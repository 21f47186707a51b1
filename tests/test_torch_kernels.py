"""K1 and K2's plain versions against Flax, and the kernels against them.

The plain versions are what the port runs on CPU tensors and what the CUDA
kernels are held to on the card. Here they are held to the JAX package's
Flax computations on the same inputs (numpy seeds, real packed segments
from ``pack_sequences`` including padding slots and all-padding rows):

* K1 ``segment_attention_plain`` vs ``flax.linen.dot_product_attention``
  and vs a whole ``nn.MultiHeadDotProductAttention`` under the packed
  mask, at EVERY slot (padding queries get the uniform average of V in
  both: the mask fill is the finite ``finfo.min``, never -inf);
* K2 ``span_embed_plain`` vs ``SpanEmbedder`` + positional add + mask.

f32 bounds are f32 summation-order noise (1e-6 relative). The bf16 bounds
are pinned from measurement, in bf16 rounding steps at the largest output
magnitude (a step is 2^-7 relative): Flax rounds the scores, the softmax,
the continuous input and every partial sum of the embedding to bf16, the
port computes them in f32 and rounds once.

The kernels themselves are held to the plain versions on a card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from odigos_tpu.features.featurizer import pack_sequences as jpack
from odigos_tpu.models.layers import SpanEmbedder
from odigos_tpu.pdata import synthesize_traces as jsynth
from odigos_tpu_torch.kernels import attention, embed
from odigos_tpu_torch.kernels.attention import (segment_attention,
                                                segment_attention_plain)
from odigos_tpu_torch.kernels.embed import (EmbedTables, span_embed,
                                            span_embed_plain)

torch.set_num_threads(1)

L, H, HD = 16, 2, 32
D = H * HD
SEEDS = (0, 1, 2)
F32_ATOL = 1e-6
K1_BF16_STEPS = 2   # measured: at most 1 step on these seeds
K2_BF16_STEPS = 4   # measured: at most 2 steps (|x| ~ 11, step 0.0625)


def _bf16_steps(ref: np.ndarray, n: int) -> float:
    """n bf16 rounding steps at the largest magnitude of ``ref``."""
    return n * 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)


def _packed(seed: int, attr_slots: int = 0):
    """Real packed rows plus two all-padding rows at the end."""
    from odigos_tpu.features.featurizer import FeaturizerConfig

    batch = jsynth(12, seed=seed)
    return jpack(batch, max_len=L, config=FeaturizerConfig(
        attr_slots=attr_slots), pad_rows_to=lambda r: r + 2)


def _qkv(seed: int, R: int) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((R, L, H, HD)).astype(np.float32)
            for _ in range(3)]


def _flax_mask(segments: np.ndarray) -> np.ndarray:
    """The mask Encoder.__call__ builds (layers.py, segments branch)."""
    m = segments > 0
    return ((segments[..., None] == segments[..., None, :])
            & m[..., None] & m[..., None, :])[:, None]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k1_plain_matches_flax_attention(seed, dtype):
    pk = _packed(seed)
    assert (pk.segments == 0).any() and (pk.segments[-1] == 0).all()
    q, k, v = _qkv(seed, pk.n_rows)
    jdt = jnp.dtype(dtype)
    ref = nn.dot_product_attention(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        mask=jnp.asarray(_flax_mask(pk.segments)))
    ref = np.asarray(ref.astype(jnp.float32))
    tdt = getattr(torch, dtype)
    got = segment_attention_plain(
        *(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
        torch.from_numpy(pk.segments)).float().numpy()
    assert np.isfinite(got).all()
    atol = F32_ATOL if dtype == "float32" else _bf16_steps(ref, K1_BF16_STEPS)
    np.testing.assert_allclose(got, ref, atol=atol, rtol=0)


def test_k1_padding_query_is_uniform_average():
    pk = _packed(0)
    q, k, v = _qkv(0, pk.n_rows)
    got = segment_attention_plain(
        *(torch.from_numpy(x) for x in (q, k, v)),
        torch.from_numpy(pk.segments)).numpy()
    pad_r, pad_l = np.argwhere(pk.segments == 0)[0]
    np.testing.assert_allclose(got[pad_r, pad_l], v[pad_r].mean(0),
                               atol=1e-6)


@pytest.mark.parametrize("seed", SEEDS)
def test_k1_plain_inside_mha_matches_flax_mha(seed):
    """The whole MultiHeadDotProductAttention: projections as the port's
    EncoderBlock does them, attention by the plain K1, out projection."""
    pk = _packed(seed)
    R = pk.n_rows
    x = np.random.default_rng(seed).standard_normal(
        (R, L, D)).astype(np.float32)
    mha = nn.MultiHeadDotProductAttention(num_heads=H, dtype=jnp.float32)
    mask = jnp.asarray(_flax_mask(pk.segments))
    params = mha.init(jax.random.PRNGKey(seed), x, x, mask=mask)
    ref = np.asarray(mha.apply(params, x, x, mask=mask))
    p = jax.tree_util.tree_map(np.asarray, params)["params"]

    def proj(name):
        kern, bias = p[name]["kernel"], p[name]["bias"]   # (D,H,HD), (H,HD)
        y = torch.from_numpy(x) @ torch.tensor(kern.reshape(D, -1)) \
            + torch.tensor(bias.reshape(-1))
        return y.view(R, L, H, HD).contiguous()

    a = segment_attention_plain(proj("query"), proj("key"), proj("value"),
                                torch.from_numpy(pk.segments))
    out = a.reshape(R, L, D) @ torch.tensor(
        p["out"]["kernel"].reshape(-1, D)) + torch.tensor(p["out"]["bias"])
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)


def _k1_tc_emulation(q, k, v, segments):
    """K1's tensor-core arithmetic (the bf16 route of
    ``csrc/segment_attention.cu``) in plain torch: keys padded with zeros to
    16-key tiles, q / sqrt(hd) rounded to bf16, f32 scores (bf16 products
    are exact in f32), the finite fill inside L and weight exactly 0 past
    L, f32 softmax, P split into bf16 hi + lo parts, both products
    accumulated in f32, one rounding at the end."""
    R, L, H, hd = q.shape
    Lk = (L + 15) // 16 * 16
    pad = (0, 0, 0, 0, 0, Lk - L)

    def tile(x):
        return torch.nn.functional.pad(x.float(), pad)

    qs = (q.float() / attention._scale_div(hd, torch.bfloat16)).to(
        torch.bfloat16)
    s = torch.einsum("rqhd,rkhd->rhqk", tile(qs), tile(k))
    seg = torch.nn.functional.pad(segments.long(), (0, Lk - L))
    allowed = (seg[:, :, None] == seg[:, None, :]) & (seg[:, :, None] > 0)
    s = s.masked_fill(~allowed[:, None], torch.finfo(torch.bfloat16).min)
    s[..., L:] = -torch.inf                       # past L: weight 0
    p = torch.softmax(s, dim=-1)
    hi = p.to(torch.bfloat16)
    lo = (p - hi.float()).to(torch.bfloat16)
    o = (torch.einsum("rhqk,rkhd->rqhd", hi.float(), tile(v))
         + torch.einsum("rhqk,rkhd->rqhd", lo.float(), tile(v)))
    return o[:, :L].to(torch.bfloat16)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("L_,hd", [(16, 32), (40, 48)])
def test_k1_tc_arithmetic_keeps_the_one_step_bound(seed, L_, hd):
    """The hi/lo split of P keeps the tensor-core route within one bf16
    step of the plain version (a single bf16 P could add 2^-9 max|v|),
    fully masked rows and the 16-key tile padding included."""
    from odigos_tpu.features.featurizer import FeaturizerConfig

    pk = jpack(jsynth(12, seed=seed), max_len=L_, config=FeaturizerConfig(),
               pad_rows_to=lambda r: r + 2)
    assert (pk.segments[-1] == 0).all()
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (pk.n_rows, L_, H, hd)).astype(np.float32)).to(torch.bfloat16)
        for _ in range(3))
    seg = torch.from_numpy(pk.segments)
    got = _k1_tc_emulation(q, k, v, seg).float().numpy()
    ref = segment_attention_plain(q, k, v, seg).float().numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=_bf16_steps(ref, 1))


class _EmbedPosMask(nn.Module):
    """SpanEmbedder + the positional add + the mask: the first lines of
    odigos_tpu's Encoder.__call__."""

    d: int
    attr_slots: int
    dtype: object

    @nn.compact
    def __call__(self, cat, cont, positions, mask):
        x = SpanEmbedder(64, 128, 256, self.d, self.dtype,
                         name="embed")(cat, cont)
        x = x + nn.Embed(L, self.d, dtype=self.dtype,
                         name="pos_embed")(positions)
        return x * mask[..., None].astype(self.dtype)


def _k2_case(seed: int, attr_slots: int, dtype):
    from odigos_tpu.features.featurizer import FeaturizerConfig, featurize

    batch = jsynth(12, seed=seed)
    cfg = FeaturizerConfig(service_vocab=64, name_vocab=128, attr_vocab=256,
                           attr_slots=attr_slots)
    pk = jpack(batch, featurize(batch, cfg), max_len=L,
               pad_rows_to=lambda r: r + 2)
    mod = _EmbedPosMask(D, attr_slots, dtype)
    mask = pk.segments > 0
    params = mod.init(jax.random.PRNGKey(seed), pk.categorical,
                      pk.continuous, pk.positions, mask)
    ref = np.asarray(mod.apply(params, pk.categorical, pk.continuous,
                               pk.positions, mask).astype(jnp.float32))
    p = jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a, np.float32)), params)["params"]
    e = p["embed"]
    tables = EmbedTables(
        service=e["service_embed"]["embedding"],
        name=e["name_embed"]["embedding"],
        kind=e["kind_embed"]["embedding"],
        status=e["status_embed"]["embedding"],
        attr=e["attr_embed"]["embedding"] if attr_slots else None,
        cont_w=e["cont_proj"]["kernel"].T.contiguous(),
        cont_b=e["cont_proj"]["bias"],
        pos=p["pos_embed"]["embedding"])
    return pk, tables, ref


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("attr_slots", [0, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k2_plain_matches_flax_embedder(seed, attr_slots, dtype):
    pk, tables, ref = _k2_case(seed, attr_slots, jnp.dtype(dtype))
    got = span_embed_plain(
        torch.from_numpy(pk.categorical), torch.from_numpy(pk.continuous),
        torch.from_numpy(pk.positions), torch.from_numpy(pk.segments),
        tables, getattr(torch, dtype)).float().numpy()
    assert (got[pk.segments == 0] == 0).all()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, atol=F32_ATOL, rtol=1e-6)
    else:
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=_bf16_steps(ref, K2_BF16_STEPS))


def test_wrappers_take_the_plain_version_on_cpu():
    pk = _packed(0)
    q, k, v = (torch.from_numpy(x) for x in _qkv(0, pk.n_rows))
    seg = torch.from_numpy(pk.segments)
    before = attention.launches
    assert torch.equal(segment_attention(q, k, v, seg),
                       segment_attention_plain(q, k, v, seg))
    assert attention.launches == before
    pk2, tables, _ = _k2_case(0, 2, jnp.float32)
    args = (torch.from_numpy(pk2.categorical),
            torch.from_numpy(pk2.continuous),
            torch.from_numpy(pk2.positions),
            torch.from_numpy(pk2.segments), tables, torch.bfloat16)
    before = embed.launches
    assert torch.equal(span_embed(*args), span_embed_plain(*args))
    assert embed.launches == before


def test_wrappers_check_their_inputs():
    q = torch.zeros(2, L, H, HD)
    seg = torch.zeros(2, L, dtype=torch.int32)
    with pytest.raises(ValueError):
        segment_attention(q, q, q[:1].contiguous(), seg)
    with pytest.raises(ValueError):
        segment_attention(q, q, q, seg[:, :4])
    with pytest.raises(TypeError):
        segment_attention(q, q.double(), q, seg)
    _, tables, _ = _k2_case(0, 0, jnp.float32)
    cat = torch.zeros(2, L, 7, dtype=torch.int32)  # 2 attr slots, no table
    cont = torch.zeros(2, L, 3)
    with pytest.raises(ValueError, match="attr"):
        span_embed(cat, cont, seg, seg, tables, torch.float32)
    with pytest.raises(ValueError):
        span_embed(cat[..., :5], cont[..., :2], seg, seg, tables,
                   torch.float32)

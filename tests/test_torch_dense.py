"""K14 and K15's plain versions, and the encoder block built on them,
against the JAX package's Flax modules, on the CPU.

Inputs are numpy draws from a seed; model weights come from the JAX
models' ``init`` and cross through ``flax_to_torch`` /
``flax_autoencoder_to_torch``. On the CPU every wrapper takes its plain
version, so these tests pin the arithmetic the kernels are held to on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Bounds, and why:

* ``ln_bf16_plain`` against ``nn.LayerNorm(dtype)``: bf16 bit-equal (both
  round the same f32 value once; the f32 statistics differ in their last
  bits at most, measured 0 differing outputs), f32 within ``F32_ATOL`` of
  the row's magnitude (Flax takes the variance as E[x^2] - E[x]^2, the
  port two-pass from exact sums);
* ``gemm_bf16_plain`` against ``nn.Dense(dtype)``: ``none`` and
  ``residual`` bit-equal in bf16 and f32 (the same roundings: the product
  rounded to the working type, the bias added in it); ``gelu_tanh`` within
  one bf16 step of the output's magnitude in bf16, where ``jax.nn.gelu``
  computes in bf16 and the port in f32 rounded once, and within
  ``F32_ATOL`` in f32 (another tanh);
* one ``EncoderBlock`` with a segment mask (``reference=True``): f32
  within ``F32_ATOL`` of the output's magnitude; bf16 within one bf16 step
  of it (K1's plain version keeps scores and softmax in f32, Flax rounds
  them to bf16);
* the autoencoder's decoder chain (``dec_ff1`` → gelu → ``dec_ff2``) on the
  reference's own input: f32 within ``F32_ATOL``, bf16 within one bf16
  step of the magnitude.
"""

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from odigos_tpu.features.featurizer import assemble_sequences
from odigos_tpu.features.featurizer import pack_sequences as jpack
from odigos_tpu.models.autoencoder import AutoencoderConfig as JaxAEConfig
from odigos_tpu.models.autoencoder import SpanAutoencoder as JaxAutoencoder
from odigos_tpu.models.layers import EncoderBlock as JaxBlock
from odigos_tpu.models.transformer import TraceTransformer as JaxTransformer
from odigos_tpu.models.transformer import TransformerConfig as JaxConfig
from odigos_tpu.pdata import synthesize_traces as jsynth
from odigos_tpu_torch.kernels import dense
from odigos_tpu_torch.kernels.dense import (gemm_bf16, gemm_bf16_plain,
                                            ln_bf16, ln_bf16_plain)
from odigos_tpu_torch.kernels.qgemm import gelu_tanh_plain
from odigos_tpu_torch.models import (AutoencoderConfig, SpanAutoencoder,
                                     TraceTransformer, TransformerConfig,
                                     flax_autoencoder_to_torch,
                                     flax_to_torch)

torch.set_num_threads(1)

F32_ATOL = 1e-5  # relative to max(1, the output's largest magnitude)
GEOM = dict(d_model=64, n_heads=2, n_layers=1, d_ff=128, max_len=16)
AE_GEOM = dict(d_model=32, d_latent=16, n_heads=2, n_layers=1, d_ff=128,
               max_len=16)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _np(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _step(ref: np.ndarray) -> float:
    """One bf16 rounding step at the largest magnitude of ``ref``."""
    return 2.0 ** (math.floor(math.log2(np.abs(ref).max())) - 7)


def _bound(ref: np.ndarray, which: str) -> float:
    return (F32_ATOL * max(1.0, float(np.abs(ref).max())) if which == "f32"
            else _step(ref))


def _t(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


# ---------------------------------------------------------- K14, K15 plain
@pytest.mark.parametrize("d", [32, 64, 256])
@pytest.mark.parametrize("which", ["f32", "bf16"])
def test_ln_plain_matches_flax_layer_norm(which, d):
    jdt, tdt = DTYPES[which]
    rng = np.random.default_rng(d)
    x = rng.normal(0.3, 1.7, (50, d)).astype(np.float32)
    scale = rng.normal(1.0, 0.2, d).astype(np.float32)
    bias = rng.normal(0.0, 0.2, d).astype(np.float32)
    ref = _np(fnn.LayerNorm(dtype=jdt).apply(
        {"params": {"scale": scale, "bias": bias}}, jnp.asarray(x, jdt)))
    got = ln_bf16_plain(_t(x, tdt), torch.from_numpy(scale),
                        torch.from_numpy(bias))
    assert got.dtype == tdt and got.shape == x.shape
    got = got.float().numpy()
    if which == "bf16":
        np.testing.assert_array_equal(got, ref)
    else:
        assert np.abs(got - ref).max() <= _bound(ref, "f32")
    # the wrapper on a CPU tensor is the plain version, and launches nothing
    before = dense.ln_launches
    wrapped = ln_bf16(_t(x, tdt), torch.from_numpy(scale),
                      torch.from_numpy(bias))
    np.testing.assert_array_equal(wrapped.float().numpy(), got)
    assert dense.ln_launches == before


@pytest.mark.parametrize("K,N", [(64, 128), (128, 64)])
@pytest.mark.parametrize("epilogue", ["none", "residual", "gelu_tanh"])
@pytest.mark.parametrize("which", ["f32", "bf16"])
def test_gemm_plain_matches_flax_dense(which, epilogue, K, N):
    jdt, tdt = DTYPES[which]
    rng = np.random.default_rng(K + N)
    M = 70
    x = rng.normal(0.0, 1.0, (M, K)).astype(np.float32)
    w = (rng.normal(0.0, 1.0, (K, N)) / np.sqrt(K)).astype(np.float32)
    b = rng.normal(0.0, 0.3, N).astype(np.float32)
    r = rng.normal(0.0, 1.0, (M, N)).astype(np.float32)
    y = fnn.Dense(N, dtype=jdt).apply({"params": {"kernel": w, "bias": b}},
                                      jnp.asarray(x, jdt))
    ref = _np({"none": y, "gelu_tanh": fnn.gelu(y),
               "residual": jnp.asarray(r, jdt) + y}[epilogue])
    # the port holds the Linear layout (N, K) in the working type
    args = (_t(x, tdt), _t(w.T, tdt), _t(b, tdt), epilogue,
            _t(r, tdt) if epilogue == "residual" else None)
    got = gemm_bf16_plain(*args)
    assert got.dtype == tdt and got.shape == (M, N)
    got = got.float().numpy()
    if epilogue == "gelu_tanh":
        assert np.abs(got - ref).max() <= _bound(ref, which)
    else:
        np.testing.assert_array_equal(got, ref)
    before = dense.gemm_launches
    np.testing.assert_array_equal(gemm_bf16(*args).float().numpy(), got)
    assert dense.gemm_launches == before


@pytest.mark.parametrize("planes", [1, 3])
def test_gemm_plain_planes_split_the_columns(planes):
    rng = np.random.default_rng(7)
    x = _t(rng.normal(size=(20, 32)).astype(np.float32), torch.bfloat16)
    w = _t(rng.normal(size=(48, 32)).astype(np.float32), torch.bfloat16)
    b = _t(rng.normal(size=48).astype(np.float32), torch.bfloat16)
    flat = gemm_bf16_plain(x, w, b)
    got = gemm_bf16_plain(x, w, b, planes=planes)
    if planes == 1:
        assert torch.equal(got, flat)
    else:
        assert got.shape == (3, 20, 16) and got.is_contiguous()
        for p in range(3):
            assert torch.equal(got[p], flat[:, 16 * p:16 * (p + 1)])


# ------------------------------------------------------- the encoder block
def _segments(R: int, L: int, seed: int) -> np.ndarray:
    """Packed rows of real traces: row-local trace ids, 0 at padding."""
    pk = jpack(jsynth(12, seed=seed), max_len=L,
               pad_rows_to=lambda r: max(r, R))
    return pk.segments[:R]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("which", ["f32", "bf16"])
def test_encoder_block_matches_flax(which, seed):
    jdt, tdt = DTYPES[which]
    jm = JaxTransformer(JaxConfig(**GEOM, dtype=jdt))
    variables = jax.tree_util.tree_map(
        np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(seed)))
    pm = TraceTransformer(TransformerConfig(**GEOM, dtype=tdt), device="cpu")
    pm.load_state_dict(flax_to_torch(variables, pm.cfg))
    L, d = GEOM["max_len"], GEOM["d_model"]
    seg = _segments(6, L, seed)
    R = seg.shape[0]
    x = np.random.default_rng(seed).normal(0, 1, (R, L, d)).astype(
        np.float32)
    mask = seg > 0
    attn = ((seg[..., None] == seg[..., None, :]) & mask[..., None]
            & mask[..., None, :])[:, None]
    block = JaxBlock(GEOM["d_model"], GEOM["n_heads"], GEOM["d_ff"], jdt)
    ref = _np(jax.jit(block.apply)(
        {"params": variables["params"]["encoder"]["block_0"]},
        jnp.asarray(x, jdt), jnp.asarray(attn)))
    blk = pm.module.encoder.blocks[0]
    with torch.inference_mode():
        got = blk(_t(x, tdt), torch.from_numpy(seg.astype(np.int32)),
                  reference=True)
        wrapped = blk(_t(x, tdt), torch.from_numpy(seg.astype(np.int32)))
    assert got.dtype == tdt and got.shape == (R, L, d)
    assert torch.equal(got, wrapped)  # the CPU wrappers are the plain path
    got = got.float().numpy()
    assert np.abs(got[mask] - ref[mask]).max() <= _bound(ref[mask], which)


@pytest.mark.parametrize("which", ["f32", "bf16"])
def test_autoencoder_decoder_chain_matches_flax(which):
    """``dec_ff1`` → gelu → ``dec_ff2`` on the reference's own input (its
    ``latent_proj`` output plus ``dec_pos_embed``), read from the Flax
    module's intermediates."""
    jdt, tdt = DTYPES[which]
    jm = JaxAutoencoder(JaxAEConfig(**AE_GEOM, dtype=jdt))
    variables = jax.tree_util.tree_map(
        np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(3)))
    pm = SpanAutoencoder(AutoencoderConfig(**AE_GEOM, dtype=tdt),
                         device="cpu")
    pm.load_state_dict(flax_autoencoder_to_torch(variables, pm.cfg))
    seqs = assemble_sequences(jsynth(6, seed=3), max_len=AE_GEOM["max_len"])
    _, state = jax.jit(partial(jm.module.apply, capture_intermediates=True))(
        variables, seqs.categorical, seqs.continuous, seqs.mask)
    inter = state["intermediates"]
    L = AE_GEOM["max_len"]
    dec_in = (inter["latent_proj"]["__call__"][0][..., None, :]
              + inter["dec_pos_embed"]["__call__"][0][:L])
    ref = _np(inter["dec_ff2"]["__call__"][0])
    m = pm.module
    x = _t(_np(dec_in).reshape(-1, AE_GEOM["d_model"]), tdt)
    with torch.inference_mode():
        h = gemm_bf16_plain(x, m.dec_ff1.weight, m.dec_ff1.bias,
                            "gelu_tanh")
        got = gemm_bf16_plain(h, m.dec_ff2.weight, m.dec_ff2.bias)
    got = got.float().numpy().reshape(ref.shape)
    assert np.abs(got - ref).max() <= _bound(ref, which)


def test_qkv_cache_follows_the_weights():
    """The block's concatenated QKV weight is rebuilt after
    ``load_state_dict`` and after an in-place edit; the state dict keeps
    the per-projection names ``models/convert.py`` maps onto."""
    a = TraceTransformer(TransformerConfig(**GEOM), device="cpu", seed=0)
    b = TraceTransformer(TransformerConfig(**GEOM), device="cpu", seed=1)
    blk = a.module.encoder.blocks[0]
    assert {"query.weight", "key.weight", "value.weight", "query.bias"} <= \
        set(blk.state_dict())
    assert not any("qkv" in k for k in a.state_dict())
    L, d = GEOM["max_len"], GEOM["d_model"]
    seg = torch.from_numpy(_segments(4, L, 5).astype(np.int32))
    x = _t(np.random.default_rng(5).normal(size=(seg.shape[0], L, d)),
           torch.bfloat16)

    def run(m):
        with torch.inference_mode():
            return m.module.encoder.blocks[0](x, seg)

    first = run(a)
    w0, _ = blk.qkv()
    a.load_state_dict(b.state_dict())
    w1, bias1 = blk.qkv()
    assert w1 is not w0
    ref = torch.cat([b.module.encoder.blocks[0].query.weight,
                     b.module.encoder.blocks[0].key.weight,
                     b.module.encoder.blocks[0].value.weight])
    assert torch.equal(w1, ref)
    assert torch.equal(run(a), run(b)) and not torch.equal(run(a), first)
    assert blk.qkv()[0] is w1  # unchanged weights: the cache holds
    with torch.no_grad():
        blk.value.bias.add_(1.0)
    assert torch.equal(blk.qkv()[1][2 * d:], blk.value.bias)
    assert not torch.equal(blk.qkv()[1], bias1)


# ------------------------------------------------------------- the wrappers
def _gemm_args(M=8, K=32, N=16, dtype=torch.bfloat16):
    return (torch.zeros(M, K, dtype=dtype), torch.zeros(N, K, dtype=dtype),
            torch.zeros(N, dtype=dtype))


@pytest.mark.parametrize("case", [
    "epilogue", "shape", "bias", "residual_missing", "residual_unwanted",
    "residual_shape", "planes", "planes_residual", "dtype"])
def test_gemm_refuses_what_it_does_not_take(case):
    x, w, b = _gemm_args()
    kw = {}
    err = ValueError
    if case == "epilogue":
        kw = dict(epilogue="relu")
    elif case == "shape":
        w = torch.zeros(16, 24, dtype=torch.bfloat16)
    elif case == "bias":
        b = torch.zeros(8, dtype=torch.bfloat16)
    elif case == "residual_missing":
        kw = dict(epilogue="residual")
    elif case == "residual_unwanted":
        kw = dict(residual=torch.zeros(8, 16, dtype=torch.bfloat16))
    elif case == "residual_shape":
        kw = dict(epilogue="residual",
                  residual=torch.zeros(8, 8, dtype=torch.bfloat16))
    elif case == "planes":
        kw = dict(planes=3)
    elif case == "planes_residual":
        kw = dict(epilogue="residual", planes=2,
                  residual=torch.zeros(8, 16, dtype=torch.bfloat16))
    elif case == "dtype":
        w = w.float()
        err = TypeError
    for fn in (gemm_bf16, gemm_bf16_plain):
        with pytest.raises(err):
            fn(x, w, b, **kw)


def test_ln_refuses_what_it_does_not_take():
    x = torch.zeros(4, 32, dtype=torch.bfloat16)
    for fn in (ln_bf16, ln_bf16_plain):
        with pytest.raises(ValueError, match="weight"):
            fn(x, torch.ones(16), torch.zeros(32))


def test_wrappers_raise_off_the_cpu_without_a_card():
    """A tensor on neither the CPU nor a card is refused, never computed;
    a model meant for the card raises where there is none."""
    x, w, b = (t.to("meta") for t in _gemm_args())
    with pytest.raises(ValueError, match="cuda or cpu"):
        gemm_bf16(x, w, b)
    with pytest.raises(ValueError, match="cuda or cpu"):
        ln_bf16(torch.zeros(4, 32, device="meta"), torch.ones(32,
                                                              device="meta"),
                torch.zeros(32, device="meta"))
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this pins the no-card path")
    with pytest.raises(RuntimeError, match="is_available"):
        TraceTransformer(TransformerConfig(**GEOM))


# ------------------------------------------------- K15's GELU table (plain)
ALL_BF16 = torch.arange(65536, dtype=torch.int32).to(torch.int16).view(
    torch.bfloat16)


def test_gelu_table_lookup_equals_the_formula_on_every_bf16():
    """The premise of K15's table: round(gelu(y)) is a function of y's 16
    bits. The lookup's plain twin (the table built by gelu_tanh_plain, the
    formula outside it) gives gelu_tanh_plain's bits on all 65,536."""
    got = dense.gelu_bf16_lookup_plain(ALL_BF16).view(torch.int16)
    want = gelu_tanh_plain(ALL_BF16.float()).to(torch.bfloat16).view(
        torch.int16)
    assert torch.equal(got, want)


def test_gelu_table_holds_the_common_values_and_not_the_rare():
    """Zero and 2^-61 <= |y| < 8 are in the table; NaN, +-inf, |y| >= 8
    and |y| < 2^-61 take the formula. A block's FFN1 on LayerNormed rows
    (random weights, the port's default widths) has no value outside."""
    a = ALL_BF16.view(torch.int16).to(torch.int64) & 0x7FFF
    lo, span = dense.GELU_TABLE_LO, dense.GELU_TABLE_SPAN
    inside = (a == 0) | ((a >= lo) & (a < lo + span))
    bits = {"zero": 0x0000, "neg_zero": 0x8000, "2^-61": 0x2100,
            "below_8": 0x40FF, "8": 0x4100, "inf": 0x7F80,
            "-inf": 0xFF80, "nan": 0x7FC0, "2^-62": 0x2080}
    held = {k: bool(inside[v]) for k, v in bits.items()}
    assert held == {"zero": True, "neg_zero": True, "2^-61": True,
                    "below_8": True, "8": False, "inf": False,
                    "-inf": False, "nan": False, "2^-62": False}
    assert int(inside.sum()) == 2 * span + 2
    cfg = TransformerConfig(dtype=torch.bfloat16)
    blk = TraceTransformer(cfg, device="cpu", seed=0).module.encoder.blocks[0]
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(0, 1, (4096, cfg.d_model)).astype(
        np.float32)).bfloat16()
    h = ln_bf16(x, blk.ln2.weight, blk.ln2.bias)
    y = gemm_bf16_plain(h, blk.ff1.weight, blk.ff1.bias)
    ya = y.view(torch.int16).to(torch.int64) & 0x7FFF
    assert bool(((ya == 0) | ((ya >= lo) & (ya < lo + span))).all())


def test_gemm_plain_formula_epilogue_is_the_gelu():
    """``gelu_tanh_formula`` (the card's per-output formula, kept to hold
    the table to it) is the same function as ``gelu_tanh``."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(0, 1, (64, 32)).astype(
        np.float32)).bfloat16()
    w = torch.from_numpy(rng.normal(0, 0.2, (48, 32)).astype(
        np.float32)).bfloat16()
    b = torch.from_numpy(rng.normal(0, 0.1, 48).astype(np.float32)).bfloat16()
    assert torch.equal(gemm_bf16(x, w, b, "gelu_tanh_formula"),
                       gemm_bf16_plain(x, w, b, "gelu_tanh"))

"""The geometries past the default one, on the CPU: the card route's
coverage contract (``kernels/coverage.py``), the port's plain path against
the JAX package at those geometries, and the host models of the kernels
that take them.

Inputs are ``synthesize_traces`` batches or numpy draws from a seed;
weights come from the JAX models' ``init`` and cross through
``flax_to_torch`` / ``flax_autoencoder_to_torch``. Depth is cut to one
layer; widths are the geometry's own. On the CPU every kernel wrapper
takes its plain version.

Bounds, the existing files' own:

* the transformer: f32 at ``F32_TOL`` (``tests/test_torch_model.py``),
  bf16 probabilities within ``BF16_ATOL``;
* int8: the JAX scorer's f32 bounds of ``tests/test_torch_quantized.py``
  (``SCORER_F32_MAX`` / ``SCORER_F32_MEAN``), K9's codes and scales exact
  against ``_qdense`` and its LayerNorm within ``LN_F32_RTOL``;
* the autoencoder: errors at ``F32_TOL`` in f32, within ``BF16_ERR_RTOL``
  relative in bf16 (``tests/test_torch_autoencoder.py``); K12's plain
  version within one bf16 step of the reference's pool plus one step of
  the row's largest LayerNorm output over the count (a LayerNorm output
  one step apart, as above, moves the pooled sum by that), K11's within
  ``F32_TOL`` of ``_errors`` in f32;
* K14's plain version against Flax's ``LayerNorm(dtype=bf16)``: bit-equal
  up to d 384; past it Flax's own f32 statistics (the variance as
  E[x^2] - E[x]^2 over more values) drift from the exact ones, and a bf16
  rounding lands one step apart on at most ``LN_DIFFER_SHARE`` of the
  outputs (measured 4 of 163,840 at d 4096): that is the reference's
  rounding, not the port's. NaN past a device row count;
* K1's tiled online softmax (the host model of the two tiled kernels)
  within ``F32_TOL`` of ``segment_attention_plain`` in f32: the same sums
  in another order, the normalisation once at the end.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from odigos_tpu.features.featurizer import FeaturizerConfig as JaxFeatConfig
from odigos_tpu.features.featurizer import assemble_sequences as jassemble
from odigos_tpu.features.featurizer import featurize as jfeaturize
from odigos_tpu.features.featurizer import pack_sequences as jpack
from odigos_tpu.models.autoencoder import AutoencoderConfig as JaxAEConfig
from odigos_tpu.models.autoencoder import SpanAutoencoder as JaxAutoencoder
from odigos_tpu.models.autoencoder import _ce
from odigos_tpu.models.quantized import QuantizedTraceScorer as JaxScorer
from odigos_tpu.models.quantized import _layernorm, _qdense
from odigos_tpu.models.transformer import TraceTransformer as JaxTransformer
from odigos_tpu.models.transformer import TransformerConfig as JaxConfig
from odigos_tpu.pdata import synthesize_traces as jsynth
from odigos_tpu.serving.engine import EngineConfig as JaxEngineConfig
from odigos_tpu.serving.engine import ScoringEngine as JaxEngine
from odigos_tpu.serving.fused import extract_columns as jax_extract
from odigos_tpu_torch.features import featurize
from odigos_tpu_torch.kernels import coverage
from odigos_tpu_torch.kernels import pool as kpool
from odigos_tpu_torch.kernels import recon as krecon
from odigos_tpu_torch.kernels.attention import segment_attention_plain
from odigos_tpu_torch.kernels.dense import (gemm_bf16, gemm_bf16_plain,
                                            ln_bf16, ln_bf16_plain)
from odigos_tpu_torch.kernels.quant import ln_quantize_plain
from odigos_tpu_torch.models import (AutoencoderConfig,
                                     QuantizedTraceScorer, SpanAutoencoder,
                                     TraceTransformer, TransformerConfig,
                                     flax_autoencoder_to_torch,
                                     flax_to_torch)
from odigos_tpu_torch.pdata import synthesize_traces as psynth
from odigos_tpu_torch.serving import EngineConfig, ScoringEngine
from odigos_tpu_torch.serving.fused import extract_columns

torch.set_num_threads(1)

F32_TOL = 1e-5
BF16_ATOL = 2e-2
BF16_ERR_RTOL = 1e-2
LN_F32_RTOL = 2.0 ** -20
SCORER_F32_MAX = 2.7e-3
SCORER_F32_MEAN = 2.4e-5
FUSED_RTOL = 2e-5
FUSED_ATOL = 1e-6
LN_DIFFER_SHARE = 1e-4

# transformer geometries past the default (depth cut to one layer)
L128 = dict(d_model=64, n_heads=2, n_layers=1, d_ff=128, max_len=128)
L256 = dict(d_model=64, n_heads=2, n_layers=1, d_ff=128, max_len=256)
HD128 = dict(d_model=256, n_heads=2, n_layers=1, d_ff=256, max_len=32)
INT8_FF2048 = dict(d_model=128, n_heads=4, n_layers=1, d_ff=2048,
                   max_len=32)
AE512 = dict(d_model=512, d_latent=64, n_heads=4, n_layers=1, d_ff=512,
             max_len=16, service_vocab=64, name_vocab=128)


# ---------------------------------------------------------------- contract

SERVED = [("L128", TransformerConfig(max_len=128)),
          ("L256", TransformerConfig(**L256)),
          ("L1024", TransformerConfig(max_len=1024)),
          ("hd128", TransformerConfig(**HD128)),
          ("hd256", TransformerConfig(d_model=512, n_heads=2)),
          ("ff2048", TransformerConfig(**INT8_FF2048)),
          ("ff4096", TransformerConfig(d_model=1024, n_heads=8,
                                       d_ff=4096)),
          ("d48", TransformerConfig(d_model=48, n_heads=3, d_ff=96)),
          ("ae", AutoencoderConfig()),
          ("ae512", AutoencoderConfig(**AE512))]


@pytest.mark.parametrize("name,cfg", SERVED, ids=[n for n, _ in SERVED])
@pytest.mark.parametrize("f32", [False, True])
def test_coverage_accepts_the_served_geometries(name, cfg, f32):
    """Either working type (the int8 scorer's K9 and K10 take the same
    limits as the float kernels)."""
    coverage.check(dataclasses.replace(cfg, dtype=torch.float32) if f32
                   else cfg)


REFUSED = [(dict(d_model=1032, n_heads=8), "d_model"),
           (dict(d_model=100, n_heads=4), "d_model"),
           (dict(max_len=2048), "max_len"),
           (dict(d_ff=4112), "d_ff"),
           (dict(d_ff=1000), "d_ff"),
           (dict(d_model=1024, n_heads=2), "head dim")]


@pytest.mark.parametrize("change,limit", REFUSED,
                         ids=[lim + "-" + "-".join(f"{k}{v}" for k, v in
                                                   c.items())
                              for c, lim in REFUSED])
def test_coverage_refuses_naming_the_limit(change, limit):
    for cfg in (TransformerConfig(**change),
                AutoencoderConfig(**change)):
        with pytest.raises(ValueError, match=limit):
            coverage.check(cfg)


def test_the_cpu_serves_geometries_the_card_refuses():
    """The contract binds the card only: on the CPU the plain versions
    take any geometry."""
    cfg = TransformerConfig(d_model=100, n_heads=4, n_layers=1, d_ff=200,
                            max_len=16)
    model = TraceTransformer(cfg, device="cpu")
    pk = jpack(jsynth(6, seed=1), max_len=16)
    out = model.score_packed(pk.categorical, pk.continuous, pk.segments,
                             pk.positions)
    assert torch.isfinite(out).all()


# ------------------------------------------- the plain path against JAX

def _pair(geometry: dict, f32: bool, seed: int = 0):
    jcfg = JaxConfig(**geometry, dtype=jnp.float32 if f32 else jnp.bfloat16)
    jm = JaxTransformer(jcfg)
    variables = jm.init(jax.random.PRNGKey(seed))
    pm = TraceTransformer(TransformerConfig(
        **geometry, dtype=torch.float32 if f32 else torch.bfloat16),
        device="cpu")
    pm.load_state_dict(flax_to_torch(
        jax.tree_util.tree_map(np.asarray, variables), pm.cfg))
    return jm, variables, pm


GEOMS = [("L128", L128), ("L256", L256), ("hd128", HD128)]


@pytest.mark.parametrize("name,geom", GEOMS, ids=[n for n, _ in GEOMS])
@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_transformer_plain_path_matches_jax(name, geom, f32):
    jm, v, pm = _pair(geom, f32, seed=len(name))
    pk = jpack(jsynth(40, seed=2), max_len=geom["max_len"],
               pad_rows_to=lambda r: r + 1)
    args = (pk.categorical, pk.continuous, pk.segments, pk.positions)
    ref = np.asarray(jm.score_packed(v, *args))
    got = pm.score_packed(*args).numpy()
    m = pk.segments > 0
    assert np.isfinite(got).all()
    if f32:
        np.testing.assert_allclose(got[m], ref[m], atol=F32_TOL,
                                   rtol=F32_TOL)
    else:
        assert np.abs(got[m] - ref[m]).max() <= BF16_ATOL


def test_int8_plain_path_matches_jax_at_d_ff_2048():
    jm = JaxTransformer(JaxConfig(**INT8_FF2048, dtype=jnp.float32))
    variables = jm.init(jax.random.PRNGKey(5))
    cfg = TransformerConfig(**INT8_FF2048, dtype=torch.float32)
    pq = QuantizedTraceScorer(cfg, device="cpu")
    pq.load_state_dict(flax_to_torch(
        jax.tree_util.tree_map(np.asarray, variables), cfg))
    pk = jpack(jsynth(40, seed=6), max_len=32, pad_rows_to=lambda r: r + 1)
    args = (pk.categorical, pk.continuous, pk.segments, pk.positions)
    ref = np.asarray(JaxScorer(jm, variables).score_packed(
        *map(jnp.asarray, args)))
    got = pq.score_packed(*args).numpy()
    m = pk.segments > 0
    d = np.abs(got[m] - ref[m])
    assert d.max() <= SCORER_F32_MAX and d.mean() <= SCORER_F32_MEAN


def _ae_pair(f32: bool, seed: int = 0):
    dt = dict(dtype=jnp.float32 if f32 else jnp.bfloat16)
    jm = JaxAutoencoder(JaxAEConfig(**AE512, **dt))
    variables = jm.init(jax.random.PRNGKey(seed))
    pm = SpanAutoencoder(AutoencoderConfig(
        **AE512, dtype=torch.float32 if f32 else torch.bfloat16),
        device="cpu")
    pm.load_state_dict(flax_autoencoder_to_torch(
        jax.tree_util.tree_map(np.asarray, variables), pm.cfg))
    return jm, variables, pm


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_autoencoder_plain_path_matches_jax_at_d_512(f32):
    jm, v, pm = _ae_pair(f32, seed=3)
    seqs = jassemble(jsynth(10, seed=3), max_len=16, pad_traces_to=12,
                     config=JaxFeatConfig(**{k: AE512[k] for k in (
                         "service_vocab", "name_vocab")}))
    ref, _ = jm.score_spans(v, seqs.categorical, seqs.continuous, seqs.mask)
    got, _ = pm.score_spans(seqs.categorical, seqs.continuous, seqs.mask)
    ref, got, m = np.asarray(ref), got.numpy(), seqs.mask
    assert np.isfinite(got).all() and (got[~m] == 0).all()
    if f32:
        np.testing.assert_allclose(got, ref, atol=F32_TOL, rtol=F32_TOL)
    else:
        assert (np.abs(got[m] - ref[m]) / np.abs(ref[m])).max() \
            <= BF16_ERR_RTOL


@pytest.fixture(scope="module")
def engines128():
    """JAX and port engines at max_len 128 on the same f32 weights."""
    geom = dict(L128, n_layers=1)
    je = JaxEngine(JaxEngineConfig(
        model="transformer", max_len=128, trace_bucket=8, bucket_ladder=2,
        model_config=JaxConfig(**geom, dtype=jnp.float32)))
    pe = ScoringEngine(EngineConfig(
        model="transformer", device="cpu", max_len=128, trace_bucket=8,
        bucket_ladder=2,
        model_config=TransformerConfig(**geom, dtype=torch.float32)))
    pe.backend.model.load_state_dict(flax_to_torch(
        jax.tree_util.tree_map(np.asarray, je.backend.variables),
        pe.backend.model.cfg))
    return je, pe


@pytest.mark.parametrize("seed", [3, 4])
def test_engine_at_max_len_128_matches_the_jax_engine(engines128, seed):
    """Both routes: the host route against the JAX engine's, the fused
    route (K14 given next-fit's row count: NaN past it on the CPU)
    against the JAX fused backend and the port's own host route."""
    je, pe = engines128
    assert pe.backend.max_len == 128
    jb, pb = jsynth(60, seed=seed), psynth(60, seed=seed)
    ref = je.backend.score(jb, jfeaturize(jb))
    host = pe.backend.score(pb, featurize(pb))
    np.testing.assert_allclose(host, ref, rtol=F32_TOL, atol=F32_TOL)
    jcols, _ = jax_extract(jb)
    pcols, reason = extract_columns(pb)
    assert reason is None
    fref = je.backend.harvest(je.backend.dispatch_columns([jcols]))
    fused = pe.backend.harvest(pe.backend.dispatch_columns([pcols]))
    assert np.isfinite(fused).all()
    np.testing.assert_allclose(fused, fref, rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(fused, host, rtol=FUSED_RTOL,
                               atol=FUSED_ATOL)
    R, used = pe.backend.fused_rows[-1]
    assert used < R  # the call had padding rows, poisoned with NaN


# --------------------------------------------------------- K14 plain

@pytest.mark.parametrize("d", [96, 384, 768, 4096])
def test_ln_plain_matches_flax_layer_norm_at_any_width(d):
    rng = np.random.default_rng(d)
    x = rng.normal(0.3, 1.7, (40, d)).astype(np.float32)
    scale = rng.normal(1.0, 0.2, d).astype(np.float32)
    bias = rng.normal(0.0, 0.2, d).astype(np.float32)
    ref = np.asarray(fnn.LayerNorm(dtype=jnp.bfloat16).apply(
        {"params": {"scale": scale, "bias": bias}},
        jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = ln_bf16_plain(xt, torch.from_numpy(scale),
                        torch.from_numpy(bias)).float().numpy()
    differ = got != ref
    if d <= 384:
        assert not differ.any()
    else:  # Flax's f32 statistics drift from the exact ones
        step = 2.0 ** (np.floor(np.log2(np.abs(ref))) - 7)
        assert (np.abs(got - ref) <= step).all()
        assert differ.mean() <= LN_DIFFER_SHARE
    # the wrapper on a CPU tensor is the plain version
    np.testing.assert_array_equal(
        ln_bf16(xt, torch.from_numpy(scale),
                torch.from_numpy(bias)).float().numpy(), got)


@pytest.mark.parametrize("live,per", [(0, 1), (3, 4), (7, 1), (100, 8)])
def test_ln_plain_with_a_row_count_is_nan_past_it(live, per):
    rng = np.random.default_rng(live)
    x = torch.from_numpy(rng.normal(0, 1, (10, 4, 96)).astype(
        np.float32)).to(torch.bfloat16).reshape(40, 96)
    w, b = torch.ones(96), torch.zeros(96)
    cnt = torch.tensor([live], dtype=torch.int32)
    got = ln_bf16(x, w, b, live=cnt, per=per)
    full = ln_bf16_plain(x, w, b)
    n = min(40, live * per)
    assert torch.equal(got[:n], full[:n])
    assert torch.isnan(got[n:].float()).all()
    with pytest.raises(ValueError, match="live"):
        ln_bf16(x, w, b, live=cnt.to(torch.int64))


@pytest.mark.parametrize("epilogue,planes", [("none", 3), ("gelu_tanh", 1),
                                             ("residual", 1)])
@pytest.mark.parametrize("live,per", [(0, 1), (3, 4), (7, 1), (100, 8)])
def test_gemm_plain_with_a_row_count_is_nan_past_it(epilogue, planes, live,
                                                    per):
    """K15's plain version with a row count: the rows before it are the
    count-free product's, every row at or past it NaN (in each plane)."""
    rng = np.random.default_rng(live + planes)

    def bf16(*shape):
        return torch.from_numpy(rng.normal(0, 0.5, shape).astype(
            np.float32)).to(torch.bfloat16)

    x, w, b = bf16(40, 32), bf16(192, 32), bf16(192)
    res = bf16(40, 192) if epilogue == "residual" else None
    cnt = torch.tensor([live], dtype=torch.int32)
    got = gemm_bf16(x, w, b, epilogue, res, planes, live=cnt, per=per)
    full = gemm_bf16_plain(x, w, b, epilogue, res, planes)
    n = min(40, live * per)
    rows = (lambda t: t) if planes == 1 else (lambda t: t.transpose(0, 1))
    assert torch.equal(rows(got)[:n], rows(full)[:n])
    assert torch.isnan(rows(got)[n:].float()).all()
    with pytest.raises(ValueError, match="per"):
        gemm_bf16(x, w, b, epilogue, res, planes, live=cnt, per=0)


def test_dense_wrappers_write_into_a_given_buffer():
    """``out``: the result lands in the caller's buffer, which must have
    the output's shape and type."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(0, 1, (8, 64)).astype(
        np.float32)).to(torch.bfloat16)
    w, b = torch.ones(64), torch.zeros(64)
    buf = torch.empty_like(x)
    assert ln_bf16(x, w, b, out=buf) is buf
    assert torch.equal(buf, ln_bf16_plain(x, w, b))
    wq, bq = x[:4].contiguous(), torch.zeros(4, dtype=torch.bfloat16)
    gbuf = torch.empty(8, 4, dtype=torch.bfloat16)
    assert gemm_bf16(x, wq, bq, out=gbuf) is gbuf
    assert torch.equal(gbuf, gemm_bf16_plain(x, wq, bq))
    with pytest.raises(ValueError, match="out"):
        ln_bf16(x, w, b, out=torch.empty(8, 32, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="out"):
        gemm_bf16(x, wq, bq, out=torch.empty(8, 4))


# ------------------------------------------- K9, K11, K12 plain, wide

def _jax_qdense_identity(x: np.ndarray) -> np.ndarray:
    """_qdense through an identity weight: x_q * a_s, f32."""
    K = x.shape[1]
    wq = jnp.eye(K, dtype=jnp.int8)
    return np.asarray(jax.jit(lambda t: _qdense(
        t, wq, jnp.ones(K, jnp.float32), jnp.zeros(K, jnp.float32),
        jnp.float32))(jnp.asarray(x)))


@pytest.mark.parametrize("K", [2048, 4096])
def test_ln_quantize_plain_is_exact_at_wide_k(K):
    rng = np.random.default_rng(K)
    x = (rng.standard_normal((24, K)) * rng.uniform(0.05, 8.0, (24, 1))
         ).astype(np.float32)
    x[3] = 0.0
    x_q, a_s = ln_quantize_plain(torch.from_numpy(x))
    got = (x_q.float() * a_s[:, None]).numpy()
    np.testing.assert_array_equal(got, _jax_qdense_identity(x))
    g = rng.normal(1, 0.2, K).astype(np.float32)
    b = rng.normal(0, 0.1, K).astype(np.float32)
    ref = np.asarray(jax.jit(lambda t: _layernorm(t, g, b, jnp.float32))(
        jnp.asarray(x)))
    from odigos_tpu_torch.kernels.quant import layer_norm_plain
    ln = layer_norm_plain(torch.from_numpy(x), torch.from_numpy(g),
                          torch.from_numpy(b)).numpy()
    top = np.abs(ref).max(1, keepdims=True)
    assert (np.abs(ln - ref) <= LN_F32_RTOL * top).all()


@pytest.mark.parametrize("d", [512, 1024])
def test_ln_masked_pool_plain_matches_the_reference_at_wide_d(d):
    rng = np.random.default_rng(d)
    T, L = 6, 16
    x = rng.normal(0, 2, (T, L, d)).astype(np.float32)
    mask = rng.random((T, L)) < 0.4
    mask[2] = False
    scale = rng.normal(1, 0.1, d).astype(np.float32)
    bias = rng.normal(0, 0.1, d).astype(np.float32)
    h = fnn.LayerNorm(dtype=jnp.bfloat16).apply(
        {"params": {"scale": scale, "bias": bias}},
        jnp.asarray(x).astype(jnp.bfloat16))
    denom = jnp.maximum(mask.sum(-1, keepdims=True), 1).astype(h.dtype)
    ref = np.asarray(((h * jnp.asarray(mask)[..., None].astype(h.dtype))
                      .sum(-2) / denom).astype(jnp.float32))
    got = kpool.ln_masked_pool(torch.from_numpy(x).to(torch.bfloat16),
                               torch.from_numpy(scale),
                               torch.from_numpy(bias),
                               torch.from_numpy(mask)).float().numpy()
    step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 2 ** -60))) - 7)
    top = np.asarray(jnp.abs(h.astype(jnp.float32)).max((1, 2)))[:, None]
    count = np.maximum(mask.sum(-1, keepdims=True), 1)
    ln_step = 2.0 ** (np.floor(np.log2(top)) - 7) / count
    assert (np.abs(got - ref) <= step + ln_step).all()
    assert (got[2] == 0).all()


@pytest.mark.parametrize("d", [512, 1024])
def test_recon_ce_plain_matches_the_reference_errors_at_wide_d(d):
    geom = dict(AE512, d_model=d)
    jm = JaxAutoencoder(JaxAEConfig(**geom, dtype=jnp.float32))
    v = jm.init(jax.random.PRNGKey(d))
    pm = SpanAutoencoder(AutoencoderConfig(**geom, dtype=torch.float32),
                         device="cpu")
    pm.load_state_dict(flax_autoencoder_to_torch(
        jax.tree_util.tree_map(np.asarray, v), pm.cfg))
    seqs = jassemble(jsynth(8, seed=d), max_len=16, pad_traces_to=10,
                     config=JaxFeatConfig(service_vocab=64, name_vocab=128))
    T, L = seqs.mask.shape
    dec = np.random.default_rng(d).normal(0, 1, (T, L, d)).astype(
        np.float32)
    p, c = v["params"], jm.cfg
    y = fnn.LayerNorm(dtype=jnp.float32).apply(
        {"params": p["dec_ln"]}, jnp.asarray(dec))
    out = {name: fnn.Dense(V, dtype=jnp.float32).apply(
        {"params": p[f"{name}_head"]}, y)
        for name, V in (("service", c.service_vocab),
                        ("name", c.name_vocab), ("kind", 8),
                        ("duration", 1))}
    ref = c.w_service * _ce(out["service"], seqs.categorical[..., 0])
    ref += c.w_name * _ce(out["name"], seqs.categorical[..., 1])
    ref += c.w_kind * _ce(out["kind"], seqs.categorical[..., 2])
    ref += c.w_duration * (out["duration"][..., 0]
                           - seqs.continuous[..., 0]) ** 2
    ref = np.asarray(ref) * seqs.mask
    m = pm.module
    got = krecon.recon_ce(
        torch.from_numpy(dec).reshape(T * L, d), m.dec_ln.weight,
        m.dec_ln.bias, m.heads(),
        torch.from_numpy(seqs.categorical).reshape(T * L, -1),
        torch.from_numpy(seqs.continuous).reshape(T * L, -1),
        torch.from_numpy(seqs.mask).reshape(-1),
        (c.w_service, c.w_name, c.w_kind, c.w_duration)).view(T, L)
    np.testing.assert_allclose(got.detach().numpy(), ref, atol=F32_TOL,
                               rtol=F32_TOL)


def test_k11_route_for_unsplittable_heads_is_the_cuda_core_kernel():
    """Heads of 1e-36 lie below the three planes' range: the split says
    so without raising, and the model names the CUDA-core kernel, chosen
    when the weights change (never on a launch)."""
    pm = SpanAutoencoder(AutoencoderConfig(**AE512), device="cpu", seed=1)
    assert pm.recon_route == "tc"
    assert pm.module.head_planes() is not None
    with torch.no_grad():
        pm.module.service_head.weight.fill_(1e-36)
    assert krecon.split_planes(pm.module.heads()) is None
    assert pm.module.head_planes() is None
    assert pm.recon_route == "cuda_core"
    assert krecon.kernel_route(torch.bfloat16, False) == "cuda_core"
    assert krecon.kernel_route(torch.bfloat16) == "tc"
    assert krecon.kernel_route(torch.float32) == "cuda_core"
    with pytest.raises(ValueError, match="three-plane"):
        krecon.head_planes(pm.module.heads())
    eng = ScoringEngine(EngineConfig(model="autoencoder", device="cpu",
                                     model_config=AutoencoderConfig(
                                         **AE512)))
    assert eng.stats()["recon_route"] == "tc"


# ----------------------------------- K1's tiled online softmax (host model)

TILE = 64


def _tiled_attention_model(q, k, v, seg):
    """The tiled kernels' algorithm (``csrc/segment_attention.cu``
    ``flash`` / ``tiled``) in f64 on the host: per (row, head) and block
    of 64 queries, the key tiles the block needs (every tile when a query
    of the block is padding, else those whose live segments meet the
    block's live range), an online softmax over them with the finite
    finfo.min fill and no weight past L, the output divided once."""
    R, L, H, hd = q.shape
    big_neg = float(torch.finfo(q.dtype).min)
    qs = (q / float(torch.tensor(hd ** 0.5, dtype=torch.float32).to(
        q.dtype))).to(q.dtype).double()
    kk, vv = k.double(), v.double()
    out = torch.zeros(R, L, H, hd, dtype=torch.float64)
    nt = -(-L // TILE)
    for r in range(R):
        s_r = seg[r].tolist()
        tiles_live = []
        for t in range(nt):
            live = [x for x in s_r[t * TILE:(t + 1) * TILE] if x > 0]
            tiles_live.append((min(live), max(live)) if live else None)
        for q0 in range(0, L, TILE):
            qseg = s_r[q0:q0 + TILE]
            pad = any(x <= 0 for x in qseg)
            live = [x for x in qseg if x > 0]
            need = [t for t in range(nt) if pad or (
                tiles_live[t] is not None and live
                and tiles_live[t][0] <= max(live)
                and tiles_live[t][1] >= min(live))]
            n = len(qseg)
            sq = torch.tensor(qseg)
            for h in range(H):
                m = torch.full((n,), -float("inf"), dtype=torch.float64)
                lsum = torch.zeros(n, dtype=torch.float64)
                acc = torch.zeros(n, hd, dtype=torch.float64)
                for t in need:
                    keys = torch.arange(t * TILE, min(L, t * TILE + TILE))
                    s = qs[r, q0:q0 + n, h] @ kk[r, keys, h].T
                    sk = seg[r, keys]
                    ok = (sq[:, None] == sk[None, :]) & (sq[:, None] > 0)
                    s = torch.where(ok, s, torch.full_like(s, big_neg))
                    mn = torch.maximum(m, s.max(1).values)
                    alpha = torch.exp(m - mn)
                    p = torch.exp(s - mn[:, None])
                    lsum = lsum * alpha + p.sum(1)
                    acc = acc * alpha[:, None] + p @ vv[r, keys, h]
                    m = mn
                out[r, q0:q0 + n, h] = acc / lsum[:, None]
    return out.float()


def _frame(L: int, seed: int):
    """Packed rows at L: padding rows, padding slots in live rows, a
    single-slot segment and segments across the 64-key tile edges."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(3):
        row, pos, sid = np.zeros(L, np.int32), 0, 1
        while pos < L - 5:
            n = int(rng.integers(1, 40))
            row[pos:pos + n] = sid
            pos, sid = pos + n, sid + 1
        rows.append(row)
    single = np.zeros(L, np.int32)
    single[TILE - 1] = 5           # one live slot at a tile's last key
    single[TILE:TILE + 3] = 6      # a segment right after the edge
    rows.append(single)
    rows.append(np.zeros(L, np.int32))  # all padding
    cross = np.zeros(L, np.int32)
    cross[TILE - 10:TILE + 30] = 1  # one segment across the edge
    rows.append(cross)
    return torch.from_numpy(np.stack(rows))


@pytest.mark.parametrize("L,H,hd", [(128, 2, 16), (200, 1, 8),
                                    (1024, 1, 8)])
def test_tiled_online_softmax_model_matches_plain(L, H, hd):
    seg = _frame(L, seed=L)
    R = seg.shape[0]
    rng = np.random.default_rng(L + hd)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, (R, L, H, hd)).astype(
        np.float32)) for _ in range(3))
    got = _tiled_attention_model(q, k, v, seg)
    ref = segment_attention_plain(q, k, v, seg)
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max().item() <= F32_TOL
    # the all-padding row averages V over the L slots, uniformly
    uniform = v[4].mean(0)
    assert (got[4] - uniform).abs().max().item() <= F32_TOL

"""The port's int8 (W8A8) scorer against the JAX package's, on the CPU.

The geometry is the reference's own int8 test's: d 128, 4 heads, 2
layers, d_ff 256, rows of L 32. Weights come from the JAX model's ``init``
and cross through ``flax_to_torch`` (the f32 values, quantized by the
port) or ``flax_quantized_to_torch`` (the JAX scorer's own codes); inputs
are ``pack_sequences`` rows of ``synthesize_traces`` or numpy draws from a
seed. On the CPU every kernel wrapper takes its plain version.

Bounds, and why:

* weight quantization (``quantize_state_dict``) is the JAX scorer's
  ``_prepare`` bit for bit, codes and scales;
* the activation quantize (K9's plain version, no LN) is exact against
  ``_qdense`` on the same input: codes and scales (``a_max * f32(1/127)``,
  the product XLA compiles ``a_max / 127.0`` into). It is read through
  ``_qdense`` with an identity weight, whose output is ``x_q * a_s``;
* the LayerNorm (LN mode) differs from ``_layernorm`` in the statistics'
  last bits — XLA sums in its own order, its rsqrt is within one f32 step
  of ``1 / sqrt`` and it contracts ``y * scale + bias`` into an FMA, while
  the port's sums are correctly rounded: f32 within ``LN_F32_RTOL`` of the
  row's largest output (a last-bit change of the mean moves every output
  of the row by the same amount), bf16 within one bf16 step; codes
  computed from them within 1;
* the product's epilogue (K10's plain version) against ``_qdense``: XLA
  on the CPU contracts ``acc * s + b`` into an FMA, the port rounds the
  product first (as K10 does, to match its plain version on the card):
  f32 within ``GEMM_F32_RTOL`` (a few f32 steps), bf16 within one bf16
  step;
* the scorer against the JAX scorer: the measured max with at most 2x
  headroom (``SCORER_F32_ATOL``; bf16 ``SCORER_BF16_MAX`` /
  ``SCORER_BF16_MEAN``, where K1, K2 and the GELU round at other places
  than the reference, ``models/quantized.py``'s docstring);
* int8 against the float path: < 0.05, the reference's own bound
  (``tests/test_features_models.py``);
* the engines (host route and fused route) against the JAX engine with
  ``quantized=True``: the scorer's f32 bounds (the same rows; measured
  max 5.0e-5, mean 1.6e-7); the fused route against the port's own host
  route: the reference's max 0.05 / mean 5e-3 (``tests/test_fused.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odigos_tpu.features.featurizer import featurize as jfeaturize
from odigos_tpu.features.featurizer import pack_sequences as jpack
from odigos_tpu.models.quantized import QuantizedTraceScorer as JaxScorer
from odigos_tpu.models.quantized import _layernorm, _qdense
from odigos_tpu.models.quantized import quantize_weight as jquantize_weight
from odigos_tpu.models.transformer import TraceTransformer as JaxTransformer
from odigos_tpu.models.transformer import TransformerConfig as JaxConfig
from odigos_tpu.pdata import synthesize_traces as jsynth
from odigos_tpu.serving.engine import EngineConfig as JaxEngineConfig
from odigos_tpu.serving.engine import ScoringEngine as JaxEngine
from odigos_tpu.serving.fused import extract_columns as jax_extract
from odigos_tpu_torch.features import FeaturizerConfig, featurize
from odigos_tpu_torch.kernels import qgemm as kq
from odigos_tpu_torch.kernels import quant as kquant
from odigos_tpu_torch.kernels.qgemm import qgemm, qgemm_plain
from odigos_tpu_torch.kernels.quant import (layer_norm_plain, ln_quantize,
                                            ln_quantize_plain)
from odigos_tpu_torch.models import (QuantizedTraceScorer, TraceTransformer,
                                     TransformerConfig,
                                     flax_quantized_to_torch, flax_to_torch,
                                     quantize_state_dict, quantize_weight)
from odigos_tpu_torch.models.quantized import int8_layout
from odigos_tpu_torch.pdata import synthesize_traces as psynth
from odigos_tpu_torch.serving import EngineConfig, ScoringEngine
from odigos_tpu_torch.serving.fused import extract_columns

torch.set_num_threads(1)

GEOM = dict(d_model=128, n_heads=4, n_layers=2, d_ff=256, max_len=32)
L = GEOM["max_len"]
SEEDS = (0, 1, 2)
LN_F32_RTOL = 2.0 ** -20        # f32 steps at the row's largest output
GEMM_F32_RTOL = 2.0 ** -21      # f32 steps at the row's largest output
# scorer vs JAX scorer over SCORER_CASES, measured on the CPU: f32 max
# 1.33e-3, mean 1.16e-5 (a few spans move where an activation code flips
# on a last-bit difference; the rest agree to ~1e-7); bf16 max 6.85e-3,
# mean 1.48e-3. Bounds: 2x those.
SCORER_F32_MAX = 2.7e-3
SCORER_F32_MEAN = 2.4e-5
SCORER_BF16_MAX = 1.4e-2
SCORER_BF16_MEAN = 3e-3
FLOAT_PATH_BOUND = 0.05         # tests/test_features_models.py


def _dt(f32: bool):
    return (jnp.float32, torch.float32) if f32 else (jnp.bfloat16,
                                                     torch.bfloat16)


def _pair(f32: bool, seed: int = 0, attr_slots: int = 0):
    """The JAX model, its variables and int8 scorer, and the port's int8
    scorer loaded from the same f32 weights."""
    jdt, tdt = _dt(f32)
    jm = JaxTransformer(JaxConfig(**GEOM, attr_slots=attr_slots, dtype=jdt))
    variables = jm.init(jax.random.PRNGKey(seed))
    cfg = TransformerConfig(**GEOM, attr_slots=attr_slots, dtype=tdt)
    pq = QuantizedTraceScorer(cfg, device="cpu")
    pq.load_state_dict(flax_to_torch(
        jax.tree_util.tree_map(np.asarray, variables), cfg))
    return jm, variables, JaxScorer(jm, variables), pq


def _packed(seed: int, attr_slots: int = 0, n: int = 64):
    batch = jsynth(n, seed=seed)
    return jpack(batch, max_len=L,
                 config=FeaturizerConfig(attr_slots=attr_slots),
                 pad_rows_to=lambda r: r + 1)


def _args(pk):
    return (pk.categorical, pk.continuous, pk.segments, pk.positions)


def _activations(seed: int, M: int = 96, K: int = 128) -> np.ndarray:
    """Rows of mixed scale, one all-zero row, as f32."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)) * rng.uniform(0.05, 8.0, (M, 1)) + \
        rng.uniform(-1, 1, (M, 1))
    x[3] = 0.0
    return x.astype(np.float32)


def _jnp(x: np.ndarray, jdt):
    return jnp.asarray(x).astype(jdt)


def _torch(x: np.ndarray, tdt):
    return torch.from_numpy(x).to(tdt)


def _f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32)) \
        if not isinstance(a, torch.Tensor) else a.float().numpy()


def _bf16_step(x: np.ndarray) -> np.ndarray:
    """One bf16 step at each value's magnitude."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


# -------------------------------------------------------- (a) the weights

@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("attr_slots", [0, 2])
def test_weight_quantization_is_the_jax_scorers(seed, attr_slots):
    """quantize_state_dict(flax_to_torch(params)) equals the JAX scorer's
    own int8 params, carried across: codes and scales exactly."""
    jm, v, js, pq = _pair(True, seed, attr_slots)
    cfg = pq.cfg
    mine = quantize_state_dict(flax_to_torch(
        jax.tree_util.tree_map(np.asarray, v), cfg), cfg)
    theirs = flax_quantized_to_torch(
        jax.tree_util.tree_map(np.asarray, js.params), cfg)
    assert set(mine) == set(theirs) == set(int8_layout(cfg))
    for k in mine:
        assert mine[k].dtype == theirs[k].dtype, k
        assert torch.equal(mine[k], theirs[k]), k
    n_int8 = sum(t.dtype == torch.int8 for t in mine.values())
    assert n_int8 == 6 * cfg.n_layers
    # the scorer holds exactly that tree
    for k, t in pq.state_dict().items():
        assert torch.equal(t, mine[k]), k


def test_quantize_weight_zero_channel_and_codes():
    w = torch.tensor([[0.0, 0.0, 0.0], [1.0, -0.5, 0.25],
                      [127.0, 63.5, -64.5]])
    w_q, s = quantize_weight(w)
    assert s[0].item() == 1.0 and (w_q[0] == 0).all()
    assert w_q[1].tolist() == [127, -64, 32]
    # s = 127 / 127 = 1: 63.5 and -64.5 round half to even
    assert s[2].item() == 1.0 and w_q[2].tolist() == [127, 64, -64]


def test_int8_trees_refuse_missing_or_unused_entries():
    jm, v, js, pq = _pair(True)
    cfg = pq.cfg
    state = flax_to_torch(jax.tree_util.tree_map(np.asarray, v), cfg)
    with pytest.raises(KeyError, match="missing"):
        quantize_state_dict({k: t for k, t in state.items()
                             if "ff1" not in k}, cfg)
    with pytest.raises(KeyError, match="unexpected"):
        quantize_state_dict({**state, "extra.weight": torch.zeros(1)}, cfg)
    qp = jax.tree_util.tree_map(np.asarray, js.params)
    qp["blocks"][0]["extra"] = {"w": np.zeros(1, np.int8)}
    with pytest.raises(KeyError, match="not carried across"):
        flax_quantized_to_torch(qp, cfg)
    del qp["blocks"][0]["extra"], qp["blocks"][1]["ffn2"]
    with pytest.raises(KeyError, match="missing"):
        flax_quantized_to_torch(qp, cfg)
    tree = quantize_state_dict(state, cfg)
    tree["encoder.blocks.0.ff1.weight"] = \
        tree["encoder.blocks.0.ff1.weight"].float()
    with pytest.raises(ValueError, match="int8"):
        pq.load_quantized(tree)


# ------------------------------------------------- (b) K9 / K10's plain

def _jax_codes_times_scale(x, jdt):
    """_qdense through an identity weight: x_q * a_s, f32."""
    K = x.shape[-1]
    eye = jnp.eye(K, dtype=jnp.int8)
    return np.asarray(jax.jit(lambda t: _qdense(
        t, eye, jnp.ones(K, jnp.float32), None, jnp.float32))(x))


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
@pytest.mark.parametrize("seed", SEEDS)
def test_quantize_codes_and_scales_are_the_references(f32, seed):
    """Exact: every x_q * a_s of _qdense equals the port's, so codes and
    scales agree (the row's absmax maps to ±127, fixing a_s)."""
    jdt, tdt = _dt(f32)
    x = _activations(seed)
    ref = _jax_codes_times_scale(_jnp(x, jdt), jdt)
    x_q, a_s = ln_quantize_plain(_torch(x, tdt))
    assert x_q.dtype == torch.int8 and a_s.dtype == torch.float32
    got = (x_q.float() * a_s[:, None]).numpy()
    np.testing.assert_array_equal(got, ref)
    assert a_s[3].item() == 1.0 and (x_q[3] == 0).all()  # the zero row
    assert (x_q.abs().amax(1)[a_s != 1.0] == 127).all()


def test_quantize_rounds_half_to_even():
    """a_s == 1 exactly (absmax 127): .5 codes go to the even neighbour,
    as jnp.round does."""
    row = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, -3.5]],
                   np.float32)
    x_q, a_s = ln_quantize_plain(torch.from_numpy(row))
    assert a_s.item() == 1.0
    assert x_q[0].tolist() == [127, 0, 2, 2, 0, -2, 4, -4]
    ref = _jax_codes_times_scale(jnp.asarray(row), jnp.float32)
    np.testing.assert_array_equal(x_q.float().numpy(), ref)


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
@pytest.mark.parametrize("seed", SEEDS)
def test_layernorm_quantize_against_the_reference(f32, seed):
    jdt, tdt = _dt(f32)
    rng = np.random.default_rng(100 + seed)
    x = _activations(seed)
    K = x.shape[1]
    g = (1 + 0.3 * rng.standard_normal(K)).astype(np.float32)
    b = (0.2 * rng.standard_normal(K)).astype(np.float32)
    ref = _f32(jax.jit(lambda t: _layernorm(t, g, b, jdt))(_jnp(x, jdt)))
    tg, tb = torch.from_numpy(g), torch.from_numpy(b)
    got = _f32(layer_norm_plain(_torch(x, tdt), tg, tb))
    if f32:
        row_max = np.abs(ref).max(1, keepdims=True)
        assert (np.abs(got - ref) <= LN_F32_RTOL * row_max).all()
    else:
        assert (np.abs(got - ref) <= _bf16_step(ref)).all()
    # codes from the LN output: within one code of the reference's, and
    # nearly all equal (a code moves only where a last-bit difference of
    # the LN output crosses a rounding boundary)
    x_q, a_s = ln_quantize_plain(_torch(x, tdt), tg, tb)
    ref_qs = _jax_codes_times_scale(
        jax.jit(lambda t: _layernorm(t, g, b, jdt))(_jnp(x, jdt)), jdt)
    ref_as = np.abs(ref_qs).max(1) / 127
    ref_codes = np.rint(ref_qs / np.where(ref_as > 0, ref_as, 1)[:, None])
    assert np.abs(x_q.numpy() - ref_codes).max() <= 1
    assert (x_q.numpy() == ref_codes).mean() > 0.99
    np.testing.assert_allclose(a_s.numpy(), np.where(ref_as > 0, ref_as, 1),
                               rtol=2.0 ** -7)


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
@pytest.mark.parametrize("epilogue", ["none", "residual", "gelu_tanh"])
def test_qgemm_plain_against_qdense(f32, epilogue):
    jdt, tdt = _dt(f32)
    rng = np.random.default_rng(7)
    x = _activations(1)
    K, N = x.shape[1], 192
    w = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(N)).astype(np.float32)
    res = rng.standard_normal((x.shape[0], N)).astype(np.float32)
    wq_j, ws_j = jquantize_weight(jnp.asarray(w))
    w_q, w_s = quantize_weight(torch.from_numpy(w.T.copy()))
    np.testing.assert_array_equal(w_q.numpy(), np.asarray(wq_j).T)
    np.testing.assert_array_equal(w_s.numpy(), np.asarray(ws_j))

    def jax_fn(t, r):
        y = _qdense(t, wq_j, ws_j, bias, jdt)
        if epilogue == "residual":
            return r + y
        return jax.nn.gelu(y) if epilogue == "gelu_tanh" else y

    ref = _f32(jax.jit(jax_fn)(_jnp(x, jdt), _jnp(res, jdt)))
    x_q, a_s = ln_quantize_plain(_torch(x, tdt))
    got = qgemm_plain(x_q, w_q, a_s, w_s, torch.from_numpy(bias), tdt,
                      epilogue, _torch(res, tdt)
                      if epilogue == "residual" else None)
    assert got.dtype == tdt and got.shape == (x.shape[0], N)
    got = _f32(got)
    if f32:
        # the FMA's difference is a step of acc * s, not of the sum
        scale = np.abs(ref).max(1, keepdims=True) + np.abs(bias).max()
        assert (np.abs(got - ref) <= GEMM_F32_RTOL * scale).all()
    elif epilogue != "gelu_tanh":
        assert (np.abs(got - ref) <= _bf16_step(ref)).all()
        assert (got == ref).mean() > 0.99
    else:
        # jax.nn.gelu on bf16 works in bf16: 1 + tanh(.) loses up to a
        # bf16 step of the cdf (2**-7) to cancellation, times the input;
        # the port's GELU runs in f32 and rounds once
        pre = _f32(qgemm_plain(x_q, w_q, a_s, w_s, torch.from_numpy(bias),
                               tdt))
        assert (np.abs(got - ref) <= 2 * _bf16_step(ref)
                + 2.0 ** -7 * np.abs(pre)).all()


def test_qgemm_plain_is_exact_past_f32_integers():
    """K = 1024 at ±127: |acc| reaches 1024 * 127^2 > 2^24 / 2; the f64
    product keeps every integer."""
    M, N, K = 4, 8, 1024
    x_q = torch.full((M, K), 127, dtype=torch.int8)
    x_q[1] = -127
    x_q[2, ::2] = -127
    w_q = torch.full((N, K), 127, dtype=torch.int8)
    w_q[3, 1] = 126
    ones = torch.ones
    y = qgemm_plain(x_q, w_q, ones(M), ones(N), torch.zeros(N),
                    torch.float32)
    acc = x_q.long() @ w_q.long().t()
    assert torch.equal(y, acc.float())
    assert acc.abs().max().item() == K * 127 * 127


def test_qgemm_planes_split_columns():
    rng = np.random.default_rng(3)
    x_q = torch.from_numpy(rng.integers(-127, 128, (6, 32), dtype=np.int8))
    w_q = torch.from_numpy(rng.integers(-127, 128, (48, 32), dtype=np.int8))
    a_s, w_s = torch.rand(6) + 0.1, torch.rand(48) + 0.1
    b = torch.randn(48)
    full = qgemm_plain(x_q, w_q, a_s, w_s, b, torch.float32)
    split = qgemm_plain(x_q, w_q, a_s, w_s, b, torch.float32, planes=3)
    assert split.shape == (3, 6, 16) and split.is_contiguous()
    for i in range(3):
        assert torch.equal(split[i], full[:, 16 * i:16 * (i + 1)])


def test_wrappers_take_the_plain_version_on_the_cpu():
    x = torch.randn(8, 64)
    kquant.launches = kq.launches = 0
    x_q, a_s = ln_quantize(x, torch.ones(64), torch.zeros(64))
    assert all(torch.equal(a, b) for a, b in zip(
        (x_q, a_s), ln_quantize_plain(x, torch.ones(64), torch.zeros(64))))
    w_q = torch.ones(16, 64, dtype=torch.int8)
    y = qgemm(x_q, w_q, a_s, torch.ones(16), torch.zeros(16),
              torch.float32, "gelu_tanh")
    assert torch.equal(y, qgemm_plain(x_q, w_q, a_s, torch.ones(16),
                                      torch.zeros(16), torch.float32,
                                      "gelu_tanh"))
    assert kquant.launches == 0 and kq.launches == 0
    with pytest.raises(ValueError, match="epilogue"):
        qgemm(x_q, w_q, a_s, torch.ones(16), torch.zeros(16),
              torch.float32, "relu")
    with pytest.raises(ValueError, match="residual"):
        qgemm(x_q, w_q, a_s, torch.ones(16), torch.zeros(16),
              torch.float32, "residual")
    with pytest.raises(ValueError, match="LN mode"):
        ln_quantize(x, torch.ones(64))


def _ffn1_case(f32: bool, M: int = 77, N: int = 96, K: int = 64,
               seed: int = 4):
    """FFN1's inputs at ragged M: random codes with one all-zero row (its
    h is gelu(0) = 0 with b = 0: scale 1), and a row whose y = 1 + b lands
    on exact .5 ties of h / a_s (a_s = 1 from its absmax 127; gelu(y) = y
    there in f32)."""
    rng = np.random.default_rng(seed)
    x_q = torch.from_numpy(rng.integers(-127, 128, (M, K), dtype=np.int8))
    w_q = torch.from_numpy(rng.integers(-127, 128, (N, K), dtype=np.int8))
    a_s = torch.from_numpy(rng.uniform(1e-3, 0.05, M).astype(np.float32))
    w_s = torch.from_numpy(rng.uniform(1e-4, 2e-3, N).astype(np.float32))
    b = torch.from_numpy((0.1 * rng.standard_normal(N)).astype(np.float32))
    x_q[5] = 0
    x_q[9] = 0
    x_q[9, 0] = 1
    w_q[:, 0] = 1
    w_s[:] = 1.0
    a_s[9] = 1.0
    # row 9: y = x_q[9] . w_q[n] * (1 * 1) + b = 1 + b
    ties = np.tile([5.5, 6.5, 7.5, 126.5, 127.0, -6.5], N)[:N]
    b[:] = torch.from_numpy((ties - 1.0).astype(np.float32))
    return x_q, w_q, a_s, w_s, b, _dt(f32)[1]


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_qgemm_plain_gelu_quant_is_the_two_plain_steps(f32):
    """"gelu_tanh_quant" is "gelu_tanh" then K9's plain mode, bit for bit:
    ragged M, a zero h row (scale 1), exact .5 ties rounded half to even;
    and its codes times scales are the JAX scorer's _qdense quantize of
    the same GELU output."""
    x_q, w_q, a_s, w_s, b, tdt = _ffn1_case(f32)
    got = qgemm_plain(x_q, w_q, a_s, w_s, b, tdt, "gelu_tanh_quant")
    h = qgemm_plain(x_q, w_q, a_s, w_s, b, tdt, "gelu_tanh")
    ref = ln_quantize_plain(h)
    assert got[0].dtype == torch.int8 and got[1].dtype == torch.float32
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert got[1][9].item() == 1.0
    q = h[9].float() / got[1][9]
    assert int((q.frac().abs() == 0.5).sum()) >= 3
    assert got[0][9, :3].tolist() == [6, 6, 8]  # 5.5, 6.5, 7.5: to even
    jdt = _dt(f32)[0]
    jref = _jax_codes_times_scale(_jnp(_f32(h), jdt), jdt)
    np.testing.assert_array_equal(
        (got[0].float() * got[1][:, None]).numpy(), jref)
    # b = 0: the zero codes' row has y = 0, h = 0, scale 1, codes 0
    zero = qgemm_plain(x_q, w_q, a_s, w_s, torch.zeros_like(b), tdt,
                       "gelu_tanh_quant")
    assert zero[1][5].item() == 1.0 and (zero[0][5] == 0).all()
    assert torch.equal(zero[0], ln_quantize_plain(qgemm_plain(
        x_q, w_q, a_s, w_s, torch.zeros_like(b), tdt, "gelu_tanh"))[0])


def test_gelu_quant_wrapper_takes_the_plain_version_and_refuses():
    """On the CPU the wrapper returns the plain version's codes and scales
    without launching; on every device it refuses what the kernel does
    not take: N > 1024, the f32 working type, K > 256, a residual."""
    x_q, w_q, a_s, w_s, b, tdt = _ffn1_case(False)
    kq.launches = 0
    got = qgemm(x_q, w_q, a_s, w_s, b, tdt, "gelu_tanh_quant")
    ref = qgemm_plain(x_q, w_q, a_s, w_s, b, tdt, "gelu_tanh_quant")
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert kq.launches == 0
    assert kq.fused_quant_takes(1024, 256, torch.bfloat16)
    assert not kq.fused_quant_takes(1032, 256, torch.bfloat16)
    wide = torch.ones(1032, x_q.shape[1], dtype=torch.int8)
    ones = torch.ones(1032)
    with pytest.raises(ValueError, match="N <= 1024"):
        qgemm(x_q, wide, a_s, ones, ones, tdt, "gelu_tanh_quant")
    with pytest.raises(ValueError, match="bf16"):
        qgemm(x_q, w_q, a_s, w_s, b, torch.float32, "gelu_tanh_quant")
    deep = torch.ones(x_q.shape[0], 272, dtype=torch.int8)
    with pytest.raises(ValueError, match="K <= 256"):
        qgemm(deep, torch.ones(96, 272, dtype=torch.int8), a_s, w_s, b, tdt,
              "gelu_tanh_quant")
    with pytest.raises(ValueError, match="residual"):
        qgemm(x_q, w_q, a_s, w_s, b, tdt, "gelu_tanh_quant",
              torch.zeros(x_q.shape[0], 96, dtype=tdt))
    with pytest.raises(ValueError, match="residual"):
        qgemm_plain(x_q, w_q, a_s, w_s, b, tdt, "gelu_tanh_quant",
                    torch.zeros(x_q.shape[0], 96, dtype=tdt))


# ----------------------------------------------- (c), (d) the scorer

SCORER_CASES = [(s, a) for s in SEEDS for a in (0, 2)]


@pytest.mark.parametrize("seed,attr_slots", SCORER_CASES)
def test_scorer_f32_matches_the_jax_scorer(seed, attr_slots):
    jm, v, js, pq = _pair(True, seed, attr_slots)
    pk = _packed(seed + 3, attr_slots)
    ref = np.asarray(js.score_packed(*map(jnp.asarray, _args(pk))))
    got = pq.score_packed(*_args(pk)).numpy()
    assert got.shape == ref.shape and got.dtype == np.float32
    m = pk.segments > 0
    d = np.abs(got[m] - ref[m])
    assert d.max() <= SCORER_F32_MAX and d.mean() <= SCORER_F32_MEAN


@pytest.mark.parametrize("seed,attr_slots", SCORER_CASES)
def test_scorer_bf16_matches_the_jax_scorer(seed, attr_slots):
    jm, v, js, pq = _pair(False, seed, attr_slots)
    pk = _packed(seed + 3, attr_slots)
    ref = np.asarray(js.score_packed(*map(jnp.asarray, _args(pk))))
    got = pq.score_packed(*_args(pk)).numpy()
    m = pk.segments > 0
    d = np.abs(got[m] - ref[m])
    assert d.max() <= SCORER_BF16_MAX and d.mean() <= SCORER_BF16_MEAN


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_scorer_serves_ffn1_as_two_steps(f32, monkeypatch):
    """Both working types serve FFN1 as K10 "gelu_tanh" then K9 (four K9
    and four K10 steps a layer); swapping each such pair for the one-launch
    "gelu_tanh_quant" mode leaves the scores equal bit for bit."""
    import odigos_tpu_torch.models.quantized as mq

    jm, v, js, pq = _pair(f32, 0)
    pk = _packed(3)
    epilogues, k9 = [], []

    def gemm(*a, **k):
        epilogues.append(a[6] if len(a) > 6 else k.get("epilogue", "none"))
        return qgemm_plain(*a, **k)

    def quant(*a):
        k9.append(len(a) > 1)
        return ln_quantize_plain(*a)

    monkeypatch.setattr(mq, "qgemm_plain", gemm)
    monkeypatch.setattr(mq, "ln_quantize_plain", quant)
    two = pq.score_packed(*_args(pk), reference=True)
    n = pq.cfg.n_layers
    assert epilogues == ["none", "residual", "gelu_tanh", "residual"] * n
    assert k9 == [True, False, True, False] * n  # LN1, ctx, LN2, GELU out
    fused = {}

    def gemm_fused(*a, **k):
        h = qgemm_plain(*a, **k)
        if a[6:7] == ("gelu_tanh",):
            fused[id(h)] = qgemm_plain(*a[:6], "gelu_tanh_quant")
        return h

    def quant_fused(*a):
        return fused.pop(id(a[0])) if id(a[0]) in fused else \
            ln_quantize_plain(*a)

    monkeypatch.setattr(mq, "qgemm_plain", gemm_fused)
    monkeypatch.setattr(mq, "ln_quantize_plain", quant_fused)
    got = pq.score_packed(*_args(pk), reference=True)
    assert not fused
    assert torch.equal(got, two)


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
@pytest.mark.parametrize("seed", SEEDS)
def test_int8_tracks_the_float_path(f32, seed):
    """The reference's own bound: int8 within 0.05 of the float model on
    the same f32 weights (the port's float path)."""
    jm, v, js, pq = _pair(f32, seed)
    fm = TraceTransformer(pq.cfg, device="cpu")
    fm.load_state_dict(flax_to_torch(jax.tree_util.tree_map(np.asarray, v),
                                     pq.cfg))
    pk = _packed(seed + 3)
    m = pk.segments > 0
    got = pq.score_packed(*_args(pk)).numpy()[m]
    flt = fm.score_packed(*_args(pk)).numpy()[m]
    assert np.abs(got - flt).max() < FLOAT_PATH_BOUND


def test_scatter_forward_and_reference_route_agree_on_the_cpu():
    jm, v, js, pq = _pair(False)
    pk = _packed(5)
    probs = pq.score_packed(*_args(pk)).numpy()
    assert np.array_equal(probs, pq.score_packed(*_args(pk),
                                                 reference=True).numpy())
    rows, cols = np.nonzero(pk.mask)
    perm = torch.from_numpy(pk.span_index[rows, cols].astype(np.int32))
    got = pq.score_packed_scatter(
        *_args(pk), perm, torch.from_numpy(rows.astype(np.int32)),
        torch.from_numpy(cols.astype(np.int32)), len(rows)).numpy()
    want = np.zeros(len(rows), np.float32)
    want[pk.span_index[pk.mask]] = probs[pk.mask]
    np.testing.assert_allclose(got, want, atol=2e-3)  # K8's bf16 bound


# ---------------------------------------------------- (g) seeded weights

@pytest.mark.parametrize("seed", [0, 5])
def test_seeded_scorer_quantizes_the_f32_draws(seed):
    """The seed's f32 draws (the float model's, before its cast of the
    block weights to bf16) are what gets quantized, not the bf16 copies."""
    cfg = TransformerConfig(**GEOM)
    pq = QuantizedTraceScorer(cfg, device="cpu", seed=seed)
    f32 = TraceTransformer(TransformerConfig(**GEOM, dtype=torch.float32),
                           device="cpu", seed=seed).state_dict()
    want = quantize_state_dict(f32, cfg)
    got = pq.state_dict()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    bf16 = TraceTransformer(cfg, device="cpu", seed=seed).state_dict()
    from_bf16 = quantize_state_dict({k: t.float() for k, t in bf16.items()},
                                    cfg)
    assert any(not torch.equal(got[k], from_bf16[k]) for k in got
               if k.endswith(".scale"))
    assert not any(t.dtype == torch.bfloat16 for t in got.values())


# ------------------------------------------------------- (e), (f) engine

@pytest.fixture(scope="module")
def engines():
    """Unstarted JAX and port engines serving int8 on the same f32
    weights, the port's requantized through ``load_state_dict``."""
    je = JaxEngine(JaxEngineConfig(
        model="transformer", quantized=True,
        model_config=JaxConfig(**GEOM, dtype=jnp.float32), max_len=L,
        trace_bucket=8, bucket_ladder=2))
    pe = ScoringEngine(EngineConfig(
        model="transformer", quantized=True, device="cpu",
        model_config=TransformerConfig(**GEOM, dtype=torch.float32),
        max_len=L, trace_bucket=8, bucket_ladder=2))
    pe.backend.model.load_state_dict(flax_to_torch(
        jax.tree_util.tree_map(np.asarray, je.backend.variables),
        pe.backend.model.cfg))
    return je, pe


def test_engine_serves_the_int8_scorer_requantized(engines):
    je, pe = engines
    model = pe.backend.model
    assert isinstance(model, QuantizedTraceScorer)
    assert pe.stats()["quantized"] is True
    theirs = flax_quantized_to_torch(
        jax.tree_util.tree_map(np.asarray, je.backend._quantized.params),
        model.cfg)
    for k, t in model.state_dict().items():
        assert torch.equal(t, theirs[k]), k


@pytest.mark.parametrize("seed", [3, 4])
def test_engine_host_route_matches_the_jax_engine(engines, seed):
    je, pe = engines
    jb, pb = jsynth(40, seed=seed), psynth(40, seed=seed)
    ref = je.backend.score(jb, jfeaturize(jb))
    got = pe.backend.score(pb, featurize(pb))
    assert got.shape == ref.shape and got.dtype == np.float32
    d = np.abs(got - ref)
    assert d.max() <= SCORER_F32_MAX and d.mean() <= SCORER_F32_MEAN


@pytest.mark.parametrize("seed", [3, 5])
def test_engine_fused_route_matches_the_jax_engine(engines, seed):
    je, pe = engines
    jb, pb = jsynth(40, seed=seed), psynth(40, seed=seed)
    jcols, jr = jax_extract(jb)
    pcols, pr = extract_columns(pb)
    assert jr is None and pr is None and pe.backend.supports_fused
    ref = je.backend.harvest(je.backend.dispatch_columns([jcols]))
    got = pe.backend.harvest(pe.backend.dispatch_columns([pcols]))
    d = np.abs(got - ref)
    assert d.max() <= SCORER_F32_MAX and d.mean() <= SCORER_F32_MEAN
    # and the port's own host route, as the reference holds its own
    host = pe.backend.score(pb, featurize(pb))
    assert np.abs(got - host).max() < 0.05
    assert np.abs(got - host).mean() < 5e-3


def test_started_engine_scores_int8_through_submit_columns():
    eng = ScoringEngine(EngineConfig(
        model="transformer", quantized=True, device="cpu",
        model_config=TransformerConfig(**GEOM), max_len=L,
        trace_bucket=8, bucket_ladder=2)).start()
    try:
        b = psynth(20, seed=1)
        req = eng.submit(b, columns=extract_columns(b)[0])
        assert req is not None and req.done.wait(120)
        s = req.scores
        assert len(s) == len(b) and ((s >= 0) & (s <= 1)).all()
        host = eng.score_sync(b, timeout_s=120)
        assert np.abs(host - s).max() < 0.05
        assert eng.fused_calls == 1
    finally:
        eng.shutdown()


@pytest.mark.parametrize("model", ["zscore", "mock"])
def test_quantized_is_refused_for_other_models(model):
    with pytest.raises(ValueError, match="transformer"):
        EngineConfig(model=model, quantized=True, device="cpu")


def test_scorer_defaults_to_cuda_and_raises_without_a_card():
    import inspect

    assert inspect.signature(QuantizedTraceScorer).parameters[
        "device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this pins the no-card path")
    with pytest.raises(RuntimeError, match="cuda"):
        QuantizedTraceScorer(TransformerConfig(**GEOM))
    with pytest.raises(RuntimeError, match="cuda"):
        ScoringEngine(EngineConfig(model="transformer", quantized=True))

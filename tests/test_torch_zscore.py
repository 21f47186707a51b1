"""The port's z-score detector and its serial engine backends, against the
JAX package's.

Inputs are made with numpy from a seed and go to both packages: the JAX
detector on the CPU (its own jitted kernels, as its tests run them) and the
port's with ``device="cpu"`` (the plain versions of K3 and K4).

Bounds, and why:
* ``count`` is exact: it holds integers below 2**24 in any summation order.
* ``MEAN_ATOL`` / ``M2_RTOL`` / ``M2_ATOL``: the per-span terms are the same
  f32 numbers in both packages; the reference sums them in f32 one after
  another, the port in f64 rounded once, so the two differ by the
  reference's own rounding — a few f32 steps at means of 5-15 (one step is
  ~1e-6). Both are tighter than the reference's own streaming bound (mean
  atol 1e-4, M2 rtol 1e-3 / atol 1e-3, ``tests/test_features_models.py``).
* ``Z_RTOL`` / ``Z_ATOL``: z follows the state, |x - mean| / std.
* ``SCORE_ATOL``: the squash ``1 - exp(-z / 4)`` has slope at most 1/4, and
  torch's and numpy's f32 ``exp`` may differ by an ulp.
"""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odigos_tpu.features.featurizer import featurize as jfeaturize
from odigos_tpu.models.zscore import ZScoreDetector as JaxDetector
from odigos_tpu.models.zscore import _group_ids as jax_group_ids
from odigos_tpu.models.zscore import _update_masked_kernel
from odigos_tpu.pdata import synthesize_traces as jsynth
from odigos_tpu.serving.engine import COLD_METRIC as JAX_COLD_METRIC
from odigos_tpu.serving.engine import EngineConfig as JaxEngineConfig
from odigos_tpu.serving.engine import ScoringEngine as JaxEngine
from odigos_tpu.utils.telemetry import meter
from odigos_tpu_torch.features import FeaturizerConfig, SpanFeatures, featurize
from odigos_tpu_torch.kernels import zscore as kz
from odigos_tpu_torch.models import ZScoreDetector, state_from_numpy
from odigos_tpu_torch.models.zscore import _group_ids
from odigos_tpu_torch.pdata import synthesize_traces as psynth
from odigos_tpu_torch.serving import EngineConfig, ScoringEngine
from odigos_tpu_torch.serving.engine import COLD_METRIC

torch.set_num_threads(1)

MEAN_ATOL = 1e-5
M2_RTOL = 1e-4
M2_ATOL = 1e-4
Z_RTOL = 1e-4
Z_ATOL = 1e-4
SCORE_ATOL = 1e-5


def _inputs(n: int, seed: int, n_svc: int = 6, n_name: int = 9,
            width: int = 5):
    """Synthetic ids and log-durations: a handful of groups (as real
    traffic has), durations around 5-15 like log(ns) of spans."""
    rng = np.random.default_rng(seed)
    cat = np.zeros((n, width), np.int32)
    cat[:, 0] = rng.integers(0, n_svc, n)
    cat[:, 1] = rng.integers(0, n_name, n)
    cat[:, 2:] = rng.integers(0, 4, (n, width - 2))
    base = 5.0 + cat[:, 0] * 1.5 + cat[:, 1] * 0.2
    x = (base + rng.normal(0.0, 0.4, n)).astype(np.float32)
    return cat, x


def _assert_state(port_state, jax_state):
    count, mean, m2 = (t.cpu().numpy() for t in port_state)
    np.testing.assert_array_equal(count, np.asarray(jax_state.count))
    np.testing.assert_allclose(mean, np.asarray(jax_state.mean), rtol=0,
                               atol=MEAN_ATOL)
    np.testing.assert_allclose(m2, np.asarray(jax_state.m2), rtol=M2_RTOL,
                               atol=M2_ATOL)


def _jax_state_after(n_groups: int, seed: int):
    """A non-empty JAX state: one update of 3000 spans."""
    det = JaxDetector(n_groups=n_groups)
    cat, x = _inputs(3000, seed)
    return det, det.update_fn(det.state, jnp.asarray(cat), jnp.asarray(x))


# ---------------------------------------------------------------- the hash
@pytest.mark.parametrize("n_groups", [64, 128, 1000, 8192])
def test_group_ids_match_jax_over_the_int32_range(n_groups):
    rng = np.random.default_rng(n_groups)
    cat = rng.integers(0, 2 ** 31 - 1, (20000, 5), endpoint=True).astype(
        np.int32)
    cat[:4, :2] = [[2 ** 31 - 1, 2 ** 31 - 1], [0, 0], [1, 0], [0, 1]]
    want = np.asarray(jax_group_ids(jnp.asarray(cat), n_groups))
    got = _group_ids(cat, n_groups)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------- functional kernels
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n_groups", [256, 8192])
def test_update_fn_matches_jax_from_a_converted_state(n_groups, masked):
    jdet, jstate = _jax_state_after(n_groups, seed=1)
    det = ZScoreDetector(n_groups=n_groups, device="cpu")
    state = state_from_numpy(jstate, device="cpu")
    _assert_state(state, jstate)  # the converter is exact
    cat, x = _inputs(1500, seed=2)
    if masked:
        w = (np.random.default_rng(3).random(1500) < 0.7).astype(np.float32)
        want = _update_masked_kernel(jstate, jnp.asarray(cat),
                                     jnp.asarray(x), jnp.asarray(w),
                                     n_groups)
        got = det.update_masked_fn(state, cat, x, w)
    else:
        want = jdet.update_fn(jstate, jnp.asarray(cat), jnp.asarray(x))
        got = det.update_fn(state, cat, x)
    _assert_state(got, want)
    # functional: the input state is left as it was
    _assert_state(state, jstate)


def test_score_fn_matches_jax_and_the_cold_gate_gives_zero():
    jdet, jstate = _jax_state_after(512, seed=4)
    det = ZScoreDetector(n_groups=512, min_count=32, device="cpu")
    state = state_from_numpy(jstate, device="cpu")
    cat, x = _inputs(2000, seed=5)
    cat[:50, 0] = 97  # groups never seen: count 0 < min_count
    x[50:60] += 3.0   # a few outliers
    want = np.asarray(jdet.score_fn(jstate, jnp.asarray(cat),
                                    jnp.asarray(x)))
    got = det.score_fn(state, cat, x).numpy()
    np.testing.assert_allclose(got, want, rtol=Z_RTOL, atol=Z_ATOL)
    assert (got[:50] == 0).all() and (want[:50] == 0).all()
    assert (got[50:60] > 3).all()


def test_score_squash_and_cold_count_plain():
    det = ZScoreDetector(n_groups=64, min_count=8, device="cpu")
    cat, x = _inputs(300, seed=6, n_svc=2, n_name=2)
    state = det.update_fn(det.state, cat[:200], x[:200])
    cat[250:, 0] = 40  # cold
    z, s, cold = kz.zscore_score(*state, torch.from_numpy(cat),
                                 torch.from_numpy(x), 64, 8, squash=True,
                                 n_valid=280)
    np.testing.assert_array_equal(s.numpy(), (1.0 - torch.exp(-z / 4.0))
                                  .numpy())
    assert int(cold) == int((z[:280] == 0).sum()) == 30


def test_update_route_follows_shared_memory():
    # 2 x G doubles of per-CTA sums (+ 16 KiB of warp staging) in 227 KiB
    assert kz.update_route(8192) == "shared"
    assert kz.update_route(13504) == "shared"
    assert kz.update_route(13505) == "global"


def test_kernels_refuse_devices_they_do_not_run_on():
    state = [torch.zeros(8, device="meta") for _ in range(3)]
    cat = torch.zeros((4, 5), dtype=torch.int32, device="meta")
    x = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        kz.zscore_score(*state, cat, x, 8, 32)
    with pytest.raises(ValueError, match="cuda or cpu"):
        kz.zscore_update(*state, cat, x, x, 8)


def test_a_failed_build_of_the_zscore_kernels_raises(monkeypatch, tmp_path):
    from odigos_tpu_torch.kernels import build

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "nvcc_path", lambda: shutil.which("false"))
    with pytest.raises(RuntimeError, match="kernel build failed: zscore"):
        build.build(["zscore"])
    assert not list(tmp_path.iterdir())  # nothing half-built is left


def test_a_stream_of_updates_matches_the_jax_stream():
    """20 updates of mixed sizes — bucket multiples, odd sizes, one of 0
    spans — through the bucketed stateful path of both packages."""
    jdet = JaxDetector(n_groups=1000, span_bucket=64)
    det = ZScoreDetector(n_groups=1000, span_bucket=64, device="cpu")
    sizes = [64, 1, 0, 100, 128, 37, 500, 64, 3, 257, 1024, 77, 2, 640,
             65, 129, 31, 900, 5, 256]
    assert len(sizes) == 20
    for i, n in enumerate(sizes):
        cat, x = _inputs(n, seed=100 + i)
        cont = np.zeros((n, 3), np.float32)
        cont[:, 0] = x
        jdet.update(_JaxFeatures(cat, cont))
        det.update(SpanFeatures(cat, cont))
        _assert_state(det.state, jdet.state)
    cat, x = _inputs(333, seed=7)
    cont = np.zeros((333, 3), np.float32)
    cont[:, 0] = x
    np.testing.assert_allclose(det.score(SpanFeatures(cat, cont)),
                               jdet.score(_JaxFeatures(cat, cont)),
                               rtol=Z_RTOL, atol=Z_ATOL)


class _JaxFeatures:
    """The two fields ``odigos_tpu``'s detector reads from SpanFeatures."""

    def __init__(self, categorical, continuous):
        self.categorical = categorical
        self.continuous = continuous


def test_warm_leaves_the_state_bit_identical():
    det = ZScoreDetector(n_groups=256, span_bucket=32, device="cpu")
    cat, x = _inputs(700, seed=8)
    det.state = det.update_fn(det.state, cat, x)
    before = [t.clone() for t in det.state]
    det.warm(max_spans=200, cat_width=5)
    for a, b in zip(before, det.state):
        assert torch.equal(a, b)
    # the zero-weight update warm() runs is itself the identity, bit for bit
    st = det.stage(SpanFeatures(cat[:100], np.stack([x[:100]] * 3, 1)))
    same = det.update_masked_fn(det.state, st.cat, st.x,
                                torch.zeros_like(st.w))
    for a, b in zip(before, same):
        assert torch.equal(a, b)
    # warm() made the staging buffers of every bucket, one past the cap
    assert sorted(b for b, _ in det._staging) == [32, 64, 128, 256, 512]


# ------------------------------------- twins of the reference's zscore tests
def test_zscore_flags_latency_outlier():
    rng = np.random.default_rng(0)
    n = 2000
    cat = np.zeros((n, 5), np.int32)
    cat[:, 0] = 7
    cat[:, 1] = 13
    log_dur = rng.normal(5.0, 0.3, n).astype(np.float32)
    det = ZScoreDetector(n_groups=256, min_count=16, device="cpu")
    det.state = det.update_fn(det.state, cat, log_dur)
    z = det.score_fn(det.state, cat[:2],
                     np.array([5.0, 5.0 + np.log(10)], np.float32)).numpy()
    assert z[0] < 2.0 and z[1] > 4.0


def test_zscore_cold_group_scores_zero():
    det = ZScoreDetector(n_groups=64, min_count=8, device="cpu")
    z = det.score_fn(det.state, np.zeros((4, 5), np.int32),
                     np.ones(4, np.float32)).numpy()
    np.testing.assert_array_equal(z, 0.0)


def test_zscore_streaming_merge_matches_batch():
    rng = np.random.default_rng(1)
    cat = np.zeros((500, 5), np.int32)
    cat[:, 0] = rng.integers(0, 4, 500)
    vals = rng.normal(3.0, 1.0, 500).astype(np.float32)
    det_a = ZScoreDetector(n_groups=128, device="cpu")
    det_b = ZScoreDetector(n_groups=128, device="cpu")
    det_a.state = det_a.update_fn(det_a.state, cat, vals)
    det_b.state = det_b.update_fn(det_b.state, cat[:200], vals[:200])
    det_b.state = det_b.update_fn(det_b.state, cat[200:], vals[200:])
    np.testing.assert_allclose(det_a.state.mean, det_b.state.mean, atol=1e-4)
    np.testing.assert_allclose(det_a.state.m2, det_b.state.m2, rtol=1e-3,
                               atol=1e-3)


def test_detector_defaults_to_cuda_and_raises_without_a_card():
    assert ZScoreDetector.device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this pins the no-card path")
    with pytest.raises(RuntimeError, match="is_available"):
        ZScoreDetector()
    with pytest.raises(RuntimeError, match="is_available"):
        ScoringEngine(EngineConfig(model="zscore"))


# ------------------------------------------------------------------ engine
def test_zscore_engine_matches_the_jax_engine():
    """Warm-up then 8 batches through both started engines: the state
    after the warm-up folds the batch in twice (backend warmup, then the
    online update of its score), scores and cold counts agree, depth 1."""
    warm_j, warm_p = jsynth(400, seed=7), psynth(400, seed=7)
    je = JaxEngine(JaxEngineConfig(model="zscore"))
    pe = ScoringEngine(EngineConfig(model="zscore", device="cpu"))
    assert pe.cfg.model == EngineConfig().model == "zscore"
    je.warmup(warm_j)
    pe.warmup(warm_p)
    _assert_state(pe.backend.det.state, je.backend.det.state)
    once = JaxDetector()
    once.update(jfeaturize(warm_j))
    np.testing.assert_array_equal(pe.backend.det.state.count.numpy(),
                                  2 * np.asarray(once.state.count))
    meter.reset()
    je.start()
    pe.start()
    try:
        for i in range(8):
            n = 5 + 13 * i
            want = je.score_sync(jsynth(n, seed=60 + i), timeout_s=120)
            got = pe.score_sync(psynth(n, seed=60 + i), timeout_s=120)
            assert want is not None and got is not None
            assert got.dtype == np.float32 and got.shape == want.shape
            np.testing.assert_allclose(got, want, rtol=0, atol=SCORE_ATOL)
            assert ((got >= 0) & (got <= 1)).all()
    finally:
        je.shutdown()
        pe.shutdown()
    _assert_state(pe.backend.det.state, je.backend.det.state)
    stats = pe.stats()
    assert stats["pipeline_depth"] == 1 and stats["device_calls"] == 8
    assert stats[COLD_METRIC] == meter.counter(JAX_COLD_METRIC)


def test_zscore_engine_counts_cold_spans_like_the_jax_engine():
    """No warm-up: the first calls score cold groups (count < 32) and
    later ones warm, so the cold count is neither 0 nor every span."""
    je = JaxEngine(JaxEngineConfig(model="zscore"))
    pe = ScoringEngine(EngineConfig(model="zscore", device="cpu",
                                    pipeline_depth=4))
    assert COLD_METRIC == JAX_COLD_METRIC
    meter.reset()
    total = 0
    for i in range(6):
        jb, pb = jsynth(15, seed=80 + i), psynth(15, seed=80 + i)
        want = je.backend.score(jb, jfeaturize(jb))
        got = pe.backend.score(pb, featurize(pb))
        np.testing.assert_allclose(got, want, rtol=0, atol=SCORE_ATOL)
        total += len(pb)
    cold = pe.stats()[COLD_METRIC]
    assert cold == meter.counter(JAX_COLD_METRIC)
    assert 0 < cold < total
    assert pe.stats()["pipeline_depth"] == 1  # clamped: no dispatch


def test_zscore_engine_honours_online_update_off():
    pe = ScoringEngine(EngineConfig(model="zscore", device="cpu",
                                    online_update=False))
    pe.warmup(psynth(50, seed=1))  # the backend's own fit, once
    count = pe.backend.det.state.count.clone()
    b = psynth(20, seed=2)
    pe.backend.score(b, featurize(b))
    assert torch.equal(pe.backend.det.state.count, count)
    je = JaxEngine(JaxEngineConfig(model="zscore", online_update=False))
    je.warmup(jsynth(50, seed=1))
    _assert_state(pe.backend.det.state, je.backend.det.state)


def test_zscore_engine_warm_ladder_warms_the_span_buckets():
    pe = ScoringEngine(EngineConfig(
        model="zscore", device="cpu", warm_ladder=True,
        max_batch_spans=10000, featurizer=FeaturizerConfig(attr_slots=2)))
    pe.start()
    try:
        # up to the bucket that holds the cap, and one past it
        assert sorted(b for b, _ in pe.backend.det._staging) == [
            4096, 8192, 16384, 32768]
        assert not pe.backend.det.state.count.any()  # untouched
        assert pe.score_sync(psynth(3, seed=1), timeout_s=60) is not None
    finally:
        pe.shutdown()


# -------------------------------------------------------------------- mock
def test_mock_scores_equal_the_jax_mock_exactly():
    jb, pb = jsynth(12, seed=3), psynth(12, seed=3)
    forced = np.arange(len(jb)) % 5 == 0
    ones = [1] * int(forced.sum())
    jb = jb.with_span_attr("mock.anomaly", ones, forced)
    pb = pb.with_span_attr("mock.anomaly", ones, forced)
    extra_j, extra_p = jsynth(4, seed=4), psynth(4, seed=4)
    je = JaxEngine(JaxEngineConfig(model="mock"))
    pe = ScoringEngine(EngineConfig(model="mock", device="cpu"))
    # queued before the workers run: each engine coalesces the two into
    # one call over a merged batch (the mock reads its attributes)
    jr = [je.submit(jb), je.submit(extra_j)]
    pr = [pe.submit(pb), pe.submit(extra_p)]
    je.start()
    pe.start()
    try:
        for a, b in zip(jr, pr):
            assert a.done.wait(60) and b.done.wait(60)
            np.testing.assert_array_equal(b.scores, a.scores)
    finally:
        je.shutdown()
        pe.shutdown()
    assert (pr[0].scores[forced] == 1.0).all()
    assert pe.stats()["device_calls"] == 1
    assert pe.stats()["pipeline_depth"] == 1

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

import re
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odigos_tpu.features.featurizer import featurize as jfeaturize
from odigos_tpu.models.zscore import ZScoreDetector as JaxDetector
from odigos_tpu.models.zscore import _group_ids as jax_group_ids
from odigos_tpu.models.zscore import _score_kernel, _update_masked_kernel
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
    # 2 x G doubles of per-CTA sums, a G-bit map of the touched groups,
    # the cold counter (16 B) and 8 KiB of warp staging in 227 KiB
    assert kz.update_route(8192) == "shared"
    assert kz.update_route(13906) == "shared"
    assert kz.update_route(13907) == "global"


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
                                torch.zeros_like(st.x))
    for a, b in zip(before, same):
        assert torch.equal(a, b)
    # warm() made the staging buffers of every bucket, one past the cap
    assert sorted(det._staging) == [32, 64, 128, 256, 512]


# ------------------------------- the one launch: K4 then K3 (score_update)
def _otel_ids(n: int, seed: int):
    """(ids, log-durations) of n spans of featurized otel-demo traffic."""
    f = featurize(psynth(max(4, n // 8), seed=seed))
    while len(f) < n:
        f = featurize(psynth(2 * len(f) // 8 + 8, seed=seed))
    return (np.ascontiguousarray(f.categorical[:n]),
            np.ascontiguousarray(f.continuous[:n, 0]))


def _mix_ids(mix: str, n: int, seed: int):
    cat, x = _otel_ids(n, seed)
    if mix == "single":  # every span in one group: the worst contention
        cat = np.tile(cat[:1], (n, 1))
    return cat, x


@pytest.mark.parametrize("n_groups", [8192, 6007])
@pytest.mark.parametrize("n", [1, 31, 4097])
@pytest.mark.parametrize("mix", ["otel", "single"])
def test_score_update_plain_matches_jax_score_then_update(mix, n, n_groups):
    """The one launch's plain version on the CPU against the JAX package's
    ``_score_kernel`` on the state before the batch, then its
    ``_update_masked_kernel`` with weights of 1, from a state fitted on
    other traffic of the same mix; the squash and cold count against the
    JAX engine's (``1 - exp(-z / 4)``, ``z == 0``)."""
    fit_cat, fit_x = _mix_ids(mix, 3000, seed=11)
    jdet = JaxDetector(n_groups=n_groups)
    jstate = jdet.update_fn(jdet.state, jnp.asarray(fit_cat),
                            jnp.asarray(fit_x))
    cat, x = _mix_ids(mix, n, seed=12)
    x = x.copy()
    x[::5] += 2.5  # some outliers
    n_valid = n - n // 3
    z_want = np.asarray(_score_kernel(jstate, jnp.asarray(cat),
                                      jnp.asarray(x), n_groups, 32))
    want = _update_masked_kernel(jstate, jnp.asarray(cat), jnp.asarray(x),
                                 jnp.ones(n, jnp.float32), n_groups)
    state = state_from_numpy(jstate, device="cpu")
    got = kz.zscore_score_update(*state, torch.from_numpy(cat),
                                 torch.from_numpy(x), n_groups, 32,
                                 n_valid=n_valid)
    _assert_state(got.state, want)
    _assert_state(state, jstate)  # not in place: the input is as it was
    np.testing.assert_allclose(got.scores.numpy(),
                               1.0 - np.exp(-z_want / 4.0), rtol=0,
                               atol=SCORE_ATOL)
    assert int(got.cold) == int((z_want[:n_valid] == 0).sum())
    # the out buffer: the cold count's int32 bits, then the scores
    assert got.out.shape == (n + 1,)
    assert int(got.out[:1].view(torch.int32)) == int(got.cold)
    assert torch.equal(got.out[1:], got.scores)


def test_score_update_in_place_and_score_only():
    cat, x = _otel_ids(500, seed=13)
    det = ZScoreDetector(n_groups=512, min_count=4, device="cpu")
    det.state = det.update_fn(det.state, cat, x)
    state = [t.clone() for t in det.state]
    c, xt = torch.from_numpy(cat), torch.from_numpy(x)
    ref_state, ref_s, ref_cold = kz.zscore_score_update_plain(
        *state, c, xt, 512, 4)
    only = kz.zscore_score_update(*state, c, xt, 512, 4, update=False)
    assert only.state is None
    assert torch.equal(only.scores, ref_s) and torch.equal(only.cold,
                                                           ref_cold)
    got = kz.zscore_score_update(*state, c, xt, 512, 4, inplace=True)
    assert all(a is b for a, b in zip(got.state, state))
    for a, b in zip(state, ref_state):
        assert torch.equal(a, b)
    assert torch.equal(got.scores, ref_s)


def _cu_constant(name: str) -> int:
    src = (Path(kz.__file__).parent / "csrc" / "zscore.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def _one_launch_model(state, cat, x, w, G: int, min_count: int,
                      n_valid: int, max_grid: int):
    """The kernel's plan on the host, with its own constants (kThreads,
    kSpansPerThread, kHeld from ``csrc/zscore.cu``): the grid (at most
    ``max_grid`` CTAs, kSpansPerThread spans a thread), each thread's
    spans ``i = j * T + t``, the score on the old state, per CTA the
    touched groups' bit map, each warp's ``__match_any_sync`` groups
    summed by their leader in lane order into the CTA's f64 sums, the
    flush of the touched groups into the device sums and bit map, the
    barrier, pass B from the device sums' b_mean, the merge of the groups
    the bit map holds (the others copied), and the scratch set back to 0.
    Returns the new state, scores, cold count, each CTA's touched groups,
    the largest j a thread took and the scratch after the call."""
    threads, spt = _cu_constant("kThreads"), _cu_constant("kSpansPerThread")
    N = len(x)
    blocks = max(1, min(max_grid, -(-N // (threads * spt))))
    T = blocks * threads
    per = -(-N // T)
    f32 = np.float32
    gid = kz.group_ids(torch.from_numpy(cat), G).numpy()
    count, mean, m2 = (t.numpy().astype(f32) for t in state)
    sums = np.zeros((3, G))
    gbits = np.zeros(G, bool)
    # score on the state before the batch, elementwise as the kernel
    cnt = count[gid]
    var = m2[gid] / np.maximum(cnt - f32(1), f32(1))
    z = np.abs(x - mean[gid]) / np.sqrt(np.maximum(var, f32(1e-8)))
    z = np.where(cnt >= min_count, z, f32(0)).astype(f32)
    scores = (f32(1) - np.exp(-(z * f32(0.25)))).astype(f32)
    cold = int((z[:n_valid] == 0).sum())
    key = np.where(w != 0, gid, -1)

    def cta_pass(b: int, term, acc: np.ndarray) -> set:
        touched = set()
        for j in range(per):
            for wp in range(threads // 32):
                t0 = b * threads + wp * 32
                idx = j * T + t0 + np.arange(32)
                lanes = [int(i) if i < N else -1 for i in idx]
                keys = [key[i] if i >= 0 else -1 for i in lanes]
                for k in sorted(set(keys) - {-1}):
                    peers = [i for i, kk in zip(lanes, keys) if kk == k]
                    tot = [0.0] * acc.shape[0]
                    for i in peers:  # the leader, in lane order
                        for r, v in enumerate(term(i, k)):
                            tot[r] += float(v)
                    acc[:, k] += tot
                    touched.add(int(k))
        return touched

    touched_by_cta = []
    for b in range(blocks):  # pass A, then each CTA's flush
        acc = np.zeros((2, G))
        touched = cta_pass(b, lambda i, k: (w[i], f32(w[i] * x[i])), acc)
        for g in sorted(touched):
            sums[:2, g] += acc[:, g]
            gbits[g] = True
        touched_by_cta.append(touched)
    # the grid barrier; pass B
    n_b = sums[0].astype(f32)
    b_mean = (sums[1].astype(f32) / np.maximum(n_b, f32(1))).astype(f32)
    for b in range(blocks):
        acc = np.zeros((1, G))

        def term_b(i, k):
            d = f32(x[i] - b_mean[k])
            return (f32(w[i] * f32(d * d)),)

        assert cta_pass(b, term_b, acc) == touched_by_cta[b]
        sums[2] += acc[0]
    # the grid barrier; the merge of the touched groups
    new = [count.copy(), mean.copy(), m2.copy()]
    for g in np.flatnonzero(gbits):
        nb, bm, bm2 = f32(sums[0, g]), b_mean[g], f32(sums[2, g])
        n_a, mean_a, m2_a = count[g], mean[g], m2[g]
        n_ab = f32(n_a + nb)
        safe = max(n_ab, f32(1))
        delta = f32(bm - mean_a)
        new[0][g] = n_ab
        new[1][g] = f32(mean_a + f32(delta * f32(nb / safe)))
        new[2][g] = f32(f32(m2_a + bm2)
                        + f32(f32(delta * delta) * f32(f32(n_a * nb) / safe)))
    sums[:, gbits] = 0.0
    gbits[:] = False
    return (tuple(torch.from_numpy(a) for a in new), scores, cold,
            touched_by_cta, per, (sums, gbits))


@pytest.mark.parametrize("max_grid", [132, 1])
@pytest.mark.parametrize("mix", ["otel", "single"])
def test_one_launch_model_matches_the_plain_versions(mix, max_grid):
    """The kernel's plan replayed on the host (``_one_launch_model``)
    against ``zscore_score_plain`` then ``zscore_update_plain``: 4097
    spans over the CTAs the plan sizes (max_grid 132), or one CTA whose
    threads take 9 spans each, past the kHeld held in registers (max_grid
    1);
    the second CTA's spans weigh 0, so it touches no group and flushes
    nothing."""
    n, G = 4097, 8192
    fit_cat, fit_x = _mix_ids(mix, 2000, seed=21)
    zero = [torch.zeros(G) for _ in range(3)]
    state = kz.zscore_update_plain(*zero, torch.from_numpy(fit_cat),
                                   torch.from_numpy(fit_x),
                                   torch.ones(len(fit_x)), G)
    cat, x = _mix_ids(mix, n, seed=22)
    threads = _cu_constant("kThreads")
    spt = _cu_constant("kSpansPerThread")
    blocks = max(1, min(max_grid, -(-n // (threads * spt))))
    T = blocks * threads
    w = np.ones(n, np.float32)
    if blocks > 1:
        w[(np.arange(n) % T) // threads == 1] = 0.0  # CTA 1's spans
    new, scores, cold, touched, per, (sums, gbits) = _one_launch_model(
        state, cat, x, w, G, 32, n - 100, max_grid)
    if max_grid == 1:
        assert blocks == 1 and per == 9 > _cu_constant("kHeld")
    else:
        assert blocks > 2 and touched[1] == set() and touched[0]
    c, xt, wt = (torch.from_numpy(a) for a in (cat, x, w))
    z_ref = kz.zscore_score_plain(*state, c, xt, G, 32)
    ref = kz.zscore_update_plain(*state, c, xt, wt, G)
    assert torch.equal(new[0], ref[0])
    np.testing.assert_allclose(new[1].numpy(), ref[1].numpy(), rtol=0,
                               atol=MEAN_ATOL)
    np.testing.assert_allclose(new[2].numpy(), ref[2].numpy(),
                               rtol=M2_RTOL, atol=M2_ATOL)
    np.testing.assert_allclose(scores, kz.squash_plain(z_ref).numpy(),
                               rtol=0, atol=1e-6)
    assert cold == int((z_ref[:n - 100] == 0).sum())
    assert not sums.any() and not gbits.any()  # the scratch back to 0


def test_staging_copies_two_id_columns_and_the_duration_of_real_spans():
    """``stage`` keeps the (service, name) ids and the log-duration of the
    n real spans (12 bytes a span, one pinned buffer a span bucket), and
    the engine's ``score_staged`` equals the one launch's plain version,
    with the state folded in place."""
    det = ZScoreDetector(n_groups=1000, span_bucket=64, device="cpu")
    cat, x = _otel_ids(100, seed=31)
    cont = np.zeros((100, 3), np.float32)
    cont[:, 0] = x
    st = det.stage(SpanFeatures(cat, cont))
    assert (st.n, st.bucket) == (100, 128)
    assert st.cat.shape == (100, 2) and st.cat.dtype == torch.int32
    np.testing.assert_array_equal(st.cat.numpy(), cat[:, :2])
    np.testing.assert_array_equal(st.x.numpy(), x)
    assert st.cat.numel() * 4 + st.x.numel() * 4 == 12 * 100
    assert sorted(det._staging) == [128]
    # the ids and durations of a bucket, and the cold count's zero
    assert det._staging[128].inputs.numel() == 3 * 128 + 1
    assert det._staging[128].inputs[3 * 100] == 0
    before = [t.clone() for t in det.state]
    ref_state, ref_s, ref_cold = kz.zscore_score_update_plain(
        *before, st.cat, st.x, 1000, det.min_count)
    state_ids = [id(t) for t in det.state]
    scores, cold = det.score_staged(st)
    np.testing.assert_array_equal(scores, ref_s.numpy())
    assert cold == int(ref_cold) == 100  # a fresh state: every span cold
    assert [id(t) for t in det.state] == state_ids  # in place
    for a, b in zip(det.state, ref_state):
        assert torch.equal(a, b)
    scores2, _ = det.score_staged(st, update=False)
    for a, b in zip(det.state, ref_state):
        assert torch.equal(a, b)  # score only: the state as it was


def test_score_update_fills_the_callers_out_buffer():
    """``out`` given: the cold count's bits and the scores land in it (the
    detector's staged buffer on the card), and a malformed one is
    refused."""
    cat, x = _otel_ids(200, seed=17)
    c, xt = torch.from_numpy(cat), torch.from_numpy(x)
    state = [torch.zeros(512) for _ in range(3)]
    _, ref_s, ref_cold = kz.zscore_score_update_plain(*state, c, xt, 512, 4)
    out = torch.full((201,), 7.0)
    got = kz.zscore_score_update(*state, c, xt, 512, 4, update=False,
                                 out=out)
    assert got.out is out
    assert torch.equal(out[1:], ref_s) and int(got.cold) == int(ref_cold)
    for bad in (torch.zeros(200), torch.zeros(201, dtype=torch.float64)):
        with pytest.raises(ValueError, match="out must be"):
            kz.zscore_score_update(*state, c, xt, 512, 4, out=bad)


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
        assert sorted(pe.backend.det._staging) == [
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

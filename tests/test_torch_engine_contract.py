"""The port engine's deadline-sized coalescing and meters, held against the
JAX package's engine (``odigos_tpu/serving/engine.py``).

* ``BucketLadder.floor_rows`` (and ``round_rows``) equal to the reference's
  at every row count 0-100,000 and on fractional row budgets, over several
  bases and ladders.
* ``_adaptive_cap`` equal to the reference's with the same EWMA state and
  ladder over a grid of deadlines (past, 1 ms, 10 ms, 1e12 ns), with and
  without a ladder, the monotonic clock frozen for both.
* Deadline-carrying requests score bit-equal to undeadlined ones on both
  routes of a small transformer, move the estimators (spans a row from the
  call's rows: the host route's packed rows, the fused route's
  ``last_shape``) and publish the cap gauge; ``on_done`` fires once, after
  the scores are set.
* The meters: one request sequence (a full queue, an expired deadline, the
  warm-up, coalesced and single groups, an injected fault, a deadline, a
  submit after shutdown) through the JAX zscore engine and the port's on
  the CPU gives equal deltas of every named counter and equal histogram
  counts.
"""

import time

import numpy as np
import pytest
import torch

from odigos_tpu.pdata import synthesize_traces as jsynth
from odigos_tpu.serving.engine import BucketLadder as JaxLadder
from odigos_tpu.serving.engine import EngineConfig as JaxEngineConfig
from odigos_tpu.serving.engine import ScoringEngine as JaxEngine
from odigos_tpu.utils.telemetry import meter as jax_meter
from odigos_tpu_torch.models import TransformerConfig
from odigos_tpu_torch.pdata import synthesize_traces as psynth
from odigos_tpu_torch.serving import BucketLadder, EngineConfig, ScoringEngine
from odigos_tpu_torch.serving import engine as port_engine
from odigos_tpu_torch.serving.fused import extract_columns
from odigos_tpu_torch.utils.telemetry import meter

torch.set_num_threads(1)

SMALL = dict(d_model=64, n_heads=2, n_layers=2, d_ff=128, max_len=16)
POLL_S = 30.0

LADDERS = [(8, 3), (256, 4), (1, 1), (100, 5), (7, 2), (16, 1)]


@pytest.mark.parametrize("base,n", LADDERS)
def test_floor_rows_matches_the_reference(base, n):
    port, ref = BucketLadder(base, n), JaxLadder(base, n)
    assert port.buckets == ref.buckets
    rows = np.arange(0, 100_001)
    got = [port.floor_rows(int(r)) for r in rows]
    want = [ref.floor_rows(int(r)) for r in rows]
    assert got == want
    assert [port.round_rows(int(r)) for r in rows[1:]] == \
        [ref.round_rows(int(r)) for r in rows[1:]]
    # row budgets are spans over spans a row: fractional
    rng = np.random.default_rng(base * 7 + n)
    for r in rng.uniform(0, 3 * port.buckets[-1] + 1, 2000):
        assert port.floor_rows(float(r)) == ref.floor_rows(float(r))


def test_floor_rows_snaps_down_onto_the_ladder():
    lad = BucketLadder(base=8, n_buckets=3)  # 8, 16, 32
    assert lad.floor_rows(7) == 8     # nothing fits: the smallest bucket
    assert lad.floor_rows(31) == 16   # down, never up
    assert lad.floor_rows(100) == 96  # past the top: multiples of it


T0 = 10**15  # the frozen monotonic clock, ns

EWMA_STATES = {
    "reference_test": (100.0, 10_000.0, 4.0, 0.0),
    "cheap_spans": (2.5, 65_536.0, 31.7, 0.4),
    "dear_spans": (40.0, 512.0, 9.25, 1.5),
    "harvest_heavy": (5.0, 2_000.0, 20.0, 4.0),
    "cold": (None, None, None, 0.0),
    "no_rows": (12.0, 3_000.0, None, 0.2),
}
DEADLINES_NS = [-1_000_000, 0, 50_000, 1_000_000, 3_000_000, 10_000_000,
                100_000_000, int(1e12)]


def _set_state(eng, state) -> None:
    (eng._ewma_call_ms, eng._ewma_call_spans, eng._ewma_spans_per_row,
     eng._ewma_harvest_ms) = state


@pytest.mark.parametrize("ladder", [None, (8, 2), (256, 4), (16, 5)])
@pytest.mark.parametrize("state", sorted(EWMA_STATES))
def test_adaptive_cap_matches_the_reference(monkeypatch, ladder, state):
    monkeypatch.setattr(time, "monotonic_ns", lambda: T0)
    ref = JaxEngine(JaxEngineConfig(model="mock"))
    port = ScoringEngine(EngineConfig(model="mock", device="cpu"))
    for eng, cls in ((ref, JaxLadder), (port, BucketLadder)):
        _set_state(eng, EWMA_STATES[state])
        if ladder is not None:
            eng.backend.ladder = cls(*ladder)
    assert port._ms_per_span() == ref._ms_per_span()
    for dl in DEADLINES_NS:
        got = port._adaptive_cap(T0 + dl)
        assert got == ref._adaptive_cap(T0 + dl), (state, ladder, dl)
        assert 1 <= got <= port.cfg.max_batch_spans
    if EWMA_STATES[state][0] is not None:
        # drain mode past the deadline, the fixed cap at 1e12 ns
        assert port._adaptive_cap(T0 - 1_000_000) == \
            port.cfg.max_batch_spans
        assert port._adaptive_cap(T0 + int(1e12)) == \
            port.cfg.max_batch_spans


def test_adaptive_cap_lands_on_a_rung_times_spans_per_row(monkeypatch):
    monkeypatch.setattr(time, "monotonic_ns", lambda: T0)
    eng = ScoringEngine(EngineConfig(model="mock", device="cpu"))
    _set_state(eng, EWMA_STATES["reference_test"])
    eng.backend.ladder = BucketLadder(8, 2)  # 8, 16
    # 1 ms affords 100 spans = 25 rows -> bucket 16 -> 64 spans
    assert eng._adaptive_cap(T0 + 1_000_000) == 64


def _transformer_engine(**kw) -> ScoringEngine:
    return ScoringEngine(EngineConfig(
        model="transformer", device="cpu", max_len=16, trace_bucket=8,
        model_config=TransformerConfig(**SMALL, dtype=torch.float32), **kw))


@pytest.mark.parametrize("route", ["host", "fused"])
def test_deadline_requests_score_as_undeadlined_and_move_the_estimators(
        route):
    eng = _transformer_engine().start()
    fired = []
    try:
        b = psynth(12, seed=3)
        cols = extract_columns(b)[0] if route == "fused" else None
        st = eng.stats()["adaptive"]
        # a one-device engine's mesh label is the reference's "single"
        assert st == {"ms_per_span": None, "spans_per_row": None,
                      "harvest_ms": 0.0, "last_cap_spans": None,
                      "mesh": "single"}
        plain = eng.submit(b, columns=cols)
        assert plain.done.wait(POLL_S)
        rows = eng.backend.last_shape[0]
        st = eng.stats()["adaptive"]
        # one call: the EWMAs are that call's own figures
        assert st["spans_per_row"] == len(b) / rows
        assert st["ms_per_span"] > 0 and st["last_cap_spans"] is None
        key = "odigos_engine_adaptive_cap_spans{model=transformer}"
        for dl_ms in (1e6, 1.0, -5.0):
            dl = time.monotonic_ns() + int(dl_ms * 1e6)
            req = eng.submit(b, columns=cols, deadline_ns=dl,
                             on_done=lambda r: fired.append(
                                 r.scores is not None))
            assert req.done.wait(POLL_S)
            np.testing.assert_array_equal(req.scores, plain.scores)
            cap = eng.stats()["adaptive"]["last_cap_spans"]
            assert meter.gauge(key) == cap
            assert 1 <= cap <= eng.cfg.max_batch_spans
            if dl_ms != 1.0:  # far off, or past: the fixed cap (drain)
                assert cap == eng.cfg.max_batch_spans
        assert eng.stats()["device_calls"] == 4
        assert eng.stats()["fused_calls"] == (4 if route == "fused" else 0)
    finally:
        eng.shutdown()
    assert fired == [True] * 3


def test_a_deadline_caps_the_coalesced_call(monkeypatch):
    """A deadline too near for two requests' spans keeps them in two
    calls; without one the same requests coalesce into one."""
    monkeypatch.setattr(time, "monotonic_ns", lambda: T0)
    eng = _transformer_engine()
    _set_state(eng, (50.0, 100.0, 4.0, 0.0))  # 0.5 ms a span
    eng.backend.ladder = BucketLadder(1, 1)
    reqs = [eng.submit(psynth(5, seed=s), deadline_ns=T0 + int(10e6))
            for s in (1, 2)]
    assert all(len(r.batch) > 20 for r in reqs)
    got = eng._collect(block=False)
    # 10 ms affords 20 spans = 5 rows of 4 spans
    assert eng._last_adaptive_cap == 20
    assert got == [reqs[0]]
    assert eng._collect(block=False) == [reqs[1]]
    for s in (3, 4):
        eng.submit(psynth(5, seed=s))
    assert len(eng._collect(block=False)) == 2


def test_stats_keep_their_keys_and_add_the_engine_surfaces():
    eng = ScoringEngine(EngineConfig(model="zscore", device="cpu"))
    st = eng.stats()
    for k in ("model", "quantized", "device", "pipeline_depth",
              "device_calls", "errors", "rejected", "passthrough_spans",
              "stage_pack_ms_p50", "stage_device_ms_p50",
              "odigos_anomaly_cold_spans_total", "stage_ms_p50_by_route",
              "fused_calls", "odigos_fastpath_fused_frames_total",
              "odigos_fastpath_fused_fallback_total",
              "fused_mixed_group_frames", "adaptive"):
        assert k in st, k
    assert "failover" not in st


COUNTERS = ("odigos_anomaly_passthrough_total",
            "odigos_anomaly_queue_full_total",
            "odigos_anomaly_scored_spans_total",
            "odigos_anomaly_cold_spans_total",
            "odigos_anomaly_engine_errors_total")
HISTOGRAMS = ("odigos_anomaly_stage_pack_ms_count",
              "odigos_anomaly_stage_device_ms_count",
              "odigos_anomaly_stage_harvest_ms_count",
              "odigos_anomaly_score_latency_ms_count")


def _sequence(eng, synth) -> int:
    """The metered request sequence, identical for both engines; returns
    the spans of the request whose deadline expired."""
    a = eng.submit(synth(5, seed=1))
    b = eng.submit(synth(8, seed=2))
    assert a is not None and b is not None
    # an expired deadline: the third request waits 0 s (not started)
    expired = synth(4, seed=3)
    assert eng.score_sync(expired, timeout_s=0.0) is None
    assert eng.submit(synth(2, seed=4)) is None       # the queue is full
    eng.warmup(synth(60, seed=5))
    eng.start()
    assert a.done.wait(POLL_S) and b.done.wait(POLL_S)
    for i in range(4):
        assert eng.score_sync(synth(3 + 5 * i, seed=10 + i),
                              timeout_s=POLL_S) is not None
    eng.inject_device_fault()
    for i in range(2):
        assert eng.score_sync(synth(6, seed=20 + i),
                              timeout_s=POLL_S) is None
    eng.clear_device_fault()
    done = []
    req = eng.submit(synth(9, seed=30),
                     deadline_ns=time.monotonic_ns() + int(5e9),
                     on_done=lambda r: done.append(1))
    assert req.done.wait(POLL_S) and req.scores is not None
    eng.shutdown()
    assert done == [1]
    assert eng.submit(synth(3, seed=31)) is None       # shut down
    return len(expired)


def test_meter_deltas_match_the_jax_engine():
    out = {}
    for name, eng, synth, m in (
            ("jax", JaxEngine(JaxEngineConfig(model="zscore",
                                              max_queue=3)),
             jsynth, jax_meter),
            ("port", ScoringEngine(EngineConfig(model="zscore",
                                                max_queue=3,
                                                device="cpu")),
             psynth, meter)):
        s0 = m.snapshot()
        expired = _sequence(eng, synth)
        s1 = m.snapshot()
        out[name] = {k: s1.get(k, 0.0) - s0.get(k, 0.0)
                     for k in COUNTERS + HISTOGRAMS}
        gauge = "odigos_engine_adaptive_cap_spans{model=zscore}"
        assert gauge in s1 and "odigos_anomaly_device_busy_frac" in s1
        assert 0.0 < s1["odigos_anomaly_device_busy_frac"] <= 1.0
    assert out["port"] == out["jax"]
    d = out["port"]
    assert d["odigos_anomaly_passthrough_total"] == expired
    assert d["odigos_anomaly_queue_full_total"] == 2
    assert d["odigos_anomaly_engine_errors_total"] == 2
    assert d["odigos_anomaly_scored_spans_total"] > 0
    assert d["odigos_anomaly_cold_spans_total"] > 0
    assert port_engine.PASSTHROUGH_METRIC == COUNTERS[0]

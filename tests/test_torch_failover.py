"""The port's failover supervisor and the engine's failover path, held
against the JAX package's (``odigos_tpu/serving/failover.py`` and
``odigos_tpu/serving/engine.py``).

* The breaker: each sequence of the reference's ``TestBreakerStateMachine``
  (``tests/test_failover.py``) and a seeded random one, fed to both
  supervisors under one fake clock, give equal ``select`` results, states,
  counters, ``status()`` (wall-clock stamps aside), histories and metric
  deltas after every step.
* ``EngineConfig.failover``: normalised equal to the reference's for
  ``True``, ``False``, ``None``, mappings, item tuples and ``{"enabled":
  False}``; ``FailoverConfig.from_spec`` equal; unknown keys and bad values
  refused alike.
* The engine on the CPU: a 2-layer transformer primary with a zscore
  fallback through ``inject_device_fault``, the trip, fallback scores held
  to the JAX zscore engine on the same stream (``test_torch_zscore.py``'s
  bound), ``clear_device_fault``, recovery by probes riding traffic, and
  the primary's scores after it bit-equal to before; ``on_done`` exactly
  once per request under a sustained fault; without a breaker, pass-through
  and errors, counted as the JAX engine counts them; remote with failover
  refused.
"""

import random
import threading
import time

import numpy as np
import pytest
import torch

from odigos_tpu.features.featurizer import featurize as jfeaturize
from odigos_tpu.pdata import synthesize_traces as jsynth
from odigos_tpu.serving.engine import EngineConfig as JaxEngineConfig
from odigos_tpu.serving.engine import ScoringEngine as JaxEngine
from odigos_tpu.serving.failover import FailoverConfig as JaxFailoverConfig
from odigos_tpu.serving.failover import \
    FailoverSupervisor as JaxSupervisor
from odigos_tpu.utils.telemetry import meter as jax_meter
from odigos_tpu_torch.models import TransformerConfig
from odigos_tpu_torch.pdata import synthesize_traces as psynth
from odigos_tpu_torch.serving import EngineConfig, ScoringEngine
from odigos_tpu_torch.serving.engine import DeviceFaultInjected
from odigos_tpu_torch.serving.failover import (
    CLOSED, FailoverConfig, FailoverSupervisor, failover_conditions)
from odigos_tpu_torch.serving.fused import extract_columns
from odigos_tpu_torch.utils.telemetry import meter

torch.set_num_threads(1)

SCORE_ATOL = 1e-5   # tests/test_torch_zscore.py: port vs JAX zscore scores
SMALL = dict(d_model=64, n_heads=2, n_layers=2, d_ff=128, max_len=16)
POLL_S = 30.0       # bounded polls: tier-1 runs several workers at once


class FakeClock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _wait_for(pred, timeout_s: float = POLL_S) -> bool:
    deadline = time.monotonic() + timeout_s
    while not pred():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.01)
    return True


# ------------------------------------------------------------ state machine

# the reference's TestBreakerStateMachine, one script each: (config, steps)
# with steps ("fail"|"ok", side, kwargs), ("advance", dt), ("select",)
SCRIPTS = {
    "trips_after_threshold_inside_window": (
        dict(trip_errors=3, window_s=5.0),
        [("fail", "p", {}), ("fail", "p", {}), ("fail", "p", {})]),
    "stale_errors_age_out_of_the_window": (
        dict(trip_errors=3, window_s=5.0),
        [("fail", "p", {}), ("fail", "p", {}), ("advance", 6.0),
         ("fail", "p", {})]),
    "open_serves_fallback_until_probe_interval": (
        dict(trip_errors=1, probe_interval_s=1.0),
        [("fail", "p", {}), ("select",), ("advance", 1.1), ("select",),
         ("select",)]),
    "failed_probe_reopens_and_rearms": (
        dict(trip_errors=1, probe_interval_s=1.0),
        [("fail", "p", {}), ("advance", 1.1), ("select",),
         ("fail", "p", {"probe": True}), ("select",), ("advance", 1.1),
         ("select",)]),
    "consecutive_successes_recover": (
        dict(trip_errors=1, probe_interval_s=1.0, recovery_successes=2),
        [("fail", "p", {}), ("advance", 1.1), ("select",),
         ("ok", "p", {"probe": True}), ("select",),
         ("ok", "p", {"probe": True}), ("select",)]),
    "stale_pretrip_results_cannot_touch_the_probe": (
        dict(trip_errors=1, probe_interval_s=1.0, recovery_successes=1),
        [("fail", "p", {}), ("advance", 1.1), ("select",),
         ("fail", "p", {}), ("select",), ("ok", "p", {}),
         ("ok", "p", {"probe": True})]),
    "fallback_results_never_drive_the_breaker": (
        dict(trip_errors=1),
        [("fail", "f", {}), ("fail", "f", {}), ("fail", "p", {}),
         ("ok", "f", {"n_spans": 7})]),
    "status_and_transitions": (
        dict(trip_errors=1, probe_interval_s=0.5, recovery_successes=1),
        [("fail", "p", {"error": "RuntimeError: dead"}), ("advance", 0.6),
         ("select",), ("ok", "p", {"probe": True})]),
}


def _random_script(seed: int, n: int = 400):
    """Results, selects and clock steps at random; the probe flag at random
    too, so stale results and genuine probes both reach the machine."""
    rng = random.Random(seed)
    steps = []
    for _ in range(n):
        k = rng.random()
        if k < 0.3:
            steps.append(("select",))
        elif k < 0.45:
            steps.append(("advance", rng.choice((0.05, 0.3, 1.2, 6.0))))
        else:
            steps.append((rng.choice(("ok", "fail")),
                          rng.choice(("p", "p", "f")),
                          {"probe": rng.random() < 0.5,
                           "n_spans": rng.randrange(100),
                           "error": f"E{rng.randrange(3)}"}))
    cfg = dict(trip_errors=rng.choice((1, 2, 3)), window_s=5.0,
               probe_interval_s=rng.choice((0.2, 1.0)),
               recovery_successes=rng.choice((1, 2, 3)))
    return cfg, steps


for _seed in range(3):
    SCRIPTS[f"random_{_seed}"] = _random_script(_seed)


def _failover_counters(snapshot: dict, model: str) -> dict:
    return {k: v for k, v in snapshot.items()
            if k.startswith("odigos_failover") and f"model={model}" in k}


def _status(sup) -> dict:
    st = sup.status()
    st["transitions"] = [{k: v for k, v in t.items() if k != "unix_ts"}
                         for t in st["transitions"]]
    return st


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_breaker_state_machine_matches_the_reference(name):
    cfg, steps = SCRIPTS[name]
    clock = FakeClock()
    model = f"script-{name}"
    sups = []
    for sup_cls, cfg_cls in ((JaxSupervisor, JaxFailoverConfig),
                             (FailoverSupervisor, FailoverConfig)):
        primary, fallback = object(), object()
        sups.append(sup_cls(model, primary, fallback, cfg_cls(**cfg),
                            clock=clock))
    ref, port = sups
    j0 = _failover_counters(jax_meter.snapshot(), model)
    p0 = _failover_counters(meter.snapshot(), model)

    def side(sup, s):
        return sup.primary if s == "p" else sup.fallback

    for i, step in enumerate(steps):
        if step[0] == "advance":
            clock.advance(step[1])
            continue
        if step[0] == "select":
            got = [(("p" if b is s.primary else "f"), probe)
                   for s in (ref, port) for b, probe in [s.select()]]
            assert got[0] == got[1], (i, got)
        else:
            ok, s, kw = step[0] == "ok", step[1], step[2]
            for sup in (ref, port):
                sup.observe(side(sup, s), ok=ok, **kw)
        assert port.state == ref.state, (i, step)
        assert (port.trips, port.recoveries, port.fallback_spans) == \
            (ref.trips, ref.recoveries, ref.fallback_spans), (i, step)
        assert port.active == ref.active
        assert _status(port) == _status(ref), (i, step)
    assert [{k: v for k, v in t.items() if k != "unix_ts"}
            for t in port.history] == \
        [{k: v for k, v in t.items() if k != "unix_ts"} for t in ref.history]
    dj = {k: v - j0.get(k, 0.0) for k, v in
          _failover_counters(jax_meter.snapshot(), model).items()}
    dp = {k: v - p0.get(k, 0.0) for k, v in
          _failover_counters(meter.snapshot(), model).items()}
    assert dp == dj
    if name.startswith("random"):
        assert ref.trips > 0  # the random walk exercised the machine


def test_history_is_bounded_like_the_reference():
    clock = FakeClock()
    cfg = dict(trip_errors=1, probe_interval_s=0.1, recovery_successes=1)
    sups = [JaxSupervisor("hist", object(), object(),
                          JaxFailoverConfig(**cfg), clock=clock),
            FailoverSupervisor("hist", object(), object(),
                               FailoverConfig(**cfg), clock=clock)]
    for _ in range(100):
        for sup in sups:
            sup.observe(sup.primary, ok=False)
        clock.advance(0.2)
        for sup in sups:
            backend, probe = sup.select()
            assert backend is sup.primary and probe
            sup.observe(backend, ok=True, probe=True)
    ref, port = sups
    assert port.trips == port.recoveries == 100
    assert len(port.history) == len(ref.history) == 64
    assert _status(port) == _status(ref)


def test_conditions_round_trip():
    clock = FakeClock()
    sup = FailoverSupervisor("cond", object(), object(),
                             FailoverConfig(trip_errors=1,
                                            probe_interval_s=0.5,
                                            recovery_successes=1),
                             clock=clock)
    assert "engine/cond" not in failover_conditions()  # never tripped
    sup.observe(sup.primary, ok=False, error="RuntimeError: gone")
    cond = failover_conditions()["engine/cond"]
    assert cond[:2] == ("Degraded", "ModelFailover")
    assert "zscore CPU fallback" in cond[2] and "gone" in cond[2]
    clock.advance(0.6)
    assert sup.select() == (sup.primary, True)
    sup.observe(sup.primary, ok=True, probe=True)
    assert failover_conditions()["engine/cond"] == ("Healthy", "Running", "")


# ------------------------------------------------------------------ config

SPECS = {
    "true": True, "false": False, "none": None, "empty": {},
    "mapping": {"trip_errors": 2, "window_s": 3.0},
    "all_keys": {"window_s": 2, "trip_errors": "4", "probe_interval_s": 0.5,
                 "recovery_successes": 3, "fallback_model": "mock"},
    "items": (("trip_errors", 2), ("fallback_model", "mock")),
    "enabled_false": {"enabled": False, "trip_errors": 9},
    "enabled_true": {"enabled": True, "trip_errors": 5},
}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_engine_config_normalises_failover_like_the_reference(name):
    spec = SPECS[name]
    port = EngineConfig(model="mock", failover=spec)
    ref = JaxEngineConfig(model="mock", failover=spec)
    assert port.failover == ref.failover
    assert port.failover_spec() == ref.failover_spec()
    hash(port)  # shared-engine keying hashes the config
    if ref.failover_spec() is None:
        assert ScoringEngine(EngineConfig(model="mock", device="cpu",
                                          failover=spec)).failover is None
        return
    got = FailoverConfig.from_spec(port.failover_spec())
    want = JaxFailoverConfig.from_spec(ref.failover_spec())
    assert got.__dict__ == want.__dict__
    # and the engine arms the breaker that spec names
    eng = ScoringEngine(EngineConfig(model="mock", device="cpu",
                                     failover=spec))
    assert eng.failover.cfg == got


@pytest.mark.parametrize("spec", [
    {"trip_erors": 3}, {"window_s": 0.0}, {"probe_interval_s": -1},
    {"trip_errors": 0}, {"recovery_successes": 0},
    {"fallback_model": "transformer"}])
def test_bad_failover_specs_are_refused_like_the_reference(spec):
    with pytest.raises(ValueError) as want:
        JaxFailoverConfig.from_spec(spec)
    with pytest.raises(ValueError) as got:
        FailoverConfig.from_spec(spec)
    assert str(got.value) == str(want.value)
    # and at engine construction, before any backend serves
    with pytest.raises(ValueError):
        ScoringEngine(EngineConfig(model="mock", device="cpu",
                                   failover=spec))


def test_remote_with_failover_is_refused():
    with pytest.raises(ValueError, match="remote"):
        ScoringEngine(EngineConfig(model="remote",
                                   socket_path="/nonexistent/x.sock",
                                   failover=True))
    with pytest.raises(ValueError, match="remote"):
        JaxEngine(JaxEngineConfig(model="remote",
                                  socket_path="/nonexistent/x.sock",
                                  failover=True))


def test_true_builds_the_default_breaker_on_a_cpu_fallback():
    eng = ScoringEngine(EngineConfig(model="mock", device="cpu",
                                     failover=True))
    assert eng.failover.cfg == FailoverConfig()
    fb = eng.failover.fallback
    assert type(fb).__name__ == "ZScoreBackend"
    assert fb.device.type == "cpu" and fb.cfg.device == "cpu"
    assert eng.failover_status()["state"] == CLOSED
    assert eng.stats()["failover"]["state"] == CLOSED
    off = ScoringEngine(EngineConfig(model="mock", device="cpu"))
    assert off.failover is None and off.failover_status() is None
    assert "failover" not in off.stats()
    assert EngineConfig().failover is None  # off by default


# ---------------------------------------------------- the engine round trip

def _transformer_engine(**fo) -> ScoringEngine:
    return ScoringEngine(EngineConfig(
        model="transformer", device="cpu", max_len=16, trace_bucket=8,
        model_config=TransformerConfig(**SMALL, dtype=torch.float32),
        failover=dict({"trip_errors": 2, "window_s": 60.0,
                       "probe_interval_s": 0.5,
                       "recovery_successes": 2}, **fo)))


def test_trip_fallback_and_recover_against_the_jax_zscore():
    """Fault → trip within trip_errors groups → the zscore fallback
    scores on the CPU like the JAX zscore engine fed the same stream
    (warm-up included) → clear → probes close the breaker → the same
    batches score bit-equal to before the fault."""
    pe = _transformer_engine()
    warm = 300
    pe.warmup(psynth(warm, seed=7))
    je = JaxEngine(JaxEngineConfig(model="zscore"))
    je.warmup(jsynth(warm, seed=7))
    sup = pe.failover
    pe.start()
    try:
        seeds = [(12, 30), (5, 31), (20, 32)]
        before = [pe.score_sync(psynth(n, seed=s), timeout_s=POLL_S)
                  for n, s in seeds]
        assert all(b is not None for b in before)
        assert sup.state == CLOSED and sup.trips == 0
        scored0 = meter.counter("odigos_anomaly_scored_spans_total")

        pe.inject_device_fault()
        fallback, failed, i = [], 0, 0

        def one(n, seed, columns=False):
            b = psynth(n, seed=seed)
            spans0 = sup.fallback_spans
            if columns:
                req = pe.submit(b, columns=extract_columns(b)[0])
                assert req is not None and req.done.wait(POLL_S)
                got = req.scores
            else:
                got = pe.score_sync(b, timeout_s=POLL_S)
            if sup.fallback_spans - spans0 == len(b):
                assert got is not None
                fallback.append((n, seed, got))
            return got

        while not sup.active:
            assert one(9, 100 + i) is None  # the primary faults
            failed += 1
            i += 1
        assert failed == 2 and sup.trips == 1  # within trip_errors groups
        errors = pe.stats()["errors"]
        for k in range(6):
            one(7 + 3 * k, 200 + k, columns=(k == 3))
        assert len(fallback) >= 3
        # a failover is not a fused fallback reason
        st = pe.stats()
        assert st["odigos_fastpath_fused_fallback_total"]["backend"] == 0
        assert st["fused_mixed_group_frames"] == 0
        assert st["failover"]["fallback_scored_spans"] == sup.fallback_spans
        # probes that hit the still-faulted primary are errors too
        assert st["errors"] >= errors

        pe.clear_device_fault()
        k = 0
        while sup.active:
            assert k < 2000, "the breaker never closed"
            one(6, 400 + k)
            k += 1
            time.sleep(0.02)
        assert sup.recoveries == 1 and sup.state == CLOSED
        after = [pe.score_sync(psynth(n, seed=s), timeout_s=POLL_S)
                 for n, s in seeds]
        for a, b in zip(before, after):
            np.testing.assert_array_equal(a, b)
        # every span scored by the fallback or the primary was metered;
        # the failed groups were not
        scored = meter.counter("odigos_anomaly_scored_spans_total") - scored0
        assert scored >= sup.fallback_spans + sum(len(a) for a in after)
        events = [t["event"] for t in sup.status()["transitions"]]
        assert events == ["tripped", "recovered"]
    finally:
        pe.shutdown()
    # the fallback's stream, replayed on the JAX zscore engine in order
    for n, seed, got in fallback:
        b = jsynth(n, seed=seed)
        want = je.backend.score(b, jfeaturize(b))
        np.testing.assert_allclose(got, want, rtol=0, atol=SCORE_ATOL)


def test_inflight_primary_group_harvests_against_the_primary():
    """A group dispatched on the primary before the trip retires through
    the primary's harvest, never the fallback (which has none)."""
    pe = _transformer_engine(trip_errors=1)
    sup = pe.failover
    req = pe.submit(psynth(10, seed=3))
    assert pe._queue.get_nowait() is req  # the engine is not started
    grp = pe._dispatch_group([req])
    assert grp.backend is pe.backend
    sup.observe(sup.primary, ok=False, error="RuntimeError: trip")
    assert sup.active and sup.select()[0] is sup.fallback
    pe._retire(grp)
    assert grp.reqs[0].done.is_set() and grp.reqs[0].scores is not None
    assert sup.fallback_spans == 0  # the primary served it


@pytest.mark.parametrize("armed", [False, True])
def test_on_done_exactly_once_per_request_under_a_sustained_fault(armed):
    fo = {"trip_errors": 1, "probe_interval_s": 3600.0,
          "fallback_model": "mock"} if armed else None
    eng = ScoringEngine(EngineConfig(model="mock", device="cpu",
                                     failover=fo)).start()
    calls: dict[int, int] = {}
    lock = threading.Lock()
    try:
        eng.inject_device_fault()
        reqs = []
        for s in range(8):
            def on_done(r, i=s):
                with lock:
                    calls[i] = calls.get(i, 0) + 1

            req = eng.submit(psynth(2, seed=s), on_done=on_done)
            assert req is not None
            reqs.append(req)
            if s == 0:
                # armed: the first group alone trips the breaker; the
                # rest go to the fallback as one burst
                assert req.done.wait(POLL_S)
        assert all(r.done.wait(POLL_S) for r in reqs)
        # a late double fire would land before the shutdown's join
    finally:
        eng.shutdown()
    with lock:
        assert calls == {i: 1 for i in range(8)}, calls
    if armed:
        # the first group tripped the breaker; the mock fallback scored
        # every later request
        assert reqs[0].scores is None
        assert all(r.scores is not None for r in reqs[1:])
        assert eng.failover.fallback_spans == sum(
            len(r.batch) for r in reqs[1:])
    else:
        assert all(r.scores is None for r in reqs)


def test_on_done_after_scores_and_its_errors_are_counted():
    eng = ScoringEngine(EngineConfig(model="mock", device="cpu")).start()
    seen = []
    errors0 = meter.counter("odigos_anomaly_engine_errors_total")
    try:
        ok = eng.submit(psynth(3, seed=1),
                        on_done=lambda r: seen.append(r.scores))

        def boom(r):
            raise RuntimeError("callback")

        bad = eng.submit(psynth(3, seed=2), on_done=boom)
        assert ok.done.wait(POLL_S) and bad.done.wait(POLL_S)
        assert _wait_for(lambda: meter.counter(
            "odigos_anomaly_engine_errors_total") == errors0 + 1)
        assert bad.scores is not None  # the callback's failure is its own
    finally:
        eng.shutdown()
    assert len(seen) == 1 and seen[0] is ok.scores
    assert eng.stats()["errors"] == 0  # counted in the meter, as reference


def _counters(snapshot: dict) -> dict:
    names = ("odigos_anomaly_passthrough_total",
             "odigos_anomaly_queue_full_total",
             "odigos_anomaly_scored_spans_total",
             "odigos_anomaly_cold_spans_total",
             "odigos_anomaly_engine_errors_total")
    return {k: snapshot.get(k, 0.0) for k in names}


def test_no_breaker_passes_through_and_counts_like_the_jax_engine():
    """failover=None: a faulted engine resolves every request unscored,
    counts every failed group as an engine error, and does not count the
    spans as expired (pass-through metres a passed deadline), exactly as
    the JAX engine does on the same sequence."""
    out = {}
    for name, eng_cls, cfg_cls, synth, m in (
            ("jax", JaxEngine, JaxEngineConfig, jsynth, jax_meter),
            ("port", ScoringEngine,
             lambda **kw: EngineConfig(device="cpu", **kw), psynth, meter)):
        eng = eng_cls(cfg_cls(model="zscore")).start()
        c0 = _counters(m.snapshot())
        try:
            eng.warmup(synth(50, seed=1))
            assert eng.score_sync(synth(4, seed=2), timeout_s=POLL_S) \
                is not None
            eng.inject_device_fault()
            got = [eng.score_sync(synth(3, seed=10 + i), timeout_s=POLL_S)
                   for i in range(5)]
            assert got == [None] * 5
            eng.clear_device_fault()
            assert eng.score_sync(synth(4, seed=3), timeout_s=POLL_S) \
                is not None
        finally:
            eng.shutdown()
        c1 = _counters(m.snapshot())
        out[name] = {k: c1[k] - c0[k] for k in c0}
        if name == "port":
            st = eng.stats()
            assert st["errors"] == 5 and st["passthrough_spans"] == 0
    assert out["port"] == out["jax"]
    assert out["port"]["odigos_anomaly_engine_errors_total"] == 5


def test_fault_raises_only_on_the_primary():
    pe = ScoringEngine(EngineConfig(model="mock", device="cpu",
                                    failover={"trip_errors": 1,
                                              "fallback_model": "mock"}))
    pe.inject_device_fault("card lost")
    b = psynth(4, seed=5)
    pe.submit(b)
    assert pe._dispatch_group([pe._queue.get_nowait()]) is None
    assert pe.failover.status()["last_error"] == \
        f"{DeviceFaultInjected.__name__}: card lost"
    pe.submit(b)
    grp = pe._dispatch_group([pe._queue.get_nowait()])
    assert grp is not None and grp.backend is pe.failover.fallback

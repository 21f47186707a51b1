"""Failover supervisor: circuit-broken model serving with a CPU fallback.

The port's copy of ``odigos_tpu/serving/failover.py``: the same
configuration, state machine, thresholds, metric names and history, so the
same sequence of group results under the same clock gives the same states,
counters and transitions.

Without a breaker a persistent card fault (a lost device, a failed kernel
build or launch, an out-of-memory) lands every dispatch in
``odigos_anomaly_engine_errors_total`` and every frame forwards unscored,
with nothing to degrade to and nothing that notices recovery. The
supervisor is the rung between "engine errors" and "pipeline dies":

* a **circuit breaker** watches the engine's dispatch/harvest results
  over a sliding window. ``trip_errors`` failures inside ``window_s``
  trip it: scoring swaps to a fallback backend on the CPU (zscore by
  default — the streaming route that needs no card). The swap is per
  *device call*: the worker selects a backend per coalesced group,
  in-flight primary calls still harvest against the primary, and the
  fallback's depth-1 eager scoring rides the engine's no-dispatch path.
* while tripped the supervisor **half-open probes** the primary: every
  ``probe_interval_s`` one real traffic group is routed to the primary
  backend (one probe in flight at a time — a failing probe must not take
  a burst of frames down with it). ``recovery_successes`` consecutive
  probe successes close the breaker and scoring swaps back; a failed
  probe re-opens it and re-arms the timer.
* state is **observable**: ``odigos_failover_*`` metrics through the
  port's ``meter`` (state gauge, trips/recoveries, per-result probe
  counters, fallback-scored span volume), a bounded transition history,
  and :func:`failover_conditions`, the ``engine/<model>`` rows the
  reference feeds its flow ledger's health rollup.

Fallback-scored frames ARE scored and are counted as such
(``odigos_failover_fallback_scored_spans_total``); frames that failed
before the trip forwarded unscored and were counted as engine errors.
Failover changes where scores come from, never what the accounting says.

Not ported yet: the reference's flight-recorder events on a trip or a
recovery and the flow ledger's ``HealthRollup`` that reads
:func:`failover_conditions` (the port has no self-telemetry package yet;
ROADMAP.md queue A, A9).

The supervisor never imports the engine: the engine constructs the
fallback backend and hands both backends in.
"""

from __future__ import annotations

import threading
import time
import weakref
from collections import deque
from dataclasses import dataclass
from typing import Any, Optional

from ..utils.telemetry import labeled_key, meter

STATE_GAUGE = "odigos_failover_state"
TRIPS_METRIC = "odigos_failover_trips_total"
RECOVERIES_METRIC = "odigos_failover_recoveries_total"
PROBES_METRIC = "odigos_failover_probes_total"
FALLBACK_SPANS_METRIC = "odigos_failover_fallback_scored_spans_total"
FALLBACK_ERRORS_METRIC = "odigos_failover_fallback_errors_total"

# breaker states; the gauge publishes the numeric value so fleet alert
# rules can watch it (max(odigos_failover_state[30s]) >= 1 = "a
# collector is serving on its fallback route")
CLOSED = "closed"        # primary serving (gauge 0)
OPEN = "open"            # tripped: fallback serving, probe timer armed (1)
HALF_OPEN = "half_open"  # fallback serving, one probe riding traffic (2)

_STATE_VALUE = {CLOSED: 0.0, OPEN: 1.0, HALF_OPEN: 2.0}

# models allowed as the fallback route: CPU-only and dispatch-free
# (depth-1 eager — the breaker exists because the async device path
# died). The zscore streaming detector is the production choice; mock
# keeps device-less tests cheap.
FALLBACK_MODELS = ("zscore", "mock")


@dataclass(frozen=True)
class FailoverConfig:
    """Validated failover spec (the engine config's ``failover:``
    mapping; ``true`` = all defaults). A typo'd key dies at engine
    construction — a breaker that silently never arms is worse than no
    breaker."""

    window_s: float = 5.0          # sliding error window
    trip_errors: int = 3           # errors inside the window that trip
    probe_interval_s: float = 1.0  # half-open probe cadence while open
    recovery_successes: int = 2    # consecutive probe OKs that close
    fallback_model: str = "zscore"

    def __post_init__(self) -> None:
        if self.window_s <= 0 or self.probe_interval_s <= 0:
            raise ValueError(
                "failover window_s/probe_interval_s must be positive")
        if self.trip_errors < 1 or self.recovery_successes < 1:
            raise ValueError(
                "failover trip_errors/recovery_successes must be >= 1")
        if self.fallback_model not in FALLBACK_MODELS:
            raise ValueError(
                f"failover fallback_model must be one of "
                f"{FALLBACK_MODELS}, got {self.fallback_model!r}")

    @classmethod
    def from_spec(cls, spec: Any) -> "FailoverConfig":
        """Normalize the engine-config spelling: ``True``/empty mapping
        = defaults; a mapping (or the EngineConfig-normalized item
        tuple) overrides fields; unknown keys refuse loudly."""
        if spec is True or spec is None:
            return cls()
        items = dict(spec)  # mapping or EngineConfig's item tuple
        items.pop("enabled", None)  # a rendered config's on-switch
        known = {f for f in cls.__dataclass_fields__}
        unknown = sorted(set(items) - known)
        if unknown:
            raise ValueError(
                f"unknown failover keys {unknown} (known: "
                f"{sorted(known)})")
        for k in ("window_s", "probe_interval_s"):
            if k in items:
                items[k] = float(items[k])
        for k in ("trip_errors", "recovery_successes"):
            if k in items:
                items[k] = int(items[k])
        return cls(**items)


# live supervisors, weak-registered so failover_conditions can list them
# without holding engines alive
_supervisors: "weakref.WeakSet[FailoverSupervisor]" = weakref.WeakSet()
_supervisors_lock = threading.Lock()

HISTORY = 64


class FailoverSupervisor:
    """The breaker state machine. ``select``/``observe`` are called by
    the engine worker thread only; ``status``/conditions are read from
    pollers — one lock covers both.

    ``observe`` sees every group's FINAL result (harvest success, or a
    dispatch/harvest failure) tagged with the backend that served it:
    primary results drive the breaker, fallback results only feed the
    fallback volume/error counters (a broken fallback cannot flap the
    breaker that exists to route around the primary)."""

    def __init__(self, model: str, primary: Any, fallback: Any,
                 config: Optional[FailoverConfig] = None,
                 clock=time.monotonic):
        self.model = model
        self.primary = primary
        self.fallback = fallback
        self.cfg = config or FailoverConfig()
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._errors: deque[float] = deque()
        self._probe_in_flight = False
        self._next_probe_at = 0.0
        self._consecutive_ok = 0
        self._since = clock()
        self._last_error: str = ""
        self.trips = 0
        self.recoveries = 0
        self.fallback_spans = 0
        self.history: deque[dict[str, Any]] = deque(maxlen=HISTORY)
        self._gauge_key = labeled_key(STATE_GAUGE, model=model)
        meter.set_gauge(self._gauge_key, 0.0)
        with _supervisors_lock:
            _supervisors.add(self)

    # ------------------------------------------------------------ routing

    def select(self) -> tuple[Any, bool]:
        """(backend, is_probe) for the next coalesced group. The probe
        flag rides the group and comes back through ``observe`` — the
        only way to resolve the probe slot, so a pre-trip in-flight
        group resolving late can neither free the slot (two concurrent
        probes) nor close the breaker without a genuine post-trip
        probe."""
        with self._lock:
            if self._state == CLOSED:
                return self.primary, False
            now = self._clock()
            if not self._probe_in_flight and now >= self._next_probe_at:
                # half-open: route ONE real group to the primary; every
                # other group keeps the fallback until it resolves
                self._set_state(HALF_OPEN, now)
                self._probe_in_flight = True
                return self.primary, True
            return self.fallback, False

    def select_backend(self) -> Any:
        """Backend-only spelling of :meth:`select` (tests/tools)."""
        return self.select()[0]

    def observe(self, backend: Any, ok: bool, n_spans: int = 0,
                error: str = "", probe: bool = False) -> None:
        """Final result of one group served by ``backend``; ``probe``
        echoes the flag :meth:`select` returned for that group."""
        with self._lock:
            now = self._clock()
            if backend is self.fallback:
                if ok:
                    self.fallback_spans += n_spans
                    meter.add(labeled_key(FALLBACK_SPANS_METRIC,
                                          model=self.model), n_spans)
                else:
                    meter.add(labeled_key(FALLBACK_ERRORS_METRIC,
                                          model=self.model))
                return
            if self._state == CLOSED:
                if ok:
                    return
                self._last_error = error
                self._errors.append(now)
                horizon = now - self.cfg.window_s
                while self._errors and self._errors[0] < horizon:
                    self._errors.popleft()
                if len(self._errors) >= self.cfg.trip_errors:
                    self._trip(now)
                return
            # OPEN/HALF_OPEN: only the PROBE group's result advances the
            # machine. A pre-trip in-flight call resolving late is stale
            # evidence — letting it clear the probe slot would dispatch
            # a second probe while the first is unresolved, and letting
            # its success count toward recovery would close the breaker
            # without a genuine post-trip probe.
            if not probe:
                return
            self._probe_in_flight = False
            meter.add(labeled_key(PROBES_METRIC, model=self.model,
                                  result="ok" if ok else "error"))
            if ok:
                self._consecutive_ok += 1
                if self._consecutive_ok >= self.cfg.recovery_successes:
                    self._recover(now)
                # else: stay half-open; the next select routes another
                # probe immediately (consecutive successes confirm
                # recovery back to back, not one per interval)
            else:
                self._last_error = error
                self._consecutive_ok = 0
                self._set_state(OPEN, now)
                self._next_probe_at = now + self.cfg.probe_interval_s

    # ------------------------------------------------------ state changes

    def _set_state(self, state: str, now: float) -> None:
        if state == self._state:
            return
        self._state = state
        self._since = now
        meter.set_gauge(self._gauge_key, _STATE_VALUE[state])

    def _trip(self, now: float) -> None:
        self.trips += 1
        self._errors.clear()
        self._consecutive_ok = 0
        self._probe_in_flight = False
        self._next_probe_at = now + self.cfg.probe_interval_s
        self._set_state(OPEN, now)
        meter.add(labeled_key(TRIPS_METRIC, model=self.model))
        self.history.append({
            "event": "tripped", "model": self.model, "unix_ts": time.time(),
            "error": self._last_error,
            "fallback": self.cfg.fallback_model})

    def _recover(self, now: float) -> None:
        self.recoveries += 1
        self._errors.clear()
        self._consecutive_ok = 0
        self._probe_in_flight = False
        self._set_state(CLOSED, now)
        meter.add(labeled_key(RECOVERIES_METRIC, model=self.model))
        self.history.append({
            "event": "recovered", "model": self.model,
            "unix_ts": time.time()})

    # ----------------------------------------------------------- surfaces

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    @property
    def active(self) -> bool:
        """True while the fallback serves (tripped or probing)."""
        with self._lock:
            return self._state != CLOSED

    def status(self) -> dict[str, Any]:
        with self._lock:
            return {
                "model": self.model,
                "state": self._state,
                "fallback_model": self.cfg.fallback_model,
                "since_s": round(self._clock() - self._since, 3),
                "trips": self.trips,
                "recoveries": self.recoveries,
                "fallback_scored_spans": self.fallback_spans,
                "window_errors": len(self._errors),
                "last_error": self._last_error,
                "transitions": list(self.history),
            }


def failover_conditions() -> dict[str, tuple[str, str, str]]:
    """(status, reason, message) per ``engine/<model>`` pseudo-component
    for every live supervisor. Degraded(ModelFailover) while the fallback
    serves; an explicit Healthy row after recovery so the condition
    round-trips visibly instead of vanishing. A breaker that never
    tripped contributes no row at all — an armed-but-idle supervisor must
    not grow every rollup in the process."""
    out: dict[str, tuple[str, str, str]] = {}
    with _supervisors_lock:
        sups = list(_supervisors)
    for sup in sups:
        name = f"engine/{sup.model}"
        st = sup.status()
        if st["state"] == CLOSED and st["trips"] == 0:
            continue
        if st["state"] != CLOSED:
            out[name] = (
                "Degraded", "ModelFailover",
                f"scoring on {st['fallback_model']} CPU fallback "
                f"({st['state']} {st['since_s']:.1f}s, trips "
                f"{st['trips']}"
                + (f"; last error: {st['last_error']}"
                   if st["last_error"] else "") + ")")
        else:
            out.setdefault(name, ("Healthy", "Running", ""))
    return out

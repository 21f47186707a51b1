"""Synthetic trace generation.

The port's own copy of ``odigos_tpu/pdata/gen.py``: the synthesizer and the
fault injection (``inject_faults``, its labels and ``FaultReport``s).
``synthesize_traces`` and ``inject_faults`` must stay bit-identical to the
reference for the same seeds: the parity tests feed both packages from
them, and the trainer's labelled stream is built on them.

Plays the role the reference's test fixtures play (multi-runtime HTTP services
under tests/common/services/ plus the traffic-generator Job,
tests/common/apply/generate-traffic-job.yaml): a deterministic source of
realistic multi-service trace trees for unit tests, benchmarks, and the
injected-fault ROC-AUC harness (SURVEY.md §4 item 4).

The default topology mirrors the otel-demo-style 10-service mesh used by
BASELINE config #2.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional

import numpy as np

from .spans import SpanBatch, SpanBatchBuilder, SpanKind, StatusCode

# service -> list of (child service, operation) calls made while handling a request
DEFAULT_TOPOLOGY: dict[str, list[tuple[str, str]]] = {
    "frontend": [("cart", "GET /cart"), ("product", "GET /products"),
                 ("recommendation", "GET /recommend"), ("ad", "GET /ads")],
    "cart": [("redis", "HGETALL cart")],
    "product": [("postgres", "SELECT products")],
    "recommendation": [("product", "GET /products")],
    "ad": [],
    "checkout": [("cart", "GET /cart"), ("payment", "POST /charge"),
                 ("shipping", "POST /ship"), ("email", "POST /send")],
    "payment": [],
    "shipping": [("postgres", "SELECT rates")],
    "email": [],
    "currency": [],
    "redis": [],
    "postgres": [],
}

ROOT_SERVICES = ("frontend", "checkout", "currency")

# mean self-latency (µs) per service; children add on top
_BASE_LATENCY_US: dict[str, float] = {
    "frontend": 800.0, "cart": 300.0, "product": 400.0, "recommendation": 350.0,
    "ad": 150.0, "checkout": 900.0, "payment": 1200.0, "shipping": 500.0,
    "email": 250.0, "currency": 80.0, "redis": 60.0, "postgres": 450.0,
}


@dataclass
class TraceShape:
    """Parameters of the synthetic workload."""

    topology: dict[str, list[tuple[str, str]]] = field(
        default_factory=lambda: dict(DEFAULT_TOPOLOGY))
    root_services: tuple[str, ...] = ROOT_SERVICES
    error_rate: float = 0.005
    latency_sigma: float = 0.35  # lognormal shape for self-latency
    base_latency_us: dict[str, float] = field(
        default_factory=lambda: dict(_BASE_LATENCY_US))
    max_depth: int = 6


def synthesize_traces(
    n_traces: int,
    *,
    shape: Optional[TraceShape] = None,
    seed: int = 0,
    start_unix_nano: int = 1_700_000_000_000_000_000,
) -> SpanBatch:
    """Generate ``n_traces`` full trace trees as one SpanBatch.

    Deterministic for a given (n_traces, shape, seed). Spans are emitted in
    post-order within each trace (children and client spans precede their
    parent); consumers needing parents-first must sort by start time.
    """
    shape = shape or TraceShape()
    rng = np.random.default_rng(seed)
    b = SpanBatchBuilder()
    res_idx = {svc: b.add_resource({
        "service.name": svc,
        "k8s.namespace.name": "default",
        "k8s.deployment.name": svc,
    }) for svc in shape.topology}

    id_counter = np.uint64(1)

    def next_id() -> int:
        nonlocal id_counter
        id_counter += np.uint64(1)
        return int(id_counter)

    clock = start_unix_nano
    for t in range(n_traces):
        trace_id = (int(rng.integers(1, 2**63)) << 64) | next_id()
        root_svc = shape.root_services[int(rng.integers(len(shape.root_services)))]
        clock += int(rng.integers(50_000, 2_000_000))  # traces ~ a few ms apart
        _emit_span(b, rng, shape, res_idx, trace_id, parent_id=0,
                   service=root_svc, op=f"GET /{root_svc}",
                   kind=SpanKind.SERVER, start_ns=clock, depth=0,
                   next_id=next_id)

    return b.build()


def _emit_span(b, rng, shape, res_idx, trace_id, parent_id, service, op,
               kind, start_ns, depth, next_id) -> int:
    """Emit one span and (recursively) its callees; returns end time ns."""
    span_id = next_id()
    self_us = shape.base_latency_us.get(service, 200.0)
    self_ns = int(rng.lognormal(np.log(self_us), shape.latency_sigma) * 1_000)
    cursor = start_ns + self_ns // 2

    if depth < shape.max_depth:
        for child_svc, child_op in shape.topology.get(service, ()):  # fan-out
            # CLIENT span on caller side wrapping the SERVER span on callee side
            client_id = next_id()
            child_start = cursor + int(rng.integers(5_000, 40_000))
            child_end = _emit_span(
                b, rng, shape, res_idx, trace_id, parent_id=client_id,
                service=child_svc, op=child_op, kind=SpanKind.SERVER,
                start_ns=child_start + int(rng.integers(2_000, 20_000)),
                depth=depth + 1, next_id=next_id)
            client_end = child_end + int(rng.integers(2_000, 20_000))
            b.add_span(
                trace_id=trace_id, span_id=client_id, parent_span_id=span_id,
                name=child_op, service=service, kind=SpanKind.CLIENT,
                status_code=StatusCode.UNSET,
                start_unix_nano=child_start, end_unix_nano=client_end,
                resource_index=res_idx[service],
                attrs={"peer.service": child_svc})
            cursor = client_end

    end_ns = max(cursor, start_ns + self_ns)
    is_error = rng.random() < shape.error_rate
    b.add_span(
        trace_id=trace_id, span_id=span_id, parent_span_id=parent_id,
        name=op, service=service, kind=kind,
        status_code=StatusCode.ERROR if is_error else StatusCode.UNSET,
        start_unix_nano=start_ns, end_unix_nano=end_ns,
        resource_index=res_idx[service],
        attrs={"http.method": op.split(" ")[0]} if " " in op else None)
    return end_ns


ORPHAN_PARENT = 0xDEADBEEFCAFEF00D  # a parent id no span declares


def adversarial_traces(n_traces: int, seed: int = 0,
                       long_trace: int = 200) -> SpanBatch:
    """``synthesize_traces`` bent toward the corners of the fused route's
    kernels (the port's own; the JAX package has no such generator):

    * every span, trace and (non-zero) parent id has its top bit set, and
      half the traces clear it again in ``trace_id_hi``, so unsigned and
      signed order differ;
    * the first ``long_trace`` spans form one trace (several chunks of 64);
    * start times rounded down to the millisecond: spans of a trace tie,
      and their order is the sort's stability;
    * every seventh span repeats the previous declaration's span id (the
      first row must win the parent join);
    * every eleventh parent resolves nowhere; every thirteenth span ends
      before it starts.
    """
    b = synthesize_traces(n_traces, seed=seed)
    cols = dict(b.columns)
    high = np.uint64(1 << 63)
    for name in ("span_id", "trace_id_hi", "trace_id_lo"):
        cols[name] = cols[name] | high
    par = cols["parent_span_id"]
    par = np.where(par == 0, par, par | high)
    half = (cols["trace_id_hi"] & np.uint64(1)) == 0
    cols["trace_id_hi"] = np.where(half, cols["trace_id_hi"] & ~high,
                                   cols["trace_id_hi"])
    k = min(long_trace, len(b))
    for name in ("trace_id_hi", "trace_id_lo"):
        col = cols[name].copy()
        col[:k] = col[0]
        cols[name] = col
    ms = np.uint64(1_000_000)
    cols["start_unix_nano"] = cols["start_unix_nano"] // ms * ms
    span = cols["span_id"].copy()
    span[1::7] = span[0::7][:len(span[1::7])]
    cols["span_id"] = span
    par = par.copy()
    par[::11] = np.uint64(ORPHAN_PARENT)
    cols["parent_span_id"] = par
    end = cols["end_unix_nano"].copy()
    end[::13] = cols["start_unix_nano"][::13] - np.uint64(5)
    cols["end_unix_nano"] = end
    return replace(b, columns=cols)


JOIN_STRESS_IDS = (0, (1 << 63) | 5)  # the span ids the stress frames share


def join_stress_frames(n_traces: int, frames: int = 4,
                       seed: int = 0) -> list[SpanBatch]:
    """``frames`` requests of ``synthesize_traces`` (``n_traces`` among
    them) bent toward the corners of K5's parent join (the port's own; the
    JAX package has no such generator): every span of frame k declares
    the one span id ``JOIN_STRESS_IDS[k % 2]`` (so one key has every row of
    its frame, the same ids repeat across frames, and span id 0 is
    declared), and the parents resolve nowhere but every eighth, which
    names its own frame's id (the frame's first row is its parent; where
    that id is 0 the span is a root whose parent service is still the
    first row's). Every fifth parent names the other frames' id, declared
    in the group but not in its own frame."""
    out = []
    for k in range(frames):
        b = synthesize_traces(max(1, n_traces // frames), seed=seed + k)
        cols = dict(b.columns)
        own = np.uint64(JOIN_STRESS_IDS[k % 2])
        other = np.uint64(JOIN_STRESS_IDS[(k + 1) % 2])
        n = len(b)
        cols["span_id"] = np.full(n, own, np.uint64)
        par = np.full(n, np.uint64(ORPHAN_PARENT), np.uint64) ^ np.arange(
            n, dtype=np.uint64)
        par[::5] = other
        par[::8] = own
        cols["parent_span_id"] = par
        out.append(replace(b, columns=cols))
    return out


# ------------------------------------------------------------ fault injection


FAULT_KINDS = ("latency_spike", "error_storm", "slow_dependency",
               "missing_subtree")


@dataclass(frozen=True)
class FaultReport:
    """Ground truth for one injected fault."""

    trace_id_lo: int
    kind: str
    service: str


def inject_faults(
    batch: SpanBatch,
    *,
    fault_fraction: float = 0.1,
    kinds: tuple[str, ...] = FAULT_KINDS,
    seed: int = 0,
) -> tuple[SpanBatch, np.ndarray, list[FaultReport]]:
    """Perturb a fraction of traces with realistic faults; returns
    (batch, span_labels, reports) where span_labels marks culprit spans.

    This is the simple-trace-db + chaos-experiment analog (SURVEY.md §4
    items 4/6): deterministic anomalies with span-level ground truth for
    ROC-AUC measurement (BASELINE north star: AUC >= 0.95).

    Fault kinds:
    * latency_spike    — one span's duration stretched 8-30x; ancestors
                         absorb the delay (end times propagate up)
    * error_storm      — a span and all its descendants flip to ERROR
    * slow_dependency  — every span of one service in the trace slows 5-15x
    * missing_subtree  — a subtree vanishes (its caller CLIENT span remains,
                         labeled, with its duration collapsed)
    """
    rng = np.random.default_rng(seed)
    cols = {k: v.copy() for k, v in batch.columns.items()}
    n = len(batch)
    labels = np.zeros(n, dtype=bool)
    keep = np.ones(n, dtype=bool)
    reports: list[FaultReport] = []

    trace_lo = cols["trace_id_lo"]
    uniq_traces = np.unique(trace_lo)
    n_faulty = int(round(len(uniq_traces) * fault_fraction))
    if n_faulty == 0:
        return batch, labels, reports
    faulty = rng.choice(uniq_traces, size=n_faulty, replace=False)

    span_id = cols["span_id"]
    parent_id = cols["parent_span_id"]
    start = cols["start_unix_nano"]
    end = cols["end_unix_nano"]
    svc_col = cols["service"]

    for t in faulty:
        rows = np.flatnonzero(trace_lo == t)
        kind = kinds[int(rng.integers(len(kinds)))]
        # children map within this trace
        children: dict[int, list[int]] = {}
        for r in rows:
            children.setdefault(int(parent_id[r]), []).append(int(r))
        by_id = {int(span_id[r]): int(r) for r in rows}

        def subtree(root_row: int) -> list[int]:
            out, stack = [], [root_row]
            while stack:
                r = stack.pop()
                out.append(r)
                stack.extend(children.get(int(span_id[r]), ()))
            return out

        def ancestors(row: int) -> list[int]:
            out = []
            r = row
            while int(parent_id[r]) in by_id:
                r = by_id[int(parent_id[r])]
                out.append(r)
            return out

        victim = int(rows[rng.integers(len(rows))])
        svc = batch.string_at(int(svc_col[victim]))

        if kind == "latency_spike":
            dur = int(end[victim] - start[victim])
            extra = int(dur * rng.uniform(8.0, 30.0))
            end[victim] += extra
            labels[victim] = True
            for a in ancestors(victim):  # parents absorb the delay
                end[a] = max(int(end[a]), int(end[victim])) + 1_000
        elif kind == "error_storm":
            for r in subtree(victim):
                cols["status_code"][r] = int(StatusCode.ERROR)
                labels[r] = True
        elif kind == "slow_dependency":
            svc_rows = rows[svc_col[rows] == svc_col[victim]]
            factor = rng.uniform(5.0, 15.0)
            for r in svc_rows:
                dur = int(end[r] - start[r])
                end[r] = start[r] + int(dur * factor)
                labels[r] = True
            # every slowed span's ancestor chain absorbs the delay — the
            # service may appear in several branches of the trace, and each
            # branch's parents must keep containing their children
            for r in svc_rows:
                for a in ancestors(int(r)):
                    end[a] = max(int(end[a]), int(end[r]) + 1_000)
        elif kind == "missing_subtree":
            victims = [r for r in rows
                       if int(parent_id[r]) in by_id
                       and children.get(int(span_id[r]))]
            if not victims:
                continue  # single-span traces can't lose a subtree
            victim = int(victims[int(rng.integers(len(victims)))])
            svc = batch.string_at(int(svc_col[victim]))  # the removed svc
            gone = subtree(victim)
            keep[gone] = False
            caller = by_id[int(parent_id[victim])]
            end[caller] = start[caller] + 1_000  # collapsed call
            labels[caller] = True
        else:
            raise ValueError(f"unknown fault kind {kind!r}; "
                             f"valid: {FAULT_KINDS}")
        reports.append(FaultReport(int(t), kind, svc))

    out = SpanBatch(strings=batch.strings, resources=batch.resources,
                    span_attrs=batch.span_attrs, columns=cols)
    if not keep.all():
        out = out.filter(keep)
        labels = labels[keep]
    return out, labels, reports

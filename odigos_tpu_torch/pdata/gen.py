"""Synthetic trace generation.

The port's own copy of the synthesizer half of ``odigos_tpu/pdata/gen.py``
(fault injection is not carried yet). ``synthesize_traces`` must stay
bit-identical to the reference for the same ``(n_traces, seed)``: the
parity tests feed both packages from it.

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

"""Batched async scoring engine — the port's scoring stage on the GPU.

A trimmed port of ``odigos_tpu/serving/engine.py`` with five models: the
streaming z-score detector (``zscore``, the default, as in the JAX
package), the packed trace transformer (``transformer``), the span
autoencoder (``autoencoder``, one trace per row), the deterministic test
model (``mock``) and a sidecar in another process (``remote``,
``serving/sidecar.py`` ``RemoteBackend`` on ``socket_path``), chosen from
``_BACKENDS``. The engine contract is kept:

* callers ``submit()`` batches into a **bounded** queue (``submit`` returns
  None when it is full or the engine is shutting down) and wait on a
  per-request event, or pass ``on_done``, called once per request after
  its scores are set; ``score_sync`` returns None when its deadline
  passes, so the caller forwards the spans unscored;
* the worker's pack stage drains the queue and **coalesces** pending
  requests into one device call, up to ``max_batch_spans``; a request
  with ``deadline_ns`` (monotonic) caps its call so that the harvest is
  expected inside that deadline: the headroom over an EWMA of the
  observed cost a span, snapped down onto the bucket ladder's rows
  (``_adaptive_cap``; past the deadline, drain mode: the full cap);
* a backend with ``dispatch`` (the transformer, the autoencoder) is
  **pipelined**: the pack stage packs on the host (the transformer: next-fit
  packed rows; the autoencoder: one trace per row, ``assemble_sequences``)
  and dispatches the forward without blocking —
  the packed arrays go to pinned host memory, are copied to the card with
  ``non_blocking=True``, the forward and the copy of the scores back to
  pinned memory are enqueued, and a CUDA event marks the end. The pinned
  arrays ride in the in-flight handle until harvest, so the next pack
  cannot overwrite a copy still in progress. Up to ``pipeline_depth``
  calls ride in flight; the harvest stage waits on the oldest call's event
  (the one blocking host/device interaction), scatters scores back to span
  order (the autoencoder's reconstruction errors squashed to ``1 -
  exp(-err)`` first, as the reference does) and wakes the requests — FIFO,
  so results equal the serial path's;
* every other backend runs at **depth 1**, its whole call in the pack
  stage under the backend lock: zscore scores a call against the state
  before folding the call into it (``online_update``), and that order must
  hold call by call;
* packed row counts round up to a geometric **bucket ladder** of shapes
  (zscore: span buckets), optionally all run once at ``start()``
  (``warm_ladder``) so the first request pays no kernel build, CUDA context
  or module load;
* ``warmup(batch)`` feeds presumed-normal traffic exactly as the reference
  does: the backend's own ``warmup`` (zscore: an update), then a score,
  which for zscore with ``online_update`` updates again — the batch is
  folded into the state twice;
* the **fused columns route** (``serving/fused.py``): ``submit(batch,
  columns=cols)`` with ``cols`` from ``extract_columns(batch)`` defers
  featurize; a group whose requests all carry columns, on a backend with
  the fused kernels (the transformer's and the autoencoder's), scores in
  one non-blocking dispatch that featurizes, packs, scores and scatters on
  the card (``dispatch_columns``); any other group takes the host route,
  the columns-carrying requests featurized in the pack stage.
  ``stats()`` counts fused frames and columns-carrying frames that took
  the host route under the reference's metric names.
* **failover** (``EngineConfig.failover``, off by default;
  ``serving/failover.py``): a circuit breaker over the dispatch/harvest
  results swaps scoring per group to a fallback backend built on the CPU
  (zscore or mock) after ``trip_errors`` failures, and half-open probes
  the primary back. The primary stays on its device and raises as it
  would without a breaker; ``inject_device_fault`` makes every primary
  dispatch raise :class:`DeviceFaultInjected` (the chaos hook). A group
  harvests against the backend that dispatched it. One departure: the
  engine's ``warmup`` also warms the fallback's state (the reference's
  zscore fallback starts cold), so its first scores are not cold ones;
* **meters**: the reference's counters, gauges and histograms under its
  names and labels (``utils/telemetry.py``'s ``meter``); ``stats()``
  carries ``"adaptive"`` (the estimators and the last cap) and, with a
  breaker, ``"failover"``;
* ``shutdown()`` drains queued and in-flight work losslessly.

``torch.inference_mode()`` and the current CUDA stream are per thread, so
every method that touches the device enters inference mode itself, on
whichever thread calls it; all device work goes to that thread's current
stream (the default stream unless the caller set another).

``EngineConfig.quantized`` serves the transformer with int8 (W8A8)
products (``models/quantized.py``, kernels K9 and K10) on both routes; the
entry points are the engine and, in the reference, the processor config.

``EngineConfig.checkpoint_path`` serves a trained model: a serving bundle
(``training/checkpoint.py``, written by ``Trainer.export``) whose geometry
and weights win, as in the reference. The engine refuses a bundle of
another model or a ``model_config`` that disagrees with the bundle's;
``quantized=True`` quantizes the bundle's f32 weights once at load; the
model serves in the bundle's own working type (f32 from the trainer).
Without a bundle the sequence models' weights are random, drawn from
``seed``.

**The engine's mesh** (``EngineConfig.mesh``, ``{"data": dp, "model":
tp}`` or pairs; ``data_parallel`` is the legacy ``{"data": N}``): the
engine owns one ``DeviceMesh`` (``parallel.make_mesh``) and the sequence
backends receive it and score every call through the partition-rule plan
(``parallel.compile_plan``): rows on the data axis; on the model axis
the attention heads and FFN columns of either model's blocks, and the
autoencoder's decoder FFN columns and vocabulary heads' rows (each rank's
K11 ``"slice"`` records gathered and merged by K24, so every rank holds
the same errors); the bucket ladder's rungs are ``lcm(base, dp)``. A mesh the world cannot back serves on one device,
counted in ``odigos_engine_mesh_unavailable_total{model=}``; a mesh with
``quantized=True`` is refused; under a plan the fused route falls back
with reason ``"backend"``; the adaptive coalescer's estimates are learned
per (model, geometry, mesh) (``_ADAPT_PRIORS``). The reference is one
process over every device; the port is SPMD: every rank of the mesh
builds the same engine from the same config. The mesh's first rank is the
leader: it alone takes requests and runs the queue, coalescing, deadlines,
failover and the depth-2 window. At each dispatch it broadcasts a header
(op, shapes) and the packed arrays to the mesh's ranks (``_MeshLink``);
every rank takes its data shard's rows and runs the plan's call (the
model axis's all-reduces, the all-gather of the scores over the data
axis). Every collective is issued at dispatch, in the same order on every
rank (the harvest issues none). ``start()`` on another rank runs a
follower loop that mirrors the leader's calls until its ``shutdown()``
broadcasts a stop; ``warmup`` on a follower mirrors the leader's
``warmup``; ``submit`` on a follower raises. A rank's failure between a
header and its arrays leaves the others waiting in their collective
until its group's timeout.

Not ported yet (later slices, listed in ROADMAP.md): the flow ledger and
its ``ModelFailover`` health rollup, the pack buffer pool (``on_features_consumed``), the self-tracer
and latency attribution (``stage_ns``, the score span's attributes and
the first-call compile estimate).
"""

from __future__ import annotations

import logging
import math
import queue
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Union

import numpy as np
import torch

from ..features.featurizer import (
    FeaturizerConfig, SpanFeatures, featurize, pack_sequences)
from ..models.autoencoder import AutoencoderConfig
from ..models.quantized import QuantizedTraceScorer
from ..models.transformer import TraceTransformer, TransformerConfig
from ..models.zscore import ZScoreDetector
from ..pdata.spans import SpanBatch, concat_batches
from ..utils.device import resolve_device
from ..utils.telemetry import labeled_key, meter
from .failover import FailoverConfig, FailoverSupervisor

log = logging.getLogger(__name__)

PASSTHROUGH_METRIC = "odigos_anomaly_passthrough_total"
QUEUE_FULL_METRIC = "odigos_anomaly_queue_full_total"
SCORED_METRIC = "odigos_anomaly_scored_spans_total"
COLD_METRIC = "odigos_anomaly_cold_spans_total"
ERRORS_METRIC = "odigos_anomaly_engine_errors_total"
LATENCY_METRIC = "odigos_anomaly_score_latency_ms"
DEVICE_BUSY_GAUGE = "odigos_anomaly_device_busy_frac"
STAGE_PACK_METRIC = "odigos_anomaly_stage_pack_ms"
STAGE_DEVICE_METRIC = "odigos_anomaly_stage_device_ms"
STAGE_HARVEST_METRIC = "odigos_anomaly_stage_harvest_ms"
ADAPTIVE_CAP_GAUGE = "odigos_engine_adaptive_cap_spans"
MESH_UNAVAILABLE_METRIC = "odigos_engine_mesh_unavailable_total"
FUSED_FRAMES_METRIC = "odigos_fastpath_fused_frames_total"
FUSED_FALLBACK_METRIC = "odigos_fastpath_fused_fallback_total"

# EWMA smoothing of the per-span call-cost estimate; 0.2 follows load
# shifts within ~5 calls without letting one outlier call resize the next
# batch
_ADAPT_ALPHA = 0.2


def _mesh_label(mesh_spec) -> str:
    """The gauge and stats label of a normalized mesh spec
    (``"data4xmodel2"``; ``"single"`` for none), ``parallel.mesh_key``'s."""
    parts = [f"{a}{int(n)}" for a, n in (mesh_spec or ()) if int(n) > 1]
    return "x".join(parts) if parts else "single"


@dataclass(frozen=True)
class EngineConfig:
    model: str = "zscore"  # zscore | transformer | autoencoder | mock | remote
    max_queue: int = 64          # pending requests bound
    max_batch_spans: int = 65536  # coalescing cap per device call
    max_len: int = 64            # spans per packed row
    trace_bucket: int = 256      # base row-shape bucket
    online_update: bool = True   # zscore: fit on observed traffic
    # transformer: serve with int8 (W8A8) products; the weights quantize
    # once at load (models/quantized.py)
    quantized: bool = False
    featurizer: FeaturizerConfig = field(default_factory=FeaturizerConfig)
    # the sequence model's geometry (TransformerConfig or
    # AutoencoderConfig, by model); None = its defaults
    model_config: Optional[Union[TransformerConfig,
                                 AutoencoderConfig]] = None
    # a serving bundle (training/checkpoint.py): its geometry and weights
    # win over model_config and seed; sequence models only
    checkpoint_path: Optional[str] = None
    socket_path: Optional[str] = None  # model "remote": sidecar unix socket
    remote_timeout_s: float = 10.0  # model "remote": per-call socket deadline
    seed: int = 0                # random weights when there is no bundle
    # depth 2 = double buffering: one call packing on the host while one
    # runs on the card (pipelined backends only; the others clamp to 1)
    pipeline_depth: int = 2
    bucket_ladder: int = 4       # geometric row buckets above trace_bucket
    warm_ladder: bool = False    # run every ladder rung at start()
    # failover supervisor (serving/failover.py): a circuit breaker over
    # the dispatch/harvest results that swaps scoring to a CPU fallback on
    # a persistent device fault and half-open probes the primary back.
    # True (defaults) or a {window_s, trip_errors, probe_interval_s,
    # recovery_successes, fallback_model} mapping, normalized hashable
    # below; None/False/{"enabled": False} = no breaker
    failover: Any = None
    device: str = "cuda"         # "cpu" runs the kernels' plain versions
    # the engine's device mesh (sequence models): {"data": N, "model": M}
    # or ((axis, size), ...) pairs, normalized below to a hashable tuple,
    # None when the product is 1; every rank of the mesh builds the same
    # engine (the module docstring)
    mesh: Any = None
    # the legacy spelling of mesh={"data": N}; ignored when mesh is set
    data_parallel: int = 0

    def __post_init__(self) -> None:
        m = self.mesh
        if m is not None:
            items = m.items() if isinstance(m, dict) else tuple(m)
            m = tuple((str(a), int(n)) for a, n in items)
            bad = [(a, n) for a, n in m if n <= 0]
            if bad:
                # dropping a zero-size axis would serve data-parallel
                # while the operator believes tp is on: refuse
                raise ValueError(f"mesh axes must be positive: {bad}")
        if m is None and self.data_parallel and self.data_parallel > 1:
            m = (("data", int(self.data_parallel)),)
        if m is not None and math.prod(n for _, n in m) <= 1:
            m = None  # a 1x1 mesh is the one-device path
        object.__setattr__(self, "mesh", m)
        if self.quantized and self.model != "transformer":
            # as the reference: refuse rather than serve float quietly
            raise ValueError(
                f"quantized serving is only implemented for the "
                f"transformer model, not {self.model!r}")
        if self.model not in _BACKENDS:
            raise ValueError(f"unknown scoring model {self.model!r} "
                             f"(known: {sorted(_BACKENDS)})")
        f = self.failover
        if f is False or f is None:
            f = None
        elif f is True:
            f = ()  # all-defaults breaker
        else:
            items = dict(f.items() if isinstance(f, dict) else tuple(f))
            # {"enabled": False} is an explicit opt-out, not a tuning knob
            if not items.pop("enabled", True):
                f = None
            else:
                f = tuple(sorted((str(k), v) for k, v in items.items()))
        object.__setattr__(self, "failover", f)

    def mesh_shape(self) -> Optional[dict[str, int]]:
        """The normalized mesh as the dict ``parallel.make_mesh`` takes."""
        return dict(self.mesh) if self.mesh else None

    def failover_spec(self) -> Optional[dict[str, Any]]:
        """Normalized failover mapping (None = breaker disabled)."""
        return dict(self.failover) if self.failover is not None else None


class DeviceFaultInjected(RuntimeError):
    """Raised by the chaos device-fault hook (``inject_device_fault``):
    the deterministic stand-in for a dead or wedged card on the primary
    scoring route."""


class BucketLadder:
    """Geometric row-count buckets bounding the set of device shapes.

    ``round_rows`` maps a real packed row count to the smallest ladder
    bucket that holds it (base, 2·base, 4·base, ...); counts beyond the top
    bucket round up to a multiple of it. ``observe`` tracks which shapes
    have already run this process (LRU-bounded), feeding the hit rate;
    ``mark_warm`` pre-seeds it from ``warm()``; ``floor_rows`` snaps the
    adaptive coalescer's row budget down onto the ladder. ``align`` lifts
    every rung to ``lcm(base, align)``: under a mesh of dp data ranks each
    padded row count divides among them, so the sharded call never pads
    again.
    """

    def __init__(self, base: int, n_buckets: int = 4, align: int = 1):
        self.align = max(1, int(align))
        self.base = math.lcm(max(1, int(base)), self.align)
        self.buckets = [self.base << k for k in range(max(1, int(n_buckets)))]
        self.hits = 0
        self.misses = 0
        self._compiled: OrderedDict[int, None] = OrderedDict()
        self._max_tracked = max(16, len(self.buckets) * 2)

    def round_rows(self, rows: int) -> int:
        for b in self.buckets:
            if rows <= b:
                return b
        top = self.buckets[-1]
        return ((rows + top - 1) // top) * top

    def mark_warm(self, rows: int) -> None:
        self._compiled[rows] = None
        self._compiled.move_to_end(rows)

    def observe(self, rows: int) -> bool:
        """Record a device call at this padded row count; True = the shape
        already ran (warm hit)."""
        hit = rows in self._compiled
        if hit:
            self.hits += 1
            self._compiled.move_to_end(rows)
        else:
            self.misses += 1
            self._compiled[rows] = None
            if len(self._compiled) > self._max_tracked:
                self._compiled.popitem(last=False)
        return hit

    def floor_rows(self, rows: float) -> int:
        """Largest padded row count ≤ ``rows`` that ``round_rows`` could
        emit (the smallest bucket when nothing fits): the adaptive
        coalescer sizes deadline-bounded calls DOWN onto shapes the
        ladder serves, never up onto a new one. Beyond the top bucket
        that is a multiple of it, mirroring ``round_rows``."""
        top = self.buckets[-1]
        if rows >= top:
            return (int(rows) // top) * top
        best = self.buckets[0]
        for b in self.buckets:
            if b <= rows:
                best = b
        return best

    def stats(self) -> dict[str, Any]:
        total = self.hits + self.misses
        return {
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": round(self.hits / total, 4) if total else 0.0,
            "buckets": list(self.buckets),
            "align": self.align,
        }


@dataclass
class _Handle:
    """One dispatched call: the scores' destination (pinned host memory on
    the card, the result itself on the CPU), the event that marks the
    end of the call's device work, the pinned inputs kept alive until
    then, and what the scatter needs."""

    scores: torch.Tensor
    event: Optional[torch.cuda.Event]
    keepalive: tuple
    span_index: np.ndarray
    mask: np.ndarray
    n: int


class SequenceBackend:
    """The packed transformer route: pack → forward → scatter.

    Scores are computed per packed (row, slot) and scattered back to span
    rows via ``span_index``; ``dispatch`` enqueues the device work without
    blocking and ``harvest`` waits for it. The autoencoder's backend
    (``serving/fused.py`` ``AutoencoderBackend``) overrides the model, the
    host pack, the squash and the padding rows.
    """

    # packing a coalesced group reads only these columns: the engine hands
    # it a columns-only stand-in instead of a merged SpanBatch
    coalesce_columns = ("trace_id_hi", "trace_id_lo", "start_unix_nano")
    # the geometry EngineConfig.model_config must hold
    config_cls: type = TransformerConfig

    def __init__(self, cfg: EngineConfig, mesh: Any = None):
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        # the ENGINE's mesh (one mesh, one owner): never built here
        self.mesh = mesh
        if mesh is not None and cfg.quantized:
            # refusing beats serving float while holding int8 weights
            raise ValueError("quantized serving does not compose with a "
                             "device mesh yet; pick one")
        variables = None
        model_config = cfg.model_config
        if cfg.checkpoint_path:
            # the bundle carries the geometry, so a config needs only the
            # path; an explicit geometry that disagrees would mis-index
            from ..training.checkpoint import load_bundle

            bundle = load_bundle(cfg.checkpoint_path)
            if bundle.model != cfg.model:
                raise ValueError(
                    f"checkpoint {cfg.checkpoint_path} holds a "
                    f"{bundle.model!r} model but the engine is configured "
                    f"for {cfg.model!r}")
            if model_config is not None and \
                    model_config != bundle.model_config:
                raise ValueError(
                    f"model_config disagrees with checkpoint "
                    f"{cfg.checkpoint_path}: {model_config} vs "
                    f"{bundle.model_config}")
            model_config = bundle.model_config
            variables = bundle.variables
        model_config = model_config or self.config_cls(
            attr_slots=cfg.featurizer.attr_slots)
        if not isinstance(model_config, self.config_cls):
            raise ValueError(f"model {cfg.model!r} takes a "
                             f"{self.config_cls.__name__}, not "
                             f"{type(model_config).__name__}")
        if model_config.attr_slots != cfg.featurizer.attr_slots:
            raise ValueError(
                f"model attr_slots {model_config.attr_slots} != featurizer "
                f"attr_slots {cfg.featurizer.attr_slots}")
        self.model = self._model_cls()(model_config, device=self.device,
                                       seed=cfg.seed)
        if variables is not None:
            # the int8 scorer quantizes the bundle's f32 weights here
            self.model.load_state_dict(variables)
        # the positional table bounds the row length
        self.max_len = min(cfg.max_len, model_config.max_len)
        dp = 1
        if mesh is not None:
            dp = int(dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)).get(
                "data", 1))
        # rungs lcm-aligned to the data axis: every call divides among
        # the data ranks
        self.ladder = BucketLadder(cfg.trace_bucket, cfg.bucket_ladder,
                                   align=dp)
        self._plan = None
        self.variables: Optional[dict] = None
        # the leader's broadcast to the mesh's ranks (the engine sets it)
        self.link: Optional["_MeshLink"] = None
        if mesh is not None:
            from ..parallel.sharding import compile_plan

            # the whole model's weights, placed once by the plan (its
            # identity cache holds this dict)
            self.variables = self.model.state_dict()
            self._plan = compile_plan(self.model, mesh)
        self.device_label = (torch.cuda.get_device_name(self.device)
                             if self.device.type == "cuda" else "cpu")
        self.last_shape: Optional[list[int]] = None

    def _model_cls(self) -> type:
        # the int8 scorer quantizes the seed's f32 draws and keeps no
        # float copy of the dense weights; it scores like the float model
        # (score_packed, score_packed_scatter), so both routes serve it
        return QuantizedTraceScorer if self.cfg.quantized \
            else TraceTransformer

    # ------------------------------------------------------- device stage
    def _forward(self, *arrays: Any) -> torch.Tensor:
        """The model's ``(R, L)`` probabilities over (categorical,
        continuous, segments, positions); under a mesh, the plan's
        sharded call."""
        if self._plan is not None:
            return self._plan.score_packed(self.variables, *arrays)
        return self.model.score_packed(*arrays)

    @torch.inference_mode()
    def _device_call(self, *arrays: np.ndarray
                     ) -> tuple[torch.Tensor, Any, tuple]:
        """Enqueue the forward; returns (scores, event, keepalive)
        WITHOUT waiting on the card. Under a mesh the leader first
        broadcasts the arrays to the mesh's ranks (``_MeshLink``)."""
        if self.device.type == "cpu":
            if self.link is not None:
                arrays = self.link.send([torch.from_numpy(
                    np.ascontiguousarray(a)) for a in arrays])
            return self._forward(*arrays), None, ()
        host = tuple(torch.from_numpy(np.ascontiguousarray(a)).pin_memory()
                     for a in arrays)
        dev = [h.to(self.device, non_blocking=True) for h in host]
        if self.link is not None:
            dev = self.link.send(dev)
        probs = self._forward(*dev)
        out = torch.empty(probs.shape, dtype=torch.float32, pin_memory=True)
        out.copy_(probs, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return out, event, host

    def dispatch(self, batch: Any, features: SpanFeatures) -> _Handle:
        """Pack stage: host pack/pad + non-blocking device enqueue."""
        packed = pack_sequences(batch, features, max_len=self.max_len,
                                pad_rows_to=self.ladder.round_rows)
        self.last_shape = list(packed.categorical.shape[:2])
        self.ladder.observe(packed.n_rows)
        scores, event, keep = self._device_call(
            packed.categorical, packed.continuous, packed.segments,
            packed.positions)
        return _Handle(scores, event, keep, packed.span_index, packed.mask,
                       len(batch))

    def harvest(self, handle: _Handle) -> np.ndarray:
        """Harvest stage: wait for the call, scatter scores to span rows."""
        if handle.event is not None:
            handle.event.synchronize()
        span_scores = self._span_scores(handle.scores.numpy())
        out = np.zeros(handle.n, np.float32)
        out[handle.span_index[handle.mask]] = span_scores[handle.mask]
        return out

    def _span_scores(self, scores: np.ndarray) -> np.ndarray:
        """A harvested call's ``(R, L)`` outputs as scores in [0, 1]: the
        transformer's probabilities already are."""
        return scores

    def score(self, batch: Any, features: SpanFeatures) -> np.ndarray:
        return self.harvest(self.dispatch(batch, features))

    @torch.inference_mode()
    def follow(self, arrays: list[torch.Tensor]) -> None:
        """A follower rank's part of one leader call: the plan's sharded
        forward on the broadcast arrays (its collectives in the leader's
        order); the scores are the leader's."""
        self._forward(*arrays)

    def warm(self) -> None:
        """Run every ladder rung once on all-padding rows and wait: the
        kernels build and load, the CUDA context and cuBLAS handles come
        up, and the caching allocator holds each shape's buffers before
        the first request. Under a mesh each rung runs once on the
        mesh (the followers mirror it)."""
        for R in self.ladder.buckets:
            _, event, _ = self._device_call(*self._padding_rows(R))
            if event is not None:
                event.synchronize()
            self.ladder.mark_warm(R)

    def _padding_rows(self, R: int) -> tuple[np.ndarray, ...]:
        """``R`` all-padding rows of the forward's inputs: categorical,
        continuous, segments, positions."""
        C = self.cfg.featurizer.cat_width
        D = self.cfg.featurizer.cont_width
        L = self.max_len
        return (np.zeros((R, L, C), np.int32), np.zeros((R, L, D), np.float32),
                np.zeros((R, L), np.int32), np.zeros((R, L), np.int32))


class MockBackend:
    """Deterministic test model: score = duration percentile proxy, and
    1.0 for spans carrying the attribute ``mock.anomaly``. Host numpy, as
    in the reference; the device is resolved like every model's, so
    ``"cuda"`` without a card raises here too."""

    def __init__(self, cfg: EngineConfig, mesh: Any = None):
        self.cfg = cfg  # mesh ignored: no device work to shard
        self.device = resolve_device(cfg.device)
        self.device_label = "host"

    def score(self, batch: SpanBatch, features: SpanFeatures) -> np.ndarray:
        log_dur = features.continuous[:, 0]
        scores = np.clip((log_dur - 5.0) / 10.0, 0.0, 1.0)
        forced = batch.attrs().mask_has("mock.anomaly")
        return np.where(forced, 1.0, scores).astype(np.float32)


class ZScoreBackend:
    """The streaming z-score detector (``models/zscore.py``) as a serial
    backend: each call stages the ids and log-durations of its real spans
    once, then one launch scores them against the state — squashed
    ``1 - exp(-z/4)``, cold spans counted on the device — and, with
    ``online_update``, folds them into the state (K4 and K3 together);
    the scores and the cold count come back in one copy, with one wait.
    No ``dispatch``: score-then-update stays ordered call by call, so the
    engine runs it at depth 1."""

    # scoring reads features only: a coalesced group needs no merged batch
    coalesce_columns: tuple = ()

    def __init__(self, cfg: EngineConfig, mesh: Any = None):
        self.cfg = cfg  # mesh ignored: the streaming state is unsharded
        self.det = ZScoreDetector(device=cfg.device)
        self.device = self.det.device
        self.device_label = (torch.cuda.get_device_name(self.device)
                             if self.device.type == "cuda" else "cpu")
        self.cold_spans = 0
        self.last_shape: Optional[list[int]] = None

    @torch.inference_mode()
    def score(self, batch: Any, features: SpanFeatures) -> np.ndarray:
        if len(features) == 0:
            return np.zeros(0, np.float32)
        st = self.det.stage(features)
        self.last_shape = [st.bucket]
        scores, cold = self.det.score_staged(st,
                                             update=self.cfg.online_update)
        self.cold_spans += cold
        if cold:
            meter.add(COLD_METRIC, cold)
        return scores

    def warm(self) -> None:
        """``warm_ladder``: every span bucket the coalescer can emit gets
        its staging buffers and one run of both kernels, state untouched."""
        with torch.inference_mode():
            self.det.warm(self.cfg.max_batch_spans,
                          self.cfg.featurizer.cat_width)

    @torch.inference_mode()
    def warmup(self, batch: SpanBatch) -> None:
        self.det.update(featurize(batch, self.cfg.featurizer))


def _fused_backend(cfg: EngineConfig, mesh: Any = None):
    # FusedSequenceBackend IS a SequenceBackend: the host route stays as it
    # is and the subclass adds the columns → scores route. Imported here:
    # serving/fused.py imports this module.
    from .fused import FusedSequenceBackend

    return FusedSequenceBackend(cfg, mesh=mesh)


def _autoencoder_backend(cfg: EngineConfig, mesh: Any = None):
    from .fused import AutoencoderBackend

    return AutoencoderBackend(cfg, mesh=mesh)


def _remote_backend(cfg: EngineConfig, mesh: Any = None):
    from .sidecar import RemoteBackend

    return RemoteBackend(cfg)  # the mesh lives sidecar-side for remote


_BACKENDS = {
    "mock": MockBackend,
    "zscore": ZScoreBackend,
    "transformer": _fused_backend,
    "autoencoder": _autoencoder_backend,
    "remote": _remote_backend,
}


class _ColumnBatch:
    """Columns-only stand-in for a concatenated SpanBatch: packing a
    coalesced group reads just the trace ids and start times, so only
    those columns are concatenated."""

    __slots__ = ("_batches", "_cols", "_n")

    def __init__(self, batches: list[SpanBatch]):
        self._batches = batches
        self._cols: dict[str, np.ndarray] = {}
        self._n = sum(len(b) for b in batches)

    def col(self, name: str) -> np.ndarray:
        arr = self._cols.get(name)
        if arr is None:
            arr = self._cols[name] = np.concatenate(
                [b.col(name) for b in self._batches])
        return arr

    def __len__(self) -> int:
        return self._n


@dataclass
class ScoreRequest:
    batch: SpanBatch
    features: Optional[SpanFeatures]
    # fused route: the frame's raw SpanColumns view when the caller
    # skipped host featurize. The pack stage scores columns on the card
    # when the whole group carries them and the backend has the fused
    # kernels; otherwise it featurizes the batch here (the host route).
    columns: Any = None
    done: threading.Event = field(default_factory=threading.Event)
    scores: Optional[np.ndarray] = None
    # admission deadline (monotonic ns): the pack stage sizes the
    # coalesced call so that its harvest lands inside it (adaptive
    # batching); None = coalescing up to max_batch_spans
    deadline_ns: Optional[int] = None
    # completion callback: invoked exactly once, on the thread that
    # completes the request (retire, a failed dispatch or harvest, the
    # shutdown drain), after ``scores`` is set and ``done`` fires.
    # Exceptions are counted as engine errors, never raised into the
    # worker.
    on_done: Optional[Callable[["ScoreRequest"], None]] = None

    def signal_done(self) -> None:
        """Fire the done event, then the completion callback (at most
        once: re-signalling a request already done is a no-op, so the
        failure paths may call it unconditionally)."""
        if self.done.is_set():
            return
        self.done.set()
        cb = self.on_done
        if cb is not None:
            try:
                cb(self)
            except Exception:  # noqa: BLE001 — must not kill the worker
                meter.add(ERRORS_METRIC)
                log.exception("on_done callback failed")


@dataclass
class _InflightGroup:
    """One dispatched-but-not-harvested device call."""

    reqs: list[ScoreRequest]
    handle: Any       # a _Handle (pipelined) or the call's scores (serial)
    t_pack0: int      # monotonic ns: pack stage start
    t_dispatch: int   # monotonic ns: device call enqueued
    n_spans: int
    # the backend that dispatched the call: under failover the worker
    # selects one per group, and a group dispatched on the primary before
    # a trip still harvests against the primary; ``probe`` echoes the
    # supervisor's select() flag
    backend: Any
    probe: bool = False
    # the call's (rows, L), snapshotted at dispatch (the backend's
    # last_shape describes the next call by the time this one retires)
    shape: Optional[list[int]] = None
    fused: bool = False


class _MeshLink:
    """The leader's broadcast of each call to the ranks of the engine's
    mesh, and the followers' receipt of it.

    One header (int64: the op, then a dtype code, rank and up to three
    dimensions for each array) and then each array, every one a broadcast
    from the mesh's first rank over a group of the mesh's ranks (the
    world's when the mesh spans it). On the card the tensors are the
    card's (NCCL); the CPU's on gloo. A follower reads the header on the
    host (a synchronisation it waits on anyway) and receives into new
    buffers."""

    SCORE, END, STOP = 1, 2, 3
    _MAX = 4  # arrays a call
    _CODES = (torch.int32, torch.float32, torch.bool)

    def __init__(self, mesh: Any, device: torch.device):
        import torch.distributed as dist

        self.dist = dist
        ranks = [int(r) for r in mesh.mesh.flatten().tolist()]
        self.leader = ranks[0]
        self.is_leader = dist.get_rank() == self.leader
        # every rank of the world takes part in making a group
        self.group = None if len(ranks) == dist.get_world_size() \
            else dist.new_group(ranks)
        self.device = device

    def _bcast(self, t: torch.Tensor) -> None:
        self.dist.broadcast(t, src=self.leader, group=self.group)

    def send(self, arrays: list, op: int = SCORE) -> list:
        """The leader: broadcast ``op`` and ``arrays`` (tensors on the
        link's device, or CPU tensors that are moved there); returns the
        tensors broadcast (the bools as sent)."""
        head = torch.zeros(2 + 5 * self._MAX, dtype=torch.int64)
        head[0], head[1] = op, len(arrays)
        out = []
        for i, a in enumerate(arrays):
            a = a.to(self.device).contiguous()
            head[2 + 5 * i] = self._CODES.index(a.dtype)
            head[3 + 5 * i] = a.dim()
            head[4 + 5 * i:4 + 5 * i + a.dim()] = torch.tensor(a.shape)
            out.append(a)
        self._bcast(head.to(self.device))
        for a in out:
            # bools travel as bytes: NCCL has no bool
            self._bcast(a.view(torch.uint8) if a.dtype == torch.bool else a)
        return out

    def recv(self) -> tuple[int, list]:
        """A follower: the next op and its arrays."""
        head = torch.zeros(2 + 5 * self._MAX, dtype=torch.int64,
                           device=self.device)
        self._bcast(head)
        head = head.cpu()
        out = []
        for i in range(int(head[1])):
            dtype = self._CODES[int(head[2 + 5 * i])]
            shape = [int(n) for n in
                     head[4 + 5 * i:4 + 5 * i + int(head[3 + 5 * i])]]
            a = torch.empty(shape, dtype=dtype, device=self.device)
            self._bcast(a.view(torch.uint8) if dtype == torch.bool else a)
            out.append(a)
        return int(head[0]), out


class ScoringEngine:
    """One engine per process.

    >>> eng = ScoringEngine(EngineConfig(device="cpu")).start()
    >>> scores = eng.score_sync(batch, timeout_s=0.5)  # None on timeout
    """

    # per-(model, geometry, mesh) learned adaptive-batching estimates,
    # shared across engines: a new engine on a mesh it has served starts
    # from the last learned cost. Only engines on a mesh read or write it
    # (the one-device path keeps its exact cold start).
    _ADAPT_PRIORS: dict[tuple, tuple] = {}

    def __init__(self, config: Optional[EngineConfig] = None):
        self.cfg = config or EngineConfig()
        # the engine owns THE mesh (one mesh, one owner): the backend
        # receives it; sequence models only
        self.mesh = None
        if self.cfg.mesh is not None and self.cfg.model in (
                "transformer", "autoencoder"):
            from ..parallel.mesh import make_mesh

            try:
                self.mesh = make_mesh(self.cfg.mesh_shape(),
                                      device=self.cfg.device)
            except ValueError:
                # a mesh the world cannot back: one device, LOUDLY
                meter.add(labeled_key(MESH_UNAVAILABLE_METRIC,
                                      model=self.cfg.model))
        self._link: Optional[_MeshLink] = None
        if self.mesh is not None:
            # every rank of the world makes the link's group first
            self._link = _MeshLink(self.mesh, resolve_device(self.cfg.device))
            if self.mesh.get_coordinate() is None:
                raise ValueError("this rank holds no coordinate of the "
                                 "engine's mesh")
        self.backend = _BACKENDS[self.cfg.model](self.cfg, mesh=self.mesh)
        if self._link is not None and self._link.is_leader:
            self.backend.link = self._link
        # a follower's loop: its thread, and the END ops it has seen
        self._follower: Optional[threading.Thread] = None
        self._ends = 0
        self._ends_cv = threading.Condition()
        # failover: the supervisor picks the backend per group; the
        # fallback is a CPU route, so it serves when the card does not
        self.failover: Optional[FailoverSupervisor] = None
        # the chaos hook: a message makes every PRIMARY dispatch raise
        self._device_fault: Optional[str] = None
        if self.cfg.failover is not None:
            if self.cfg.model == "remote":
                # the sidecar featurizes server-side (needs_features is
                # False), so submit never builds the features a local
                # fallback would score — and the sidecar carries its own
                # deadline discipline anyway
                raise ValueError(
                    "failover does not compose with the remote sidecar "
                    "backend")
            fo_cfg = FailoverConfig.from_spec(self.cfg.failover_spec())
            fb_cfg = EngineConfig(
                model=fo_cfg.fallback_model,
                max_batch_spans=self.cfg.max_batch_spans,
                max_len=self.cfg.max_len,
                trace_bucket=self.cfg.trace_bucket,
                online_update=self.cfg.online_update,
                featurizer=self.cfg.featurizer,
                seed=self.cfg.seed, device="cpu")
            self.failover = FailoverSupervisor(
                self.cfg.model, self.backend,
                _BACKENDS[fo_cfg.fallback_model](fb_cfg, mesh=None), fo_cfg)
        # only a backend with a non-blocking dispatch can overlap; the
        # others (zscore's ordered online update, mock, the remote
        # sidecar with its own deadline) run serially. A fallback group
        # takes the serial branch inside the primary's window.
        self._depth = max(1, self.cfg.pipeline_depth) \
            if _pipelined(self.backend) else 1
        self._queue: queue.Queue[ScoreRequest] = queue.Queue(
            self.cfg.max_queue)
        self._link_stopped = False
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # serializes backend access between the worker and warmup()
        self._backend_lock = threading.Lock()
        self.device_calls = 0
        self.errors = 0
        # bumped from caller threads (sidecar handlers): under a lock
        self._count_lock = threading.Lock()
        self.rejected = 0
        self.passthrough_spans = 0
        # fused route: calls and frames scored fused, and columns-carrying
        # frames that took the host route — by the closed reason set, or
        # in a group that mixed them with plain requests
        from .fused import FALLBACK_REASONS

        self.fused_calls = 0
        self.fused_frames = 0
        self.fused_fallback = dict.fromkeys(FALLBACK_REASONS, 0)
        self.fused_mixed_frames = 0
        self._stage_log: deque[dict[str, Any]] = deque(maxlen=512)
        # device occupancy: the union of [dispatch, harvest end]
        # intervals over the wall since the first dispatch
        self._busy_ns = 0
        self._busy_until = 0
        self._t_run0: Optional[int] = None
        # deadline-sized coalescing: the per-span cost is a ratio of
        # averages (EWMA of call ms over EWMA of call spans), since a call
        # carries a fixed cost and one small call must not read as a
        # catastrophic per-span cost; None until the first call retires
        # (no estimate, no adaptive cap)
        self._ewma_call_ms: Optional[float] = None
        self._ewma_call_spans: Optional[float] = None
        self._ewma_spans_per_row: Optional[float] = None
        self._ewma_harvest_ms = 0.0
        self._last_adaptive_cap: Optional[int] = None
        # keyed by the mesh the engine BUILT (a degraded one is "single")
        # and the model's geometry; an unhashable geometry opts out
        self._mesh_label = _mesh_label(self.cfg.mesh) \
            if self.mesh is not None else "single"
        try:
            self._adapt_key: Optional[tuple] = (
                self.cfg.model, self.cfg.model_config, self.cfg.mesh)
            hash(self._adapt_key)
        except TypeError:
            self._adapt_key = None
        if self.mesh is not None and self._adapt_key is not None:
            prior = ScoringEngine._ADAPT_PRIORS.get(self._adapt_key)
            if prior is not None:
                (self._ewma_call_ms, self._ewma_call_spans,
                 self._ewma_spans_per_row, self._ewma_harvest_ms) = prior
        if self.mesh is not None:
            self._adaptive_gauge_key = labeled_key(
                ADAPTIVE_CAP_GAUGE, model=self.cfg.model,
                mesh=self._mesh_label)
        else:
            self._adaptive_gauge_key = labeled_key(ADAPTIVE_CAP_GAUGE,
                                                   model=self.cfg.model)

    @property
    def is_follower(self) -> bool:
        """A rank of the engine's mesh other than its leader."""
        return self._link is not None and not self._link.is_leader

    def _backends(self) -> tuple:
        """The primary and, with a breaker, the fallback."""
        if self.failover is None:
            return (self.backend,)
        return (self.backend, self.failover.fallback)

    # ----------------------------------------------------------- lifecycle
    def start(self) -> "ScoringEngine":
        if self.is_follower:
            # the follower loop mirrors the leader's calls (its warm
            # rungs among them) until the leader's shutdown
            if self._follower is None or not self._follower.is_alive():
                self._follower = threading.Thread(
                    target=self._follow, name="scoring-engine-follower",
                    daemon=True)
                self._follower.start()
            return self
        if self._thread is None or not self._thread.is_alive():
            if self.cfg.warm_ladder:
                # blocking: the caller opted in; the fallback warms too,
                # or its first groups pay their first-call costs in the
                # middle of the fault the breaker exists for
                with self._backend_lock:
                    for backend in self._backends():
                        warm = getattr(backend, "warm", None)
                        if warm is not None:
                            warm()
            # per-run stop event: a worker that outlived a timed-out join
            # keeps ITS event set instead of being resurrected
            stop = threading.Event()
            self._stop = stop
            self._thread = threading.Thread(
                target=self._worker, args=(stop,),
                name="scoring-engine", daemon=True)
            self._thread.start()
        return self

    def _follow(self, until_end: bool = False) -> None:
        """A follower's loop: each SCORE op through the backend's sharded
        call, until a STOP (or, with ``until_end``, an END)."""
        if self.backend.device.type == "cuda":  # per thread: this rank's
            torch.cuda.set_device(self.backend.device)
        while True:
            try:
                op, arrays = self._link.recv()
            except Exception:
                self._count_error()
                log.exception("follower lost the leader's broadcast")
                return
            if op == _MeshLink.STOP:
                return
            if op == _MeshLink.END:
                with self._ends_cv:
                    self._ends += 1
                    self._ends_cv.notify_all()
                if until_end:
                    return
                continue
            try:
                self.backend.follow(arrays)
            except Exception:
                self._count_error()
                log.exception("follower call failed")

    def shutdown(self) -> None:
        if self.is_follower:
            # the loop ends at the leader's stop, however long the leader
            # serves (a lost leader fails the loop's collective at its
            # group's timeout); with no loop running, the stop (and any
            # call before it) is taken here
            if self._follower is not None:
                self._follower.join()
                self._follower = None
            elif not self._link_stopped:
                self._follow()
            self._link_stopped = True
            return
        self._stop.set()
        if self._thread is not None:
            # the worker drains queued + in-flight work losslessly first
            self._thread.join(timeout=30.0)
            self._thread = None
        if self._link is not None and not self._link_stopped:
            with self._backend_lock:
                self._link.send([], _MeshLink.STOP)
            self._link_stopped = True
        # fail-fast any request that raced past submit()'s stop check
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            req.scores = None
            req.signal_done()

    # ------------------------------------------------------------- scoring
    def submit(self, batch: SpanBatch,
               features: Optional[SpanFeatures] = None,
               deadline_ns: Optional[int] = None,
               on_done: Optional[Callable[[ScoreRequest], None]] = None,
               columns: Any = None) -> Optional[ScoreRequest]:
        """Enqueue for scoring; None when the queue is full or the engine
        is shutting down (admission control, never a stall; ``on_done``
        is then not called). ``deadline_ns`` (monotonic) sizes the
        coalesced call so that its harvest is expected inside it;
        ``on_done`` is called once when the request resolves. A request
        with ``columns`` (``fused.extract_columns(batch)[0]``) is not
        featurized here: its group scores on the fused route, or the pack
        stage featurizes it; the remote model featurizes in the sidecar.
        A follower rank of the mesh raises: requests go to the leader."""
        if self.is_follower:
            raise RuntimeError(
                f"rank {self._link.dist.get_rank()} follows the engine's "
                f"mesh: submit on its leader, rank {self._link.leader}")
        if self._stop.is_set():
            self._reject()
            return None
        if features is None and columns is None \
                and getattr(self.backend, "needs_features", True):
            features = featurize(batch, self.cfg.featurizer)
        req = ScoreRequest(batch=batch, features=features, columns=columns,
                           deadline_ns=deadline_ns, on_done=on_done)
        try:
            self._queue.put_nowait(req)
        except queue.Full:
            self._reject()
            return None
        return req

    def _reject(self) -> None:
        with self._count_lock:
            self.rejected += 1
        meter.add(QUEUE_FULL_METRIC)

    def score_sync(self, batch: SpanBatch,
                   features: Optional[SpanFeatures] = None,
                   timeout_s: float = 0.005) -> Optional[np.ndarray]:
        """Submit and wait up to the latency budget; None => pass through
        (a passed deadline counts as pass-through; a failed call counts
        as an engine error, as in the reference)."""
        req = self.submit(batch, features)
        if req is None:
            return None
        if req.done.wait(timeout_s):
            return req.scores
        with self._count_lock:
            self.passthrough_spans += len(batch)
        meter.add(PASSTHROUGH_METRIC, len(batch))
        return None

    def warmup(self, batch: SpanBatch) -> None:
        """Feed presumed-normal traffic to a streaming backend (its own
        ``warmup``), then score the batch synchronously so first-call costs
        are paid before real traffic — as the reference does, so a zscore
        engine with ``online_update`` folds the batch in twice. With a
        breaker the fallback is warmed the same way (the module
        docstring's departure). Runs under the backend lock: a worker
        scoring concurrent traffic must not interleave with the fit. On a
        follower rank it mirrors the leader's ``warmup`` (the follower
        loop, or here if none runs) up to the leader's END."""
        if self.is_follower:
            with self._ends_cv:
                seen = self._ends
            if self._follower is not None and self._follower.is_alive():
                with self._ends_cv:
                    self._ends_cv.wait_for(lambda: self._ends > seen)
            else:
                self._follow(until_end=True)
            return
        feats = featurize(batch, self.cfg.featurizer)
        with self._backend_lock:
            for backend in self._backends():
                w = getattr(backend, "warmup", None)
                if w is not None:
                    w(batch)
                backend.score(batch, feats)
            if self._link is not None:
                self._link.send([], _MeshLink.END)

    def count_fused_fallback(self, reason: str) -> None:
        """Count a frame its caller sent down the host route, by reason
        (one of ``fused.FALLBACK_REASONS``: the caller's gate consults
        ``fused_enabled()`` and ``extract_columns``)."""
        if reason not in self.fused_fallback:
            raise ValueError(f"unknown fused fallback reason {reason!r} "
                             f"(known: {list(self.fused_fallback)})")
        with self._count_lock:
            self.fused_fallback[reason] += 1

    # --------------------------------------------------------- chaos hooks
    def inject_device_fault(
            self, message: str = "injected device fault") -> None:
        """Every later PRIMARY-backend dispatch raises
        :class:`DeviceFaultInjected` until cleared: the deterministic
        device loss that the breaker and the sustained-failure tests
        drive. The fallback route is untouched."""
        self._device_fault = str(message)

    def clear_device_fault(self) -> None:
        """Lift the injected device fault (idempotent)."""
        self._device_fault = None

    def failover_status(self) -> Optional[dict[str, Any]]:
        """The breaker's state snapshot (None = no breaker configured)."""
        return self.failover.status() if self.failover is not None \
            else None

    def stats(self) -> dict[str, Any]:
        log_ = list(self._stage_log)

        def p50(key: str, fused: Optional[bool] = None) -> float:
            vals = [c[key] for c in log_
                    if fused is None or c["fused"] == fused]
            return float(np.percentile(vals, 50)) if vals else 0.0

        out = {
            "model": self.cfg.model,
            "quantized": self.cfg.quantized,
            "device": self.backend.device_label,
            "pipeline_depth": self._depth,
            "device_calls": self.device_calls,
            "errors": self.errors,
            "rejected": self.rejected,
            "passthrough_spans": self.passthrough_spans,
            # a serial backend's whole call, device wait included, is in
            # its pack stage
            "stage_pack_ms_p50": p50("pack_ms"),
            "stage_device_ms_p50": p50("device_ms"),
            COLD_METRIC: getattr(self.backend, "cold_spans", 0),
            "stage_ms_p50_by_route": {
                route: {"pack_ms": p50("pack_ms", fused),
                        "device_ms": p50("device_ms", fused)}
                for route, fused in (("host", False), ("fused", True))},
            "fused_calls": self.fused_calls,
            FUSED_FRAMES_METRIC: self.fused_frames,
            FUSED_FALLBACK_METRIC: dict(self.fused_fallback),
            "fused_mixed_group_frames": self.fused_mixed_frames,
            "adaptive": {
                "ms_per_span": self._ms_per_span(),
                "spans_per_row": self._ewma_spans_per_row,
                "harvest_ms": round(self._ewma_harvest_ms, 4),
                "last_cap_spans": self._last_adaptive_cap,
                "mesh": self._mesh_label,
            },
        }
        if self.mesh is not None:
            out["mesh"] = dict(self.cfg.mesh)
        ladder = getattr(self.backend, "ladder", None)
        if ladder is not None:
            out["bucket_ladder"] = ladder.stats()
        # the autoencoder's K11 kernel for the loaded weights
        route = getattr(getattr(self.backend, "model", None), "recon_route",
                        None)
        if route is not None:
            out["recon_route"] = route
        if self.failover is not None:
            out["failover"] = self.failover.status()
        return out

    # -------------------------------------------------------------- worker
    def _worker(self, stop: threading.Event) -> None:
        """Fill the in-flight window (pack + dispatch) ahead of
        harvesting, retire FIFO. With an empty queue the window drains at
        once; on stop the queue and the window drain losslessly."""
        if self._link is not None and self.backend.device.type == "cuda":
            # the current card is per thread: the leader's own
            torch.cuda.set_device(self.backend.device)
        inflight: deque[_InflightGroup] = deque()
        while True:
            stopping = stop.is_set()
            if stopping and not inflight and self._queue.empty():
                return
            # keep-serving backstop: _dispatch_group/_retire fail their own
            # requests; nothing else may kill this thread
            try:
                if len(inflight) < self._depth:
                    reqs = self._collect(block=not inflight and not stopping)
                    if reqs is not None:
                        grp = self._dispatch_group(reqs)
                        if grp is not None:
                            inflight.append(grp)
                        continue
                if inflight:
                    self._retire(inflight.popleft())
            except Exception:
                self._count_error()
                log.exception("scoring engine worker error")

    def _count_error(self) -> None:
        self.errors += 1
        meter.add(ERRORS_METRIC)

    def _collect(self, block: bool) -> Optional[list[ScoreRequest]]:
        """One request (blocking briefly only when the pipeline is idle)
        plus whatever else is already waiting, up to max_batch_spans — or,
        when the first request carries a deadline, up to the adaptive cap
        that lands its harvest inside it."""
        try:
            first = self._queue.get(timeout=0.05) if block \
                else self._queue.get_nowait()
        except queue.Empty:
            return None
        reqs = [first]
        total = len(first.batch)
        cap = self.cfg.max_batch_spans
        if first.deadline_ns is not None:
            cap = min(cap, self._adaptive_cap(first.deadline_ns))
            self._last_adaptive_cap = cap
            meter.set_gauge(self._adaptive_gauge_key, cap)
        while total < cap:
            try:
                nxt = self._queue.get_nowait()
            except queue.Empty:
                break
            reqs.append(nxt)
            total += len(nxt.batch)
        return reqs

    def _adaptive_cap(self, deadline_ns: int) -> int:
        """Span budget for one coalesced call such that its harvest is
        expected inside ``deadline_ns``: the remaining headroom over the
        observed cost a span, snapped DOWN onto the bucket ladder's row
        shapes (never up onto a new one). With no estimate yet the fixed
        cap applies."""
        per_span = self._ms_per_span()
        if per_span is None or per_span <= 0:
            return self.cfg.max_batch_spans
        headroom_ms = ((deadline_ns - time.monotonic_ns()) / 1e6
                       - self._ewma_harvest_ms)
        if headroom_ms <= 0:
            # already late: queue wait ate the deadline, so per-request
            # latency is lost either way — DRAIN mode (maximal coalescing)
            # clears the backlog at peak efficiency; shipping minimal calls
            # here would shrink batches exactly when load demands growth
            return self.cfg.max_batch_spans
        afford = int(headroom_ms / per_span)
        ladder = getattr(self.backend, "ladder", None)
        spans_per_row = self._ewma_spans_per_row
        if ladder is not None and spans_per_row and spans_per_row > 0:
            rows = afford / spans_per_row
            afford = int(ladder.floor_rows(rows) * spans_per_row)
        return max(1, min(afford, self.cfg.max_batch_spans))

    def _ms_per_span(self) -> Optional[float]:
        """Volume-weighted call cost a span (see __init__)."""
        if not self._ewma_call_ms or not self._ewma_call_spans:
            return None
        return self._ewma_call_ms / self._ewma_call_spans

    def _dispatch_group(self, reqs: list[ScoreRequest]
                        ) -> Optional[_InflightGroup]:
        t0 = time.monotonic_ns()
        if self._t_run0 is None:
            self._t_run0 = t0
        # the breaker picks the backend PER GROUP: the primary while
        # closed, the CPU fallback while tripped, one probe group per
        # interval while recovering
        if self.failover is not None:
            backend, probe = self.failover.select()
        else:
            backend, probe = self.backend, False
        n_spans = sum(len(r.batch) for r in reqs)
        carrying = sum(r.columns is not None for r in reqs)
        fused = False
        try:
            if self._device_fault is not None and backend is self.backend:
                # only the PRIMARY faults: the fallback must keep scoring
                # or there is nothing to fail over to
                raise DeviceFaultInjected(self._device_fault)
            # fused per group AND per selected backend: a trip to the CPU
            # fallback (no fused kernels) scores the same requests on the
            # host route below
            fused = bool(getattr(backend, "supports_fused", False)) \
                and carrying == len(reqs)
            if fused:
                with self._backend_lock:
                    handle = backend.dispatch_columns(
                        [r.columns for r in reqs])
                    shape = backend.last_shape
                with self._count_lock:
                    self.fused_calls += 1
                    self.fused_frames += len(reqs)
            else:
                handle, shape = self._dispatch_host(backend, reqs, carrying)
        except Exception as e:
            self._count_error()
            log.exception("scoring dispatch failed")
            if self.failover is not None:
                self.failover.observe(backend, ok=False, n_spans=n_spans,
                                      error=f"{type(e).__name__}: {e}",
                                      probe=probe)
            for r in reqs:
                r.scores = None
                r.signal_done()
            return None
        return _InflightGroup(reqs=reqs, handle=handle, t_pack0=t0,
                              t_dispatch=time.monotonic_ns(),
                              n_spans=n_spans, backend=backend, probe=probe,
                              shape=shape, fused=fused)

    def _dispatch_host(self, backend: Any, reqs: list[ScoreRequest],
                       carrying: int) -> tuple[Any, Optional[list[int]]]:
        """The host route of one group on ``backend``: the deferred
        featurize, the coalesced batch and features, and the call
        (dispatched, or scored at once by a serial backend). Returns the
        handle and the call's (rows, L) for a row-shaped backend."""
        if carrying:
            if getattr(backend, "needs_features", True):
                # columns-carrying requests on the host route: the host
                # featurize the submit skipped
                for r in reqs:
                    if r.features is None:
                        r.features = featurize(r.batch, self.cfg.featurizer)
            # a group on the failover fallback is no fused fallback
            if backend is self.backend:
                with self._count_lock:
                    if getattr(backend, "supports_fused", False):
                        self.fused_mixed_frames += carrying
                    else:
                        self.fused_fallback["backend"] += carrying
        if len(reqs) == 1:
            merged: Any = reqs[0].batch
            feats = reqs[0].features
        else:
            feats = None
            if all(r.features is not None for r in reqs):
                feats = SpanFeatures(
                    np.concatenate([r.features.categorical for r in reqs]),
                    np.concatenate([r.features.continuous for r in reqs]))
            if feats is not None and \
                    getattr(backend, "coalesce_columns", None) is not None:
                merged = _ColumnBatch([r.batch for r in reqs])
            else:  # the backend reads more than columns (mock: attrs;
                # remote: the whole batch goes over the socket)
                merged = concat_batches([r.batch for r in reqs])
        with self._backend_lock:
            if _pipelined(backend):
                handle = backend.dispatch(merged, feats)
            else:
                # depth 1: the whole call, here and in order; the handle
                # is the scores
                handle = backend.score(merged, feats)
            # rows of a laddered call (zscore's last_shape is a span
            # bucket, not rows), read under the lock: a concurrent
            # warmup() would overwrite it
            shape = backend.last_shape \
                if getattr(backend, "ladder", None) is not None else None
        return handle, shape

    def _retire(self, grp: _InflightGroup) -> None:
        """Harvest the oldest call against the backend that dispatched
        it, feed the breaker, the estimators and the meters, split the
        scores per request and wake them."""
        t_h0 = time.monotonic_ns()
        backend = grp.backend
        harvest = getattr(backend, "harvest", None)
        try:
            if harvest is not None:
                with self._backend_lock:
                    scores = harvest(grp.handle)
            else:
                scores = grp.handle
        except Exception as e:
            self._count_error()
            log.exception("scoring harvest failed")
            self.device_calls += 1
            if self.failover is not None:
                self.failover.observe(backend, ok=False,
                                      n_spans=grp.n_spans,
                                      error=f"{type(e).__name__}: {e}",
                                      probe=grp.probe)
            for r in grp.reqs:
                r.scores = None
                r.signal_done()
            return
        if self.failover is not None:
            self.failover.observe(backend, ok=True, n_spans=grp.n_spans,
                                  probe=grp.probe)
        # account the call before waking anyone: a woken caller may read
        # the counters
        t_end = time.monotonic_ns()
        pack_ms = (grp.t_dispatch - grp.t_pack0) / 1e6
        device_ms = (t_end - grp.t_dispatch) / 1e6
        harvest_ms = (t_end - t_h0) / 1e6
        self._update_estimators(grp, pack_ms + device_ms, harvest_ms)
        # the union of [dispatch, harvest end] intervals bounds the device
        # busy time from above (copies included); under depth > 1 they
        # overlap, so clip to the high-water mark
        self._busy_ns += t_end - max(grp.t_dispatch, self._busy_until)
        self._busy_until = t_end
        busy_frac = min(self._busy_ns / max(t_end - self._t_run0, 1), 1.0)
        self.device_calls += 1
        self._stage_log.append({"pack_ms": pack_ms, "device_ms": device_ms,
                                "fused": grp.fused})
        meter.add(SCORED_METRIC, grp.n_spans)
        meter.record(LATENCY_METRIC, (t_end - grp.t_pack0) / 1e6)
        meter.record(STAGE_PACK_METRIC, pack_ms)
        meter.record(STAGE_DEVICE_METRIC, device_ms)
        meter.record(STAGE_HARVEST_METRIC, harvest_ms)
        meter.set_gauge(DEVICE_BUSY_GAUGE, round(busy_frac, 4))
        try:
            off = 0
            for r in grp.reqs:
                n_r = len(r.batch)
                r.scores = scores[off:off + n_r]
                off += n_r
                r.signal_done()
        finally:
            # no request may hang on a half-failed split: the rest fire
            # with scores None (a no-op for those already signalled)
            for r in grp.reqs:
                r.signal_done()

    def _update_estimators(self, grp: _InflightGroup, call_ms: float,
                           harvest_ms: float) -> None:
        """The adaptive coalescer's EWMAs: the call's cost (pack +
        device, the wall the next group's deadline must absorb) and span
        volume as separate averages, spans a packed row (span budgets to
        ladder rows) and the harvest allowance."""
        a = _ADAPT_ALPHA
        if grp.n_spans > 0:
            self._ewma_call_ms = call_ms if self._ewma_call_ms is None \
                else (1 - a) * self._ewma_call_ms + a * call_ms
            self._ewma_call_spans = float(grp.n_spans) \
                if self._ewma_call_spans is None \
                else (1 - a) * self._ewma_call_spans + a * grp.n_spans
            if grp.shape and grp.shape[0] > 0:
                spr = grp.n_spans / grp.shape[0]
                self._ewma_spans_per_row = spr \
                    if self._ewma_spans_per_row is None \
                    else (1 - a) * self._ewma_spans_per_row + a * spr
        self._ewma_harvest_ms = (1 - a) * self._ewma_harvest_ms \
            + a * harvest_ms
        if self.mesh is not None and self._adapt_key is not None:
            # the next engine on this (model geometry, mesh) starts
            # informed; the worker is the only writer for its key
            ScoringEngine._ADAPT_PRIORS[self._adapt_key] = (
                self._ewma_call_ms, self._ewma_call_spans,
                self._ewma_spans_per_row, self._ewma_harvest_ms)


def _pipelined(backend: Any) -> bool:
    """Whether a backend dispatches without blocking (dispatch/harvest)."""
    return callable(getattr(backend, "dispatch", None))

"""Batched async scoring engine — the port's scoring stage on the GPU.

A trimmed port of ``odigos_tpu/serving/engine.py`` with four models: the
streaming z-score detector (``zscore``, the default, as in the JAX
package), the packed trace transformer (``transformer``), the span
autoencoder (``autoencoder``, one trace per row) and the deterministic test
model (``mock``), chosen from ``_BACKENDS``. The engine contract is kept:

* callers ``submit()`` batches into a **bounded** queue (``submit`` returns
  None when it is full or the engine is shutting down) and wait on a
  per-request event; ``score_sync`` returns None when its deadline passes,
  so the caller forwards the spans unscored;
* the worker's pack stage drains the queue and **coalesces** pending
  requests into one device call;
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

Not ported yet (later slices, listed in ROADMAP.md): the remote model,
failover, device meshes, adaptive deadline-sized
coalescing, the flow ledger, meters (the cold-span count
and the fused counters are kept in ``stats()`` under the reference's
metric names until then), the self-tracer and latency attribution.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Any, Optional, Union

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

log = logging.getLogger(__name__)

COLD_METRIC = "odigos_anomaly_cold_spans_total"
FUSED_FRAMES_METRIC = "odigos_fastpath_fused_frames_total"
FUSED_FALLBACK_METRIC = "odigos_fastpath_fused_fallback_total"
# models of the reference that later slices port
UNPORTED_MODELS = ("remote",)


@dataclass(frozen=True)
class EngineConfig:
    model: str = "zscore"        # zscore | transformer | autoencoder | mock
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
    seed: int = 0                # random weights when there is no bundle
    # depth 2 = double buffering: one call packing on the host while one
    # runs on the card (pipelined backends only; the others clamp to 1)
    pipeline_depth: int = 2
    bucket_ladder: int = 4       # geometric row buckets above trace_bucket
    warm_ladder: bool = False    # run every ladder rung at start()
    device: str = "cuda"         # "cpu" runs the kernels' plain versions

    def __post_init__(self) -> None:
        if self.quantized and self.model != "transformer":
            # as the reference: refuse rather than serve float quietly
            raise ValueError(
                f"quantized serving is only implemented for the "
                f"transformer model, not {self.model!r}")
        if self.model in UNPORTED_MODELS:
            raise ValueError(
                f"model {self.model!r} is not ported yet (ported: "
                f"{sorted(_BACKENDS)}; {', '.join(UNPORTED_MODELS)}: a "
                f"later slice)")
        if self.model not in _BACKENDS:
            raise ValueError(f"unknown scoring model {self.model!r} "
                             f"(known: {sorted(_BACKENDS)})")


class BucketLadder:
    """Geometric row-count buckets bounding the set of device shapes.

    ``round_rows`` maps a real packed row count to the smallest ladder
    bucket that holds it (base, 2·base, 4·base, ...); counts beyond the top
    bucket round up to a multiple of it. ``observe`` tracks which shapes
    have already run this process (LRU-bounded), feeding the hit rate;
    ``mark_warm`` pre-seeds it from ``warm()``. (The reference's mesh
    ``align`` and the adaptive coalescer's ``floor_rows`` come with those
    features.)
    """

    def __init__(self, base: int, n_buckets: int = 4):
        self.base = max(1, int(base))
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

    def stats(self) -> dict[str, Any]:
        total = self.hits + self.misses
        return {
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": round(self.hits / total, 4) if total else 0.0,
            "buckets": list(self.buckets),
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

    def __init__(self, cfg: EngineConfig):
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
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
        self.ladder = BucketLadder(cfg.trace_bucket, cfg.bucket_ladder)
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
        continuous, segments, positions)."""
        return self.model.score_packed(*arrays)

    @torch.inference_mode()
    def _device_call(self, *arrays: np.ndarray
                     ) -> tuple[torch.Tensor, Any, tuple]:
        """Enqueue the forward; returns (scores, event, keepalive)
        WITHOUT waiting on the card."""
        if self.device.type == "cpu":
            return self._forward(*arrays), None, ()
        host = tuple(torch.from_numpy(np.ascontiguousarray(a)).pin_memory()
                     for a in arrays)
        dev = [h.to(self.device, non_blocking=True) for h in host]
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

    def warm(self) -> None:
        """Run every ladder rung once on all-padding rows and wait: the
        kernels build and load, the CUDA context and cuBLAS handles come
        up, and the caching allocator holds each shape's buffers before
        the first request."""
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

    def __init__(self, cfg: EngineConfig):
        self.cfg = cfg
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

    def __init__(self, cfg: EngineConfig):
        self.cfg = cfg
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


def _fused_backend(cfg: EngineConfig):
    # FusedSequenceBackend IS a SequenceBackend: the host route stays as it
    # is and the subclass adds the columns → scores route. Imported here:
    # serving/fused.py imports this module.
    from .fused import FusedSequenceBackend

    return FusedSequenceBackend(cfg)


def _autoencoder_backend(cfg: EngineConfig):
    from .fused import AutoencoderBackend

    return AutoencoderBackend(cfg)


_BACKENDS = {
    "mock": MockBackend,
    "zscore": ZScoreBackend,
    "transformer": _fused_backend,
    "autoencoder": _autoencoder_backend,
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


@dataclass
class _InflightGroup:
    """One dispatched-but-not-harvested device call."""

    reqs: list[ScoreRequest]
    handle: Any       # a _Handle (pipelined) or the call's scores (serial)
    t_pack0: int      # monotonic ns: pack stage start
    t_dispatch: int   # monotonic ns: device call enqueued
    fused: bool = False


class ScoringEngine:
    """One engine per process.

    >>> eng = ScoringEngine(EngineConfig(device="cpu")).start()
    >>> scores = eng.score_sync(batch, timeout_s=0.5)  # None on timeout
    """

    def __init__(self, config: Optional[EngineConfig] = None):
        self.cfg = config or EngineConfig()
        self.backend = _BACKENDS[self.cfg.model](self.cfg)
        # only a backend with a non-blocking dispatch can overlap; the
        # others (zscore's ordered online update, mock) run serially
        self._pipelined = callable(getattr(self.backend, "dispatch", None))
        self._depth = max(1, self.cfg.pipeline_depth) \
            if self._pipelined else 1
        self._queue: queue.Queue[ScoreRequest] = queue.Queue(
            self.cfg.max_queue)
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

    # ----------------------------------------------------------- lifecycle
    def start(self) -> "ScoringEngine":
        if self._thread is None or not self._thread.is_alive():
            warm = getattr(self.backend, "warm", None)
            if self.cfg.warm_ladder and warm is not None:
                with self._backend_lock:
                    warm()  # blocking: the caller opted in
            # per-run stop event: a worker that outlived a timed-out join
            # keeps ITS event set instead of being resurrected
            stop = threading.Event()
            self._stop = stop
            self._thread = threading.Thread(
                target=self._worker, args=(stop,),
                name="scoring-engine", daemon=True)
            self._thread.start()
        return self

    def shutdown(self) -> None:
        self._stop.set()
        if self._thread is not None:
            # the worker drains queued + in-flight work losslessly first
            self._thread.join(timeout=30.0)
            self._thread = None
        # fail-fast any request that raced past submit()'s stop check
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            req.scores = None
            req.done.set()

    # ------------------------------------------------------------- scoring
    def submit(self, batch: SpanBatch,
               features: Optional[SpanFeatures] = None,
               columns: Any = None) -> Optional[ScoreRequest]:
        """Enqueue for scoring; None when the queue is full or the engine
        is shutting down (admission control, never a stall). A request
        with ``columns`` (``fused.extract_columns(batch)[0]``) is not
        featurized here: its group scores on the fused route, or the pack
        stage featurizes it."""
        if self._stop.is_set():
            with self._count_lock:
                self.rejected += 1
            return None
        if features is None and columns is None:
            features = featurize(batch, self.cfg.featurizer)
        req = ScoreRequest(batch=batch, features=features, columns=columns)
        try:
            self._queue.put_nowait(req)
        except queue.Full:
            with self._count_lock:
                self.rejected += 1
            return None
        return req

    def score_sync(self, batch: SpanBatch,
                   features: Optional[SpanFeatures] = None,
                   timeout_s: float = 0.005) -> Optional[np.ndarray]:
        """Submit and wait up to the latency budget; None => pass through."""
        req = self.submit(batch, features)
        if req is None:
            return None
        if req.done.wait(timeout_s):
            return req.scores
        with self._count_lock:
            self.passthrough_spans += len(batch)
        return None

    def warmup(self, batch: SpanBatch) -> None:
        """Feed presumed-normal traffic to a streaming backend (its own
        ``warmup``), then score the batch synchronously so first-call costs
        are paid before real traffic — as the reference does, so a zscore
        engine with ``online_update`` folds the batch in twice. Runs under
        the backend lock: a worker scoring concurrent traffic must not
        interleave with the fit."""
        with self._backend_lock:
            w = getattr(self.backend, "warmup", None)
            if w is not None:
                w(batch)
            self.backend.score(batch, featurize(batch, self.cfg.featurizer))

    def count_fused_fallback(self, reason: str) -> None:
        """Count a frame its caller sent down the host route, by reason
        (one of ``fused.FALLBACK_REASONS``: the caller's gate consults
        ``fused_enabled()`` and ``extract_columns``)."""
        if reason not in self.fused_fallback:
            raise ValueError(f"unknown fused fallback reason {reason!r} "
                             f"(known: {list(self.fused_fallback)})")
        with self._count_lock:
            self.fused_fallback[reason] += 1

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
        }
        ladder = getattr(self.backend, "ladder", None)
        if ladder is not None:
            out["bucket_ladder"] = ladder.stats()
        # the autoencoder's K11 kernel for the loaded weights
        route = getattr(getattr(self.backend, "model", None), "recon_route",
                        None)
        if route is not None:
            out["recon_route"] = route
        return out

    # -------------------------------------------------------------- worker
    def _worker(self, stop: threading.Event) -> None:
        """Fill the in-flight window (pack + dispatch) ahead of
        harvesting, retire FIFO. With an empty queue the window drains at
        once; on stop the queue and the window drain losslessly."""
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
                self.errors += 1
                log.exception("scoring engine worker error")

    def _collect(self, block: bool) -> Optional[list[ScoreRequest]]:
        """One request (blocking briefly only when the pipeline is idle)
        plus whatever else is already waiting, up to max_batch_spans."""
        try:
            first = self._queue.get(timeout=0.05) if block \
                else self._queue.get_nowait()
        except queue.Empty:
            return None
        reqs = [first]
        total = len(first.batch)
        while total < self.cfg.max_batch_spans:
            try:
                nxt = self._queue.get_nowait()
            except queue.Empty:
                break
            reqs.append(nxt)
            total += len(nxt.batch)
        return reqs

    def _dispatch_group(self, reqs: list[ScoreRequest]
                        ) -> Optional[_InflightGroup]:
        t0 = time.monotonic_ns()
        backend = self.backend
        carrying = sum(r.columns is not None for r in reqs)
        fused = bool(getattr(backend, "supports_fused", False)) \
            and carrying == len(reqs)
        try:
            if fused:
                with self._backend_lock:
                    handle = backend.dispatch_columns(
                        [r.columns for r in reqs])
                with self._count_lock:
                    self.fused_calls += 1
                    self.fused_frames += len(reqs)
                return _InflightGroup(reqs=reqs, handle=handle, t_pack0=t0,
                                      t_dispatch=time.monotonic_ns(),
                                      fused=True)
            if carrying:
                # columns-carrying requests on the host route: the host
                # featurize the submit skipped
                for r in reqs:
                    if r.features is None:
                        r.features = featurize(r.batch, self.cfg.featurizer)
                with self._count_lock:
                    if getattr(backend, "supports_fused", False):
                        self.fused_mixed_frames += carrying
                    else:
                        self.fused_fallback["backend"] += carrying
            if len(reqs) == 1:
                merged: Any = reqs[0].batch
                feats = reqs[0].features
            else:
                if getattr(backend, "coalesce_columns", None) is not None:
                    merged = _ColumnBatch([r.batch for r in reqs])
                else:  # the backend reads more than columns (mock: attrs)
                    merged = concat_batches([r.batch for r in reqs])
                feats = SpanFeatures(
                    np.concatenate([r.features.categorical for r in reqs]),
                    np.concatenate([r.features.continuous for r in reqs]))
            with self._backend_lock:
                if self._pipelined:
                    handle = backend.dispatch(merged, feats)
                else:
                    # depth 1: the whole call, here and in order; the
                    # handle is the scores
                    handle = backend.score(merged, feats)
        except Exception:
            self.errors += 1
            log.exception("scoring dispatch failed")
            for r in reqs:
                r.scores = None
                r.done.set()
            return None
        return _InflightGroup(reqs=reqs, handle=handle, t_pack0=t0,
                              t_dispatch=time.monotonic_ns())

    def _retire(self, grp: _InflightGroup) -> None:
        """Harvest the oldest call, split scores per request, wake them."""
        try:
            if self._pipelined:
                with self._backend_lock:
                    scores = self.backend.harvest(grp.handle)
            else:
                scores = grp.handle
        except Exception:
            self.errors += 1
            log.exception("scoring harvest failed")
            scores = None
        # count the call before waking anyone: a woken caller may read it
        t_end = time.monotonic_ns()
        self.device_calls += 1
        self._stage_log.append({
            "pack_ms": (grp.t_dispatch - grp.t_pack0) / 1e6,
            "device_ms": (t_end - grp.t_dispatch) / 1e6,
            "fused": grp.fused})
        off = 0
        for r in grp.reqs:
            n_r = len(r.batch)
            r.scores = None if scores is None else scores[off:off + n_r]
            off += n_r
            r.done.set()

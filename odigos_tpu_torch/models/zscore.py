"""Per-group latency z-score detector — the default scoring model, in PyTorch.

Counterpart of ``odigos_tpu/models/zscore.py``: it keeps the streaming
mean and variance of log-duration per (service, operation) group and scores
each span by ``|z|``. The state is three ``(G,)`` f32 tensors on the
detector's device — count, mean and M2 (G defaults to 8192: 96 KiB) — and
the group id is the reference's Knuth mix of (service id, name id) mod G.

* ``update_fn`` / ``update``: the weighted Welford merge of a batch into the
  state (K3, ``kernels/zscore.py``: per-group sums, then Chan's parallel
  merge);
* ``score_fn`` / ``score``: gather and normalise (K4), 0 for groups with
  fewer than ``min_count`` spans;
* ``score_staged``: the engine's call — a staged batch scored on the state
  before it (squashed, cold spans counted) and, asked to, folded into the
  state in place: K4 and K3 in one launch on the card.

``stage`` copies what the kernel reads of a batch's ``n`` real spans —
the (service, name) ids and the log-duration, 12 bytes a span — to the
device in one copy, with the zero the kernel adds the cold count into
(4 bytes a batch, in place of a fill launch); the kernel takes them with
implicit weights of 1, so nothing is padded. Batch sizes still round up to geometric buckets
(``span_bucket``, 2x, 4x, ...): each bucket has one set of pinned host
buffers (the staged inputs, and the scores and cold count copied back),
and ``warm`` makes them ahead of serving and runs the kernel once at each
with all-zero weights, which leaves the state as it was, bit for bit.

``device`` defaults to ``"cuda"`` and raises where CUDA is absent; pass
``"cpu"`` for the kernels' plain versions.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from ..features.featurizer import SpanFeatures
from ..kernels import zscore as kz
from ..utils.device import resolve_device


class ZScoreState(NamedTuple):
    count: torch.Tensor  # (G,) float32
    mean: torch.Tensor   # (G,) float32
    m2: torch.Tensor     # (G,) float32


def _group_ids(categorical: Any, n_groups: int) -> torch.Tensor:
    """(service, name) → group id, int32 as in the reference."""
    return kz.group_ids(torch.as_tensor(categorical), n_groups).to(
        torch.int32)


def state_from_numpy(state: Any, device: str | torch.device = "cuda"
                     ) -> ZScoreState:
    """A port state from any ``(count, mean, m2)`` of array-likes — a JAX
    ``ZScoreState`` read as numpy, say — so two detectors can start from
    the same state."""
    dev = resolve_device(device)
    count, mean, m2 = (torch.tensor(np.asarray(a, np.float32), device=dev)
                       for a in state)
    return ZScoreState(count, mean, m2)


@dataclass
class _Staging:
    """Pinned host buffers of one span bucket ``b``: ``inputs``,
    ``(3 b + 1,)`` int32 — a batch's ``(n, 2)`` ids, its ``n``
    log-durations' f32 bits and a 0 for the cold count, packed so one copy
    moves them — and ``out``, ``(b + 1,)`` f32 — the cold count's int32
    bits and the scores copied back; ``event`` marks the end of the last
    copy out of ``inputs`` (it is refilled only after it)."""

    inputs: torch.Tensor
    out: torch.Tensor
    event: Optional[torch.cuda.Event] = None


@dataclass
class Staged:
    """One batch on the detector's device: the ``(n, 2)`` int32 (service,
    name) ids and ``(n,)`` f32 log-durations of its ``n`` real spans, the
    span bucket whose buffers staged it, and on the card ``out``, ``(n +
    1,)`` f32 right after them: a zero word for the cold count, then room
    for the scores (used by one ``score_staged``)."""

    cat: torch.Tensor
    x: torch.Tensor
    n: int
    bucket: int
    out: Optional[torch.Tensor] = None


@dataclass
class ZScoreDetector:
    """Streaming z-score anomaly model.

    >>> det = ZScoreDetector(device="cpu")
    >>> det.update(features)           # fit on presumed-normal traffic
    >>> z = det.score(features)        # (n,) |z| per span
    """

    n_groups: int = 8192
    min_count: int = 32
    # span-axis bucket of the stateful update()/score() path: inputs pad up
    # to span_bucket, 2x, 4x, ... (0 = exact shapes)
    span_bucket: int = 4096
    device: Any = "cuda"
    _staging: dict = field(default_factory=dict, init=False, repr=False)
    # bytes ``stage`` has copied host → device (none on the CPU)
    staged_bytes: int = field(default=0, init=False)

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)
        # the kernel's sums, bit map and counters, zero between calls (its
        # launch leaves them so); the CPU path needs none
        self._scratch = (kz.new_scratch(self.n_groups, self.device)
                         if self.device.type == "cuda" else None)
        self.state = self.init()

    def init(self) -> ZScoreState:
        return ZScoreState(*(torch.zeros(self.n_groups, dtype=torch.float32,
                                         device=self.device)
                             for _ in range(3)))

    def _tensor(self, a: Any, dtype: torch.dtype) -> torch.Tensor:
        t = torch.as_tensor(a) if isinstance(a, np.ndarray) else a
        return t.to(device=self.device, dtype=dtype).contiguous()

    # -- functional kernels (used directly by the serving engine / tests)
    def update_fn(self, state: ZScoreState, categorical: Any,
                  log_dur: Any) -> ZScoreState:
        return ZScoreState(*kz.zscore_update(
            *state, self._tensor(categorical, torch.int32),
            self._tensor(log_dur, torch.float32), None, self.n_groups,
            scratch=self._scratch))

    def update_masked_fn(self, state: ZScoreState, categorical: Any,
                         log_dur: Any, weights: Any) -> ZScoreState:
        """The weighted merge: rows of weight 0 add nothing, so the merged
        state equals the one of the weighted rows alone."""
        return ZScoreState(*kz.zscore_update(
            *state, self._tensor(categorical, torch.int32),
            self._tensor(log_dur, torch.float32),
            self._tensor(weights, torch.float32), self.n_groups,
            scratch=self._scratch))

    def score_fn(self, state: ZScoreState, categorical: Any,
                 log_dur: Any) -> torch.Tensor:
        return kz.zscore_score(*state, self._tensor(categorical, torch.int32),
                               self._tensor(log_dur, torch.float32),
                               self.n_groups, self.min_count)

    def _bucket_rows(self, n: int) -> int:
        """Geometric span bucket ≥ n: O(log max_batch) buffer sets."""
        b = self.span_bucket
        while b < n:
            b <<= 1
        return b

    # -- staging: features → the kernel's inputs on the device
    def _buffers(self, b: int) -> _Staging:
        buf = self._staging.get(b)
        if buf is None:
            pin = self.device.type == "cuda"
            buf = _Staging(
                torch.empty(3 * b + 1, dtype=torch.int32, pin_memory=pin),
                torch.empty(b + 1, dtype=torch.float32, pin_memory=pin),
                torch.cuda.Event() if pin else None)
            self._staging[b] = buf
        return buf

    def stage(self, features: SpanFeatures) -> Staged:
        """Copy the (service, name) ids and log-durations of a batch's real
        spans to the device, with a 0 for the cold count: 12 bytes a span
        and 4 a batch, one copy. On the card the copy goes through the span
        bucket's pinned buffer and is not waited for."""
        cat = features.categorical
        n = len(cat)
        buf = None
        if self.span_bucket:
            b = self._bucket_rows(n)
            buf = self._buffers(b)
            if buf.event is not None:
                buf.event.synchronize()  # the last copy out of it is done
            host = buf.inputs
        else:
            b = n
            host = torch.empty(3 * n + 1, dtype=torch.int32)
        h = host.numpy()
        h[:2 * n].reshape(n, 2)[:] = cat[:, :2]
        h[2 * n:3 * n].view(np.float32)[:] = features.continuous[:, 0]
        h[3 * n] = 0  # the cold count's word
        out = None
        if self.device.type == "cpu":  # the tensors leave with the caller
            dev = host[:3 * n].clone()
        else:
            # the ids, durations and zero, then room for the scores
            dev = torch.empty(4 * n + 1, dtype=torch.int32,
                              device=self.device)
            dev[:3 * n + 1].copy_(host[:3 * n + 1],
                                  non_blocking=buf is not None)
            if buf is not None:
                buf.event.record()
            self.staged_bytes += 12 * n + 4
            out = dev[3 * n:].view(torch.float32)
        return Staged(dev[:2 * n].view(n, 2),
                      dev[2 * n:3 * n].view(torch.float32), n, b, out)

    def score_staged(self, st: Staged, update: bool = True,
                     weights: Optional[torch.Tensor] = None
                     ) -> tuple[np.ndarray, int]:
        """The squashed scores ``1 - exp(-z / 4)`` of a staged batch on the
        state before it, and its number of cold spans (``z == 0``); with
        ``update``, the batch folded into the state in place (weights of 1
        where none are given). One launch on the card, then one copy of the
        count and the scores into the bucket's pinned buffer and one
        wait."""
        r = kz.zscore_score_update(*self.state, st.cat, st.x, self.n_groups,
                                   self.min_count, weights=weights,
                                   update=update, scratch=self._scratch,
                                   inplace=True, out=st.out)
        st.out = None  # its cold word is spent: a second call makes one
        n = st.n
        buf = self._staging.get(st.bucket) if self.span_bucket else None
        if buf is None or buf.event is None:  # the CPU, or no buckets
            out = r.out.cpu()
        else:
            out = buf.out[:n + 1]
            out.copy_(r.out, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            done.synchronize()
        return out[1:].numpy().copy(), int(out[:1].view(torch.int32)[0])

    def warm(self, max_spans: int, cat_width: int) -> None:
        """Make every span bucket's staging buffers up to ``max_spans`` —
        and one bucket past it, since the engine's coalescer can end a
        group one request over its cap — and run the engine's launch
        (``score_staged``) once at each bucket with all-zero weights, so
        the first request pays no kernel load or allocation. The state is
        not touched: a zero-weight update merges nothing."""
        if not self.span_bucket:
            return
        b = self.span_bucket
        past = False
        while True:
            st = self.stage(SpanFeatures(
                np.zeros((b, cat_width), np.int32),
                np.zeros((b, 3), np.float32)))
            self.score_staged(st, weights=torch.zeros_like(st.x))
            if past:
                return
            past = b >= max_spans
            b <<= 1

    # -- stateful convenience over SpanFeatures
    def update_staged(self, st: Staged) -> None:
        if st.n:
            self.state = self.update_fn(self.state, st.cat, st.x)

    def update(self, features: SpanFeatures) -> None:
        if len(features):
            self.update_staged(self.stage(features))

    def score(self, features: SpanFeatures) -> np.ndarray:
        n = len(features)
        if n == 0:
            return np.zeros(0, np.float32)
        st = self.stage(features)
        return self.score_fn(self.state, st.cat, st.x).cpu().numpy()

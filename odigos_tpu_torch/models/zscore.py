"""Per-group latency z-score detector — the default scoring model, in PyTorch.

Counterpart of ``odigos_tpu/models/zscore.py``: it keeps the streaming
mean and variance of log-duration per (service, operation) group and scores
each span by ``|z|``. The state is three ``(G,)`` f32 tensors on the
detector's device — count, mean and M2 (G defaults to 8192: 96 KiB) — and
the group id is the reference's Knuth mix of (service id, name id) mod G.

* ``update_fn`` / ``update``: the weighted Welford merge of a batch into the
  state (kernel K3, ``kernels/zscore.py``: per-group sums, then Chan's
  parallel merge);
* ``score_fn`` / ``score``: gather and normalise (kernel K4), 0 for groups
  with fewer than ``min_count`` spans.

The stateful ``update`` / ``score`` pad the span axis to geometric buckets
(``span_bucket``, 2x, 4x, ...) with zero-weight rows, as the reference does.
The card has no recompile to bound, but the buckets bound the set of pinned
host staging buffers the detector keeps (one per bucket), and ``warm``
allocates them ahead of serving. A zero-weight row adds nothing to any sum,
so padding — and ``warm`` — leave the state as it was, bit for bit.

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
    """Pinned host buffers of one span bucket, and the event that marks the
    end of the last copy out of them (they are refilled only after it)."""

    cat: torch.Tensor
    x: torch.Tensor
    w: torch.Tensor
    event: Optional[torch.cuda.Event] = None


@dataclass
class Staged:
    """One batch on the detector's device: ``(b, C)`` ids, ``(b,)``
    log-durations and weights (1 on the ``n`` real rows, 0 on padding)."""

    cat: torch.Tensor
    x: torch.Tensor
    w: torch.Tensor
    n: int


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

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)
        # K3's (3, G) f64 sums, zero between calls (the kernel's last
        # launch zeroes them); the CPU path allocates its own
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
        x = self._tensor(log_dur, torch.float32)
        return self.update_masked_fn(state, categorical, x,
                                     torch.ones_like(x))

    def update_masked_fn(self, state: ZScoreState, categorical: Any,
                         log_dur: Any, weights: Any) -> ZScoreState:
        """The weighted merge behind span bucketing: rows of weight 0 add
        nothing, so the merged state equals the unpadded one."""
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
        """Geometric span bucket ≥ n: O(log max_batch) distinct shapes."""
        b = self.span_bucket
        while b < n:
            b <<= 1
        return b

    # -- staging: features → padded tensors on the device
    def _buffers(self, b: int, cat_width: int) -> _Staging:
        buf = self._staging.get((b, cat_width))
        if buf is None:
            pin = self.device.type == "cuda"
            buf = _Staging(
                torch.empty((b, cat_width), dtype=torch.int32,
                            pin_memory=pin),
                torch.empty(b, dtype=torch.float32, pin_memory=pin),
                torch.empty(b, dtype=torch.float32, pin_memory=pin),
                torch.cuda.Event() if pin else None)
            self._staging[(b, cat_width)] = buf
        return buf

    def stage(self, features: SpanFeatures) -> Staged:
        """Copy a batch to the device, padded to its span bucket with
        zero-weight rows (id 0, duration 0). On the card the copy goes
        through the bucket's pinned buffers and is not waited for."""
        cat = features.categorical
        n, C = cat.shape
        if not self.span_bucket:
            x = self._tensor(np.ascontiguousarray(features.continuous[:, 0]),
                             torch.float32)
            return Staged(self._tensor(np.ascontiguousarray(cat),
                                       torch.int32), x, torch.ones_like(x), n)
        b = self._bucket_rows(n)
        buf = self._buffers(b, C)
        if buf.event is not None:
            buf.event.synchronize()  # the last copy out of them is done
        hc, hx, hw = buf.cat.numpy(), buf.x.numpy(), buf.w.numpy()
        hc[:n] = cat
        hc[n:] = 0
        hx[:n] = features.continuous[:, 0]
        hx[n:] = 0.0
        hw[:n] = 1.0
        hw[n:] = 0.0
        if buf.event is None:  # CPU: the tensors leave with the caller
            return Staged(buf.cat.clone(), buf.x.clone(), buf.w.clone(), n)
        dev = [t.to(self.device, non_blocking=True)
               for t in (buf.cat, buf.x, buf.w)]
        buf.event.record()
        return Staged(*dev, n)

    def warm(self, max_spans: int, cat_width: int) -> None:
        """Make every span bucket's staging buffers up to ``max_spans`` —
        and one bucket past it, since the engine's coalescer can end a
        group one request over its cap — and run both kernels once at each
        bucket with all-zero weights, so the first request pays no kernel
        load or allocation. The state is not touched: the zero-weight
        update's result is discarded (and equals the state, bit for
        bit)."""
        if not self.span_bucket:
            return
        b = self.span_bucket
        past = False
        while True:
            st = self.stage(SpanFeatures(
                np.zeros((b, cat_width), np.int32),
                np.zeros((b, 3), np.float32)))
            self.update_masked_fn(self.state, st.cat, st.x,
                                  torch.zeros_like(st.w))
            self.score_fn(self.state, st.cat, st.x)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            if past:
                return
            past = b >= max_spans
            b <<= 1

    # -- stateful convenience over SpanFeatures
    def update_staged(self, st: Staged) -> None:
        if st.n:
            self.state = self.update_masked_fn(self.state, st.cat, st.x,
                                               st.w)

    def update(self, features: SpanFeatures) -> None:
        if len(features):
            self.update_staged(self.stage(features))

    def score(self, features: SpanFeatures) -> np.ndarray:
        n = len(features)
        if n == 0:
            return np.zeros(0, np.float32)
        st = self.stage(features)
        return self.score_fn(self.state, st.cat, st.x)[:n].cpu().numpy()

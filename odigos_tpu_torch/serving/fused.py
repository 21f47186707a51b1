"""The fused columns route: raw span columns in, span scores out, on the card.

The port's counterpart of ``odigos_tpu/serving/fused.py``, with the same
public names. A caller hands the engine a decoded frame's raw column views
(:class:`~odigos_tpu_torch.features.featurizer.SpanColumns`, from
:func:`extract_columns`), and :class:`FusedSequenceBackend` scores a
coalesced group of them with one non-blocking dispatch: the group's
columns are staged side by side into one pinned host buffer and copied to
the card in one copy, then hand-written kernels featurize (K5 gathers,
joins each span to its parent by a hash table on the card and
assembles), sort the spans by trace and start (K6), pack them next-fit
into ``(R, L)`` rows (K7), run the
transformer (K2, K1 and the dense chain) and apply the final LayerNorm,
span head and sigmoid at each real span, writing its score at its original
index (K8). The autoencoder's chain is the same up to the sort; then K13
packs one trace per row, the encoder runs (K2, K1), K12 pools, the decoder's
dense products run, and K11 scores each real span, squashes its error to
``1 - exp(-err)`` and writes it at its original index (the reference's
``_build_pack_spans`` + ``_build_forward_spans``). Only the ``(n,)`` scores
come back.

Route discipline, as in the reference:

* the host route (``dispatch``/``harvest``) is untouched and is what every
  group that does not fuse takes;
* :func:`fused_enabled` reads the ``ODIGOS_FUSED=0`` kill switch; callers
  consult it before extracting columns (the engine does not read it);
* :func:`extract_columns` is the fallback ladder: a frame the kernels do
  not cover comes back as ``(None, reason)``, with the reason drawn from
  the closed :data:`FALLBACK_REASONS`; the ladder routes on frame
  properties only and never catches an exception — a fused dispatch that
  raises fails its requests, as every dispatch does.

**The one deliberate departure: the row bound.** The reference sizes the
packed rows statically from the span bucket, ``R = round_rows(2 N / L +
2)`` with N the power-of-two bucket (the autoencoder: ``R = N``, one row
per possible trace). The port sizes them from the real span count the host
already knows, ``R = round_rows(2 n / L + 2)``: next-fit never leaves two
adjacent rows holding L spans or fewer together, so ``2 n / L + 2`` rows
hold any group of n spans, and no device sync is needed (the autoencoder:
``R = round_rows(n)``, since a trace holds at least one span; most of
those rows are padding, ~10 spans a trace on the otel mix, and sizing R by
the real trace count is later work). The scores are the same (the extra rows of the reference are all
padding, and attention never crosses rows); the shape set is still the
ladder's; the forward does up to ~2x less padding work at a bucket's low
end. ``tests/test_torch_fused.py`` holds the port's scores to the JAX
backend's, whose R is larger.

Other differences: u64 columns stay whole (int64 bit patterns read
unsigned) where the reference splits them into u32 halves to serve without
x64, so the duration is exact (the host's f64 arithmetic) instead of the
reference's f32 recomposition; the sampled device attribution is a later
slice.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from ..features.featurizer import (FeaturizerConfig, SpanColumns,
                                   SpanFeatures, _hash_table,
                                   assemble_sequences, batch_columns)
from ..kernels import featurize as kfeat
from ..kernels import pack as kpack
from ..kernels import sort as ksort
from ..models.autoencoder import AutoencoderConfig, SpanAutoencoder
from ..pdata.attrstore import AttrDictView
from .engine import EngineConfig, SequenceBackend, _Handle

# the closed set of reasons a frame takes the host route instead; callers
# count each fallback under exactly one of these (the reference's metric
# odigos_fastpath_fused_fallback_total{reason=...})
FALLBACK_REASONS = (
    "disabled",            # ODIGOS_FUSED=0 kill switch
    "backend",             # backend has no fused kernel (mock/zscore/mesh)
    "legacy_attrs",        # JSON attr frames (no AttrDictView store)
    "attr_slots",          # attr-slot features need the host attr matrix
    "zero_span",           # empty frame: nothing to score
    "misaligned_columns",  # non-contiguous / foreign-dtype u64 columns
)

# the u64 columns, staged as int64 bit patterns in this order; each must
# be a C-contiguous native uint64 array
_U64_COLUMNS = ("span_id", "parent_span_id", "trace_id_hi", "trace_id_lo",
                "start_unix_nano", "end_unix_nano")


def fused_enabled() -> bool:
    """Live kill switch: ``ODIGOS_FUSED=0`` disarms the fused route per
    frame, no restart."""
    return os.environ.get("ODIGOS_FUSED", "1") != "0"


def extract_columns(batch: Any, config: Optional[FeaturizerConfig] = None
                    ) -> tuple[Optional[SpanColumns], Optional[str]]:
    """The fallback ladder's gate: the frame's :class:`SpanColumns` view
    if the fused kernels cover it, else ``(None, reason)`` with the reason
    from :data:`FALLBACK_REASONS`. Zero-copy on success."""
    config = config or FeaturizerConfig()
    if len(batch) == 0:
        return None, "zero_span"
    if config.attr_slots:
        return None, "attr_slots"
    if not isinstance(batch.span_attrs, AttrDictView):
        return None, "legacy_attrs"
    for name in _U64_COLUMNS:
        col = batch.col(name)
        if col.dtype != np.uint64 or not col.flags.c_contiguous:
            return None, "misaligned_columns"
    return batch_columns(batch), None


def _span_bucket(n: int) -> int:
    """Geometric span-axis bucket: a power of two, at least 512."""
    b = 512
    while b < n:
        b <<= 1
    return b


def _table_bucket(n: int) -> int:
    """Hash-table axis bucket: a power of two, at least 1024."""
    b = 1024
    while b < n:
        b <<= 1
    return b


# value-keyed LRU of card-resident table pairs, which can also answer "how
# many device bytes do these tables pin?"
_TABLE_LRU = 32
_table_lock = threading.Lock()
_table_cache: OrderedDict = OrderedDict()


def _device_tables(strings: tuple[str, ...], service_vocab: int,
                   name_vocab: int, device: Any = "cuda"
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The hashed service/name tables of one interned string pool, padded
    to the table bucket and resident on ``device``. Memoized by value (wire
    senders re-ship the same pools): a steady sender set hashes and uploads
    each pool once."""
    device = torch.device(device)
    key = (strings, service_vocab, name_vocab, str(device))
    with _table_lock:
        hit = _table_cache.get(key)
        if hit is not None:
            _table_cache.move_to_end(key)
            return hit[0], hit[1]
    svc = _hash_table(strings, service_vocab)
    nam = _hash_table(strings, name_vocab)
    tb = _table_bucket(len(svc))
    pair = np.zeros((2, tb), np.int32)
    pair[0, :len(svc)] = svc
    pair[1, :len(nam)] = nam
    t = torch.from_numpy(pair).to(device)
    dsvc, dnam = t[0], t[1]
    with _table_lock:
        _table_cache[key] = (dsvc, dnam, int(t.numel() * t.element_size()))
        while len(_table_cache) > _TABLE_LRU:
            _table_cache.popitem(last=False)
    return dsvc, dnam


def device_table_bytes() -> int:
    """Device bytes currently pinned by the resident gather tables."""
    with _table_lock:
        return sum(entry[2] for entry in _table_cache.values())


@dataclass
class _Staged:
    """A group's columns on the device: views into one staged buffer."""

    host: torch.Tensor            # the staging buffer (pinned on the card)
    N: int                        # its span bucket: its key in the pool
    service_table: torch.Tensor
    name_table: torch.Tensor
    cols: dict[str, torch.Tensor]


@dataclass
class _FusedHandle:
    scores: torch.Tensor           # (n,) f32: pinned host on the card
    rows_used: torch.Tensor        # (1,) int32: rows filled (next-fit's
                                   # rows, or the real trace count)
    event: Optional[torch.cuda.Event]
    staged: _Staged                # kept alive until harvest
    n: int
    R: int


def _words(N: int, tb: int) -> int:
    """int64 words of a staging buffer: six u64 columns, three int32
    (service, name, frame), two int8 (kind, status), then two int32
    tables of ``tb`` entries (multi-frame groups)."""
    return 6 * N + 3 * N // 2 + N // 4 + tb


def _views(buf: torch.Tensor, N: int, tb: int) -> tuple:
    """(u64 (6, N) int64, i32 (3, N), i8 (2, N), tables (2, tb) int32)
    views of a staging buffer laid out as :func:`_words` says."""
    a, b, c = 6 * N, 6 * N + 3 * N // 2, 6 * N + 3 * N // 2 + N // 4
    return (buf[:a].view(6, N), buf[a:b].view(torch.int32).view(3, N),
            buf[b:c].view(torch.int8).view(2, N),
            buf[c:c + tb].view(torch.int32).view(2, tb))


class FusedSequenceBackend(SequenceBackend):
    """``SequenceBackend`` plus the fused columns → scores dispatch.

    ``dispatch_columns`` replaces the host featurize + pack with one staged
    copy and the kernels of the module docstring; ``dispatch``/``score``
    remain the host route that every fallback group takes. The handle
    holds the staging buffer until ``harvest``, which waits on the call's
    event, checks next-fit's row count against R and returns the scores,
    already in span order.
    """

    def __init__(self, cfg: EngineConfig, mesh: Any = None):
        super().__init__(cfg, mesh=mesh)
        # (span bucket, rows) shapes already run: bucket_hit, LRU-bounded
        self._fused_shapes: OrderedDict = OrderedDict()
        self.last_span_bucket: Optional[int] = None
        self.last_bucket_hit: Optional[bool] = None
        self.last_rows_real: Optional[int] = None
        # (R, rows filled) of the harvested fused calls
        self.fused_rows: deque = deque(maxlen=512)
        # pinned staging buffers by span bucket, each out of the pool from
        # its dispatch until its harvest (a copy from it may be in flight)
        self._free: dict[int, list[torch.Tensor]] = {}
        self._free_lock = threading.Lock()

    @property
    def supports_fused(self) -> bool:
        """Attr-slot features need the host attr matrix, and the mesh's
        plan keeps its own sharded call: no fused route for either (the
        reference's ``supports_fused``)."""
        return self._plan is None and self.cfg.featurizer.attr_slots == 0

    def rows_for(self, n_real: int) -> int:
        """The packed rows of a fused call: the next-fit bound
        ``2 n / L + 2`` on the real span count, rounded onto the ladder
        (the module docstring's departure from the reference)."""
        return self.ladder.round_rows(2 * n_real // self.max_len + 2)

    # --------------------------------------------------- fused dispatch
    @torch.inference_mode()
    def dispatch_columns(self, cols_list: list[SpanColumns]
                         ) -> _FusedHandle:
        """Pack stage of a fused group: stage, one copy, and every kernel
        enqueued without blocking. ``cols_list`` is the coalesced group in
        request order; the scores come back in the concatenated span
        order."""
        n_real = sum(len(c) for c in cols_list)
        N = _span_bucket(n_real)
        R = self.rows_for(n_real)
        L = self.max_len
        # a call that raises keeps its staging buffer out of the pool: a
        # copy from it may still be in flight
        staged = self._prep_columns(cols_list, N)
        self.last_shape = [R, L]
        key = (N, R)
        self.last_bucket_hit = key in self._fused_shapes
        self._fused_shapes[key] = True
        self._fused_shapes.move_to_end(key)
        if len(self._fused_shapes) > 16:
            self._fused_shapes.popitem(last=False)
        self.last_span_bucket = N
        scores, rows_used = self.fused_forward(staged, n_real, R)
        if self.device.type == "cpu":
            return _FusedHandle(scores[:n_real], rows_used, None, staged,
                                n_real, R)
        # sized by the span bucket, so the pinned allocator reuses a block
        host = torch.empty(N, dtype=torch.float32, pin_memory=True)[:n_real]
        host.copy_(scores[:n_real], non_blocking=True)
        rows_host = torch.empty(1, dtype=torch.int32, pin_memory=True)
        rows_host.copy_(rows_used, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return _FusedHandle(host, rows_host, event, staged, n_real, R)

    def fused_forward(self, staged: _Staged, n_real: int, R: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
        """The device half of a fused call on staged columns: K5
        (featurize), K6 (trace order), then :meth:`pack_forward`. Returns
        ``((N,) scores in span order, (1,) rows filled)``."""
        c = staged.cols
        cat, cont = kfeat.featurize_columns(
            staged.service_table, staged.name_table, c["service"],
            c["name"], c["kind"], c["status_code"], c["span_id"],
            c["parent_span_id"], c["start_unix_nano"], c["end_unix_nano"],
            c["frame"], n_real)
        perm = ksort.radix_sort(
            [c["trace_id_hi"], c["trace_id_lo"], c["start_unix_nano"]],
            n_real)
        return self.pack_forward(c, cat, cont, perm, n_real, R)

    def pack_forward(self, cols: dict, cat: torch.Tensor,
                     cont: torch.Tensor, perm: torch.Tensor, n_real: int,
                     R: int) -> tuple[torch.Tensor, torch.Tensor]:
        """K7 packs the sorted spans next-fit into R rows; the encoder and
        K8 score them. Returns the scores and next-fit's row count."""
        pk = kpack.next_fit_pack(perm, cols["trace_id_hi"],
                                 cols["trace_id_lo"], cat, cont, n_real,
                                 self.max_len, R)
        scores = self.model.score_packed_scatter(
            pk.categorical, pk.continuous, pk.segments, pk.positions, perm,
            pk.row_eff, pk.span_col, n_real, live=pk.rows_used)
        return scores, pk.rows_used

    def harvest(self, handle: Any) -> np.ndarray:
        if not isinstance(handle, _FusedHandle):
            return super().harvest(handle)
        if handle.event is not None:
            handle.event.synchronize()
            self._release(handle.staged.N, handle.staged.host)
        rows = int(handle.rows_used[0])
        if not 0 <= rows <= handle.R:
            raise RuntimeError(f"fused pack filled {rows} rows of "
                               f"{handle.R} for {handle.n} spans")
        self.last_rows_real = rows
        self.fused_rows.append((handle.R, rows))
        return handle.scores.numpy().copy()  # the pinned buffer goes back

    # ---------------------------------------------------- host staging
    def _acquire(self, N: int, nbytes: int) -> torch.Tensor:
        """A pinned byte buffer of at least ``nbytes`` for span bucket N."""
        with self._free_lock:
            free = self._free.get(N, [])
            for i, buf in enumerate(free):
                if buf.numel() >= nbytes:
                    return free.pop(i)
        return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)

    def _release(self, N: int, buf: torch.Tensor) -> None:
        with self._free_lock:
            self._free.setdefault(N, []).append(buf)

    def _prep_columns(self, cols_list: list[SpanColumns], N: int
                      ) -> _Staged:
        """Stage the group's columns side by side in one buffer (pinned on
        the card) and copy it to the device in one non-blocking copy.
        Padding rows are zero with frame -1. A one-frame group gathers
        through the card-resident tables of its string pool; a
        multi-frame group's per-frame tables ride in the buffer,
        concatenated, each frame's indices offset to its own."""
        fcfg = self.cfg.featurizer
        multi = len(cols_list) > 1
        if multi:
            host_tabs = [(_hash_table(c.strings, fcfg.service_vocab),
                          _hash_table(c.strings, fcfg.name_vocab))
                         for c in cols_list]
            tab_lens = [len(t[0]) for t in host_tabs]
            tb = _table_bucket(sum(tab_lens))
        else:
            tab_lens, tb = [0], 0
        words = _words(N, tb)
        if self.device.type == "cpu":
            raw = buf = torch.empty(words, dtype=torch.int64)
        else:
            raw = self._acquire(N, 8 * words)
            buf = raw[:8 * words].view(torch.int64)
        u64, i32, i8, tabs = (v.numpy() for v in _views(buf, N, tb))
        u64 = u64.view(np.uint64)
        off = tab_off = 0
        for fi, c in enumerate(cols_list):
            sl = slice(off, off + len(c))
            np.add(c.service, np.int32(tab_off), out=i32[0, sl])
            np.add(c.name, np.int32(tab_off), out=i32[1, sl])
            i32[2, sl] = fi
            i8[0, sl] = c.kind
            i8[1, sl] = c.status_code
            for row, name in enumerate(_U64_COLUMNS):
                u64[row, sl] = getattr(c, name)
            off += len(c)
            tab_off += tab_lens[fi] if multi else 0
        u64[:, off:] = 0
        i32[:2, off:] = 0
        i32[2, off:] = -1  # padding marker
        i8[:, off:] = 0
        if multi:
            o = 0
            for (st, nt), k in zip(host_tabs, tab_lens):
                tabs[0, o:o + k] = st
                tabs[1, o:o + k] = nt
                o += k
            tabs[:, o:] = 0
        dev = buf if self.device.type == "cpu" else buf.to(
            self.device, non_blocking=True)
        d64, d32, d8, dtab = _views(dev, N, tb)
        if multi:
            svc_tab, nam_tab = dtab[0], dtab[1]
        else:
            svc_tab, nam_tab = _device_tables(
                cols_list[0].strings, fcfg.service_vocab, fcfg.name_vocab,
                self.device)
        cols = {name: d64[row] for row, name in enumerate(_U64_COLUMNS)}
        cols.update(service=d32[0], name=d32[1], frame=d32[2], kind=d8[0],
                    status_code=d8[1])
        return _Staged(raw, N, svc_tab, nam_tab, cols)

    # ------------------------------------------------------------ warm
    def warm(self) -> None:
        """The host route's rungs, then one fused call for each span
        bucket up to the coalescing cap's, on synthetic columns (traces of
        10 spans), waited for: every fused kernel builds and loads, and
        the allocator holds each bucket's buffers before the first
        request."""
        super().warm()
        if not self.supports_fused:
            return
        top = _span_bucket(self.cfg.max_batch_spans)
        N = 512
        while N <= top:
            self.harvest(self.dispatch_columns([_warm_columns(N)]))
            N <<= 1


def _warm_columns(n: int) -> SpanColumns:
    i = np.arange(n, dtype=np.uint64)
    zeros32 = np.zeros(n, np.int32)
    zeros8 = np.zeros(n, np.int8)
    return SpanColumns(
        strings=(), service=zeros32, name=zeros32, kind=zeros8,
        status_code=zeros8, span_id=i + np.uint64(1),
        parent_span_id=np.where(i % 10 == 0, 0, i).astype(np.uint64),
        trace_id_hi=np.zeros(n, np.uint64),
        trace_id_lo=i // np.uint64(10) + np.uint64(1),
        start_unix_nano=i * np.uint64(1000),
        end_unix_nano=i * np.uint64(1000) + np.uint64(500))


class AutoencoderBackend(FusedSequenceBackend):
    """The span autoencoder (``models/autoencoder.py``) on both routes,
    one trace per row.

    The host route is the reference's ``"seq"`` branch: ``dispatch``
    assembles the traces (``assemble_sequences``, rows padded onto the
    ladder) and enqueues ``span_errors``; ``harvest`` squashes each error
    to ``1 - exp(-err)`` on the host and scatters it to span order. The
    fused route is the transformer's up to the sort; then K13 packs one
    trace per row and the model scores, K11 squashing each error and
    writing it at the span's original index. ``quantized`` is refused by
    ``EngineConfig``, as in the reference. Under the engine's mesh the
    host route scores through the plan's ``score_spans`` on ``{"data": dp,
    "model": tp}`` (``parallel.sharding``); the fused route falls back
    there, as the transformer's does.
    """

    config_cls = AutoencoderConfig

    def _model_cls(self) -> type:
        return SpanAutoencoder

    def _forward(self, *arrays: Any) -> torch.Tensor:
        """The ``(R, L)`` reconstruction errors over (categorical,
        continuous, mask); under a mesh, the plan's sharded call."""
        if self._plan is not None:
            return self._plan.score_spans(self.variables, *arrays)[0]
        return self.model.span_errors(*arrays)

    def dispatch(self, batch: Any, features: SpanFeatures) -> _Handle:
        seqs = assemble_sequences(batch, features, max_len=self.max_len,
                                  pad_traces_to=self.ladder.round_rows)
        self.last_shape = list(seqs.mask.shape)
        self.ladder.observe(seqs.n_traces)
        scores, event, keep = self._device_call(
            seqs.categorical, seqs.continuous, seqs.mask)
        return _Handle(scores, event, keep, seqs.span_index, seqs.mask,
                       len(batch))

    def _span_scores(self, scores: np.ndarray) -> np.ndarray:
        # the reconstruction error is unbounded: squash it to (0, 1) so
        # the processor's threshold contract holds, as the reference's
        # harvest does
        return 1.0 - np.exp(-scores)

    def _padding_rows(self, R: int) -> tuple[np.ndarray, ...]:
        """``R`` all-padding rows: categorical, continuous, mask."""
        cat, cont = super()._padding_rows(R)[:2]
        return cat, cont, np.zeros(cat.shape[:2], bool)

    def rows_for(self, n_real: int) -> int:
        """One row per trace: a trace holds at least one span, so ``n``
        rows always suffice (the module docstring's departure)."""
        return self.ladder.round_rows(n_real)

    def pack_forward(self, cols: dict, cat: torch.Tensor,
                     cont: torch.Tensor, perm: torch.Tensor, n_real: int,
                     R: int) -> tuple[torch.Tensor, torch.Tensor]:
        """K13 packs one trace per row; the model (K2, K1, K12, the dense
        decoder, K11) scores and scatters. Returns the scores and the real
        trace count."""
        tr = kpack.trace_rows_pack(perm, cols["trace_id_hi"],
                                   cols["trace_id_lo"], cat, cont, n_real,
                                   self.max_len, R)
        scores = self.model.score_spans_scatter(
            tr.categorical, tr.continuous, tr.mask, tr.span_map,
            perm.shape[0], live=tr.rows_used)
        return scores, tr.rows_used

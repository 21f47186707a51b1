"""K7: next-fit packing of trace-sorted spans into ``(R, L)`` rows; K13:
one trace per row.

``next_fit_pack(perm, trace_id_hi, trace_id_lo, categorical, continuous,
n, max_len, rows)`` is ``_sorted_trace_layout`` + ``_build_pack_packed`` of
``odigos_tpu/serving/fused.py`` after the sort: ``perm`` orders the first
``n`` of ``N`` rows by ``(trace_id_hi, trace_id_lo, start)`` (K6, identity
past ``n``); each trace is cut into chunks of ``max_len`` (segments), and
segments fill rows next-fit, exactly as the host packer ``pack_arrays``
does (``bisect_right`` over the cumulative segment lengths). It returns a
:class:`PackedColumns`: the ``(R, L, ·)`` row tensors the forward reads,
and for each sorted index ``j`` its row (``row_eff``, ``R`` for padding or
a dropped span) and column (``span_col``), which the span head (K8) reads
with ``perm`` to write each score at its span's original index.
``rows_used`` is the number of rows next-fit filled (a one-element int32
tensor; -1 marks a broken layout on the card), which a caller compares with
``R`` without a sync on the dispatch path.

A CUDA tensor launches ``csrc/trace_pack.cu`` (three launches: layout,
walk, scatter) or raises; a CPU tensor takes :func:`next_fit_pack_plain`.
The walk finds the row starts by chunks of spans (:func:`walk_plan`), not
one row at a time, and takes ``max_len`` up to ``MAX_WALK_LEN`` on the
card. ``launches`` counts the calls that launched, ``device_launches`` the
kernels.

K13, ``trace_rows_pack(perm, trace_id_hi, trace_id_lo, categorical,
continuous, n, max_len, rows)``, packs the same sorted spans one trace per
row, for the autoencoder: ``_build_pack_spans`` of
``odigos_tpu/serving/fused.py`` (:462-488). Row = the trace's ordinal in
``perm``'s order, column = the span's position in its trace; spans at
column >= ``max_len`` and traces at row >= ``rows`` are dropped, as the
host's ``assemble_sequences`` and the reference's scatter with
``mode="drop"`` drop them. It returns a :class:`TraceRows`: the ``(R, L,
·)`` tensors the model reads, the ``(R, L)`` mask, each slot's original
span index (``span_map``, -1 at padding; K11 writes the span's score
there) and ``rows_used``, the real trace count (one int32 on the device,
no sync). The kernel is two launches in ``csrc/trace_pack.cu``: a layout
marking trace starts and counting them a block, and a scatter (by
programmatic dependent launch) in which each block takes its prefix of
those counts, writes the slots of its layout block's spans (a thread a
span, its row and column from the mask), the rest of those rows as zeros
(a warp a row, 16-byte stores) and its share of the zero rows past the
trace count; the plain version is :func:`trace_rows_pack_plain`.
``rows_launches`` counts its calls that launched, ``rows_device_launches``
its kernels.
"""

from __future__ import annotations

import ctypes
import math
import threading
from bisect import bisect_right
from typing import NamedTuple

import torch

from . import build

# the walk's table of (chunk, candidate) slots (csrc/trace_pack.cu
# kWalkSlots), and the longest max_len it takes
WALK_SLOTS = 8192
MAX_WALK_LEN = 1024
# K13's layout block (csrc/trace_pack.cu kThreads): sorted spans a block,
# one trace-start count and 8 mask words each
ROWS_BLOCK = 256

launches = 0
device_launches = 0
rows_launches = 0
rows_device_launches = 0
_count_lock = threading.Lock()
_fn = None
_rows_fn = None


class PackedColumns(NamedTuple):
    categorical: torch.Tensor   # (R, L, C) int32
    continuous: torch.Tensor    # (R, L, D) float32
    segments: torch.Tensor      # (R, L) int32, 1-based slot, 0 = padding
    positions: torch.Tensor     # (R, L) int32, position in the chunk
    row_eff: torch.Tensor       # (N,) int32 by sorted index; R = none
    span_col: torch.Tensor      # (N,) int32 by sorted index
    rows_used: torch.Tensor     # (1,) int32


class TraceRows(NamedTuple):
    categorical: torch.Tensor   # (R, L, C) int32
    continuous: torch.Tensor    # (R, L, D) float32
    mask: torch.Tensor          # (R, L) bool
    span_map: torch.Tensor      # (R, L) int32 original span, -1 = padding
    rows_used: torch.Tensor     # (1,) int32, the real trace count


def next_fit_pack_plain(perm: torch.Tensor, trace_id_hi: torch.Tensor,
                        trace_id_lo: torch.Tensor, categorical: torch.Tensor,
                        continuous: torch.Tensor, n: int, max_len: int,
                        rows: int) -> PackedColumns:
    """The plain version: the host packer's arithmetic on tensors, its
    per-row ``bisect_right`` walk in Python."""
    N = perm.shape[0]
    L, R = int(max_len), int(rows)
    C, D = categorical.shape[1], continuous.shape[1]
    dev = perm.device
    catp = torch.zeros((R, L, C), dtype=torch.int32, device=dev)
    contp = torch.zeros((R, L, D), dtype=torch.float32, device=dev)
    segs = torch.zeros((R, L), dtype=torch.int32, device=dev)
    poss = torch.zeros((R, L), dtype=torch.int32, device=dev)
    row_eff = torch.full((N,), R, dtype=torch.int32, device=dev)
    span_col = torch.zeros(N, dtype=torch.int32, device=dev)
    if n == 0:
        return PackedColumns(catp, contp, segs, poss, row_eff, span_col,
                             torch.zeros(1, dtype=torch.int32, device=dev))
    p = perm[:n].long()
    hi, lo = trace_id_hi[p], trace_id_lo[p]
    new_trace = torch.ones(n, dtype=torch.bool, device=dev)
    new_trace[1:] = (hi[1:] != hi[:-1]) | (lo[1:] != lo[:-1])
    idx = torch.arange(n, device=dev)
    first = torch.cummax(torch.where(new_trace, idx, 0), 0).values
    pic = (idx - first) % L
    seg_start = pic == 0
    bounds = torch.nonzero(seg_start).flatten().tolist() + [n]
    starts: list[int] = []
    pos = 0
    while pos < n:
        starts.append(pos)
        if pos + L >= n:
            break
        pos = bounds[bisect_right(bounds, pos + L) - 1]
    rs = torch.tensor(starts, dtype=torch.int64, device=dev)
    row = torch.searchsorted(rs, idx, right=True) - 1
    col = idx - rs[row]
    n_starts = torch.cumsum(seg_start.long(), 0)
    slot = n_starts - n_starts[rs[row]] + 1
    keep = row < R
    r_k, c_k = row[keep], col[keep]
    catp[r_k, c_k] = categorical[p[keep]]
    contp[r_k, c_k] = continuous[p[keep]]
    segs[r_k, c_k] = slot[keep].to(torch.int32)
    poss[r_k, c_k] = pic[keep].to(torch.int32)
    row_eff[:n] = torch.where(keep, row, R).to(torch.int32)
    span_col[:n] = torch.where(keep, col, 0).to(torch.int32)
    return PackedColumns(catp, contp, segs, poss, row_eff, span_col,
                         torch.tensor([len(starts)], dtype=torch.int32,
                                      device=dev))


def walk_plan(n: int, max_len: int) -> tuple[int, int]:
    """K7's walk geometry for ``n`` sorted spans: ``(chunks, W)``, chunks
    of ``W`` spans covering ``[0, n)``, none empty, ``W >= max_len`` when
    there are several. The first row start at or after a chunk's first
    span lies within ``max_len`` spans of it (the chunk's candidates), and
    the walk keeps ``max_len`` candidates a chunk in shared memory (at
    most ``WALK_SLOTS``). ~sqrt(n / 8) chunks balance the walks inside the
    chunks (~W / row steps, in parallel) against the one thread that
    composes them (a step a chunk)."""
    if n <= 0:
        return 0, 1
    chunks = max(1, min(math.isqrt(n // 8), n // max_len,
                        WALK_SLOTS // max_len))
    W = -(-n // chunks)
    return -(-n // W), W


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("trace_pack").next_fit_pack_launch
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
                       + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p] * 10
                       + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(perm, trace_id_hi, trace_id_lo, categorical, continuous, n,
           max_len, rows) -> None:
    N = perm.shape[0]
    for name, t, dt in (("perm", perm, torch.int32),
                        ("trace_id_hi", trace_id_hi, torch.int64),
                        ("trace_id_lo", trace_id_lo, torch.int64)):
        if t.shape != (N,) or t.dtype != dt:
            raise ValueError(f"{name} must be ({N},) {dt}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if (categorical.dim() != 2 or categorical.shape[0] != N
            or categorical.dtype != torch.int32):
        raise ValueError(f"categorical must be ({N}, C) int32")
    if (continuous.dim() != 2 or continuous.shape[0] != N
            or continuous.dtype != torch.float32):
        raise ValueError(f"continuous must be ({N}, D) float32")
    if not 0 <= n <= N or max_len < 1 or rows < 0:
        raise ValueError(f"need 0 <= n <= {N}, max_len >= 1, rows >= 0; "
                         f"got {n}, {max_len}, {rows}")
    devs = {t.device for t in (perm, trace_id_hi, trace_id_lo, categorical,
                               continuous)}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")


def next_fit_pack(perm: torch.Tensor, trace_id_hi: torch.Tensor,
                  trace_id_lo: torch.Tensor, categorical: torch.Tensor,
                  continuous: torch.Tensor, n: int, max_len: int,
                  rows: int) -> PackedColumns:
    """The packed rows of the group; see the module docstring. Nothing is
    synchronised."""
    global launches, device_launches
    n, max_len, rows = int(n), int(max_len), int(rows)
    _check(perm, trace_id_hi, trace_id_lo, categorical, continuous, n,
           max_len, rows)
    dev = perm.device
    if dev.type == "cpu":
        return next_fit_pack_plain(perm, trace_id_hi, trace_id_lo,
                                   categorical, continuous, n, max_len, rows)
    if dev.type != "cuda":
        raise ValueError(f"next_fit_pack runs on cuda or cpu, not {dev}")
    ins = (perm, trace_id_hi, trace_id_lo, categorical, continuous)
    if not all(t.is_contiguous() for t in ins):
        raise ValueError("next_fit_pack needs contiguous inputs")
    if max_len > MAX_WALK_LEN:
        raise ValueError(f"next_fit_pack on the card takes max_len <= "
                         f"{MAX_WALK_LEN}, not {max_len}")
    N = perm.shape[0]
    C, D = categorical.shape[1], continuous.shape[1]
    L, R = max_len, rows
    out = PackedColumns(
        torch.empty((R, L, C), dtype=torch.int32, device=dev),
        torch.empty((R, L, D), dtype=torch.float32, device=dev),
        torch.empty((R, L), dtype=torch.int32, device=dev),
        torch.empty((R, L), dtype=torch.int32, device=dev),
        torch.empty(N, dtype=torch.int32, device=dev),
        torch.empty(N, dtype=torch.int32, device=dev),
        torch.empty(1, dtype=torch.int32, device=dev))
    words = -(-N // 32)
    scratch = torch.empty(words + N + R + 1, dtype=torch.int32, device=dev)
    base = scratch.data_ptr()
    count = ctypes.c_int(0)
    chunks, W = walk_plan(n, L)
    fn = _kernel()
    with torch.cuda.device(dev):
        rc = fn(perm.data_ptr(), trace_id_hi.data_ptr(),
                trace_id_lo.data_ptr(), categorical.data_ptr(),
                continuous.data_ptr(), C, D, n, N, L, R, chunks, W, base,
                base + 4 * words, base + 4 * (words + N),
                out.rows_used.data_ptr(), out.categorical.data_ptr(),
                out.continuous.data_ptr(), out.segments.data_ptr(),
                out.positions.data_ptr(), out.row_eff.data_ptr(),
                out.span_col.data_ptr(), ctypes.byref(count),
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"next_fit_pack launch failed: CUDA error {rc}")
    with _count_lock:
        launches += 1
        device_launches += count.value
    return out


def trace_rows_pack_plain(perm: torch.Tensor, trace_id_hi: torch.Tensor,
                          trace_id_lo: torch.Tensor,
                          categorical: torch.Tensor,
                          continuous: torch.Tensor, n: int, max_len: int,
                          rows: int) -> TraceRows:
    """The plain version: new-trace flags, their cumulative count as the
    row, the cummax of trace starts for the column, one scatter."""
    L, R = int(max_len), int(rows)
    C, D = categorical.shape[1], continuous.shape[1]
    dev = perm.device
    catp = torch.zeros((R, L, C), dtype=torch.int32, device=dev)
    contp = torch.zeros((R, L, D), dtype=torch.float32, device=dev)
    maskp = torch.zeros((R, L), dtype=torch.bool, device=dev)
    span_map = torch.full((R, L), -1, dtype=torch.int32, device=dev)
    if n == 0:
        return TraceRows(catp, contp, maskp, span_map,
                         torch.zeros(1, dtype=torch.int32, device=dev))
    p = perm[:n].long()
    hi, lo = trace_id_hi[p], trace_id_lo[p]
    new_trace = torch.ones(n, dtype=torch.bool, device=dev)
    new_trace[1:] = (hi[1:] != hi[:-1]) | (lo[1:] != lo[:-1])
    row = torch.cumsum(new_trace.long(), 0) - 1
    idx = torch.arange(n, device=dev)
    col = idx - torch.cummax(torch.where(new_trace, idx, 0), 0).values
    keep = (row < R) & (col < L)
    r_k, c_k, p_k = row[keep], col[keep], p[keep]
    catp[r_k, c_k] = categorical[p_k]
    contp[r_k, c_k] = continuous[p_k]
    maskp[r_k, c_k] = True
    span_map[r_k, c_k] = p_k.to(torch.int32)
    return TraceRows(catp, contp, maskp, span_map,
                     new_trace.sum().to(torch.int32).reshape(1))


def _rows_kernel():
    global _rows_fn
    if _rows_fn is None:
        fn = build.load("trace_pack").trace_rows_pack_launch
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
                       + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 2
                       + [ctypes.c_void_p] * 7
                       + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _rows_fn = fn
    return _rows_fn


def trace_rows_pack(perm: torch.Tensor, trace_id_hi: torch.Tensor,
                    trace_id_lo: torch.Tensor, categorical: torch.Tensor,
                    continuous: torch.Tensor, n: int, max_len: int,
                    rows: int) -> TraceRows:
    """The one-trace-per-row tensors of the group (K13); see the module
    docstring. Nothing is synchronised."""
    global rows_launches, rows_device_launches
    n, max_len, rows = int(n), int(max_len), int(rows)
    _check(perm, trace_id_hi, trace_id_lo, categorical, continuous, n,
           max_len, rows)
    dev = perm.device
    if dev.type == "cpu":
        return trace_rows_pack_plain(perm, trace_id_hi, trace_id_lo,
                                     categorical, continuous, n, max_len,
                                     rows)
    if dev.type != "cuda":
        raise ValueError(f"trace_rows_pack runs on cuda or cpu, not {dev}")
    ins = (perm, trace_id_hi, trace_id_lo, categorical, continuous)
    if not all(t.is_contiguous() for t in ins):
        raise ValueError("trace_rows_pack needs contiguous inputs")
    N = perm.shape[0]
    C, D = categorical.shape[1], continuous.shape[1]
    L, R = max_len, rows
    out = TraceRows(
        torch.empty((R, L, C), dtype=torch.int32, device=dev),
        torch.empty((R, L, D), dtype=torch.float32, device=dev),
        torch.empty((R, L), dtype=torch.bool, device=dev),
        torch.empty((R, L), dtype=torch.int32, device=dev),
        torch.empty(1, dtype=torch.int32, device=dev))
    blocks = -(-n // ROWS_BLOCK)
    scratch = torch.empty(max(1, blocks * (ROWS_BLOCK // 32 + 1)),
                          dtype=torch.int32, device=dev)
    base = scratch.data_ptr()
    count = ctypes.c_int(0)
    fn = _rows_kernel()
    with torch.cuda.device(dev):
        rc = fn(perm.data_ptr(), trace_id_hi.data_ptr(),
                trace_id_lo.data_ptr(), categorical.data_ptr(),
                continuous.data_ptr(), C, D, n, N, L, R, base,
                base + 4 * blocks * (ROWS_BLOCK // 32),
                out.rows_used.data_ptr(), out.categorical.data_ptr(),
                out.continuous.data_ptr(), out.mask.data_ptr(),
                out.span_map.data_ptr(), ctypes.byref(count),
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"trace_rows_pack launch failed: CUDA error {rc}")
    with _count_lock:
        rows_launches += 1
        rows_device_launches += count.value
    return out

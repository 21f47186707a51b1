"""K2: the span-embedding gather-sum.

``span_embed`` is ``SpanEmbedder.__call__`` plus the positional add and the
padding mask of ``Encoder.__call__`` in ``odigos_tpu/models/layers.py``:

    x = svc[c0] + name[c1] + kind[c2] + status[c3] + svc[c4]
        + sum_s attr[c5+s] + cont @ Wc^T + bc + pos[positions]
    out = x * (segments > 0)

with column layout ``CAT_FIELDS`` (c4, the parent service, shares the
service table). Tables are f32; the sum runs in f32 and is rounded once to
``dtype``. Each table is read as Flax's ``nn.Embed`` reads it, ``jnp.take``
in fill mode (:func:`take_rows`): an id in ``[0, rows)`` takes its row, one
in ``[-rows, 0)`` row ``id + rows``, and any other id a NaN row, so the
live slot's whole embedding is NaN; a one-row table is broadcast to every
id. The positions are the packer's own (``0 <= p < max_len``) and are held
into the positional table.

A CUDA tensor launches the hand-written kernel (``csrc/span_embed.cu``) or
raises: with 16-byte aligned tables at ``d`` a multiple of 256 (the main
path, :func:`vector_path`) its sliced 16-byte path, else its scalar path.
A CPU tensor takes :func:`span_embed_plain`, the plain PyTorch version of
the same sum in the same order. ``launches`` counts kernel launches.

**K18** ``span_embed_bwd(dy, categorical, positions, segments, tables)``
is the backward pass of the table gathers (``csrc/span_embed_bwd.cu``),
f32: each table's gradient row is the sum of ``dy`` over the live slots
(segment > 0) that gathered it, each id taking its row as the forward
takes it (the gradient of an id that takes none is dropped, as
``jax.grad`` of ``nn.Embed`` drops it): the service table from columns 0
and 4, name, kind, status, the attribute table from every attribute slot,
and the positional table. One
launch: a CTA of 32 warps takes 32 rows of a table, sorts the table's
entries of those rows stably by all its warps (per-warp counts of
contiguous entry chunks, a scan over (row, warp)), then sums them in f64
in a fixed order, a hot row cut across warps and its parts added in
order, each row rounded once; rows no slot gathered are written as zeros.
No atomics on the sums, so a step is reproducible. It returns an
:class:`EmbedGrads` whose tables are views of one buffer; the continuous
projection's gradient is the caller's (two small matrix products). The
entry lists' scratch is cached per device and stream. A CPU tensor takes
:func:`span_embed_bwd_plain` (``index_add_`` in f64, rounded once);
``bwd_launches`` counts the calls that launched.
"""

from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass
from typing import Optional

import torch

from . import build

N_BASE_FIELDS = 5  # service, name, kind, status, parent_service
KIND_VOCAB = 8
STATUS_VOCAB = 4

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
bwd_launches = 0
_count_lock = threading.Lock()
_fn = None
_bwd_fns: dict = {}
# a table's rows K18 takes: each of a table's CTAs (32 rows) reads all its
# ids, so the ids are read rows / 32 times
MAX_BWD_ROWS = 49152
# (N, C, d, meta) -> (the meta as a ctypes array, gradient elements, int32
# scratch elements)
_bwd_plans: dict = {}
# (device index, stream) -> the int32 entry-list scratch
_bwd_scratch: dict = {}


@dataclass(frozen=True)
class EmbedTables:
    """The f32 tables the gather-sum reads, all ``(rows, d)`` except
    ``cont_w`` (``(d, 3)``, torch Linear layout) and ``cont_b`` (``(d,)``).
    ``attr`` is None when the model has no attr slots."""

    service: torch.Tensor
    name: torch.Tensor
    kind: torch.Tensor
    status: torch.Tensor
    attr: Optional[torch.Tensor]
    cont_w: torch.Tensor
    cont_b: torch.Tensor
    pos: torch.Tensor

    def tensors(self) -> list[torch.Tensor]:
        return [t for t in (self.service, self.name, self.kind, self.status,
                            self.attr, self.cont_w, self.cont_b, self.pos)
                if t is not None]


def take_rows(ids: torch.Tensor, rows: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """``jnp.take``'s fill mode on a table of ``rows`` rows, as Flax's
    ``nn.Embed`` gathers: ``(row, takes)``, ``row`` the row each id reads
    (0 where it takes none) and ``takes`` False where the id lies outside
    ``[-rows, rows)`` (its term is NaN, its gradient dropped). A one-row
    table is broadcast: every id takes it."""
    i = ids.long()
    if rows == 1:
        return torch.zeros_like(i), torch.ones_like(i, dtype=torch.bool)
    i = torch.where(i < 0, i + rows, i)
    takes = (i >= 0) & (i < rows)
    return torch.where(takes, i, 0), takes


def _pos_rows(positions: torch.Tensor, rows: int) -> torch.Tensor:
    """The positional table's rows: the packer's positions, held into
    it."""
    return positions.long().clamp(0, rows - 1)


def span_embed_plain(categorical: torch.Tensor, continuous: torch.Tensor,
                     positions: torch.Tensor, segments: torch.Tensor,
                     tables: EmbedTables,
                     dtype: torch.dtype) -> torch.Tensor:
    """The plain version: the same f32 sum, term by term in the kernel's
    order, rounded once. In f32 it differs from Flax only in summation
    order; in bf16 Flax also rounds every gathered term and every partial
    sum to bf16, which this version (like the kernel) does not."""
    t = tables
    nan = torch.full((), float("nan"), dtype=t.service.dtype,
                     device=t.service.device)

    def take(tab: torch.Tensor, col: torch.Tensor, rows: int):
        i, takes = take_rows(col, rows)
        return torch.where(takes[..., None], tab[i], nan)

    cat = categorical
    n_svc = t.service.shape[0]
    x = take(t.service, cat[..., 0], n_svc) + take(
        t.name, cat[..., 1], t.name.shape[0])
    x = x + take(t.kind, cat[..., 2], KIND_VOCAB)
    x = x + take(t.status, cat[..., 3], STATUS_VOCAB)
    x = x + take(t.service, cat[..., 4], n_svc)
    for a in range(N_BASE_FIELDS, cat.shape[-1]):
        x = x + take(t.attr, cat[..., a], t.attr.shape[0])
    c = continuous.float()
    proj = (c[..., 0:1] * t.cont_w[:, 0] + c[..., 1:2] * t.cont_w[:, 1]
            + c[..., 2:3] * t.cont_w[:, 2] + t.cont_b)
    x = x + proj
    x = x + t.pos[_pos_rows(positions, t.pos.shape[0])]
    x = torch.where((segments > 0)[..., None], x, torch.zeros((), device=x.device))
    return x.to(dtype)


def _check(categorical, continuous, positions, segments,
           tables: EmbedTables) -> None:
    if categorical.dim() != 3 or categorical.shape[-1] < N_BASE_FIELDS:
        raise ValueError(f"categorical must be (R, L, C>={N_BASE_FIELDS}), "
                         f"got {tuple(categorical.shape)}")
    R, L, C = categorical.shape
    if continuous.shape != (R, L, 3):
        raise ValueError(f"continuous must be {(R, L, 3)}, got "
                         f"{tuple(continuous.shape)}")
    if positions.shape != (R, L) or segments.shape != (R, L):
        raise ValueError("positions/segments must be (R, L)")
    if C > N_BASE_FIELDS and tables.attr is None:
        raise ValueError(f"{C - N_BASE_FIELDS} attr slots but no attr table")
    d = tables.service.shape[1]
    for name in ("name", "kind", "status", "attr", "pos"):
        tab = getattr(tables, name)
        if tab is not None and (tab.dim() != 2 or tab.shape[1] != d):
            raise ValueError(f"{name} table must be (rows, {d})")
    if tables.cont_w.shape != (d, 3) or tables.cont_b.shape != (d,):
        raise ValueError(f"cont_w must be ({d}, 3) and cont_b ({d},)")
    if tables.kind.shape[0] < KIND_VOCAB or tables.status.shape[0] < \
            STATUS_VOCAB:
        raise ValueError("kind/status tables are smaller than their vocabs")
    inputs = [categorical, continuous, positions, segments, *tables.tensors()]
    devices = {t.device for t in inputs}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {devices}")


SLICE_COLS = 256   # columns of one warp's slice (32 lanes x kCols in csrc)
CTA_WARPS = 16     # warps per CTA (kWarps in csrc)


def _aligned(tables: EmbedTables) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tables.tensors())


def vector_path(d: int, tables: EmbedTables) -> bool:
    """Whether the kernel takes its sliced path (each warp a fixed slice
    of 256 columns, 16-byte loads and stores): every table 16-byte aligned
    (outputs are fresh allocations, always aligned) and ``d`` a multiple of
    256 whose slices divide a CTA's warps; else the scalar path."""
    return (d % SLICE_COLS == 0 and CTA_WARPS % (d // SLICE_COLS) == 0
            and _aligned(tables))


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("span_embed").span_embed_launch
        fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 9
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def span_embed(categorical: torch.Tensor, continuous: torch.Tensor,
               positions: torch.Tensor, segments: torch.Tensor,
               tables: EmbedTables, dtype: torch.dtype) -> torch.Tensor:
    """``(R, L, d)`` embedded slots in ``dtype``; see the module docstring."""
    global launches
    _check(categorical, continuous, positions, segments, tables)
    dev = categorical.device
    if dev.type == "cpu":
        return span_embed_plain(categorical, continuous, positions,
                                segments, tables, dtype)
    if dev.type != "cuda":
        raise ValueError(f"span_embed runs on cuda or cpu, not {dev}")
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"kernel writes float32 or bfloat16, not {dtype}")
    for name, t, want in (("categorical", categorical, torch.int32),
                          ("continuous", continuous, torch.float32),
                          ("positions", positions, torch.int32),
                          ("segments", segments, torch.int32)):
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype}")
    for t in tables.tensors():
        if t.dtype != torch.float32:
            raise TypeError(f"embedding tables must be float32, got {t.dtype}")
    inputs = [categorical, continuous, positions, segments, *tables.tensors()]
    if not all(t.is_contiguous() for t in inputs):
        raise ValueError("span_embed needs contiguous inputs")
    R, L, C = categorical.shape
    d = tables.service.shape[1]
    out = torch.empty((R, L, d), dtype=dtype, device=dev)
    N = R * L
    if N == 0:
        return out
    t = tables
    attr_ptr = t.attr.data_ptr() if t.attr is not None else None
    n_attr = t.attr.shape[0] if t.attr is not None else 0
    aligned = int(_aligned(tables))
    fn = _kernel()
    with torch.cuda.device(dev):
        rc = fn(categorical.data_ptr(), continuous.data_ptr(),
                positions.data_ptr(), segments.data_ptr(),
                t.service.data_ptr(), t.name.data_ptr(), t.kind.data_ptr(),
                t.status.data_ptr(), attr_ptr, t.cont_w.data_ptr(),
                t.cont_b.data_ptr(), t.pos.data_ptr(), out.data_ptr(),
                N, C, d, t.service.shape[0], t.name.shape[0], n_attr,
                t.pos.shape[0], _DTYPE_CODES[dtype], aligned,
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"span_embed launch failed: CUDA error {rc}")
    with _count_lock:
        launches += 1
    return out


# ------------------------------------------------------------ backward (K18)
@dataclass(frozen=True)
class EmbedGrads:
    """K18's output: each gathered table's gradient (``attr`` None without
    attribute slots)."""

    service: torch.Tensor
    name: torch.Tensor
    kind: torch.Tensor
    status: torch.Tensor
    attr: Optional[torch.Tensor]
    pos: torch.Tensor


def _bwd_tables(categorical: torch.Tensor, tables: EmbedTables) -> list:
    """``(name, table, rows an id addresses, first column, column step,
    columns, positions?)`` of each gathered table, in :class:`EmbedGrads`'
    order."""
    C = categorical.shape[-1]
    t = tables
    out = [("service", t.service, t.service.shape[0], 0, 4, 2, 0),
           ("name", t.name, t.name.shape[0], 1, 1, 1, 0),
           ("kind", t.kind, KIND_VOCAB, 2, 1, 1, 0),
           ("status", t.status, STATUS_VOCAB, 3, 1, 1, 0)]
    if t.attr is not None:
        out.append(("attr", t.attr, t.attr.shape[0], N_BASE_FIELDS, 1,
                    C - N_BASE_FIELDS, 0))
    out.append(("pos", t.pos, t.pos.shape[0], 0, 1, 1, 1))
    return out


def span_embed_bwd_plain(dy: torch.Tensor, categorical: torch.Tensor,
                         positions: torch.Tensor, segments: torch.Tensor,
                         tables: EmbedTables) -> EmbedGrads:
    """K18's plain version: ``index_add_`` of the live slots' ``dy`` rows
    in f64, column by column, each id at the row :func:`take_rows` gives it
    (none where it takes none), rounded once to ``dy``'s type."""
    _check(categorical, torch.zeros(categorical.shape[:2] + (3,),
                                    device=categorical.device),
           positions, segments, tables)
    R, L, C = categorical.shape
    d = tables.service.shape[1]
    if dy.shape != (R, L, d):
        raise ValueError(f"dy must be {(R, L, d)}, got {tuple(dy.shape)}")
    live = (segments > 0).reshape(-1, 1)
    g = torch.where(live, dy.reshape(-1, d).to(torch.float64),
                    torch.zeros((), dtype=torch.float64, device=dy.device))
    cat = categorical.reshape(-1, C).long()
    grads = {}
    for name, tab, id_rows, first, step, ncols, use_pos in _bwd_tables(
            categorical, tables):
        acc = torch.zeros(tab.shape, dtype=torch.float64, device=dy.device)
        for j in range(ncols):
            if use_pos:
                acc.index_add_(0, _pos_rows(positions.reshape(-1), id_rows),
                               g)
                continue
            i, takes = take_rows(cat[:, first + j * step], id_rows)
            acc.index_add_(0, i[takes], g[takes])
        grads[name] = acc.to(dy.dtype)
    grads.setdefault("attr", None)
    return EmbedGrads(**grads)


def _bwd_kernel(name: str = "span_embed_bwd_launch"):
    fn = _bwd_fns.get(name)
    if fn is None:
        lib = build.load("span_embed_bwd")
        fn = getattr(lib, name)
        if name == "span_embed_bwd_launch":
            fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong]
                           + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4)
            fn.restype = ctypes.c_int
        else:
            fn.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                           ctypes.c_void_p,
                           ctypes.POINTER(ctypes.c_longlong)]
            fn.restype = ctypes.c_longlong
        _bwd_fns[name] = fn
    return fn


def _bwd_plan(N: int, C: int, d: int, meta: tuple):
    """K18's launch plan for these shapes and tables (cached): the meta as
    a ctypes array, the gradients' f32 elements, the scratch's int32
    elements."""
    key = (N, C, d, meta)
    plan = _bwd_plans.get(key)
    if plan is None:
        arr = (ctypes.c_int * len(meta))(*meta)
        order = ctypes.c_longlong(0)
        elems = _bwd_kernel("span_embed_bwd_sizes")(
            N, d, len(meta) // 6, ctypes.cast(arr, ctypes.c_void_p),
            ctypes.byref(order))
        if elems < 0:
            raise ValueError(f"span_embed_bwd refuses these tables: {meta}")
        plan = (arr, elems, order.value)
        _bwd_plans[key] = plan
    return plan


def _bwd_order(dev: torch.device, stream, n: int) -> torch.Tensor:
    """K18's cached int32 entry-list scratch of at least ``n`` elements on
    ``dev`` for ``stream`` (every element the kernel reads it writes
    first)."""
    key = (dev.index, stream.cuda_stream)
    buf = _bwd_scratch.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.empty(max(n, 1), dtype=torch.int32, device=dev)
        _bwd_scratch[key] = buf
    return buf


def span_embed_bwd(dy: torch.Tensor, categorical: torch.Tensor,
                   positions: torch.Tensor, segments: torch.Tensor,
                   tables: EmbedTables) -> EmbedGrads:
    """K18: the gathered tables' gradients, f32 (module docstring).
    Nothing is synchronised."""
    global bwd_launches
    dev = dy.device
    if dev.type == "cpu":
        return span_embed_bwd_plain(dy, categorical, positions, segments,
                                    tables)
    if dev.type != "cuda":
        raise ValueError(f"span_embed_bwd runs on cuda or cpu, not {dev}")
    R, L, C = categorical.shape
    d = tables.service.shape[1]
    if dy.shape != (R, L, d) or dy.dtype != torch.float32:
        raise ValueError(f"dy must be an ({R}, {L}, {d}) float32 tensor, "
                         f"got {tuple(dy.shape)} {dy.dtype}")
    if d > 1024:
        raise ValueError(f"span_embed_bwd takes d up to 1024, not {d}")
    for name, t in (("categorical", categorical), ("positions", positions),
                    ("segments", segments)):
        if t.dtype != torch.int32 or not t.is_contiguous() or \
                t.device != dev:
            raise TypeError(f"{name} must be contiguous int32 on {dev}")
    if not dy.is_contiguous():
        raise ValueError("span_embed_bwd needs a contiguous dy")
    specs = _bwd_tables(categorical, tables)
    for name, tab, *_ in specs:
        if tab.shape[0] > MAX_BWD_ROWS:
            raise ValueError(f"span_embed_bwd takes tables of up to "
                             f"{MAX_BWD_ROWS} rows; {name} has "
                             f"{tab.shape[0]}")
    N = R * L
    rows = [tab.shape[0] for _, tab, *_ in specs]
    if N == 0:
        grads = {name: torch.zeros((n, d), dtype=torch.float32, device=dev)
                 for (name, *_), n in zip(specs, rows)}
        grads.setdefault("attr", None)
        return EmbedGrads(**grads)
    meta = tuple(x for (_, tab, id_rows, first, step, ncols, use_pos)
                 in specs for x in (tab.shape[0], id_rows, first, step,
                                    ncols, use_pos))
    arr, elems, order_n = _bwd_plan(N, C, d, meta)
    flat = torch.empty(elems, dtype=torch.float32, device=dev)
    grads, at = {}, 0
    for (name, *_), n in zip(specs, rows):
        grads[name] = flat[at:at + n * d].view(n, d)
        at += n * d
    grads.setdefault("attr", None)
    fn = _bwd_kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        order = _bwd_order(dev, stream, order_n)
        rc = fn(dy.data_ptr(), categorical.data_ptr(), positions.data_ptr(),
                segments.data_ptr(), N, C, d, len(specs),
                ctypes.cast(arr, ctypes.c_void_p), flat.data_ptr(),
                order.data_ptr(), stream.cuda_stream)
    if rc != 0:
        raise RuntimeError(f"span_embed_bwd launch failed: CUDA error {rc}")
    with _count_lock:
        bwd_launches += 1
    return EmbedGrads(**grads)

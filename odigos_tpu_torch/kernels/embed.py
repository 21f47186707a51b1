"""K2: the span-embedding gather-sum.

``span_embed`` is ``SpanEmbedder.__call__`` plus the positional add and the
padding mask of ``Encoder.__call__`` in ``odigos_tpu/models/layers.py``:

    x = svc[c0] + name[c1] + kind[c2] + status[c3] + svc[c4]
        + sum_s attr[c5+s] + cont @ Wc^T + bc + pos[positions]
    out = x * (segments > 0)

with column layout ``CAT_FIELDS`` (c4, the parent service, shares the
service table). Tables are f32; the sum runs in f32 and is rounded once to
``dtype``. Ids are clamped into their tables (the featurizer emits them in
range by construction).

A CUDA tensor launches the hand-written kernel (``csrc/span_embed.cu``) or
raises: with 16-byte aligned tables at ``d`` a multiple of 256 (the main
path, :func:`vector_path`) its sliced 16-byte path, else its scalar path.
A CPU tensor takes :func:`span_embed_plain`, the plain PyTorch version of
the same sum in the same order. ``launches`` counts kernel launches.
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
_count_lock = threading.Lock()
_fn = None


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


def span_embed_plain(categorical: torch.Tensor, continuous: torch.Tensor,
                     positions: torch.Tensor, segments: torch.Tensor,
                     tables: EmbedTables,
                     dtype: torch.dtype) -> torch.Tensor:
    """The plain version: the same f32 sum, term by term in the kernel's
    order, rounded once. In f32 it differs from Flax only in summation
    order; in bf16 Flax also rounds every gathered term and every partial
    sum to bf16, which this version (like the kernel) does not."""
    t = tables

    def ids(col: torch.Tensor, rows: int) -> torch.Tensor:
        return col.long().clamp(0, rows - 1)

    cat = categorical
    n_svc = t.service.shape[0]
    x = t.service[ids(cat[..., 0], n_svc)] + t.name[
        ids(cat[..., 1], t.name.shape[0])]
    x = x + t.kind[ids(cat[..., 2], KIND_VOCAB)]
    x = x + t.status[ids(cat[..., 3], STATUS_VOCAB)]
    x = x + t.service[ids(cat[..., 4], n_svc)]
    for a in range(N_BASE_FIELDS, cat.shape[-1]):
        x = x + t.attr[ids(cat[..., a], t.attr.shape[0])]
    c = continuous.float()
    proj = (c[..., 0:1] * t.cont_w[:, 0] + c[..., 1:2] * t.cont_w[:, 1]
            + c[..., 2:3] * t.cont_w[:, 2] + t.cont_b)
    x = x + proj
    x = x + t.pos[ids(positions, t.pos.shape[0])]
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

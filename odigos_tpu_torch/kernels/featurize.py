"""K5: the fused route's featurize over raw span columns.

``featurize_columns(...)`` is ``featurize_columns_jax`` of
``odigos_tpu/features/featurizer.py`` — string-table gathers, enum
widening, the per-frame parent self-join and the continuous block — over a
padded group of ``N`` rows whose first ``n`` are real; see
:func:`~odigos_tpu_torch.features.featurizer.featurize_columns_torch` for
the contract, which is also the plain version (its three phases are
``featurize_{hash,join,assemble}_torch``).

A CUDA tensor takes ``csrc/featurize.cu``: the parent join by a hash
table on the card (``table_slots(N)`` u64 slots from the caching
allocator, cleared by a memset), one launch inserting every declaration
(the lowest row of each ``(frame, span_id)`` key wins) and one, by
programmatic dependent launch, probing each span's ``(frame, parent_id)``
and assembling its row; a failure raises. No sort runs: K6 sorts only the
traces of a fused call. A CPU tensor takes the plain version.
``launches`` counts the calls that launched K5, ``device_launches`` its
kernels (two a call with real rows; the memset is not counted).
"""

from __future__ import annotations

import ctypes
import threading

import torch

from ..features.featurizer import featurize_columns_torch
from . import build

launches = 0
device_launches = 0
_count_lock = threading.Lock()
_fn = None

featurize_columns_plain = featurize_columns_torch

_INT32 = ("service_table", "name_table", "service", "name", "frame_id")
_INT8 = ("kind", "status_code")
_INT64 = ("span_id", "parent_id", "start", "end")


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("featurize").featurize_launch
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
                       + [ctypes.c_void_p] * 10 + [ctypes.c_longlong] * 3
                       + [ctypes.c_void_p] * 2
                       + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def table_slots(N: int) -> int:
    """The join table's slots for a bucket of ``N`` rows: the power of two
    at or above 4N (so the table is at most a quarter full), at least one
    probe group (4)."""
    return max(4, 1 << (4 * N - 1).bit_length()) if N else 4


def _check(cols: dict, n: int) -> None:
    N = cols["service"].shape[0]
    for name, t in cols.items():
        if name.endswith("table"):
            if t.dim() != 1 or t.numel() < 1:
                raise ValueError(f"{name} must be a non-empty 1-D table")
        elif t.shape != (N,):
            raise ValueError(f"{name} must be ({N},), got {tuple(t.shape)}")
    want = {**{k: torch.int32 for k in _INT32},
            **{k: torch.int8 for k in _INT8},
            **{k: torch.int64 for k in _INT64}}
    for name, t in cols.items():
        if t.dtype != want[name]:
            raise TypeError(f"{name} must be {want[name]}, got {t.dtype}")
    if len({t.device for t in cols.values()}) != 1:
        raise ValueError("featurize_columns inputs on several devices")
    if not 0 <= n <= N:
        raise ValueError(f"n must be in [0, {N}], got {n}")


def featurize_columns(service_table: torch.Tensor, name_table: torch.Tensor,
                      service: torch.Tensor, name: torch.Tensor,
                      kind: torch.Tensor, status_code: torch.Tensor,
                      span_id: torch.Tensor, parent_id: torch.Tensor,
                      start: torch.Tensor, end: torch.Tensor,
                      frame_id: torch.Tensor, n: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(categorical (N, 5) int32, continuous (N, 3) f32)`` of the group,
    zero past ``n``. Nothing is synchronised."""
    global launches, device_launches
    cols = dict(service_table=service_table, name_table=name_table,
                service=service, name=name, kind=kind,
                status_code=status_code, span_id=span_id,
                parent_id=parent_id, start=start, end=end,
                frame_id=frame_id)
    n = int(n)
    _check(cols, n)
    dev = service.device
    if dev.type == "cpu":
        return featurize_columns_plain(
            service_table, name_table, service, name, kind, status_code,
            span_id, parent_id, start, end, frame_id, n)
    if dev.type != "cuda":
        raise ValueError(f"featurize_columns runs on cuda or cpu, not {dev}")
    if not all(t.is_contiguous() for t in cols.values()):
        raise ValueError("featurize_columns needs contiguous inputs")
    N = service.shape[0]
    cat = torch.empty((N, 5), dtype=torch.int32, device=dev)
    cont = torch.empty((N, 3), dtype=torch.float32, device=dev)
    if N == 0:
        return cat, cont
    P = table_slots(N)
    table = torch.empty(P, dtype=torch.int64, device=dev)
    count = ctypes.c_int(0)
    fn = _kernel()
    with torch.cuda.device(dev):
        rc = fn(service_table.data_ptr(), name_table.data_ptr(),
                service_table.numel(), name_table.numel(),
                service.data_ptr(), name.data_ptr(), kind.data_ptr(),
                status_code.data_ptr(), span_id.data_ptr(),
                parent_id.data_ptr(), start.data_ptr(), end.data_ptr(),
                frame_id.data_ptr(), table.data_ptr(), P, n, N,
                cat.data_ptr(), cont.data_ptr(), ctypes.byref(count),
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"featurize_columns launch failed: CUDA error "
                           f"{rc}")
    with _count_lock:
        launches += 1
        device_launches += count.value
    return cat, cont

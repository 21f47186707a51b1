"""K1: packed segment-masked multi-head attention.

``segment_attention(q, k, v, segments)`` is Flax's
``MultiHeadDotProductAttention`` core (``dot_product_attention``) under the
packed block-diagonal mask of ``odigos_tpu/models/layers.py`` (Encoder,
segments branch): key j is allowed for query i iff
``segments[i] == segments[j] > 0``. Layout is JAX's DenseGeneral layout,
``(R, L, H, hd)`` in and out.

A CUDA tensor launches one of four hand-written kernels
(``csrc/segment_attention.cu``) or raises; :func:`kernel_route` says which.
Up to ``L = 64`` slots and ``hd = 64``, bf16 inputs with ``hd % 16 == 0``
and ``L % 4 == 0`` whose row fits shared memory (the default geometry)
take the one-tile tensor-core kernel (``"tc"``), the rest the one-tile
CUDA-core kernel (``"simt"``; f32, the parity path). Past that, up to
``MAX_L`` slots and ``MAX_HD`` head dims, the tiled kernels stream 64-key
tiles with an online softmax: bf16 with ``hd % 16 == 0`` on tensor cores
(``"flash"``), everything else on CUDA cores (``"tiled"``).
A CPU tensor takes :func:`segment_attention_plain`, the plain PyTorch
version of the same arithmetic, which is also what both kernels are held
to on the card. ``launches`` counts kernel launches.

The f32 routes (``"simt"``, ``"tiled"``) also write each query's
log-sum-exp of its masked scores into an ``(R, H, L)`` f32 buffer the
caller passes (``lse=``), for the backward pass; serving passes none and
its launches are unchanged.

**K16** ``segment_attention_bwd`` is that backward pass
(``csrc/segment_attention_bwd.cu``), f32 only (the trainer's working
type), for every ``L <= MAX_L`` and ``hd <= MAX_HD`` the f32 routes take.
From ``dO``, ``q``, ``k``, ``v``, the output ``O`` and the LSE it
recomputes, for each (row, head) over the allowed pairs,
``S = (q / round(sqrt(hd))) . k^T`` and ``P = exp(S - LSE)``, then
``dV = P^T dO``, ``dP = dO V^T``, ``Delta = rowsum(dO * O)``,
``dS = P * (dP - Delta)``, ``dQ = dS . k / round(sqrt(hd))`` and
``dK = dS^T . (q / round(sqrt(hd)))``. A padding query (segment 0) has no
allowed key: the forward gives it the uniform average of the row's L
values (the finite fill), so its ``P`` is ``1 / L`` over the row and its
``dS`` is 0 (the fill's scores do not depend on q or k); the masked pairs
of a live query have ``P = 0`` and ``dS = 0``. One launch a call, no
atomics (a step is reproducible), each output one f32 chain in a fixed
order (S and dP over d, dQ over keys, dK and dV over queries, Delta's f64
sum), leaving out only exactly-zero terms, so both routes give the same
bits. Up to ``BWD_ONE_CTA_MAX_L`` slots and ``BWD_ONE_CTA_MAX_HD`` head
dims (``hd % 4 == 0``, 16-byte aligned tensors: both trainers' shapes) a
CTA takes a (row, head): the live slots listed once, S and dP computed
once for each allowed pair, P and dS kept in shared memory (``"one_cta"``);
past that, dQ CTAs (a query tile) and dK/dV CTAs (a key tile) share one
grid, each computing Delta for the query tiles it reads and walking only
the tile pairs that hold an allowed pair (``"tiled"``);
:func:`bwd_route` says which. A CPU tensor takes
:func:`segment_attention_bwd_plain`; ``bwd_launches`` counts the calls
that launched.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import Optional

import torch

from . import build

ONE_TILE = 64   # the one-tile kernels: <= 64 slots and hd <= 64
MAX_L = 1024    # the tiled kernels (K7's walk takes no longer rows)
MAX_HD = 256
BWD_ONE_CTA_MAX_L = 64    # K16's one-CTA route: a (row, head) in one CTA
BWD_ONE_CTA_MAX_HD = 128  # (its shared tiles fit 227 KB up to L 64, hd 128)
TC_SMEM_LIMIT = 232448   # shared memory a block may use on Hopper (227 KB)
_ROUTES = {"simt": 0, "tc": 1, "flash": 2, "tiled": 3}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
bwd_launches = 0
_count_lock = threading.Lock()
_fn = None
_bwd_fn = None


@functools.lru_cache(maxsize=None)
def _scale_div(hd: int, dtype: torch.dtype) -> float:
    """sqrt(hd) rounded to the working type — Flax divides q by
    ``jnp.sqrt(depth).astype(dtype)`` (f32 sqrt, then the cast)."""
    return float(torch.tensor(math.sqrt(hd), dtype=torch.float32).to(dtype))


def _acc(dtype: torch.dtype) -> torch.dtype:
    """The plain versions' arithmetic type: f32, or f64 for f64 inputs
    (the gradient checks)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _allowed(segments: torch.Tensor) -> torch.Tensor:
    """``(R, Lq, Lk)``: key j allowed for query i (same live segment)."""
    seg = segments.to(torch.int64)
    return (seg[:, :, None] == seg[:, None, :]) & (seg[:, :, None] > 0)


def segment_attention_plain(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, segments: torch.Tensor,
                            lse: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """The plain version: q scaled in the working type, then scores,
    the finite-``finfo.min`` mask, softmax and P.V in f32, rounded once.
    In f32 this is exactly Flax's computation; in bf16 Flax also rounds
    the scores and the softmax to bf16, which this version (like the
    kernel) does not. ``lse``: an ``(R, H, L)`` buffer that takes each
    query's log-sum-exp of its masked scores."""
    dtype = q.dtype
    acc = _acc(dtype)
    qs = (q / _scale_div(q.shape[-1], dtype)).to(acc)
    s = torch.einsum("rqhd,rkhd->rhqk", qs, k.to(acc))
    s = s.masked_fill(~_allowed(segments)[:, None], torch.finfo(dtype).min)
    if lse is not None:  # an auxiliary output: no graph behind it
        with torch.no_grad():
            lse.copy_(torch.logsumexp(s, dim=-1))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("rhqk,rkhd->rqhd", p, v.to(acc))
    return o.to(dtype).contiguous()  # the kernel's output layout


def segment_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, segments: torch.Tensor,
                                o: torch.Tensor, lse: torch.Tensor,
                                do: torch.Tensor
                                ) -> tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """K16's plain version: ``(dq, dk, dv)`` from the forward's output
    ``o`` and ``lse`` (module docstring), in the working type."""
    _check_bwd(q, k, v, segments, o, lse, do)
    dtype = q.dtype
    acc = _acc(dtype)
    R, L, H, hd = q.shape
    sd = _scale_div(hd, dtype)
    qs = (q / sd).to(acc)
    s = torch.einsum("rqhd,rkhd->rhqk", qs, k.to(acc))
    allowed = _allowed(segments)[:, None]              # (R, 1, Lq, Lk)
    live = (segments > 0)[:, None, :, None]            # (R, 1, Lq, 1)
    zero = torch.zeros((), dtype=acc, device=q.device)
    p = torch.where(allowed, torch.exp(s - lse.to(acc)[..., None]), zero)
    p = torch.where(live, p, torch.full((), 1.0 / L, dtype=acc,
                                        device=q.device))
    dof = do.to(acc)
    dv = torch.einsum("rhqk,rqhd->rkhd", p, dof)
    dp = torch.einsum("rqhd,rkhd->rhqk", dof, v.to(acc))
    # Delta: f32 products summed in f64 (the kernel's sums)
    delta = (dof * o.to(acc)).to(torch.float64).sum(-1).to(acc)
    ds = torch.where(allowed, p * (dp - delta.permute(0, 2, 1)[..., None]),
                     zero)
    dq = torch.einsum("rhqk,rkhd->rqhd", ds, k.to(acc)) / sd
    dk = torch.einsum("rhqk,rqhd->rkhd", ds, qs)
    return (dq.to(dtype).contiguous(), dk.to(dtype).contiguous(),
            dv.to(dtype).contiguous())


def _check(q, k, v, segments) -> None:
    if q.dim() != 4:
        raise ValueError(f"q must be (R, L, H, hd), got {tuple(q.shape)}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v shapes differ: {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q/k/v dtypes differ")
    if segments.shape != q.shape[:2]:
        raise ValueError(f"segments must be (R, L) = {tuple(q.shape[:2])}, "
                         f"got {tuple(segments.shape)}")
    devices = {t.device for t in (q, k, v, segments)}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {devices}")


def _check_bwd(q, k, v, segments, o, lse, do) -> None:
    _check(q, k, v, segments)
    R, L, H, _ = q.shape
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o and do must be {tuple(q.shape)}, got "
                         f"{tuple(o.shape)} and {tuple(do.shape)}")
    if lse.shape != (R, H, L):
        raise ValueError(f"lse must be (R, H, L) = {(R, H, L)}, got "
                         f"{tuple(lse.shape)}")
    if o.dtype != q.dtype or do.dtype != q.dtype:
        raise TypeError("o and do must have q's dtype")
    if {t.device for t in (q, o, lse, do)} != {q.device}:
        raise ValueError("inputs on several devices")


def _round16(x: int) -> int:
    return (x + 15) // 16 * 16


def tc_stage_bytes(L: int, H: int, hd: int) -> int:
    """Shared memory of one stage of the tensor-core kernel: Q, K and V
    each as the row's ``[L rounded to 16]`` slots of ``H * hd`` bf16 plus 8
    of padding, then the row's segment ids (``tc::Geom`` in the source)."""
    Lk = _round16(L)
    return 3 * Lk * (H * hd + 8) * 2 + Lk * 4


def kernel_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 segments: torch.Tensor) -> str:
    """The kernel a CUDA launch takes (module docstring): ``"tc"`` where
    the one-tile tensor-core kernel takes the inputs (bf16, ``hd % 16 ==
    0`` for whole 16-column tiles, ``L % 4 == 0`` and 16-byte aligned
    tensors for 16-byte copies, one row's stage in shared memory, ``L`` and
    ``hd`` at most 64), else ``"simt"`` up to 64; past that ``"flash"``
    (bf16, ``hd % 16 == 0``, aligned) or ``"tiled"``."""
    _, L, H, hd = q.shape
    aligned = all(t.data_ptr() % 16 == 0 for t in (q, k, v))
    tc_shape = q.dtype == torch.bfloat16 and hd % 16 == 0 and aligned
    if L <= ONE_TILE and hd <= ONE_TILE:
        fits = tc_stage_bytes(L, H, hd) <= TC_SMEM_LIMIT
        if (tc_shape and fits and L % 4 == 0
                and segments.data_ptr() % 16 == 0):
            return "tc"
        return "flash" if tc_shape and not fits else "simt"
    return "flash" if tc_shape else "tiled"


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("segment_attention").segment_attention_launch
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check_lse(lse: torch.Tensor, q: torch.Tensor) -> None:
    R, L, H, _ = q.shape
    want = _acc(q.dtype)  # f32 (f64 for f64 inputs on the CPU)
    if (lse.shape != (R, H, L) or lse.dtype != want
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"lse must be a contiguous (R, H, L) = "
                         f"{(R, H, L)} {want} buffer on {q.device}")


def segment_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      segments: torch.Tensor,
                      lse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``(R, L, H, hd)`` attention output; with ``lse`` (a contiguous
    ``(R, H, L)`` f32 buffer; the f32 routes only) also each query's
    log-sum-exp. See the module docstring."""
    global launches
    _check(q, k, v, segments)
    if lse is not None:
        _check_lse(lse, q)
    if q.device.type == "cpu":
        return segment_attention_plain(q, k, v, segments, lse)
    if q.device.type != "cuda":
        raise ValueError(f"segment_attention runs on cuda or cpu, not "
                         f"{q.device}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"kernel takes float32 or bfloat16, not {q.dtype}")
    if segments.dtype != torch.int32:
        raise TypeError(f"segments must be int32, got {segments.dtype}")
    R, L, H, hd = q.shape
    if L > MAX_L or hd > MAX_HD:
        raise ValueError(f"segment_attention takes L <= {MAX_L} and hd <= "
                         f"{MAX_HD}, got L={L} hd={hd}")
    if not all(t.is_contiguous() for t in (q, k, v, segments)):
        raise ValueError("segment_attention needs contiguous inputs")
    out = torch.empty_like(q)
    if R == 0 or L == 0 or H == 0 or hd == 0:
        return out
    name = kernel_route(q, k, v, segments)
    if lse is not None and name not in ("simt", "tiled"):
        raise ValueError(f"the {name!r} route writes no log-sum-exp (the "
                         f"f32 routes do)")
    fn = _kernel()
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                segments.data_ptr(), out.data_ptr(), R, L, H, hd,
                _DTYPE_CODES[q.dtype], _ROUTES[name], _scale_div(hd, q.dtype),
                torch.finfo(q.dtype).min,
                None if lse is None else lse.data_ptr(),
                torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"segment_attention launch failed: CUDA error "
                           f"{rc}")
    with _count_lock:
        launches += 1
    return out


def _bwd_kernel():
    global _bwd_fn
    if _bwd_fn is None:
        fn = build.load("segment_attention_bwd").segment_attention_bwd_launch
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 4
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _bwd_fn = fn
    return _bwd_fn


def bwd_route(L: int, hd: int, *tensors: torch.Tensor) -> str:
    """K16's route for ``L`` slots of ``hd`` dims (module docstring):
    ``"one_cta"`` where a (row, head) fits one CTA and every tensor given
    is 16-byte aligned, else ``"tiled"``."""
    aligned = all(t.data_ptr() % 16 == 0 for t in tensors)
    if (L <= BWD_ONE_CTA_MAX_L and hd <= BWD_ONE_CTA_MAX_HD and hd % 4 == 0
            and aligned):
        return "one_cta"
    return "tiled"


def segment_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          segments: torch.Tensor, o: torch.Tensor,
                          lse: torch.Tensor, do: torch.Tensor,
                          out: Optional[torch.Tensor] = None
                          ) -> tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """K16: ``(dq, dk, dv)``, each ``(R, L, H, hd)``, the planes of
    ``out`` (a contiguous ``(3, R, L, H, hd)`` buffer) if given. See the
    module docstring. Nothing is synchronised."""
    global bwd_launches
    _check_bwd(q, k, v, segments, o, lse, do)
    shape = (3,) + tuple(q.shape)
    if out is not None and (tuple(out.shape) != shape
                            or out.dtype != q.dtype
                            or out.device != q.device
                            or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous {shape} {q.dtype} "
                         f"buffer on {q.device}")
    if q.device.type == "cpu":
        grads = segment_attention_bwd_plain(q, k, v, segments, o, lse, do)
        if out is None:
            return grads
        for plane, g in zip(out, grads):
            plane.copy_(g)
        return out[0], out[1], out[2]
    if q.device.type != "cuda":
        raise ValueError(f"segment_attention_bwd runs on cuda or cpu, not "
                         f"{q.device}")
    if q.dtype != torch.float32:
        raise TypeError(f"segment_attention_bwd takes float32 (the "
                        f"trainer's type), not {q.dtype}")
    if segments.dtype != torch.int32 or lse.dtype != torch.float32:
        raise TypeError("segments must be int32 and lse float32")
    R, L, H, hd = q.shape
    if L > MAX_L or hd > MAX_HD:
        raise ValueError(f"segment_attention_bwd takes L <= {MAX_L} and "
                         f"hd <= {MAX_HD}, got L={L} hd={hd}")
    if not all(t.is_contiguous() for t in (q, k, v, segments, o, lse, do)):
        raise ValueError("segment_attention_bwd needs contiguous inputs")
    out = torch.empty(shape, dtype=q.dtype, device=q.device) \
        if out is None else out
    if R == 0 or L == 0 or H == 0 or hd == 0:
        out.zero_()
        return out[0], out[1], out[2]
    fn = _bwd_kernel()
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                segments.data_ptr(), o.data_ptr(), lse.data_ptr(),
                do.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
                out[2].data_ptr(), R, L, H, hd, _scale_div(hd, q.dtype),
                torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"segment_attention_bwd launch failed: CUDA "
                           f"error {rc}")
    with _count_lock:
        bwd_launches += 1
    return out[0], out[1], out[2]

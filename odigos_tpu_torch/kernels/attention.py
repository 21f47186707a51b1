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
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading

import torch

from . import build

ONE_TILE = 64   # the one-tile kernels: <= 64 slots and hd <= 64
MAX_L = 1024    # the tiled kernels (K7's walk takes no longer rows)
MAX_HD = 256
TC_SMEM_LIMIT = 232448   # shared memory a block may use on Hopper (227 KB)
_ROUTES = {"simt": 0, "tc": 1, "flash": 2, "tiled": 3}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
_count_lock = threading.Lock()
_fn = None


@functools.lru_cache(maxsize=None)
def _scale_div(hd: int, dtype: torch.dtype) -> float:
    """sqrt(hd) rounded to the working type — Flax divides q by
    ``jnp.sqrt(depth).astype(dtype)`` (f32 sqrt, then the cast)."""
    return float(torch.tensor(math.sqrt(hd), dtype=torch.float32).to(dtype))


def segment_attention_plain(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor,
                            segments: torch.Tensor) -> torch.Tensor:
    """The plain version: q scaled in the working type, then scores,
    the finite-``finfo.min`` mask, softmax and P.V in f32, rounded once.
    In f32 this is exactly Flax's computation; in bf16 Flax also rounds
    the scores and the softmax to bf16, which this version (like the
    kernel) does not."""
    dtype = q.dtype
    qs = (q / _scale_div(q.shape[-1], dtype)).float()
    s = torch.einsum("rqhd,rkhd->rhqk", qs, k.float())
    seg = segments.to(torch.int64)
    allowed = (seg[:, :, None] == seg[:, None, :]) & (seg[:, :, None] > 0)
    s = s.masked_fill(~allowed[:, None], torch.finfo(dtype).min)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("rhqk,rkhd->rqhd", p, v.float())
    return o.to(dtype).contiguous()  # the kernel's output layout


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
                       + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def segment_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      segments: torch.Tensor) -> torch.Tensor:
    """``(R, L, H, hd)`` attention output; see the module docstring."""
    global launches
    _check(q, k, v, segments)
    if q.device.type == "cpu":
        return segment_attention_plain(q, k, v, segments)
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
    route = _ROUTES[kernel_route(q, k, v, segments)]
    fn = _kernel()
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                segments.data_ptr(), out.data_ptr(), R, L, H, hd,
                _DTYPE_CODES[q.dtype], route, _scale_div(hd, q.dtype),
                torch.finfo(q.dtype).min,
                torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"segment_attention launch failed: CUDA error "
                           f"{rc}")
    with _count_lock:
        launches += 1
    return out

"""K12: the autoencoder's final LayerNorm + masked mean-pool.

``ln_masked_pool(x, ln_weight, ln_bias, mask, eps, live=None)`` takes the
encoder's ``(T, L, d)`` hidden state BEFORE its final LayerNorm and a
``(T, L)`` bool mask, and returns the ``(T, d)`` pooled trace vectors in
``x``'s type: the LayerNorm at each real position (f32 statistics, eps
1e-6, output rounded to the working type), summed over the real
positions, the sum rounded to the working type and divided by
``max(mask.sum(-1), 1)`` in that type. That is ``final_ln`` of
``odigos_tpu/models/layers.py`` ``Encoder`` and the pool of
``odigos_tpu/models/autoencoder.py`` ``_AutoencoderModule`` (:69-70).
``ln_masked_pool_bwd(x, ln_weight, mask, dpool, eps)`` (K21,
``csrc/ae_pool_bwd.cu``) is its backward pass for the trainer, f32:
``(dx, dweight, dbias)`` from the pooled vectors' gradient, ``g =
dpool / max(count, 1)`` taken through the LayerNorm at each real position
(K17's arithmetic, K12's statistics recomputed), ``dx`` 0 at padding. On
the card it is one launch (a CTA of 8 warps a trace, the trace's real
rows spread over its warps; the traces' f64 column sums added in trace
order by the last CTA after a ticket), its counter and partials cached
per (device, stream) by ``build.stream_scratch`` and dropped after a
failed launch.
``live`` (a ``(1,)`` int32 row count on the device: the fused route's
trace count from K13) makes every row at or past ``live[0]`` a row of
padding: it is written as zeros, and neither its mask nor its ``x`` is
read (on the card the count is read there, with no host sync).

Roundings: the LayerNorm is :func:`quant.layer_norm_plain`'s (row sums
taken exactly in f64 and rounded once to f32), and the pool's sum is taken
in f64 and rounded to f32, then to the working type (``jnp.sum`` accumulates
bf16 in f32 and rounds once), so the kernel and its plain version agree to
the bit in any summation order.

A CUDA tensor launches ``csrc/ae_pool.cu`` or raises; a CPU tensor takes
:func:`ln_masked_pool_plain`. The kernel: a warp a trace on a persistent
grid lists the trace's real positions from its mask row by ballots, then
normalises them on K14's layout (16-byte vectors on ``d / 8`` lanes, bf16;
``d / 4``, f32; several positions a warp at ``d <= 128`` bf16), the next
positions' loads issued before the current ones are reduced; the rows past
``live`` are zero-filled. It takes ``d % 8 == 0`` up to ``MAX_D`` and ``L``
up to ``MAX_L``, 16-byte aligned ``x``. ``launches`` counts the calls that
launched, ``bwd_launches`` K21's calls and ``bwd_device_launches`` the
kernels its launcher reports (one a call).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from . import build
from .dense import ln_bwd_plain
from .quant import layer_norm_plain

LN_EPS = 1e-6
MAX_D = 1024
MAX_L = 1024  # the kernel's list of a trace's real positions
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
bwd_launches = 0
bwd_device_launches = 0
_count_lock = threading.Lock()
_fn = None
_bwd_fns: dict = {}  # K21's launchers


def ln_masked_pool_plain(x: torch.Tensor, ln_weight: torch.Tensor,
                         ln_bias: torch.Tensor, mask: torch.Tensor,
                         eps: float = LN_EPS,
                         live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version: the LayerNorm at every position, then the
    masked f64 sum, rounded, divided; the rows at or past ``live[0]`` are
    taken as padding (their values, whatever they hold, are not summed)."""
    if live is not None:
        rows = torch.arange(mask.shape[0], device=mask.device)
        mask = mask & (rows < live.to(mask.device).long())[:, None]
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    y = layer_norm_plain(x, ln_weight, ln_bias, eps)
    y = torch.where(mask[..., None], y.double(), 0.0)
    s = y.sum(-2).to(acc).to(x.dtype)
    denom = mask.sum(-1, keepdim=True).clamp(min=1).to(acc)
    return (s.to(acc) / denom).to(x.dtype)


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("ae_pool").ln_masked_pool_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(x, ln_weight, ln_bias, mask, live) -> None:
    if x.dim() != 3:
        raise ValueError(f"x must be (T, L, d), got {tuple(x.shape)}")
    T, L, d = x.shape
    for name, t in (("ln_weight", ln_weight), ("ln_bias", ln_bias)):
        if t.shape != (d,):
            raise ValueError(f"{name} must be ({d},), got {tuple(t.shape)}")
    if mask.shape != (T, L) or mask.dtype != torch.bool:
        raise ValueError(f"mask must be ({T}, {L}) bool, got "
                         f"{tuple(mask.shape)} {mask.dtype}")
    if live is not None and (live.shape != (1,) or live.dtype != torch.int32):
        raise ValueError(f"live must be (1,) int32, got {tuple(live.shape)} "
                         f"{live.dtype}")
    tensors = (x, ln_weight, ln_bias, mask) + (() if live is None else (live,))
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")


def ln_masked_pool(x: torch.Tensor, ln_weight: torch.Tensor,
                   ln_bias: torch.Tensor, mask: torch.Tensor,
                   eps: float = LN_EPS,
                   live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``(T, d)`` pooled trace vectors; see the module docstring. Nothing
    is synchronised."""
    global launches
    _check(x, ln_weight, ln_bias, mask, live)
    dev = x.device
    if dev.type == "cpu":
        return ln_masked_pool_plain(x, ln_weight, ln_bias, mask, eps, live)
    if dev.type != "cuda":
        raise ValueError(f"ln_masked_pool runs on cuda or cpu, not {dev}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"x must be float32 or bfloat16, not {x.dtype}")
    if ln_weight.dtype != torch.float32 or ln_bias.dtype != torch.float32:
        raise TypeError("LayerNorm parameters must be float32")
    T, L, d = x.shape
    if d % 8 or not 0 < d <= MAX_D:
        raise ValueError(f"ln_masked_pool takes d % 8 == 0 up to {MAX_D}, "
                         f"not {d}")
    if L > MAX_L:
        raise ValueError(f"ln_masked_pool takes L up to {MAX_L}, not {L}")
    if not all(t.is_contiguous() for t in (x, ln_weight, ln_bias, mask)):
        raise ValueError("ln_masked_pool needs contiguous inputs")
    if x.data_ptr() % 16:
        raise ValueError("ln_masked_pool needs x 16-byte aligned")
    out = torch.empty((T, d), dtype=x.dtype, device=dev)
    if T == 0:
        return out
    fn = _kernel()
    with torch.cuda.device(dev):
        rc = fn(x.data_ptr(), _DTYPE_CODES[x.dtype], mask.data_ptr(),
                ln_weight.data_ptr(), ln_bias.data_ptr(), eps, T, L, d,
                None if live is None else live.data_ptr(), out.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ln_masked_pool launch failed: CUDA error {rc}")
    with _count_lock:
        launches += 1
    return out


# ------------------------------------------------------- K21: the backward
def ln_masked_pool_bwd_plain(x: torch.Tensor, ln_weight: torch.Tensor,
                             mask: torch.Tensor, dpool: torch.Tensor,
                             eps: float = LN_EPS
                             ) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """K21's plain version: ``g = dpool / max(count, 1)`` spread over each
    trace's real positions (0 at padding), then K17's plain version
    (``dense.ln_bwd_plain``) through the LayerNorm: ``(dx, dweight,
    dbias)`` (f64 for f64 inputs)."""
    _check_bwd(x, ln_weight, mask, dpool)
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    denom = mask.sum(-1, keepdim=True).clamp(min=1).to(acc)
    g = dpool.to(acc) / denom
    dy = torch.where(mask[..., None], g[:, None, :], 0.0).to(x.dtype)
    return ln_bwd_plain(x, ln_weight, dy, eps)


def _check_bwd(x, ln_weight, mask, dpool) -> None:
    if x.dim() != 3:
        raise ValueError(f"x must be (T, L, d), got {tuple(x.shape)}")
    T, L, d = x.shape
    if ln_weight.shape != (d,):
        raise ValueError(f"ln_weight must be ({d},), got "
                         f"{tuple(ln_weight.shape)}")
    if mask.shape != (T, L) or mask.dtype != torch.bool:
        raise ValueError(f"mask must be ({T}, {L}) bool, got "
                         f"{tuple(mask.shape)} {mask.dtype}")
    if dpool.shape != (T, d):
        raise ValueError(f"dpool must be ({T}, {d}), got "
                         f"{tuple(dpool.shape)}")
    devs = {t.device for t in (x, ln_weight, mask, dpool)}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")


def _bwd_kernel(name: str):
    fn = _bwd_fns.get(name)
    if fn is None:
        fn = getattr(build.load("ae_pool_bwd"), name)
        if name == "ln_masked_pool_bwd_counters":
            fn.argtypes = [ctypes.c_longlong]
            fn.restype = ctypes.c_longlong
        elif name == "ln_masked_pool_bwd_scratch":
            fn.argtypes = [ctypes.c_longlong, ctypes.c_int]
            fn.restype = ctypes.c_longlong
        else:
            fn.argtypes = ([ctypes.c_void_p] * 4
                           + [ctypes.c_float, ctypes.c_longlong, ctypes.c_int,
                              ctypes.c_int] + [ctypes.c_void_p] * 5
                           + [ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                              ctypes.c_void_p])
            fn.restype = ctypes.c_int
        _bwd_fns[name] = fn
    return fn


def ln_masked_pool_bwd(x: torch.Tensor, ln_weight: torch.Tensor,
                       mask: torch.Tensor, dpool: torch.Tensor,
                       eps: float = LN_EPS
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K21: ``(dx, dweight, dbias)`` of :func:`ln_masked_pool` (module
    docstring), f32. Nothing is synchronised."""
    global bwd_launches, bwd_device_launches
    _check_bwd(x, ln_weight, mask, dpool)
    dev = x.device
    if dev.type == "cpu":
        return ln_masked_pool_bwd_plain(x, ln_weight, mask, dpool, eps)
    if dev.type != "cuda":
        raise ValueError(f"ln_masked_pool_bwd runs on cuda or cpu, not {dev}")
    if any(t.dtype != torch.float32 for t in (x, ln_weight, dpool)):
        raise TypeError("ln_masked_pool_bwd takes float32 (the trainer's "
                        "type)")
    T, L, d = x.shape
    if not 0 < d <= MAX_D:
        raise ValueError(f"ln_masked_pool_bwd takes d up to {MAX_D}, not {d}")
    if not all(t.is_contiguous() for t in (x, ln_weight, mask, dpool)):
        raise ValueError("ln_masked_pool_bwd needs contiguous inputs")
    dx = torch.empty_like(x)
    if T == 0 or L == 0:
        return (dx, torch.zeros(d, dtype=torch.float32, device=dev),
                torch.zeros(d, dtype=torch.float32, device=dev))
    # the kernel writes both whole
    dw = torch.empty(d, dtype=torch.float32, device=dev)
    db = torch.empty(d, dtype=torch.float32, device=dev)
    launched = ctypes.c_int(0)  # the kernels launched (the launcher's own)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        cnt, part = build.stream_scratch(
            "ae_pool_bwd", dev, stream,
            _bwd_kernel("ln_masked_pool_bwd_counters")(T), torch.int32,
            _bwd_kernel("ln_masked_pool_bwd_scratch")(T, d), torch.float64)
        rc = _bwd_kernel("ln_masked_pool_bwd_launch")(
            x.data_ptr(), ln_weight.data_ptr(), mask.data_ptr(),
            dpool.data_ptr(), eps, T, L, d, dx.data_ptr(), dw.data_ptr(),
            db.data_ptr(), cnt.data_ptr(), part.data_ptr(),
            build.sm_count(dev), ctypes.byref(launched), stream.cuda_stream)
        if rc != 0:
            build.drop_scratch("ae_pool_bwd", dev, stream)
    if rc != 0:
        raise RuntimeError(f"ln_masked_pool_bwd launch failed: CUDA error "
                           f"{rc}")
    with _count_lock:
        bwd_launches += 1
        bwd_device_launches += launched.value
    return dx, dw, db

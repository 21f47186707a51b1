"""K10: int8 tensor-core GEMM with the dequantize and the block's next step
fused into its epilogue.

``qgemm(x_q, w_q, a_s, w_s, bias, out_dtype, epilogue, residual, planes)``
computes ``y = (x_q @ w_q.T) * (a_s[:, None] * w_s[None, :]) + bias`` from
``x_q (M, K)`` and ``w_q (N, K)`` int8 (the Linear layout), with the
product exact in s32 and every f32 step IEEE-rounded in the reference's
order (``odigos_tpu/models/quantized.py`` ``_qdense``), then:

* ``"none"``: ``round(y)`` to ``out_dtype`` (q, k, v);
* ``"residual"``: ``residual + round(y)``, rounded (out-projection, FFN2);
* ``"gelu_tanh"``: ``gelu(round(y))`` in f32, rounded (FFN1): the tanh
  form of ``jax.nn.gelu``, ``x * (0.5 * (1 + tanh(c * (x + 0.044715 *
  x**3))))`` with f32 constants;
* ``"gelu_tanh_quant"``: ``"gelu_tanh"``'s bf16 ``h``, then FFN2's
  activation quantize of it (K9's plain mode): returns ``(codes (M, N)
  int8, scales (M,) f32)`` and never writes ``h``. The kernel takes bf16,
  ``N <= 1024`` and ``K <= 256`` (``fused_quant_takes``); the wrapper
  refuses anything else on every device, so the CPU route mirrors the
  card's. The plain version computes it as the two plain steps in any
  dtype. The int8 scorer does not serve this mode: on the H100 it
  measured slower than ``"gelu_tanh"`` followed by K9 (PERF.md).

``planes > 1`` splits the N columns into ``planes`` blocks and returns them
as ``(planes, M, N / planes)``: the fused QKV product leaves q, k and v
each contiguous for K1.

A CUDA tensor launches ``csrc/qgemm.cu`` (bf16: ``wgmma`` s8 with TMA;
f32, and bf16 planes that are not a multiple of 64 columns: ``mma.sync``
s8) or raises — on ``K % 16 != 0``, ``N % 8 != 0`` or a misaligned operand
as on anything else it does not take; it never hands the work to the plain
version. A CPU
tensor takes :func:`qgemm_plain`, which computes the product exactly in
f64 (every partial sum is an integer below 2**53; f32 would not be exact
once ``K * 127**2`` passes ``2**24``) and the same epilogue as separate
torch ops. ``launches`` counts the calls that launched.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np
import torch

from . import build
from .quant import ln_quantize_plain

EPILOGUES = {"none": 0, "residual": 1, "gelu_tanh": 2, "gelu_tanh_quant": 3}
QUANT_MAX_N = 1024  # "gelu_tanh_quant": a 4-CTA cluster holds a row's N
QUANT_MAX_K = 256   # columns, each CTA a quarter of W resident
GELU_C = float(np.float32(np.sqrt(2.0 / np.pi)))  # the kernel's constants
GELU_K = float(np.float32(0.044715))
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
_count_lock = threading.Lock()
_fn = None


def gelu_tanh_plain(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s tanh form on f32, one IEEE step per op."""
    x3 = x * x * x
    inner = (x + x3 * GELU_K) * GELU_C
    return x * ((torch.tanh(inner) + 1.0) * 0.5)


def _split(y: torch.Tensor, planes: int) -> torch.Tensor:
    if planes == 1:
        return y
    M, N = y.shape
    return y.view(M, planes, N // planes).transpose(0, 1).contiguous()


def fused_quant_takes(N: int, K: int, out_dtype: torch.dtype) -> bool:
    """Whether ``"gelu_tanh_quant"`` takes an FFN1 of ``N`` outputs over
    ``K`` inputs in ``out_dtype`` (on every device)."""
    return (out_dtype == torch.bfloat16 and 8 <= N <= QUANT_MAX_N
            and N % 8 == 0 and 16 <= K <= QUANT_MAX_K and K % 16 == 0)


def qgemm_plain(x_q: torch.Tensor, w_q: torch.Tensor, a_s: torch.Tensor,
                w_s: torch.Tensor, bias: torch.Tensor,
                out_dtype: torch.dtype, epilogue: str = "none",
                residual: Optional[torch.Tensor] = None,
                planes: int = 1):
    """The plain version (see the module docstring)."""
    _check(x_q, w_q, a_s, w_s, bias, epilogue, residual, planes)
    if epilogue == "gelu_tanh_quant":
        return ln_quantize_plain(qgemm_plain(x_q, w_q, a_s, w_s, bias,
                                             out_dtype, "gelu_tanh"))
    acc = (x_q.double() @ w_q.double().t()).float()  # exact integers
    y = acc * (a_s[:, None] * w_s[None, :])
    y = (y + bias).to(out_dtype)
    if epilogue == "residual":
        y = (residual.float() + y.float()).to(out_dtype)
    elif epilogue == "gelu_tanh":
        y = gelu_tanh_plain(y.float()).to(out_dtype)
    return _split(y, planes)


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("qgemm").qgemm_launch
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 2
                       + [ctypes.c_longlong] + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(x_q, w_q, a_s, w_s, bias, epilogue, residual, planes) -> None:
    if epilogue not in EPILOGUES:
        raise ValueError(f"epilogue must be one of {sorted(EPILOGUES)}, "
                         f"not {epilogue!r}")
    if x_q.dim() != 2 or w_q.dim() != 2 or x_q.shape[1] != w_q.shape[1]:
        raise ValueError(f"x_q (M, K) and w_q (N, K) expected, got "
                         f"{tuple(x_q.shape)} and {tuple(w_q.shape)}")
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError("x_q and w_q must be int8")
    M, N = x_q.shape[0], w_q.shape[0]
    for name, t, n in (("a_s", a_s, M), ("w_s", w_s, N), ("bias", bias, N)):
        if t.shape != (n,) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be ({n},) float32")
    if (epilogue == "residual") != (residual is not None):
        raise ValueError("a residual is given exactly with the 'residual' "
                         "epilogue")
    if residual is not None and residual.shape != (M, N):
        raise ValueError(f"residual must be ({M}, {N})")
    if planes < 1 or N % planes or (epilogue in ("residual",
                                                  "gelu_tanh_quant")
                                     and planes != 1):
        raise ValueError(f"planes must divide N = {N} (1 with a residual "
                         f"or the quantize)")
    devs = {t.device for t in (x_q, w_q, a_s, w_s, bias)
            if t is not None} | ({residual.device} if residual is not None
                                 else set())
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")


def qgemm(x_q: torch.Tensor, w_q: torch.Tensor, a_s: torch.Tensor,
          w_s: torch.Tensor, bias: torch.Tensor, out_dtype: torch.dtype,
          epilogue: str = "none", residual: Optional[torch.Tensor] = None,
          planes: int = 1):
    """``(M, N)`` (or ``(planes, M, N / planes)``) in ``out_dtype``, or
    ``(codes, scales)`` for ``"gelu_tanh_quant"``; see the module
    docstring. Nothing is synchronised."""
    global launches
    dev = x_q.device
    M, K = x_q.shape if x_q.dim() == 2 else (0, 0)
    N = w_q.shape[0] if w_q.dim() == 2 else 0
    if epilogue == "gelu_tanh_quant" and not fused_quant_takes(N, K,
                                                               out_dtype):
        raise ValueError(f"'gelu_tanh_quant' takes bf16 out, N % 8 == 0, "
                         f"N <= {QUANT_MAX_N}, K % 16 == 0, K <= "
                         f"{QUANT_MAX_K}; got {out_dtype}, N = {N}, "
                         f"K = {K}")
    if dev.type == "cpu":
        return qgemm_plain(x_q, w_q, a_s, w_s, bias, out_dtype, epilogue,
                           residual, planes)
    _check(x_q, w_q, a_s, w_s, bias, epilogue, residual, planes)
    if dev.type != "cuda":
        raise ValueError(f"qgemm runs on cuda or cpu, not {dev}")
    if out_dtype not in _DTYPE_CODES:
        raise TypeError(f"out_dtype must be float32 or bfloat16, not "
                        f"{out_dtype}")
    if K % 16 or N % 8 or (N // planes) % 8:
        raise ValueError(f"qgemm takes K % 16 == 0 and N, N / planes % 8 "
                         f"== 0, got K = {K}, N = {N}, planes = {planes}")
    if residual is not None and residual.dtype != out_dtype:
        raise TypeError(f"residual must be {out_dtype}")
    ts = (x_q, w_q, a_s, w_s, bias) + (() if residual is None
                                       else (residual,))
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("qgemm needs contiguous inputs")
    if x_q.data_ptr() % 16 or w_q.data_ptr() % 16:
        raise ValueError("qgemm needs x_q and w_q 16-byte aligned")
    if residual is not None and residual.data_ptr() % 16:
        raise ValueError("qgemm needs the residual 16-byte aligned")
    if w_s.data_ptr() % 8 or bias.data_ptr() % 8:
        raise ValueError("qgemm needs w_s and bias 8-byte aligned")
    quant = epilogue == "gelu_tanh_quant"
    if quant:
        out = torch.empty((M, N), dtype=torch.int8, device=dev)
        scales = torch.empty(M, dtype=torch.float32, device=dev)
    else:
        shape = (M, N) if planes == 1 else (planes, M, N // planes)
        out = torch.empty(shape, dtype=out_dtype, device=dev)
        scales = None
    if M == 0:
        return (out, scales) if quant else out
    fn = _kernel()
    with torch.cuda.device(dev):
        rc = fn(x_q.data_ptr(), w_q.data_ptr(), a_s.data_ptr(),
                w_s.data_ptr(), bias.data_ptr(),
                None if residual is None else residual.data_ptr(),
                out.data_ptr(), None if scales is None else scales.data_ptr(),
                _DTYPE_CODES[out_dtype], EPILOGUES[epilogue], M, N, K,
                planes, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"qgemm launch failed: CUDA error {rc}")
    with _count_lock:
        launches += 1
    return (out, scales) if quant else out

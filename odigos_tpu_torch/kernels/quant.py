"""K9: per-token int8 quantize, with an optional LayerNorm in front.

``ln_quantize(x, ln_weight, ln_bias)`` takes ``(M, K)`` activations in the
working type (bf16 or f32) and returns ``(x_q, a_s)``: ``(M, K)`` int8
codes and ``(M,)`` f32 scales such that ``x ≈ x_q * a_s`` row by row. With
``ln_weight``/``ln_bias`` the row first goes through a LayerNorm (f32
statistics, eps 1e-6) whose output is rounded to ``x``'s type. This is the
activation half of ``odigos_tpu/models/quantized.py`` ``_qdense`` (per-token
symmetric scales, ``clip(round(x / a_s), ±127)``) with ``_layernorm`` in
front in LN mode.

The roundings are the reference's, step for step, so that no int8 code
flips between the kernel and its plain version:

* the LayerNorm's mean and variance are f32 sums rounded once (summed
  exactly in f64 by both versions, so the summation order does not
  matter), the variance two-pass, ``1 / sqrt(var + eps)`` correctly
  rounded, each product and sum a separate IEEE step, and the output
  rounded to the working type before the absmax, because ``_layernorm``
  returns that type and ``_qdense`` reads it back;
* ``a_s = absmax * f32(1/127)``, 1 for an all-zero row: XLA compiles the
  reference's ``a_max / 127.0`` into that product, so the scales are the
  JAX scorer's bit for bit;
* ``x / a_s`` is a true division, rounded half to even (the kernel
  multiplies by the row's reciprocal and divides truly only where the
  product lies near a rounding boundary: the same codes,
  ``csrc/quant_exact.cuh``).

A CUDA tensor launches ``csrc/quant.cu`` (one warp per row up to K =
1024, one CTA per row past it, 16-byte loads; ``K % 8 == 0``, ``K <=
MAX_K``, 16-byte aligned rows) or raises; a CPU tensor
takes :func:`ln_quantize_plain`. ``launches`` counts the calls that
launched.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np
import torch

from . import build

LN_EPS = 1e-6
MAX_K = 4096
INV_127 = float(np.float32(1.0) / np.float32(127.0))  # f32(1/127)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
_count_lock = threading.Lock()
_fn = None


def layer_norm_plain(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, eps: float = LN_EPS
                     ) -> torch.Tensor:
    """The LayerNorm of LN mode, rounded to ``x``'s type: f32 statistics
    (the row sums taken in f64 and rounded once), two-pass variance, each
    step a separate IEEE-rounded op (f64 inputs compute in f64: the
    gradient checks)."""
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    xf = x.to(acc)
    k = torch.full((), x.shape[-1], dtype=acc, device=x.device)
    mean = xf.double().sum(-1, keepdim=True).to(acc) / k
    dev = xf - mean
    var = (dev * dev).double().sum(-1, keepdim=True).to(acc) / k
    rstd = torch.ones_like(var) / torch.sqrt(var + eps)
    y = (dev * rstd) * weight.to(acc)
    return (y + bias.to(acc)).to(x.dtype)


def ln_quantize_plain(x: torch.Tensor,
                      ln_weight: Optional[torch.Tensor] = None,
                      ln_bias: Optional[torch.Tensor] = None,
                      eps: float = LN_EPS) -> tuple[torch.Tensor,
                                                    torch.Tensor]:
    """The plain version: :func:`layer_norm_plain` (LN mode), then the
    per-row symmetric int8 codes and scales."""
    if ln_weight is not None:
        x = layer_norm_plain(x, ln_weight, ln_bias, eps)
    xf = x.float()
    amax = xf.abs().amax(-1)
    a_s = torch.where(amax > 0, amax * INV_127, torch.ones_like(amax))
    x_q = torch.round(xf / a_s[:, None]).clamp_(-127, 127).to(torch.int8)
    return x_q, a_s


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("quant").ln_quantize_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(x, ln_weight, ln_bias) -> None:
    if x.dim() != 2:
        raise ValueError(f"x must be (M, K), got {tuple(x.shape)}")
    if (ln_weight is None) != (ln_bias is None):
        raise ValueError("LN mode needs both ln_weight and ln_bias")
    K = x.shape[1]
    for name, t in (("ln_weight", ln_weight), ("ln_bias", ln_bias)):
        if t is not None and (t.shape != (K,) or t.device != x.device):
            raise ValueError(f"{name} must be ({K},) on {x.device}")


def ln_quantize(x: torch.Tensor, ln_weight: Optional[torch.Tensor] = None,
                ln_bias: Optional[torch.Tensor] = None,
                eps: float = LN_EPS) -> tuple[torch.Tensor, torch.Tensor]:
    """``(x_q (M, K) int8, a_s (M,) f32)``; see the module docstring.
    Nothing is synchronised."""
    global launches
    _check(x, ln_weight, ln_bias)
    dev = x.device
    if dev.type == "cpu":
        return ln_quantize_plain(x, ln_weight, ln_bias, eps)
    if dev.type != "cuda":
        raise ValueError(f"ln_quantize runs on cuda or cpu, not {dev}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"x must be float32 or bfloat16, not {x.dtype}")
    M, K = x.shape
    if K % 8 or K > MAX_K or K == 0:
        raise ValueError(f"ln_quantize takes K % 8 == 0 and K <= {MAX_K}, "
                         f"got K = {K}")
    ln = ln_weight is not None
    if ln and (ln_weight.dtype != torch.float32
               or ln_bias.dtype != torch.float32):
        raise TypeError("LayerNorm parameters must be float32")
    tensors = (x, ln_weight, ln_bias) if ln else (x,)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ln_quantize needs contiguous inputs")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("ln_quantize needs x and the LayerNorm parameters "
                         "16-byte aligned")
    x_q = torch.empty((M, K), dtype=torch.int8, device=dev)
    a_s = torch.empty(M, dtype=torch.float32, device=dev)
    if M == 0:
        return x_q, a_s
    fn = _kernel()
    with torch.cuda.device(dev):
        rc = fn(x.data_ptr(), _DTYPE_CODES[x.dtype], M, K,
                ln_weight.data_ptr() if ln else None,
                ln_bias.data_ptr() if ln else None, eps, x_q.data_ptr(),
                a_s.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ln_quantize launch failed: CUDA error {rc}")
    with _count_lock:
        launches += 1
    return x_q, a_s

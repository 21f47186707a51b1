"""K8: final LayerNorm + span head + sigmoid + inverse scatter.

``span_head_scatter(h, ln_weight, ln_bias, head_weight, head_bias, perm,
row_eff, span_col, n)`` takes the encoder's ``(R, L, d)`` output BEFORE
its final LayerNorm and, for each sorted index ``j < n`` whose row is
below ``R``, evaluates the final LayerNorm (K14's exact arithmetic: f64
row sums rounded once, IEEE steps, eps 1e-6, output rounded to ``h``'s
dtype as Flax's ``LayerNorm(dtype=bf16)`` does), the f32 ``d -> 1`` span
head and the sigmoid at ``h[row_eff[j], span_col[j]]``, and writes the
probability to ``out[perm[j]]``; every other entry of the ``(N,)`` f32
output is 0. That is ``_TraceTransformerModule.span_head`` of
``odigos_tpu/models/transformer.py`` fused with the inverse scatter of
``odigos_tpu/serving/fused.py`` ``_build_forward_packed._forward``.

A CUDA tensor launches ``csrc/span_head.cu`` or raises; a CPU tensor takes
:func:`span_head_scatter_plain` (the port's ``LayerNorm``, K14's exact
arithmetic → ``span_head`` → sigmoid → ``index_put``). The kernel: a span
on ``d / 8`` lanes (bf16; ``d / 4``, f32) as 16-byte vectors read once,
several spans a warp at ``d <= 128`` bf16, the LayerNorm's and head's
parameters held by each lane for the whole launch, a persistent grid
whose warps load the next spans' indices and vectors before reducing the
current ones; padding costs nothing. Its LayerNorm output has the plain
version's bits, so the two differ only by the f32 head dot's summation
order. It takes ``d % 8 == 0`` up to ``MAX_D`` and 16-byte aligned ``h``.
``launches`` counts the calls that launched.
"""

from __future__ import annotations

import ctypes
import threading

import torch
import torch.nn.functional as F

from . import build
from .quant import layer_norm_plain

LN_EPS = 1e-6
MAX_D = 1024
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
_count_lock = threading.Lock()
_fn = None


def span_head_scatter_plain(h: torch.Tensor, ln_weight: torch.Tensor,
                            ln_bias: torch.Tensor, head_weight: torch.Tensor,
                            head_bias: torch.Tensor, perm: torch.Tensor,
                            row_eff: torch.Tensor, span_col: torch.Tensor,
                            n: int, eps: float = LN_EPS) -> torch.Tensor:
    """The plain version, on the real spans only."""
    R, L, d = h.shape
    N = perm.shape[0]
    out = torch.zeros(N, dtype=torch.float32, device=h.device)
    row = row_eff[:n].long()
    keep = row < R
    x = h[row[keep], span_col[:n].long()[keep]]
    y = layer_norm_plain(x, ln_weight, ln_bias, eps)
    z = F.linear(y.float(), head_weight.float().reshape(1, d),
                 head_bias.float().reshape(1))[:, 0]
    out[perm[:n].long()[keep]] = torch.sigmoid(z)
    return out


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("span_head").span_head_launch
        fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 4
                       + [ctypes.c_void_p] * 4 + [ctypes.c_float]
                       + [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2
                       + [ctypes.c_void_p] * 2)
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(h, ln_weight, ln_bias, head_weight, head_bias, perm, row_eff,
           span_col, n) -> None:
    if h.dim() != 3:
        raise ValueError(f"h must be (R, L, d), got {tuple(h.shape)}")
    d = h.shape[2]
    for name, t in (("ln_weight", ln_weight), ("ln_bias", ln_bias),
                    ("head_weight", head_weight)):
        if t.numel() != d:
            raise ValueError(f"{name} must hold {d} values, got "
                             f"{t.numel()}")
    if head_bias.numel() != 1:
        raise ValueError("head_bias must hold one value")
    N = perm.shape[0]
    for name, t in (("perm", perm), ("row_eff", row_eff),
                    ("span_col", span_col)):
        if t.shape != (N,) or t.dtype != torch.int32:
            raise ValueError(f"{name} must be ({N},) int32")
    if not 0 <= n <= N:
        raise ValueError(f"n must be in [0, {N}], got {n}")
    devs = {t.device for t in (h, ln_weight, ln_bias, head_weight,
                               head_bias, perm, row_eff, span_col)}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")


def span_head_scatter(h: torch.Tensor, ln_weight: torch.Tensor,
                      ln_bias: torch.Tensor, head_weight: torch.Tensor,
                      head_bias: torch.Tensor, perm: torch.Tensor,
                      row_eff: torch.Tensor, span_col: torch.Tensor,
                      n: int, eps: float = LN_EPS) -> torch.Tensor:
    """``(N,)`` f32 span probabilities in original span order; see the
    module docstring. Nothing is synchronised."""
    global launches
    n = int(n)
    _check(h, ln_weight, ln_bias, head_weight, head_bias, perm, row_eff,
           span_col, n)
    dev = h.device
    if dev.type == "cpu":
        return span_head_scatter_plain(h, ln_weight, ln_bias, head_weight,
                                       head_bias, perm, row_eff, span_col,
                                       n, eps)
    if dev.type != "cuda":
        raise ValueError(f"span_head_scatter runs on cuda or cpu, not {dev}")
    if h.dtype not in _DTYPE_CODES:
        raise TypeError(f"h must be float32 or bfloat16, not {h.dtype}")
    params = (ln_weight, ln_bias, head_weight, head_bias)
    if any(t.dtype != torch.float32 for t in params):
        raise TypeError("LayerNorm and head parameters must be float32")
    if not all(t.is_contiguous() for t in (h, *params, perm, row_eff,
                                           span_col)):
        raise ValueError("span_head_scatter needs contiguous inputs")
    R, L, d = h.shape
    if d % 8 or not 0 < d <= MAX_D:
        raise ValueError(f"span_head_scatter takes d % 8 == 0 up to {MAX_D}, "
                         f"not {d}")
    if h.data_ptr() % 16:
        raise ValueError("span_head_scatter needs h 16-byte aligned")
    N = perm.shape[0]
    out = torch.empty(N, dtype=torch.float32, device=dev)
    if N == 0:
        return out
    fn = _kernel()
    with torch.cuda.device(dev):
        rc = fn(h.data_ptr(), _DTYPE_CODES[h.dtype], R, L, d,
                ln_weight.data_ptr(), ln_bias.data_ptr(),
                head_weight.data_ptr(), head_bias.data_ptr(), eps,
                perm.data_ptr(), row_eff.data_ptr(), span_col.data_ptr(), n,
                N, out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"span_head_scatter launch failed: CUDA error "
                           f"{rc}")
    with _count_lock:
        launches += 1
    return out


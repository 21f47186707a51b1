"""K11: the autoencoder's decoder LayerNorm + four heads + reconstruction error.

``recon_ce(dec, ln_weight, ln_bias, heads, categorical, continuous, mask,
loss_weights)`` takes the decoder's ``(M, d)`` output BEFORE ``dec_ln``
(M = T·L positions, working type) and returns the ``(M,)`` f32 weighted
reconstruction error of ``odigos_tpu/models/autoencoder.py``
``SpanAutoencoder._errors`` (:112-120):

    y   = dec_ln(dec)                 # f32 statistics, rounded to the
                                      # working type (Flax's dtype=bf16)
    err = w_s·ce(y W_s + b_s, cat[:, 0]) + w_n·ce(y W_n + b_n, cat[:, 1])
          + w_k·ce(y W_k + b_k, cat[:, 2]) + w_d·(y W_d + b_d - cont[:, 0])²

summed in that order, 0 at masked positions. ``heads`` is the four
``(weight (V, d), bias (V,))`` f32 pairs in the order service, name, kind,
duration (V = 1). Labels are clamped into their vocabularies (the
featurizer emits them in range).

With ``span_map`` (``(M,)`` int32, each position's original span index,
-1 at padding: K13's map) and ``n_out``, it also returns the ``(n_out,)``
f32 squashed scores ``1 - exp(-err)`` written at those indices, 0
elsewhere: ``_build_forward_spans``'s squash and inverse scatter
(``odigos_tpu/serving/fused.py:491-509``).

The LayerNorm is :func:`quant.layer_norm_plain`'s (exact f64 row sums), so
kernel and plain version normalise to the same bits; the heads' f32 dots
and the log-sum-exp are summed in another order (the kernel keeps an
online log-sum-exp and never writes the logits), so ``err`` agrees to
summation-order noise.

A CUDA tensor launches ``csrc/recon_ce.cu`` (masked positions skipped;
``d`` in 32, 64, 128, 256) or raises; a CPU tensor takes
:func:`recon_ce_plain`. ``launches`` counts the calls that launched.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from . import build
from .quant import layer_norm_plain

LN_EPS = 1e-6
WIDTHS = (32, 64, 128, 256)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
_count_lock = threading.Lock()
_fn = None

Heads = Sequence[tuple[torch.Tensor, torch.Tensor]]


def recon_ce_plain(dec: torch.Tensor, ln_weight: torch.Tensor,
                   ln_bias: torch.Tensor, heads: Heads,
                   categorical: torch.Tensor, continuous: torch.Tensor,
                   mask: torch.Tensor, loss_weights: Sequence[float],
                   span_map: Optional[torch.Tensor] = None, n_out: int = 0,
                   eps: float = LN_EPS):
    """The plain version, on the real positions only: the LayerNorm, four
    ``F.linear`` heads in f32, three ``F.cross_entropy`` and the squared
    error, summed in the reference's order."""
    M = dec.shape[0]
    err = torch.zeros(M, dtype=torch.float32, device=dec.device)
    real = torch.nonzero(mask).flatten()
    y = layer_norm_plain(dec[real], ln_weight, ln_bias, eps).float()
    logits = [F.linear(y, w.float(), b.float()) for w, b in heads]
    w_s, w_n, w_k, w_d = (float(w) for w in loss_weights)
    labels = categorical[real].long()

    def ce(h: int) -> torch.Tensor:
        lab = labels[:, h].clamp(0, logits[h].shape[1] - 1)
        return F.cross_entropy(logits[h], lab, reduction="none")

    e = w_s * ce(0)
    e = e + w_n * ce(1)
    e = e + w_k * ce(2)
    e = e + w_d * (logits[3][:, 0] - continuous[real, 0].float()) ** 2
    err[real] = e
    if span_map is None:
        return err
    scores = torch.zeros(n_out, dtype=torch.float32, device=dec.device)
    idx = span_map[real].long()
    keep = idx >= 0
    scores[idx[keep]] = 1.0 - torch.exp(-e[keep])
    return err, scores


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("recon_ce").recon_ce_launch
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                        ctypes.c_float] + [ctypes.c_void_p] * 8
                       + [ctypes.c_int] * 4
                       + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                          ctypes.c_int, ctypes.c_void_p]
                       + [ctypes.c_float] * 4 + [ctypes.c_void_p] * 4)
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(dec, ln_weight, ln_bias, heads, categorical, continuous, mask,
           loss_weights, span_map, n_out) -> None:
    if dec.dim() != 2:
        raise ValueError(f"dec must be (M, d), got {tuple(dec.shape)}")
    M, d = dec.shape
    for name, t in (("ln_weight", ln_weight), ("ln_bias", ln_bias)):
        if t.shape != (d,):
            raise ValueError(f"{name} must be ({d},), got {tuple(t.shape)}")
    if len(heads) != 4 or len(loss_weights) != 4:
        raise ValueError("recon_ce takes four heads and four loss weights "
                         "(service, name, kind, duration)")
    for i, (w, b) in enumerate(heads):
        if w.dim() != 2 or w.shape[1] != d or b.shape != (w.shape[0],) \
                or w.shape[0] < 1:
            raise ValueError(f"head {i}: weight must be (V, {d}) and bias "
                             f"(V,), got {tuple(w.shape)} {tuple(b.shape)}")
    if heads[3][0].shape[0] != 1:
        raise ValueError("the duration head has one output")
    if (categorical.dim() != 2 or categorical.shape[0] != M
            or categorical.shape[1] < 3 or categorical.dtype != torch.int32):
        raise ValueError(f"categorical must be ({M}, C >= 3) int32")
    if (continuous.dim() != 2 or continuous.shape[0] != M
            or continuous.dtype != torch.float32):
        raise ValueError(f"continuous must be ({M}, D) float32")
    if mask.shape != (M,) or mask.dtype != torch.bool:
        raise ValueError(f"mask must be ({M},) bool")
    if span_map is not None and (span_map.shape != (M,)
                                 or span_map.dtype != torch.int32):
        raise ValueError(f"span_map must be ({M},) int32")
    if n_out < 0:
        raise ValueError(f"n_out must be >= 0, got {n_out}")
    tensors = [dec, ln_weight, ln_bias, categorical, continuous, mask,
               *(t for pair in heads for t in pair)]
    if span_map is not None:
        tensors.append(span_map)
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")


def recon_ce(dec: torch.Tensor, ln_weight: torch.Tensor,
             ln_bias: torch.Tensor, heads: Heads, categorical: torch.Tensor,
             continuous: torch.Tensor, mask: torch.Tensor,
             loss_weights: Sequence[float],
             span_map: Optional[torch.Tensor] = None, n_out: int = 0,
             eps: float = LN_EPS):
    """``(M,)`` f32 errors, and with ``span_map`` also the ``(n_out,)``
    squashed scores by span; see the module docstring. Nothing is
    synchronised."""
    global launches
    n_out = int(n_out)
    _check(dec, ln_weight, ln_bias, heads, categorical, continuous, mask,
           loss_weights, span_map, n_out)
    dev = dec.device
    if dev.type == "cpu":
        return recon_ce_plain(dec, ln_weight, ln_bias, heads, categorical,
                              continuous, mask, loss_weights, span_map,
                              n_out, eps)
    if dev.type != "cuda":
        raise ValueError(f"recon_ce runs on cuda or cpu, not {dev}")
    if dec.dtype not in _DTYPE_CODES:
        raise TypeError(f"dec must be float32 or bfloat16, not {dec.dtype}")
    params = (ln_weight, ln_bias, *(t for pair in heads for t in pair))
    if any(t.dtype != torch.float32 for t in params):
        raise TypeError("LayerNorm and head parameters must be float32")
    M, d = dec.shape
    if d not in WIDTHS:
        raise ValueError(f"recon_ce takes d in {WIDTHS}, not {d}")
    ins = (dec, categorical, continuous, mask, *params) + (
        (span_map,) if span_map is not None else ())
    if not all(t.is_contiguous() for t in ins):
        raise ValueError("recon_ce needs contiguous inputs")
    if any(w.data_ptr() % 16 for w, _ in heads):
        raise ValueError("recon_ce needs 16-byte aligned head weights")
    err = torch.empty(M, dtype=torch.float32, device=dev)
    scores = None
    if span_map is not None:
        scores = torch.zeros(n_out, dtype=torch.float32, device=dev)
    if M > 0:
        fn = _kernel()
        (w0, b0), (w1, b1), (w2, b2), (w3, b3) = heads
        w_s, w_n, w_k, w_d = (float(w) for w in loss_weights)
        with torch.cuda.device(dev):
            rc = fn(dec.data_ptr(), _DTYPE_CODES[dec.dtype], M, d,
                    ln_weight.data_ptr(), ln_bias.data_ptr(), eps,
                    w0.data_ptr(), w1.data_ptr(), w2.data_ptr(),
                    w3.data_ptr(), b0.data_ptr(), b1.data_ptr(),
                    b2.data_ptr(), b3.data_ptr(), w0.shape[0], w1.shape[0],
                    w2.shape[0], w3.shape[0], categorical.data_ptr(),
                    categorical.shape[1], continuous.data_ptr(),
                    continuous.shape[1], mask.data_ptr(), w_s, w_n, w_k, w_d,
                    err.data_ptr(),
                    None if span_map is None else span_map.data_ptr(),
                    None if scores is None else scores.data_ptr(),
                    torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"recon_ce launch failed: CUDA error {rc}")
        with _count_lock:
            launches += 1
    return err if span_map is None else (err, scores)

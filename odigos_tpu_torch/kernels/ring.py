"""K22: one step of ring attention, a q-block against a kv-block.

``ring_block_attention(q, k, v, kv_mask, o, m, s, scale, finalize)`` is
``odigos_tpu/parallel/ring_attention.py`` ``_block_attention`` followed by
the streaming merge of ``_ring_body`` (alpha / beta), in place: the f32
accumulators ``o (B, Lq, H, D)``, ``m (B, H, Lq)`` (the running max) and
``s (B, H, Lq)`` (the running sum of exponentials) take the block's
contribution. ``q (B, Lq, H, D)`` is f32 or bf16 (read as f32, as the
reference's einsum promotes it), ``k, v (B, Lk, H, D)`` are f32 (the
reference casts them before its ring loop) and ``kv_mask (B, Lk)`` is bool
or uint8. A masked key's logit is the finite ``NEG_INF`` (-1e30) and its
weight is set to 0 explicitly, so a block whose every key is masked adds
nothing. ``finalize`` (the ring's last step) then writes
``o / max(s, 1e-30)`` over ``o``, the reference's output: a query that saw
no allowed key gives 0, never NaN. ``scale`` defaults to ``1 / D ** 0.5``,
multiplied into the logits after the product as the reference does (K1
divides q first; this is not K1's contract).

A CUDA tensor launches the hand-written kernel (``csrc/ring_attention.cu``:
both products on the tensor cores as split-operand TF32, three products a
pair of f32 operands, within the reference's 1e-5; an online softmax over
key tiles from the incoming state) or raises; head dims 1 to
``coverage.RING_MAX_HEAD_DIM`` (256). A CPU tensor takes
:func:`ring_block_attention_plain`, the reference's arithmetic in PyTorch
ops (the block's max first, then the merge), which is also what the
kernel is held to on the card. ``launches`` counts the
calls that launched.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from . import build, coverage

NEG_INF = -1e30      # the reference's fill for masked logits
SUM_FLOOR = 1e-30    # the reference's floor under the final division
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
_count_lock = threading.Lock()
_fn = None


def _check(q, k, v, kv_mask, o, m, s) -> None:
    if q.dim() != 4:
        raise ValueError(f"q must be (B, Lq, H, D), got {tuple(q.shape)}")
    B, Lq, H, D = q.shape
    if k.dim() != 4 or k.shape[0] != B or tuple(k.shape[2:]) != (H, D):
        raise ValueError(f"k must be (B, Lk, H, D) = ({B}, Lk, {H}, {D}), "
                         f"got {tuple(k.shape)}")
    if v.shape != k.shape:
        raise ValueError(f"v must match k {tuple(k.shape)}, got "
                         f"{tuple(v.shape)}")
    if kv_mask.shape != k.shape[:2]:
        raise ValueError(f"kv_mask must be (B, Lk) = {tuple(k.shape[:2])}, "
                         f"got {tuple(kv_mask.shape)}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"q must be float32 or bfloat16, not {q.dtype}")
    if kv_mask.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"kv_mask must be bool or uint8, not "
                        f"{kv_mask.dtype}")
    for name, t, shape in (("k", k, None), ("v", v, None),
                           ("o", o, (B, Lq, H, D)), ("m", m, (B, H, Lq)),
                           ("s", s, (B, H, Lq))):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, not {t.dtype}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got "
                             f"{tuple(t.shape)}")
    devices = {t.device for t in (q, k, v, kv_mask, o, m, s)}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {devices}")


def _merge(o, m, s, o_i, m_i, s_i) -> None:
    """The reference's streaming merge of a block's ``(o_i, m_i, s_i)``
    into the accumulators, in place."""
    m_new = torch.maximum(m, m_i)
    alpha = torch.exp(m - m_new)
    beta = torch.exp(m_i - m_new)
    o.mul_(alpha.transpose(1, 2)[..., None]).add_(
        o_i * beta.transpose(1, 2)[..., None])
    s.mul_(alpha).add_(s_i * beta)
    m.copy_(m_new)


def ring_block_attention_plain(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, kv_mask: torch.Tensor,
                               o: torch.Tensor, m: torch.Tensor,
                               s: torch.Tensor,
                               scale: Optional[float] = None,
                               finalize: bool = False) -> torch.Tensor:
    """The plain version: ``_block_attention`` (the block's logits, max,
    exponentials, sum and P.V in f32), the merge, and with ``finalize``
    the division. Updates ``o``, ``m`` and ``s`` in place; returns ``o``."""
    _check(q, k, v, kv_mask, o, m, s)
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    allowed = kv_mask.to(torch.bool)[:, None, None, :]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k) * scale
    logits = logits.masked_fill(~allowed, NEG_INF)
    m_i = logits.amax(dim=-1)
    p = torch.exp(logits - m_i[..., None]).masked_fill(~allowed, 0.0)
    s_i = p.sum(dim=-1)
    o_i = torch.einsum("bhqk,bkhd->bqhd", p, v)
    _merge(o, m, s, o_i, m_i, s_i)
    if finalize:
        o.div_(s.clamp(min=SUM_FLOOR).transpose(1, 2)[..., None])
    return o


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("ring_attention").ring_block_attention_launch
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def ring_block_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kv_mask: torch.Tensor, o: torch.Tensor,
                         m: torch.Tensor, s: torch.Tensor,
                         scale: Optional[float] = None,
                         finalize: bool = False) -> torch.Tensor:
    """K22: merge one kv-block into ``(o, m, s)`` in place (module
    docstring); returns ``o``. Nothing is synchronised."""
    global launches
    _check(q, k, v, kv_mask, o, m, s)
    if q.device.type == "cpu":
        return ring_block_attention_plain(q, k, v, kv_mask, o, m, s, scale,
                                          finalize)
    if q.device.type != "cuda":
        raise ValueError(f"ring_block_attention runs on cuda or cpu, not "
                         f"{q.device}")
    B, Lq, H, D = q.shape
    coverage.check_ring(D)
    if not all(t.is_contiguous() for t in (q, k, v, kv_mask, o, m, s)):
        raise ValueError("ring_block_attention needs contiguous tensors")
    if B == 0 or Lq == 0 or H == 0:
        return o
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    fn = _kernel()
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_mask.data_ptr(),
                o.data_ptr(), m.data_ptr(), s.data_ptr(), B, Lq, k.shape[1],
                H, D, _DTYPE_CODES[q.dtype], scale, int(bool(finalize)),
                torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ring_block_attention launch failed: CUDA error "
                           f"{rc}")
    with _count_lock:
        launches += 1
    return o

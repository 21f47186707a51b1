"""The trainer's gradients: one ``torch.autograd.Function`` a kernel.

The JAX package trains the transformer by XLA's autodiff of its jitted
forward (``odigos_tpu/training/trainer.py:171``). Here each device
computation of the encoder's forward is a hand-written kernel, so each
gets a Function whose forward is that kernel and whose backward is a
hand-written kernel too:

* :func:`layer_norm` — forward K14 ``ln_bf16``, backward K17 ``ln_bwd``;
* :func:`dense` — forward K15 ``gemm_bf16`` (the f32 route; FFN1 also
  writes its pre-activation), backward ``dX = dY . W`` and ``dW = dY^T .
  X`` as ``torch.mm`` (TF32 off, as the JAX package leaves these products
  to XLA outside any kernel), the bias gradient as a column sum, except
  FFN1's: there K19 ``gelu_tanh_bwd`` gives ``dPre`` and the bias
  gradient in one pass. Several weights (q, k and v) are one launch over
  their concatenation, their gradients split back into the parts;
* :func:`tp_epilogue` — a tensor-parallel block's row-parallel product:
  forward K23 on the all-reduced ``"partial"`` products (K15 writes each
  shard's through :func:`dense`, whose backward products are the same),
  backward the identity to the partials and the residual and the bias
  gradient as a column sum;
* :func:`attention` — forward K1 ``segment_attention`` with its
  log-sum-exp, backward K16 ``segment_attention_bwd``, on the fused QKV
  product's three planes;
* :func:`span_embed` — forward K2, backward K18 ``span_embed_bwd`` for the
  gathered tables; the continuous projection's ``(d, 3)`` weight and its
  bias get two small ``torch.mm``;
* :func:`ln_masked_pool` — the autoencoder's final LayerNorm + masked
  mean-pool: forward K12, backward K21 ``ln_masked_pool_bwd``;
* :func:`recon_ce` — the autoencoder's ``dec_ln``, four heads and
  reconstruction error: forward K11 (its f32 CUDA-core kernel, writing its
  log-sum-exps), backward K20 ``recon_ce_bwd`` (the gradient at
  ``dec_ln``'s output and the heads'), then K17 ``ln_bwd`` through
  ``dec_ln``.
* :func:`recon_ce_slice` — the same on a ``"model"`` axis (the service
  and name heads' rows sliced over it): forward each local shard's K11
  ``"slice"`` records, the axis's gather in rank order and K24
  ``vocab_ce_merge`` (writing the merged log-sum-exps), backward each
  shard's K20 ``"slice"``, the shards' ``dy`` summed over the axis, K17
  through ``dec_ln``; a sliced head's whole bias takes the shards' bias
  gradients gathered in rank order.

``reference=True`` runs every forward and backward through the plain
versions (a check on the card: the smoke run holds a step's gradients on
the kernels against it); a CPU tensor takes the plain versions anyway, in
any float type (f64 for the gradient checks). On the card the backward
kernels take f32 only (the trainer's working type): these Functions raise
for another type there.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from . import attention as _attn
from . import dense as _dense
from . import embed as _embed
from . import pool as _pool
from . import recon as _recon


def _trainable(x: torch.Tensor, what: str) -> None:
    if x.device.type == "cuda" and x.dtype != torch.float32:
        raise TypeError(f"{what}: the backward kernels take float32 on the "
                        f"card (the trainer's type), not {x.dtype}")


# ------------------------------------------------------------- LayerNorm
class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, eps, reference):
        ln = _dense.ln_bf16_plain if reference else _dense.ln_bf16
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        ctx.reference = reference
        return ln(x, weight, bias, eps)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        bwd = _dense.ln_bwd_plain if ctx.reference else _dense.ln_bwd
        dx, dw, db = bwd(x, weight, dy.contiguous(), ctx.eps)
        return dx, dw, db, None, None


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float, reference: bool = False) -> torch.Tensor:
    """K14's LayerNorm over ``x``'s last dimension, with K17 behind it."""
    _trainable(x, "layer_norm")
    return _LayerNorm.apply(x.contiguous(), weight, bias, eps, reference)


# ----------------------------------------------------------------- Dense
class _Dense(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, residual, epilogue, planes, reference, *params):
        # "partial" takes no bias: its params are the weights alone
        n = len(params) if epilogue == "partial" else len(params) // 2
        ws, bs = params[:n], params[n:]
        w = ws[0] if n == 1 else torch.cat(ws)
        b = None if not bs else bs[0] if n == 1 else torch.cat(bs)
        gemm = _dense.gemm_bf16_plain if reference else _dense.gemm_bf16
        pre = torch.empty((x.shape[0], w.shape[0]), dtype=x.dtype,
                          device=x.device) \
            if epilogue == "gelu_tanh" else None
        y = gemm(x, w, b, epilogue, residual, planes, pre=pre)
        ctx.save_for_backward(x, w, pre)
        ctx.sizes = [t.shape[0] for t in ws]
        ctx.epilogue = epilogue
        ctx.planes = planes
        ctx.reference = reference
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, pre = ctx.saved_tensors
        planes = ctx.planes
        N = w.shape[0]
        if ctx.epilogue == "gelu_tanh":
            bwd = (_dense.gelu_tanh_bwd_plain if ctx.reference
                   else _dense.gelu_tanh_bwd)
            dy, db = bwd(dy.contiguous(), pre)
        elif planes == 1 and ctx.epilogue != "partial":
            db = dy.sum(0)
        if planes == 1:
            dy = dy.contiguous()
            dx = torch.mm(dy, w)
            dw = torch.mm(dy.t(), x)
        else:  # (planes, M, N / planes): a product a plane
            pc = N // planes
            dx = torch.mm(dy[0], w[:pc])
            dw = torch.empty_like(w)
            db = torch.empty(N, dtype=dy.dtype, device=dy.device)
            for p in range(planes):
                if p:
                    dx.addmm_(dy[p], w[p * pc:(p + 1) * pc])
                torch.mm(dy[p].t(), x, out=dw[p * pc:(p + 1) * pc])
                torch.sum(dy[p], 0, out=db[p * pc:(p + 1) * pc])
        dres = dy if ctx.epilogue == "residual" else None
        dbs = () if ctx.epilogue == "partial" else torch.split(db, ctx.sizes)
        return (dx, dres, None, None, None, *torch.split(dw, ctx.sizes),
                *dbs)


def dense(x: torch.Tensor, weights: Sequence[torch.Tensor],
          biases: Sequence[torch.Tensor], epilogue: str = "none",
          residual: Optional[torch.Tensor] = None, planes: int = 1,
          reference: bool = False) -> torch.Tensor:
    """K15's ``epilogue(x . W^T + b)`` over ``W = [weights]`` stacked (one
    launch; ``planes`` as K15 splits its output), with the backward
    products, the bias sums and (FFN1) K19 behind it. ``"partial"``: no
    biases, the f32 product."""
    _trainable(x, "dense")
    return _Dense.apply(x.contiguous(), residual, epilogue, planes,
                        reference, *weights, *biases)


class _TpEpilogue(torch.autograd.Function):
    @staticmethod
    def forward(ctx, acc, b, residual, reference):
        epi = _dense.tp_epilogue_plain if reference else _dense.tp_epilogue
        ctx.res = residual is not None
        return epi(acc, b, residual)

    @staticmethod
    def backward(ctx, dy):
        return dy, dy.sum(0), dy if ctx.res else None, None


def tp_epilogue(acc: torch.Tensor, b: torch.Tensor,
                residual: Optional[torch.Tensor] = None,
                reference: bool = False) -> torch.Tensor:
    """K23 on the all-reduced partials, the bias and the residual (the
    trainer's type: f32, where every rounding is the identity, so the
    gradient passes to ``acc`` and the residual unchanged)."""
    _trainable(acc, "tp_epilogue")
    return _TpEpilogue.apply(acc.contiguous(), b, residual, reference)


# -------------------------------------------------------------- attention
class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, segments, reference):
        q, k, v = qkv[0], qkv[1], qkv[2]
        R, L, H, _ = q.shape
        lse = torch.empty((R, H, L), dtype=_attn._acc(q.dtype),
                          device=q.device)
        attend = (_attn.segment_attention_plain if reference
                  else _attn.segment_attention)
        o = attend(q, k, v, segments, lse)
        ctx.save_for_backward(qkv, segments, o, lse)
        ctx.reference = reference
        return o

    @staticmethod
    def backward(ctx, do):
        qkv, segments, o, lse = ctx.saved_tensors
        q, k, v = qkv[0], qkv[1], qkv[2]
        do = do.contiguous()
        if ctx.reference:
            g = torch.stack(_attn.segment_attention_bwd_plain(
                q, k, v, segments, o, lse, do))
        else:
            g = torch.empty_like(qkv)
            _attn.segment_attention_bwd(q, k, v, segments, o, lse, do,
                                        out=g)
        return g, None, None


def attention(qkv: torch.Tensor, segments: torch.Tensor,
              reference: bool = False) -> torch.Tensor:
    """K1 over ``qkv`` = q, k, v as the planes of one ``(3, R, L, H, hd)``
    tensor (the fused QKV product's output), with K16 behind it writing
    the three gradients into one such tensor."""
    _trainable(qkv, "attention")
    return _Attention.apply(qkv.contiguous(), segments, reference)


# ------------------------------------------------------- span embedding
class _SpanEmbed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, categorical, continuous, positions, segments,
                reference, dtype, service, name, kind, status, attr, cont_w,
                cont_b, pos):
        tables = _embed.EmbedTables(service, name, kind, status, attr,
                                    cont_w, cont_b, pos)
        embed = _embed.span_embed_plain if reference else _embed.span_embed
        ctx.save_for_backward(categorical, continuous, positions, segments,
                              service, name, kind, status, attr, cont_w,
                              cont_b, pos)
        ctx.reference = reference
        return embed(categorical, continuous, positions, segments, tables,
                     dtype)

    @staticmethod
    def backward(ctx, dy):
        (categorical, continuous, positions, segments,
         *tensors) = ctx.saved_tensors
        tables = _embed.EmbedTables(*tensors)
        bwd = (_embed.span_embed_bwd_plain if ctx.reference
               else _embed.span_embed_bwd)
        dy = dy.contiguous()
        g = bwd(dy, categorical, positions, segments, tables)
        # the continuous projection at the live slots: (d, 3) and (d,)
        d = dy.shape[-1]
        live = (segments > 0).reshape(-1).to(dy.dtype)
        cont = continuous.reshape(-1, 3).to(dy.dtype) * live[:, None]
        flat = dy.reshape(-1, d)
        d_cont_w = torch.mm(flat.t(), cont)
        d_cont_b = torch.mv(flat.t(), live)
        return (None, None, None, None, None, None, g.service, g.name,
                g.kind, g.status, g.attr, d_cont_w, d_cont_b, g.pos)


def span_embed(categorical: torch.Tensor, continuous: torch.Tensor,
               positions: torch.Tensor, segments: torch.Tensor,
               tables: _embed.EmbedTables, dtype: torch.dtype,
               reference: bool = False) -> torch.Tensor:
    """K2's embedded slots in ``dtype``, with K18 behind it."""
    _trainable(tables.service, "span_embed")
    if categorical.device.type == "cuda" and dtype != torch.float32:
        raise TypeError(f"span_embed: the backward kernels take float32 on "
                        f"the card, not {dtype}")
    t = tables
    return _SpanEmbed.apply(categorical, continuous, positions, segments,
                            reference, dtype, t.service, t.name, t.kind,
                            t.status, t.attr, t.cont_w, t.cont_b, t.pos)


# ------------------------------------------------ final LN + masked pool
class _LnMaskedPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, mask, eps, reference):
        pool = (_pool.ln_masked_pool_plain if reference
                else _pool.ln_masked_pool)
        ctx.save_for_backward(x, weight, mask)
        ctx.eps = eps
        ctx.reference = reference
        return pool(x, weight, bias, mask, eps)

    @staticmethod
    def backward(ctx, dpool):
        x, weight, mask = ctx.saved_tensors
        bwd = (_pool.ln_masked_pool_bwd_plain if ctx.reference
               else _pool.ln_masked_pool_bwd)
        dx, dw, db = bwd(x, weight, mask, dpool.contiguous(), ctx.eps)
        return dx, dw, db, None, None, None


def ln_masked_pool(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   mask: torch.Tensor, eps: float,
                   reference: bool = False) -> torch.Tensor:
    """K12's ``(T, d)`` pooled vectors of ``x`` ``(T, L, d)`` (the encoder
    before its final LayerNorm), with K21 behind it."""
    _trainable(x, "ln_masked_pool")
    return _LnMaskedPool.apply(x.contiguous(), weight, bias, mask, eps,
                               reference)


# ------------------------------------------ dec_ln + heads + the error
class _ReconCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dec, ln_w, ln_b, categorical, continuous, mask,
                loss_weights, eps, reference, *head_params):
        heads = list(zip(head_params[0::2], head_params[1::2]))
        lse = torch.empty((dec.shape[0], 3), dtype=_recon._acc(dec.dtype),
                          device=dec.device)
        if reference:
            err = _recon.recon_ce_plain(dec, ln_w, ln_b, heads, categorical,
                                        continuous, mask, loss_weights,
                                        eps=eps, lse=lse)
        else:
            err = _recon.recon_ce(dec, ln_w, ln_b, heads, categorical,
                                  continuous, mask, loss_weights, eps=eps,
                                  route="cuda_core", lse=lse)
        ctx.save_for_backward(dec, ln_w, ln_b, categorical, continuous, mask,
                              lse, *head_params)
        ctx.loss_weights = loss_weights
        ctx.eps = eps
        ctx.reference = reference
        return err

    @staticmethod
    def backward(ctx, derr):
        (dec, ln_w, ln_b, categorical, continuous, mask, lse,
         *head_params) = ctx.saved_tensors
        heads = list(zip(head_params[0::2], head_params[1::2]))
        ref = ctx.reference
        bwd = _recon.recon_ce_bwd_plain if ref else _recon.recon_ce_bwd
        g = bwd(dec, ln_w, ln_b, heads, lse, categorical, continuous, mask,
                derr.contiguous(), ctx.loss_weights, ctx.eps)
        ln_bwd = _dense.ln_bwd_plain if ref else _dense.ln_bwd
        ddec, dlnw, dlnb = ln_bwd(dec, ln_w, g.dy, ctx.eps)
        return (ddec, dlnw, dlnb, None, None, None, None, None, None,
                *(t for pair in g.heads for t in pair))


def recon_ce(dec: torch.Tensor, ln_weight: torch.Tensor,
             ln_bias: torch.Tensor,
             heads: Sequence[tuple[torch.Tensor, torch.Tensor]],
             categorical: torch.Tensor, continuous: torch.Tensor,
             mask: torch.Tensor, loss_weights: Sequence[float], eps: float,
             reference: bool = False) -> torch.Tensor:
    """K11's ``(M,)`` errors of the ``(M, d)`` decoder output ``dec``
    (before ``dec_ln``), with K20 and K17 behind them."""
    _trainable(dec, "recon_ce")
    return _ReconCE.apply(dec.contiguous(), ln_weight, ln_bias, categorical,
                          continuous, mask, tuple(loss_weights), eps,
                          reference, *(t for pair in heads for t in pair))


class _ReconCESlice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dec, ln_w, ln_b, categorical, continuous, mask,
                loss_weights, eps, reference, axis, slices, dy_heads,
                *head_params):
        shards = _shard_heads(head_params, slices)
        lse = torch.empty((dec.shape[0], 3), dtype=_recon._acc(dec.dtype),
                          device=dec.device)
        if reference:
            recs = [_recon.recon_ce_slice_plain(dec, ln_w, ln_b, heads,
                                                categorical, continuous,
                                                mask, vsl, eps)
                    for heads, vsl in zip(shards, slices)]
        else:
            recs = [_recon.recon_ce_slice(dec, ln_w, ln_b, heads, categorical,
                                          continuous, mask, vsl, eps,
                                          route="cuda_core")
                    for heads, vsl in zip(shards, slices)]
        merge = (_recon.vocab_ce_merge_plain if reference
                 else _recon.vocab_ce_merge)
        vs = tuple(h[0].shape[0] for h in shards[0][:2])
        err = merge(axis.gather(recs), categorical, mask, slices[0].vf, vs,
                    loss_weights, lse=lse)
        ctx.save_for_backward(dec, ln_w, ln_b, categorical, continuous, mask,
                              lse, *head_params)
        ctx.meta = (loss_weights, eps, reference, axis, slices, dy_heads)
        return err

    @staticmethod
    def backward(ctx, derr):
        (dec, ln_w, ln_b, categorical, continuous, mask, lse,
         *head_params) = ctx.saved_tensors
        loss_weights, eps, ref, axis, slices, dy_heads = ctx.meta
        shards = _shard_heads(head_params, slices)
        bwd = _recon.recon_ce_bwd_plain if ref else _recon.recon_ce_bwd
        gs = [bwd(dec, ln_w, ln_b, heads, lse, categorical, continuous, mask,
                  derr.contiguous(), loss_weights, eps, vsl, dyh)
              for heads, vsl, dyh in zip(shards, slices, dy_heads)]
        dy = axis.reduce([g.dy for g in gs])
        ln_bwd = _dense.ln_bwd_plain if ref else _dense.ln_bwd
        ddec, dlnw, dlnb = ln_bwd(dec, ln_w, dy, eps)
        # a sliced head's whole bias: every shard's rows, in rank order
        whole_db = {h: axis.gather([g.heads[h][1] for g in gs]).reshape(-1)
                    for h in range(2)
                    if shards[0][h][0].shape[0] < slices[0].vf[h]}
        grads = []
        for i, g in enumerate(gs):
            for h, (dw, db) in enumerate(g.heads):
                if h in whole_db:
                    db = whole_db[h] if i == 0 else whole_db[h].clone()
                grads += [dw, db]
        return (ddec, dlnw, dlnb, None, None, None, None, None, None, None,
                None, None, *grads)


def _shard_heads(head_params, slices) -> list:
    """Each local shard's four heads from its eight tensors, a sliced
    head's bias cut to the shard's rows."""
    out = []
    for i, vsl in enumerate(slices):
        t = head_params[8 * i:8 * i + 8]
        heads = []
        for h in range(4):
            w, b = t[2 * h], t[2 * h + 1]
            if h < 2 and w.shape[0] < vsl.vf[h]:
                b = b[vsl.lo[h]:vsl.lo[h] + w.shape[0]]
            heads.append((w, b))
        out.append(heads)
    return out


def recon_ce_slice(dec: torch.Tensor, ln_weight: torch.Tensor,
                   ln_bias: torch.Tensor,
                   shard_params: Sequence[Sequence[tuple[torch.Tensor,
                                                         torch.Tensor]]],
                   slices: Sequence[_recon.VocabSlice],
                   dy_heads: Sequence[int], axis,
                   categorical: torch.Tensor, continuous: torch.Tensor,
                   mask: torch.Tensor, loss_weights: Sequence[float],
                   eps: float, reference: bool = False) -> torch.Tensor:
    """K24's ``(M,)`` errors over a model axis ``axis`` from each local
    shard's K11 ``"slice"`` (``shard_params``: each shard's four heads'
    ``(weight, bias)``, a sliced head's weight its rows and its bias the
    WHOLE bias parameter; ``slices`` and ``dy_heads``: each shard's
    :class:`~.recon.VocabSlice` and K20 mask), with K20 ``"slice"``, the
    axis's sum of ``dy`` and K17 behind them."""
    _trainable(dec, "recon_ce_slice")
    params = [t for heads in shard_params for pair in heads for t in pair]
    return _ReconCESlice.apply(dec.contiguous(), ln_weight, ln_bias,
                               categorical, continuous, mask,
                               tuple(loss_weights), eps, reference, axis,
                               tuple(slices), tuple(dy_heads), *params)

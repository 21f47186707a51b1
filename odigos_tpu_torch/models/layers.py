"""Span embedding trunk + transformer encoder blocks as ``nn.Module``s.

Counterparts of ``odigos_tpu/models/layers.py`` (``SpanEmbedder``,
``EncoderBlock``, ``Encoder``), holding the same parameters under the
names ``models.convert.flax_to_torch`` maps onto. Flax's numerics are kept
where torch's defaults differ:

* ``nn.gelu`` is the tanh approximation (K15's ``gelu_tanh`` epilogue);
* ``nn.LayerNorm`` uses eps 1e-6 with statistics in f32, output in the
  working type;
* a Dense with ``dtype=bf16`` casts both input and kernel to bf16: the
  block's Linear layers hold their weights in the working type;
* embedding tables stay f32 (the gather-sum kernel reads them in f32 and
  rounds once).

Every device computation of the encoder goes through the port's kernels:
the embedding gather-sum (``kernels.embed.span_embed``, K2), the packed
attention (``kernels.attention.segment_attention``, K1), and the block's
dense chain (``kernels.dense``): each LayerNorm through K14 ``ln_bf16``,
each Dense through K15 ``gemm_bf16`` with what follows it fused into the
epilogue (the out-projection's and FFN2's residual add, FFN1's GELU), and
q, k and v as one K15 launch over the concatenated ``[W_q; W_k; W_v]``
(cached, rebuilt whenever a weight changes). The Dense rounding points are
Flax's: the product rounded to the working type, then the bias added in
it. The final LayerNorm is fused with the span head in ``kernels.head``
when the transformer scores through ``score_packed_scatter``.

A module in training mode (``.train()``) with gradients enabled runs the
block's one chain as the trainer's forward: the same kernels through the
``torch.autograd.Function``s of ``kernels.autograd`` (K14/K17, K15 with
the backward products and K19 for FFN1, K1/K16, K2/K18), which build the
graph the backward pass walks. There the fused QKV launch's gradient goes
back to ``query``, ``key`` and ``value`` (its ``dW`` and ``db`` split into
the three parts). Serving's modules are in eval mode and run under
``inference_mode``: their launches are unchanged.

**A block on a shard of the ``"model"`` axis** (``EncoderBlock(...,
tp=)``, the reference's ``PARTITION_RULES``): it holds ``H / tp`` heads
(its rows of ``[W_q; W_k; W_v]`` and their biases, its columns of
``W_out``) and ``d_ff / tp`` FFN columns (its rows of ``ff1`` with their
bias, its columns of ``ff2``); the LayerNorms and the ``out`` and ``ff2``
biases are whole. :func:`run_block` runs the blocks of a model axis's
local shards (``parallel/tp.py``): K14 once, each shard's fused QKV K15,
K1 on its heads and K15 ``"partial"`` for ``out``, the axis's sum of the
partials, K23 (the ``out`` bias and the residual added once, after the
sum), K14, each shard's K15 ``"gelu_tanh"`` and ``"partial"`` for FFN2,
the sum, K23. A group whose axis does not divide it (heads, or d_ff, not
a multiple of tp: the reference's mesh guard replicates it) runs whole on
every shard with no sum. ``fused_qkv`` is decided by the local width.
"""

from __future__ import annotations

import math
from typing import Any

import torch
from torch import nn

from ..kernels import autograd
from ..kernels.attention import segment_attention, segment_attention_plain
from ..kernels.dense import (gemm_bf16, gemm_bf16_plain, ln_bf16,
                             ln_bf16_plain, tp_epilogue, tp_epilogue_plain)
from ..kernels.embed import (EmbedTables, KIND_VOCAB, STATUS_VOCAB,
                             span_embed, span_embed_plain)

LN_EPS = 1e-6  # flax.linen.LayerNorm's default (torch's is 1e-5)


def _trains(module: nn.Module) -> bool:
    """The trainer's forward: training mode with gradients enabled."""
    return module.training and torch.is_grad_enabled()


class LayerNorm(nn.LayerNorm):
    """Flax LayerNorm: f32 statistics and params, eps 1e-6, output in
    ``out_dtype``, the working type its input arrives in (K14)."""

    def __init__(self, d: int, out_dtype: torch.dtype):
        super().__init__(d, eps=LN_EPS)
        self.out_dtype = out_dtype

    def forward(self, x: torch.Tensor, reference: bool = False,
                live: torch.Tensor | None = None,
                per: int = 1) -> torch.Tensor:
        """``live``/``per``: K14's device row count (rows at or past
        ``live[0] * per`` are padding, left unwritten)."""
        if _trains(self):
            return autograd.layer_norm(x.to(self.out_dtype), self.weight,
                                       self.bias, self.eps, reference)
        ln = ln_bf16_plain if reference else ln_bf16
        return ln(x.to(self.out_dtype), self.weight, self.bias, self.eps,
                  live, per)


class SpanEmbedder(nn.Module):
    """The categorical/continuous embedding tables of ``SpanEmbedder``.

    Column layout follows ``features.featurizer.CAT_FIELDS``: 0 service,
    1 name, 2 kind, 3 status, 4 parent_service (shares the service table),
    5.. attr slots (one shared attr table, summed). The sum itself runs in
    the ``span_embed`` kernel, called by :class:`Encoder`."""

    def __init__(self, service_vocab: int, name_vocab: int, attr_vocab: int,
                 attr_slots: int, d_model: int):
        super().__init__()
        self.service_embed = nn.Embedding(service_vocab, d_model)
        self.name_embed = nn.Embedding(name_vocab, d_model)
        self.kind_embed = nn.Embedding(KIND_VOCAB, d_model)
        self.status_embed = nn.Embedding(STATUS_VOCAB, d_model)
        # Flax creates the attr table only when attr columns exist
        self.attr_embed = nn.Embedding(attr_vocab, d_model) \
            if attr_slots > 0 else None
        self.cont_proj = nn.Linear(3, d_model)


class EncoderBlock(nn.Module):
    """Pre-LN bidirectional block: LN → MHA (segment-masked) → residual →
    LN → Dense(d_ff) → tanh-GELU → Dense(d) → residual."""

    def __init__(self, d_model: int, n_heads: int, d_ff: int,
                 dtype: torch.dtype, tp: int = 1):
        super().__init__()
        if d_model % n_heads:
            raise ValueError(f"d_model {d_model} not divisible by "
                             f"n_heads {n_heads}")
        # the mesh guard: an axis that does not divide the group's
        # dimension replicates the group (it runs whole on every shard)
        self.tp_attn = tp if n_heads % tp == 0 else 1
        self.tp_ffn = tp if d_ff % tp == 0 else 1
        self.n_heads = n_heads // self.tp_attn  # this shard's heads
        self.head_dim = d_model // n_heads
        width = self.n_heads * self.head_dim
        ff = d_ff // self.tp_ffn
        self.ln1 = LayerNorm(d_model, dtype)
        self.query = nn.Linear(d_model, width)
        self.key = nn.Linear(d_model, width)
        self.value = nn.Linear(d_model, width)
        self.out = nn.Linear(width, d_model)
        self.ln2 = LayerNorm(d_model, dtype)
        self.ff1 = nn.Linear(d_model, ff)
        self.ff2 = nn.Linear(ff, d_model)
        self._qkv: tuple = ((), (), None, None)  # key, held, weight, bias
        # K15 writes q, k, v as planes of 64-column boxes: a local width
        # off a multiple of 64 takes three launches instead
        self.fused_qkv = width % 64 == 0

    def dense_layers(self) -> list[nn.Linear]:
        return [self.query, self.key, self.value, self.out, self.ff1,
                self.ff2]

    def qkv(self) -> tuple[torch.Tensor, torch.Tensor]:
        """``[W_q; W_k; W_v]`` (3d, d) and its bias (3d,), for the one K15
        launch of the QKV product. Cached under the six tensors' addresses,
        types and version counters (the cache holds their storage, so an
        address is not reused while it is cached): a ``load_state_dict``,
        an in-place copy or a move rebuilds it. Parameters made under
        ``inference_mode`` count no versions: those are concatenated anew
        on every call."""
        parts = [t for lin in (self.query, self.key, self.value)
                 for t in (lin.weight, lin.bias)]
        key = None if any(t.is_inference() for t in parts) else tuple(
            (t.data_ptr(), t._version, t.dtype, t.device) for t in parts)
        if key is None or key != self._qkv[0]:
            # plain tensors even under inference_mode: usable outside it
            with torch.inference_mode(False), torch.no_grad():
                held = tuple(t.detach() for t in parts)
                w = torch.cat(held[0::2]).contiguous()
                b = torch.cat(held[1::2]).contiguous()
            self._qkv = (key, held, w, b)
        return self._qkv[2], self._qkv[3]

    def _ops(self, segments: torch.Tensor, reference: bool,
             live: torch.Tensor | None, L: int, trains: bool):
        """The block's ``dense(t, linears, epilogue, ...)`` and
        ``attend(qkv)``: the trainer's Functions (``trains``: training
        mode, gradients enabled), else the kernels (or their plain
        versions)."""
        if trains:
            def dense(t, lins, *args, **kw):
                bs = ([] if args and args[0] == "partial"
                      else [m.bias for m in lins])
                return autograd.dense(t, [m.weight for m in lins], bs,
                                      *args, reference=reference, **kw)

            def attend(qkv):
                if not torch.is_tensor(qkv):
                    qkv = torch.stack(qkv)
                return autograd.attention(qkv, segments, reference)
            return dense, attend
        gemm = gemm_bf16_plain if reference else gemm_bf16
        kernel = segment_attention_plain if reference else segment_attention

        def dense(t, lins, *args, **kw):
            w, b = self.qkv() if len(lins) == 3 else (lins[0].weight,
                                                      lins[0].bias)
            if args and args[0] == "partial":  # no bias, no row count
                return gemm(t, w, None, *args, **kw)
            return gemm(t, w, b, *args, live=live, per=L, **kw)

        def attend(qkv):
            return kernel(*qkv, segments)
        return dense, attend

    def attention_out(self, h: torch.Tensor, segments: torch.Tensor, R: int,
                      L: int, reference: bool, live: torch.Tensor | None,
                      epilogue: str = "partial",
                      residual: torch.Tensor | None = None,
                      trains: bool | None = None) -> torch.Tensor:
        """The attention sublayer after LN1 on this block's heads: the QKV
        product, K1, then the out-projection with ``epilogue``
        (``"residual"``: the whole sublayer; ``"partial"``: this shard's
        f32 share of the out-projection, no bias). ``trains``: the
        trainer's forward (default: this block's own mode)."""
        trains = _trains(self) if trains is None else trains
        dense, attend = self._ops(segments, reference, live, L, trains)
        H, hd = self.n_heads, self.head_dim
        # q, k, v as three contiguous (R, L, H, hd) planes: JAX's
        # DenseGeneral layout, K1's input
        parts = (self.query, self.key, self.value)
        if self.fused_qkv:
            qkv = dense(h, parts, planes=3).view(3, R, L, H, hd)
        else:
            qkv = [dense(h, (p,)).view(R, L, H, hd) for p in parts]
        a = attend(qkv).view(R * L, H * hd)
        return dense(a, (self.out,), epilogue, residual=residual)

    def ffn_out(self, h: torch.Tensor, segments: torch.Tensor, L: int,
                reference: bool, live: torch.Tensor | None,
                epilogue: str = "partial",
                residual: torch.Tensor | None = None,
                trains: bool | None = None) -> torch.Tensor:
        """FFN1 + GELU on this block's columns, then FFN2 with
        ``epilogue`` (as :meth:`attention_out`)."""
        trains = _trains(self) if trains is None else trains
        dense, _ = self._ops(segments, reference, live, L, trains)
        g = dense(h, (self.ff1,), "gelu_tanh")
        return dense(g, (self.ff2,), epilogue, residual=residual)

    def forward(self, x: torch.Tensor, segments: torch.Tensor,
                reference: bool = False,
                live: torch.Tensor | None = None) -> torch.Tensor:
        """``live``: the count of real packed rows, on the device (the
        fused routes'); the LayerNorms and the products leave the rows
        past it unwritten (the products: their row tiles past it). The
        trainer's forward (training mode, gradients enabled) runs the same
        chain through ``kernels.autograd``'s Functions, which take no row
        count; serving's calls the kernels directly, the fused QKV product
        on the cached ``[W_q; W_k; W_v]``. A block built for ``tp > 1``
        runs through :func:`run_block` with a model axis."""
        if self.tp_attn > 1 or self.tp_ffn > 1:
            raise ValueError("a block on a shard of the model axis runs "
                             "through run_block with its axis")
        R, L, d = x.shape
        x = x.reshape(R * L, d)
        h = self.ln1(x, reference, live, L)
        x = self.attention_out(h, segments, R, L, reference, live,
                               "residual", x)
        h = self.ln2(x, reference, live, L)
        x = self.ffn_out(h, segments, L, reference, live, "residual", x)
        return x.view(R, L, d)


def run_block(blocks: list[EncoderBlock], axis: Any, x: torch.Tensor,
              segments: torch.Tensor, reference: bool = False,
              live: torch.Tensor | None = None) -> torch.Tensor:
    """One encoder block over the shards ``blocks`` of a model axis
    (``axis.shards``, in order; one a rank under ``GroupModelAxis``, all of
    them under ``LocalModelAxis``): the module docstring's chain. The
    replicated parameters (the LayerNorms, the ``out`` and ``ff2``
    biases) are ``blocks[0]``'s. ``live`` reaches the LayerNorms and the
    column-parallel products; the partials and K23 take every row."""
    b0 = blocks[0]
    R, L, d = x.shape
    x = x.reshape(R * L, d)
    trains = _trains(b0)

    def finish(acc, bias, res):
        if trains:
            return autograd.tp_epilogue(acc, bias, res, reference)
        epi = tp_epilogue_plain if reference else tp_epilogue
        return epi(acc, bias, res)

    h = b0.ln1(x, reference, live, L)
    if b0.tp_attn > 1:
        hin = axis.enter(h)
        acc = axis.reduce([blk.attention_out(hin, segments, R, L, reference,
                                             live, trains=trains)
                           for blk in blocks])
        x = finish(acc, b0.out.bias, x)
    else:
        x = b0.attention_out(h, segments, R, L, reference, live, "residual",
                             x)
    h = b0.ln2(x, reference, live, L)
    if b0.tp_ffn > 1:
        hin = axis.enter(h)
        acc = axis.reduce([blk.ffn_out(hin, segments, L, reference, live,
                                       trains=trains) for blk in blocks])
        x = finish(acc, b0.ff2.bias, x)
    else:
        x = b0.ffn_out(h, segments, L, reference, live, "residual", x)
    return x.view(R, L, d)


class Encoder(nn.Module):
    """Embedding trunk + positional embedding + N blocks + final LN, over
    packed rows: ``segments`` (row-local trace ids, 0 = padding) makes
    attention block-diagonal, ``positions`` index the positional table."""

    def __init__(self, service_vocab: int, name_vocab: int, attr_vocab: int,
                 attr_slots: int, d_model: int, n_heads: int, n_layers: int,
                 d_ff: int, max_len: int, dtype: torch.dtype, tp: int = 1):
        super().__init__()
        self.dtype = dtype
        self.embed = SpanEmbedder(service_vocab, name_vocab, attr_vocab,
                                  attr_slots, d_model)
        self.pos_embed = nn.Embedding(max_len, d_model)
        self.blocks = nn.ModuleList(
            EncoderBlock(d_model, n_heads, d_ff, dtype, tp)
            for _ in range(n_layers))
        self.final_ln = LayerNorm(d_model, dtype)
        # a shard of the model axis: the axis and the encoders of its
        # local shards (this one first), set by the model that holds them
        self.model_axis: Any = None
        self.peers: list = []

    def tables(self) -> EmbedTables:
        e = self.embed
        return EmbedTables(
            service=e.service_embed.weight, name=e.name_embed.weight,
            kind=e.kind_embed.weight, status=e.status_embed.weight,
            attr=e.attr_embed.weight if e.attr_embed is not None else None,
            cont_w=e.cont_proj.weight, cont_b=e.cont_proj.bias,
            pos=self.pos_embed.weight)

    def forward(self, categorical: torch.Tensor, continuous: torch.Tensor,
                positions: torch.Tensor, segments: torch.Tensor,
                reference: bool = False, final_ln: bool = True,
                live: torch.Tensor | None = None) -> torch.Tensor:
        """``reference=True`` runs the plain versions of both kernels
        (the smoke run holds the kernel path against it on the card).
        ``final_ln=False`` returns the hidden state before ``final_ln``,
        for the span head kernel, which applies it at real spans only.
        ``live``: a ``(1,)`` int32 count of the real rows on the device;
        the blocks' LayerNorms (K14) and products (K15) skip the rows past
        it, which hold garbage (NaN from the plain versions) that no real
        slot reads."""
        if _trains(self):
            x = autograd.span_embed(categorical, continuous, positions,
                                    segments, self.tables(), self.dtype,
                                    reference)
        else:
            embed = span_embed_plain if reference else span_embed
            x = embed(categorical, continuous, positions, segments,
                      self.tables(), self.dtype)
        for i, blk in enumerate(self.blocks):
            if self.model_axis is None:
                x = blk(x, segments, reference=reference, live=live)
            else:
                x = run_block([e.blocks[i] for e in self.peers],
                              self.model_axis, x, segments, reference, live)
        if not final_ln:
            return x
        return self.final_ln(x, reference, live, x.shape[1])


# the standard deviation of a unit normal truncated to [-2, 2]: JAX's
# variance_scaling divides by it, so the truncated draws keep the variance
TRUNC_NORMAL_STD = 0.87962566103423978


def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Random init from an explicit generator, after Flax's defaults:
    embeddings N(0, 1/d), Dense kernels truncated-normal with variance
    1/fan_in after the truncation (lecun_normal: a normal of standard
    deviation ``1 / sqrt(fan_in) / TRUNC_NORMAL_STD`` cut at two of them),
    biases 0, LayerNorm scale 1 / bias 0. The draws differ from JAX's
    (another generator); tests that compare the two packages carry the
    weights across with ``flax_to_torch``."""
    for m in module.modules():
        if isinstance(m, nn.Embedding):
            nn.init.normal_(m.weight, std=1.0 / math.sqrt(m.weight.shape[1]),
                            generator=generator)
        elif isinstance(m, nn.Linear):
            std = 1.0 / math.sqrt(m.in_features) / TRUNC_NORMAL_STD
            nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std,
                                  generator=generator)
            nn.init.zeros_(m.bias)
        elif isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)

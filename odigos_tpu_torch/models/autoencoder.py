"""Span-sequence autoencoder (BASELINE config #4), in PyTorch.

Counterpart of ``odigos_tpu/models/autoencoder.py``: an unsupervised trace
model with a trace-level bottleneck. The encoder (``models/layers.py``)
reads each trace's spans, one trace per row; the masked mean-pool of its
output is projected to one latent vector per trace; per-position decoder
heads reconstruct each span's service, name, kind and log-duration from
the latent plus a positional embedding only, so a span that does not fit
its trace's structure reconstructs poorly and scores high. The score of a
span is its weighted reconstruction error (two cross-entropies, half a
third, and a squared error); the serving route squashes it to
``1 - exp(-err)``.

The device computations go through the port's kernels:

* the encoder's span embedding (K2) and attention (K1), with ``segments``
  the mask itself (one trace per row, segment id 1, padding 0), so K1's
  rule ``seg_q == seg_k > 0`` is the reference's ``mask_q & mask_k`` and
  K2's zeroing of ``segments == 0`` its ``x * mask``;
* the encoder's final LayerNorm and the masked mean-pool (K12,
  ``kernels.pool``): the encoder's output is read by nothing else, so it is
  never written;
* ``dec_ln``, the four f32 heads and the weighted error (K11,
  ``kernels.recon``), which never writes the logits; on the fused route it
  also squashes each score and writes it at the span's original index.

* the encoder blocks' LayerNorms and dense products (K14 and K15,
  ``kernels.dense``), and the decoder's ``dec_ff1`` + tanh-GELU and
  ``dec_ff2`` over every position (K15, the GELU in ``dec_ff1``'s
  epilogue).

A module in training mode (``.train()``) with gradients enabled runs the
trainer's forward (``loss_fn``): the same kernels through the
``torch.autograd.Function``s of ``kernels.autograd``, the encoder's as
``models/layers.py`` runs them, then K12 with K21 behind it, ``dec_ff1`` +
GELU and ``dec_ff2`` on K15 (K19 and the backward products behind them),
and K11's f32 kernel with its log-sum-exps, K20 and K17 behind it.
Serving's calls are in eval mode under ``inference_mode``: their launches
are unchanged.

``bottleneck`` and ``latent_proj``, one small product per trace, are left
to ``F.linear`` as the JAX package left them to XLA (so are the broadcast
add of ``dec_pos_embed`` and the loss's sum, with their gradients). The
decoder's dense layers hold their weights in the working type, as Flax's
``Dense(dtype=bf16)`` casts them. The rounding points of the reference
are kept: the pool is divided in the working type, ``dec_pos_embed`` is
cast to it and added to the latent projection in it, each Dense rounds its
product before adding its bias, and ``dec_ln``'s output is rounded to the
working type before the f32 heads.

``SpanAutoencoder(..., model_axis=)`` holds the shards of the ``"model"``
axis that a model axis (``parallel/tp.py``) places in this process, as
``TraceTransformer`` does: each shard's encoder blocks hold ``H / tp``
heads and ``d_ff / tp`` FFN columns (``models/layers.py``
:func:`~.layers.run_block`), its ``dec_ff1`` ``d_ff / tp`` columns (the rows
of its weight and bias) and ``dec_ff2`` the matching columns of its weight,
and the service and name heads :class:`VocabHead` slices: ``V / tp`` rows
of the weight and the WHOLE bias (the reference's ``P()``), K11 reading the
shard's rows of it. A group whose width the axis does not divide (the
reference's mesh guard) stays whole on every shard. The decoder then runs
each shard's K15 ``"gelu_tanh"`` on its columns and ``"partial"`` for
``dec_ff2``, the axis's sum of the partials and K23 with no residual; the
heads each shard's K11 ``"slice"`` (``kernels.recon.recon_ce_slice``), the
axis's gather of the shards' records in rank order and K24
(``recon.vocab_ce_merge``), so that every rank holds the same errors. In
training (``kernels.autograd.recon_ce_slice``) each shard's K20 ``"slice"``
gives its part of ``dy`` (a head every shard holds whole on the first shard
only), the parts are summed over the axis before K17, and each whole bias
of a sliced head takes the shards' bias gradients gathered in rank order,
so every replicated parameter's gradient is the same on every shard. The
fused route (squash and scatter) has no slice mode and is refused there.
Its weights are the whole model's, sliced by
``parallel.sharding.shard_state``: from the seed or from
:meth:`load_state_dict`, which takes the WHOLE state dict; ``module`` is the
first local shard and :meth:`state_dict` its.

Defaults match ``odigos_tpu.models.autoencoder.AutoencoderConfig``: d_model
128, d_latent 64, 2 heads, 2 layers, d_ff 512, max_len 64, vocabs
512/2048/4096, bf16 over f32 parameters, loss weights 1, 1, 0.5, 1.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Mapping, Optional

import torch
from torch import nn

from ..kernels import autograd
from ..kernels.dense import (gemm_bf16, gemm_bf16_plain, tp_epilogue,
                             tp_epilogue_plain)
from ..kernels.embed import KIND_VOCAB
from ..kernels.pool import ln_masked_pool, ln_masked_pool_plain
from ..kernels.recon import (HeadPlanes, VocabSlice, kernel_route, recon_ce,
                             recon_ce_plain, recon_ce_slice,
                             recon_ce_slice_plain, split_planes,
                             vocab_ce_merge, vocab_ce_merge_plain)
from ..kernels import coverage
from ..utils.device import resolve_device
from .layers import Encoder, LayerNorm, _trains, init_parameters
from .transformer import _as_tensor, load_module_state


@dataclass(frozen=True)
class AutoencoderConfig:
    service_vocab: int = 512
    name_vocab: int = 2048
    attr_vocab: int = 4096
    attr_slots: int = 0  # must match FeaturizerConfig.attr_slots
    d_model: int = 128
    d_latent: int = 64   # trace bottleneck width
    n_heads: int = 2
    n_layers: int = 2
    d_ff: int = 512
    max_len: int = 64
    dtype: torch.dtype = torch.bfloat16
    # reconstruction-loss weights: service CE, name CE, kind CE, duration MSE
    w_service: float = 1.0
    w_name: float = 1.0
    w_kind: float = 0.5
    w_duration: float = 1.0

    def tp_kernels(self) -> dict[str, tuple[str, tuple[int, int]]]:
        """The groups this model adds to the encoder's on the ``"model"``
        axis, each with the Flax kernel the reference's rules guard it on
        (``parallel.sharding.group_tp``): the decoder FFN and the service
        and name heads."""
        return {"dec_ff": ("dec_ff1/kernel", (self.d_model, self.d_ff)),
                "service": ("service_head/kernel",
                            (self.d_model, self.service_vocab)),
                "name": ("name_head/kernel",
                         (self.d_model, self.name_vocab))}


class VocabHead(nn.Module):
    """A vocabulary head on a shard of the ``"model"`` axis: its rows
    ``[lo, lo + V / ways)`` of the whole head's ``(V, d)`` weight and the
    whole ``(V,)`` bias (the reference's ``P()`` on a Dense bias)."""

    def __init__(self, d: int, V: int, ways: int, rank: int):
        super().__init__()
        self.rows = V // ways
        self.lo = rank * self.rows
        self.weight = nn.Parameter(torch.zeros(self.rows, d))
        self.bias = nn.Parameter(torch.zeros(V))

    def pair(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The weight and this shard's rows of the bias, K11's head."""
        return self.weight, self.bias[self.lo:self.lo + self.rows]


class _AutoencoderModule(nn.Module):
    def __init__(self, cfg: AutoencoderConfig, tp: int = 1, rank: int = 0):
        super().__init__()
        c = cfg
        self.encoder = Encoder(c.service_vocab, c.name_vocab, c.attr_vocab,
                               c.attr_slots, c.d_model, c.n_heads,
                               c.n_layers, c.d_ff, c.max_len, c.dtype, tp)
        self.bottleneck = nn.Linear(c.d_model, c.d_latent)
        self.dec_pos_embed = nn.Embedding(c.max_len, c.d_model)
        self.latent_proj = nn.Linear(c.d_latent, c.d_model)
        # the decoder FFN's group and the two vocabulary heads' on the axis:
        # tp, or 1 where the reference's mesh guard keeps the group whole
        from ..parallel.sharding import group_tp

        groups = group_tp(c, {"model": tp})
        self.tp_dec = groups["dec_ff"]
        self.dec_ff1 = nn.Linear(c.d_model, c.d_ff // self.tp_dec)
        self.dec_ff2 = nn.Linear(c.d_ff // self.tp_dec, c.d_model)
        self.dec_ln = LayerNorm(c.d_model, c.dtype)
        self.rank = rank
        self.tp_heads = (groups["service"], groups["name"])
        self.service_head, self.name_head = (
            VocabHead(c.d_model, V, ways, rank) if ways > 1
            else nn.Linear(c.d_model, V)
            for V, ways in zip((c.service_vocab, c.name_vocab),
                               self.tp_heads))
        self.kind_head = nn.Linear(c.d_model, KIND_VOCAB)
        self.duration_head = nn.Linear(c.d_model, 1)
        self._planes: tuple = ((), (), None)  # key, held, planes

    def dense_layers(self) -> list[nn.Linear]:
        """The decoder's products in the working type."""
        return [self.bottleneck, self.latent_proj, self.dec_ff1,
                self.dec_ff2]

    def heads(self) -> list[tuple[torch.Tensor, torch.Tensor]]:
        """The four f32 heads in K11's order: service, name, kind,
        duration (a sliced head's rows of its bias)."""
        return [h.pair() if isinstance(h, VocabHead) else (h.weight, h.bias)
                for h in (self.service_head, self.name_head, self.kind_head,
                          self.duration_head)]

    def head_params(self) -> list[tuple[torch.Tensor, torch.Tensor]]:
        """The four heads' parameters, a sliced head's whole bias."""
        return [(h.weight, h.bias) for h in (
            self.service_head, self.name_head, self.kind_head,
            self.duration_head)]

    def vocab_slice(self) -> VocabSlice:
        """This shard's rows of the service and name heads."""
        heads = (self.service_head, self.name_head)
        return VocabSlice(
            tuple(h.bias.shape[0] for h in heads),
            tuple(h.lo if isinstance(h, VocabHead) else 0 for h in heads))

    def dy_heads(self) -> int:
        """K20's ``dy_heads`` on this shard: its sliced heads, and the
        heads every shard holds whole on the first shard only."""
        first = self.rank == 0
        bits = 12 if first else 0  # kind and duration: always whole
        for h, ways in enumerate(self.tp_heads):
            if ways > 1 or first:
                bits |= 1 << h
        return bits

    def head_planes(self) -> Optional[HeadPlanes]:
        """K11's three bf16 planes of the service and name heads
        (``kernels.recon.split_planes``; None where the split cannot hold
        them, and K11 then runs its CUDA-core kernel), cached as the
        blocks' QKV weight is: under the four tensors' addresses, types and
        version counters, so a ``load_state_dict``, an in-place copy or a
        move rebuilds them; parameters made under ``inference_mode`` count
        no versions and are split anew on every call."""
        parts = [t for pair in self.heads()[:2] for t in pair]
        key = None if any(t.is_inference() for t in parts) else tuple(
            (t.data_ptr(), t._version, t.dtype, t.device) for t in parts)
        if key is None or key != self._planes[0]:
            # plain tensors even under inference_mode: usable outside it
            with torch.inference_mode(False), torch.no_grad():
                held = tuple(t.detach() for t in parts)
                planes = split_planes([held[:2], held[2:]])
            self._planes = (key, held, planes)
        return self._planes[2]


class SpanAutoencoder:
    """Model + device: init from a seed (an explicit ``torch.Generator``,
    never the global one), load weights, score.

    ``device`` defaults to ``"cuda"`` and raises if CUDA is absent; pass
    ``"cpu"`` to run the plain versions of the kernels on the CPU.
    Scoring methods take numpy arrays or tensors and return tensors on
    the model's device without synchronising (the caller fetches).
    """

    def __init__(self, config: Optional[AutoencoderConfig] = None,
                 device: str | torch.device = "cuda", seed: int = 0,
                 model_axis: Any = None):
        self.cfg = config or AutoencoderConfig()
        if self.cfg.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"working dtype must be float32 or bfloat16, "
                             f"not {self.cfg.dtype}")
        self.device = resolve_device(device)
        self.model_axis = model_axis
        tp = 1 if model_axis is None else model_axis.tp
        if self.device.type == "cuda":  # no plain route on the card
            coverage.check(self.cfg, tp)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        module = _AutoencoderModule(self.cfg)
        init_parameters(module, torch.Generator().manual_seed(seed))
        shards = [module]
        if model_axis is not None:  # the seed's draws, sliced
            state = module.state_dict()
            shards = [_AutoencoderModule(self.cfg, tp, r)
                      for r in model_axis.shards]
            self._load_shards(shards, state)
        for m in shards:
            for lin in m.dense_layers() + [
                    lin for blk in m.encoder.blocks
                    for lin in blk.dense_layers()]:
                lin.to(self.cfg.dtype)
            m.to(self.device).eval()
        self.shards = shards
        self.module = shards[0]
        if model_axis is not None:
            self.module.encoder.model_axis = model_axis
            self.module.encoder.peers = [m.encoder for m in shards]

    # ------------------------------------------------------------ weights
    def state_dict(self) -> dict[str, torch.Tensor]:
        """The state dict of the first local shard (the whole model's
        without a model axis)."""
        return self.module.state_dict()

    def _load_shards(self, shards: list, state: Mapping[str, Any]) -> None:
        from ..parallel.sharding import shard_state

        tp = self.model_axis.tp
        for r, m in zip(self.model_axis.shards, shards):
            load_module_state(m, shard_state(state, {"model": tp}, self.cfg,
                                             rank=r))

    def load_state_dict(self, state: Mapping[str, Any]) -> None:
        """Load a state dict (tensors or numpy arrays) of the WHOLE model;
        each value is cast to the parameter's own dtype and device, and
        under a model axis each local shard takes its slice."""
        if self.model_axis is None:
            load_module_state(self.module, state)
        else:
            self._load_shards(self.shards, state)

    def parameters(self) -> list[torch.nn.Parameter]:
        """Every local shard's parameters (the replicated ones of the
        shards past the first take part in the heads only)."""
        return [p for m in self.shards for p in m.parameters()]

    def train(self, mode: bool = True) -> None:
        """Every local shard into training (or eval) mode."""
        for m in self.shards:
            m.train(mode)

    # ------------------------------------------------------------ scoring
    def _inputs(self, categorical: Any, continuous: Any, mask: Any):
        dev = self.device
        return (_as_tensor(categorical, torch.int32, dev),
                _as_tensor(continuous, torch.float32, dev),
                _as_tensor(mask, torch.bool, dev))

    def _decoder_input(self, cat: torch.Tensor, cont: torch.Tensor,
                       mask: torch.Tensor, reference: bool,
                       live: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Encoder, K12 pool, bottleneck, latent projection plus
        ``dec_pos_embed``: the ``(T·L, d)`` rows ``dec_ff1`` reads. With
        ``live`` (K13's trace count) K12 reads no row past it and writes
        zeros there, so the bottleneck reads defined rows."""
        m = self.module
        T, L = mask.shape
        seg = mask.to(torch.int32).contiguous()
        pos = torch.arange(L, dtype=torch.int32, device=mask.device).expand(
            T, L).contiguous()
        h = m.encoder(cat, cont, pos, seg, reference=reference,
                      final_ln=False, live=live)
        ln = m.encoder.final_ln
        if _trains(m):
            pooled = autograd.ln_masked_pool(h, ln.weight, ln.bias, mask,
                                             ln.eps, reference)
        else:
            pool = ln_masked_pool_plain if reference else ln_masked_pool
            pooled = pool(h, ln.weight, ln.bias, mask, ln.eps, live=live)
        z = m.bottleneck(pooled)
        pos_e = m.dec_pos_embed.weight[:L].to(self.cfg.dtype)
        return (m.latent_proj(z)[:, None, :] + pos_e).reshape(T * L, -1)

    def _decode(self, cat: torch.Tensor, cont: torch.Tensor,
                mask: torch.Tensor, reference: bool,
                live: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The decoder up to ``dec_ln``, K15 twice (the GELU in
        ``dec_ff1``'s epilogue): the ``(T·L, d)`` rows K11 reads (with
        ``live``, K11 reads no row of a trace past the count, and K15
        skips their row tiles)."""
        m = self.module
        x = self._decoder_input(cat, cont, mask, reference, live)
        if m.tp_dec > 1:
            return self._decode_sharded(x, reference)
        if _trains(m):
            x = autograd.dense(x, [m.dec_ff1.weight], [m.dec_ff1.bias],
                               "gelu_tanh", reference=reference)
            return autograd.dense(x, [m.dec_ff2.weight], [m.dec_ff2.bias],
                                  reference=reference)
        gemm = gemm_bf16_plain if reference else gemm_bf16
        L = mask.shape[1]
        dec = gemm(x, m.dec_ff1.weight, m.dec_ff1.bias, "gelu_tanh",
                   live=live, per=L)
        return gemm(dec, m.dec_ff2.weight, m.dec_ff2.bias, live=live, per=L)

    def _decode_sharded(self, x: torch.Tensor,
                        reference: bool) -> torch.Tensor:
        """The decoder FFN over the model axis: each shard's ``dec_ff1``
        columns with the GELU (K15 ``"gelu_tanh"``) and its f32 share of
        ``dec_ff2`` (K15 ``"partial"``), the axis's sum, then K23 with the
        ``dec_ff2`` bias and no residual."""
        axis, m0 = self.model_axis, self.module
        if _trains(m0):
            xin = axis.enter(x)
            parts = [autograd.dense(
                autograd.dense(xin, [m.dec_ff1.weight], [m.dec_ff1.bias],
                               "gelu_tanh", reference=reference),
                [m.dec_ff2.weight], [], "partial", reference=reference)
                for m in self.shards]
            return autograd.tp_epilogue(axis.reduce(parts), m0.dec_ff2.bias,
                                        None, reference)
        gemm = gemm_bf16_plain if reference else gemm_bf16
        parts = [gemm(gemm(x, m.dec_ff1.weight, m.dec_ff1.bias, "gelu_tanh"),
                      m.dec_ff2.weight, None, "partial")
                 for m in self.shards]
        epi = tp_epilogue_plain if reference else tp_epilogue
        return epi(axis.reduce(parts), m0.dec_ff2.bias, None)

    def _errors(self, cat, cont, mask, reference: bool, span_map=None,
                n_out: int = 0, live: Optional[torch.Tensor] = None):
        c = self.cfg
        T, L = mask.shape
        if self.model_axis is not None and span_map is not None:
            raise ValueError("the fused route's squash and scatter has no "
                             "model-axis mode (K11 'slice' writes records); "
                             "score a model axis through score_spans")
        dec = self._decode(cat, cont, mask, reference, live)
        if self.model_axis is not None:
            return self._errors_sliced(dec, cat, cont, mask, reference)
        ln = self.module.dec_ln
        args = (dec, ln.weight, ln.bias, self.module.heads(),
                cat.reshape(T * L, -1), cont.reshape(T * L, -1),
                mask.reshape(T * L),
                (c.w_service, c.w_name, c.w_kind, c.w_duration))
        if _trains(self.module):
            return autograd.recon_ce(*args, ln.eps, reference)
        if reference:
            return recon_ce_plain(*args, span_map=span_map, n_out=n_out,
                                  eps=ln.eps)
        if not dec.is_cuda:
            return recon_ce(*args, span_map=span_map, n_out=n_out,
                            eps=ln.eps)
        planes = (self.module.head_planes()
                  if dec.dtype == torch.bfloat16 else None)
        return recon_ce(*args, span_map=span_map, n_out=n_out, eps=ln.eps,
                        planes=planes,
                        route=kernel_route(dec.dtype, planes is not None))

    def _errors_sliced(self, dec, cat, cont, mask, reference: bool):
        """The heads over the model axis: each shard's K11 ``"slice"``
        records, their gather over the axis in rank order and K24's merge
        (the trainer's forward: ``autograd.recon_ce_slice``, with K20
        ``"slice"``, the sum of ``dy`` and K17 behind it)."""
        c = self.cfg
        T, L = mask.shape
        m0 = self.module
        ln = m0.dec_ln
        weights = (c.w_service, c.w_name, c.w_kind, c.w_duration)
        args = (cat.reshape(T * L, -1), cont.reshape(T * L, -1),
                mask.reshape(T * L))
        slices = [m.vocab_slice() for m in self.shards]
        if _trains(m0):
            return autograd.recon_ce_slice(
                dec, ln.weight, ln.bias,
                [m.head_params() for m in self.shards],
                slices, [m.dy_heads() for m in self.shards], self.model_axis,
                *args, weights, ln.eps, reference)
        recs = []
        for m, vsl in zip(self.shards, slices):
            if reference or not dec.is_cuda:
                fn = recon_ce_slice_plain if reference else recon_ce_slice
                recs.append(fn(dec, ln.weight, ln.bias, m.heads(), *args,
                               vsl, ln.eps))
                continue
            planes = m.head_planes() if dec.dtype == torch.bfloat16 else None
            recs.append(recon_ce_slice(
                dec, ln.weight, ln.bias, m.heads(), *args, vsl, ln.eps,
                planes=planes,
                route=kernel_route(dec.dtype, planes is not None)))
        merge = vocab_ce_merge_plain if reference else vocab_ce_merge
        vf = slices[0].vf
        vs = tuple(h[0].shape[0] for h in m0.heads()[:2])
        return merge(self.model_axis.gather(recs), args[0], args[2], vf, vs,
                     weights)

    @property
    def recon_route(self) -> str:
        """K11's kernel on the card for the loaded weights
        (``kernels.recon.kernel_route``): ``"tc"`` for bf16 heads the three
        planes hold, ``"cuda_core"`` for f32 or heads they cannot (the
        split is made when the weights change, never on a launch)."""
        planes = (self.module.head_planes()
                  if self.cfg.dtype == torch.bfloat16 else None)
        return kernel_route(self.cfg.dtype, planes is not None)

    @torch.inference_mode()
    def span_errors(self, categorical: Any, continuous: Any, mask: Any,
                    reference: bool = False) -> torch.Tensor:
        """``(T, L)`` f32 weighted reconstruction error per span, 0 at
        padding: what the engine's host route scores. ``reference=True``
        runs the plain versions of every kernel instead (a check, not a
        route)."""
        cat, cont, m = self._inputs(categorical, continuous, mask)
        return self._errors(cat, cont, m, reference).view(m.shape)

    @torch.inference_mode()
    def score_spans(self, categorical: Any, continuous: Any, mask: Any,
                    reference: bool = False
                    ) -> tuple[torch.Tensor, torch.Tensor]:
        """``(T, L)`` span errors and the ``(T,)`` per-trace mean error
        (over the real spans, 1 where a row has none)."""
        cat, cont, m = self._inputs(categorical, continuous, mask)
        err = self._errors(cat, cont, m, reference).view(m.shape)
        denom = m.sum(-1).clamp(min=1).float()
        return err, err.sum(-1) / denom

    @torch.inference_mode()
    def score_spans_scatter(self, categorical: Any, continuous: Any,
                            mask: Any, span_map: torch.Tensor, n_out: int,
                            reference: bool = False,
                            live: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
        """The fused route's forward: every real slot's squashed score
        ``1 - exp(-err)`` written at ``span_map`` (K13's original span
        index, -1 at padding) of an ``(n_out,)`` f32 output, 0 elsewhere
        (spans truncated from their trace stay 0). ``live``: K13's ``(1,)``
        count of filled rows on the device; the encoder's LayerNorms skip
        the rows past it (K12 and K11 read only real positions)."""
        cat, cont, m = self._inputs(categorical, continuous, mask)
        smap = _as_tensor(span_map, torch.int32, self.device)
        _, scores = self._errors(cat, cont, m, reference,
                                 span_map=smap.reshape(-1), n_out=n_out,
                                 live=live)
        return scores

    def loss_terms(self, categorical: Any, continuous: Any, mask: Any,
                   span_labels: Any = None, trace_labels: Any = None,
                   reference: bool = False
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        """The sum :meth:`loss_fn` divides and its count: ``(the masked
        reconstruction error summed, real spans)`` (labels ignored: the
        model is unsupervised). The sharded train step all-reduces the
        count over the data axis to take the loss over the global batch.
        With the module in training mode and gradients enabled it has a
        graph behind it."""
        cat, cont, m = self._inputs(categorical, continuous, mask)
        err = self._errors(cat, cont, m, reference)
        return err.sum(), m.sum().float()

    def loss_fn(self, categorical: Any, continuous: Any, mask: Any,
                reference: bool = False) -> torch.Tensor:
        """The reference's ``loss_fn``: the mean masked reconstruction
        error (``odigos_tpu/models/autoencoder.py:129-136``; no labels: the
        model is unsupervised). With the module in training mode and
        gradients enabled (the trainer's forward) it has a graph behind it,
        else it runs under ``inference_mode``. ``reference=True``: the
        plain versions of every kernel, forward and backward."""
        if _trains(self.module):
            return self._loss(categorical, continuous, mask, reference)
        with torch.inference_mode():
            return self._loss(categorical, continuous, mask, reference)

    def _loss(self, categorical, continuous, mask, reference: bool
              ) -> torch.Tensor:
        total, n = self.loss_terms(categorical, continuous, mask,
                                   reference=reference)
        return total / n.clamp(min=1.0)

"""Trace transformer classifier — the flagship scoring model, in PyTorch.

Counterpart of ``odigos_tpu/models/transformer.py``: a bidirectional
transformer over the spans of each trace, emitting a per-span anomaly
logit and a per-trace logit (masked mean-pool head). ``score_packed``
scores packed rows (several traces per row, block-diagonal attention) and
is what the engine's host route runs; ``score_packed_scatter``, the fused
route's, does the same and writes each real span's probability to its
original index through the span head kernel (K8); ``score_spans`` scores
one trace per row.

Defaults match ``odigos_tpu.models.transformer.TransformerConfig``: d_model
256, 4 heads, 4 layers, d_ff 1024, max_len 64, vocabs 512/2048/4096, working
dtype bfloat16 over f32 parameters. The heads run in f32, as in the JAX
model.

``logits`` and ``loss_fn`` are the trainer's (``training/trainer.py``):
with the module in training mode and gradients enabled, the encoder runs
through ``kernels.autograd``'s Functions and the loss is the reference's
``loss_fn`` (masked span BCE plus trace BCE weighted by trace validity);
the heads and the trace pool stay f32 PyTorch ops, as in scoring.

``TraceTransformer(..., model_axis=)`` holds the shards of the ``"model"``
axis that a model axis (``parallel/tp.py``) places in this process, each
a module at the shard's geometry (``H / tp`` heads, ``d_ff / tp`` FFN
columns; ``models/layers.py`` :func:`~.layers.run_block`): one under
``GroupModelAxis``, every one under ``LocalModelAxis``. Its weights are
the whole model's, sliced by ``parallel.sharding.shard_state``: from the
seed (the unsharded model's draws) or from :meth:`load_state_dict`, which
takes the WHOLE state dict. ``module`` is the first local shard (the
replicated embedding, LayerNorms and heads are its), ``shards`` all of
them, and :meth:`state_dict` the first shard's.

Float32 matmuls run in full f32: constructing a model sets
``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` to False (TF32 keeps ~3 decimal digits,
which would break parity with the f32 reference).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from ..kernels.head import span_head_scatter, span_head_scatter_plain
from ..kernels import coverage
from ..utils.device import resolve_device
from .layers import Encoder, init_parameters


@dataclass(frozen=True)
class TransformerConfig:
    service_vocab: int = 512
    name_vocab: int = 2048
    attr_vocab: int = 4096
    attr_slots: int = 0  # must match FeaturizerConfig.attr_slots
    d_model: int = 256
    n_heads: int = 4
    n_layers: int = 4
    d_ff: int = 1024
    max_len: int = 64
    dtype: torch.dtype = torch.bfloat16

    def tp_kernels(self) -> dict[str, tuple[str, tuple[int, int]]]:
        """The groups this model adds to the encoder's on the ``"model"``
        axis (``parallel.sharding.group_tp``): none."""
        return {}


class _TraceTransformerModule(nn.Module):
    def __init__(self, cfg: TransformerConfig, tp: int = 1):
        super().__init__()
        c = cfg
        self.encoder = Encoder(c.service_vocab, c.name_vocab, c.attr_vocab,
                               c.attr_slots, c.d_model, c.n_heads,
                               c.n_layers, c.d_ff, c.max_len, c.dtype, tp)
        self.span_head = nn.Linear(c.d_model, 1)
        self.trace_head = nn.Linear(c.d_model, 1)

    def span_logits(self, h: torch.Tensor) -> torch.Tensor:
        return self.span_head(h.float())[..., 0]  # f32 head

    def trace_logits(self, h: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
        denom = mask.sum(-1, keepdim=True).clamp(min=1)
        pooled = (h * mask[..., None].to(h.dtype)).sum(-2) / denom.to(h.dtype)
        return self.trace_head(pooled.float())[..., 0]


def load_module_state(module: nn.Module, state: Mapping[str, Any]) -> None:
    """Copy a state dict (tensors or numpy arrays) into ``module``, each
    value cast to the parameter's own dtype and device; every name must
    match both ways and every shape agree, or it raises."""
    own = module.state_dict()
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise KeyError(f"state dict mismatch: missing {missing}, "
                       f"unexpected {extra}")
    with torch.no_grad():
        for name, value in state.items():
            t = torch.as_tensor(np.asarray(value)) \
                if not isinstance(value, torch.Tensor) else value
            if t.shape != own[name].shape:
                raise ValueError(f"{name}: shape {tuple(t.shape)} != "
                                 f"{tuple(own[name].shape)}")
            own[name].copy_(t)


def _as_tensor(x: Any, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    t = torch.as_tensor(x) if isinstance(x, np.ndarray) else x
    return t.to(device=device, dtype=dtype).contiguous()


class TraceTransformer:
    """Model + device: init from a seed, load weights, score.

    ``device`` defaults to ``"cuda"`` and raises if CUDA is absent; pass
    ``"cpu"`` to run the plain versions of the kernels on the CPU.
    Scoring methods take numpy arrays or tensors and return tensors on
    the model's device without synchronising (the caller fetches).
    """

    def __init__(self, config: TransformerConfig | None = None,
                 device: str | torch.device = "cuda", seed: int = 0,
                 model_axis: Any = None):
        self.cfg = config or TransformerConfig()
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
        module = _TraceTransformerModule(self.cfg)
        init_parameters(module, torch.Generator().manual_seed(seed))
        shards = [module]
        if model_axis is not None:  # the seed's draws, sliced
            state = module.state_dict()
            shards = [_TraceTransformerModule(self.cfg, tp)
                      for _ in model_axis.shards]
            self._load_shards(shards, state)
        for m in shards:
            # a Dense with dtype=bf16 casts its kernel to bf16 on every
            # call in Flax; holding the block weights in the working type
            # is the same arithmetic, paid once
            for blk in m.encoder.blocks:
                for lin in blk.dense_layers():
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
        shards past the first are not used)."""
        return [p for m in self.shards for p in m.parameters()]

    def train(self, mode: bool = True) -> None:
        """Every local shard into training (or eval) mode."""
        for m in self.shards:
            m.train(mode)

    # ------------------------------------------------------------ scoring
    @torch.inference_mode()
    def score_packed(self, categorical: Any, continuous: Any, segments: Any,
                     positions: Any, reference: bool = False) -> torch.Tensor:
        """Packed-rows scoring: ``(R, L)`` f32 span probabilities with
        block-diagonal attention per segment. ``reference=True`` runs the
        plain versions of the kernels instead (a check, not a route)."""
        dev = self.device
        cat = _as_tensor(categorical, torch.int32, dev)
        cont = _as_tensor(continuous, torch.float32, dev)
        seg = _as_tensor(segments, torch.int32, dev)
        pos = _as_tensor(positions, torch.int32, dev)
        h = self.module.encoder(cat, cont, pos, seg, reference=reference)
        return torch.sigmoid(self.module.span_logits(h))

    @torch.inference_mode()
    def score_packed_scatter(self, categorical: Any, continuous: Any,
                             segments: Any, positions: Any,
                             perm: torch.Tensor, row_eff: torch.Tensor,
                             span_col: torch.Tensor, n: int,
                             reference: bool = False,
                             live: torch.Tensor | None = None
                             ) -> torch.Tensor:
        """Packed-rows scoring straight to span order, the fused route's
        forward: the encoder over the ``(R, L)`` rows, then the span head
        kernel (K8, final LayerNorm + head + sigmoid at each real span
        only) writes span ``perm[j]``'s probability from slot
        ``(row_eff[j], span_col[j])`` for ``j < n``; ``(N,)`` f32, 0
        elsewhere. ``reference=True`` runs the plain versions of every
        kernel. ``live``: next-fit's ``(1,)`` count of filled rows on the
        device; the blocks' LayerNorms skip the rows past it (K8 reads
        none of them)."""
        dev = self.device
        cat = _as_tensor(categorical, torch.int32, dev)
        cont = _as_tensor(continuous, torch.float32, dev)
        seg = _as_tensor(segments, torch.int32, dev)
        pos = _as_tensor(positions, torch.int32, dev)
        m = self.module
        h = m.encoder(cat, cont, pos, seg, reference=reference,
                      final_ln=False, live=live)
        head = span_head_scatter_plain if reference else span_head_scatter
        ln = m.encoder.final_ln
        return head(h, ln.weight, ln.bias, m.span_head.weight,
                    m.span_head.bias, _as_tensor(perm, torch.int32, dev),
                    _as_tensor(row_eff, torch.int32, dev),
                    _as_tensor(span_col, torch.int32, dev), n, ln.eps)

    # ----------------------------------------------------------- training
    def _rows(self, categorical: Any, continuous: Any, mask: Any):
        """One trace a row: the device tensors, segment id 1 at the real
        slots (0 at padding) and positions 0..L-1."""
        dev = self.device
        cat = _as_tensor(categorical, torch.int32, dev)
        cont = _as_tensor(continuous, torch.float32, dev)
        m = _as_tensor(mask, torch.bool, dev)
        T, L = m.shape
        seg = m.to(torch.int32).contiguous()
        pos = torch.arange(L, dtype=torch.int32, device=dev).expand(
            T, L).contiguous()
        return cat, cont, m, seg, pos

    def logits(self, categorical: Any, continuous: Any, mask: Any,
               reference: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
        """``(T, L)`` span and ``(T,)`` trace logits, one trace a row, with
        a graph behind them when the module is in training mode and
        gradients are enabled (the trainer's forward; ``reference=True``:
        the plain versions of every kernel, forward and backward)."""
        cat, cont, m, seg, pos = self._rows(categorical, continuous, mask)
        h = self.module.encoder(cat, cont, pos, seg, reference=reference)
        return self.module.span_logits(h), self.module.trace_logits(h, m)

    def loss_terms(self, categorical: Any, continuous: Any, mask: Any,
                   span_labels: Any, trace_labels: Any,
                   reference: bool = False
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              torch.Tensor]:
        """The sums and counts :meth:`loss_fn` divides: ``(span BCE summed
        over real spans, real spans, trace BCE summed over valid traces,
        valid traces)``. The data-parallel step all-reduces the counts to
        take the loss over the global batch."""
        span_logit, trace_logit = self.logits(categorical, continuous, mask,
                                              reference)
        dev = self.device
        m = _as_tensor(mask, torch.float32, dev)
        span_bce = sigmoid_bce(span_logit,
                               _as_tensor(span_labels, torch.float32, dev))
        valid = (m.sum(-1) > 0).to(torch.float32)
        trace_bce = sigmoid_bce(trace_logit,
                                _as_tensor(trace_labels, torch.float32, dev))
        return ((span_bce * m).sum(), m.sum(), (trace_bce * valid).sum(),
                valid.sum())

    def loss_fn(self, categorical: Any, continuous: Any, mask: Any,
                span_labels: Any, trace_labels: Any,
                reference: bool = False) -> torch.Tensor:
        """The reference's ``loss_fn``: masked span BCE plus trace BCE
        (equal weight), the trace term weighted by trace validity so that
        all-padding rows do not train the trace head."""
        span_sum, span_n, trace_sum, trace_n = self.loss_terms(
            categorical, continuous, mask, span_labels, trace_labels,
            reference)
        return (span_sum / span_n.clamp(min=1.0)
                + trace_sum / trace_n.clamp(min=1.0))

    @torch.inference_mode()
    def score_spans(self, categorical: Any, continuous: Any, mask: Any
                    ) -> tuple[torch.Tensor, torch.Tensor]:
        """One trace per row: ``(T, L)`` span and ``(T,)`` trace
        probabilities; positions are 0..L-1 and attention spans the real
        slots of each row (segment id 1, padding 0)."""
        cat, cont, m, seg, pos = self._rows(categorical, continuous, mask)
        h = self.module.encoder(cat, cont, pos, seg)
        span = torch.sigmoid(self.module.span_logits(h))
        trace = torch.sigmoid(self.module.trace_logits(h, m))
        return span, trace


def sigmoid_bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Numerically stable sigmoid binary cross-entropy (the reference's
    ``optax_sigmoid_bce``)."""
    labels = labels.to(torch.float32)
    return (logits.clamp(min=0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs())))

"""int8 (W8A8) serving path for the trace transformer, in PyTorch.

Counterpart of ``odigos_tpu/models/quantized.py``: the six dense products
of every encoder block (q, k, v, the attention output, FFN1, FFN2) run in
int8 with

* per-output-channel symmetric weight scales, quantized ONCE at load from
  the f32 parameters (:func:`quantize_weight`; the scorer keeps no float
  copy of those weights), and
* per-token dynamic activation scales (absmax / 127).

Attention, the LayerNorm statistics, the embeddings and the f32 heads stay
as in the float model. The forward is the reference's ``_block`` with the
port's kernels:

* K2 (``kernels.embed``) for the embedding, positional table and mask;
* per block, K9 (``kernels.quant.ln_quantize``) four times — LN1 and LN2
  with the LayerNorm in front, the attention context and the GELU output
  plain — and K10 (``kernels.qgemm.qgemm``) four times: q, k and v as one
  product over the concatenated ``(3 d, d)`` int8 weight (per-channel
  scales make that exact) split into three contiguous planes for K1, the
  out-projection with the residual add in its epilogue, FFN1 with the
  tanh GELU, FFN2 with the residual (K10's ``"gelu_tanh_quant"``, FFN1
  and this K9 step in one launch, computes the same bits but is not
  served: on the H100 it measured slower than the two launches, PERF.md);
* K1 (``kernels.attention``) on the bf16 q, k, v viewed ``(R, L, H, hd)``;
* the host route's final LayerNorm and f32 span head as the float model
  has them; the fused route's through K8 (``kernels.head``).

Differences from the JAX scorer, absorbed by the stated bounds
(``tests/test_torch_quantized.py``): K2 sums the embedding in f32 and
rounds once where the reference rounds each partial sum to the working
type; K1 divides q by sqrt(hd) before the product where the reference
divides the scores after it (equal at hd = 64, one bf16 step apart at
hd = 32), and keeps the scores and softmax in f32; the GELU runs in f32
and rounds once (``jax.nn.gelu`` on bf16 works in bf16); the LayerNorm
statistics are correctly rounded f32 sums and ``1 / sqrt``, where XLA
sums in its own order and uses its own rsqrt; XLA on the CPU also
contracts ``acc * s + b`` into an FMA, the port rounds the product first.

No throughput figure of the reference applies here: its docstring's
numbers are a TPU's. The card's are in PERF.md.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.attention import segment_attention, segment_attention_plain
from ..kernels.embed import EmbedTables, span_embed, span_embed_plain
from ..kernels.head import span_head_scatter, span_head_scatter_plain
from ..kernels.qgemm import qgemm, qgemm_plain
from ..kernels.quant import ln_quantize, ln_quantize_plain
from ..kernels import coverage
from ..utils.device import resolve_device
from .layers import LN_EPS, init_parameters
from .transformer import (TransformerConfig, _as_tensor,
                          _TraceTransformerModule)

# the block's dense layers: port name -> the JAX scorer's name
DENSE = {"query": "q", "key": "k", "value": "v", "out": "o", "ff1": "ffn1",
         "ff2": "ffn2"}


def quantize_weight(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8: ``w (out, in)`` → ``(w_q (out,
    in) int8, scale (out,) f32)``; an all-zero channel gets scale 1. The
    reference's ``quantize_weight`` on the transposed layout, with its
    true divisions (it runs eagerly, once, at load)."""
    w = w.float()
    absmax = w.abs().amax(1)
    scale = torch.where(absmax > 0, absmax / torch.full_like(absmax, 127.0),
                        torch.ones_like(absmax))
    w_q = torch.round(w / scale[:, None]).clamp_(-127, 127).to(torch.int8)
    return w_q, scale


def dense_keys(n_layers: int) -> list[str]:
    """The state-dict prefixes of the int8 products, block by block."""
    return [f"encoder.blocks.{i}.{name}" for i in range(n_layers)
            for name in DENSE]


def int8_layout(cfg: TransformerConfig) -> dict[str, tuple[tuple, Any]]:
    """Name → (shape, dtype) of the int8 tree for ``cfg``: the float
    model's state dict with each dense ``weight`` int8 and a ``scale`` (out,)
    f32 beside it."""
    with torch.device("meta"):
        own = _TraceTransformerModule(cfg).state_dict()
    out = {k: (tuple(v.shape), torch.float32) for k, v in own.items()}
    for p in dense_keys(cfg.n_layers):
        out[f"{p}.weight"] = (out[f"{p}.weight"][0], torch.int8)
        out[f"{p}.scale"] = ((out[f"{p}.weight"][0][0],), torch.float32)
    return out


@dataclass(frozen=True)
class _QDense:
    w: torch.Tensor  # (N, K) int8
    s: torch.Tensor  # (N,) f32
    b: torch.Tensor  # (N,) f32


@dataclass(frozen=True)
class _QBlock:
    ln1: tuple[torch.Tensor, torch.Tensor]
    qkv: _QDense     # q, k, v stacked: (3 d, d)
    out: _QDense
    ln2: tuple[torch.Tensor, torch.Tensor]
    ff1: _QDense
    ff2: _QDense


class QuantizedTraceScorer:
    """The trace transformer served with int8 products.

    ``device`` defaults to ``"cuda"`` and raises if CUDA is absent; pass
    ``"cpu"`` to run the plain versions of the kernels on the CPU. A seed
    draws the float model's f32 parameters (``init_parameters``, the same
    draws as ``TraceTransformer`` with that seed, before its cast of the
    block weights to the working type) and quantizes them.

    >>> scorer = QuantizedTraceScorer(TransformerConfig(), device="cuda")
    >>> probs = scorer.score_packed(cat, cont, segments, positions)
    """

    def __init__(self, config: TransformerConfig | None = None,
                 device: str | torch.device = "cuda", seed: int = 0):
        self.cfg = config or TransformerConfig()
        if self.cfg.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"working dtype must be float32 or bfloat16, "
                             f"not {self.cfg.dtype}")
        self.device = resolve_device(device)
        if self.device.type == "cuda":  # no plain route on the card
            coverage.check(self.cfg)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        module = _TraceTransformerModule(self.cfg)
        init_parameters(module, torch.Generator().manual_seed(seed))
        self.load_state_dict(module.state_dict())

    # ------------------------------------------------------------ weights
    def load_state_dict(self, state: Mapping[str, Any]) -> None:
        """Load the float model's state dict (``TraceTransformer``'s names,
        tensors or numpy arrays): the dense weights are quantized from the
        f32 values given, the rest kept in f32."""
        from .convert import quantize_state_dict

        self.load_quantized(quantize_state_dict(state, self.cfg))

    def load_quantized(self, tree: Mapping[str, Any]) -> None:
        """Load an int8 tree (``convert.quantize_state_dict`` or
        ``convert.flax_quantized_to_torch``) as it is."""
        layout = int8_layout(self.cfg)
        missing = sorted(set(layout) - set(tree))
        extra = sorted(set(tree) - set(layout))
        if missing or extra:
            raise KeyError(f"int8 tree mismatch: missing {missing}, "
                           f"unexpected {extra}")
        p: dict[str, torch.Tensor] = {}
        for name, (shape, dtype) in layout.items():
            v = tree[name]
            t = v if isinstance(v, torch.Tensor) else torch.as_tensor(
                np.asarray(v))
            if tuple(t.shape) != shape or t.dtype != dtype:
                raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype}, "
                                 f"expected {shape} {dtype}")
            p[name] = t.to(self.device).contiguous()
        self._params = p

        def dense(*names: str) -> _QDense:
            return _QDense(*(torch.cat([p[f"{n}.{part}"] for n in names])
                             .contiguous()
                             for part in ("weight", "scale", "bias")))

        def ln(name: str) -> tuple[torch.Tensor, torch.Tensor]:
            return p[f"{name}.weight"], p[f"{name}.bias"]

        blocks = []
        for i in range(self.cfg.n_layers):
            b = f"encoder.blocks.{i}"
            blocks.append(_QBlock(
                ln1=ln(f"{b}.ln1"),
                qkv=dense(f"{b}.query", f"{b}.key", f"{b}.value"),
                out=dense(f"{b}.out"), ln2=ln(f"{b}.ln2"),
                ff1=dense(f"{b}.ff1"), ff2=dense(f"{b}.ff2")))
        self._blocks = blocks
        e = "encoder.embed"
        self._tables = EmbedTables(
            service=p[f"{e}.service_embed.weight"],
            name=p[f"{e}.name_embed.weight"],
            kind=p[f"{e}.kind_embed.weight"],
            status=p[f"{e}.status_embed.weight"],
            attr=p.get(f"{e}.attr_embed.weight"),
            cont_w=p[f"{e}.cont_proj.weight"],
            cont_b=p[f"{e}.cont_proj.bias"],
            pos=p["encoder.pos_embed.weight"])

    def state_dict(self) -> dict[str, torch.Tensor]:
        """The int8 tree as loaded (codes, scales and f32 parameters)."""
        return dict(self._params)

    # ------------------------------------------------------------ forward
    def _encode(self, cat: torch.Tensor, cont: torch.Tensor,
                seg: torch.Tensor, pos: torch.Tensor,
                reference: bool) -> torch.Tensor:
        """The hidden state before the final LayerNorm, ``(R, L, d)``."""
        c = self.cfg
        dt = c.dtype
        embed = span_embed_plain if reference else span_embed
        quant = ln_quantize_plain if reference else ln_quantize
        gemm = qgemm_plain if reference else qgemm
        attend = segment_attention_plain if reference else segment_attention
        x = embed(cat, cont, pos, seg, self._tables, dt)
        R, L, d = x.shape
        H = c.n_heads
        x = x.view(R * L, d)
        for b in self._blocks:
            xq, a_s = quant(x, *b.ln1)
            qkv = gemm(xq, b.qkv.w, a_s, b.qkv.s, b.qkv.b, dt, planes=3)
            q, k, v = (t.view(R, L, H, d // H) for t in qkv)
            ctx = attend(q, k, v, seg)
            xq, a_s = quant(ctx.view(R * L, d))
            x = gemm(xq, b.out.w, a_s, b.out.s, b.out.b, dt, "residual", x)
            xq, a_s = quant(x, *b.ln2)
            h = gemm(xq, b.ff1.w, a_s, b.ff1.s, b.ff1.b, dt, "gelu_tanh")
            xq, a_s = quant(h)
            x = gemm(xq, b.ff2.w, a_s, b.ff2.s, b.ff2.b, dt, "residual", x)
        return x.view(R, L, d)

    def _inputs(self, categorical, continuous, segments, positions):
        dev = self.device
        return (_as_tensor(categorical, torch.int32, dev),
                _as_tensor(continuous, torch.float32, dev),
                _as_tensor(segments, torch.int32, dev),
                _as_tensor(positions, torch.int32, dev))

    @torch.inference_mode()
    def score_packed(self, categorical: Any, continuous: Any, segments: Any,
                     positions: Any, reference: bool = False) -> torch.Tensor:
        """``(R, L)`` f32 span probabilities of packed rows — the drop-in
        for ``TraceTransformer.score_packed``. ``reference=True`` runs the
        plain versions of the kernels instead (a check, not a route)."""
        cat, cont, seg, pos = self._inputs(categorical, continuous,
                                           segments, positions)
        h = self._encode(cat, cont, seg, pos, reference)
        p = self._params
        y = F.layer_norm(h.float(), (h.shape[-1],),
                         p["encoder.final_ln.weight"],
                         p["encoder.final_ln.bias"], LN_EPS).to(h.dtype)
        logit = F.linear(y.float(), p["span_head.weight"],
                         p["span_head.bias"])[..., 0]
        return torch.sigmoid(logit)

    @torch.inference_mode()
    def score_packed_scatter(self, categorical: Any, continuous: Any,
                             segments: Any, positions: Any,
                             perm: torch.Tensor, row_eff: torch.Tensor,
                             span_col: torch.Tensor, n: int,
                             reference: bool = False,
                             live: torch.Tensor | None = None
                             ) -> torch.Tensor:
        """The fused route's forward, as
        ``TraceTransformer.score_packed_scatter``: the int8 encoder over
        the ``(R, L)`` rows, then K8 writes span ``perm[j]``'s probability
        for ``j < n``; ``(N,)`` f32, 0 elsewhere. ``live`` (next-fit's row
        count) is taken for the float model's signature: K9 reads every
        row."""
        dev = self.device
        cat, cont, seg, pos = self._inputs(categorical, continuous,
                                           segments, positions)
        h = self._encode(cat, cont, seg, pos, reference)
        p = self._params
        head = span_head_scatter_plain if reference else span_head_scatter
        return head(h, p["encoder.final_ln.weight"],
                    p["encoder.final_ln.bias"], p["span_head.weight"],
                    p["span_head.bias"], _as_tensor(perm, torch.int32, dev),
                    _as_tensor(row_eff, torch.int32, dev),
                    _as_tensor(span_col, torch.int32, dev), n, LN_EPS)

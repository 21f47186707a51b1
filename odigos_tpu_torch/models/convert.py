"""Carry the JAX package's model parameters into the port.

``flax_to_torch(params, cfg)`` takes the Flax variables of
``odigos_tpu.models.transformer.TraceTransformer`` as numpy arrays — the
nested dict ``init`` returns (with or without its ``"params"`` level) or a
dict flattened with ``/`` — and returns the port's f32 state dict. Every
source parameter must be used and every target filled, or it raises.
``flax_autoencoder_to_torch(params, cfg)`` does the same for
``odigos_tpu.models.autoencoder.SpanAutoencoder``: the same encoder, then
the bottleneck, decoder and head names.

The layout changes:

* Dense ``kernel (in, out)`` → Linear ``weight (out, in)``;
* MHA ``query/key/value/kernel (d, H, hd)`` → ``weight (H*hd, d)`` and
  ``bias (H, hd)`` → ``(H*hd,)``, so a Linear's output viewed as
  ``(..., H, hd)`` is JAX's DenseGeneral layout;
* MHA ``out/kernel (H, hd, d)`` → ``weight (d, H*hd)``;
* LayerNorm ``scale`` → ``weight``; Embed ``embedding`` → ``weight``.

The parent-service column gathers the service table (one parameter, no
copy), and there is no ``attr_embed`` when ``attr_slots == 0``.

The int8 scorer (``models/quantized.py``) loads an **int8 tree**: the same
names, with each block's dense ``weight`` as int8 codes ``(out, in)`` and a
``scale`` ``(out,)`` f32 beside it (``quantized.int8_layout``).
``quantize_state_dict(state, cfg)`` makes it from the port's f32 state
dict; ``flax_quantized_to_torch(qparams, cfg)`` carries the JAX scorer's
own ``QuantizedTraceScorer.params`` (as numpy) across, its ``w (in, out)``
codes transposed. Both raise on a missing or unused entry.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .transformer import TransformerConfig

_MHA = "MultiHeadDotProductAttention_0"


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> dict[str, Any]:
    out: dict[str, Any] = {}
    items = tree.items() if isinstance(tree, Mapping) else enumerate(tree)
    for k, v in items:
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, (Mapping, list, tuple)):
            out.update(_flatten(v, key))
        else:
            out[key] = v
    return out


class _Taker:
    """A flattened Flax tree (without its ``"params"`` level) that records
    which leaves were taken."""

    def __init__(self, params: Mapping[str, Any]):
        flat = _flatten(params)
        self.flat = {k[len("params/"):] if k.startswith("params/") else k: v
                     for k, v in flat.items()}
        self.used: set[str] = set()

    def __call__(self, name: str) -> np.ndarray:
        if name not in self.flat:
            raise KeyError(f"flax parameter {name!r} missing")
        self.used.add(name)
        return np.asarray(self.flat[name], dtype=np.float32)

    def dense(self, src: str) -> tuple[np.ndarray, np.ndarray]:
        return self(f"{src}/kernel").T, self(f"{src}/bias")

    def done(self, sd: Mapping[str, np.ndarray]) -> dict[str, torch.Tensor]:
        unused = sorted(set(self.flat) - self.used)
        if unused:
            raise KeyError(f"flax parameters not carried across: {unused}")
        return {k: torch.from_numpy(np.array(v, dtype=np.float32, order="C"))
                for k, v in sd.items()}


def _encoder(take: _Taker, cfg: Any) -> dict[str, np.ndarray]:
    """The ``encoder`` subtree (``models/layers.py`` ``Encoder``), shared by
    the transformer and the autoencoder."""
    H = cfg.n_heads
    d = cfg.d_model
    sd: dict[str, np.ndarray] = {}
    for table in ("service_embed", "name_embed", "kind_embed",
                  "status_embed"):
        sd[f"encoder.embed.{table}.weight"] = take(
            f"encoder/embed/{table}/embedding")
    if cfg.attr_slots > 0:
        sd["encoder.embed.attr_embed.weight"] = take(
            "encoder/embed/attr_embed/embedding")
    w, b = take.dense("encoder/embed/cont_proj")
    sd["encoder.embed.cont_proj.weight"], sd["encoder.embed.cont_proj.bias"] \
        = w, b
    sd["encoder.pos_embed.weight"] = take("encoder/pos_embed/embedding")
    for i in range(cfg.n_layers):
        src = f"encoder/block_{i}"
        dst = f"encoder.blocks.{i}"
        for ln_src, ln_dst in (("LayerNorm_0", "ln1"), ("LayerNorm_1", "ln2")):
            sd[f"{dst}.{ln_dst}.weight"] = take(f"{src}/{ln_src}/scale")
            sd[f"{dst}.{ln_dst}.bias"] = take(f"{src}/{ln_src}/bias")
        for proj in ("query", "key", "value"):
            kern = take(f"{src}/{_MHA}/{proj}/kernel")     # (d, H, hd)
            sd[f"{dst}.{proj}.weight"] = kern.reshape(d, -1).T
            sd[f"{dst}.{proj}.bias"] = take(
                f"{src}/{_MHA}/{proj}/bias").reshape(-1)   # (H*hd,)
        kern = take(f"{src}/{_MHA}/out/kernel")            # (H, hd, d)
        if kern.shape[0] != H:
            raise ValueError(f"{src} has {kern.shape[0]} heads, config "
                             f"says {H}")
        sd[f"{dst}.out.weight"] = kern.reshape(-1, d).T
        sd[f"{dst}.out.bias"] = take(f"{src}/{_MHA}/out/bias")
        sd[f"{dst}.ff1.weight"], sd[f"{dst}.ff1.bias"] = take.dense(
            f"{src}/Dense_0")
        sd[f"{dst}.ff2.weight"], sd[f"{dst}.ff2.bias"] = take.dense(
            f"{src}/Dense_1")
    sd["encoder.final_ln.weight"] = take("encoder/final_ln/scale")
    sd["encoder.final_ln.bias"] = take("encoder/final_ln/bias")
    return sd


def flax_to_torch(params: Mapping[str, Any],
                  cfg: TransformerConfig) -> dict[str, torch.Tensor]:
    take = _Taker(params)
    sd = _encoder(take, cfg)
    for head in ("span_head", "trace_head"):
        sd[f"{head}.weight"], sd[f"{head}.bias"] = take.dense(head)
    return take.done(sd)


def flax_autoencoder_to_torch(params: Mapping[str, Any], cfg: Any
                              ) -> dict[str, torch.Tensor]:
    """The Flax variables of ``odigos_tpu.models.autoencoder.SpanAutoencoder``
    as the port's ``SpanAutoencoder`` state dict: the encoder as
    :func:`flax_to_torch` maps it, then the bottleneck, the decoder and the
    four heads under their own names."""
    take = _Taker(params)
    sd = _encoder(take, cfg)
    for dense in ("bottleneck", "latent_proj", "dec_ff1", "dec_ff2",
                  "service_head", "name_head", "kind_head", "duration_head"):
        sd[f"{dense}.weight"], sd[f"{dense}.bias"] = take.dense(dense)
    sd["dec_pos_embed.weight"] = take("dec_pos_embed/embedding")
    sd["dec_ln.weight"] = take("dec_ln/scale")
    sd["dec_ln.bias"] = take("dec_ln/bias")
    return take.done(sd)


def quantize_state_dict(state: Mapping[str, Any], cfg: TransformerConfig
                        ) -> dict[str, torch.Tensor]:
    """The int8 tree of the port's f32 state dict: each block's six dense
    weights quantized per output channel (``quantized.quantize_weight``,
    from the values as given, in f32), everything else as f32."""
    from .quantized import dense_keys, int8_layout, quantize_weight

    floats = {k: v for k, v in int8_layout(cfg).items()
              if not k.endswith(".scale")}
    missing = sorted(set(floats) - set(state))
    extra = sorted(set(state) - set(floats))
    if missing or extra:
        raise KeyError(f"state dict mismatch: missing {missing}, "
                       f"unexpected {extra}")
    out = {k: (v if isinstance(v, torch.Tensor)
               else torch.as_tensor(np.asarray(v))).detach().cpu().float()
           for k, v in state.items()}
    for p in dense_keys(cfg.n_layers):
        out[f"{p}.weight"], out[f"{p}.scale"] = quantize_weight(
            out[f"{p}.weight"])
    return out


def flax_quantized_to_torch(qparams: Mapping[str, Any],
                            cfg: TransformerConfig
                            ) -> dict[str, torch.Tensor]:
    """The JAX scorer's ``QuantizedTraceScorer.params`` (numpy leaves) as
    the port's int8 tree: ``w (in, out)`` codes → ``weight (out, in)``,
    ``s`` → ``scale``, ``b`` → ``bias``; the f32 leaves as
    ``flax_to_torch`` maps them."""
    from .quantized import DENSE

    flat = _flatten(qparams)
    used: set[str] = set()

    def take(name: str) -> np.ndarray:
        if name not in flat:
            raise KeyError(f"quantized parameter {name!r} missing")
        used.add(name)
        return np.asarray(flat[name])

    tree: dict[str, np.ndarray] = {}
    for table in ("service_embed", "name_embed", "kind_embed",
                  "status_embed"):
        tree[f"encoder.embed.{table}.weight"] = take(
            f"embed/{table}/embedding")
    if cfg.attr_slots > 0:
        tree["encoder.embed.attr_embed.weight"] = take(
            "embed/attr_embed/embedding")
    tree["encoder.embed.cont_proj.weight"] = take("embed/cont_proj/kernel").T
    tree["encoder.embed.cont_proj.bias"] = take("embed/cont_proj/bias")
    tree["encoder.pos_embed.weight"] = take("pos")
    for i in range(cfg.n_layers):
        src, dst = f"blocks/{i}", f"encoder.blocks.{i}"
        for ln in ("ln1", "ln2"):
            tree[f"{dst}.{ln}.weight"] = take(f"{src}/{ln}/scale")
            tree[f"{dst}.{ln}.bias"] = take(f"{src}/{ln}/bias")
        for port, jax_name in DENSE.items():
            w = take(f"{src}/{jax_name}/w")
            if w.dtype != np.int8:
                raise TypeError(f"{src}/{jax_name}/w is {w.dtype}, not "
                                f"int8")
            tree[f"{dst}.{port}.weight"] = w.T
            tree[f"{dst}.{port}.scale"] = take(f"{src}/{jax_name}/s")
            tree[f"{dst}.{port}.bias"] = take(f"{src}/{jax_name}/b")
    tree["encoder.final_ln.weight"] = take("final_ln/scale")
    tree["encoder.final_ln.bias"] = take("final_ln/bias")
    for head in ("span_head", "trace_head"):
        tree[f"{head}.weight"] = take(f"{head}/kernel").T
        tree[f"{head}.bias"] = take(f"{head}/bias")
    unused = sorted(set(flat) - used)
    if unused:
        raise KeyError(f"quantized parameters not carried across: {unused}")
    return {k: torch.from_numpy(np.array(
        v, dtype=np.int8 if v.dtype == np.int8 else np.float32, order="C"))
        for k, v in tree.items()}

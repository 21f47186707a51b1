"""The reference's initial weights for a seed, without JAX.

``odigos_tpu``'s trainer starts from ``TraceTransformer.init(
jax.random.PRNGKey(seed))`` (or ``SpanAutoencoder``'s): Flax's default
initializers drawn from JAX's threefry generator, one key a parameter. Training from another draw of the
same distributions is another experiment: the reference's north-star
fixture (200 steps, seed 0) reaches ROC-AUC 0.98 from its own seed-0
weights, while seeds 1 and 2 of the same recipe reach 0.66 and 0.35 (the
JAX trainer on a CPU; PERF.md). So the port's trainer starts from the
same weights the reference's seed gives, and this module computes them
with numpy:

* threefry2x32 (20 rounds, JAX's rotations and key schedule), a key from
  a seed ``[0, seed]``, ``fold_in`` and the partitionable random bits (the
  key hashed with each element's 64-bit flat index, the two words XORed);
* ``uniform`` (23 random mantissa bits in ``[1, 2)``, minus 1, scaled),
  ``normal`` (``sqrt(2) erfinv(u)``, u in ``(-1, 1)``) and
  ``truncated_normal`` (``erfinv`` of u between ``erf(-2 / sqrt 2)`` and
  ``erf(2 / sqrt 2)``, clipped inside ``(-2, 2)``) in f32, with XLA's
  polynomial ``erfinv``;
* Flax's keys: a parameter created as the ``c``-th draw of the module at
  path ``p1/.../pn`` takes ``fold_in(root, sha1(p1 ... pn c)[:4])``
  (``flax.core.scope._fold_in_static``), and its initializer:
  ``lecun_normal`` (a truncated normal of standard deviation
  ``sqrt(1 / fan_in) / 0.8796...``) for the dense kernels, ``normal(1 /
  sqrt(d))`` for the embeddings, zeros and ones for the biases and the
  LayerNorm scales.

The bits, keys and uniforms are the reference's exactly (XLA fuses the
uniform's scale and shift, and ``erfinv``'s Horner steps, into
multiply-adds: :func:`_fma` rounds them once); ``erfinv``'s ``log1p`` is
numpy's (in f64, rounded), not XLA's, so about 1% of the values land one
f32 step from the reference's (``tests/test_torch_training.py`` holds the
weights to the JAX package's).
"""

from __future__ import annotations

import hashlib
from typing import Any

import numpy as np
import torch

_U32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_SQRT2 = np.float32(np.sqrt(2.0))
# erf(-+2 / sqrt 2) in f32 as XLA computes it: the truncated normal's
# uniform range
_ERF_LO = np.float32(float.fromhex("-0x1.e8b43p-1"))
_ERF_HI = np.float32(float.fromhex("0x1.e8b43p-1"))
_TRUNC_STD = np.float32(0.87962566103423978)
# XLA's f32 erfinv (M. Giles' approximation): w < 5 and w >= 5
_ERFINV_LT = np.array([2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                       -4.39150654e-06, 0.00021858087, -0.00125372503,
                       -0.00417768164, 0.246640727, 1.50140941], np.float32)
_ERFINV_GE = np.array([-0.000200214257, 0.000100950558, 0.00134934322,
                       -0.00367342844, 0.00573950773, -0.0076224613,
                       0.00943887047, 1.00167406, 2.83297682], np.float32)

Key = tuple[int, int]


def _threefry2x32(key: Key, x0: np.ndarray, x1: np.ndarray
                  ) -> tuple[np.ndarray, np.ndarray]:
    k0, k1 = _U32(key[0]), _U32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _U32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x0 = (x0 + ks[0]).astype(_U32)
        x1 = (x1 + ks[1]).astype(_U32)
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = (x0 + x1).astype(_U32)
                x1 = ((x1 << _U32(r)) | (x1 >> _U32(32 - r))) ^ x0
            x0 = (x0 + ks[(i + 1) % 3]).astype(_U32)
            x1 = (x1 + ks[(i + 2) % 3] + _U32(i + 1)).astype(_U32)
    return x0, x1


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)``'s two words, for 0 <= seed < 2^32."""
    return (0, int(seed) & 0xFFFFFFFF)


def fold_in(key: Key, data: int) -> Key:
    y0, y1 = _threefry2x32(key, np.array([0], _U32),
                           np.array([data & 0xFFFFFFFF], _U32))
    return (int(y0[0]), int(y1[0]))


def random_bits(key: Key, shape: tuple[int, ...]) -> np.ndarray:
    """``jax.random.bits(key, shape)`` (32-bit, partitionable threefry)."""
    n = int(np.prod(shape, dtype=np.int64))
    i = np.arange(n, dtype=np.uint64)
    y0, y1 = _threefry2x32(key, (i >> np.uint64(32)).astype(_U32),
                           (i & np.uint64(0xFFFFFFFF)).astype(_U32))
    return (y0 ^ y1).reshape(shape)


def _fma(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """``a * b + c`` rounded once to f32, as XLA's fused multiply-add:
    the f32 product is exact in f64 and the f64 sum rounds once more, which
    changes the result only in a double-rounding tie."""
    return (np.float64(1.0) * a * b + c).astype(np.float32)


def uniform(key: Key, shape: tuple[int, ...], lo: float, hi: float
            ) -> np.ndarray:
    lo, hi = np.float32(lo), np.float32(hi)
    bits = random_bits(key, shape)
    f = ((bits >> _U32(9)) | _U32(0x3F800000)).view(np.float32) \
        - np.float32(1.0)
    return np.maximum(lo, _fma(f, hi - lo, lo))


def _erfinv(x: np.ndarray) -> np.ndarray:
    w = (-np.log1p(np.float64(1.0) * -(x * x))).astype(np.float32)
    lt = w < np.float32(5.0)
    w = np.where(lt, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0))
    p = np.where(lt, _ERFINV_LT[0], _ERFINV_GE[0])
    for i in range(1, len(_ERFINV_LT)):
        p = _fma(p, w, np.where(lt, _ERFINV_LT[i], _ERFINV_GE[i]))
    return (p * x).astype(np.float32)


def normal(key: Key, shape: tuple[int, ...]) -> np.ndarray:
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    return _SQRT2 * _erfinv(uniform(key, shape, lo, 1.0))


def truncated_normal(key: Key, shape: tuple[int, ...]) -> np.ndarray:
    """``jax.random.truncated_normal(key, -2, 2, shape)``."""
    out = _SQRT2 * _erfinv(uniform(key, shape, _ERF_LO, _ERF_HI))
    return np.clip(out, np.nextafter(np.float32(-2.0), np.float32(np.inf)),
                   np.nextafter(np.float32(2.0), np.float32(-np.inf)))


def param_key(root: Key, path: tuple[str, ...], count: int) -> Key:
    """The key Flax hands the ``count``-th parameter drawn in the module
    at ``path`` (its scope's counter, from 1)."""
    m = hashlib.sha1()
    for part in path:
        m.update(part.encode("utf-8"))
    m.update(count.to_bytes((count.bit_length() + 7) // 8, "big"))
    return fold_in(root, int.from_bytes(m.digest()[:4], "big"))


def _lecun(key: Key, shape: tuple[int, ...], fan_in: int) -> np.ndarray:
    std = np.sqrt(np.float32(1.0 / fan_in)) / _TRUNC_STD
    return truncated_normal(key, shape) * std


def _embed(key: Key, rows: int, d: int) -> np.ndarray:
    return normal(key, (rows, d)) * np.sqrt(np.float32(1.0 / d))


def _encoder_params(cfg: Any, root: Key) -> tuple[dict[str, np.ndarray],
                                                   Any, Any]:
    """The ``encoder`` subtree both models share (``odigos_tpu/models/
    layers.py`` ``Encoder``, its ``final_ln`` included), and the ``dense``
    and ``layer_norm`` helpers that draw more parameters into it."""
    d, H, ff = cfg.d_model, cfg.n_heads, cfg.d_ff
    hd = d // H
    out: dict[str, np.ndarray] = {}

    def dense(path: tuple[str, ...], shape: tuple[int, ...], fan_in: int,
              bias: tuple[int, ...]) -> None:
        name = "/".join(path)
        out[f"{name}/kernel"] = _lecun(param_key(root, path, 1), shape,
                                       fan_in)
        out[f"{name}/bias"] = np.zeros(bias, np.float32)

    def layer_norm(path: tuple[str, ...]) -> None:
        name = "/".join(path)
        out[f"{name}/scale"] = np.ones(d, np.float32)
        out[f"{name}/bias"] = np.zeros(d, np.float32)

    emb = ("encoder", "embed")
    tables = [("service_embed", cfg.service_vocab),
              ("name_embed", cfg.name_vocab), ("kind_embed", 8),
              ("status_embed", 4)]
    if cfg.attr_slots > 0:
        tables.append(("attr_embed", cfg.attr_vocab))
    for table, rows in tables:
        path = emb + (table,)
        out["/".join(path) + "/embedding"] = _embed(
            param_key(root, path, 1), rows, d)
    dense(emb + ("cont_proj",), (3, d), 3, (d,))
    out["encoder/pos_embed/embedding"] = _embed(
        param_key(root, ("encoder", "pos_embed"), 1), cfg.max_len, d)
    mha = "MultiHeadDotProductAttention_0"
    for i in range(cfg.n_layers):
        blk = ("encoder", f"block_{i}")
        layer_norm(blk + ("LayerNorm_0",))
        for proj in ("query", "key", "value"):
            dense(blk + (mha, proj), (d, H, hd), d, (H, hd))
        dense(blk + (mha, "out"), (H, hd, d), d, (d,))
        layer_norm(blk + ("LayerNorm_1",))
        dense(blk + ("Dense_0",), (d, ff), d, (ff,))
        dense(blk + ("Dense_1",), (ff, d), ff, (d,))
    layer_norm(("encoder", "final_ln"))
    return out, dense, layer_norm


def transformer_params(cfg: Any, seed: int) -> dict[str, np.ndarray]:
    """The Flax variables ``odigos_tpu``'s ``TraceTransformer(cfg).init(
    jax.random.PRNGKey(seed))`` draws, as a ``/``-flattened dict of f32
    arrays (``convert.flax_to_torch`` takes it)."""
    d = cfg.d_model
    out, dense, _ = _encoder_params(cfg, prng_key(seed))
    dense(("span_head",), (d, 1), d, (1,))
    dense(("trace_head",), (d, 1), d, (1,))
    return out


def transformer_state(cfg: Any, seed: int) -> dict[str, torch.Tensor]:
    """:func:`transformer_params` as the port's state dict."""
    from .convert import flax_to_torch

    return flax_to_torch(transformer_params(cfg, seed), cfg)


def autoencoder_params(cfg: Any, seed: int) -> dict[str, np.ndarray]:
    """The Flax variables ``odigos_tpu``'s ``SpanAutoencoder(cfg).init(
    jax.random.PRNGKey(seed))`` draws (``odigos_tpu/models/
    autoencoder.py:103-110``): the encoder, then the bottleneck, the
    decoder and the four heads, as a ``/``-flattened dict of f32 arrays
    (``convert.flax_autoencoder_to_torch`` takes it)."""
    root = prng_key(seed)
    d, lat, ff = cfg.d_model, cfg.d_latent, cfg.d_ff
    out, dense, layer_norm = _encoder_params(cfg, root)
    dense(("bottleneck",), (d, lat), d, (lat,))
    out["dec_pos_embed/embedding"] = _embed(
        param_key(root, ("dec_pos_embed",), 1), cfg.max_len, d)
    dense(("latent_proj",), (lat, d), lat, (d,))
    dense(("dec_ff1",), (d, ff), d, (ff,))
    dense(("dec_ff2",), (ff, d), ff, (d,))
    layer_norm(("dec_ln",))
    for head, width in (("service_head", cfg.service_vocab),
                        ("name_head", cfg.name_vocab), ("kind_head", 8),
                        ("duration_head", 1)):
        dense((head,), (d, width), d, (width,))
    return out


def autoencoder_state(cfg: Any, seed: int) -> dict[str, torch.Tensor]:
    """:func:`autoencoder_params` as the port's state dict."""
    from .convert import flax_autoencoder_to_torch

    return flax_autoencoder_to_torch(autoencoder_params(cfg, seed), cfg)

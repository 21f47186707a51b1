"""What the card route serves: the model geometries every kernel takes.

The reference's jnp forward takes any geometry its pipeline config names
(``odigos_tpu/components/processors/tpuanomaly.py`` reads ``max_len`` and a
``model_config``). On the card every device computation of the port is a
hand-written kernel with no plain route, so a model states at construction
whether its kernels take its geometry. :func:`check` is that statement:

* ``d_model`` and ``d_ff`` multiples of 16 (the reference's own defaults
  are "MXU-shaped" multiples of 128; K15 and K10 take ``K % 16 == 0``),
  ``d_model <= 1024`` (K11's and K12's rows) and ``d_ff <= 4096`` (the
  rows of K9's GELU output and the K of K10's and K15's FFN2);
* ``max_len <= 1024``: K7's walk (``pack.MAX_WALK_LEN``) and K1's key
  tiles;
* head dim ``d_model / n_heads`` at most 256: K1's tensor-core tiles keep
  a 16-query block's output in registers;
* on a ``"model"`` axis of tp (``check(cfg, tp)``): the local widths of
  the row-parallel products (attention ``d_model / tp``, the FFNs' ``d_ff /
  tp``, the autoencoder's decoder FFN among them) multiples of 16. A
  vocabulary slice of any width runs: K11's tensor-core planes pad each
  head of a shard to whole ``recon.PLANE_PAD`` (64) columns, as they pad
  a whole head.

The float and int8 transformers and the autoencoder call it when their
device is a card and raise the ``ValueError`` it raises, naming the limit;
they never pick a plain version instead. On the CPU the plain versions
serve every geometry.

Ring attention (K22, ``ring.ring_block_attention``) takes any head dim
``D`` from 1 to ``RING_MAX_HEAD_DIM`` (256: at D 256 a 128-query tile of
f32 and 16-key K and V tiles of (hi, lo) pairs take 199 KB of a block's
227 KB of shared memory), any sequence lengths, q in f32 or bf16: the
reference's test and dry-run head dims (8, 16, its all-masked test's 4)
and the transformer's 64 among them. :func:`check_ring` raises past it.
"""

from __future__ import annotations

from typing import Any

from .pack import MAX_WALK_LEN

ALIGN = 16
MAX_D_MODEL = 1024
MAX_D_FF = 4096
MAX_LEN = MAX_WALK_LEN
MAX_HEAD_DIM = 256
RING_MAX_HEAD_DIM = 256


def check(cfg: Any, tp: int = 1) -> None:
    """Raise ``ValueError`` naming the first limit ``cfg`` (a
    ``TransformerConfig`` or ``AutoencoderConfig``: ``d_model``,
    ``n_heads``, ``d_ff``, ``max_len``) breaks on the card route, float or
    int8 (K9 and K10 take the float kernels' limits). ``tp``: a shard of
    a ``"model"`` axis of that size, whose local widths (``d_model /
    tp`` of attention where the heads divide, ``d_ff / tp`` where d_ff
    does) are the K of its row-parallel products: multiples of 16."""
    what = "the card route"
    d, h, ff, L = cfg.d_model, cfg.n_heads, cfg.d_ff, cfg.max_len
    if tp > 1 and h > 0:
        width = d // tp if h % tp == 0 else d
        local = ff // tp if ff % tp == 0 else ff
        if width % ALIGN or local % ALIGN:
            raise ValueError(f"{what} on a model axis of {tp} takes local "
                             f"widths a multiple of {ALIGN}, not attention "
                             f"{width} / FFN {local}")
    if d % ALIGN or d <= 0 or d > MAX_D_MODEL:
        raise ValueError(f"{what} takes d_model a multiple of {ALIGN} up to "
                         f"{MAX_D_MODEL}, not {d}")
    if ff % ALIGN or ff <= 0 or ff > MAX_D_FF:
        raise ValueError(f"{what} takes d_ff a multiple of {ALIGN} up to "
                         f"{MAX_D_FF}, not {ff}")
    if L <= 0 or L > MAX_LEN:
        raise ValueError(f"{what} takes max_len up to {MAX_LEN} (K7's walk), "
                         f"not {L}")
    if h <= 0 or d % h:
        raise ValueError(f"d_model {d} not divisible by n_heads {h}")
    if d // h > MAX_HEAD_DIM:
        raise ValueError(f"{what} takes a head dim d_model / n_heads up to "
                         f"{MAX_HEAD_DIM}, not {d // h}")


def check_ring(head_dim: int) -> None:
    """Raise ``ValueError`` where K22 cannot take a head dim on the card."""
    if not 1 <= head_dim <= RING_MAX_HEAD_DIM:
        raise ValueError(f"ring attention on the card takes a head dim from "
                         f"1 to {RING_MAX_HEAD_DIM}, not {head_dim}")

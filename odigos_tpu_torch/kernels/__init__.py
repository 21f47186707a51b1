"""Hand-written CUDA kernels of the port, each beside its plain version.

* ``attention.segment_attention`` — K1, packed segment-masked attention
  (``csrc/segment_attention.cu``);
* ``embed.span_embed`` — K2, the span-embedding gather-sum
  (``csrc/span_embed.cu``);
* ``zscore.zscore_update`` — K3, the z-score detector's weighted Welford
  segmented update, and ``zscore.zscore_score`` — K4, its score
  (``csrc/zscore.cu``).

Each wrapper launches its kernel for CUDA tensors (or raises) and takes the
plain PyTorch version for CPU tensors; ``attention.launches``,
``embed.launches``, ``zscore.update_launches`` and
``zscore.score_launches`` count the calls that launched. ``build``
compiles the sources with nvcc at first use.
"""

from . import attention, build, embed, zscore
from .attention import segment_attention, segment_attention_plain
from .embed import EmbedTables, span_embed, span_embed_plain
from .zscore import (zscore_score, zscore_score_plain, zscore_update,
                     zscore_update_plain)

__all__ = [
    "attention",
    "build",
    "embed",
    "segment_attention",
    "segment_attention_plain",
    "EmbedTables",
    "span_embed",
    "span_embed_plain",
    "zscore",
    "zscore_score",
    "zscore_score_plain",
    "zscore_update",
    "zscore_update_plain",
]

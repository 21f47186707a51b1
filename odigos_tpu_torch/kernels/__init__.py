"""Hand-written CUDA kernels of the port, each beside its plain version.

* ``attention.segment_attention`` — K1, packed segment-masked attention
  (``csrc/segment_attention.cu``);
* ``embed.span_embed`` — K2, the span-embedding gather-sum
  (``csrc/span_embed.cu``);
* ``zscore.zscore_update`` — K3, the z-score detector's weighted Welford
  segmented update, and ``zscore.zscore_score`` — K4, its score
  (``csrc/zscore.cu``);
* ``featurize.featurize_columns`` — K5, the fused route's featurize over
  raw span columns (``csrc/featurize.cu``);
* ``sort.radix_sort`` — K6, a stable radix sort of multi-word unsigned
  keys (``csrc/trace_sort.cu``);
* ``pack.next_fit_pack`` — K7, next-fit packing of trace-sorted spans,
  the row starts walked by chunks (``csrc/trace_pack.cu``);
* ``head.span_head_scatter`` — K8, final LayerNorm + span head + sigmoid
  written to each span's original index (``csrc/span_head.cu``);
* ``quant.ln_quantize`` — K9, per-token int8 quantize with an optional
  LayerNorm in front (``csrc/quant.cu``);
* ``qgemm.qgemm`` — K10, the int8 tensor-core GEMM with the dequantize,
  bias and residual or GELU fused into its epilogue (``csrc/qgemm.cu``;
  the package's ``qgemm`` is the module, which holds the launch count);
* ``recon.recon_ce`` — K11, the autoencoder's decoder LayerNorm, four f32
  heads and weighted reconstruction error (online log-sum-exp), with an
  optional squash-and-scatter to span order; bf16 on tensor cores from
  three bf16 planes of each head weight, f32 on CUDA cores
  (``csrc/recon_ce.cu``);
* ``pool.ln_masked_pool`` — K12, the autoencoder's final LayerNorm and
  masked mean-pool over each trace (``csrc/ae_pool.cu``);
* ``pack.trace_rows_pack`` — K13, trace-sorted spans packed one trace per
  row (``csrc/trace_pack.cu``, beside K7);
* ``dense.ln_bf16`` — K14, the float encoder block's exact LayerNorm, and
  ``dense.gemm_bf16`` — K15, its bf16 tensor-core GEMM with the bias and
  the residual or GELU fused into the epilogue (``csrc/dense.cu``);
* ``ring.ring_block_attention`` — K22, one q-block x kv-block step of ring
  attention merged into f32 accumulators in place
  (``csrc/ring_attention.cu``; its tile loops are K1's tiled kernel's,
  shared through ``csrc/attention_tiles.cuh``).

``coverage.check`` states the model geometries the kernels take on the
card (the models call it at construction there and raise outside it).

Each wrapper launches its kernel for CUDA tensors (or raises) and takes the
plain PyTorch version for CPU tensors; each module's ``launches`` (K3/K4:
``zscore.update_launches`` and ``zscore.score_launches``; K13:
``pack.rows_launches``; K14/K15: ``dense.ln_launches`` and
``dense.gemm_launches``) counts the calls that launched. ``build``
compiles the sources with nvcc at first use.
"""

from . import (attention, build, coverage, dense, embed, featurize, head,
               pack, pool, qgemm, quant, recon, ring, sort, zscore)
from .attention import segment_attention, segment_attention_plain
from .dense import gemm_bf16, gemm_bf16_plain, ln_bf16, ln_bf16_plain
from .embed import EmbedTables, span_embed, span_embed_plain
from .featurize import featurize_columns, featurize_columns_plain
from .head import span_head_scatter, span_head_scatter_plain
from .pack import (PackedColumns, TraceRows, next_fit_pack,
                   next_fit_pack_plain, trace_rows_pack,
                   trace_rows_pack_plain)
from .pool import ln_masked_pool, ln_masked_pool_plain
from .qgemm import qgemm_plain
from .quant import ln_quantize, ln_quantize_plain
from .recon import recon_ce, recon_ce_plain
from .ring import ring_block_attention, ring_block_attention_plain
from .sort import radix_sort, radix_sort_plain
from .zscore import (zscore_score, zscore_score_plain, zscore_update,
                     zscore_update_plain)

__all__ = [
    "attention",
    "build",
    "coverage",
    "dense",
    "embed",
    "featurize",
    "head",
    "pack",
    "pool",
    "qgemm",
    "quant",
    "recon",
    "ring",
    "sort",
    "zscore",
    "segment_attention",
    "segment_attention_plain",
    "gemm_bf16",
    "gemm_bf16_plain",
    "ln_bf16",
    "ln_bf16_plain",
    "EmbedTables",
    "span_embed",
    "span_embed_plain",
    "featurize_columns",
    "featurize_columns_plain",
    "span_head_scatter",
    "span_head_scatter_plain",
    "PackedColumns",
    "next_fit_pack",
    "next_fit_pack_plain",
    "TraceRows",
    "trace_rows_pack",
    "trace_rows_pack_plain",
    "ln_masked_pool",
    "ln_masked_pool_plain",
    "qgemm_plain",
    "ln_quantize",
    "ln_quantize_plain",
    "recon_ce",
    "recon_ce_plain",
    "ring_block_attention",
    "ring_block_attention_plain",
    "radix_sort",
    "radix_sort_plain",
    "zscore_score",
    "zscore_score_plain",
    "zscore_update",
    "zscore_update_plain",
]

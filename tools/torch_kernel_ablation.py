#!/usr/bin/env python3
"""Where a port kernel's time goes, by ablation, on one GPU.

    python3 tools/torch_kernel_ablation.py [--kernels recon_ce,...]

The card's profilers (Nsight) do not run everywhere the port is measured,
so this tool answers "is it the loads, the math or the stores?" by
timing variants of each kernel with one part taken out. Each variant is
the checkout's own source with named text edits (listed in ``VARIANTS``;
an edit whose anchor is missing fails the run), built with the same
``nvcc`` flags as ``odigos_tpu_torch/kernels/build.py``, and launched
through the port's wrapper on the smoke run's main-path inputs (R = 256
and 2048 packed rows, default ``TransformerConfig``; K10 ``qgemm`` at the
int8 block's QKV product and at its FFN1 + GELU + quantize step
(``qgemm_ffn1``), on the first block's own codes; K9 ``ln_quantize`` at
LN1 on the block's input; K15
``gemm_bf16`` at the float block's FFN1 + GELU, on the first block's own
LN2 output; K6 ``radix_sort`` as the trace sort of the smoke run's otel
frame at N = 65536; K7 ``next_fit_pack`` on that frame and at N = 131072,
its launches and its walk's steps cut off in turn, and its launches
without programmatic dependent launch; K5 ``featurize_columns`` on the
otel, adversarial and join-stress frames at N = 4096, 65536 and 131072:
the table's clear alone, the clear and the insert launch, no probe,
every lane inserting, no programmatic dependent launch, no f64 log1p;
K13 ``trace_rows_pack`` at R = 4096, 43008 (an engine call of 4096
traces) and 63488: the layout launch alone, the zero fill alone, the
real rows alone, scalar stores, no programmatic dependent launch;
K11 ``recon_ce``'s
bf16 kernel on the default autoencoder's decoder output at T = 256, 2048
and 4096 traces (the last about a fused call's real positions): the
compaction alone, no column tile, no LayerNorm, no plane loads, one
plane, no products, no log-sum-exp, no barrier a column tile, no kind
and duration dots; two CTAs an SM on 32-column stages; tiles of 256
rows; every tile whole; K14 ``ln_bf16`` at LN1 (R = 256, 2048), at d
128 (T = 2048) and with the fused transformer's row count: the bytes
alone, no prefetch, a warp a row, streaming (evict-first) stores or
loads, the parent's 4096-CTA grid; K12 ``ln_masked_pool`` on the default
autoencoder's pre-LN state at T = 256 and 2048 and at an engine call's
shape (4096 traces packed by K13, with its count): the bytes alone, a
ring of 1, 2 or 8 stages (not 4), a position a warp, without the count,
the mask listing alone; K8 ``span_head_scatter`` on the default
transformer's encoder output at N = 4096, 65536 and 131072: the bytes
alone, no prefetch, a span a warp, two vectors a lane at d 256, f32
statistics in place of the exact LayerNorm; K3 + K4's one launch
``zscore_score_update`` as an engine call makes it, on phase 4's otel and
single-group mixes at N = 4096, 65536 and 131072: the barriers alone (no
span work), no pass B, 2 or 4 spans a thread in place of one, CTAs of
1024 threads in place of 512); the trainer's K20 ``recon_ce_bwd`` and
K21 ``ln_masked_pool_bwd`` on one autoencoder training step's own inputs
(chip_smoke phase 16's): K20's prep launch alone, its slice items alone
(and without the logits' products, without dy's, without both), its dW
items alone (and without db's chains), the whole without dy's products,
the tiles' folds or dlogit's stores, without programmatic dependent
launch, and on CTAs of 128 threads two an SM; K21's launch alone, without
the last CTA's column sums, and on CTAs of 4 warps a trace (not 8); K17 ``ln_bwd`` on the first LayerNorm gradient
of a transformer and an autoencoder training step: no prefetch, one or
four rows a warp, the launch alone, the rows without the column sums;
K22 ``ring_block_attention`` at L 8192 and 4096 (B 2, H 4, D 64): 16
queries a warp, 32-key tiles, P.V 32 dims at a time, ``expf``, the
staging loop not unrolled; K16 ``segment_attention_bwd`` on a
transformer and an autoencoder training step's first attention gradient
(the one-CTA route) and on the smoke run's packed L 128 rows (the tiled
route): the launch alone, cut off after the staging and after S/dP/P/dS,
q/k/v/O staged at every slot (no dependent load), no zero stores at the
padding rows, the tiled route's tile ranges alone, every tile pair
walked, 64-slot tiles at hd 128; K18 ``span_embed_bwd`` on a transformer step's
embedding gradient: the launch alone, the sort alone, CTAs of 16 warps,
one CTA a small table (not four 64-column slabs), no zero rows, ids a
batch at a time, 2 rows in flight; K1's f32 CUDA-core route with its
log-sum-exp (``segment_attention_f32``, the trainers' forward) on both
trainers' steps and at R 256: the launch alone, cut off after the
staging, after the scores and after the softmax; K15's f32 route
(``gemm_f32``) on each product of both trainers' steps: each of its three
tiles forced, the copies alone, no epilogue, no barrier a slab, the
chunks of a slab unrolled whole.
``--kernels`` picks some of them. Times are
``chip_smoke.device_ms``: CUDA-event medians with the L2 flushed and the
host's enqueue kept out. Variants compute wrong results on purpose; only
the unchanged build is held to the plain version.

Prints the card's name and power limit, then one JSON line per (kernel,
variant, R). Imports nothing of JAX or of the JAX package; needs a CUDA
device and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# K15's epilogue taken out: no accumulator is rounded, staged or stored
# (a test that never holds keeps the products alive)
NO_EPILOGUE = {
    "epilogue_rows<MODE, ROWS>(acc":
        "if (acc0[0] == 1234567.f && acc1[63] == -7654321.f)\n"
        "        epilogue_rows<MODE, ROWS>(acc",
    "store_boxes<ROWS>(&map_out": "if (false) store_boxes<ROWS>(&map_out"}

# K10's (qgemm_s8_kernel) likewise
NO_EPILOGUE_S8 = {
    "epilogue_rows<MODE, ROWS, WS>(acc":
        "if (acc0[0] == 1234567 && acc1[63] == -7654321)\n"
        "        epilogue_rows<MODE, ROWS, WS>(acc",
    "store_boxes<ROWS>(&map_out": "if (false) store_boxes<ROWS>(&map_out"}

# K10's FFN1 quantize (qgemm_s8_quant_kernel): neither pass 1 (dequantize,
# GELU, row maxima) nor pass 2 (codes, transposes, stores) runs; the
# maxima swap between the cluster's CTAs stays
NO_QUANT_EPILOGUE = {
    "      chunk_gelu(acc, c * QCH,":
        "      if (acc[0] == 1234567 && acc[63] == -7654321)\n"
        "      chunk_gelu(acc, c * QCH,",
    "    block_codes(hb, xs,": "    if (false) block_codes(hb, xs,"}

# kernel -> variant -> {anchor text in the source: replacement}
# K20's parts, for its variants below: the dW items alone (no slice items,
# no waits), the slice items alone
DW_ONLY = {
    "      slice_item<TS, NC4, SLICED>(w, (int)(item % w.ntiles),\n"
    "                                  (int)(item / w.ntiles), smem, s_coef,\n"
    "                                  s_lab, s_lse, s_c0, s_bias, &s_flag,\n"
    "                                  dy_heads);": "      (void)0;",
    "        while (load_acquire(w.cnt + kLead + base + s) < w.ntiles)":
    "        while (false)"}
NO_DW = {"      dw_item(w, (int)(item - slice_items), smem);": "      (void)0;"}

VARIANTS = {
    # K11's f32 route: the list and the exit ticket alone (no
    # item), no class walk, no LayerNorm (the rows as they are), no merge
    # (its ticket reset), no products
    "recon_ce_f32": {
        "list_only": {"const long long items = (long long)tiles * ni;":
                      "const long long items = 0;"},
        "no_walk": {"      if (k > 0) walk(k - 1);": "",
                    "    walk(nchunks - 1);\n": "\n"},
        "no_ln": {
            "        y = ln_out(load_f(xr + f), s_st[p].x, s_st[p].y, "
            "__ldg(a.gamma + f),\n                   __ldg(a.beta + f), xr);":
            "        y = load_f(xr + f);"},
        "no_merge": {"    if (tid == 0) a.sc.tile_done[tile] = 0;\n":
                     "    if (tid == 0) a.sc.tile_done[tile] = 0;\n"
                     "    continue;\n"},
        "no_products": {"      for (int kk = 0; kk < d; kk += 4) {":
                        "      for (int kk = 0; kk < (d & 0); kk += 4) {"},
        # at d <= 128 below kLargeM: 4 x 4 logits a thread over 128-row
        # chunks double-buffered (one CTA an SM), 4 x 2 over 64-row chunks
        # double- or single-buffered, 2 x 4 (16-position tiles)
        "tile_4x4_double": {"launch_f32_t<T, 4, 4, false>":
                            "launch_f32_t<T, 4, 4, true>"},
        "tile_4x2_double": {"launch_f32_t<T, 4, 4, false>":
                            "launch_f32_t<T, 4, 2, true>"},
        "tile_4x2_single": {"launch_f32_t<T, 4, 4, false>":
                            "launch_f32_t<T, 4, 2, false>"},
        "tile_2x4_single": {"launch_f32_t<T, 4, 4, false>":
                            "launch_f32_t<T, 2, 4, false>"},
        # 64-position tiles at every M, or never
        "large_tiles_always": {"constexpr long long kLargeM = 16384;":
                               "constexpr long long kLargeM = 0;"},
        "large_tiles_never": {"constexpr long long kLargeM = 16384;":
                              "constexpr long long kLargeM = 1LL << 40;"}},
    # K19's one launch: the producers alone (no fold, each flag zeroed by
    # its owner: the folders leave at once), the stream alone (no block
    # fold either), 4 producer CTAs an SM (not 8), 16 partials a fold step
    # (not 32), the registers a thread left to the compiler or held to 64
    # (8 CTAs an SM), folders that never produce (they only wait)
    "gelu_tanh_bwd": {
        "production_only": {
            "  for (long long b0 = 0; b0 < blocks;) {":
            "  for (long long b0 = blocks; b0 < blocks;) {",
            "    atomicOr(flag, kDone);  // after the fence: a release":
            "    *flag = 0;"},
        "stream_only": {
            "  for (long long b0 = 0; b0 < blocks;) {":
            "  for (long long b0 = blocks; b0 < blocks;) {",
            "    atomicOr(flag, kDone);  // after the fence: a release":
            "    *flag = 0;",
            "  if (n < N) {\n    const float* col":
            "  if (n < 0) {\n    const float* col"},
        "ctas_4_an_sm": {"constexpr int kCtasPerSm = 8;":
                         "constexpr int kCtasPerSm = 4;"},
        "fold_batch_16": {"constexpr int kFoldBatch = 32;":
                          "constexpr int kFoldBatch = 16;"},
        "min_ctas_free": {"__launch_bounds__(kThreads, kMinCtasPerSm)":
                          "__launch_bounds__(kThreads)"},
        "min_ctas_8": {"constexpr int kMinCtasPerSm = 6;":
                       "constexpr int kMinCtasPerSm = 8;"},
        "folders_never_produce": {"      if (tried <= b0) {":
                                  "      if (false) {"}},
    "segment_attention": {
        # the row copies and waits only: no attention math, no output
        "loads_only": {
            "      attend_item(stage, g, out, r, item / nqb, (item % nqb) "
            "* 16, L, H, hd,\n                  inv_scale, big_neg);":
                "      ;"},
        # the math and the output stores only, on the zero-filled stages
        # (every slot reads as padding: no key tile is skipped)
        "compute_only": {
            "  copy_row(data, g, q, k, v, seg, r, L, H, hd);\n  for (int it":
                "  for (int it",
            "      if (rn < R)\n        copy_row(":
                "      if (false)\n        copy_row("},
    },
    # K1's f32 CUDA-core kernel with its log-sum-exp (the trainers'
    # forward), cut off after each of its phases
    "segment_attention_f32": {
        # the launch and one read of the segments
        "launch_only": {
            "  const size_t slot0 = (size_t)r * L * H + h;  // slot l at "
            "(slot0 + l H) hd\n":
                "  const size_t slot0 = (size_t)r * L * H + h;\n"
                "  if (seg[0] != INT_MIN) return;\n"},
        # the (row, head) tiles staged, nothing computed
        "staging_only": {
            "  __syncthreads();\n\n  // ---- scores: thread (ty, tx) owns "
            "rows ty + 16 a and keys tx + 16 b\n":
                "  __syncthreads();\n  if (segs[0] != INT_MIN) return;\n"
                "  // ---- scores\n"},
        # staged, scored and masked: no softmax, no P.V
        "through_scores": {
            "  __syncthreads();\n\n  // ---- softmax over keys, one warp "
            "per query row (the same shuffle trees),\n":
                "  __syncthreads();\n  if (segs[0] != INT_MIN) return;\n"
                "  // ---- softmax\n  //\n"},
        # everything but P.V and the output stores
        "through_softmax": {
            "  __syncthreads();\n\n  // ---- out = P.V: thread (ty, tx) "
            "owns rows ty + 16 a, dims 4 tx .. + 3\n":
                "  __syncthreads();\n  if (segs[0] != INT_MIN) return;\n"
                "  // ---- out = P.V\n"},
    },
    # K15's f32 route on the trainers' products, each tile forced
    "gemm_f32": {
        "tile_64x128": {"  *tile = plan_tile(M, N, sms);":
                        "  *tile = 0;\n  (void)plan_tile;"},
        "tile_64x64": {"  *tile = plan_tile(M, N, sms);":
                       "  *tile = 1;\n  (void)plan_tile;"},
        "tile_32x64": {"  *tile = plan_tile(M, N, sms);":
                       "  *tile = 2;\n  (void)plan_tile;"},
        # the cp.async copies and the ring only: no FMAs, no epilogue
        "loads_only": {"      if (half && c >= kChunks / 2) break;":
                       "      if (K > 0) break;",
                       "  // ---- the epilogue, 4 columns at a time":
                       "  if (K > 0) return;\n  // ---- the epilogue"},
        # no barrier a slab (wrong sums: what the barrier costs)
        "no_barrier": {"    __syncthreads();  // ... for every thread, and "
                       "slab s - 1 is consumed\n": "\n"},
        # the chunks of a slab unrolled whole (registers)
        "unroll_8": {"#pragma unroll 2\n    for (int c = 0; c < kChunks; "
                     "++c) {": "#pragma unroll\n    for (int c = 0; c < "
                               "kChunks; ++c) {"},
        # the products, no epilogue
        "no_epilogue": {"  // ---- the epilogue, 4 columns at a time":
                        "  if (acc[0][0] != 12345.f) return;\n"
                        "  // ---- the epilogue"},
    },
    "span_embed": {
        # no service/name/parent-service row gathers from L2
        "no_gathers": {"      if (mk[9] > 0) {": "      if (false) {"},
        # no gathers and no sums: every slot stores zeros (the batch
        # copies of the slots' words, the loop and the output stores)
        "stores_only": {"      if (mk[9] > 0) {": "      if (false) {",
                        "        if (w_c.y > 0) {": "        if (false) {"},
    },
    "qgemm": {
        # the TMA loads and the ring only: no products, no epilogue
        "loads_only": {
            "        wgmma_s8_m64n128k32(acc0, sw128_desc(a + kk * 32), db);\n"
            "        wgmma_s8_m64n128k32(acc1, sw128_desc(a + 64 * 128 + kk * "
            "32), db);":
                "        (void)db;",
            **NO_EPILOGUE_S8},
        # the products on stale shared memory: no A/W tile loads (the
        # producer arrives on each stage itself), no epilogue
        "mma_only": {
            "          mbar_expect_tx(&full[s], kStageBytes);\n"
            "          tma_load_2d(st, &map_x, kt * BK, m0, &full[s]);\n"
            "          if constexpr (!WS)\n"
            "            tma_load_2d(st + kTile, &map_w, kt * BK, n0, "
            "&full[s]);":
                "          (void)st, (void)n0, (void)m0;\n"
                "          mbar_arrive(&full[s]);",
            **NO_EPILOGUE_S8},
        # loads and products, no epilogue
        "no_epilogue": NO_EPILOGUE_S8,
        # the epilogue's math and staging, no TMA stores
        "no_stores": {"store_boxes<ROWS>(&map_out":
                      "if (false) store_boxes<ROWS>(&map_out"},
    },
    "qgemm_ffn1": {
        # the A block loads (and W half, once) only: no products, no
        # epilogue passes
        "loads_only": {
            "          wgmma_s8_m64n128k32(\n              acc, sw128_desc("
            "a_base":
                "          if (false) wgmma_s8_m64n128k32(\n              "
                "acc, sw128_desc(a_base",
            **NO_QUANT_EPILOGUE},
        # the products on stale A blocks (the producer arrives itself; the
        # W half still loads once), no epilogue passes
        "mma_only": {
            "        mbar_expect_tx(&a_full[wg][s], ktiles * kQABox);\n"
            "        for (int kt = 0; kt < ktiles; ++kt)\n"
            "          tma_load_2d(a_mine + s * kQA + kt * kQABox, &map_x, kt "
            "* BK,\n                      (int)(q * QBM), &a_full[wg][s]);":
                "        mbar_arrive(&a_full[wg][s]);",
            **NO_QUANT_EPILOGUE},
        # loads and products, no epilogue passes
        "no_epilogue": NO_QUANT_EPILOGUE,
        # pass 1 and the maxima swap, no codes computed or stored
        "no_quantize": {"    block_codes(hb, xs,":
                        "    if (false) block_codes(hb, xs,"},
        # pass 1's GELU by the formula on every output (no table)
        "gelu_formula": {
            "  rare |= gelu_rare<LO, SPAN>(v & 0xFFFFu) | gelu_rare<LO, SPAN>(v "
            ">> 16);\n"
            "  return (uint32_t)tab[gelu_index<LO, SPAN>(v & 0xFFFFu)] |\n"
            "         ((uint32_t)tab[gelu_index<LO, SPAN>(v >> 16)] << 16);":
                "  (void)tab, (void)rare;\n"
                "  return (uint32_t)gelu_formula_bits(v & 0xFFFFu) |\n"
                "         ((uint32_t)gelu_formula_bits(v >> 16) << 16);"},
        # every code by the true division (no reciprocal product)
        "true_division": {
            "  if (near) {  // rare: a product near a rounding boundary\n"
            "#pragma unroll\n    for (int e = 0; e < 4; ++e) {":
                "  if (true) {\n#pragma unroll\n    for (int e = 0; e < 4; "
                "++e) {"},
    },
    "ln_quantize": {
        # every code by the true division
        "true_division": {
            "      if (near) {  // rare: a product near a rounding boundary":
                "      if (true) {"},
    },
    "radix_sort": {
        # each key stored back at its own place, coalesced, in place of
        # its rank (the loads, ranking, barriers and offsets as they are)
        "no_scatter": {
            "          dst[s_cnt[warp][digit[r]] + __popc(peers[r] & lt)] = "
            "idx[r];":
                "          dst[t * kTile + warp * kWarpTile + lane + r * 32] = "
                "idx[r];"},
        # prep, the grid barriers and the offset scans only: no tile is
        # loaded, counted or scattered
        "barriers_only": {
            "for (long long t = t0; t < t1; ++t) {":
                "for (long long t = t0; t < t0; ++t) {"},
    },
    "next_fit_pack": {
        # the layout kernel alone: no walk, no scatter launched
        "layout_only": {
            "  err = smem_mask ? cudaLaunchKernelEx(":
                "  err = cudaSuccess;\n  if (false) err = smem_mask ? "
                "cudaLaunchKernelEx(",
            "  if (work > 0) {": "  if (false) {"},
        # the layout and the walk's step 1 (every chunk's candidates walked
        # to the next chunk): no composition, no row starts, no scatter
        "walk_candidates": {
            "  if (tid == 0) {\n    int k = 0, r = 0;":
                "  if (false) {\n    int k = 0, r = 0;",
            "  for (int c = tid; c < chunks; c += kWalkThreads) {":
                "  for (int c = tid; c < 0; c += kWalkThreads) {",
            "  if (work > 0) {": "  if (false) {"},
        # the layout and the walk's steps 1 and 2: no row starts written,
        # no scatter
        "walk_compose": {
            "  for (int c = tid; c < chunks; c += kWalkThreads) {":
                "  for (int c = tid; c < 0; c += kWalkThreads) {",
            "  if (work > 0) {": "  if (false) {"},
        # the layout and the whole walk: no scatter launched
        "layout_walk": {"  if (work > 0) {": "  if (false) {"},
        # the walk and the scatter launched plainly, each after the kernel
        # before it has ended (no programmatic dependent launch)
        "no_pdl": {"  cfg.numAttrs = 1;": "  cfg.numAttrs = 0;"},
    },
    "featurize_columns": {
        # the table's clear (a memset) alone: no insert, no probe
        "clear_only": {
            "    featurize_insert_kernel<<<":
                "    if (false) featurize_insert_kernel<<<",
            "  err = cudaLaunchKernelEx(\n      &cfg, featurize_probe_kernel,":
                "  err = cudaSuccess;\n  if (false) err = cudaLaunchKernelEx("
                "\n      &cfg, featurize_probe_kernel,"},
        # the clear and the insert launch: no probe + assemble launch
        "insert_only": {
            "  err = cudaLaunchKernelEx(\n      &cfg, featurize_probe_kernel,":
                "  err = cudaSuccess;\n  if (false) err = cudaLaunchKernelEx("
                "\n      &cfg, featurize_probe_kernel,"},
        # no probe: every parent not found (the inserts, the gathers, the
        # duration and the stores as they are)
        "no_probe": {"  for (bool more = true; more;) {":
                     "  for (bool more = false; more;) {"},
        # every lane inserts, not one a key a warp
        "no_warp_dedup": {
            "  if (!real || (__ffs(same) - 1) != lane) return;":
                "  if (!real) return;"},
        # the probe launched after the insert has ended (no programmatic
        # dependent launch)
        "no_pdl": {"  cfg.numAttrs = 1;": "  cfg.numAttrs = 0;"},
        # no f64 log1p: the duration in microseconds rounded to f32
        "no_log1p": {"  const float ld = __double2float_rn(log1p(us));":
                     "  const float ld = __double2float_rn(us);"},
    },
    "trace_rows_pack": {
        # the layout launch alone: no scatter
        "layout_only": {
            "  err = cudaLaunchKernelEx(\n      &cfg, rows_scatter_kernel,":
                "  err = cudaSuccess;\n  if (false) err = cudaLaunchKernelEx("
                "\n      &cfg, rows_scatter_kernel,"},
        # the scatter writes no real row: the counts' sums and the zero fill
        "fill_only": {"  const bool slot = in_block && r < R && c < L;":
                      "  const bool slot = false;"},
        # the scatter writes the real rows only: no zero fill
        "no_fill": {
            "  const long long all = (long long)gridDim.x * kThreads;":
                "  return;\n  const long long all = (long long)gridDim.x * "
                "kThreads;"},
        # every store a scalar one (no 16-byte vectors)
        "scalar_stores": {
            "  const long long a0 = min(e1, (e0 + V - 1) / V * V);\n"
            "  const long long a1 = max(a0, e1 / V * V);":
                "  const long long a0 = e1;\n  const long long a1 = e1;"},
        # the scatter launched after the layout has ended (no programmatic
        # dependent launch; K7's launches likewise)
        "no_pdl": {"  cfg.numAttrs = 1;": "  cfg.numAttrs = 0;"},
    },
    "recon_ce": {
        # the compaction launch alone: the scoring kernel not launched
        "compact_only": {
            "  recon_tc_kernel<D><<<sms * per_sm, kTcThreads, "
            "TcGeom<D>::SMEM, st>>>(a);":
                "  if (false)\n    recon_tc_kernel<D><<<sms * per_sm, "
                "kTcThreads, TcGeom<D>::SMEM, st>>>(a);"},
        # no vocabulary tile: the rows' gather and LayerNorm, the ring's
        # first stages, the kind and duration dots, the error
        "ln_only": {"    for (int it = 0; it < nt; ++it) {":
                    "    for (int it = 0; it < 0; ++it) {"},
        # no LayerNorm (the raw rows stay in the A tile; the statistics
        # are still taken in the compaction launch)
        "no_ln": {"    // dec_ln in place from the statistics: 8 values a "
                  "thread a step\n"
                  "    for (int e = tid; e < kBM * (D / 8); e += "
                  "kTcThreads) {":
                  "    for (int e = tid; e < 0; e += kTcThreads) {"},
        # the planes never loaded: the products on stale shared memory
        "no_b_loads": {"    cp_async16(smem_u32(st + (p * G::NT + r) * "
                       "G::LD + c * 8),":
                       "    if (false) cp_async16(smem_u32(st + (p * G::NT "
                       "+ r) * G::LD + c * 8),"},
        # one plane (W_hi) instead of three
        "one_plane": {"    for (int p = 0; p < 3; ++p) {":
                      "    for (int p = 0; p < 1; ++p) {"},
        # the loads and fragments, no tensor-core products
        "no_mma": {
            "          mma_bf16(acc[mi][2 * jj], af[mi], bf[0], bf[1]);\n"
            "          mma_bf16(acc[mi][2 * jj + 1], af[mi], bf[2], bf[3]);":
                "          acc[mi][2 * jj][0] += __uint_as_float("
                "af[mi][0] ^ bf[0] ^ bf[1]);\n"
                "          acc[mi][2 * jj + 1][0] += __uint_as_float("
                "af[mi][1] ^ bf[2] ^ bf[3]);"},
        # the products and the label's logit, no online log-sum-exp
        "no_lse": {
            "    if (h == 0)\n"
            "      lse_add<NW>(m[0][i], s[0][i], z, tm);\n"
            "    else\n"
            "      lse_add<NW>(m[1][i], s[1][i], z, tm);":
                "    s[0][i] += tm;"},
        # no barrier between the column tiles (races on the ring: wrong
        # results, what the barriers cost)
        "no_tile_barrier": {
            "      cp_async_wait<ST - 2>();\n      __syncthreads();\n":
                "      cp_async_wait<ST - 2>();\n"},
        # no kind and duration dots on CUDA cores
        "no_kind_duration": {
            "    for (int e = tid; e < rows * vk1; e += kTcThreads) {":
                "    for (int e = tid; e < 0; e += kTcThreads) {"},
        # two CTAs an SM: 32-column stages, two of them
        "two_ctas": {
            "  static constexpr int NT = D <= 128 ? 64 : 32;":
                "  static constexpr int NT = 32;",
            "  static constexpr int STAGES = D <= 128 ? 3 : 2;":
                "  static constexpr int STAGES = 2;",
            "__global__ void __launch_bounds__(kTcThreads, 1)\n"
            "    recon_tc_kernel":
                "__global__ void __launch_bounds__(kTcThreads, 2)\n"
                "    recon_tc_kernel"},
        # tiles of 256 rows (4 m16 tiles a warp, half the plane loads per
        # row), with a 2-stage ring to fit
        "rows_256": {
            "constexpr int kBM = 128;": "constexpr int kBM = 256;",
            "  static constexpr int STAGES = D <= 128 ? 3 : 2;":
                "  static constexpr int STAGES = 2;"},
        # every tile whole (S = 1)
        "no_slices": {"  const int S = plan_slices(tiles, vt, gridDim.x, "
                      "a.part_items);":
                      "  const int S = 1;"},
    },
    "ln_bf16": {
        # every row read and written, no statistics (the bytes alone)
        "loads_only": {
            "        y[e] = ln_out(v[j][e], mean, rstd, g[j][e], b[j][e], x);":
                "        y[e] = v[j][e];"},
        # the next rows' loads issued after the current ones are reduced
        "no_prefetch": {
            "      if (rn < lim && j * G + sub < nvec)\n"
            "        nxt[j] = __ldg(xv + rn * nvec + j * G + sub);":
                "      if (false)\n"
                "        nxt[j] = __ldg(xv + rn * nvec + j * G + sub);",
            "    for (int j = 0; j < NV; ++j) cur[j] = nxt[j];\n  }\n}\n\n"
            "// A row wider":
                "    for (int j = 0; j < NV; ++j)\n"
                "      if (rn < lim && j * G + sub < nvec)\n"
                "        cur[j] = __ldg(xv + rn * nvec + j * G + sub);\n"
                "  }\n}\n\n// A row wider"},
        # a warp a row at every width (lanes past the row's vectors idle)
        "warp_a_row": {
            "  if (nvec <= 1) LN_ROWS(1, 1)\n  if (nvec <= 2) LN_ROWS(2, 1)\n"
            "  if (nvec <= 4) LN_ROWS(4, 1)\n  if (nvec <= 8) LN_ROWS(8, 1)\n"
            "  if (nvec <= 16) LN_ROWS(16, 1)\n": ""},
        # stores that stream past L2 (evict-first), and loads likewise
        "streaming_stores": {
            "      ov[r * nvec + j * G + sub] = pack(y);":
                "      __stcs(ov + r * nvec + j * G + sub, pack(y));"},
        "streaming_loads": {
            "        nxt[j] = __ldg(xv + rn * nvec + j * G + sub);":
                "        nxt[j] = __ldcs(xv + rn * nvec + j * G + sub);"},
        # the parent's grid: at most 4096 CTAs, not sized to the card
        "grid_4096": {
            "  if (units < grid) grid = (int)(units > 0 ? units : 1);":
                "  grid = (int)(units < 4096 ? (units > 0 ? units : 1) "
                ": 4096);"}},
    "ln_masked_pool": {
        # the mask listing and the real positions' loads, summed raw: no
        # statistics, no LayerNorm (the bytes alone)
        "loads_only": {
            "        group_ln_stats<G>(v, sub, nvec, d, inv_d, eps, &mean, "
            "&rstd);":
                "        mean = 0.f, rstd = 1.f;",
            "            acc[j][e] += (double)ln_out(v[j][e], mean, rstd, gg, "
            "bb, x);":
                "            acc[j][e] += (double)v[j][e];"},
        # no ring: each step's vectors copied, then waited for (one stage)
        "ring_1": {", 1, 4)\n": ", 1, 1)\n"},
        # two and eight ring stages (not four) at one vector a lane
        "ring_2": {", 1, 4)\n": ", 1, 2)\n"},
        "ring_8": {", 1, 4)\n": ", 1, 8)\n"},
        # a position a warp at every width (the parent's layout: lanes
        # past the row's vectors idle)
        "position_a_warp": {
            "  if (nvec <= 1) POOL(1, 1, 4)\n  if (nvec <= 2) POOL(2, 1, 4)\n"
            "  if (nvec <= 4) POOL(4, 1, 4)\n  if (nvec <= 8) POOL(8, 1, 4)\n"
            "  if (nvec <= 16) POOL(16, 1, 4)\n": ""},
        # without the device row count: every row's mask listed and
        # pooled (the padding rows' empty masks give the zeros)
        "no_live": {
            "  const long long lim = ln_row_limit(rows, live, 1);":
                "  const long long lim = ln_row_limit(rows, nullptr, 1);"},
        # the mask listing and the output stores only: no position read
        "list_only": {"      const int steps = (n + P - 1) / P;":
                      "      const int steps = 0;"},
    },
    "span_head_scatter": {
        # the indices and vectors loaded, the raw dot: no statistics, no
        # LayerNorm (the bytes alone)
        "loads_only": {
            "    group_ln_stats<G>(v, sub, nvec, d, inv_d, eps, &mean, "
            "&rstd);":
                "    mean = 0.f, rstd = 1.f;",
            "        z = fmaf(ln_out(v[k][e], mean, rstd, gg, bb, h), ww, z);":
                "        z = fmaf(v[k][e], ww, z);"},
        # the next step's indices and vectors loaded after the current
        # one is reduced
        "no_prefetch": {
            "    load_vec(nxt, row_n, prm_n);    // the next step's vectors,\n"
            "    load_idx(j + 2 * stride);       // the one after's indices, "
            "first\n": "",
            "    row_c = row_n;\n    prm_c = prm_n;\n#pragma unroll\n"
            "    for (int k = 0; k < NV; ++k) cur[k] = nxt[k];":
                "    load_idx(j + stride);\n    load_vec(cur, row_c, prm_c);"},
        # a span a warp at every width (the parent's layout)
        "span_a_warp": {
            "  if (nvec <= 1) HEAD(1, 1)\n  if (nvec <= 2) HEAD(2, 1)\n"
            "  if (nvec <= 4) HEAD(4, 1)\n  if (nvec <= 8) HEAD(8, 1)\n"
            "  if (nvec <= 16) HEAD(16, 1)\n": ""},
        # two spans a warp at d 256 (16 lanes of two vectors each)
        "two_vectors_a_lane": {"  if (nvec <= 32) HEAD(32, 1)":
                               "  if (nvec <= 32) HEAD(16, 2)"},
        # f32 statistics (sums in f32, rsqrtf) in place of the exact
        # LayerNorm
        "f32_stats": {
            "    group_ln_stats<G>(v, sub, nvec, d, inv_d, eps, &mean, "
            "&rstd);":
                "    {\n"
                "      float s = 0.f, q = 0.f;\n"
                "      for (int k = 0; k < NV; ++k)\n"
                "        if (k * G + sub < nvec)\n"
                "          for (int e = 0; e < EPV; ++e) s += v[k][e];\n"
                "      for (int o = G / 2; o; o >>= 1)\n"
                "        s += __shfl_xor_sync(0xffffffffu, s, o);\n"
                "      mean = s / (float)d;\n"
                "      for (int k = 0; k < NV; ++k)\n"
                "        if (k * G + sub < nvec)\n"
                "          for (int e = 0; e < EPV; ++e) {\n"
                "            const float t = v[k][e] - mean;\n"
                "            q = fmaf(t, t, q);\n          }\n"
                "      for (int o = G / 2; o; o >>= 1)\n"
                "        q += __shfl_xor_sync(0xffffffffu, q, o);\n"
                "      rstd = rsqrtf(q / (float)d + eps);\n    }"},
    },
    "gemm_bf16": {
        # the TMA loads and the ring only: no products, no epilogue
        "loads_only": {
            "        wgmma_m64n128k16(acc0, sw128_desc(a + kk * 32), db);\n"
            "        wgmma_m64n128k16(acc1, sw128_desc(a + 64 * 128 + kk * "
            "32), db);":
                "        (void)db;",
            **NO_EPILOGUE},
        # the products on stale shared memory and the ring: no A/W tile
        # loads (the producer arrives on each stage itself), no epilogue
        "mma_only": {
            "          mbar_expect_tx(&full[s], kStageBytes);\n"
            "          tma_load_2d(st, &map_x, kt * BK, m0, &full[s]);\n"
            "          if constexpr (!WS)\n"
            "            tma_load_2d(st + kTileA, &map_w, kt * BK, n0, "
            "&full[s]);":
                "          (void)st, (void)n0, (void)m0;\n"
                "          mbar_arrive(&full[s]);",
            **NO_EPILOGUE},
        # loads and products, no epilogue
        "no_epilogue": NO_EPILOGUE,
        # the GELU by the formula per output, not the table
        "gelu_formula": {
            "    case 2: return launch_tc_mode<2, WS>(a, st);":
                "    case 2: return launch_tc_mode<3, WS>(a, st);"},
        # the streaming walk (A and W tiles reloaded) at K <= 256 too
        "streaming_walk": {
            "  if (K <= kWsMaxK && n_tiles <= a.sms)":
                "  if (false && K <= kWsMaxK)"},
        # the GELU table read at a conflict-free index (each lane its own
        # bank; wrong values): what the lookups' bank conflicts cost
        "conflict_free_lookup": {
            "          lo[jj][h] = tab[gelu_index(v[jj][h] & 0xFFFFu)];\n"
            "          hi[jj][h] = tab[gelu_index(v[jj][h] >> 16)];":
                "          lo[jj][h] = tab[((threadIdx.x & 31) << 1) | "
                "(v[jj][h] & 1u)];\n"
                "          hi[jj][h] = tab[((threadIdx.x & 31) << 1) | "
                "((v[jj][h] >> 16) & 1u)];"},
        # no rare-value check, nor the formula pass it guards (the same
        # bits on the block's own activations, none of them rare)
        "no_rare_check": {
            "          rare |= gelu_rare(v[jj][h] & 0xFFFFu) | "
            "gelu_rare(v[jj][h] >> 16);\n": ""},
        # the consumer drains every wgmma group before freeing its stage
        "drain": {
            "wgmma.wait_group.sync.aligned 1;":
                "wgmma.wait_group.sync.aligned 0;"},
    },
    "zscore_score_update": {
        # no span work: the launch, the bit maps' zeroing, the barriers
        # and the merge's scan of the bit map
        "barriers_only": {"  const int per = a.per;":
                          "  const int per = 0;"},
        # no pass B (its flush adds zeros)
        "no_pass_b": {"  for_each(pass_b, false);": "  (void)pass_b;"},
        # several spans a thread (a half or a quarter of the CTAs; held in
        # registers from the first pass to the last)
        "spans_2": {"constexpr int kSpansPerThread = 1;":
                    "constexpr int kSpansPerThread = 2;"},
        "spans_4": {"constexpr int kSpansPerThread = 1;":
                    "constexpr int kSpansPerThread = 4;"},
        # CTAs of 1024 threads (one an SM, as 512 are: the sums' shared
        # memory)
        "threads_1024": {"constexpr int kThreads = 512;":
                         "constexpr int kThreads = 1024;"},
    },
    # the trainer's backward kernels: the design choices measured
    "recon_ce_bwd": {
        # the prep launch alone (the main launch returns at once)
        "prep_only": {
            "  wait_prior_grid();  // the prep grid's list, y and count\n":
            "  wait_prior_grid();  // the prep grid's list, y and count\n"
            "  if (d > 0) return;\n"},
        # the slice items alone; the dW items alone (no waits); the dW
        # items without db's chains
        "no_dw": NO_DW,
        "dw_only": DW_ONLY,
        "dw_no_db": DW_ONLY | {
            "      if (dbl) {\n#pragma unroll\n        for (int r = 0; r < 4; "
            "++r) dbs[r] = __fadd_rn(dbs[r], gs[r]);\n      }\n": ""},
        # the slice items alone without the logits' products, without dy's,
        # without both (the loads, dlogit, the partials, tickets, folds)
        "slices_no_logits": NO_DW | {
            "    for (int k = 0; k < d; k += 4) {":
            "    for (int k = 0; k < 0 * d; k += 4) {"},
        "slices_no_dy": NO_DW | {
            "#pragma unroll 2\n    for (int r = 0; r < kVR; ++r) {":
            "#pragma unroll 2\n    for (int r = 0; r < 0 * kVR; ++r) {"},
        "slices_overhead": NO_DW | {
            "    for (int k = 0; k < d; k += 4) {":
            "    for (int k = 0; k < 0 * d; k += 4) {",
            "#pragma unroll 2\n    for (int r = 0; r < kVR; ++r) {":
            "#pragma unroll 2\n    for (int r = 0; r < 0 * kVR; ++r) {"},
        # the whole launch without dy's products, without the tiles' folds,
        # without dlogit's stores to the scratch
        "no_dy": {"#pragma unroll 2\n    for (int r = 0; r < kVR; ++r) {":
                  "#pragma unroll 2\n    for (int r = 0; r < 0 * kVR; ++r) {"},
        "no_fold": {"    for (int e = tid; e < np * d4; e += kThreads) {":
                    "    for (int e = tid; e < 0 * np * d4; e += kThreads) {"},
        "no_dl_store": {
            "    for (int e = tid; e < np * nr; e += kThreads) {":
            "    for (int e = tid; e < 0 * np * nr; e += kThreads) {"},
        # the main launch without programmatic dependent launch
        "no_pdl": {"  cfg.numAttrs = 1;": "  cfg.numAttrs = 0;"},
        # CTAs of 128 threads, two an SM, 16-row dW items (not 256, one,
        # 32)
        "threads_128": {
            "constexpr int kThreads = 256;": "constexpr int kThreads = 128;",
            "constexpr int kCtasPerSm = 1;": "constexpr int kCtasPerSm = 2;",
            "constexpr int kBRows = 32;": "constexpr int kBRows = 16;"},
        # dW items of 32 rows x 128 columns on 8 warps, or x 32 on 2 (not
        # x 64 on 4)
        "dw_cols_128": {"constexpr int kBCols = 64; ":
                        "constexpr int kBCols = 128; "},
        "dw_cols_32": {"constexpr int kBCols = 64; ":
                       "constexpr int kBCols = 32; "}},
    "ln_masked_pool_bwd": {
        # the launch alone; the traces without the last CTA's column sums
        "launch_only": {
            "  for (long long t = blockIdx.x; t < T; t += gridDim.x) {  // "
            "CTA-uniform":
            "  if (T > 0) return;\n"
            "  for (long long t = blockIdx.x; t < T; t += gridDim.x) {  // "
            "CTA-uniform"},
        "no_column_sums": {
            "  for (int c = tid; c < 2 * d; c += kThreads) {\n"
            "    double a = 0.0;":
            "  for (int c = tid; c < 0 * d; c += kThreads) {\n"
            "    double a = 0.0;"},
        # CTAs of 4 warps a trace (not 8)
        "threads_128": {"constexpr int kThreads = 256;":
                        "constexpr int kThreads = 128;"}},
    # K17's one launch: the next row's loads not issued first; a row or
    # four rows a warp before the grid's cap (not two)
    "ln_bwd": {
        "no_prefetch": {"ln_bwd_kernel<PER, VEC, (PER <= 4)>":
                        "ln_bwd_kernel<PER, VEC, false>"},
        "one_row_a_warp": {"constexpr int kRowsPerWarp = 2;":
                           "constexpr int kRowsPerWarp = 1;"},
        "four_rows_a_warp": {"constexpr int kRowsPerWarp = 2;":
                             "constexpr int kRowsPerWarp = 4;"},
        # the launch alone (every thread returns at once), and the rows
        # and the CTAs' partials without the column sums' tickets
        "launch_only": {
            "  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n"
            "  float g[NV];":
            "  if (rows > 0) return;\n"
            "  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n"
            "  float g[NV];"},
        "rows_only": {
            "  for (int c = tid; c < 2 * d; c += kThreads) mine[c] = red[c];\n":
            "  for (int c = tid; c < 2 * d; c += kThreads) mine[c] = red[c];\n"
            "  if (rows > 0) return;\n"}},
    # K22's split-TF32 kernel: 16 queries a warp at D <= 64 (not 32); key
    # tiles of 32 at D <= 64 (not 64); P.V over 32 output dims at a time
    # (not 64); the weights by expf of the scaled logit (not one FFMA into
    # exp2f)
    "ring_block_attention": {
        "one_m_tile": {"constexpr int kMTiles64 = 2;":
                       "constexpr int kMTiles64 = 1;"},
        "key_tile_32": {"constexpr int kKeyTile64 = 64;":
                        "constexpr int kKeyTile64 = 32;"},
        "pv_steps_4": {"constexpr int kPVSteps = 8;":
                       "constexpr int kPVSteps = 4;"},
        "staging_not_unrolled": {
            "      for (int e = tid; e < KT * q4; e += kThreads) {":
            "#pragma unroll 1\n"
            "      for (int e = tid; e < KT * q4; e += kThreads) {"},
        "expf": {"exp2f(fmaf(sc[mt][j][2 * hf + c], sl, -mb))":
                 "expf(sc[mt][j][2 * hf + c] * scale - mn)"}},
    # K16's one launch, cut off after each of its parts in turn (one-CTA
    # route: the launch, the live list and staging, S/dP/P/dS; tiled: the
    # tile ranges), and the tiled route's choices: every tile pair walked
    # (no skip), 64-slot tiles at hd 128 (not 32)
    "segment_attention_bwd": {
        "launch_only": {
            "  const int r = blockIdx.x / H;\n  const int h = blockIdx.x - r * H;":
            "  if (L > 0) return;\n"
            "  const int r = blockIdx.x / H;\n  const int h = blockIdx.x - r * H;"},
        "staged_only": {"  // ---- Delta a warp a live query;":
                        "  if (L > 0) return;\n"
                        "  // ---- Delta a warp a live query;"},
        "scores_only": {"  // ---- dQ, dK, dV at the live slots":
                        "  if (L > 0) return;\n"
                        "  // ---- dQ, dK, dV at the live slots"},
        # q, k, v, O staged at every slot beside dO, not after the live
        # list (no dependent load); the padding rows' zero stores left out
        "stage_all_rows": {
            "      reinterpret_cast<float4*>(dos + l * ld)[c4] = gvec(dO, l)[c4];\n"
            "    }\n  } else {":
            "      reinterpret_cast<float4*>(dos + l * ld)[c4] = gvec(dO, l)[c4];\n"
            "      reinterpret_cast<float4*>(qs + l * ld)[c4] =\n"
            "          div4(gvec(q, l)[c4], scale_div);\n"
            "      reinterpret_cast<float4*>(ks + l * ld)[c4] = gvec(k, l)[c4];\n"
            "      reinterpret_cast<float4*>(vs + l * ld)[c4] = gvec(v, l)[c4];\n"
            "      reinterpret_cast<float4*>(os + l * ld)[c4] = gvec(o, l)[c4];\n"
            "    }\n  } else {",
            "  for (int e = tid; e < nl * h4; e += kOneThreads) {\n"
            "    const int c = e / h4, c4 = e - c * h4;\n"
            "    const int l = live[c];\n    const float4 xq":
            "  for (int e = tid; e < 0 * h4; e += kOneThreads) {\n"
            "    const int c = e / h4, c4 = e - c * h4;\n"
            "    const int l = live[c];\n    const float4 xq"},
        "no_padding_stores": {"    if (segs[l] > 0) continue;\n"
                              "    const size_t g = ((row0 + l) * H + h)":
                              "    if (L > 0) continue;\n"
                              "    const size_t g = ((row0 + l) * H + h)"},
        "tiled_ranges_only": {"  const int my_t = own / B;":
                              "  if (L > 0) return;\n"
                              "  const int my_t = own / B;"},
        "tiled_no_skip": {"    return tlo[a] <= thi[a] && tlo[b] <= thi[b]":
                          "    return true;\n"
                          "    return tlo[a] <= thi[a] && tlo[b] <= thi[b]"},
        "tiled_64_at_hd128": {"    return (int)launch_tiled<32, 2>(":
                              "    return (int)launch_tiled<64, 2>("}},
    # K18's one launch: the launch alone, the sort alone (both passes and
    # the scan), CTAs of 16 warps (not 32), the small tables in one CTA
    # (256-column slabs, not 64), ids read a batch at a time (not 4), 2
    # rows in flight (not 4)
    "span_embed_bwd": {
        "narrow_256": {"constexpr int kNarrow = 64;":
                       "constexpr int kNarrow = 256;"},
        "no_zero_rows": {"    if (rstart[row] != rstart[row + 1]) continue;":
                         "    if (N > 0) continue;"},
        "group_1": {"constexpr int kGroup = 4;": "constexpr int kGroup = 1;"},
        "unroll_2": {"#pragma unroll 4\n        for (int x = 0; x < n; ++x)":
                     "#pragma unroll 2\n        for (int x = 0; x < n; ++x)"},
        "launch_only": {"  int t = 0;\n  while (t + 1 < tabs.n":
                        "  if (N > 0) return;\n"
                        "  int t = 0;\n  while (t + 1 < tabs.n"},
        "sort_only": {"  float* out = grads + tb.grad_off":
                      "  if (N > 0) return;\n"
                      "  float* out = grads + tb.grad_off"},
        "threads_512": {"constexpr int kThreads = 1024;":
                        "constexpr int kThreads = 512;"}},
}


# kernel -> (source under build.SOURCES, its C launcher)
LAUNCHERS = {"segment_attention_bwd": ("segment_attention_bwd",
                                       "segment_attention_bwd_launch"),
             "recon_ce_f32": ("recon_ce", "recon_ce_f32_launch"),
             "gelu_tanh_bwd": ("gelu_bwd", "gelu_tanh_bwd_launch"),
             "span_embed_bwd": ("span_embed_bwd", "span_embed_bwd_launch"),
             "recon_ce_bwd": ("recon_ce_bwd", "recon_ce_bwd_launch"),
             "ln_bwd": ("ln_bwd", "ln_bwd_launch"),
             "ring_block_attention": ("ring_attention",
                                      "ring_block_attention_launch"),
             "ln_masked_pool_bwd": ("ae_pool_bwd",
                                    "ln_masked_pool_bwd_launch"),
             "segment_attention": ("segment_attention",
                                   "segment_attention_launch"),
             "segment_attention_f32": ("segment_attention",
                                       "segment_attention_launch"),
             "gemm_f32": ("gemm_f32", "gemm_f32_launch"),
             "span_embed": ("span_embed", "span_embed_launch"),
             "qgemm": ("qgemm", "qgemm_launch"),
             "qgemm_ffn1": ("qgemm", "qgemm_launch"),
             "ln_quantize": ("quant", "ln_quantize_launch"),
             "radix_sort": ("trace_sort", "radix_sort_launch"),
             "next_fit_pack": ("trace_pack", "next_fit_pack_launch"),
             "featurize_columns": ("featurize", "featurize_launch"),
             "trace_rows_pack": ("trace_pack", "trace_rows_pack_launch"),
             "recon_ce": ("recon_ce", "recon_ce_tc_launch"),
             "gemm_bf16": ("dense", "gemm_bf16_launch"),
             "ln_bf16": ("dense", "ln_bf16_launch"),
             "ln_masked_pool": ("ae_pool", "ln_masked_pool_launch"),
             "span_head_scatter": ("span_head", "span_head_launch"),
             "zscore_score_update": ("zscore", "zscore_step_launch")}


def _zscore_cases(dev) -> list:
    """K3 + K4's one launch as an engine call makes it (the staged (N, 2)
    ids, the state updated in place, the caller's buffer for the scores)
    on phase 4's otel-demo and single-group mixes at N = 4096, 65536 and
    131072, G = 8192, from a state fitted on 20,000 otel spans."""
    import torch

    import chip_smoke
    from odigos_tpu_torch.kernels import zscore

    G = chip_smoke.ZS_G
    mixes = chip_smoke._zs_mixes(max(chip_smoke.ZS_N))
    cat0, x0 = (torch.from_numpy(a[:20000]).to(dev) for a in mixes["otel"])
    zero = [torch.zeros(G, device=dev) for _ in range(3)]
    state = zscore.zscore_update_plain(*zero, cat0, x0, torch.ones_like(x0),
                                       G)
    sums = zscore.new_scratch(G, dev)
    cases = []
    for mix, (cat_np, x_np) in mixes.items():
        for N in chip_smoke.ZS_N:
            ids = torch.from_numpy(cat_np[:N, :2].copy()).to(dev)
            x = torch.from_numpy(x_np[:N]).to(dev)
            own = [t.clone() for t in state]
            out = torch.zeros(N + 1, device=dev)  # the cold word zeroed
            cases.append(("zscore_score_update", {"N": N, "mix": mix,
                                                  "G": G},
                          lambda ids=ids, x=x, own=own, out=out:
                          zscore.zscore_score_update(
                              *own, ids, x, G, chip_smoke.ZS_MIN_COUNT,
                              scratch=sums, inplace=True, out=out)))
    return cases


def _training_cases(dev) -> list:
    """K20 and K21 on the inputs one training step of the default f32
    autoencoder hands them (the reference's seed-0 weights, 63 clean traces
    padded to 64 rows: chip_smoke phase 16's)."""
    import torch

    import chip_smoke
    from odigos_tpu_torch.kernels import pool, recon
    from odigos_tpu_torch.models import AutoencoderConfig, SpanAutoencoder
    from odigos_tpu_torch.models.jax_init import autoencoder_state

    cfg = AutoencoderConfig(max_len=chip_smoke.TRAIN_LEN,
                            dtype=torch.float32)
    model = SpanAutoencoder(cfg, device=dev)
    model.load_state_dict(autoencoder_state(cfg, 0))
    seen = chip_smoke._capture_ae_inputs(
        model, chip_smoke._ae_train_step_data(chip_smoke.TRAIN_TRACES - 1))
    args = seen["recon_ce_bwd"][0]
    pargs = seen["ln_masked_pool_bwd"][0]
    shape = {"M": args[0].shape[0], "real": int(args[7].sum().item())}
    return [("recon_ce_bwd", shape, lambda: recon.recon_ce_bwd(*args)),
            ("ln_masked_pool_bwd", shape,
             lambda: pool.ln_masked_pool_bwd(*pargs))]


def _k17_k22_cases(dev, names) -> list:
    """K17 on the first LayerNorm gradient of one training step of the
    transformer (2048, 256) and of the autoencoder (2048, 128), the smoke
    run's steps, with the wrapper's scratch grown for any variant's grid;
    K22 at the smoke run's one block (2, 8192, 4, 64) and one ring step
    (4096 x 4096)."""
    import torch

    import chip_smoke
    from odigos_tpu_torch.kernels import dense
    from odigos_tpu_torch.kernels import ring as kring
    from odigos_tpu_torch.models import (AutoencoderConfig, SpanAutoencoder,
                                         TraceTransformer, TransformerConfig)
    from odigos_tpu_torch.models.jax_init import autoencoder_state
    from odigos_tpu_torch.training import labeled_sequences

    cases = []
    if "ln_bwd" in names:
        tcfg = TransformerConfig(max_len=chip_smoke.TRAIN_LEN,
                                 dtype=torch.float32)
        tseen = chip_smoke._capture_backward_inputs(
            TraceTransformer(tcfg, device=dev, seed=0),
            labeled_sequences(chip_smoke.TRAIN_TRACES - 1,
                              max_len=chip_smoke.TRAIN_LEN, seed=0,
                              pad_traces_to=chip_smoke.TRAIN_TRACES))
        acfg = AutoencoderConfig(max_len=chip_smoke.TRAIN_LEN,
                                 dtype=torch.float32)
        amodel = SpanAutoencoder(acfg, device=dev)
        amodel.load_state_dict(autoencoder_state(acfg, 0))
        aseen = chip_smoke._capture_ae_inputs(
            amodel,
            chip_smoke._ae_train_step_data(chip_smoke.TRAIN_TRACES - 1))
        for model, seen in (("transformer", tseen), ("autoencoder", aseen)):
            x, w, dy = seen["ln_bwd"][0][:3]
            d = x.shape[-1]
            rows = x.numel() // d
            dense._ln_bwd_part(dev, torch.cuda.current_stream(dev),
                               (rows + 64) * 2 * d)
            cases.append(("ln_bwd", {"model": model, "rows": rows, "d": d},
                          lambda x=x, w=w, dy=dy: dense.ln_bwd(x, w, dy)))
    if "ring_block_attention" in names:
        for L in (chip_smoke.RING_ONE_L, chip_smoke.RING_BLOCK_L):
            q, k, v, mask = chip_smoke._ring_inputs(L, 0, slice(0, L // 2))
            st = chip_smoke._ring_state(L)
            cases.append(("ring_block_attention", {"L": L},
                          lambda q=q, k=k, v=v, mask=mask, st=st:
                          kring.ring_block_attention(q, k, v, mask, *st)))
    return cases


def _k16_k18_cases(dev, names) -> list:
    """K16 on the first attention gradient of one transformer training
    step (64, 32, 4, 64) and of one autoencoder step (64, 32, 2, 64), and
    on the smoke run's tiled rows (50, 128, 2, 128); K18 on one
    transformer step's embedding gradient."""
    import torch

    import chip_smoke
    from odigos_tpu_torch.features import pack_sequences
    from odigos_tpu_torch.kernels import attention, embed
    from odigos_tpu_torch.models import (AutoencoderConfig, SpanAutoencoder,
                                         TraceTransformer, TransformerConfig)
    from odigos_tpu_torch.models.jax_init import autoencoder_state
    from odigos_tpu_torch.pdata import synthesize_traces
    from odigos_tpu_torch.training import labeled_sequences

    if not {"segment_attention_bwd", "span_embed_bwd",
            "segment_attention_f32"} & set(names):
        return []
    tcfg = TransformerConfig(max_len=chip_smoke.TRAIN_LEN,
                             dtype=torch.float32)
    tseen = chip_smoke._capture_backward_inputs(
        TraceTransformer(tcfg, device=dev, seed=0),
        labeled_sequences(chip_smoke.TRAIN_TRACES - 1,
                          max_len=chip_smoke.TRAIN_LEN, seed=0,
                          pad_traces_to=chip_smoke.TRAIN_TRACES))
    acfg = AutoencoderConfig(max_len=chip_smoke.TRAIN_LEN,
                             dtype=torch.float32)
    amodel = SpanAutoencoder(acfg, device=dev)
    amodel.load_state_dict(autoencoder_state(acfg, 0))
    aseen = chip_smoke._capture_ae_inputs(
        amodel, chip_smoke._ae_train_step_data(chip_smoke.TRAIN_TRACES - 1))
    pk = pack_sequences(synthesize_traces(600, seed=21), max_len=128,
                        pad_rows_to=lambda r: r + 2)
    seg = torch.from_numpy(pk.segments).to(dev).contiguous()
    R, L = seg.shape
    g = torch.Generator().manual_seed(17)
    q, k, v, do = (torch.randn(R, L, 2, 128, generator=g).to(dev)
                   for _ in range(4))
    do = (do * (seg > 0)[..., None, None]).contiguous()
    lse = torch.empty(R, 2, L, device=dev)
    o = attention.segment_attention(q, k, v, seg, lse)
    cases = []
    for tag, args in (("transformer", tseen["segment_attention_bwd"][0]),
                      ("autoencoder", aseen["segment_attention_bwd"][0]),
                      ("tiled", (q, k, v, seg, o, lse, do))):
        a = args[:7]
        cases.append(("segment_attention_bwd",
                      {"case": tag, "shape": list(a[0].shape),
                       "route": attention.bwd_route(a[0].shape[1],
                                                    a[0].shape[3], *a)},
                      lambda a=a: attention.segment_attention_bwd(*a)))
    ea = tseen["span_embed_bwd"][0][:5]
    cases.append(("span_embed_bwd", {"case": "transformer",
                                     "shape": list(ea[0].shape)},
                  lambda: embed.span_embed_bwd(*ea)))
    # K1's f32 forward with its log-sum-exp on the same steps' q, k, v,
    # and at R 256 (L 64, 4 heads of 64) on packed rows, random q, k, v
    pk = chip_smoke._packed_rows(256)
    seg = torch.from_numpy(pk.segments[:256]).to(dev).contiguous()
    q, k, v = (torch.randn(*seg.shape, 4, 64, generator=g).to(dev)
               for _ in range(3))
    for tag, a in (("transformer", tseen["segment_attention_bwd"][0][:4]),
                   ("autoencoder", aseen["segment_attention_bwd"][0][:4]),
                   ("R256", (q, k, v, seg))):
        R, L, H, hd = a[0].shape
        lse = torch.empty((R, H, L), device=dev)
        cases.append(("segment_attention_f32",
                      {"case": tag, "shape": [R, L, H, hd],
                       "route": attention.kernel_route(*a)},
                      lambda a=a, lse=lse: attention.segment_attention(
                          *a, lse)))
    return cases


def _k11_f32_k19_cases(dev, names) -> list:
    """K11's f32 route with its log-sum-exps on one autoencoder training
    step's decoder output (M 2048, 619 real positions) and at the served
    parity shapes (T 256 and 2048 traces of L 64 from the synthetic mix,
    d 128, the default heads); K19 on the first FFN1 gradient of one
    transformer step (2048, 1024) and one autoencoder step (2048, 512)."""
    import torch

    import chip_smoke
    from odigos_tpu_torch.features import assemble_sequences
    from odigos_tpu_torch.kernels import dense, recon
    from odigos_tpu_torch.models import (AutoencoderConfig, SpanAutoencoder,
                                         TraceTransformer, TransformerConfig)
    from odigos_tpu_torch.models.jax_init import autoencoder_state
    from odigos_tpu_torch.pdata import synthesize_traces
    from odigos_tpu_torch.training import labeled_sequences

    if not {"recon_ce_f32", "gelu_tanh_bwd"} & set(names):
        return []
    acfg = AutoencoderConfig(max_len=chip_smoke.TRAIN_LEN,
                             dtype=torch.float32)
    amodel = SpanAutoencoder(acfg, device=dev)
    amodel.load_state_dict(autoencoder_state(acfg, 0))
    aseen = chip_smoke._capture_ae_inputs(
        amodel, chip_smoke._ae_train_step_data(chip_smoke.TRAIN_TRACES - 1))
    cases = []
    if "recon_ce_f32" in names:
        args, kw = aseen["recon_ce"]
        lse = torch.empty(args[0].shape[0], 3, device=dev)
        cases.append(("recon_ce_f32", {"case": "autoencoder step",
                                       "M": args[0].shape[0],
                                       "real": int(args[6].sum())},
                      lambda: recon.recon_ce(*args[:8], eps=kw["eps"],
                                             route="cuda_core", lse=lse)))
        g = torch.Generator(device=dev).manual_seed(3)
        heads = [(torch.randn(V, 128, generator=g, device=dev) / 128 ** 0.5,
                  torch.randn(V, generator=g, device=dev) / 4)
                 for V in (512, 2048, 8, 1)]
        ln = (1 + torch.randn(128, generator=g, device=dev) / 4,
              torch.randn(128, generator=g, device=dev) / 4)
        for T in (256, 2048):
            seqs = assemble_sequences(synthesize_traces(T, seed=T),
                                      max_len=64)
            M = T * 64
            cat = torch.from_numpy(seqs.categorical.reshape(M, -1)).to(dev)
            cont = torch.from_numpy(seqs.continuous.reshape(M, -1)).to(dev)
            mask = torch.from_numpy(seqs.mask.reshape(M)).to(dev)
            dec = torch.randn(M, 128, generator=g, device=dev)
            cases.append(("recon_ce_f32", {"case": f"served T {T}", "M": M,
                                           "real": int(mask.sum())},
                          lambda dec=dec, cat=cat, cont=cont, mask=mask:
                          recon.recon_ce(dec, *ln, heads, cat, cont, mask,
                                         (1.0, 1.0, 0.5, 1.0),
                                         route="cuda_core")))
    if "gelu_tanh_bwd" in names:
        tcfg = TransformerConfig(max_len=chip_smoke.TRAIN_LEN,
                                 dtype=torch.float32)
        tseen = chip_smoke._capture_backward_inputs(
            TraceTransformer(tcfg, device=dev, seed=0),
            labeled_sequences(chip_smoke.TRAIN_TRACES - 1,
                              max_len=chip_smoke.TRAIN_LEN, seed=0,
                              pad_traces_to=chip_smoke.TRAIN_TRACES))
        for model, a in (("transformer", tseen["gelu_tanh_bwd"][0]),
                         ("autoencoder", aseen["gelu_tanh_bwd"][0])):
            dy, pre = a[:2]
            cases.append(("gelu_tanh_bwd", {"case": f"{model} step",
                                            "M": dy.shape[0],
                                            "N": dy.shape[1]},
                          lambda dy=dy, pre=pre:
                          dense.gelu_tanh_bwd(dy, pre)))
    return cases


def _k15_f32_cases(dev, names) -> list:
    """K15's f32 route on each distinct product of one training step of
    the transformer and of the autoencoder (their own inputs)."""
    if "gemm_f32" not in names:
        return []
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch_f32_forward_times as f32t
    from odigos_tpu_torch.kernels import dense

    cases, seen = [], set()
    for tag, calls in f32t._steps(dev).items():
        for name, a, k in calls:
            if name != "gemm_bf16":
                continue
            x, w, b, epi, res, planes = a[:6]
            key = (tag, x.shape[0], w.shape[0], x.shape[1], epi)
            if key in seen:
                continue
            seen.add(key)
            cases.append(("gemm_f32", {"case": tag, "M": key[1],
                                       "N": key[2], "K": key[3],
                                       "epilogue": epi, "planes": planes},
                          lambda a=a, k=k: dense.gemm_bf16(*a, **k)))
    return cases


def _gelu_bwd_launcher(name: str):
    """K19's launcher as the wrapper binds it (a first call on the card
    binds it)."""
    import torch

    from odigos_tpu_torch.kernels import dense

    if name not in dense._fns:
        z = torch.zeros(16, 4, device="cuda")
        dense.gelu_tanh_bwd(z, z)
    return dense._fns[name]


def build_variants(tmp: str, built: dict, names) -> dict:
    """Each variant of the kernels in ``names`` compiled (one ``nvcc`` per
    variant, all started together) and loaded, with the argument types of
    the wrapper's own launcher (``built``)."""
    from odigos_tpu_torch.kernels import build

    procs = {}
    for kname in names:
        source, launcher = LAUNCHERS[kname]
        src = (build.CSRC / build.SOURCES[source]).read_text()
        for vname, edits in VARIANTS.get(kname, {}).items():
            text = src
            for anchor, repl in edits.items():
                if anchor not in text:
                    raise RuntimeError(f"{kname}/{vname}: anchor not in "
                                       f"source: {anchor[:60]!r}")
                text = text.replace(anchor, repl)
            cu = os.path.join(tmp, f"{kname}-{vname}.cu")
            with open(cu, "w") as f:
                f.write(text)
            so = cu[:-3] + ".so"
            procs[(kname, vname)] = (subprocess.Popen(
                [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
                 "-o", so, cu],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), so)
    fns = {}
    for (kname, vname), (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{kname}/{vname} failed to build:\n{log}")
        fn = getattr(ctypes.CDLL(so), LAUNCHERS[kname][1])
        fn.argtypes = built[kname].argtypes
        fn.restype = ctypes.c_int
        fns[(kname, vname)] = fn
    return fns


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels", default=",".join(LAUNCHERS),
                    help="comma-separated kernels to ablate (default: all)")
    args = ap.parse_args()
    names = [k for k in args.kernels.split(",") if k]
    unknown = [k for k in names if k not in LAUNCHERS]
    if unknown:
        ap.error(f"unknown kernels {unknown} (known: {list(LAUNCHERS)})")
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    import chip_smoke
    from odigos_tpu_torch.kernels import (attention, build, dense, embed,
                                          featurize, head, pack, pool,
                                          qgemm, quant, recon, sort, zscore)
    from odigos_tpu_torch.models import (AutoencoderConfig,
                                         QuantizedTraceScorer,
                                         SpanAutoencoder, TraceTransformer,
                                         TransformerConfig)
    from odigos_tpu_torch.serving.engine import BucketLadder

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    build.build()
    modules = {"segment_attention": attention,
               "segment_attention_f32": attention, "span_embed": embed,
               "qgemm": qgemm, "qgemm_ffn1": qgemm, "ln_quantize": quant,
               "radix_sort": sort, "next_fit_pack": pack, "recon_ce": recon,
               "gemm_bf16": dense, "ln_bf16": dense, "gemm_f32": dense,
               "featurize_columns": featurize, "trace_rows_pack": pack,
               "ln_masked_pool": pool, "span_head_scatter": head,
               "zscore_score_update": zscore}
    from odigos_tpu_torch.kernels import ring as kring

    modules.update(recon_ce_bwd=recon, ln_masked_pool_bwd=pool, ln_bwd=dense,
                   ring_block_attention=kring, recon_ce_f32=recon,
                   gelu_tanh_bwd=dense)
    # a wrapper's launcher kept under its own names (getter, cache)
    own = {"trace_rows_pack": ("_rows_kernel", "_rows_fn"),
           "segment_attention_bwd": ("_bwd_kernel", "_bwd_fn")}
    modules.update(segment_attention_bwd=attention, span_embed_bwd=embed)
    # the backward kernels' launchers: (getter, cache dict)
    bwd = {"recon_ce_bwd": (recon._bwd_kernel, recon._fns),
           "ln_masked_pool_bwd": (pool._bwd_kernel, pool._bwd_fns),
           "ln_bwd": (lambda _name: dense._ln_bwd_kernel(), dense._fns),
           "span_embed_bwd": (embed._bwd_kernel, embed._bwd_fns),
           "gelu_tanh_bwd": (_gelu_bwd_launcher, dense._fns)}

    def launcher(kname: str):
        m = modules[kname]
        if kname in bwd:
            return bwd[kname][0](LAUNCHERS[kname][1])
        if kname in own:
            return getattr(m, own[kname][0])()
        if hasattr(m, "_fns"):  # a library of several launchers
            return m._kernel(LAUNCHERS[kname][1])
        return m._kernel()

    def swap(kname: str, fn) -> None:
        m = modules[kname]
        if kname in bwd:
            bwd[kname][1][LAUNCHERS[kname][1]] = fn
        elif kname in own:
            setattr(m, own[kname][1], fn)
        elif hasattr(m, "_fns"):
            m._fns[LAUNCHERS[kname][1]] = fn
        else:
            m._fn = fn

    built = {k: launcher(k) for k in names}
    dev = torch.device("cuda")
    scratch = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    # (kernel, shape, call) on the smoke run's inputs
    cases: list[tuple[str, dict, object]] = []
    cfg = TransformerConfig()
    H = cfg.n_heads
    hd = cfg.d_model // H
    with torch.inference_mode():
        enc = TraceTransformer(cfg, device=dev, seed=0).module.encoder
        tables = enc.tables()
        qblk = QuantizedTraceScorer(cfg, device=dev, seed=0)._blocks[0]
        pk = chip_smoke._packed_rows(max(chip_smoke.R_SHAPES))
        for R in chip_smoke.R_SHAPES:
            def rows(a, dtype):
                return torch.from_numpy(a[:R]).to(dev, dtype).contiguous()

            cat = rows(pk.categorical, torch.int32)
            cont = rows(pk.continuous, torch.float32)
            seg = rows(pk.segments, torch.int32)
            pos = rows(pk.positions, torch.int32)
            x = embed.span_embed_plain(cat, cont, pos, seg, tables,
                                       cfg.dtype)
            blk = enc.blocks[0]
            L = cat.shape[1]
            x2 = x.view(R * L, -1)
            q, k, v = dense.gemm_bf16(blk.ln1(x2), *blk.qkv(),
                                      planes=3).view(3, R, L, H, hd)
            h2 = blk.ln2(x2)
            xq, a_s = quant.ln_quantize(x2, *qblk.ln1)
            # FFN1's input: LN2 of the embedding (the block's x1 is a
            # residual step away; the product's shapes are the same)
            hq, h_s = quant.ln_quantize(x2, *qblk.ln2)
            ff1, qkv = qblk.ff1, qblk.qkv
            shape = {"R": R}
            cases += [
                ("segment_attention", shape,
                 lambda q=q, k=k, v=v, seg=seg:
                 attention.segment_attention(q, k, v, seg)),
                ("span_embed", shape,
                 lambda cat=cat, cont=cont, pos=pos, seg=seg:
                 embed.span_embed(cat, cont, pos, seg, tables, cfg.dtype)),
                ("qgemm", shape,
                 lambda xq=xq, a_s=a_s: qgemm.qgemm(
                     xq, qkv.w, a_s, qkv.s, qkv.b, cfg.dtype, planes=3)),
                ("ln_quantize", shape,
                 lambda x2=x2: quant.ln_quantize(x2, *qblk.ln1)),
                ("qgemm_ffn1", shape,
                 lambda hq=hq, h_s=h_s: qgemm.qgemm(
                     hq, ff1.w, h_s, ff1.s, ff1.b, cfg.dtype,
                     "gelu_tanh_quant")),
                ("gemm_bf16", shape,
                 lambda h2=h2: dense.gemm_bf16(h2, blk.ff1.weight,
                                               blk.ff1.bias, "gelu_tanh")),
                ("ln_bf16", shape,
                 lambda x2=x2: dense.ln_bf16(x2, blk.ln1.weight,
                                             blk.ln1.bias))]
        # K6's trace sort and K7 on the fused route's staged frames
        ladder = BucketLadder(256, 4)
        for N in (chip_smoke.FUSED_MAIN_N, max(chip_smoke.FUSED_N)):
            n, svc_t, nam_t, c = chip_smoke._staged(
                chip_smoke._fused_frame(N, "otel"), dev)
            keys = [c["trace_id_hi"], c["trace_id_lo"], c["start_unix_nano"]]
            fcat, fcont = featurize.featurize_columns(
                svc_t, nam_t, c["service"], c["name"], c["kind"],
                c["status_code"], c["span_id"], c["parent_span_id"],
                c["start_unix_nano"], c["end_unix_nano"], c["frame"], n)
            perm = sort.radix_sort(keys, n)
            R = ladder.round_rows(2 * n // cfg.max_len + 2)
            if N == chip_smoke.FUSED_MAIN_N:
                cases.append(("radix_sort", {"N": N, "n": n},
                              lambda keys=keys, n=n: sort.radix_sort(keys,
                                                                     n)))
            cases.append(("next_fit_pack", {"N": N, "n": n, "R": R},
                          lambda perm=perm, c=c, fcat=fcat, fcont=fcont, n=n,
                          R=R: pack.next_fit_pack(
                              perm, c["trace_id_hi"], c["trace_id_lo"],
                              fcat, fcont, n, cfg.max_len, R)))
        # K5 on the smoke's otel, adversarial and stress frames (its hash
        # join included); K13 at the autoencoder's fused R (one row a
        # possible trace: R = 4096, an engine call of 4096 traces, the
        # 65536-span bucket)
        from odigos_tpu_torch.pdata import synthesize_traces

        for kind in ("otel", "adversarial", "stress"):
            for N in chip_smoke.FUSED_N:
                n, svc_t, nam_t, c = chip_smoke._staged(
                    chip_smoke._stress_frames(N) if kind == "stress"
                    else chip_smoke._fused_frame(N, kind), dev)
                fargs = (svc_t, nam_t, c["service"], c["name"], c["kind"],
                         c["status_code"], c["span_id"], c["parent_span_id"],
                         c["start_unix_nano"], c["end_unix_nano"],
                         c["frame"])
                cases.append(("featurize_columns",
                              {"N": N, "n": n, "mix": kind},
                              lambda fargs=fargs, n=n:
                              featurize.featurize_columns(*fargs, n)))
        for key, batch in (
                ("otel_N4096", chip_smoke._fused_frame(4096, "otel")),
                ("engine_call_4096_traces",
                 synthesize_traces(4096, seed=301)),
                ("otel_N65536", chip_smoke._fused_frame(65536, "otel"))):
            n, svc_t, nam_t, c = chip_smoke._staged(batch, dev)
            fcat, fcont = featurize.featurize_columns(
                svc_t, nam_t, c["service"], c["name"], c["kind"],
                c["status_code"], c["span_id"], c["parent_span_id"],
                c["start_unix_nano"], c["end_unix_nano"], c["frame"], n)
            perm = sort.radix_sort([c["trace_id_hi"], c["trace_id_lo"],
                                    c["start_unix_nano"]], n)
            R = ladder.round_rows(n)
            cases.append(("trace_rows_pack", {"frame": key, "n": n, "R": R},
                          lambda perm=perm, c=c, fcat=fcat, fcont=fcont, n=n,
                          R=R: pack.trace_rows_pack(
                              perm, c["trace_id_hi"], c["trace_id_lo"],
                              fcat, fcont, n, 64, R)))
        # K11 on the default autoencoder's decoder output (its parameters
        # made outside inference_mode: the planes are cached, as served)
        acfg = AutoencoderConfig()
        with torch.inference_mode(False):
            ae = SpanAutoencoder(acfg, device=dev, seed=0)
        m = ae.module
        wts = (acfg.w_service, acfg.w_name, acfg.w_kind, acfg.w_duration)
        for T in chip_smoke.AE_T + (4096,):
            cat, cont, mask = chip_smoke._ae_rows(T, dev)
            dec = ae._decode(cat, cont, mask, reference=False)
            M = T * acfg.max_len
            rargs = (dec, m.dec_ln.weight, m.dec_ln.bias, m.heads(),
                     cat.reshape(M, -1), cont.reshape(M, -1),
                     mask.reshape(M), wts)
            cases.append(("recon_ce", {"T": T},
                          lambda rargs=rargs: recon.recon_ce(
                              *rargs, planes=m.head_planes())))
        # K12 on the encoder's pre-LN state at T = 256 and 2048, and at an
        # engine call's shape (4096 traces packed by K13 into round_rows(n)
        # rows, with K13's count)
        enc_ae = m.encoder
        fl = enc_ae.final_ln
        Lae = acfg.max_len
        for T in chip_smoke.AE_T:
            cat, cont, mask = chip_smoke._ae_rows(T, dev)
            pos = torch.arange(Lae, dtype=torch.int32, device=dev).expand(
                T, Lae).contiguous()
            h = enc_ae(cat, cont, pos, mask.to(torch.int32), final_ln=False)
            cases.append(("ln_masked_pool", {"T": T},
                          lambda h=h, mask=mask: pool.ln_masked_pool(
                              h, fl.weight, fl.bias, mask, fl.eps)))
        n, svc_t, nam_t, c = chip_smoke._staged(
            synthesize_traces(4096, seed=301), dev)
        fcat, fcont = featurize.featurize_columns(
            svc_t, nam_t, c["service"], c["name"], c["kind"],
            c["status_code"], c["span_id"], c["parent_span_id"],
            c["start_unix_nano"], c["end_unix_nano"], c["frame"], n)
        perm = sort.radix_sort([c["trace_id_hi"], c["trace_id_lo"],
                                c["start_unix_nano"]], n)
        R = ladder.round_rows(n)
        tr = pack.trace_rows_pack(perm, c["trace_id_hi"], c["trace_id_lo"],
                                  fcat, fcont, n, Lae, R)
        pos = torch.arange(Lae, dtype=torch.int32, device=dev).expand(
            R, Lae).contiguous()
        h_eng = enc_ae(tr.categorical, tr.continuous, pos,
                       tr.mask.to(torch.int32), final_ln=False,
                       live=tr.rows_used)
        cases.append(("ln_masked_pool", {"R": R, "live": True},
                      lambda: pool.ln_masked_pool(h_eng, fl.weight, fl.bias,
                                                  tr.mask, fl.eps,
                                                  live=tr.rows_used)))
        # K8 on the default transformer's encoder output over next-fit's
        # rows at the span buckets (chip_smoke phase 7's inputs)
        tmodel = TraceTransformer(cfg, device=dev, seed=0)
        tenc = tmodel.module.encoder
        for N in chip_smoke.FUSED_N:
            n, svc_t, nam_t, c = chip_smoke._staged(
                chip_smoke._fused_frame(N, "otel"), dev)
            fcat, fcont = featurize.featurize_columns(
                svc_t, nam_t, c["service"], c["name"], c["kind"],
                c["status_code"], c["span_id"], c["parent_span_id"],
                c["start_unix_nano"], c["end_unix_nano"], c["frame"], n)
            perm = sort.radix_sort([c["trace_id_hi"], c["trace_id_lo"],
                                    c["start_unix_nano"]], n)
            R = ladder.round_rows(2 * n // cfg.max_len + 2)
            pk = pack.next_fit_pack(perm, c["trace_id_hi"], c["trace_id_lo"],
                                    fcat, fcont, n, cfg.max_len, R)
            h = tenc(pk.categorical, pk.continuous, pk.positions,
                     pk.segments, final_ln=False)
            hargs = (h, tenc.final_ln.weight, tenc.final_ln.bias,
                     tmodel.module.span_head.weight,
                     tmodel.module.span_head.bias, perm, pk.row_eff,
                     pk.span_col, n)
            cases.append(("span_head_scatter", {"N": N, "n": n, "R": R},
                          lambda hargs=hargs: head.span_head_scatter(
                              *hargs)))
        # K14 at the autoencoder's d 128 (T = 2048), and at the fused
        # transformer's R = 2048 rows with next-fit's real rows as the count
        ln = m.encoder.blocks[0].ln1
        g = torch.Generator(device=dev).manual_seed(0)
        x128 = (torch.randn(2048 * 64, 128, generator=g, device=dev) * 3
                + 1).to(torch.bfloat16)
        cases.append(("ln_bf16", {"T": 2048, "d": 128},
                      lambda: dense.ln_bf16(x128, ln.weight, ln.bias)))
        from odigos_tpu_torch.features import featurize as host_featurize
        from odigos_tpu_torch.features import pack_sequences

        b4096 = synthesize_traces(4096, seed=103)
        real = torch.tensor([pack_sequences(b4096, host_featurize(b4096),
                                            max_len=64).n_rows],
                            dtype=torch.int32, device=dev)
        blk = enc.blocks[0]
        x256 = (torch.randn(2048 * 64, 256, generator=g, device=dev) * 3
                + 1).to(torch.bfloat16)
        cases.append(("ln_bf16", {"R": 2048, "live": int(real.item())},
                      lambda: dense.ln_bf16(x256, blk.ln1.weight,
                                            blk.ln1.bias, live=real,
                                            per=64)))
    if "zscore_score_update" in names:
        cases += _zscore_cases(dev)
    if {"recon_ce_bwd", "ln_masked_pool_bwd"} & set(names):
        cases += _training_cases(dev)
    cases += _k17_k22_cases(dev, names)
    cases += _k16_k18_cases(dev, names)
    cases += _k15_f32_cases(dev, names)
    cases += _k11_f32_k19_cases(dev, names)
    cases = [cs for cs in cases if cs[0] in names]

    with tempfile.TemporaryDirectory() as tmp, torch.inference_mode():
        fns = build_variants(tmp, built, names)
        fns.update({(k, "unchanged"): fn for k, fn in built.items()})
        for kname, shape, call in cases:
            for (kn, vname), fn in sorted(fns.items()):
                if kn != kname:
                    continue
                swap(kname, fn)
                try:
                    ms = chip_smoke.device_ms(call, scratch.zero_)
                finally:
                    swap(kname, built[kname])
                print(json.dumps({"kernel": kname, "variant": vname,
                                  **shape, "device_ms": ms, "card": card}),
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

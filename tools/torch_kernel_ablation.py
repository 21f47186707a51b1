#!/usr/bin/env python3
"""Where a port kernel's time goes, by ablation, on one GPU.

    python3 tools/torch_kernel_ablation.py

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
frame at N = 65536). Times are
``chip_smoke.device_ms``: CUDA-event medians with the L2 flushed and the
host's enqueue kept out. Variants compute wrong results on purpose; only
the unchanged build is held to the plain version.

Prints the card's name and power limit, then one JSON line per (kernel,
variant, R). Imports nothing of JAX or of the JAX package; needs a CUDA
device and ``nvcc``.
"""

from __future__ import annotations

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
VARIANTS = {
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
}


# kernel -> (source under build.SOURCES, its C launcher)
LAUNCHERS = {"segment_attention": ("segment_attention",
                                   "segment_attention_launch"),
             "span_embed": ("span_embed", "span_embed_launch"),
             "qgemm": ("qgemm", "qgemm_launch"),
             "qgemm_ffn1": ("qgemm", "qgemm_launch"),
             "ln_quantize": ("quant", "ln_quantize_launch"),
             "radix_sort": ("trace_sort", "radix_sort_launch"),
             "gemm_bf16": ("dense", "gemm_bf16_launch")}

ARGTYPES = {
    "segment_attention": ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                          + [ctypes.c_float, ctypes.c_float,
                             ctypes.c_void_p]),
    "span_embed": [ctypes.c_void_p] * 13 + [ctypes.c_int] * 9
                  + [ctypes.c_void_p],
    "qgemm": ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 2
              + [ctypes.c_longlong] + [ctypes.c_int] * 3 + [ctypes.c_void_p]),
    "qgemm_ffn1": ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 2
                   + [ctypes.c_longlong] + [ctypes.c_int] * 3
                   + [ctypes.c_void_p]),
    "ln_quantize": [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_void_p],
    "radix_sort": ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                    ctypes.c_longlong] + [ctypes.c_void_p] * 4),
    "gemm_bf16": ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
                  + [ctypes.c_longlong] + [ctypes.c_int] * 3
                  + [ctypes.c_void_p]),
}


def build_variants(tmp: str) -> dict:
    from odigos_tpu_torch.kernels import build

    procs = {}
    for kname, variants in VARIANTS.items():
        source, launcher = LAUNCHERS[kname]
        src = (build.CSRC / build.SOURCES[source]).read_text()
        for vname, edits in variants.items():
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
        fn.argtypes = ARGTYPES[kname]
        fn.restype = ctypes.c_int
        fns[(kname, vname)] = fn
    return fns


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    import chip_smoke
    from odigos_tpu_torch.kernels import (attention, build, dense, embed,
                                          qgemm, quant, sort)
    from odigos_tpu_torch.models import (QuantizedTraceScorer,
                                         TraceTransformer, TransformerConfig)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    build.build()
    modules = {"segment_attention": attention, "span_embed": embed,
               "qgemm": qgemm, "radix_sort": sort}
    built = {k: m._kernel() for k, m in modules.items()}
    built["gemm_bf16"] = dense._kernel("gemm_bf16_launch")
    built["qgemm_ffn1"] = built["qgemm"]
    modules["qgemm_ffn1"] = qgemm
    modules["ln_quantize"] = quant
    built["ln_quantize"] = quant._kernel()

    def swap(kname: str, fn) -> None:
        if kname == "gemm_bf16":
            dense._fns["gemm_bf16_launch"] = fn
        else:
            modules[kname]._fn = fn

    with tempfile.TemporaryDirectory() as tmp:
        fns = build_variants(tmp)
        fns.update({(k, "unchanged"): fn for k, fn in built.items()})
        dev = torch.device("cuda")
        cfg = TransformerConfig()
        enc = TraceTransformer(cfg, device=dev, seed=0).module.encoder
        tables = enc.tables()
        qblk = QuantizedTraceScorer(cfg, device=dev, seed=0)._blocks[0]
        pk = chip_smoke._packed_rows(max(chip_smoke.R_SHAPES))
        N = chip_smoke.FUSED_MAIN_N
        n, _, _, c = chip_smoke._staged(chip_smoke._fused_frame(N, "otel"),
                                        dev)
        trace_keys = [c["trace_id_hi"], c["trace_id_lo"],
                      c["start_unix_nano"]]
        scratch = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
        H = cfg.n_heads
        hd = cfg.d_model // H
        with torch.inference_mode():
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
                xq, a_s = quant.ln_quantize(x.view(R * L, -1), *qblk.ln1)
                # FFN1's input: LN2 of the embedding (the block's x1 is a
                # residual step away; the product's shapes are the same)
                hq, h_s = quant.ln_quantize(x.view(R * L, -1), *qblk.ln2)
                ff1 = qblk.ff1
                qkv = qblk.qkv
                calls = {
                    "segment_attention": lambda: attention.segment_attention(
                        q, k, v, seg),
                    "span_embed": lambda: embed.span_embed(
                        cat, cont, pos, seg, tables, cfg.dtype),
                    "qgemm": lambda: qgemm.qgemm(
                        xq, qkv.w, a_s, qkv.s, qkv.b, cfg.dtype, planes=3),
                    "ln_quantize": lambda: quant.ln_quantize(
                        x.view(R * L, -1), *qblk.ln1),
                    "qgemm_ffn1": lambda: qgemm.qgemm(
                        hq, ff1.w, h_s, ff1.s, ff1.b, cfg.dtype,
                        "gelu_tanh_quant"),
                    "gemm_bf16": lambda: dense.gemm_bf16(
                        h2, blk.ff1.weight, blk.ff1.bias, "gelu_tanh"),
                    "radix_sort": lambda: sort.radix_sort(trace_keys, n)}
                for (kname, vname), fn in sorted(fns.items()):
                    if kname == "radix_sort" and R != max(
                            chip_smoke.R_SHAPES):
                        continue  # one shape: the trace sort at N
                    swap(kname, fn)
                    try:
                        ms = chip_smoke.device_ms(calls[kname],
                                                  scratch.zero_)
                    finally:
                        swap(kname, built[kname])
                    shape = ({"N": N, "n": n} if kname == "radix_sort"
                             else {"R": R})
                    print(json.dumps({"kernel": kname, "variant": vname,
                                      **shape, "device_ms": ms,
                                      "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Device times of the port's kernels at the default geometries, one JSON
line each, for an A/B of two checkouts on one card.

    python3 tools/torch_default_times.py [--label NAME] [--kernels K,...]

Times K1 ``segment_attention`` (the default transformer's first block,
R = 256 and 2048 packed rows), K9 ``ln_quantize`` (LN1 at R = 2048, and
plain mode at K = 1024, the GELU output's width), K11 ``recon_ce`` (the
default autoencoder's decoder output, T = 256 and 2048 traces), K12
``ln_masked_pool`` (its encoder's hidden state at T = 256 and 2048, and
at an engine call's own shape: 4096 traces packed by K13 into R =
``round_rows(n)`` rows, with K13's trace count where the wrapper takes
one), K8 ``span_head_scatter`` (the default transformer's encoder output
over next-fit's rows at the span buckets N = 4096, 65536 and 131072) and
K14 ``ln_bf16`` (LN1 at R = 2048, the autoencoder's d 128 at T = 2048)
with ``chip_smoke.device_ms`` (CUDA-event medians, L2 flushed, the host's
enqueue kept out) on the smoke run's own inputs. It uses only what the
checkout it sits in already had before this script (``chip_smoke``'s
inputs and timer, the kernels' wrappers), so a copy placed in an older
checkout's ``tools/`` times that checkout: run the two in turns (parent,
change, change, parent) in one call to compare them on one card.
Imports nothing of JAX or of the JAX package; needs a CUDA device.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = ("segment_attention", "ln_quantize", "ln_bf16", "recon_ce",
           "ln_masked_pool", "span_head_scatter")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default=os.path.basename(ROOT))
    ap.add_argument("--kernels", default=",".join(KERNELS),
                    help="comma-separated kernels to time (default: all)")
    args = ap.parse_args()
    names = set(k for k in args.kernels.split(",") if k)
    if names - set(KERNELS):
        ap.error(f"unknown kernels {sorted(names - set(KERNELS))} (known: "
                 f"{list(KERNELS)})")
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    import chip_smoke
    from odigos_tpu_torch.kernels import (attention, build, dense, embed,
                                          featurize, head, pack, pool, quant,
                                          recon, sort)
    from odigos_tpu_torch.models import (AutoencoderConfig,
                                         QuantizedTraceScorer,
                                         SpanAutoencoder, TraceTransformer,
                                         TransformerConfig)
    from odigos_tpu_torch.pdata import synthesize_traces
    from odigos_tpu_torch.serving.engine import BucketLadder

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    build.build()
    dev = torch.device("cuda")
    scratch = torch.empty(128 << 20, dtype=torch.uint8, device=dev)

    def emit(kernel: str, shape: dict, fn) -> None:
        if kernel not in names:
            return
        ms = chip_smoke.device_ms(fn, scratch.zero_)
        print(json.dumps({"label": args.label, "kernel": kernel, **shape,
                          "device_ms": ms, "card": card}), flush=True)

    cfg = TransformerConfig()
    H, hd = cfg.n_heads, cfg.d_model // cfg.n_heads
    with torch.inference_mode():
        enc = TraceTransformer(cfg, device=dev, seed=0).module.encoder
        qblk = QuantizedTraceScorer(cfg, device=dev, seed=0)._blocks[0]
        blk = enc.blocks[0]
        pk = chip_smoke._packed_rows(max(chip_smoke.R_SHAPES))
        for R in chip_smoke.R_SHAPES:
            def rows(a, dtype):
                return torch.from_numpy(a[:R]).to(dev, dtype).contiguous()

            cat, cont = rows(pk.categorical, torch.int32), rows(
                pk.continuous, torch.float32)
            seg, pos = rows(pk.segments, torch.int32), rows(
                pk.positions, torch.int32)
            x = embed.span_embed(cat, cont, pos, seg, enc.tables(),
                                 cfg.dtype)
            L = x.shape[1]
            x2 = x.view(R * L, -1)
            q, k, v = dense.gemm_bf16(blk.ln1(x2), *blk.qkv(),
                                      planes=3).view(3, R, L, H, hd)
            emit("segment_attention", {"R": R},
                 lambda q=q, k=k, v=v, seg=seg:
                 attention.segment_attention(q, k, v, seg))
            if R == max(chip_smoke.R_SHAPES):
                emit("ln_quantize", {"R": R, "step": "ln1"},
                     lambda x2=x2: quant.ln_quantize(x2, *qblk.ln1))
                g = torch.Generator(device=dev).manual_seed(1)
                wide = torch.randn(R * L, cfg.d_ff, generator=g,
                                   device=dev).to(cfg.dtype)
                emit("ln_quantize", {"R": R, "step": "gelu_out", "K":
                                     cfg.d_ff},
                     lambda wide=wide: quant.ln_quantize(wide))
                ln = blk.ln1
                emit("ln_bf16", {"R": R, "step": "ln1", "d": cfg.d_model},
                     lambda x2=x2: dense.ln_bf16(x2, ln.weight, ln.bias,
                                                 ln.eps))
        del enc, qblk, blk
        acfg = AutoencoderConfig()
        with torch.inference_mode(False):
            ae = SpanAutoencoder(acfg, device=dev, seed=0)
        m = ae.module
        wts = (acfg.w_service, acfg.w_name, acfg.w_kind, acfg.w_duration)
        for T in chip_smoke.AE_T:
            cat, cont, mask = chip_smoke._ae_rows(T, dev)
            Lae = mask.shape[1]
            dec = ae._decode(cat, cont, mask, reference=False)
            M = T * Lae
            rargs = (dec, m.dec_ln.weight, m.dec_ln.bias, m.heads(),
                     cat.reshape(M, -1), cont.reshape(M, -1),
                     mask.reshape(M), wts)
            planes = m.head_planes()
            emit("recon_ce", {"T": T},
                 lambda rargs=rargs: recon.recon_ce(*rargs, planes=planes))
            seg = mask.to(torch.int32).contiguous()
            pos = torch.arange(Lae, dtype=torch.int32, device=dev
                               ).expand(T, Lae).contiguous()
            h = m.encoder(cat, cont, pos, seg, final_ln=False)
            fl = m.encoder.final_ln
            emit("ln_masked_pool", {"T": T},
                 lambda h=h, mask=mask: pool.ln_masked_pool(
                     h, fl.weight, fl.bias, mask, fl.eps))
            if T == max(chip_smoke.AE_T):
                x = embed.span_embed(cat, cont, pos, seg,
                                     m.encoder.tables(), acfg.dtype)
                x2 = x.view(T * Lae, -1)
                ln = m.encoder.blocks[0].ln1
                emit("ln_bf16", {"T": T, "step": "ae_ln1",
                                 "d": acfg.d_model},
                     lambda x2=x2: dense.ln_bf16(x2, ln.weight, ln.bias,
                                                 ln.eps))
            del h
        # K12 at an engine call's own shape: 4096 traces packed by K13 one
        # a row into round_rows(n) rows, the encoder run with K13's count
        # as the fused route runs it, K12 given the count where it takes one
        if "ln_masked_pool" in names:
            ladder = BucketLadder(256, 4)  # EngineConfig's default ladder
            n, svc_t, nam_t, c = chip_smoke._staged(
                synthesize_traces(4096, seed=301), dev)
            fcat, fcont = featurize.featurize_columns(
                svc_t, nam_t, c["service"], c["name"], c["kind"],
                c["status_code"], c["span_id"], c["parent_span_id"],
                c["start_unix_nano"], c["end_unix_nano"], c["frame"], n)
            perm = sort.radix_sort([c["trace_id_hi"], c["trace_id_lo"],
                                    c["start_unix_nano"]], n)
            R = ladder.round_rows(n)
            tr = pack.trace_rows_pack(perm, c["trace_id_hi"],
                                      c["trace_id_lo"], fcat, fcont, n, Lae,
                                      R)
            seg = tr.mask.to(torch.int32).contiguous()
            pos = torch.arange(Lae, dtype=torch.int32, device=dev).expand(
                R, Lae).contiguous()
            h = m.encoder(tr.categorical, tr.continuous, pos, seg,
                          final_ln=False, live=tr.rows_used)
            fl = m.encoder.final_ln
            takes_live = "live" in inspect.signature(
                pool.ln_masked_pool).parameters
            extra = {"live": tr.rows_used} if takes_live else {}
            emit("ln_masked_pool", {
                "shape": "engine_call_4096_traces", "R": R, "n": n,
                "traces": int(tr.rows_used.item()), "with_live": takes_live},
                lambda: pool.ln_masked_pool(h, fl.weight, fl.bias, tr.mask,
                                            fl.eps, **extra))
            del h, tr
        del ae, m
        # K8 on the default transformer's encoder output over next-fit's
        # rows, as phase 7 of chip_smoke gives it
        if "span_head_scatter" in names:
            model = TraceTransformer(cfg, device=dev, seed=0)
            enc = model.module.encoder
            ladder = BucketLadder(256, 4)
            for N in chip_smoke.FUSED_N:
                n, svc_t, nam_t, c = chip_smoke._staged(
                    chip_smoke._fused_frame(N, "otel"), dev)
                fcat, fcont = featurize.featurize_columns(
                    svc_t, nam_t, c["service"], c["name"], c["kind"],
                    c["status_code"], c["span_id"], c["parent_span_id"],
                    c["start_unix_nano"], c["end_unix_nano"], c["frame"], n)
                perm = sort.radix_sort([c["trace_id_hi"], c["trace_id_lo"],
                                        c["start_unix_nano"]], n)
                L = cfg.max_len
                R = ladder.round_rows(2 * n // L + 2)
                pk = pack.next_fit_pack(perm, c["trace_id_hi"],
                                        c["trace_id_lo"], fcat, fcont, n, L,
                                        R)
                h = enc(pk.categorical, pk.continuous, pk.positions,
                        pk.segments, final_ln=False)
                ln = enc.final_ln
                hargs = (h, ln.weight, ln.bias,
                         model.module.span_head.weight,
                         model.module.span_head.bias, perm, pk.row_eff,
                         pk.span_col, n)
                emit("span_head_scatter", {"N": N, "n": n, "R": R},
                     lambda hargs=hargs: head.span_head_scatter(*hargs))
    return 0


if __name__ == "__main__":
    sys.exit(main())

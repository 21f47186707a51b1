#!/usr/bin/env python3
"""Device times of the port's kernels at the default geometries, one JSON
line each, for an A/B of two checkouts on one card.

    python3 tools/torch_default_times.py [--label NAME]

Times K1 ``segment_attention`` (the default transformer's first block,
R = 256 and 2048 packed rows), K9 ``ln_quantize`` (LN1 at R = 2048, and
plain mode at K = 1024, the GELU output's width), K11 ``recon_ce`` (the
default autoencoder's decoder output, T = 256 and 2048 traces), K12
``ln_masked_pool`` (its encoder's hidden state, T = 2048) and K14
``ln_bf16`` (LN1 at R = 2048, the autoencoder's d 128 at T = 2048) with
``chip_smoke.device_ms`` (CUDA-event medians, L2 flushed, the host's
enqueue kept out) on the smoke run's own inputs. It uses only what the
checkout it sits in already had before this script (``chip_smoke``'s
inputs and timer, the kernels' wrappers), so a copy placed in an older
checkout's ``tools/`` times that checkout: run the two in turns (parent,
change, change, parent) in one call to compare them on one card.
Imports nothing of JAX or of the JAX package; needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default=os.path.basename(ROOT))
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    import chip_smoke
    from odigos_tpu_torch.kernels import (attention, build, dense, embed,
                                          pool, quant, recon)
    from odigos_tpu_torch.models import (AutoencoderConfig,
                                         QuantizedTraceScorer,
                                         SpanAutoencoder, TraceTransformer,
                                         TransformerConfig)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    build.build()
    dev = torch.device("cuda")
    scratch = torch.empty(128 << 20, dtype=torch.uint8, device=dev)

    def emit(kernel: str, shape: dict, fn) -> None:
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
            if T == max(chip_smoke.AE_T):
                seg = mask.to(torch.int32).contiguous()
                pos = torch.arange(Lae, dtype=torch.int32, device=dev
                                   ).expand(T, Lae).contiguous()
                h = m.encoder(cat, cont, pos, seg, final_ln=False)
                fl = m.encoder.final_ln
                emit("ln_masked_pool", {"T": T},
                     lambda h=h: pool.ln_masked_pool(h, fl.weight, fl.bias,
                                                     mask, fl.eps))
                x = embed.span_embed(cat, cont, pos, seg,
                                     m.encoder.tables(), acfg.dtype)
                x2 = x.view(T * Lae, -1)
                ln = m.encoder.blocks[0].ln1
                emit("ln_bf16", {"T": T, "step": "ae_ln1",
                                 "d": acfg.d_model},
                     lambda x2=x2: dense.ln_bf16(x2, ln.weight, ln.bias,
                                                 ln.eps))
    return 0


if __name__ == "__main__":
    sys.exit(main())

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
K14 ``ln_bf16`` (LN1 at R = 2048, the autoencoder's d 128 at T = 2048),
and the zscore detector's K3 ``zscore_update`` and K4 ``zscore_score``
(``squash=True``) on ``chip_smoke``'s otel-demo and single-group mixes at
N = 4096, 65536 and 131072 spans, G = 8192, each alone and as an engine
call launches them (``zscore_score_update``: the one-launch function in
place on the two id columns where the checkout has it, else K4, its cold
counter's fill and K3 in turn; ``zscore_score_only``: an engine call
without the online update, the one launch's score alone into a buffer
whose cold word the caller zeroed, else K4 and its fill)
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
           "ln_masked_pool", "span_head_scatter", "zscore_update",
           "zscore_score", "zscore_score_update", "zscore_score_only")
ZSCORE = ("zscore_update", "zscore_score", "zscore_score_update",
          "zscore_score_only")


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

    with torch.inference_mode():
        _zscore_times(names, emit, dev)
    if not names - set(ZSCORE):
        return 0
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


def _zscore_times(names: set, emit, dev) -> None:
    """K3 and K4 on phase 4's inputs: from a state fitted on 20,000 otel
    spans, each alone on the ``(N, C)`` featurized ids, and an engine
    call's launches on the staged batch."""
    if not names & set(ZSCORE):
        return
    import torch

    import chip_smoke
    from odigos_tpu_torch.kernels import zscore

    G, mc = chip_smoke.ZS_G, chip_smoke.ZS_MIN_COUNT
    one_launch = hasattr(zscore, "zscore_score_update")
    mixes = chip_smoke._zs_mixes(max(chip_smoke.ZS_N))
    cat0, x0 = (torch.from_numpy(a[:20000]).to(dev) for a in mixes["otel"])
    zero = [torch.zeros(G, device=dev) for _ in range(3)]
    state = zscore.zscore_update_plain(*zero, cat0, x0, torch.ones_like(x0),
                                       G)
    sums = zscore.new_scratch(G, dev)
    for mix, (cat_np, x_np) in mixes.items():
        for N in chip_smoke.ZS_N:
            cat = torch.from_numpy(cat_np[:N]).to(dev)
            x = torch.from_numpy(x_np[:N]).to(dev)
            w = torch.ones_like(x)
            shape = {"N": N, "mix": mix, "G": G}
            emit("zscore_update", shape,
                 lambda cat=cat, x=x, w=w: zscore.zscore_update(
                     *state, cat, x, w, G, scratch=sums))
            emit("zscore_score", shape,
                 lambda cat=cat, x=x: zscore.zscore_score(
                     *state, cat, x, G, mc, squash=True))
            if one_launch:
                # the engine's own call: the staged (n, 2) ids, the state
                # updated in place (a copy, so the others keep theirs)
                # and the caller's buffer for the scores, its cold word
                # zeroed (the engine's host-to-device copy does that)
                ids = cat[:, :2].contiguous()
                own = [t.clone() for t in state]
                out = torch.zeros(N + 1, device=dev)
                emit("zscore_score_update", {**shape, "launches": 1},
                     lambda ids=ids, x=x, own=own, out=out:
                     zscore.zscore_score_update(*own, ids, x, G, mc,
                                                scratch=sums, inplace=True,
                                                out=out))
                emit("zscore_score_only", {**shape, "launches": 1},
                     lambda ids=ids, x=x, out=out: zscore.zscore_score_update(
                         *state, ids, x, G, mc, update=False, out=out))
            else:
                emit("zscore_score_only", {**shape, "launches": "K4 + fill"},
                     lambda cat=cat, x=x: zscore.zscore_score(
                         *state, cat, x, G, mc, squash=True, n_valid=N))
                # the engine's sequence: K4 with its cold counter's fill,
                # then K3 with the staged weights
                emit("zscore_score_update", {**shape, "launches": "K4 + "
                                             "fill + K3"},
                     lambda cat=cat, x=x, w=w: (
                         zscore.zscore_score(*state, cat, x, G, mc,
                                             squash=True, n_valid=N),
                         zscore.zscore_update(*state, cat, x, w, G,
                                              scratch=sums)))


if __name__ == "__main__":
    sys.exit(main())

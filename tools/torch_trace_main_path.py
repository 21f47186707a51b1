#!/usr/bin/env python3
"""Where the time goes on the PyTorch/CUDA port's main path, on one GPU.

    python3 tools/torch_trace_main_path.py [--model transformer|zscore|
                                                    autoencoder]
                                           [--route host|fused]
                                           [--quantized]
                                           [--traces 4096] [--requests 6]
                                           [--no-profile]

Starts the port's ``ScoringEngine`` on the card with the ladder warmed —
the default ``TransformerConfig`` (bf16, full width), with ``--model
zscore`` the default ``ZScoreDetector`` (G 8192, every span bucket warmed,
fitted first on 400 traces through ``warmup``), or with ``--model
autoencoder`` the default ``AutoencoderConfig`` (bf16, full width) — then
scores
``--requests`` synthetic batches of ``--traces`` traces each, one after
another through ``score_sync`` (the engine path the sidecar calls, minus
the socket and wire codec) — or, with ``--route fused`` (the sequence
models), through ``submit(batch, columns=extract_columns(batch)[0])``, the
fused columns route — under ``torch.profiler`` with CPU and CUDA
activities. ``--quantized`` serves the transformer with int8 products
(``EngineConfig(quantized=True)``) and then runs the same requests through
the bf16 engine in the same process, so the line carries the int8 path's
numbers and, under ``bf16_same_run``, the float path's beside them. It
prints one JSON line with:

* the window's host wall time and the spans scored;
* the card's busy time — the union of every kernel and copy interval the
  profiler saw — and the idle share of the window;
* device time by category (K1 to K15, GEMMs, LayerNorm, GELU, copies
  (the memset clearing K5's join table among them), other),
  each category's share of the busy time, and the top kernels by device
  time;
* each hand-written kernel by name (K1-K15: K5, K7, K11 and K13 are
  several kernels each; K3 and K4 one kernel since their redesign, three
  and one before it), with its launches and device ms per engine call;
* the copies a call: host→device and device→host bytes (from the
  trace's memcpy records), their count and their device ms, and the
  memsets (fills) a call;
* the engine's stage medians (pack stage, device stage).

With ``--no-profile`` the same requests run without the profiler and the
line holds only the host-side numbers (window, spans/s, the engine's stage
medians): the profiler's own host cost stays out of an A/B of two
commits (copy this file into the other checkout's ``tools/`` to run it
there).

It imports nothing of JAX or of the JAX package, needs a CUDA device, and
fails when the profiler records no device activity (then the device
numbers are not measured).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

CATEGORIES = (
    ("K1 segment_attention", ("segment_attention",)),
    ("K2 span_embed", ("span_embed",)),
    ("K3+K4 zscore_score_update", ("zscore_step",)),
    ("K3 zscore_update", ("zscore_pass", "zscore_merge")),
    ("K4 zscore_score", ("zscore_score",)),
    ("K5 featurize_columns", ("featurize_insert_kernel",
                              "featurize_probe_kernel")),
    ("K6 radix_sort", ("radix_sort_kernel",)),
    ("K7 next_fit_pack", ("pack_layout_kernel", "pack_walk_kernel",
                          "pack_scatter_kernel")),
    ("K13 trace_rows_pack", ("rows_layout_kernel", "rows_scatter_kernel")),
    ("K8 span_head_scatter", ("span_head_kernel",)),
    ("K9 ln_quantize", ("ln_quantize_kernel", "ln_quantize_row_kernel")),
    ("K10 qgemm", ("qgemm_s8_kernel", "qgemm_s8_quant_kernel",
                   "qgemm_mma_kernel")),
    ("K11 recon_ce", ("recon_ce_kernel", "recon_ce_list_kernel",
                      "recon_tc_kernel", "recon_compact_kernel",
                      "recon_prep_kernel", "recon_tc_wide_kernel")),
    ("K12 ln_masked_pool", ("ln_masked_pool_kernel",
                            "ln_masked_pool_any_kernel")),
    ("K14 ln_bf16", ("ln_rows_kernel", "ln_wide_kernel")),
    ("K15 gemm_bf16", ("gemm_tc_kernel", "gemm_f32_kernel")),
    ("GEMM", ("gemm", "gemv", "nvjet", "xmma", "cutlass", "sm90_")),
    ("LayerNorm", ("layer_norm", "LayerNorm")),
    ("GELU", ("gelu", "GeluCUDA")),
    ("copies", ("Memcpy", "memcpy", "Memset")),
)


def category(name: str) -> str:
    for cat, keys in CATEGORIES:
        if any(k in name for k in keys):
            return cat
    return "other (elementwise, reductions)"


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespaces' noise and
    argument list: ``void (anonymous namespace)::k<true>(int*)`` → ``k<true>``."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[len("void "):]
    return name.split("(")[0][:80]


def union_us(intervals: list[tuple[float, float]]) -> float:
    total = 0.0
    end = float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def measure(args, quantized: bool, card: str) -> dict:
    """Serve the requests on one engine and return the line's numbers."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from odigos_tpu_torch.pdata import synthesize_traces
    from odigos_tpu_torch.serving import EngineConfig, ScoringEngine

    batches = [synthesize_traces(args.traces, seed=300 + i)
               for i in range(args.requests + 1)]
    engine = ScoringEngine(EngineConfig(model=args.model, device="cuda",
                                        quantized=quantized,
                                        warm_ladder=True)).start()

    def score(b):
        if args.route == "host":
            return engine.score_sync(b, timeout_s=120)
        from odigos_tpu_torch.serving.fused import extract_columns

        req = engine.submit(b, columns=extract_columns(b)[0])
        return req.scores if req is not None and req.done.wait(120) \
            else None

    try:
        if args.model == "zscore":
            engine.warmup(synthesize_traces(400, seed=7))
        if score(batches[0]) is None:
            raise RuntimeError("warm-up request timed out")
        torch.cuda.synchronize()

        def run() -> float:
            t0 = time.perf_counter()
            for b in batches[1:]:
                if score(b) is None:
                    raise RuntimeError("request timed out")
            return time.perf_counter() - t0

        if args.no_profile:
            wall_s = run()
        else:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                wall_s = run()
        stats = engine.stats()
        rows = list(getattr(engine.backend, "fused_rows", []))[-args.requests:]
    finally:
        engine.shutdown()

    spans = sum(len(b) for b in batches[1:])
    out = {
        "card": card, "torch_device": torch.cuda.get_device_name(0),
        "model": args.model, "route": args.route, "quantized": quantized,
        "profiled": not args.no_profile, "requests": args.requests,
        "traces_per_request": args.traces, "spans": spans,
        "window_s": wall_s, "spans_per_s": spans / wall_s,
        "fused_rows_R_vs_real": rows if args.route == "fused" else None}
    if args.no_profile:
        return {**out, "device_busy_ms": "not measured", "engine": stats}
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        raise RuntimeError("the profiler recorded no device activity: "
                           "device time not measured")
    busy_ms = union_us([(e.time_range.start, e.time_range.end)
                        for e in dev]) / 1e3
    by_cat: dict[str, float] = {}
    by_name: dict[str, list] = {}
    for e in dev:
        ms = (e.time_range.end - e.time_range.start) / 1e3
        by_cat[category(e.name)] = by_cat.get(category(e.name), 0.0) + ms
        rec = by_name.setdefault(e.name, [0.0, 0])
        rec[0] += ms
        rec[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    copies = copies_per_call(prof, args.requests)
    return {
        **out, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / (wall_s * 1e3),
        "device_ms_by_category": dict(sorted(by_cat.items(),
                                             key=lambda kv: -kv[1])),
        "share_of_busy_by_category": {
            c: ms / busy_ms for c, ms in sorted(by_cat.items(),
                                                key=lambda kv: -kv[1])},
        "top_kernels": [{"name": n[:120], "ms": v[0], "count": v[1]}
                        for n, v in top],
        "hand_written_per_call": {
            short_name(n): {"category": category(n),
                            "ms": v[0] / args.requests,
                            "launches": v[1] / args.requests}
            for n, v in sorted(by_name.items())
            if category(n).startswith("K")},
        "copies_per_call": copies,
        "engine": stats}


def copies_per_call(prof, requests: int) -> dict:
    """Host→device and device→host copies and the memsets a call: bytes,
    count and device ms, read from the trace's device memcpy and memset
    records (Kineto writes each one's bytes into its ``args``); "not
    measured" where no record has them."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    out: dict = {}
    for e in events:
        cat = e.get("cat")
        if cat not in ("gpu_memcpy", "gpu_memset") or e.get("ph") != "X":
            continue
        name = str(e.get("name", ""))
        kind = ("memset" if cat == "gpu_memset" else "HtoD" if "HtoD" in name
                else "DtoH" if "DtoH" in name else "DtoD" if "DtoD" in name
                else "other")
        rec = out.setdefault(kind, {"bytes": 0, "count": 0, "ms": 0.0})
        nbytes = (e.get("args") or {}).get("bytes")
        if nbytes is None:
            rec["bytes"] = "not measured"
        elif rec["bytes"] != "not measured":
            rec["bytes"] += int(nbytes)
        rec["count"] += 1
        rec["ms"] += float(e.get("dur", 0.0)) / 1e3
    return {k: {f: (v / requests if isinstance(v, (int, float)) else v)
                for f, v in rec.items()} for k, rec in out.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="transformer",
                    choices=["transformer", "zscore", "autoencoder"])
    ap.add_argument("--route", default="host", choices=["host", "fused"],
                    help="sequence models: score_sync (host featurize + "
                         "pack) or submit(columns=) (the fused route)")
    ap.add_argument("--quantized", action="store_true",
                    help="transformer: the int8 (W8A8) engine, then the "
                         "bf16 engine on the same requests")
    ap.add_argument("--traces", type=int, default=4096)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--no-profile", action="store_true",
                    help="host-side numbers only, without the profiler")
    args = ap.parse_args()
    if args.route == "fused" and args.model == "zscore":
        ap.error("--route fused needs a sequence model")
    if args.quantized and args.model != "transformer":
        ap.error("--quantized needs --model transformer")

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import torch

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    line = measure(args, args.quantized, card)
    if args.quantized:
        flt = measure(args, False, card)
        line["bf16_same_run"] = {
            k: flt.get(k) for k in (
                "spans_per_s", "window_s", "device_busy_ms",
                "device_idle_share", "device_ms_by_category",
                "share_of_busy_by_category", "hand_written_per_call")}
        line["bf16_same_run"]["stage_ms_p50_by_route"] = \
            flt["engine"].get("stage_ms_p50_by_route")
        line["int8_over_bf16_spans_per_s"] = (line["spans_per_s"]
                                              / flt["spans_per_s"])
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""The engine on a dp x tp mesh over NCCL ranks, one card a rank, against
the one-card engine and the in-process model axis.

    python3 tools/torch_mesh_multicard.py [--ranks 4] [--requests 6]
                                          [--traces 2048] [--no-dryrun]

Every rank builds the same ``ScoringEngine`` on ``{"data": ranks / 2,
"model": 2}`` (the served ``TransformerConfig()``, bf16, weights from
seed 0, a warm ladder); rank 0 leads and serves ``--requests`` requests
of ``--traces`` traces, the others follow its broadcast calls. Rank 0
holds the scores against a one-card engine of the same weights on its
card (within ``PLAIN_PATH_BOUND``: the f32 all-reduce of the partials
against the one-card rounding), times both engines' requests and reports
the ladder's misses after the warm. Then every rank runs the plan's
sharded call (``compile_plan``) on the packed rows of one request, and on
them padded to ``TOP_ROWS`` (the ladder's top rung, the served R 2048),
timed with CUDA events (median of ``REPS``), with each model-axis
all-reduce bracketed by events on the current stream: the all-reduces'
share of the call (a rank's all-reduce also waits for the other ranks to
arrive). Then one all-reduce of a partial's bytes alone, after a
barrier: the transfer's own time. Rank 0 holds the rows it scored
against ``LocalModelAxis(2)`` (the in-process axis) on the same rows: at
tp = 2 the NCCL sum of two partials is the in-process one, so bit-equal.
Then the autoencoder engine on the same mesh (the served
``AutoencoderConfig()`` with its loss weights scaled down so that the
squashed scores spread, weights from seed 0; its decoder FFN and
vocabulary heads on the model axis, K24 merging the gathered records)
against a one-card autoencoder engine of the same weights, within
``PLAIN_PATH_BOUND``, with both engines' spans/s. With a multiple of 4
ranks, NCCL's sum over a ``"model"`` axis of 4 (``GroupModelAxis``) of
four f32 partials of a served shard's shape against
``LocalModelAxis(4)``'s rank-order sum of the same partials on rank 0's
card: NCCL's ring may add in another order, so the two agree within
``TP4_SUM_BOUND`` (2 x 3 f32 rounding units of the sum of the four
magnitudes: each order is within 3 of the exact sum), the bit-equal share
reported. Last, ``dryrun_multichip(ranks, "cuda")``. Prints the card's
name and power limit, one JSON line of results and ``{"ok": ...}``.
Needs ``--ranks`` cards (an even number).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

PLAIN_PATH_BOUND = 2e-2  # chip_smoke.py's: probabilities, two bf16 paths
REPS = 10
TOP_ROWS = 2048          # the engine ladder's top rung (EngineConfig())
TP4_SUM_BOUND = 6 * 2.0 ** -24  # of sum_r |p_r|, element by element
TP4_SHAPE = (2048 * 64, 256)    # a partial at R 2048: (rows x L, d_model)
AE_WEIGHTS = dict(w_service=0.01, w_name=0.01, w_kind=0.005,
                  w_duration=0.002)  # chip_smoke.py's AE_SCALED_WEIGHTS


def _ae_engine(out: dict, shape: dict, batches: list, rank: int) -> bool:
    """The autoencoder engine on ``shape`` against a one-card engine of the
    same weights (rank 0): the squashed scores' largest difference and
    both engines' spans/s. Returns the check."""
    import numpy as np

    from odigos_tpu_torch.features import featurize
    from odigos_tpu_torch.models import AutoencoderConfig
    from odigos_tpu_torch.serving import EngineConfig, ScoringEngine

    def engine(mesh):
        return ScoringEngine(EngineConfig(
            model="autoencoder", mesh=mesh, warm_ladder=True, device="cuda",
            model_config=AutoencoderConfig(**AE_WEIGHTS))).start()

    def serve(eng):
        scores, walls = [], []
        for b in batches:
            t1 = time.perf_counter()
            scores.append(eng.score_sync(b, featurize(b), timeout_s=300.0))
            walls.append((time.perf_counter() - t1) * 1e3)
        return scores, sum(len(b) for b in batches) / (sum(walls) / 1e3)

    eng = engine(shape)
    r: dict = {"tp_shard_service_rows":
               eng.backend._plan.runner.module.service_head.weight.shape[0]}
    if not eng.is_follower:
        scores, r["spans_per_s"] = serve(eng)
        r["misses"] = eng.backend.ladder.misses
    eng.shutdown()
    if rank != 0:
        out["autoencoder"] = r
        return True
    one = engine(None)
    ref, r["one_card_spans_per_s"] = serve(one)
    one.shutdown()
    r["vs_one_card_max_abs_diff"] = max(float(np.abs(s - f).max())
                                        for s, f in zip(scores, ref))
    r["vs_one_card_bit_equal_share"] = float(np.mean(
        np.concatenate([s == f for s, f in zip(scores, ref)])))
    out["autoencoder"] = r
    return (r["vs_one_card_max_abs_diff"] <= PLAIN_PATH_BOUND
            and r["misses"] == 0)


def _tp4_sum(out: dict, n: int, rank: int) -> None:
    """NCCL's sum over a model axis of 4 against the in-process one."""
    import torch

    from odigos_tpu_torch.parallel import (GroupModelAxis, LocalModelAxis,
                                           make_mesh)

    mesh = make_mesh({"data": n // 4, "model": 4}, device="cuda")
    axis = GroupModelAxis.of(mesh)
    dev = torch.device("cuda", torch.cuda.current_device())

    def partial(r):
        g = torch.Generator(device=dev).manual_seed(1000 + r)
        return torch.randn(TP4_SHAPE, generator=g, device=dev) * (1 + r)

    got = axis.reduce([partial(axis.shards[0])])
    torch.cuda.synchronize()
    if rank != 0:
        return
    parts = [partial(r) for r in range(4)]
    ref = LocalModelAxis(4).reduce(parts)
    mag = sum(p.abs() for p in parts)
    diff = (got - ref).abs()
    out["tp4_sum"] = {
        "shape": list(TP4_SHAPE), "max_abs_diff": float(diff.max()),
        "worst_ratio_to_bound": float(torch.where(
            diff > 0, diff / (TP4_SUM_BOUND * mag), 0.0).max()),
        "bit_equal_share": float((diff == 0).float().mean()),
        "bound": "6 x 2^-24 x sum_r |p_r|"}


def _rank(requests: int, traces: int) -> dict:
    import numpy as np
    import torch
    import torch.distributed as dist

    from odigos_tpu_torch.features import featurize, pack_sequences
    from odigos_tpu_torch.models import TraceTransformer, TransformerConfig
    from odigos_tpu_torch.parallel import LocalModelAxis, compile_plan
    from odigos_tpu_torch.pdata import synthesize_traces
    from odigos_tpu_torch.serving import EngineConfig, ScoringEngine

    n, rank = dist.get_world_size(), dist.get_rank()
    dev = torch.device("cuda", torch.cuda.current_device())
    shape = {"data": n // 2, "model": 2}
    out: dict = {"rank": rank, "mesh": shape}
    batches = [synthesize_traces(traces, seed=300 + i)
               for i in range(requests)]

    # the mesh-owning engine: rank 0 serves, the others follow
    t0 = time.monotonic()
    eng = ScoringEngine(EngineConfig(model="transformer", mesh=shape,
                                     warm_ladder=True,
                                     device="cuda")).start()
    out["start_s"] = time.monotonic() - t0
    scores = []
    if not eng.is_follower:
        out["misses_after_warm"] = eng.backend.ladder.misses
        walls = []
        for b in batches:
            t1 = time.perf_counter()
            s = eng.score_sync(b, featurize(b), timeout_s=300.0)
            walls.append((time.perf_counter() - t1) * 1e3)
            scores.append(s)
        out["request_ms"] = walls
        out["spans_per_s"] = sum(len(b) for b in batches) / (sum(walls)
                                                             / 1e3)
        out["misses"] = eng.backend.ladder.misses
        out["stats"] = {k: eng.stats()[k] for k in ("device_calls",
                                                     "errors")}
        out["stats"]["adaptive_mesh"] = eng.stats()["adaptive"]["mesh"]
    eng.shutdown()
    if rank == 0:
        one = ScoringEngine(EngineConfig(
            model="transformer", warm_ladder=True, device="cuda")).start()
        ref, walls = [], []
        for b in batches:
            t1 = time.perf_counter()
            ref.append(one.score_sync(b, featurize(b), timeout_s=300.0))
            walls.append((time.perf_counter() - t1) * 1e3)
        one.shutdown()
        out["one_card_request_ms"] = walls
        out["one_card_spans_per_s"] = sum(len(b) for b in batches) / (
            sum(walls) / 1e3)
        diffs = [float(np.abs(s - r).max()) for s, r in zip(scores, ref)]
        out["vs_one_card_max_abs_diff"] = max(diffs)
        out["vs_one_card_bit_equal_share"] = float(np.mean(
            np.concatenate([s == r for s, r in zip(scores, ref)])))

    # the plan's sharded call on one request's packed rows, timed, its
    # all-reduces bracketed by events on the current stream
    cfg = TransformerConfig()
    whole = TraceTransformer(cfg, device=dev, seed=0)
    state = whole.state_dict()
    plan = compile_plan(whole, eng.mesh)
    b = batches[0]
    pk = pack_sequences(b, featurize(b), max_len=cfg.max_len,
                        pad_rows_to=lambda r: r + (-r) % (n // 2))
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in (pk.categorical, pk.continuous, pk.segments,
                      pk.positions)]
    got = plan.score_packed(state, *args)
    torch.cuda.synchronize()
    if rank == 0:
        local = TraceTransformer(cfg, device=dev, seed=0,
                                 model_axis=LocalModelAxis(2))
        ref = local.score_packed(*args)
        torch.cuda.synchronize()
        out["plan_vs_in_process_bit_equal"] = bool(torch.equal(got, ref))
        out["plan_vs_in_process_max_abs_diff"] = float(
            (got - ref).abs().max())
    real_all_reduce = dist.all_reduce
    marks: list = []

    def timed_all_reduce(t, *a, **k):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        r = real_all_reduce(t, *a, **k)
        e1.record()
        marks.append((e0, e1, t.numel() * t.element_size()))
        return r

    top = [torch.cat([a, a.new_zeros((TOP_ROWS - a.shape[0],)
                                     + tuple(a.shape[1:]))])
           for a in args]
    for tag, rows in (("real", args), (f"R{TOP_ROWS}", top)):
        calls, shares, reduce_ms = [], [], []
        for i in range(REPS + 1):
            marks.clear()
            a = torch.cuda.Event(enable_timing=True)
            z = torch.cuda.Event(enable_timing=True)
            dist.all_reduce = timed_all_reduce
            try:
                a.record()
                plan.score_packed(state, *rows)
                z.record()
            finally:
                dist.all_reduce = real_all_reduce
            z.synchronize()
            if i == 0:
                continue  # warm
            call = a.elapsed_time(z)
            red = sum(e0.elapsed_time(e1) for e0, e1, _ in marks)
            calls.append(call)
            reduce_ms.append(red)
            shares.append(red / call)
        nbytes = marks[0][2] if marks else 0
        # one all-reduce of the same bytes alone, every rank arrived
        buf = torch.zeros(max(nbytes // 4, 1), device=dev)
        alone = []
        for i in range(REPS + 1):
            torch.cuda.synchronize()
            dist.barrier()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            dist.all_reduce(buf, group=eng.mesh.get_group("model"))
            e1.record()
            e1.synchronize()
            if i:
                alone.append(e0.elapsed_time(e1))
        out[tag] = {"R": int(rows[2].shape[0]),
                    "all_reduces_a_call": len(marks),
                    "all_reduce_bytes_each": nbytes,
                    "call_ms": statistics.median(calls),
                    "all_reduce_ms": statistics.median(reduce_ms),
                    "all_reduce_share": statistics.median(shares),
                    "one_all_reduce_alone_ms": statistics.median(alone),
                    "alone_share": len(marks) * statistics.median(alone)
                    / statistics.median(calls)}
    out["autoencoder_ok"] = _ae_engine(out, shape, batches, rank)
    if n % 4 == 0:
        _tp4_sum(out, n, rank)
    gathered = [None] * n
    dist.all_gather_object(gathered, out)
    return {"ranks": gathered}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ranks", type=int, default=4)
    p.add_argument("--requests", type=int, default=6)
    p.add_argument("--traces", type=int, default=2048)
    p.add_argument("--no-dryrun", action="store_true")
    args = p.parse_args(argv)
    if args.ranks < 2 or args.ranks % 2:
        raise SystemExit("--ranks must be even: the model axis is 2")
    from odigos_tpu_torch.parallel.dryrun import dryrun_multichip
    from odigos_tpu_torch.parallel.launch import spawn

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    # the rank function by its importable name (this file runs as
    # __main__; its children import it as the tool module)
    import importlib

    tool = importlib.import_module("torch_mesh_multicard")
    res = spawn(tool._rank, args.ranks, device="cuda",
                args=(args.requests, args.traces), timeout=900.0)[0]
    lead = res["ranks"][0]
    ok = (lead["misses_after_warm"] == 0 and lead["misses"] == 0
          and lead["vs_one_card_max_abs_diff"] <= PLAIN_PATH_BOUND
          and lead["plan_vs_in_process_bit_equal"]
          and lead["autoencoder_ok"]
          and lead.get("tp4_sum", {}).get("worst_ratio_to_bound", 0.0)
          <= 1.0)
    result = {"engine": res["ranks"]}
    if not args.no_dryrun:
        dry = dryrun_multichip(args.ranks, "cuda")
        result["dryrun"] = {k: dry[k] for k in ("dp", "tp", "loss", "mesh",
                                                "scored",
                                                "ring_max_abs_err")}
        ok = ok and dry["scored"] > 0 and dry["ring_max_abs_err"] <= 1e-5
    print(json.dumps(result), flush=True)
    print(json.dumps({"ok": bool(ok)}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

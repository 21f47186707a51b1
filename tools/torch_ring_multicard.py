#!/usr/bin/env python3
"""Ring attention over NCCL ranks, one card a rank, against the same ring
run inside one process.

    python3 tools/torch_ring_multicard.py [--ranks 4] [--len 32768]

Every rank makes the same global (2, L, 4, 64) f32 inputs from a seed on
its own card (~20% of keys masked), runs ``ring_attention`` on its block
over a ``{"seq": n}`` mesh (K22 a step, the next block's ``isend`` /
``irecv`` between cards posted before it), and holds its output against
``ring_body`` with the in-process rotation over the same blocks on its
card: the same kernel merging the same blocks in the same order, so the
two must be bit-equal. Each is timed with CUDA events (median of 5, after
a warm-up). Prints one JSON line per rank from rank 0, and the card's
name and power limit. Needs ``--ranks`` cards.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

B, H, D = 2, 4, 64
KEEP = 0.8
REPS = 5


def _time_ms(fn) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _rank(L: int) -> dict:
    import torch
    import torch.distributed as dist

    from odigos_tpu_torch.kernels import ring as kring
    from odigos_tpu_torch.parallel import (LocalRotation, make_mesh,
                                           ring_attention, ring_body,
                                           shard_seq)

    n, rank = dist.get_world_size(), dist.get_rank()
    dev = torch.device("cuda", torch.cuda.current_device())
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn((B, L, H, D), generator=g, device=dev)
               for _ in range(3))
    mask = torch.rand((B, L), generator=g, device=dev) < KEEP
    mesh = make_mesh({"seq": n}, axes=("seq",))
    mine = [shard_seq(t, mesh) for t in (q, k, v, mask)]
    Lb = L // n
    blocks = [(k[:, j * Lb:(j + 1) * Lb].contiguous(),
               v[:, j * Lb:(j + 1) * Lb].contiguous(),
               mask[:, j * Lb:(j + 1) * Lb].to(torch.uint8).contiguous())
              for j in range(n)]

    def over_nccl():
        return ring_attention(*mine, mesh)

    def in_process():
        return ring_body(mine[0], *blocks[rank], n,
                         LocalRotation(blocks, rank))

    launched = kring.launches
    got, ref = over_nccl(), in_process()
    torch.cuda.synchronize()
    out = {"rank": rank, "ranks": n, "L": L, "block": Lb,
           "backend": dist.get_backend(),
           "k22_launches_each": (kring.launches - launched) // 2,
           "bit_equal": bool(torch.equal(got, ref)),
           "max_abs_diff": float((got - ref).abs().max()),
           "finite": bool(torch.isfinite(got).all()),
           "nccl_ring_ms": _time_ms(over_nccl),
           "in_process_ring_ms": _time_ms(in_process)}
    gathered = [None] * n
    dist.all_gather_object(gathered, out)
    return {"ranks": gathered}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ranks", type=int, default=4)
    p.add_argument("--len", type=int, default=32768)
    args = p.parse_args(argv)
    from odigos_tpu_torch.parallel.launch import spawn

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    # the rank function by its importable name (this file runs as
    # __main__; its children import it as the tool module)
    import importlib

    tool = importlib.import_module("torch_ring_multicard")
    res = spawn(tool._rank, args.ranks, device="cuda", args=(args.len,))[0]
    for r in res["ranks"]:
        print(json.dumps(r), flush=True)
    ok = all(r["bit_equal"] and r["finite"] for r in res["ranks"])
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

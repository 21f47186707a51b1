"""The multi-device dry run: one train step on a dp x tp mesh, a started
mesh-owning engine, and one ring-attention call, on n ranks.

The port's twin of ``__graft_entry__.dryrun_multichip``:

    python -m odigos_tpu_torch.parallel.dryrun --devices N --device cpu|cuda

On the reference's mesh, ``{"data": dp, "model": tp}`` with tp = 2 where
n is even and dp = n // tp, from ``jax_init.transformer_params`` seed 0
at the reference's dry-run config (d 64, 4 heads, 2 layers, d_ff 128,
max_len 16, f32; Adam 1e-3) it takes one
:func:`~.sharding.make_sharded_train_step` step on this rank's shard
(:func:`~.sharding.shard_model`), starts a ``ScoringEngine`` that owns
the same mesh (``warm_ladder``, rungs of ``8 n`` rows, one rung) on every
rank, serves ``4 n`` traces through its leader with no ladder miss after
the warm, and runs :func:`~.ring_attention.ring_attention` on a ``{"seq":
n}`` mesh at (2, 8n, 4, 16), held to ``reference_attention`` within
1e-5. It prints one line, as the reference's does. n = 1 runs in this
process (a world of 1: NCCL on the card, gloo on the CPU; the engine's
mesh normalizes to one device, as the reference's does); n > 1 starts n
ranks by ``parallel.launch.spawn`` (gloo processes on the CPU, one card a
rank with NCCL).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch
import torch.distributed as dist

RING_ATOL = 1e-5  # the reference's ring test bound (tests/test_parallel.py)


def _dryrun_rank(device: str) -> dict:
    """The dry run on this rank (its process group already up)."""
    from ..features import assemble_sequences, featurize
    from ..models import TraceTransformer, TransformerConfig
    from ..models.jax_init import transformer_state
    from ..pdata import synthesize_traces
    from .mesh import make_mesh
    from .ring_attention import (gather_seq, reference_attention,
                                 ring_attention, shard_seq)
    from ..serving.engine import EngineConfig, ScoringEngine
    from .sharding import make_sharded_train_step, shard_model

    n = dist.get_world_size()
    rank = dist.get_rank()
    dev = (torch.device("cuda", torch.cuda.current_device())
           if device == "cuda" else torch.device("cpu"))
    # dp x tp: tp = 2 wherever n is even, the rest data-parallel
    tp = 2 if n % 2 == 0 else 1
    dp = n // tp
    mesh = make_mesh({"data": dp, "model": tp}, device=device)

    cfg = TransformerConfig(d_model=64, n_heads=4, n_layers=2, d_ff=128,
                            max_len=16, dtype=torch.float32)
    whole = TraceTransformer(cfg, device=dev)
    whole.load_state_dict(transformer_state(cfg, 0))
    model = shard_model(whole, mesh)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    step = make_sharded_train_step(model, opt, mesh)

    batch = synthesize_traces(2 * dp, seed=0)
    seqs = assemble_sequences(batch, featurize(batch), max_len=16,
                              pad_traces_to=2 * dp)
    rng = np.random.default_rng(0)
    span_labels = (rng.random(seqs.mask.shape) < 0.2) & seqs.mask
    trace_labels = rng.random(seqs.mask.shape[0]) < 0.5
    loss = float(step(seqs.categorical, seqs.continuous, seqs.mask,
                      span_labels, trace_labels))
    if not np.isfinite(loss):
        raise RuntimeError(f"non-finite loss {loss}")

    # the production route: a started engine that owns the dp x tp mesh,
    # every packed call through the partition-rule plan, a warm ladder
    eng = ScoringEngine(EngineConfig(
        model="transformer", mesh={"data": dp, "model": tp},
        trace_bucket=8 * n, max_len=16, bucket_ladder=1, warm_ladder=True,
        model_config=cfg, device=device)).start()
    scored = 0
    try:
        if not eng.is_follower:
            if eng.backend.ladder.misses:
                raise RuntimeError("the warm ladder counted a miss")
            serve = synthesize_traces(4 * n, seed=3)
            scores = eng.score_sync(serve, featurize(serve), timeout_s=300.0)
            if scores is None or scores.shape != (len(serve),) or \
                    not np.isfinite(scores).all():
                raise RuntimeError("the mesh engine gave no scores, or "
                                   "non-finite ones")
            if eng.backend.ladder.misses:
                raise RuntimeError("serving missed the warm ladder")
            scored = 4 * n
    finally:
        eng.shutdown()

    seq_mesh = make_mesh({"seq": n}, axes=("seq",), device=device)
    L = 8 * n
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn((2, L, 4, 16), generator=g) for _ in range(3))
    mask = torch.ones((2, L), dtype=torch.bool)
    out = gather_seq(ring_attention(
        *(shard_seq(t.to(dev), seq_mesh) for t in (q, k, v, mask)),
        seq_mesh), seq_mesh)
    ring_err = (out.cpu() - reference_attention(q, k, v, mask)).abs().max()
    if not bool(torch.isfinite(out).all()) or float(ring_err) > RING_ATOL:
        raise RuntimeError(f"ring attention off the reference by "
                           f"{float(ring_err)}")
    mesh_label = eng.stats()["adaptive"]["mesh"]
    return {"rank": rank, "n": n, "dp": dp, "tp": tp, "loss": loss,
            "scored": scored, "mesh": mesh_label, "L": L,
            "ring_max_abs_err": float(ring_err),
            "line": f"dryrun_multichip({n}): dp={dp} tp={tp} "
                    f"loss={loss:.4f} mesh engine ({mesh_label}) served "
                    f"{scored} traces with a warm ladder, "
                    f"ring_attention L={L} OK (max |ring - reference| "
                    f"{float(ring_err):.2e}, backend {dist.get_backend()})"}


def dryrun_multichip(n_devices: int = 1, device: str = "cuda") -> dict:
    """Run the dry run on ``n_devices`` ranks of ``device`` (the card by
    default: raises without one) and print its line; returns rank 0's
    result."""
    from . import dryrun  # the rank function by its importable name
    from .launch import spawn
    from .mesh import init_group

    if n_devices == 1:
        init_group(device)
        result = _dryrun_rank(device)
    else:
        result = spawn(dryrun._dryrun_rank, n_devices, device=device,
                       args=(device,))[0]
    print(result["line"], flush=True)
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--devices", type=int, default=1)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    dryrun_multichip(args.devices, args.device)
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())

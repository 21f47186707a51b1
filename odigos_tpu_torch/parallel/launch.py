"""Start n ranks, one process each, and run one function on every rank.

The port's twin of the reference's n-device CPU mesh
(``odigos_tpu/parallel/mesh.py`` ``ensure_host_devices``): where JAX runs
one process over n virtual devices, the port runs n processes, each with
its own process group rank (gloo on the CPU, NCCL on the cards; one card a
rank). :func:`spawn` rendezvouses them on a ``FileStore`` in a new
temporary directory (no port to pick), runs ``fn(*args)`` on each after
``mesh.init_group``, and returns each rank's return value, in rank order.

``fn`` must be importable by name in a fresh interpreter (a module-level
function): children start by the ``spawn`` method, so they import only
``fn``'s module and what it imports. Each child runs one torch thread. A
rank that raises fails the call with its traceback; a rank still running
after ``timeout`` seconds fails it too, and every child is ended either
way, so a hung rank cannot outlive the caller.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Sequence

DEFAULT_TIMEOUT = 300.0


def _child(rank: int, world_size: int, device: str, root: str,
           fn: Callable, args: Sequence[Any]) -> None:
    import torch
    import torch.distributed as dist

    from .mesh import init_group

    torch.set_num_threads(1)
    out = os.path.join(root, f"rank{rank}.pkl")
    try:
        store = dist.FileStore(os.path.join(root, "store"), world_size)
        init_group(device, rank=rank, world_size=world_size, store=store)
        try:
            result = ("ok", fn(*args))
        finally:
            dist.destroy_process_group()
    except BaseException:
        result = ("error", traceback.format_exc())
    with open(out + ".tmp", "wb") as f:
        pickle.dump(result, f)
    os.replace(out + ".tmp", out)


def spawn(fn: Callable, n: int, device: str = "cuda",
          args: Sequence[Any] = (),
          timeout: float = DEFAULT_TIMEOUT) -> list[Any]:
    """Run ``fn(*args)`` on ``n`` new ranks of ``device`` (``"cuda"``, the
    default: NCCL, which needs ``n`` cards and raises with fewer;
    ``"cpu"``: gloo) and return their results in rank order. Raises
    ``RuntimeError`` with the first failing rank's traceback, or
    ``TimeoutError`` after ``timeout`` seconds."""
    if n < 1:
        raise ValueError(f"spawn needs at least one rank, not {n}")
    if device == "cuda":
        import torch

        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n:
            raise RuntimeError(f"{n} NCCL ranks need {n} cards, have {have} "
                               f"(NCCL takes one rank a card)")
    elif device != "cpu":
        raise ValueError(f"spawn runs on 'cuda' or 'cpu', not {device!r}")
    ctx = mp.get_context("spawn")
    root = tempfile.mkdtemp(prefix="odigos_ranks_")
    procs = []
    try:
        for rank in range(n):
            p = ctx.Process(target=_child, name=f"rank{rank}",
                            args=(rank, n, device, root, fn, tuple(args)))
            p.start()
            procs.append(p)
        deadline = time.monotonic() + timeout
        results: list[Any] = [None] * n
        pending = set(range(n))
        while pending:
            for rank in sorted(pending):
                path = os.path.join(root, f"rank{rank}.pkl")
                if os.path.exists(path):
                    procs[rank].join(timeout=30)
                    with open(path, "rb") as f:
                        status, value = pickle.load(f)
                    if status != "ok":
                        raise RuntimeError(f"rank {rank} of {n} failed:\n"
                                           f"{value}")
                    results[rank] = value
                    pending.discard(rank)
                elif not procs[rank].is_alive():
                    raise RuntimeError(f"rank {rank} of {n} exited with code "
                                       f"{procs[rank].exitcode} and no "
                                       f"result")
            if pending and time.monotonic() > deadline:
                raise TimeoutError(f"ranks {sorted(pending)} of {n} still "
                                   f"running after {timeout} s")
            if pending:
                time.sleep(0.05)
        return results
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(root, ignore_errors=True)

#!/usr/bin/env python3
"""K1's CUDA-core routes and K22, built from another copy of their
sources, against the repo's own build: bit for bit, and timed.

    python3 tools/torch_attention_bitcheck.py --old DIR

``DIR`` holds ``segment_attention.cu`` and ``ring_attention.cu`` as they
stood before a change (with the headers they include), for example
``git archive <commit> odigos_tpu_torch/kernels/csrc`` unpacked. The tool
builds both copies with the repo's ``nvcc`` flags, runs each on the same
inputs from a seed on the card, and compares every output bit for bit:

* K1 ``segment_attention`` route 3 (the tiled CUDA-core kernel; hd 8 to
  256, L up to 1024, padding slots) and route 0 (the one-tile kernel), f32
  and bf16, with each query's log-sum-exp;
* K22 ``ring_block_attention``: three blocks merged into the same (o, m,
  s), the first fully masked, a trace masked in the last, the last
  finalized; D 4 to 256, Lq != Lk, lengths that are not multiples of 64,
  f32 and bf16 q.

Then it times the two builds (CUDA events, 10 launches after a warm-up,
in the order old, new, new, old) on K22 at the smoke's one-block shape (2,
8192, 4, 64), K22 at D 256 and K1's tiled f32 kernel at R 256, L 1024.
Prints the card's name and power limit, the registers and spills ptxas
reports for each build, one line a case, and a last line ``BITCHECK OK``
or ``BITCHECK FAILED n``; exits 1 on a difference.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

SOURCES = ("segment_attention", "ring_attention")


def _ptxas(log: str) -> list[str]:
    return [" ".join(line.split()[-6:]) if "spill" in line
            else line.split("Used")[1].split(",")[0].strip()
            for line in log.splitlines()
            if "spill" in line or ("Used" in line and "registers" in line)]


def _bind(lib: ctypes.CDLL, name: str):
    if name == "segment_attention":
        f = lib.segment_attention_launch
        f.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                      + [ctypes.c_float] * 2 + [ctypes.c_void_p] * 2)
    else:
        f = lib.ring_block_attention_launch
        f.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                      + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    f.restype = ctypes.c_int
    return f


def _builds(old_dir: Path, out: Path):
    from odigos_tpu_torch.kernels import build

    procs = {}
    for name in SOURCES:
        so = out / f"old_{name}.so"
        procs[name] = (subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(so),
             str(old_dir / f"{name}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), so)
    build.build(list(SOURCES))
    old, new = {}, {}
    for name, (p, so) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"old {name} failed to build:\n{log}")
        print("old", name, _ptxas(log))
        print("new", name, _ptxas(build.build_logs[name])
              if name in build.build_logs else "(built before this run)")
        old[name] = _bind(ctypes.CDLL(str(so)), name)
        new[name] = _bind(ctypes.CDLL(str(build.library_path(name))), name)
    return old, new


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", required=True, type=Path)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    with tempfile.TemporaryDirectory(prefix="bitcheck_") as tmp:
        old, new = _builds(args.old.resolve(), Path(tmp))
        dev = torch.device("cuda")
        rng = np.random.default_rng(0)

        def stream():
            return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

        def same_bits(a, b):
            view = torch.int32 if a.dtype == torch.float32 else torch.int16
            return bool((a.view(view) == b.view(view)).all())

        def randn(*shape, dtype=torch.float32):
            return torch.from_numpy(rng.standard_normal(shape).astype(
                np.float32)).to(dev, dtype)

        def segments(R, L):
            out = np.zeros((R, L), np.int32)
            for r in range(R):
                pos, sid, live = 0, 1, int(L * rng.uniform(0.5, 1.0))
                while pos < live:
                    n = int(rng.integers(1, 80))
                    out[r, pos:min(pos + n, live)] = sid
                    pos, sid = pos + n, sid + 1
            return torch.from_numpy(out).to(dev)

        def k1_call(fn, q, k, v, seg, out, lse, route):
            R, L, H, hd = q.shape
            return lambda: fn(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
                out.data_ptr(), R, L, H, hd, int(q.dtype != torch.float32),
                route, float(hd) ** 0.5, float(torch.finfo(q.dtype).min),
                lse.data_ptr(), stream())

        def k22_call(fn, q, k, v, mask, o, m, s, finalize):
            B, Lq, H, D = q.shape
            return lambda: fn(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
                o.data_ptr(), m.data_ptr(), s.data_ptr(), B, Lq, k.shape[1],
                H, D, int(q.dtype != torch.float32), D ** -0.5,
                int(finalize), stream())

        fails = cases = 0
        k1_cases = [(3, (3, 64, 2, 8)), (3, (2, 96, 3, 16)),
                    (3, (2, 200, 4, 64)), (3, (2, 1024, 4, 64)),
                    (3, (2, 130, 2, 100)), (3, (1, 1024, 2, 256)),
                    (3, (64, 256, 4, 64)), (0, (4, 64, 4, 64)),
                    (0, (3, 40, 2, 24))]
        for route, shape in k1_cases:
            for dt in (torch.float32, torch.bfloat16):
                q, k, v = (randn(*shape, dtype=dt) for _ in range(3))
                seg = segments(*shape[:2])
                got = []
                for fn in (old["segment_attention"],
                           new["segment_attention"]):
                    out = torch.empty_like(q)
                    lse = torch.empty((shape[0], shape[2], shape[1]),
                                      device=dev)
                    rc = k1_call(fn, q, k, v, seg, out, lse, route)()
                    torch.cuda.synchronize()
                    if rc != 0:
                        raise RuntimeError(f"K1 launch failed: {rc}")
                    got.append((out, lse))
                ok = all(same_bits(a, b) for a, b in zip(*got))
                cases, fails = cases + 1, fails + (not ok)
                print("K1 route", route, shape, dt,
                      "bit-equal" if ok else "DIFFERS")

        for B, Lq, Lk, H, D in [(2, 70, 130, 3, 4), (2, 70, 130, 3, 8),
                                (2, 64, 100, 2, 16), (2, 100, 64, 4, 64),
                                (2, 33, 257, 2, 100), (2, 70, 130, 3, 128),
                                (1, 65, 129, 2, 256), (2, 4096, 4096, 4, 64)]:
            for qdt in (torch.float32, torch.bfloat16):
                q = randn(B, Lq, H, D, dtype=qdt)
                blocks = []
                for i in range(3):
                    mask = torch.from_numpy(
                        (rng.random((B, Lk)) < 0.8).astype(np.uint8)).to(dev)
                    if i == 0:
                        mask[:] = 0
                    if i == 2 and B > 1:
                        mask[1] = 0
                    blocks.append((randn(B, Lk, H, D), randn(B, Lk, H, D),
                                   mask))
                got = []
                for fn in (old["ring_attention"], new["ring_attention"]):
                    o = torch.zeros((B, Lq, H, D), device=dev)
                    m = torch.full((B, H, Lq), -1e30, device=dev)
                    s = torch.zeros((B, H, Lq), device=dev)
                    for i, (k, v, mask) in enumerate(blocks):
                        rc = k22_call(fn, q, k, v, mask, o, m, s, i == 2)()
                        torch.cuda.synchronize()
                        if rc != 0:
                            raise RuntimeError(f"K22 launch failed: {rc}")
                    got.append((o, m, s))
                ok = all(same_bits(a, b) for a, b in zip(*got))
                cases, fails = cases + 1, fails + (not ok)
                print("K22", (B, Lq, Lk, H, D), qdt,
                      "bit-equal" if ok else "DIFFERS")

        def time_ms(fn, reps=10):
            fn()
            torch.cuda.synchronize()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(reps):
                fn()
            e1.record()
            torch.cuda.synchronize()
            return e0.elapsed_time(e1) / reps

        def k22_timed(B, L, H, D):
            q, k, v = (randn(B, L, H, D) for _ in range(3))
            mask = (torch.rand(B, L, device=dev) < 0.8).to(torch.uint8)
            o, s = torch.zeros_like(q), torch.zeros((B, H, L), device=dev)
            m = torch.full((B, H, L), -1e30, device=dev)
            return [k22_call(lib["ring_attention"], q, k, v, mask, o, m, s,
                             False) for lib in (old, new)]

        def k1_timed(R, L, H, hd):
            q, k, v = (randn(R, L, H, hd) for _ in range(3))
            seg, out = segments(R, L), torch.empty_like(q)
            lse = torch.empty((R, H, L), device=dev)
            return [k1_call(lib["segment_attention"], q, k, v, seg, out, lse,
                            3) for lib in (old, new)]

        for tag, (fo, fn) in (
                ("K22 (2, 8192, 4, 64)", k22_timed(2, 8192, 4, 64)),
                ("K22 (2, 4096, 2, 256)", k22_timed(2, 4096, 2, 256)),
                ("K1 tiled f32 (256, 1024, 4, 64)", k1_timed(256, 1024, 4,
                                                             64))):
            t = [time_ms(f) for f in (fo, fn, fn, fo)]
            print(tag, "ms old, new, new, old:", t)
    print("BITCHECK", "OK" if fails == 0 else f"FAILED {fails}", "cases",
          cases)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""K1's CUDA-core routes, K22 and K17, built from another copy of their
sources, against the repo's own build: bit for bit where the arithmetic is
meant to be the same, within the plain bound where it is not, and timed.

    python3 tools/torch_attention_bitcheck.py --old DIR

``DIR`` holds ``segment_attention.cu``, ``ring_attention.cu`` and
``ln_bwd.cu`` as they stood before a change (with the headers they
include), for example ``git archive <commit>
odigos_tpu_torch/kernels/csrc`` unpacked. The tool builds both copies
with the repo's ``nvcc`` flags, runs each on the same inputs from a seed
on the card, and compares:

* K1 ``segment_attention`` route 3 (the tiled CUDA-core kernel; hd 8 to
  256, L up to 1024, padding slots) and route 0 (the one-tile kernel), f32
  and bf16, with each query's log-sum-exp: bit for bit;
* K22 ``ring_block_attention``: three blocks merged into the same (o, m,
  s), the first fully masked, a trace masked in the last, the last
  finalized; D 4 to 256, Lq != Lk, lengths that are not multiples of 64,
  f32 and bf16 q. Each build's largest difference from the other and
  from the plain version, each of o, m and s relative to the plain
  version's largest magnitude of it, is printed; the new build must stay
  within ``RING_RTOL`` of the plain version and give the same bits on a
  second call (a ring step is bit-equal to the old build only while both
  run the same arithmetic);
* K17 ``ln_bwd``: (dx, dgamma, dbeta) bit for bit on the card tests'
  sweep (d 1 to 1024, rows 1 to 50000, random rows with a zero padding
  row) and on every LayerNorm gradient of one training step of the
  transformer and of the autoencoder (the smoke run's steps).

Then it times the two builds (``chip_smoke.device_ms``: L2 flushed, the
host's enqueue kept out; in the order old, new, new, old) on K22 at the
smoke run's one block (2, 8192, 4, 64), one ring step (4096 x 4096), the
8-block ring at L 32768 (64 launches, every rank's blocks in the
reference's order) and at D 256, K1's tiled f32 kernel at R 256, L 1024,
and K17 at the trainers' shapes. Prints the card's name and power limit,
the registers and spills ptxas reports for each build, one line a case,
and a last line ``BITCHECK OK`` or ``BITCHECK FAILED n``; exits 1 on a
failure.
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

SOURCES = ("segment_attention", "ring_attention", "ln_bwd")
RING_RTOL = 1e-5  # the reference's ring bound, of the plain output's max
K17_ROWS = (1, 63, 2048, 50000)
K17_D = (1, 33, 128, 256, 1000, 1024)


def _ptxas(log: str) -> list[str]:
    """Each kernel's registers and spills from ``-Xptxas=-v``, after the
    template arguments of its mangled name."""
    out, name = [], ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            name = mangled[mangled.find("I"):][:40] if "I" in mangled \
                else mangled[-24:]
        elif "spill" in line:
            out.append(f"{name}: {line.strip()}")
        elif "Used" in line and "registers" in line:
            out.append(f"{name}: " + line.split("Used")[1].split(",")[0]
                       .strip())
    return out


def _bind(lib: ctypes.CDLL, name: str):
    if name == "segment_attention":
        f = lib.segment_attention_launch
        f.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                      + [ctypes.c_float] * 2 + [ctypes.c_void_p] * 2)
    elif name == "ring_attention":
        f = lib.ring_block_attention_launch
        f.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                      + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    else:
        f = lib.ln_bwd_launch
        f.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_float,
                                                ctypes.c_longlong,
                                                ctypes.c_int]
                      + [ctypes.c_void_p] * 5)
        p = lib.ln_bwd_partials
        p.argtypes = [ctypes.c_longlong]
        p.restype = ctypes.c_longlong
        f.restype = ctypes.c_int
        return f, p
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


def _trainer_ln_inputs(dev) -> list:
    """Every (x, weight, dy) K17 is handed in one training step of the
    transformer and of the autoencoder (the smoke run's steps: the
    reference's seed-0 weights, 63 traces padded to 64 rows)."""
    import torch

    import chip_smoke
    from odigos_tpu_torch import kernels
    from odigos_tpu_torch.models import (AutoencoderConfig, SpanAutoencoder,
                                         TraceTransformer, TransformerConfig)
    from odigos_tpu_torch.models.jax_init import autoencoder_state
    from odigos_tpu_torch.training import labeled_sequences

    seen = []
    real = kernels.dense.ln_bwd

    def rec(x, w, dy, *a, **k):
        seen.append((x.clone(), w.clone(), dy.clone()))
        return real(x, w, dy, *a, **k)

    tcfg = TransformerConfig(max_len=chip_smoke.TRAIN_LEN,
                             dtype=torch.float32)
    tmodel = TraceTransformer(tcfg, device=dev, seed=0)
    tdata = labeled_sequences(chip_smoke.TRAIN_TRACES - 1,
                              max_len=chip_smoke.TRAIN_LEN, seed=0,
                              pad_traces_to=chip_smoke.TRAIN_TRACES)
    acfg = AutoencoderConfig(max_len=chip_smoke.TRAIN_LEN,
                             dtype=torch.float32)
    amodel = SpanAutoencoder(acfg, device=dev)
    amodel.load_state_dict(autoencoder_state(acfg, 0))
    adata = chip_smoke._ae_train_step_data(chip_smoke.TRAIN_TRACES - 1)
    kernels.dense.ln_bwd = rec
    try:
        for model, loss in (
                (tmodel, lambda: tmodel.loss_fn(
                    tdata.categorical, tdata.continuous, tdata.mask,
                    tdata.span_labels, tdata.trace_labels)),
                (amodel, lambda: amodel.loss_fn(
                    adata.categorical, adata.continuous, adata.mask))):
            model.module.train()
            n = len(seen)
            loss().backward()
            model.module.eval()
            print("trainer step:", type(model).__name__, "K17 inputs",
                  len(seen) - n)
    finally:
        kernels.dense.ln_bwd = real
    return seen


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", required=True, type=Path)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke
    from odigos_tpu_torch.kernels.ring import (NEG_INF,
                                               ring_block_attention_plain)

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    with tempfile.TemporaryDirectory(prefix="bitcheck_") as tmp:
        old, new = _builds(args.old.resolve(), Path(tmp))
        dev = torch.device("cuda")
        rng = np.random.default_rng(0)
        scratch = torch.empty(128 << 20, dtype=torch.uint8, device=dev)

        def flush():
            scratch.zero_()

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

        def k17_call(lib, x, w, dy, outs, part):
            fn, _ = lib
            rows, d = x.shape
            return lambda: fn(
                x.data_ptr(), w.data_ptr(), dy.data_ptr(), 1e-6, rows, d,
                *(t.data_ptr() for t in outs), part.data_ptr(), stream())

        def k17_part(lib, rows, d):
            n = lib[1](rows)
            if n <= 0:
                raise RuntimeError("ln_bwd_partials failed")
            return torch.zeros(n * 2 * d, dtype=torch.float64, device=dev)

        def k17_outs(x):
            rows, d = x.shape
            return (torch.empty_like(x), torch.empty(d, device=dev),
                    torch.empty(d, device=dev))

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

        def fresh_state(B, Lq, H, D):
            return (torch.zeros((B, Lq, H, D), device=dev),
                    torch.full((B, H, Lq), NEG_INF, device=dev),
                    torch.zeros((B, H, Lq), device=dev))

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
                for fn in (old["ring_attention"], new["ring_attention"],
                           new["ring_attention"], None):
                    st = fresh_state(B, Lq, H, D)
                    for i, (k, v, mask) in enumerate(blocks):
                        if fn is None:
                            ring_block_attention_plain(q, k, v, mask, *st,
                                                       finalize=i == 2)
                            continue
                        rc = k22_call(fn, q, k, v, mask, *st, i == 2)()
                        torch.cuda.synchronize()
                        if rc != 0:
                            raise RuntimeError(f"K22 launch failed: {rc}")
                    got.append(st)
                g_old, g_new, g_again, g_plain = got

                def rel(a, b):
                    # each of o, m, s against its own largest magnitude
                    return max((x - y).abs().max().item()
                               / (z.abs().max().item() or 1.0)
                               for x, y, z in zip(a, b, g_plain))

                new_plain, old_plain = rel(g_new, g_plain), rel(g_old,
                                                                g_plain)
                again = all(same_bits(a, b) for a, b in zip(g_new, g_again))
                ok = new_plain <= RING_RTOL and again and all(
                    bool(torch.isfinite(t).all()) for t in g_new)
                cases, fails = cases + 1, fails + (not ok)
                print("K22", (B, Lq, Lk, H, D), qdt, "vs old",
                      rel(g_new, g_old), "vs plain", new_plain,
                      "(old vs plain", old_plain, ")",
                      "second call bit-equal" if again else
                      "SECOND CALL DIFFERS", "ok" if ok else "FAILED")

        def k17_case(tag, x, w, dy):
            nonlocal cases, fails
            rows, d = x.shape
            got = []
            for lib in (old["ln_bwd"], new["ln_bwd"]):
                outs = k17_outs(x)
                rc = k17_call(lib, x, w, dy, outs, k17_part(lib, rows, d))()
                torch.cuda.synchronize()
                if rc != 0:
                    raise RuntimeError(f"K17 launch failed: {rc}")
                got.append(outs)
            ok = all(same_bits(a, b) for a, b in zip(*got))
            cases, fails = cases + 1, fails + (not ok)
            print("K17", tag, (rows, d), "bit-equal" if ok else "DIFFERS")

        for d in K17_D:
            for rows in K17_ROWS:
                x = randn(rows, d) * 3 + 1
                dy = randn(rows, d)
                if rows > 1:
                    x[-1] = 0.0  # a padding row
                    dy[-1] = 0.0
                k17_case("sweep", x, randn(d), dy)
        for i, (x, w, dy) in enumerate(_trainer_ln_inputs(dev)):
            d = x.shape[-1]
            k17_case(f"trainer input {i}", x.reshape(-1, d).contiguous(),
                     w.contiguous(), dy.reshape(-1, d).contiguous())

        def timed(tag, fo, fn, reps=20):
            t = [chip_smoke.device_ms(f, flush, reps=reps)
                 for f in (fo, fn, fn, fo)]
            print(tag, "device ms old, new, new, old:", t, flush=True)

        def k22_pair(B, Lq, Lk, H, D):
            q, k, v = randn(B, Lq, H, D), randn(B, Lk, H, D), randn(B, Lk,
                                                                    H, D)
            mask = (torch.rand(B, Lk, device=dev) < 0.8).to(torch.uint8)
            st = fresh_state(B, Lq, H, D)
            return [k22_call(lib["ring_attention"], q, k, v, mask, *st,
                             False) for lib in (old, new)]

        def k22_ring(n, Lb):
            B, H, D = 2, 4, 64
            qs = [randn(B, Lb, H, D) for _ in range(n)]
            blocks = [(randn(B, Lb, H, D), randn(B, Lb, H, D),
                       (torch.rand(B, Lb, device=dev) < 0.8).to(torch.uint8))
                      for _ in range(n)]
            states = [fresh_state(B, Lb, H, D) for _ in range(n)]

            def ring(lib):
                def run():
                    for j in range(n):
                        o, m, s = states[j]
                        o.zero_()
                        m.fill_(NEG_INF)
                        s.zero_()
                        for i in range(n):
                            k22_call(lib["ring_attention"], qs[j],
                                     *blocks[(j - i) % n], o, m, s,
                                     i == n - 1)()
                return run

            return ring(old), ring(new)

        def k1_pair(R, L, H, hd):
            q, k, v = (randn(R, L, H, hd) for _ in range(3))
            seg, out = segments(R, L), torch.empty_like(q)
            lse = torch.empty((R, H, L), device=dev)
            return [k1_call(lib["segment_attention"], q, k, v, seg, out, lse,
                            3) for lib in (old, new)]

        def k17_pair(rows, d):
            x, w, dy = randn(rows, d) * 3 + 1, randn(d), randn(rows, d)
            return [k17_call(lib["ln_bwd"], x, w, dy, k17_outs(x),
                             k17_part(lib["ln_bwd"], rows, d))
                    for lib in (old, new)]

        timed("K22 one block (2, 8192, 4, 64)", *k22_pair(2, 8192, 8192, 4,
                                                         64))
        timed("K22 ring step (2, 4096, 4, 64) x 4096",
              *k22_pair(2, 4096, 4096, 4, 64))
        timed("K22 8-block ring L 32768 (64 launches)", *k22_ring(8, 4096),
              reps=3)
        timed("K22 D 256 (2, 4096, 2, 256)", *k22_pair(2, 4096, 4096, 2,
                                                       256))
        timed("K1 tiled f32 (256, 1024, 4, 64)", *k1_pair(256, 1024, 4, 64))
        timed("K17 (2048, 256)", *k17_pair(2048, 256))
        timed("K17 (2048, 128)", *k17_pair(2048, 128))
    print("BITCHECK", "OK" if fails == 0 else f"FAILED {fails}", "cases",
          cases)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())

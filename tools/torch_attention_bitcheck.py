#!/usr/bin/env python3
"""K1's CUDA-core routes, K15's f32 route, K22, K17, K16, K18, K11's f32
route and K19, built from another copy of their sources, against the
repo's own build: bit for bit where the arithmetic is meant to be the
same, within the plain bound where it is not, and timed.

    python3 tools/torch_attention_bitcheck.py --old DIR [--only a,b]

``DIR`` holds ``segment_attention.cu``, ``dense.cu`` (or
``gemm_f32.cu``), ``ring_attention.cu``, ``ln_bwd.cu``,
``segment_attention_bwd.cu``, ``span_embed_bwd.cu``, ``recon_ce.cu`` and
``gelu_bwd.cu`` as they stood before a change (with the headers they
include), for example ``git archive <commit> odigos_tpu_torch/kernels/csrc``
unpacked; ``--only`` names the sources to check (default: all eight;
``gemm_f32`` is K15's f32
route, ``DIR/gemm_f32.cu`` where the old copy has it, else the f32 route
of ``DIR/dense.cu``'s ``gemm_bf16_launch``). The tool builds both copies
with the repo's ``nvcc`` flags (each launcher bound by the symbols its
library exports), runs each on the same inputs from a seed on the card,
and compares:

* K1 ``segment_attention`` route 3 (the tiled CUDA-core kernel; hd 8 to
  256, L up to 1024, padding slots) and route 0 (the one-tile kernel; L 1
  to 64, hd 4 to 64, with 16-byte vectors and without, misaligned
  tensors, and every attention input of one training step of each
  trainer), f32 and bf16, with each query's log-sum-exp: bit for bit;
* K15 ``gemm_bf16``'s f32 route: every product of one training step of
  each trainer (QKV in planes, out + residual, FFN1 + GELU with its
  pre-activation, FFN2 + residual, ``dec_ff1``, ``dec_ff2``) and ragged
  shapes (M and N off the tiles, K off the slabs, every epilogue, a row
  count mid-tile): the outputs and ``pre`` bit for bit below the row
  count, and the rows of the tiles past it left as they were;
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
  transformer and of the autoencoder (the smoke run's steps);
* K16 ``segment_attention_bwd``: (dq, dk, dv) bit for bit on every
  attention gradient of one training step of each trainer (4 layers of
  (64, 32, 4, 64), 2 of (64, 32, 2, 64)), on more one-CTA-route shapes
  (L 1 to 64, hd 4 to 128, an all-padding row, padding dO zero and not),
  and on tiled-route shapes (L 40 to 1024, hd 30 to 256, the smoke's
  packed L 128 rows), each also within ``K16_RTOL`` of the plain version
  and a second call bit-equal;
* K18 ``span_embed_bwd``: every table bit for bit on each trainer's step
  and on random slots with the attr table, a hot row holding every live
  slot and ids past every table and below zero (d 256, 128, 42; there
  against the old build only where every id is in range: an older build
  clamped the others), and bit-equal to the plain version;
* K11 ``recon_ce``'s tensor-core route (``--only recon_ce``; bf16, every
  label in range): the errors and the squashed scores bit for bit on the
  128-position design (d 32 to 256) and the design chunked along d (d 16,
  48, 512, 1024), random cases and the served parity shapes (T 256 and
  2048 traces of L 64), a second call the same, within ``RECON_ATOL`` of
  the plain version;
* K11 ``recon_ce``'s f32 CUDA-core route (``--only recon_ce``): the errors,
  the log-sum-exps and the squashed scores at ``span_map`` bit for bit on
  the autoencoder trainer's step and on random cases (d 4 to 1024, f32
  and bf16 decoder rows, vocabularies off 16 and the kind head to 16,
  M 1 to 70000), a second call and a call without ``span_map`` and
  ``lse`` the same; labels -1, -V, V and V + 7 (against the old build
  only where every label is in range: an older build clamped them) with
  the plain version's NaN positions;
* K19 ``gelu_tanh_bwd`` (``--only gelu_bwd``): dPre and db bit for bit on
  every FFN1 gradient of both trainers' steps ((2048, 1024) and (2048,
  512)), ragged and large shapes and a case of zeros and large |pre|, a
  second call on the same scratch the same.

Then it times the two builds (``chip_smoke.device_ms``: L2 flushed, the
host's enqueue kept out; in the order old, new, new, old) on K1's route 0
at both trainers' steps and at R 256 (L 64, 4 heads of 64), K15's f32
route at each distinct product of both trainers' steps, on K22 at the
smoke run's one block (2, 8192, 4, 64), one ring step (4096 x 4096), the
8-block ring at L 32768 (64 launches, every rank's blocks in the
reference's order) and at D 256, K1's tiled f32 kernel at R 256, L 1024,
K17 at the trainers' shapes, K16 at both trainers' steps and at the
tiled route's (50, 128, 2, 128), and K18 at both trainers' steps (each
beside its library call: the backward of f32 SDPA under the same mask,
``index_add_`` per table), K11's f32 route at the autoencoder trainer's
step (with its log-sum-exps) and at the served parity shapes (T 256 and
2048 traces of L 64) beside the library sum (``F.layer_norm``, 4
``F.linear``, 3 ``F.cross_entropy`` and the squared error), K11's
tensor-core route at the served T 256 and 2048, and K19 at
both trainers' steps beside ``F.gelu``'s tanh backward. Prints the card's
name and power limit,
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

SOURCES = ("segment_attention", "gemm_f32", "ring_attention", "ln_bwd",
           "segment_attention_bwd", "span_embed_bwd", "recon_ce",
           "gelu_bwd", "ae_pool_bwd", "recon_ce_bwd")
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


def _bind(lib: ctypes.CDLL, name: str, src: str = ""):
    """``name``'s launcher(s) of ``lib`` with their argument types, by the
    build's own signature (``src``: the source it was built from; K11's
    and K20's launchers take the "model" axis's vocabulary slice and
    records in the sources that have ``take_slice_label``)."""
    sliced = "take_slice_label" in src
    if name == "gemm_f32":
        # (launcher, True) for gemm_f32.cu's own; (launcher, False) for
        # dense.cu's gemm_bf16_launch with its dtype and pre arguments
        own = hasattr(lib, "gemm_f32_launch")
        f = lib.gemm_f32_launch if own else lib.gemm_bf16_launch
        f.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * (1 if own
                                                                 else 2)
                      + [ctypes.c_longlong] + [ctypes.c_int] * 3
                      + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                         ctypes.c_void_p])
        f.restype = ctypes.c_int
        return f, own
    if name == "segment_attention":
        f = lib.segment_attention_launch
        f.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                      + [ctypes.c_float] * 2 + [ctypes.c_void_p] * 2)
    elif name == "segment_attention_bwd":
        f = lib.segment_attention_bwd_launch
        new = hasattr(lib, "segment_attention_bwd_route")  # one launch
        f.argtypes = ([ctypes.c_void_p] * (10 if new else 11)
                      + [ctypes.c_int] * 4 + [ctypes.c_float,
                                              ctypes.c_void_p])
        f.restype = ctypes.c_int
        return f, new
    elif name == "span_embed_bwd":
        f = lib.span_embed_bwd_launch
        new = hasattr(lib, "span_embed_bwd_sizes")
        f.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong]
                      + [ctypes.c_int] * 3
                      + [ctypes.c_void_p] * (4 if new else 5))
        f.restype = ctypes.c_int
        sizes = None
        if new:
            sizes = lib.span_embed_bwd_sizes
            sizes.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                              ctypes.c_void_p,
                              ctypes.POINTER(ctypes.c_longlong)]
            sizes.restype = ctypes.c_longlong
        return f, sizes
    elif name == "recon_ce":
        # (f32 launcher, its scratch sizes or None, tensor-core launcher,
        # sliced): a build with recon_ce_f32_counters takes the f32
        # route's counters, its data scratch, the card's SM count and a
        # launch count before the stream; a sliced build takes both
        # launchers' slice (4 ints) and records after their outputs
        tc = lib.recon_ce_tc_launch
        tc.argtypes = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float,
                        ctypes.c_void_p, ctypes.c_void_p]
                       + [ctypes.c_int] * 4
                       + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                          ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                          ctypes.c_void_p]
                       + [ctypes.c_float] * 4 + [ctypes.c_void_p] * 3
                       + ([ctypes.c_int] * 4 + [ctypes.c_void_p]
                          if sliced else [])
                       + [ctypes.c_void_p] * 4
                       + [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
                          ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
        tc.restype = ctypes.c_int
        f = lib.recon_ce_f32_launch
        new = hasattr(lib, "recon_ce_f32_counters")
        f.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_float] + [ctypes.c_void_p] * 8
                      + [ctypes.c_int] * 4
                      + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                         ctypes.c_int, ctypes.c_void_p]
                      + [ctypes.c_float] * 4 + [ctypes.c_void_p] * 4
                      + ([ctypes.c_int] * 4 + [ctypes.c_void_p]
                         if sliced else [])
                      + ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                          ctypes.POINTER(ctypes.c_int)] if new else [])
                      + [ctypes.c_void_p])
        f.restype = ctypes.c_int
        size = None
        if new:
            data = lib.recon_ce_f32_scratch
            data.argtypes = [ctypes.c_longlong] + [ctypes.c_int] * 3
            data.restype = ctypes.c_longlong
            cnt = lib.recon_ce_f32_counters
            cnt.argtypes = [ctypes.c_longlong]
            cnt.restype = ctypes.c_longlong
            size = (cnt, data)
        return f, size, tc, sliced
    elif name == "gelu_bwd":
        # (launcher, flags(M, N) or None, partials(M, N)): a build with
        # gelu_bwd_flags takes its flags before its partials, then the
        # card's SM count and a launch count before the stream
        f = lib.gelu_tanh_bwd_launch
        one = hasattr(lib, "gelu_bwd_flags")
        f.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong,
                                               ctypes.c_int]
                      + ([ctypes.c_void_p] * 4
                         + [ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                            ctypes.c_void_p] if one
                         else [ctypes.c_void_p] * 4))
        f.restype = ctypes.c_int
        if one:
            size = lib.gelu_bwd_scratch
            size.argtypes = [ctypes.c_longlong, ctypes.c_int]
            size.restype = ctypes.c_longlong
            cnt = lib.gelu_bwd_flags
            cnt.argtypes = [ctypes.c_longlong, ctypes.c_int]
            cnt.restype = ctypes.c_longlong
            return f, cnt, size
        parts = lib.gelu_bwd_partials
        parts.argtypes = [ctypes.c_longlong]
        parts.restype = ctypes.c_longlong
        return f, None, lambda M, N: parts(M) * N
    elif name == "ae_pool_bwd":
        # (launcher, scratch(T, d) or None, partials(T)): a build with
        # ln_masked_pool_bwd_scratch takes its counters before its f64
        # scratch, then the card's SM count and a launch count
        f = lib.ln_masked_pool_bwd_launch
        one = hasattr(lib, "ln_masked_pool_bwd_scratch")
        f.argtypes = ([ctypes.c_void_p] * 4
                      + [ctypes.c_float, ctypes.c_longlong, ctypes.c_int,
                         ctypes.c_int] + [ctypes.c_void_p] * 3
                      + ([ctypes.c_void_p] * 2
                         + [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
                         if one else [ctypes.c_void_p])
                      + [ctypes.c_void_p])
        f.restype = ctypes.c_int
        if one:
            size = lib.ln_masked_pool_bwd_scratch
            size.argtypes = [ctypes.c_longlong, ctypes.c_int]
            size.restype = ctypes.c_longlong
            cnt = lib.ln_masked_pool_bwd_counters
            cnt.argtypes = [ctypes.c_longlong]
            cnt.restype = ctypes.c_longlong
            return f, (cnt, size)
        parts = lib.ln_masked_pool_bwd_partials
        parts.argtypes = [ctypes.c_longlong]
        parts.restype = ctypes.c_longlong
        return f, parts
    elif name == "recon_ce_bwd":
        # (launcher, (counters, scratch) or None, slices, sliced): a build
        # with recon_ce_bwd_scratch takes its counters and byte scratch,
        # dy, dW and db, the card's SM count and a launch count; the
        # parent takes its list, count, dl, y and dy partials, and a
        # zeroed dy; a sliced build takes the slice (4 ints) and dy_heads
        # after the loss weights
        f = lib.recon_ce_bwd_launch
        one = hasattr(lib, "recon_ce_bwd_scratch")
        f.argtypes = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float]
                      + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                      + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                         ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                         ctypes.c_void_p] + [ctypes.c_float] * 4
                      + ([ctypes.c_int] * 5 if sliced else [])
                      + ([ctypes.c_void_p] * 5
                         + [ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                            ctypes.c_void_p] if one
                         else [ctypes.c_void_p] * 9))
        f.restype = ctypes.c_int
        sl = lib.recon_ce_bwd_slices
        sl.argtypes = [ctypes.c_int] * 4
        sl.restype = ctypes.c_int
        if one:
            cnt = lib.recon_ce_bwd_counters
            cnt.argtypes = [ctypes.c_longlong] + [ctypes.c_int] * 4
            cnt.restype = ctypes.c_longlong
            data = lib.recon_ce_bwd_scratch
            data.argtypes = [ctypes.c_longlong] + [ctypes.c_int] * 5
            data.restype = ctypes.c_longlong
            return f, (cnt, data), sl, sliced
        return f, None, sl, sliced
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


def _builds(old_dir: Path, out: Path, names):
    from odigos_tpu_torch.kernels import build

    procs = {}
    for name in names:
        so = out / f"old_{name}.so"
        src = old_dir / f"{name}.cu"
        if name == "gemm_f32" and not src.exists():
            src = old_dir / "dense.cu"  # the f32 route's first home
        procs[name] = (subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(so),
             str(src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), so, src)
    build.build(list(names))
    old, new = {}, {}
    for name, (p, so, src) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"old {name} failed to build:\n{log}")
        print("old", name, _ptxas(log))
        print("new", name, _ptxas(build.build_logs[name])
              if name in build.build_logs else "(built before this run)")
        old[name] = _bind(ctypes.CDLL(str(so)), name, src.read_text())
        new[name] = _bind(ctypes.CDLL(str(build.library_path(name))), name,
                          (build.CSRC / build.SOURCES[name]).read_text())
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


def _trainer_bwd_inputs(dev, hooks=(("attention", "segment_attention_bwd"),
                                     ("embed", "span_embed_bwd")),
                        kwargs: bool = False) -> dict:
    """Every argument tuple the kernels of ``hooks`` ((module, wrapper)
    pairs; by default K16 and K18) are handed in one training step of the
    transformer and of the autoencoder (the smoke run's steps): a list a
    wrapper of (model, args), or with ``kwargs`` (model, args, kwargs)."""
    import torch

    import chip_smoke
    from odigos_tpu_torch import kernels
    from odigos_tpu_torch.models import (AutoencoderConfig, SpanAutoencoder,
                                         TraceTransformer, TransformerConfig)
    from odigos_tpu_torch.models.jax_init import autoencoder_state
    from odigos_tpu_torch.training import labeled_sequences

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
    seen: dict = {}
    saved = []
    for mod, name in hooks:
        m = getattr(kernels, mod)
        real = getattr(m, name)
        saved.append((m, name, real))

        def rec(*a, _real=real, _name=name, **k):
            entry = (seen["model"], [t.clone() if hasattr(t, "clone") else t
                                     for t in a])
            seen.setdefault(_name, []).append(entry + ((dict(k),) if kwargs
                                                       else ()))
            return _real(*a, **k)

        setattr(m, name, rec)
    try:
        for tag, model, loss in (
                ("transformer", tmodel, lambda: tmodel.loss_fn(
                    tdata.categorical, tdata.continuous, tdata.mask,
                    tdata.span_labels, tdata.trace_labels)),
                ("autoencoder", amodel, lambda: amodel.loss_fn(
                    adata.categorical, adata.continuous, adata.mask))):
            seen["model"] = tag
            model.module.train()
            loss().backward()
            model.module.eval()
    finally:
        for m, name, real in saved:
            setattr(m, name, real)
    seen.pop("model")
    return seen


def _k16_k18_checks(old, new, only, dev, rng, randn, segments, same_bits,
                    stream, flush, timed) -> tuple[int, int]:
    """K16 and K18, old build against new: (failures, cases)."""
    import torch
    import torch.nn.functional as F

    import chip_smoke
    from odigos_tpu_torch.kernels import attention, embed

    import numpy as np

    fails = cases = 0
    inputs = _trainer_bwd_inputs(dev)

    def k16_call(lib, args, out):
        fn, one_launch = lib
        q, k, v, seg, o, lse, do = args[:7]
        R, L, H, hd = q.shape
        sd = attention._scale_div(hd, torch.float32)
        head = [t.data_ptr() for t in (q, k, v, seg, o, lse, do)]
        if not one_launch:
            head.append(torch.empty((R, H, L), device=dev).data_ptr())
        ptrs = head + [t.data_ptr() for t in out]

        def run():
            rc = fn(*ptrs, R, L, H, hd, sd, stream())
            if rc != 0:
                raise RuntimeError(f"K16 launch failed: {rc}")
        return run

    def k16_case(tag, args):
        nonlocal fails, cases
        q = args[0]
        got = []
        for lib in (old["segment_attention_bwd"],
                    new["segment_attention_bwd"],
                    new["segment_attention_bwd"]):
            out = torch.empty((3,) + tuple(q.shape), device=dev)
            k16_call(lib, args, out)()
            torch.cuda.synchronize()
            got.append(out)
        ref = attention.segment_attention_bwd_plain(*args[:7])
        bit_old = same_bits(got[0], got[1])
        again = same_bits(got[1], got[2])
        rel = max((a - b).abs().max().item() / (b.abs().max().item() or 1.0)
                  for a, b in zip(got[1], ref))
        R, L, H, hd = q.shape
        route = attention.bwd_route(L, hd, *args[:7])
        # bit-equal to the parent where both run the same chains (always,
        # by design); within the bound everywhere
        ok = (bit_old and again and rel <= chip_smoke.K16_RTOL
              and bool(torch.isfinite(got[1]).all()))
        cases, fails = cases + 1, fails + (not ok)
        print("K16", tag, tuple(q.shape), route,
              "bit-equal to old" if bit_old else "DIFFERS from old",
              "second call bit-equal" if again else "SECOND CALL DIFFERS",
              "vs plain", rel, "ok" if ok else "FAILED", flush=True)

    def k16_random(R, L, H, hd, padding_do):
        q, k, v, do = (randn(R, L, H, hd) for _ in range(4))
        seg = segments(R, L)
        seg[-1] = 0  # an all-padding row
        if not padding_do:
            do = do * (seg > 0)[..., None, None]
        lse = torch.empty((R, H, L), device=dev)
        o = attention.segment_attention(q, k, v, seg, lse)
        return (q, k, v, seg, o, lse, do.contiguous())

    def k18_call(lib, args):
        fn, sizes = lib
        dy, cat, pos, seg, tables = args[:5]
        specs = embed._bwd_tables(cat, tables)
        R, L, C = cat.shape
        N, d = R * L, dy.shape[-1]
        meta = [x for (_, tab, id_rows, first, step, ncols, use_pos) in specs
                for x in (tab.shape[0], id_rows, first, step, ncols,
                          use_pos)]
        marr = (ctypes.c_int * len(meta))(*meta)
        rows = [tab.shape[0] for _, tab, *_ in specs]
        if sizes is not None:
            on = ctypes.c_longlong(0)
            elems = sizes(N, d, len(specs), ctypes.cast(marr,
                                                        ctypes.c_void_p),
                          ctypes.byref(on))
            flat = torch.empty(elems, device=dev)
            order = torch.empty(max(on.value, 1), dtype=torch.int32,
                                device=dev)
            outs = list(torch.split(flat, [n * d for n in rows]))
            call = (dy.data_ptr(), cat.data_ptr(), pos.data_ptr(),
                    seg.data_ptr(), N, C, d, len(specs),
                    ctypes.cast(marr, ctypes.c_void_p), flat.data_ptr(),
                    order.data_ptr())
        else:
            outs = [torch.empty(n * d, device=dev) for n in rows]
            starts = [torch.empty(n + 1, dtype=torch.int32, device=dev)
                      for n in rows]
            orders = [torch.empty(max(N * sp[5], 1), dtype=torch.int32,
                                  device=dev) for sp in specs]
            n = len(specs)
            keep = [(ctypes.c_longlong * n)(*(t.data_ptr() for t in ts))
                    for ts in (outs, starts, orders)]
            call = (dy.data_ptr(), cat.data_ptr(), pos.data_ptr(),
                    seg.data_ptr(), N, C, d, n, *keep, marr)

        def run():
            rc = fn(*call, stream())
            if rc != 0:
                raise RuntimeError(f"K18 launch failed: {rc}")
        return run, outs, (starts, orders) if sizes is None else order

    def k18_case(tag, args):
        nonlocal fails, cases
        got = []
        for lib in (old["span_embed_bwd"], new["span_embed_bwd"],
                    new["span_embed_bwd"]):
            run, outs, _keep = k18_call(lib, args)
            run()
            torch.cuda.synchronize()
            got.append(torch.cat(outs))
        ref = embed.span_embed_bwd_plain(*args[:5])
        ref = torch.cat([getattr(ref, n).reshape(-1) for n in
                         ("service", "name", "kind", "status", "attr", "pos")
                         if getattr(ref, n) is not None])
        # an id outside its table: an older build clamped it where this
        # one drops or wraps it as nn.Embed's fill mode
        cat = args[1].reshape(-1, args[1].shape[-1])
        in_range = all(bool(((cat[:, first + j * step] >= 0)
                             & (cat[:, first + j * step] < id_rows)).all())
                       for _, _, id_rows, first, step, ncols, use_pos
                       in embed._bwd_tables(args[1], args[4])
                       if not use_pos for j in range(ncols))
        ok = ((not in_range or same_bits(got[0], got[1]))
              and same_bits(got[1], got[2]) and same_bits(got[1], ref))
        cases, fails = cases + 1, fails + (not ok)
        print("K18", tag, tuple(args[0].shape),
              ("bit-equal to old, " if in_range else "ids past a table, ")
              + "a second call and plain" if ok else "DIFFERS: FAILED",
              flush=True)

    def k18_random(R, L, d, attr_slots, hot):
        tables = embed.EmbedTables(
            service=randn(512, d), name=randn(2048, d), kind=randn(8, d),
            status=randn(4, d), attr=randn(30, d) if attr_slots else None,
            cont_w=torch.zeros(d, 3, device=dev),
            cont_b=torch.zeros(d, device=dev), pos=randn(L, d))
        C = embed.N_BASE_FIELDS + attr_slots
        cat = torch.from_numpy(rng.integers(-3, 3000, (R, L, C)).astype(
            np.int32)).to(dev)
        seg = segments(R, L)
        if hot:  # one status row holds every live slot
            cat[..., 3] = 2
        pos = torch.from_numpy(np.tile(np.arange(L, dtype=np.int32) + 3,
                                       (R, 1))).to(dev)
        return (randn(R, L, d), cat.contiguous(), pos, seg, tables)

    if "segment_attention_bwd" in only:
        for i, (model, args) in enumerate(inputs["segment_attention_bwd"]):
            k16_case(f"{model} step input {i}", args)
        for R, L, H, hd in [(64, 32, 4, 64), (64, 32, 2, 64), (16, 64, 4, 32),
                            (7, 33, 3, 16), (3, 1, 2, 4), (5, 64, 2, 128),
                            (9, 20, 2, 100), (50, 128, 2, 128),
                            (8, 128, 2, 128), (4, 96, 2, 256),
                            (2, 1024, 2, 64), (3, 200, 1, 40),
                            (16, 64, 4, 30)]:
            for padding_do in (False, True):
                k16_case(f"random padding dO {padding_do}",
                         k16_random(R, L, H, hd, padding_do))
    if "span_embed_bwd" in only:
        for i, (model, args) in enumerate(inputs["span_embed_bwd"]):
            k18_case(f"{model} step input {i}", args)
        for R, L, d, attr_slots, hot in [(64, 32, 256, 3, False),
                                         (64, 32, 256, 0, True),
                                         (300, 64, 128, 2, False),
                                         (64, 32, 42, 1, True)]:
            k18_case(f"random attr {attr_slots} hot {hot} d {d}",
                     k18_random(R, L, d, attr_slots, hot))

    def library_ms(tag, fn):
        print(tag, "library device ms:",
              chip_smoke.device_ms(fn, flush), flush=True)

    if "segment_attention_bwd" in only:
        pk_args = None
        for model, args in inputs["segment_attention_bwd"]:
            if pk_args is None or model != pk_args[0]:
                pk_args = (model, args)
                outs = [torch.empty((3,) + tuple(args[0].shape), device=dev)
                        for _ in range(2)]
                timed(f"K16 {model} step {tuple(args[0].shape)}",
                      k16_call(old["segment_attention_bwd"], args, outs[0]),
                      k16_call(new["segment_attention_bwd"], args, outs[1]))
        from odigos_tpu_torch.features import pack_sequences
        from odigos_tpu_torch.pdata import synthesize_traces

        pk = pack_sequences(synthesize_traces(600, seed=21), max_len=128,
                            pad_rows_to=lambda r: r + 2)
        seg2 = torch.from_numpy(pk.segments).to(dev).contiguous()
        R2, L2 = seg2.shape
        g = torch.Generator().manual_seed(17)
        q2, k2, v2, do2 = (torch.randn(R2, L2, 2, 128, generator=g).to(dev)
                           for _ in range(4))
        do2 = (do2 * (seg2 > 0)[..., None, None]).contiguous()
        lse2 = torch.empty(R2, 2, L2, device=dev)
        o2 = attention.segment_attention(q2, k2, v2, seg2, lse2)
        targs = (q2, k2, v2, seg2, o2, lse2, do2)
        k16_case("smoke tiled rows", targs)
        outs = [torch.empty((3, R2, L2, 2, 128), device=dev)
                for _ in range(2)]
        timed(f"K16 tiled {(R2, L2, 2, 128)}",
              k16_call(old["segment_attention_bwd"], targs, outs[0]),
              k16_call(new["segment_attention_bwd"], targs, outs[1]))
        for tag, (q, k, v, seg, o, lse, do) in (
                ("transformer step", inputs["segment_attention_bwd"][0][1]
                 [:7]), ("tiled", targs)):
            segl = seg.long()
            allowed = ((segl[:, :, None] == segl[:, None, :])
                       & (segl[:, :, None] > 0))[:, None]
            qt, kt, vt = (t.transpose(1, 2).detach().clone()
                          .requires_grad_() for t in (q, k, v))
            ot = F.scaled_dot_product_attention(qt, kt, vt,
                                                attn_mask=allowed)
            dot = do.transpose(1, 2)
            library_ms(f"K16 {tag} (f32 SDPA backward)",
                       lambda ot=ot, qt=qt, kt=kt, vt=vt, dot=dot:
                       torch.autograd.grad(ot, (qt, kt, vt), dot,
                                           retain_graph=True))
    if "span_embed_bwd" in only:
        for model, args in inputs["span_embed_bwd"]:
            runs = [k18_call(lib, args) for lib in (old["span_embed_bwd"],
                                                    new["span_embed_bwd"])]
            timed(f"K18 {model} step {tuple(args[0].shape)}",
                  runs[0][0], runs[1][0])
        dy, cat, pos, seg, tables = inputs["span_embed_bwd"][0][1][:5]
        d = dy.shape[-1]
        live = (seg > 0).reshape(-1)
        c2 = cat.reshape(-1, cat.shape[-1]).long()
        specs = [(tables.service, c2[:, 0], tables.service.shape[0]),
                 (tables.service, c2[:, 4], tables.service.shape[0]),
                 (tables.name, c2[:, 1], tables.name.shape[0]),
                 (tables.kind, c2[:, 2], embed.KIND_VOCAB),
                 (tables.status, c2[:, 3], embed.STATUS_VOCAB),
                 (tables.pos, pos.reshape(-1).long(), tables.pos.shape[0])]
        specs = [(t, ids.clamp(0, n - 1)[live]) for t, ids, n in specs]
        dy_live = dy.reshape(-1, d)[live].contiguous()
        library_ms("K18 transformer step (index_add_ x 6)",
                   lambda: [torch.zeros_like(t).index_add_(0, ids, dy_live)
                            for t, ids in specs])
    return fails, cases


def _k11_k19_checks(old, new, only, dev, rng, randn, same_bits, stream,
                    flush, timed) -> tuple[int, int]:
    """K11's f32 route and K19, old build against new: (failures,
    cases)."""
    import torch
    import torch.nn.functional as F

    import chip_smoke
    from odigos_tpu_torch.features import assemble_sequences
    from odigos_tpu_torch.kernels import recon
    from odigos_tpu_torch.pdata import synthesize_traces

    import numpy as np

    fails = cases = 0
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    calls = _trainer_bwd_inputs(dev, (("recon", "recon_ce"),
                                      ("dense", "gelu_tanh_bwd")),
                                kwargs=True)

    def k11_call(lib, args, out):
        """A launch of ``lib``'s f32 route on recon_ce's ``args`` (dec,
        ln weight and bias, heads, cat, cont, mask, loss weights, eps,
        span_map) into ``out`` (err, scores or None, lse or None); the
        new build's scratch made once, as the wrapper keeps it."""
        fn, size, _, sliced = lib
        dec, lw, lb, heads, cat, cont, mask, wts, eps, smap = args
        err, scores, lse = out
        M, d = dec.shape
        vs = [w.shape[0] for w, _ in heads]
        ptrs = ([dec.data_ptr(), int(dec.dtype == torch.bfloat16), M, d,
                 lw.data_ptr(), lb.data_ptr(), eps]
                + [w.data_ptr() for w, _ in heads]
                + [b.data_ptr() for _, b in heads] + vs
                + [cat.data_ptr(), cat.shape[1], cont.data_ptr(),
                   cont.shape[1], mask.data_ptr()]
                + [float(w) for w in wts]
                + [err.data_ptr(), None if smap is None else smap.data_ptr(),
                   None if scores is None else scores.data_ptr(),
                   None if lse is None else lse.data_ptr()]
                + ([vs[0], 0, vs[1], 0, None] if sliced else []))
        if size is not None:
            n, nb = size[0](M), size[1](M, *vs[:3])
            if n < 0 or nb < 0:
                raise RuntimeError("recon_ce_f32 scratch sizes failed")
            scratch = (torch.zeros(max(n, 1), dtype=torch.int32, device=dev),
                       torch.empty(max(nb, 16), dtype=torch.uint8,
                                   device=dev))
            launched = ctypes.c_int(0)
            ptrs += [scratch[0].data_ptr(), scratch[1].data_ptr(), sms,
                     ctypes.byref(launched)]
        else:
            scratch = None

        def run(_keep=scratch):  # the scratch lives as long as the launch
            if scores is not None:
                scores.zero_()
            rc = fn(*ptrs, stream())
            if rc != 0:
                raise RuntimeError(f"K11 f32 launch failed: {rc}")
        return run

    def k11_outs(args, with_map, with_lse):
        M = args[0].shape[0]
        return (torch.empty(M, device=dev),
                torch.zeros(M + 3, device=dev) if with_map else None,
                torch.empty(M, 3, device=dev) if with_lse else None)

    def k11_tc_call(lib, args, out):
        """A launch of ``lib``'s tensor-core route (bf16 ``dec``: the
        128-position design at ``recon.TC_WIDTHS``, the design chunked
        along d elsewhere) on ``args`` into ``out`` (err, scores or None),
        its scratch made as the wrapper makes it (the zeroed count and
        tiles' slices zeroed again before each launch, as the wrapper's
        fresh ``torch.zeros``)."""
        tc, sliced = lib[2], lib[3]
        dec, lw, lb, heads, cat, cont, mask, wts, eps, smap = args
        err, scores, _ = out
        M, d = dec.shape
        planes = recon.head_planes(heads)
        v_tc = planes.w.shape[1]
        items = recon.PART_ITEMS_PER_SM * sms
        lst = torch.empty(M, dtype=torch.int32, device=dev)
        stats = torch.empty((2 if d in recon.TC_WIDTHS else 4) * M,
                            dtype=torch.float32, device=dev)
        zeros = torch.zeros(2 + items // 2, dtype=torch.int32, device=dev)
        part = torch.empty(items * 6 * recon.TILE, dtype=torch.float32,
                           device=dev)
        (w2, b2), (w3, b3) = heads[2], heads[3]
        launched = ctypes.c_int(0)

        def run():
            zeros.zero_()
            if scores is not None:
                scores.zero_()
            rc = tc(dec.data_ptr(), M, d, lw.data_ptr(), lb.data_ptr(), eps,
                    planes.w.data_ptr(), planes.b.data_ptr(), planes.vs_pad,
                    v_tc, planes.v_s, planes.v_n, w2.data_ptr(),
                    b2.data_ptr(), w2.shape[0], w3.data_ptr(), b3.data_ptr(),
                    cat.data_ptr(), cat.shape[1], cont.data_ptr(),
                    cont.shape[1], mask.data_ptr(),
                    *(float(w) for w in wts), err.data_ptr(),
                    None if smap is None else smap.data_ptr(),
                    None if scores is None else scores.data_ptr(),
                    *((planes.v_s, 0, planes.v_n, 0, None) if sliced
                      else ()),
                    lst.data_ptr(), stats.data_ptr(), zeros.data_ptr(),
                    part.data_ptr(), part.numel(), zeros.data_ptr() + 4, sms,
                    ctypes.byref(launched), stream())
            if rc != 0:
                raise RuntimeError(f"K11 tc launch failed: {rc}")
        return run

    def k11_tc_case(tag, args):
        """Old and new (twice) on the tensor-core route with span_map,
        every label in range: err and scores bit for bit, and the new
        build within RECON_ATOL of the plain version."""
        nonlocal cases, fails
        got = []
        for lib in (old["recon_ce"], new["recon_ce"], new["recon_ce"]):
            out = k11_outs(args, True, False)
            k11_tc_call(lib, args, out)()
            torch.cuda.synchronize()
            got.append(out[:2])
        ref_e = recon.recon_ce_plain(*args[:8], eps=args[8])
        new_e = got[1][0]
        real = args[6].bool()
        near = bool(torch.isfinite(new_e).all()) and (
            (new_e[real] - ref_e[real]).abs().max().item()
            <= chip_smoke.RECON_ATOL if real.any() else True)
        same = all(same_bits(a, b) for a, b in zip(got[0], got[1]))
        again = all(same_bits(a, b) for a, b in zip(got[1], got[2]))
        ok = near and same and again
        cases, fails = cases + 1, fails + (not ok)
        design = ("128-position" if args[0].shape[1] in recon.TC_WIDTHS
                  else "chunked along d")
        print("K11 tc", design, tag, tuple(args[0].shape),
              "bit-equal to old (err, scores), a second call, near plain"
              if ok else f"DIFFERS: FAILED (near {near} old {same} "
              f"again {again})", flush=True)

    def k11_case(tag, args, in_range=True):
        """Old and new (twice) with span_map and lse, then new without
        either: bit for bit where every label is in range (an older build
        clamped the others); the new build against the plain version
        always (its NaN positions, and within RECON_ATOL elsewhere)."""
        nonlocal cases, fails
        got = []
        for lib, full in ((old["recon_ce"], True), (new["recon_ce"], True),
                          (new["recon_ce"], True), (new["recon_ce"], False)):
            out = k11_outs(args, full, full)
            k11_call(lib, args if full else args[:-1] + (None,), out)()
            torch.cuda.synchronize()
            got.append(out)
        ref_e, ref_s = recon.recon_ce_plain(*args[:8], span_map=args[9],
                                            n_out=args[0].shape[0] + 3,
                                            eps=args[8])
        new_e, new_s, new_l = got[1]
        nan_same = torch.equal(new_e.isnan(), ref_e.isnan()) and \
            torch.equal(new_s.isnan(), ref_s.isnan())
        fin = ~ref_e.isnan()
        near = (new_e[fin] - ref_e[fin]).abs().max().item() \
            <= chip_smoke.RECON_ATOL if fin.any() else True
        again = all(same_bits(a, b) for a, b in zip(got[1], got[2]))
        alone = same_bits(got[3][0], new_e)
        old_ok = not in_range or all(same_bits(a, b)
                                     for a, b in zip(got[0], got[1]))
        ok = nan_same and near and again and alone and old_ok and bool(
            torch.isfinite(new_l).all())
        cases, fails = cases + 1, fails + (not ok)
        print("K11 f32", tag, tuple(args[0].shape), args[0].dtype,
              ("bit-equal to old (err, lse, scores), " if in_range
               else "labels past a head, ")
              + "a second call, without span_map and lse, plain's NaNs"
              if ok else f"DIFFERS: FAILED (nan {nan_same} near {near} "
              f"again {again} alone {alone} old {old_ok})", flush=True)

    def k11_random(M, d, vocabs, density, dt, bad=False):
        dec = randn(M, d) * 2 + 0.5
        mask = torch.from_numpy(rng.random(M) < density).to(dev)
        cat = torch.from_numpy(np.stack(
            [rng.integers(0, V, M) for V in vocabs[:3]]
            + [np.zeros(M, np.int64)] * 2, 1).astype(np.int32)).to(dev)
        if bad:
            for h in range(3):
                V = vocabs[h]
                cat[h::11, h] = torch.tensor(
                    [-1, -V, V, V + 7], dtype=torch.int32,
                    device=dev).repeat(M)[:cat[h::11].shape[0]]
        cont = torch.from_numpy((rng.random((M, 3)) * 4).astype(
            np.float32)).to(dev)
        heads = [(randn(V, d) / d ** 0.5, randn(V) / 4) for V in vocabs]
        smap = torch.from_numpy(rng.permutation(M + 3)[:M].astype(
            np.int32)).to(dev)
        smap[::5] = -1
        return (dec.to(dt).contiguous(), 1 + randn(d) / 4, randn(d) / 4,
                heads, cat, cont, mask, (1.0, 0.7, 0.5, 0.3), 1e-6, smap)

    def served(T):
        """The served parity shape: T traces of L 64 from the synthetic
        mix (~10.3 spans a trace), the default autoencoder's heads."""
        seqs = assemble_sequences(synthesize_traces(T, seed=T), max_len=64)
        M = T * 64
        cat = torch.from_numpy(seqs.categorical.reshape(M, -1)).to(dev)
        cat[:, 0] %= 512
        cat[:, 1] %= 2048
        cat[:, 2] %= 8
        heads = [(randn(V, 128) / 128 ** 0.5, randn(V) / 4)
                 for V in (512, 2048, 8, 1)]
        return (randn(M, 128), 1 + randn(128) / 4, randn(128) / 4, heads,
                cat.contiguous(),
                torch.from_numpy(seqs.continuous.reshape(M, -1)).to(dev),
                torch.from_numpy(seqs.mask.reshape(M)).to(dev),
                (1.0, 1.0, 0.5, 1.0), 1e-6, None)

    step_k11 = []
    if "recon_ce" in only:
        for model, args, kw in calls.get("recon_ce", []):
            a = tuple(args[:8]) + (kw.get("eps", recon.LN_EPS),)
            smap = torch.arange(args[0].shape[0], dtype=torch.int32,
                                device=dev)
            step_k11.append(a + (smap,))
            k11_case(f"{model} step input", step_k11[-1])
        for M, d, vocabs, density in [
                (1, 128, (512, 2048, 8, 1), 1.0),
                (2048, 128, (512, 2048, 8, 1), 0.3),
                (4096, 32, (64, 64, 8, 1), 0.16),
                (3000, 4, (7, 33, 3, 1), 0.5),
                (2000, 12, (100, 300, 8, 1), 0.6),
                (1500, 100, (513, 17, 16, 1), 0.4),
                (1024, 256, (100, 300, 8, 1), 0.9),
                (900, 388, (512, 2048, 8, 1), 0.3),
                (700, 768, (64, 64, 8, 1), 0.5),
                (600, 1000, (512, 200, 8, 1), 0.5),
                (500, 1024, (512, 2048, 8, 1), 0.4),
                (20000, 128, (512, 2048, 8, 1), 0.9),
                (70000, 128, (512, 2048, 8, 1), 0.16)]:
            for dt in (torch.float32, torch.bfloat16):
                k11_case(f"random density {density}",
                         k11_random(M, d, vocabs, density, dt), True)
        for dt in (torch.float32, torch.bfloat16):
            k11_case("labels -1, -V, V, V + 7",
                     k11_random(3000, 128, (512, 2048, 8, 1), 0.5, dt,
                                bad=True), False)
        for M, d, vocabs, density in [
                (1, 128, (512, 2048, 8, 1), 1.0),
                (4096, 32, (64, 64, 8, 1), 0.16),
                (3000, 64, (100, 300, 8, 1), 0.5),
                (20000, 128, (512, 2048, 8, 1), 0.16),
                (1024, 256, (513, 17, 16, 1), 0.9),
                (3000, 16, (7, 33, 3, 1), 0.5),
                (2000, 48, (100, 300, 8, 1), 0.6),
                (900, 512, (512, 2048, 8, 1), 0.3),
                (500, 1024, (512, 200, 8, 1), 0.4)]:
            k11_tc_case(f"random density {density}",
                        k11_random(M, d, vocabs, density, torch.bfloat16))
        for T in (256, 2048):
            a = served(T)
            k11_tc_case(f"served T {T}",
                        (a[0].to(torch.bfloat16),) + a[1:9] + (
                            torch.arange(a[0].shape[0], dtype=torch.int32,
                                         device=dev),))
    if "gelu_bwd" in only:
        def k19_call(lib, dy, pre, out):
            fn, tickets, size = lib
            M, N = dy.shape
            scratch = [torch.zeros(max(size(M, N), 1), dtype=torch.float64,
                                   device=dev)]
            tail = []
            if tickets is not None:
                scratch.insert(0, torch.zeros(max(tickets(M, N), 1),
                                              dtype=torch.int32, device=dev))
                launched = ctypes.c_int(0)
                tail = [sms, ctypes.byref(launched)]

            def run():
                rc = fn(dy.data_ptr(), pre.data_ptr(), M, N,
                        out[0].data_ptr(), out[1].data_ptr(),
                        *(t.data_ptr() for t in scratch), *tail, stream())
                if rc != 0 or (tail and launched.value != 1):
                    raise RuntimeError(f"K19 launch failed: {rc}")
            return run

        def k19_case(tag, dy, pre):
            nonlocal cases, fails
            got = []
            for lib in (old["gelu_bwd"], new["gelu_bwd"], new["gelu_bwd"]):
                out = (torch.empty_like(dy),
                       torch.empty(dy.shape[1], device=dev))
                run = k19_call(lib, dy, pre, out)
                run()
                if lib is new["gelu_bwd"]:
                    run()  # the scratch as a second call finds it
                torch.cuda.synchronize()
                got.append(out)
            ok = all(same_bits(a, b) for a, b in zip(*got[:2])) and all(
                same_bits(a, b) for a, b in zip(*got[1:]))
            cases, fails = cases + 1, fails + (not ok)
            print("K19", tag, tuple(dy.shape),
                  "bit-equal to old (dPre, db), a second call bit-equal"
                  if ok else "DIFFERS: FAILED", flush=True)

        steps_k19 = {}
        for model, args, _ in calls.get("gelu_tanh_bwd", []):
            k19_case(f"{model} step input", args[0], args[1])
            steps_k19.setdefault(model, (args[0], args[1]))
        for M, N in [(1, 4), (70, 44), (2048, 1024), (2048, 512),
                     (4097, 1028), (33, 4096), (16, 8), (17, 16),
                     (50000, 64), (2048, 2048)]:
            k19_case("random", randn(M, N) / 8, randn(M, N) * 2)
        dy, pre = randn(300, 256), randn(300, 256) * 30
        pre[::3] = 0.0
        dy[::5] = 0.0
        k19_case("zeros, large |pre|", dy, pre)

    def library_ms(tag, fn):
        print(tag, "library device ms:",
              chip_smoke.device_ms(fn, flush), flush=True)

    if "recon_ce" in only:
        for tag, args in ([("autoencoder step (lse)", step_k11[0])]
                          if step_k11 else []) + [
                ("served T 256", served(256)),
                ("served T 2048", served(2048))]:
            outs = [k11_outs(args, False, tag.endswith("(lse)"))
                    for _ in range(2)]
            a = args[:-1] + (None,)
            timed(f"K11 f32 {tag} {tuple(args[0].shape)} real "
                  f"{int(args[6].sum())}",
                  k11_call(old["recon_ce"], a, outs[0]),
                  k11_call(new["recon_ce"], a, outs[1]))
            dec, lw, lb, heads, cat, cont, mask, wts, eps, _ = args
            real = torch.nonzero(mask).flatten()
            labels = cat[real].long()

            def lib_sum(dec=dec, lw=lw, lb=lb, heads=heads, real=real,
                        labels=labels, cont=cont, wts=wts):
                y = F.layer_norm(dec[real], (dec.shape[1],), lw, lb, 1e-6)
                zs = [F.linear(y, w, b) for w, b in heads]
                e = sum(float(wts[h]) * F.cross_entropy(
                    zs[h], labels[:, h], reduction="none")
                    for h in range(3))
                return e + float(wts[3]) * (zs[3][:, 0]
                                            - cont[real, 0]) ** 2
            library_ms(f"K11 f32 {tag} (F.layer_norm + 4 F.linear + 3 "
                       f"F.cross_entropy + MSE)", lib_sum)
    if "recon_ce" in only:
        for T in (256, 2048):
            a = served(T)
            args = (a[0].to(torch.bfloat16),) + a[1:]
            outs = [k11_outs(args, False, False) for _ in range(2)]
            timed(f"K11 tc served T {T} {tuple(args[0].shape)} real "
                  f"{int(args[6].sum())}",
                  k11_tc_call(old["recon_ce"], args, outs[0]),
                  k11_tc_call(new["recon_ce"], args, outs[1]))
    if "gelu_bwd" in only:
        for model, (dy, pre) in steps_k19.items():
            outs = [(torch.empty_like(dy), torch.empty(dy.shape[1],
                                                        device=dev))
                    for _ in range(2)]
            timed(f"K19 {model} step {tuple(dy.shape)}",
                  k19_call(old["gelu_bwd"], dy, pre, outs[0]),
                  k19_call(new["gelu_bwd"], dy, pre, outs[1]))
            pt = pre.detach().clone().requires_grad_()
            yt = F.gelu(pt, approximate="tanh")
            library_ms(f"K19 {model} step (F.gelu tanh backward)",
                       lambda yt=yt, pt=pt, dy=dy: torch.autograd.grad(
                           yt, pt, dy, retain_graph=True))
    return fails, cases


def _k20_k21_checks(old, new, only, dev, rng, randn, same_bits, stream,
                    flush, timed) -> tuple[int, int]:
    """K21 and K20, old build against new: (failures, cases)."""
    import torch
    import torch.nn.functional as F

    import chip_smoke
    from odigos_tpu_torch.kernels import recon
    from odigos_tpu_torch.kernels.quant import layer_norm_plain

    import numpy as np

    fails = cases = 0
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    calls = _trainer_bwd_inputs(dev, (("recon", "recon_ce_bwd"),
                                      ("pool", "ln_masked_pool_bwd")),
                                kwargs=True)

    # ------------------------------------------------------------- K21
    def k21_call(lib, args, out):
        """A launch of ``lib``'s K21 on (x, w, mask, dpool, eps) into
        ``out`` (dx, dgamma, dbeta), its scratch made once as the wrapper
        keeps it; the parent's partials as its wrapper made them."""
        fn, size = lib
        x, w, mask, dpool, eps = args
        T, L, d = x.shape
        head = [x.data_ptr(), w.data_ptr(), mask.data_ptr(),
                dpool.data_ptr(), eps, T, L, d] + [t.data_ptr()
                                                   for t in out]
        launched = None
        if isinstance(size, tuple):
            cnt = torch.zeros(max(size[0](T), 1), dtype=torch.int32,
                              device=dev)
            part = (cnt, torch.empty(max(size[1](T, d), 1),
                                     dtype=torch.float64, device=dev))
            launched = ctypes.c_int(0)
            tail = [cnt.data_ptr(), part[1].data_ptr(), sms,
                    ctypes.byref(launched)]
        else:
            part = torch.empty(size(T) * 2 * d, dtype=torch.float64,
                               device=dev)
            tail = [part.data_ptr()]

        def run(_keep=part):  # the scratch lives as long as the launch
            if launched is None:
                out[1].zero_()  # the parent's wrapper zero-fills both
                out[2].zero_()
            rc = fn(*head, *tail, stream())
            if rc != 0 or (launched is not None and launched.value != 1):
                raise RuntimeError(f"K21 launch failed: {rc}")
        return run

    def k21_outs(x):
        d = x.shape[-1]
        return (torch.empty_like(x), torch.empty(d, device=dev),
                torch.empty(d, device=dev))

    def k21_case(tag, args):
        nonlocal cases, fails
        got = []
        for lib in (old["ae_pool_bwd"], new["ae_pool_bwd"]):
            out = k21_outs(args[0])
            run = k21_call(lib, args, out)
            run()
            if lib is new["ae_pool_bwd"]:
                torch.cuda.synchronize()
                first = [t.clone() for t in out]
                run()  # a second call on the same scratch
            torch.cuda.synchronize()
            got.append(out)
        same = all(same_bits(a, b) for a, b in zip(*got))
        again = all(same_bits(a, b) for a, b in zip(first, got[1]))
        ok = same and again
        cases, fails = cases + 1, fails + (not ok)
        print("K21", tag, tuple(args[0].shape), "real",
              int(args[2].sum()),
              "bit-equal to old (dx, dgamma, dbeta), a second call "
              "bit-equal" if ok else
              f"DIFFERS: FAILED (old {same} again {again})", flush=True)

    def k21_random(T, L, d, density, empty_every=0):
        x = randn(T, L, d) * 2 + 0.5
        mask = torch.from_numpy(rng.random((T, L)) < density).to(dev)
        if empty_every:
            mask[::empty_every] = False  # traces with no real position
        return (x, 1 + randn(d) / 4, mask, randn(T, d), 1e-6)

    k21_step = []
    if "ae_pool_bwd" in only:
        for model, args, kw in calls.get("ln_masked_pool_bwd", []):
            a = tuple(args[:4]) + (args[4] if len(args) > 4
                                   else kw.get("eps", 1e-6),)
            k21_step.append(a)
            k21_case(f"{model} step input", a)
        for d in (1, 4, 33, 96, 128, 256, 512, 1000, 1024):
            for T, L, density, empty in ((1, 1, 1.0, 0), (64, 32, 0.3, 7),
                                         (300, 17, 0.5, 3),
                                         (5, 1024, 0.3, 0),
                                         (16, 64, 0.9, 5)):
                if d >= 512 and L == 1024 and T > 2:
                    T = 2
                k21_case(f"random density {density}",
                         k21_random(T, L, d, density, empty))
        k21_case("all padding", k21_random(40, 32, 128, 0.0))

    # ------------------------------------------------------------- K20
    def k20_call(lib, args, out):
        """A launch of ``lib``'s K20 on recon_ce_bwd's ``args`` into
        ``out`` (dy, dW, db): the new build's scratch made once, as the
        wrapper keeps it; the parent's as its wrapper made it, dy
        zero-filled before each launch (its wrapper's torch.zeros)."""
        fn, size, slices, sliced = lib
        dec, lw, lb, heads, lse, cat, cont, mask, derr, wts, eps = args
        dy, dw, db = out
        M, d = dec.shape
        vs = [w.shape[0] for w, _ in heads]
        head = ([dec.data_ptr(), M, d, lw.data_ptr(), lb.data_ptr(), eps]
                + [w.data_ptr() for w, _ in heads]
                + [b.data_ptr() for _, b in heads] + vs
                + [lse.data_ptr(), cat.data_ptr(), cat.shape[1],
                   cont.data_ptr(), cont.shape[1], mask.data_ptr(),
                   derr.data_ptr()] + [float(w) for w in wts]
                + ([vs[0], 0, vs[1], 0, 15] if sliced else []))
        launched = None
        if size is not None:
            cnt = torch.zeros(max(size[0](M, *vs), 1), dtype=torch.int32,
                              device=dev)
            data = torch.empty(max(size[1](M, d, *vs), 16),
                               dtype=torch.uint8, device=dev)
            launched = ctypes.c_int(0)
            keep = (cnt, data)
            tail = [cnt.data_ptr(), data.data_ptr(), dy.data_ptr(),
                    dw.data_ptr(), db.data_ptr(), sms,
                    ctypes.byref(launched)]
        else:
            S = slices(*vs)
            lst = torch.empty(M + 1, dtype=torch.int32, device=dev)
            dl = torch.empty((M, sum(vs)), device=dev)
            ybuf = torch.empty((M, d), device=dev)
            part = torch.empty((S, M, d), device=dev)
            keep = (lst, dl, ybuf, part)
            tail = [lst.data_ptr(), lst.data_ptr() + 4 * M, dl.data_ptr(),
                    ybuf.data_ptr(), part.data_ptr(), dy.data_ptr(),
                    dw.data_ptr(), db.data_ptr()]

        def run(_keep=keep):  # the scratch lives as long as the launch
            if launched is None:
                dy.zero_()
            rc = fn(*head, *tail, stream())
            if rc != 0 or (launched is not None and launched.value != 2):
                raise RuntimeError(f"K20 launch failed: {rc}")
        return run

    def k20_outs(args):
        M, d = args[0].shape
        V = sum(w.shape[0] for w, _ in args[3])
        return (torch.empty((M, d), device=dev),
                torch.empty((V, d), device=dev), torch.empty(V, device=dev))

    def k20_case(tag, args):
        nonlocal cases, fails
        got = []
        for lib in (old["recon_ce_bwd"], new["recon_ce_bwd"]):
            out = k20_outs(args)
            if lib is new["recon_ce_bwd"]:
                for t in out:
                    t.fill_(float("nan"))  # every value must be written
            run = k20_call(lib, args, out)
            run()
            if lib is new["recon_ce_bwd"]:
                torch.cuda.synchronize()
                first = [t.clone() for t in out]
                run()  # a second call on the same scratch
            torch.cuda.synchronize()
            got.append(out)
        same = all(same_bits(a, b) for a, b in zip(*got))
        again = all(same_bits(a, b) for a, b in zip(first, got[1]))
        ok = same and again
        cases, fails = cases + 1, fails + (not ok)
        print("K20", tag, tuple(args[0].shape), "vocab",
              [w.shape[0] for w, _ in args[3]], "real", int(args[7].sum()),
              "bit-equal to old (dy, dW, db), a second call bit-equal"
              if ok else f"DIFFERS: FAILED (old {same} again {again})",
              flush=True)

    def k20_random(M, d, vocabs, density, bad=False):
        dec = randn(M, d) * 2 + 0.5
        mask = torch.from_numpy(rng.random(M) < density).to(dev)
        cat = torch.from_numpy(np.stack(
            [rng.integers(0, V, M) for V in vocabs[:3]]
            + [np.zeros(M, np.int64)] * 2, 1).astype(np.int32)).to(dev)
        cont = torch.from_numpy((rng.random((M, 3)) * 4).astype(
            np.float32)).to(dev)
        heads = [(randn(V, d) / d ** 0.5, randn(V) / 4) for V in vocabs]
        lw, lb, wts = 1 + randn(d) / 4, randn(d) / 4, (1.0, 0.7, 0.5, 0.3)
        lse = torch.empty(M, 3, device=dev)
        recon.recon_ce(dec, lw, lb, heads, cat, cont, mask, wts,
                       route="cuda_core", lse=lse)
        if bad:  # labels the reference wraps or drops (fault C5)
            for h in range(3):
                V = vocabs[h]
                cat[h::11, h] = torch.tensor(
                    [-1, -V, V, V + 7], dtype=torch.int32,
                    device=dev).repeat(M)[:cat[h::11].shape[0]]
        derr = torch.from_numpy((rng.random(M) + 0.5).astype(
            np.float32)).to(dev)
        return (dec, lw, lb, heads, lse, cat, cont, mask, derr, wts, 1e-6)

    k20_step = []
    if "recon_ce_bwd" in only:
        for model, args, kw in calls.get("recon_ce_bwd", []):
            a = tuple(args[:10]) + (args[10] if len(args) > 10
                                    else kw.get("eps", 1e-6),)
            k20_step.append(a)
            k20_case(f"{model} step input", a)
        for M, d, vocabs, density in [
                (2048, 128, (512, 2048, 8, 1), 0.3),   # the card tests'
                (2048, 512, (512, 2048, 8, 1), 0.3),
                (700, 1024, (512, 2048, 8, 1), 0.6),
                (64, 96, (512, 2048, 8, 1), 0.0),
                (1, 128, (512, 2048, 8, 1), 1.0),      # 1 real position
                (2048, 128, (512, 2048, 8, 1), 1.0),   # 2048
                (3000, 4, (7, 33, 3, 1), 0.5),
                (2000, 12, (100, 300, 8, 1), 0.6),
                (1500, 100, (513, 17, 16, 1), 0.4),
                (1024, 256, (100, 300, 8, 1), 0.9),
                (900, 388, (512, 2048, 8, 1), 0.3),
                (600, 1000, (512, 200, 8, 1), 0.5),
                (20000, 128, (512, 2048, 8, 1), 0.16)]:
            k20_case(f"random density {density}",
                     k20_random(M, d, vocabs, density))
        for d in (128, 512):
            k20_case("labels -1, -V, V, V + 7",
                     k20_random(2048, d, (512, 2048, 8, 1), 0.3, bad=True))

    def library_ms(tag, fn):
        print(tag, "library device ms:",
              chip_smoke.device_ms(fn, flush), flush=True)

    if k21_step:
        x, w, mask, dpool, eps = k21_step[0]
        outs = [k21_outs(x) for _ in range(2)]
        timed(f"K21 autoencoder step {tuple(x.shape)} real "
              f"{int(mask.sum())}",
              k21_call(old["ae_pool_bwd"], k21_step[0], outs[0]),
              k21_call(new["ae_pool_bwd"], k21_step[0], outs[1]))
        T, L, d = x.shape
        xr = x.detach().clone().requires_grad_()
        wr = w.detach().clone().requires_grad_()
        br = torch.zeros_like(wr).requires_grad_()
        pooled = (F.layer_norm(xr, (d,), wr, br, eps) * mask[..., None]
                  ).sum(1) / mask.sum(-1, keepdim=True).clamp(min=1).float()
        library_ms("K21 autoencoder step (autograd.grad of F.layer_norm + "
                   "the masked mean)",
                   lambda: torch.autograd.grad(pooled, (xr, wr, br), dpool,
                                               retain_graph=True))
    if k20_step:
        a = k20_step[0]
        outs = [k20_outs(a) for _ in range(2)]
        timed(f"K20 autoencoder step {tuple(a[0].shape)} real "
              f"{int(a[7].sum())}",
              k20_call(old["recon_ce_bwd"], a, outs[0]),
              k20_call(new["recon_ce_bwd"], a, outs[1]))
        dec, lw, lb, heads, lse, cat, cont, mask, derr, wts, eps = a
        real = torch.nonzero(mask).flatten()
        y = layer_norm_plain(dec[real], lw, lb, eps).detach() \
            .requires_grad_()
        params = [t.detach().clone().requires_grad_()
                  for pair in heads for t in pair]
        zs = [F.linear(y, params[2 * h], params[2 * h + 1])
              for h in range(4)]
        labels = cat[real].long()
        e = sum(float(wts[h]) * F.cross_entropy(zs[h], labels[:, h],
                                                reduction="none")
                for h in range(3))
        e = e + float(wts[3]) * (zs[3][:, 0] - cont[real, 0]) ** 2
        loss = (e * derr[real]).sum()
        library_ms("K20 autoencoder step (autograd.grad of 4 F.linear + 3 "
                   "F.cross_entropy + MSE from dec_ln's output)",
                   lambda: torch.autograd.grad(loss, [y] + params,
                                               retain_graph=True))
    return fails, cases


def _k15_checks(old, new, dev, randn, same_bits, stream,
                timed) -> tuple[int, int]:
    """K15's f32 route, old build against new: (failures, cases)."""
    import torch

    from odigos_tpu_torch.kernels import dense

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch_f32_forward_times as f32t

    tile_rows = None
    if new["gemm_f32"][1]:
        def tile_rows(M, N):
            return dense.f32_tile(M, N)[0]

    def call(lib, x, w, b, res, out, epi, planes, live, per, pre):
        fn, own = lib
        M, K = x.shape
        N = w.shape[0]
        mode = dense.EPILOGUES[epi]
        head = (x.data_ptr(), w.data_ptr(), b.data_ptr(),
                None if res is None else res.data_ptr(), out.data_ptr())
        tail = (M, N, K, planes, None if live is None else live.data_ptr(),
                per, None if pre is None else pre.data_ptr())
        args = head + ((mode,) if own else (0, mode)) + tail

        def run():
            rc = fn(*args, stream())
            if rc != 0:
                raise RuntimeError(f"K15 f32 launch failed: {rc}")
        return run

    def outputs(x, w, planes, with_pre):
        M, N = x.shape[0], w.shape[0]
        shape = (M, N) if planes == 1 else (planes, M, N // planes)
        out = torch.full(shape, float("nan"), device=dev)
        pre = torch.full((M, N), float("nan"), device=dev) \
            if with_pre else None
        return out, pre

    fails = cases = 0

    def case(tag, x, w, b, res, epi, planes, pre_on, live=None, per=1):
        nonlocal fails, cases
        got = []
        for lib in (old["gemm_f32"], new["gemm_f32"], new["gemm_f32"]):
            out, pre = outputs(x, w, planes, pre_on)
            call(lib, x, w, b, res, out, epi, planes, live, per, pre)()
            torch.cuda.synchronize()
            got.append((out, pre))
        M, N = x.shape[0], w.shape[0]
        rows = M if live is None else min(M, int(live.item()) * per)

        def real(t, p=planes):
            return t[:rows] if p == 1 else t[:, :rows]

        ok = all(same_bits(real(a[0]), real(b_[0]))
                 and (a[1] is None or same_bits(real(a[1], 1),
                                                real(b_[1], 1)))
                 for a, b_ in ((got[0], got[1]), (got[1], got[2])))
        untouched = True
        if live is not None and tile_rows is not None:
            bm = tile_rows(M, N)
            past = -(-rows // bm) * bm
            out, pre = got[1]
            tail = out[past:] if planes == 1 else out[:, past:]
            untouched = bool(torch.isnan(tail).all()) and (
                pre is None or bool(torch.isnan(pre[past:]).all()))
        finite = bool(torch.isfinite(real(got[1][0])).all())
        ok = ok and untouched and finite
        cases, fails = cases + 1, fails + (not ok)
        print("K15 f32", tag, (M, N, x.shape[1]), epi, "planes", planes,
              "pre" if pre_on else "", "rows", rows,
              "bit-equal to old, a second call bit-equal" if ok
              else "DIFFERS: FAILED",
              "" if untouched else "ROWS PAST THE COUNT WRITTEN", flush=True)

    steps = f32t._steps(dev)
    seen = {}
    for tag, calls in steps.items():
        for name, a, k in calls:
            if name != "gemm_bf16":
                continue
            x, w, b, epi, res, planes = a[:6]
            key = (tag, tuple(x.shape), tuple(w.shape), epi, planes)
            case(f"{tag} step", x, w, b, res, epi, planes,
                 k.get("pre") is not None)
            seen.setdefault(key, (x, w, b, res, epi, planes,
                                  k.get("pre") is not None))
    for M, N, K, epi, planes, pre_on, live, per in [
            (70, 40, 48, "none", 1, False, None, 1),
            (70, 40, 48, "gelu_tanh", 1, True, None, 1),
            (1, 8, 16, "none", 1, False, None, 1),
            (333, 128, 512, "residual", 1, False, None, 1),
            (100, 520, 128, "gelu_tanh_formula", 1, False, None, 1),
            (131, 264, 1040, "residual", 1, False, None, 1),
            (5000, 192, 16, "none", 3, False, None, 1),
            (2048, 768, 256, "none", 3, False, None, 1),
            (4096, 256, 256, "residual", 1, False, 1000, 1),
            (2048, 1024, 256, "gelu_tanh", 1, True, 100, 7),
            (2048, 128, 128, "none", 1, False, 45, 1)]:
        x, w = randn(M, K), randn(N, K) / K ** 0.5
        b = randn(N)
        res = randn(M, N) if epi == "residual" else None
        lv = None if live is None else torch.tensor(
            [live], dtype=torch.int32, device=dev)
        case("random", x, w, b, res, epi, planes, pre_on, lv, per)
    for (tag, *_), (x, w, b, res, epi, planes, pre_on) in seen.items():
        outs = [outputs(x, w, planes, pre_on) for _ in range(2)]
        timed(f"K15 f32 {tag} {(x.shape[0], w.shape[0], x.shape[1])} "
              f"{epi} planes {planes}",
              call(old["gemm_f32"], x, w, b, res, outs[0][0], epi, planes,
                   None, 1, outs[0][1]),
              call(new["gemm_f32"], x, w, b, res, outs[1][0], epi, planes,
                   None, 1, outs[1][1]))
    return fails, cases


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", required=True, type=Path)
    ap.add_argument("--only", default=",".join(SOURCES),
                    help="comma-separated sources to check (default: all)")
    args = ap.parse_args()
    only = [n for n in args.only.split(",") if n]
    unknown = [n for n in only if n not in SOURCES]
    if unknown:
        ap.error(f"unknown sources {unknown} (known: {list(SOURCES)})")

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
        old, new = _builds(args.old.resolve(), Path(tmp), only)
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
                    (0, (3, 40, 2, 24)), (0, (64, 32, 4, 64)),
                    (0, (64, 32, 2, 64)), (0, (256, 64, 4, 64)),
                    (0, (2, 1, 1, 4)), (0, (3, 33, 2, 30)),
                    (0, (5, 17, 3, 60)), (0, (2, 64, 1, 8)),
                    (0, (7, 48, 2, 40)), (0, (4, 31, 2, 64))]
        for route, shape in (k1_cases if "segment_attention" in only
                             else []):
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

        def k1_old_new(tag, q, k, v, seg, route=0):
            nonlocal cases, fails
            R, L, H, _ = q.shape
            got = []
            for fn in (old["segment_attention"], new["segment_attention"],
                       new["segment_attention"]):
                out = torch.empty_like(q)
                lse = torch.empty((R, H, L), device=dev)
                rc = k1_call(fn, q, k, v, seg, out, lse, route)()
                torch.cuda.synchronize()
                if rc != 0:
                    raise RuntimeError(f"K1 launch failed: {rc}")
                got.append((out, lse))
            ok = all(same_bits(a, b) for a, b in zip(*got[:2])) and all(
                same_bits(a, b) for a, b in zip(*got[1:]))
            cases, fails = cases + 1, fails + (not ok)
            print("K1 route", route, tag, tuple(q.shape), q.dtype,
                  "bit-equal to old, a second call bit-equal" if ok
                  else "DIFFERS", flush=True)

        k1_steps = []
        if "segment_attention" in only:
            # 16-byte misaligned tensors (the one-value staging)
            for dt in (torch.float32, torch.bfloat16):
                R, L, H, hd = 6, 32, 2, 64
                n = R * L * H * hd
                q, k, v = (randn(n + 1, dtype=dt)[1:].view(R, L, H, hd)
                           for _ in range(3))
                k1_old_new("misaligned", q, k, v, segments(R, L))
            for i, (model, args) in enumerate(
                    _trainer_bwd_inputs(dev)["segment_attention_bwd"]):
                q, k, v, seg = args[:4]
                k1_old_new(f"{model} step input {i}", q, k, v, seg)
                if i == 0 or model != k1_steps[-1][0]:
                    k1_steps.append((model, (q, k, v, seg)))

        def fresh_state(B, Lq, H, D):
            return (torch.zeros((B, Lq, H, D), device=dev),
                    torch.full((B, H, Lq), NEG_INF, device=dev),
                    torch.zeros((B, H, Lq), device=dev))

        for B, Lq, Lk, H, D in [] if "ring_attention" not in only else [
                (2, 70, 130, 3, 4), (2, 70, 130, 3, 8), (2, 64, 100, 2, 16),
                (2, 100, 64, 4, 64), (2, 33, 257, 2, 100),
                (2, 70, 130, 3, 128), (1, 65, 129, 2, 256),
                (2, 4096, 4096, 4, 64)]:
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

        for d in K17_D if "ln_bwd" in only else ():
            for rows in K17_ROWS:
                x = randn(rows, d) * 3 + 1
                dy = randn(rows, d)
                if rows > 1:
                    x[-1] = 0.0  # a padding row
                    dy[-1] = 0.0
                k17_case("sweep", x, randn(d), dy)
        for i, (x, w, dy) in enumerate(_trainer_ln_inputs(dev)
                                       if "ln_bwd" in only else []):
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

        def k1_pair(R, L, H, hd, route=3):
            q, k, v = (randn(R, L, H, hd) for _ in range(3))
            seg, out = segments(R, L), torch.empty_like(q)
            lse = torch.empty((R, H, L), device=dev)
            return [k1_call(lib["segment_attention"], q, k, v, seg, out, lse,
                            route) for lib in (old, new)]

        def k17_pair(rows, d):
            x, w, dy = randn(rows, d) * 3 + 1, randn(d), randn(rows, d)
            return [k17_call(lib["ln_bwd"], x, w, dy, k17_outs(x),
                             k17_part(lib["ln_bwd"], rows, d))
                    for lib in (old, new)]

        if "ring_attention" in only:
            timed("K22 one block (2, 8192, 4, 64)",
                  *k22_pair(2, 8192, 8192, 4, 64))
            timed("K22 ring step (2, 4096, 4, 64) x 4096",
                  *k22_pair(2, 4096, 4096, 4, 64))
            timed("K22 8-block ring L 32768 (64 launches)",
                  *k22_ring(8, 4096), reps=3)
            timed("K22 D 256 (2, 4096, 2, 256)",
                  *k22_pair(2, 4096, 4096, 2, 256))
        if "segment_attention" in only:
            for model, (q, k, v, seg) in k1_steps:
                R, L, H, _ = q.shape
                lse = torch.empty((R, H, L), device=dev)
                outs = [torch.empty_like(q) for _ in range(2)]
                timed(f"K1 route 0 f32 {model} step {tuple(q.shape)}",
                      *[k1_call(lib["segment_attention"], q, k, v, seg, o,
                                lse, 0) for lib, o in zip((old, new),
                                                          outs)])
            timed("K1 route 0 f32 (256, 64, 4, 64)",
                  *k1_pair(256, 64, 4, 64, route=0))
            timed("K1 tiled f32 (256, 1024, 4, 64)",
                  *k1_pair(256, 1024, 4, 64))
        if "gemm_f32" in only:
            n, c = _k15_checks(old, new, dev, randn, same_bits, stream,
                               timed)
            fails, cases = fails + n, cases + c
        if "ln_bwd" in only:
            timed("K17 (2048, 256)", *k17_pair(2048, 256))
            timed("K17 (2048, 128)", *k17_pair(2048, 128))
        if "recon_ce" in only or "gelu_bwd" in only:
            n, c = _k11_k19_checks(old, new, only, dev, rng, randn,
                                   same_bits, stream, flush, timed)
            fails, cases = fails + n, cases + c
        if "ae_pool_bwd" in only or "recon_ce_bwd" in only:
            n, c = _k20_k21_checks(old, new, only, dev, rng, randn,
                                   same_bits, stream, flush, timed)
            fails, cases = fails + n, cases + c
        if "segment_attention_bwd" in only or "span_embed_bwd" in only:
            n, c = _k16_k18_checks(old, new, only, dev, rng, randn,
                                   segments, same_bits, stream, flush,
                                   timed)
            fails, cases = fails + n, cases + c
    print("BITCHECK", "OK" if fails == 0 else f"FAILED {fails}", "cases",
          cases)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""The trainers' f32 forward routes, each timed at the shapes a step
gives it, beside its bound, its launches a step and one PyTorch call.

    python3 tools/torch_f32_forward_times.py [--label X] [--reps N]

One training step of the transformer and one of the autoencoder (the
smoke run's steps: the reference's seed-0 weights, 63 traces padded to
64 rows, ``max_len`` 32, f32) run on the card with the forward kernels'
wrappers recording every call: K1 ``segment_attention`` (the CUDA-core
route with its log-sum-exp), K2 ``span_embed``, K11 ``recon_ce`` (its f32
CUDA-core kernel with its log-sum-exps), K12 ``ln_masked_pool``, K14
``ln_bf16`` and K15 ``gemm_bf16`` (the f32 route; FFN1 also writes its
pre-activation). Each distinct call (kernel, shapes, epilogue) is then
run again alone on its recorded arguments and timed with
``chip_smoke.device_ms`` (median of ``--reps``, L2 flushed, the host's
enqueue kept out), beside

* its bound: the larger of the bytes it must move (each input read once,
  each output written once) over 3.35 TB/s and its operations over the
  67 TFLOP/s f32 peak;
* its launches a step: the recorded calls with the same key;
* one PyTorch call for the same function where there is one: K15 f32
  ``F.linear`` (TF32 off, no GELU or residual), K1 f32
  ``scaled_dot_product_attention`` under the same boolean mask, K14
  ``F.layer_norm``, K2 ``F.embedding_bag`` over the stacked tables, K11
  the sum of four ``F.linear`` + three ``F.cross_entropy`` + the squared
  error (no one call); K12 none.

Then K1 at R 256 (packed rows of L 64, 4 heads of 64, f32, random q, k, v
from a seed), the shape of PERF.md's older f32 row. The script uses only
the wrappers' public calls and ``chip_smoke``'s timers, so a copy in
another checkout's ``tools/`` times that checkout's kernels (an A/B runs
parent, change, change, parent in one call). Prints the card's name and
power limit, one JSON line a row, and a last line ``F32 ROWS n``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (module, wrapper) recorded in a step; K11 only on its CUDA-core route
WRAPPED = (("attention", "segment_attention"), ("embed", "span_embed"),
           ("dense", "ln_bf16"), ("dense", "gemm_bf16"),
           ("pool", "ln_masked_pool"), ("recon", "recon_ce"))


def _record(step) -> list:
    """Every call of the forward wrappers in ``step()``: ``(wrapper,
    args, kwargs)`` with the tensors cloned."""
    import torch

    from odigos_tpu_torch import kernels

    seen, saved = [], []
    for mod, name in WRAPPED:
        m = getattr(kernels, mod)
        real = getattr(m, name)
        saved.append((m, name, real))

        def rec(*a, _real=real, _name=name, **k):
            clone = [t.detach().clone() if isinstance(t, torch.Tensor)
                     else [tuple(x.detach().clone() for x in p)
                           for p in t] if _name == "recon_ce"
                     and isinstance(t, list) else t for t in a]
            kw = {key: (v.detach().clone() if isinstance(v, torch.Tensor)
                        else v) for key, v in k.items()}
            out = _real(*a, **k)
            seen.append((_name, clone, kw))
            return out

        setattr(m, name, rec)
    try:
        step()
    finally:
        for m, name, real in saved:
            setattr(m, name, real)
    return seen


def _steps(dev) -> dict:
    """Each trainer's recorded forward calls of one step."""
    import torch

    import chip_smoke
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
    out = {}
    for tag, model, loss in (
            ("transformer", tmodel, lambda: tmodel.loss_fn(
                tdata.categorical, tdata.continuous, tdata.mask,
                tdata.span_labels, tdata.trace_labels)),
            ("autoencoder", amodel, lambda: amodel.loss_fn(
                adata.categorical, adata.continuous, adata.mask))):
        model.module.train()
        out[tag] = _record(lambda: loss().backward())
        model.module.eval()
        model.module.zero_grad(set_to_none=True)
    return out


def _key(name: str, a: list, k: dict) -> tuple:
    """The calls a step repeats at the same shapes and options."""
    import torch

    shapes = tuple(tuple(t.shape) for t in a if isinstance(t, torch.Tensor))
    if name == "ln_bf16":  # (rows, d) whatever the leading dimensions
        shapes = ((a[0].numel() // a[0].shape[-1], a[0].shape[-1]),)
    opts = tuple(x for x in a if isinstance(x, (str, int, float)))
    return (name, shapes, opts, tuple(sorted(
        (kk, tuple(v.shape) if isinstance(v, torch.Tensor) else v)
        for kk, v in k.items())))


def _allowed(seg):
    segl = seg.long()
    return ((segl[:, :, None] == segl[:, None, :])
            & (segl[:, :, None] > 0))[:, None]


def _row(name, a, k, launches, flush, reps) -> dict:
    """One recorded call timed beside its bound and library call."""
    import torch
    import torch.nn.functional as F

    import chip_smoke
    from odigos_tpu_torch import kernels

    fn = getattr(getattr(kernels, dict(
        (n, m) for m, n in WRAPPED)[name]), name)
    call = (lambda: fn(*a, **k))
    lib, lib_name = None, None
    F32 = chip_smoke.F32_FLOPS
    if name == "gemm_bf16":
        x, w, b = a[:3]
        epi = a[3] if len(a) > 3 else k.get("epilogue", "none")
        res = a[4] if len(a) > 4 else k.get("residual")
        planes = a[5] if len(a) > 5 else k.get("planes", 1)
        pre = k.get("pre")
        M, K = x.shape
        N = w.shape[0]
        nbytes = 4 * (M * K + N * K + N + M * N * (
            1 + (res is not None) + (pre is not None)))
        b_ms, b_by = chip_smoke.bound(nbytes, 2 * M * N * K, F32)
        shape = {"M": M, "N": N, "K": K, "epilogue": epi, "planes": planes,
                 "pre": pre is not None}

        def lib():
            return F.linear(x, w, b)
        lib_name = "F.linear f32, TF32 off (no GELU or residual)"
    elif name == "segment_attention":
        q, kk, v, seg = a[:4]
        lse = a[4] if len(a) > 4 else k.get("lse")
        R, L, H, hd = q.shape
        allowed = _allowed(seg)
        pairs = int(allowed.sum().item())
        nbytes = 4 * (4 * R * L * H * hd + R * L
                      + (R * H * L if lse is not None else 0))
        b_ms, b_by = chip_smoke.bound(nbytes, 4 * pairs * H * hd, F32)
        shape = {"R": R, "L": L, "H": H, "hd": hd, "lse": lse is not None,
                 "route": kernels.attention.kernel_route(q, kk, v, seg),
                 "allowed_pairs": pairs}
        qt, kt, vt = (t.transpose(1, 2) for t in (q, kk, v))

        def lib():
            return F.scaled_dot_product_attention(qt, kt, vt,
                                                  attn_mask=allowed)
        lib_name = "f32 scaled_dot_product_attention, same boolean mask"
    elif name == "ln_bf16":
        x, w, b = a[:3]
        d = x.shape[-1]
        M = x.numel() // d
        nbytes = 4 * (2 * M * d + 2 * d)
        b_ms, b_by = chip_smoke.bound(nbytes, 8 * M * d, F32)
        shape = {"M": M, "d": d}
        eps = a[3] if len(a) > 3 else k.get("eps", 1e-6)

        def lib():
            return F.layer_norm(x, (d,), w, b, eps)
        lib_name = "F.layer_norm f32"
    elif name == "span_embed":
        cat, cont, pos, seg, tables = a[:5]
        R, L, C = cat.shape
        d = tables.service.shape[1]
        ids, wts, stacked = chip_smoke._embedding_bag_args(
            cat, cont, pos, seg, tables)
        rows = int(torch.unique(ids[seg.reshape(-1) > 0]).numel())
        nbytes = (R * L * d * 4 + R * L * C * 4 + R * L * 3 * 4
                  + 2 * R * L * 4 + rows * d * 4)
        b_ms, b_by = chip_smoke.bound(nbytes, R * L * d * (12 + (C - 5)),
                                      F32)
        shape = {"R": R, "L": L, "C": C, "d": d, "table_rows": rows}

        def lib():
            return F.embedding_bag(ids, stacked, per_sample_weights=wts,
                                   mode="sum")
        lib_name = "F.embedding_bag over the stacked tables"
    elif name == "ln_masked_pool":
        x, w, b, mask = a[:4]
        T, L, d = x.shape
        real = int(mask.sum().item())
        nbytes = real * d * 4 + T * L + T * d * 4 + 2 * d * 4
        b_ms, b_by = chip_smoke.bound(nbytes, 12 * d * real, F32)
        shape = {"T": T, "L": L, "d": d, "real_positions": real}
    elif name == "recon_ce":
        dec, lw, lb, heads, cat, cont, mask, weights = a[:8]
        M, d = dec.shape
        real = int(mask.sum().item())
        V = sum(w.shape[0] for w, _ in heads)
        b_ms, b_by, nbytes = chip_smoke._k11_bound(real, M, d, V, 0,
                                                   "cuda_core", 4)
        shape = {"M": M, "d": d, "real_positions": real, "V": V,
                 "lse": k.get("lse") is not None}
        idx = torch.nonzero(mask).flatten()
        lab = cat[idx].long()
        c0 = cont[idx, 0]
        eps = k.get("eps", 1e-6)

        def lib():
            y = F.layer_norm(dec[idx], (d,), lw, lb, eps)
            lo = [F.linear(y, w, bb) for w, bb in heads]
            e = sum(weights[h] * F.cross_entropy(lo[h], lab[:, h],
                                                 reduction="none")
                    for h in range(3))
            return e + weights[3] * (lo[3][:, 0] - c0) ** 2
        lib_name = ("F.layer_norm + 4 f32 F.linear + 3 F.cross_entropy + "
                    "squared error on the real rows, summed (no one call)")
    else:
        raise ValueError(name)
    ms = chip_smoke.device_ms(call, flush, reps=reps)
    lib_ms = None if lib is None else chip_smoke.device_ms(lib, flush,
                                                           reps=reps)
    return {"name": name, **shape, "device_ms": ms, "bound_ms": b_ms,
            "bound_by": b_by, "bytes": nbytes,
            "launches_per_step": launches, "library": lib_name,
            "library_device_ms": lib_ms,
            "loss_per_step_ms": launches * (ms - b_ms)}


def rows(dev, flush, reps: int = 20) -> list:
    """Every distinct forward call of both trainers' steps, timed, then K1
    at R 256 (module docstring)."""
    import numpy as np
    import torch

    import chip_smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = []
    for tag, calls in _steps(dev).items():
        groups: dict = {}
        for name, a, k in calls:
            if name == "recon_ce" and k.get("route") != "cuda_core":
                continue
            groups.setdefault(_key(name, a, k), []).append((name, a, k))
        for key, same in groups.items():
            name, a, k = same[0]
            out.append({"trainer": tag, **_row(name, a, k, len(same), flush,
                                               reps)})
            print(json.dumps(out[-1]), flush=True)
    # K1 at R 256 on packed rows of real traffic, random q, k, v (f32)
    pk = chip_smoke._packed_rows(256)
    seg = torch.from_numpy(pk.segments[:256]).to(dev).contiguous()
    rng = np.random.default_rng(0)
    R, L = seg.shape
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (R, L, 4, 64)).astype(np.float32)).to(dev) for _ in range(3))
    lse = torch.empty((R, 4, L), device=dev)
    out.append({"trainer": None, **_row("segment_attention",
                                        [q, k, v, seg, lse], {}, 0, flush,
                                        reps)})
    print(json.dumps(out[-1]), flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="", help="printed on every row")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    from odigos_tpu_torch.kernels import build

    build.build()
    dev = torch.device("cuda")
    scratch = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    got = rows(dev, scratch.zero_, args.reps)
    if args.label:
        print(json.dumps({"label": args.label, "rows": got}))
    print("F32 ROWS", len(got))
    return 0


if __name__ == "__main__":
    sys.exit(main())

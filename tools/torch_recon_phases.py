#!/usr/bin/env python3
"""Where K11's tensor-core kernel spends its cycles, by phase, on one GPU.

    python3 tools/torch_recon_phases.py

``recon_tc_kernel`` (``odigos_tpu_torch/kernels/csrc/recon_ce.cu``) walks
work items (a tile of 128 listed positions, a slice of the heads'
columns) in phases: the rows' labels and statistics, the gather of their
decoder rows, the LayerNorm in place, the column tiles (products and the
log-sum-exp), the merges of a row's partial sums, the kind and duration
dots, the error. This tool writes a copy of the source with a clock64()
counter at each phase boundary (thread 0 adds the cycles since the last
boundary into a device array; a __syncthreads closes each phase, so the
counters cost a little time themselves), builds it with the flags of
``odigos_tpu_torch/kernels/build.py``, launches it through the port's
wrapper on the default autoencoder's decoder output at T = 256, 2048 and
4096 traces of L = 64 (the smoke run's rows), and prints one JSON line
per T: the kernel's ``device_ms`` (``chip_smoke.device_ms``) unchanged
and instrumented, the items a call, and each phase's cycles per item
(the phases after the column tiles run in the last slice of a split tile
only, so their average is over every item). An anchor missing from the
source fails the run: update ``PHASES`` when the kernel changes.

Prints the card's name and power limit first. Imports nothing of JAX or
of the JAX package; needs a CUDA device and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (phase, text at its end, where the counter goes: after or before the
# text, with a __syncthreads first for a phase that ends without one)
PHASES = (
    ("labels_stats", "    // their decoder rows gathered into the A tile",
     "before"),
    ("gather", "    cp_async_wait<ST - 1>();  // the rows (the oldest group) "
               "landed\n    __syncthreads();\n", "after"),
    ("layer_norm", "      *p = make_uint4(w[0], w[1], w[2], w[3]);\n    }\n"
                   "    __syncthreads();\n", "after"),
    ("column_tiles", "    cp_async_wait<0>();\n", "after_sync"),
    ("quad_merge", "    float fm[2], fs[2], fz[2];\n", "before"),
    ("row_merges_partials", "    // the kind and duration logits, f32 dots "
                            "on CUDA cores: a warp's", "before_sync"),
    ("kind_duration", "    if (tid < rows) {\n      float km = -INFINITY",
     "before"),
    ("error", "  }\n}\n\ntemplate <int D>\nint launch_tc_t(", "before_sync"),
)
ITEM_START = ("    __syncthreads();  // the previous item's shared tiles are "
              "consumed\n")


def instrumented(src: str) -> str:
    """The source with the phase counters (``g_phase``, read and reset by
    two extra C functions)."""
    def count(k: int) -> str:
        return (f"    if (tid == 0) {{ const long long n_ = clock64(); "
                f"atomicAdd(&g_phase[{k}], (unsigned long long)(n_ - t_)); "
                f"t_ = n_; }}\n")

    def edit(anchor: str, text: str) -> str:
        if src.count(anchor) != 1:
            raise RuntimeError(f"anchor not once in the source: "
                               f"{anchor[:60]!r}")
        return src.replace(anchor, text)

    src = edit(ITEM_START, ITEM_START + "    long long t_ = clock64();\n"
               "    if (tid == 0) atomicAdd(&g_phase[15], 1ull);\n")
    sync = "    __syncthreads();\n"
    for k, (_, anchor, where) in enumerate(PHASES):
        src = edit(anchor, {
            "after": anchor + count(k),
            "after_sync": anchor + sync + count(k),
            "before": count(k) + anchor,
            "before_sync": sync + count(k) + anchor}[where])
    src = src.replace("namespace {\n", "namespace {\n__device__ unsigned "
                      "long long g_phase[16];\n", 1)
    return src + '''
extern "C" int phases_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));
}
extern "C" int phases_reset() {
  unsigned long long z[16] = {0};
  return (int)cudaMemcpyToSymbol(g_phase, z, sizeof(z));
}
'''


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    import chip_smoke
    from odigos_tpu_torch.kernels import build, recon
    from odigos_tpu_torch.models import AutoencoderConfig, SpanAutoencoder

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    build.build()
    served = recon._kernel("recon_ce_tc_launch")
    with tempfile.TemporaryDirectory() as tmp:
        cu = os.path.join(tmp, "recon_phases.cu")
        with open(cu, "w") as f:
            f.write(instrumented((build.CSRC / "recon_ce.cu").read_text()))
        so = cu[:-3] + ".so"
        r = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-I",
                            str(build.CSRC), "-o", so, cu],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"the instrumented copy failed to build:\n"
                               f"{r.stdout}{r.stderr}")
        lib = ctypes.CDLL(so)
        fn = lib.recon_ce_tc_launch
        fn.argtypes = served.argtypes
        fn.restype = ctypes.c_int
        lib.phases_read.argtypes = [ctypes.c_void_p]
        dev = torch.device("cuda")
        cfg = AutoencoderConfig()
        model = SpanAutoencoder(cfg, device=dev, seed=0)
        m = model.module
        wts = (cfg.w_service, cfg.w_name, cfg.w_kind, cfg.w_duration)
        for T in chip_smoke.AE_T + (4096,):
            with torch.inference_mode():
                cat, cont, mask = chip_smoke._ae_rows(T, dev)
                dec = model._decode(cat, cont, mask, reference=False)
                M = T * cfg.max_len
                rargs = (dec, m.dec_ln.weight, m.dec_ln.bias, m.heads(),
                         cat.reshape(M, -1), cont.reshape(M, -1),
                         mask.reshape(M), wts)
                planes = m.head_planes()

                def call():
                    return recon.recon_ce(*rargs, planes=planes)

                scratch = torch.empty(128 << 20, dtype=torch.uint8,
                                      device=dev)
                ms = chip_smoke.device_ms(call, scratch.zero_)
                recon._fns["recon_ce_tc_launch"] = fn
                try:
                    call()
                    torch.cuda.synchronize()
                    lib.phases_reset()
                    reps = 10
                    for _ in range(reps):
                        call()
                    torch.cuda.synchronize()
                    counts = (ctypes.c_ulonglong * 16)()
                    lib.phases_read(counts)
                    ms_inst = chip_smoke.device_ms(call, scratch.zero_)
                finally:
                    recon._fns["recon_ce_tc_launch"] = served
            items = counts[15]
            print(json.dumps({
                "T": T, "real_positions": int(mask.sum().item()),
                "device_ms": ms, "instrumented_device_ms": ms_inst,
                "items_per_call": items / reps,
                "cycles_per_item": {name: counts[k] / items
                                    for k, (name, _, _) in
                                    enumerate(PHASES)},
                "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

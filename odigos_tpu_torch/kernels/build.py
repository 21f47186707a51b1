"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/*.cu`` file exports a plain C launcher (raw pointers, sizes and
a ``cudaStream_t``) and is compiled on its own into a shared library:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/<name>-<hash>.so csrc/<name>.cu

The library lands in ``odigos_tpu_torch/kernels/build/`` (git-ignored),
named by a hash of its source, the shared ``csrc/*.cuh`` headers and the
flags, so an edited source or header rebuilds and an unchanged one is
reused. The build happens at first use, never at
import: this module imports on machines without ``nvcc`` (the CPU tests).
No PyTorch headers are compiled, so a build takes seconds. A failed build
raises; there is no fallback.

``build()`` starts one ``nvcc`` per source, all at once, and waits for
them; ``load(name)`` builds on demand and returns the loaded library.
``stream_scratch`` keeps the scratch of the kernels that count or sum
across CTAs (K11's f32 route, K17, K19, K20, K21) per kernel, device and
stream;
``sm_count`` is the card's multiprocessors, which their launchers take.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"

# kernel name -> source file under csrc/
SOURCES = {
    "segment_attention": "segment_attention.cu",
    "span_embed": "span_embed.cu",
    "zscore": "zscore.cu",
    "trace_sort": "trace_sort.cu",
    "featurize": "featurize.cu",
    "trace_pack": "trace_pack.cu",
    "span_head": "span_head.cu",
    "quant": "quant.cu",
    "qgemm": "qgemm.cu",
    "ae_pool": "ae_pool.cu",
    "recon_ce": "recon_ce.cu",
    "dense": "dense.cu",
    "gemm_f32": "gemm_f32.cu",
    "segment_attention_bwd": "segment_attention_bwd.cu",
    "ln_bwd": "ln_bwd.cu",
    "gelu_bwd": "gelu_bwd.cu",
    "span_embed_bwd": "span_embed_bwd.cu",
    "recon_ce_bwd": "recon_ce_bwd.cu",
    "ae_pool_bwd": "ae_pool_bwd.cu",
    "ring_attention": "ring_attention.cu",
    "vocab_merge": "vocab_merge.cu",
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# what the last build of each kernel printed (-Xptxas=-v: registers,
# shared memory, spills), for the smoke run's log
build_logs: dict[str, str] = {}
# (kernel, device index, stream handle) -> (zeroed, data) tensors
_scratch: dict = {}
_sms: dict[int, int] = {}  # device index -> multiprocessors


def nvcc_path() -> str:
    """The toolkit's ``nvcc``, looked up as PyTorch looks up its CUDA home:
    ``$CUDA_HOME`` / ``$CUDA_PATH``, else ``nvcc`` on ``PATH``, else the
    toolkit's default install location. Raises when there is none."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (home and os.path.join(home, "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                       "kernels are built from source at first use")


def library_path(name: str) -> Path:
    """Where ``name``'s built library lives (keyed by its source, the
    shared headers and the flags)."""
    src = (CSRC / SOURCES[name]).read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{key[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> dict[str, float]:
    """Compile the named kernels (all by default) that are not built yet,
    one ``nvcc`` process per source, all started together. Returns the
    seconds each compile took (0.0 for one already built)."""
    names = list(SOURCES if names is None else names)
    unknown = [n for n in names if n not in SOURCES]
    if unknown:
        raise KeyError(f"unknown kernels {unknown} (known: {list(SOURCES)})")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True),
                       tmp, out, time.monotonic())
    took = {n: 0.0 for n in names}
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        took[name] = time.monotonic() - t0
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return took


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib


def stream_scratch(kernel: str, dev, stream, zeroed: int, zeroed_dtype,
                   data: int = 0, data_dtype=None):
    """``kernel``'s scratch on ``dev`` for ``stream`` (``torch`` tensors,
    cached per kernel, device and stream: calls on one stream run in
    order): at least ``zeroed`` values of ``zeroed_dtype``, zeroed when
    made or grown, which every launch leaves at zero (counters, tickets,
    flags); and, with a ``data_dtype``, at least ``data`` values of it,
    which every launch writes before it reads them (else None). The two
    grow apart. Negative sizes (a size function's refusal) raise."""
    import torch

    if zeroed < 0 or data < 0:
        raise RuntimeError(f"{kernel}: no scratch size ({zeroed}, {data})")
    key = (kernel, dev.index, stream.cuda_stream)
    z, buf = _scratch.get(key, (None, None))
    if z is None or z.numel() < zeroed:
        z = torch.zeros(max(zeroed, 1), dtype=zeroed_dtype, device=dev)
    if data_dtype is not None and (buf is None or buf.numel() < data):
        buf = torch.empty(max(data, 1), dtype=data_dtype, device=dev)
    _scratch[key] = (z, buf)
    return z, buf


def drop_scratch(kernel: str, dev, stream) -> None:
    """Forget ``kernel``'s scratch for ``stream`` after a failed launch: a
    launch that failed part way may leave its zeroed values unzeroed."""
    _scratch.pop((kernel, dev.index, stream.cuda_stream), None)


def sm_count(dev) -> int:
    """The multiprocessors of the card ``dev`` (a CUDA ``torch.device``),
    looked up once."""
    import torch

    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _sms:
        _sms[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sms[idx]

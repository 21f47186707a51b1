"""K6: a stable radix sort of multi-word unsigned keys.

``radix_sort(keys, n)`` returns the int32 permutation that sorts the first
``n`` rows of ``keys`` — a sequence of ``(N,)`` tensors, MOST significant
first as in a sort by tuple, int64 words read as unsigned 64-bit and int32
words as unsigned 32-bit — stably (tied rows keep their order); rows
``n..N-1`` keep the identity. The fused route sorts once a call with it:
the trace layout by ``(trace_id_hi, trace_id_lo, start_unix_nano)``, the
``jnp.lexsort`` of ``odigos_tpu/serving/fused.py``
``_sorted_trace_layout``. (The plain join of
``features.featurizer.featurize_join_torch`` sorts with
:func:`radix_sort_plain`; on the card K5 joins by a hash table, no sort.)

u64 columns travel as zero-copy ``np.int64`` views (``torch.uint64`` has
partial op support); the kernel reads them as ``unsigned long long``, and
the plain version flips the sign bit (``x ^ -2**63``) before ordering, so
ids at or above 2**63 sort after the others, as unsigned.

A CUDA tensor launches the hand-written LSD sort of ``csrc/trace_sort.cu``
(8-bit digits, a digit that is the same in every key skipped on the card;
one cooperative launch a sort, its passes separated by grid barriers;
nothing synchronised with the host) or raises. A CPU tensor takes
:func:`radix_sort_plain`: successive ``torch.sort(stable=True)`` from the
least significant key up. ``launches`` counts wrapper calls that launched;
``device_launches`` the kernels they launched (one a call).
:func:`plan` gives the grid: each block owns a contiguous run of ``TILE``
key tiles, as many as its share of ``n`` needs.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Sequence

import torch

from . import build

MAX_WORDS = 4
TILE = 1024          # keys per tile of the hist / scatter passes
# int32 scratch a block: its OR and complement-OR of each word (u64), and
# its 256 digit counts
SCRATCH_PER_BLOCK = 2 * 2 * MAX_WORDS + 256
_SIGN = -(2 ** 63)

launches = 0
device_launches = 0
_count_lock = threading.Lock()
_fn = None
_max_grid: dict = {}  # device index -> radix_sort_max_grid


def ordered_key(key: torch.Tensor) -> torch.Tensor:
    """int64 whose signed order is ``key``'s unsigned order: int64 words
    get the sign bit flipped, int32 words are zero-extended."""
    if key.dtype == torch.int64:
        return key ^ _SIGN
    return key.to(torch.int64) & 0xFFFFFFFF


def radix_sort_plain(keys: Sequence[torch.Tensor],
                     n: Optional[int] = None) -> torch.Tensor:
    """The plain version: a stable sort by each key from the least
    significant up; the identity past ``n``."""
    N = keys[0].shape[0]
    n = N if n is None else int(n)
    dev = keys[0].device
    perm = torch.arange(n, device=dev)
    for key in reversed(keys):
        k = ordered_key(key[:n])[perm]
        perm = perm[torch.sort(k, stable=True).indices]
    return torch.cat([perm, torch.arange(n, N, device=dev)]).to(torch.int32)


def _check(keys: Sequence[torch.Tensor], n: int) -> None:
    if not 1 <= len(keys) <= MAX_WORDS:
        raise ValueError(f"radix_sort takes 1 to {MAX_WORDS} key words, "
                         f"got {len(keys)}")
    N = keys[0].shape[0]
    for k in keys:
        if k.dim() != 1 or k.shape[0] != N:
            raise ValueError(f"keys must all be ({N},), got "
                             f"{tuple(k.shape)}")
        if k.dtype not in (torch.int64, torch.int32):
            raise TypeError(f"keys must be int64 or int32, not {k.dtype}")
    if len({k.device for k in keys}) != 1:
        raise ValueError("keys on several devices")
    if not 0 <= n <= N:
        raise ValueError(f"n must be in [0, {N}], got {n}")


def plan(n: int, N: int, max_grid: int) -> tuple[int, int]:
    """``(grid, tiles_per_block)`` of a sort of ``n`` real rows of ``N``:
    enough blocks for the tiles of ``n`` (and for the padding rows' grid
    stride), at most ``max_grid``; block ``b`` owns tiles ``[b * tpb,
    (b + 1) * tpb)``."""
    tiles = -(-n // TILE)
    grid = max(1, min(max_grid, max(tiles, -(-N // TILE))))
    return grid, -(-tiles // grid)


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("trace_sort").radix_sort_launch
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_longlong] + [ctypes.c_void_p] * 4)
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def max_grid(dev: torch.device) -> int:
    """The most blocks K6 launches on ``dev`` (all resident at once)."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    g = _max_grid.get(idx)
    if g is None:
        fn = build.load("trace_sort").radix_sort_max_grid
        fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        out = ctypes.c_int(0)
        with torch.cuda.device(idx):
            rc = fn(ctypes.byref(out))
        if rc != 0:
            raise RuntimeError(f"radix_sort: no cooperative launch on {dev}: "
                               f"CUDA error {rc}")
        g = _max_grid[idx] = out.value
    return g


def radix_sort(keys: Sequence[torch.Tensor], n: Optional[int] = None,
               passes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``(N,)`` int32 permutation sorting the first ``n`` rows of ``keys``
    (most significant first), stably; the identity past ``n``. On the card
    ``passes`` (a one-element int32 tensor), when given, receives the
    number of digit passes that ran. Nothing is synchronised."""
    global launches, device_launches
    keys = list(keys)
    N = keys[0].shape[0] if keys else 0
    n = N if n is None else int(n)
    _check(keys, n)
    dev = keys[0].device
    if dev.type == "cpu":
        return radix_sort_plain(keys, n)
    if dev.type != "cuda":
        raise ValueError(f"radix_sort runs on cuda or cpu, not {dev}")
    if not all(k.is_contiguous() for k in keys):
        raise ValueError("radix_sort needs contiguous keys")
    if N >= 2 ** 31:
        raise ValueError(f"radix_sort sorts fewer than 2**31 rows, got {N}")
    if passes is not None and (passes.shape != (1,) or passes.dtype
                               != torch.int32 or passes.device != dev):
        raise ValueError(f"passes must be a (1,) int32 tensor on {dev}")
    out = torch.empty(N, dtype=torch.int32, device=dev)
    if N == 0:
        return out
    lsf = keys[::-1]  # the kernel takes the least significant word first
    grid, tpb = plan(n, N, max_grid(dev))
    scratch = torch.empty(2 * n + SCRATCH_PER_BLOCK * grid,
                          dtype=torch.int32, device=dev)
    ptrs = (ctypes.c_void_p * MAX_WORDS)(*[k.data_ptr() for k in lsf])
    bits = (ctypes.c_int * MAX_WORDS)(
        *[64 if k.dtype == torch.int64 else 32 for k in lsf])
    fn = _kernel()
    with torch.cuda.device(dev):
        rc = fn(ctypes.addressof(ptrs), ctypes.addressof(bits), len(lsf), n,
                N, grid, tpb, scratch.data_ptr(), out.data_ptr(),
                passes.data_ptr() if passes is not None else None,
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"radix_sort launch failed: CUDA error {rc}")
    with _count_lock:
        launches += 1
        device_launches += 1
    return out

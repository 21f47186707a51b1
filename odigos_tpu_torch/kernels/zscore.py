"""K3 and K4: the streaming z-score detector's update and score.

``zscore_update`` is ``_update_masked_kernel`` of
``odigos_tpu/models/zscore.py`` (``_update_kernel`` is its form with weights
of 1): weighted per-group sums of ``w``, ``w * x`` and then
``w * (x - b_mean[gid])^2`` over ``G`` groups, merged into the streaming
``(count, mean, m2)`` state with Chan's parallel formula.
``zscore_score`` is ``_score_kernel``: each span's ``|z|`` against its
group's state, 0 where the group has fewer than ``min_count`` spans; asked
to, it also returns the engine's squash ``1 - exp(-z / 4)`` and the number
of cold spans (``z == 0``), as ``ZScoreBackend.score`` in
``odigos_tpu/serving/engine.py`` computes them.

The group of a span is ``(u32(svc) * 2654435761 ^ u32(name) * 40503) mod G``
(:func:`group_ids`). The per-span terms are f32 as in the reference; the
per-group sums are taken in f64 and rounded once to f32, in the kernel and
in the plain version alike, so the atomics' order does not show in the
result and the two agree almost always to the bit. ``count`` is exact.

A CUDA tensor launches the hand-written kernels (``csrc/zscore.cu``) or
raises: K3 is three launches (the two sum passes and the merge), K4 one.
:func:`update_route` says whether K3's per-CTA sums live in shared memory
(``"shared"``, where ``2 * G`` doubles fit) or go straight to device memory
(``"global"``). A CPU tensor takes the plain PyTorch versions
(:func:`zscore_update_plain`, :func:`zscore_score_plain`).
``update_launches`` and ``score_launches`` count calls that launched.

K3 takes a ``(3, G)`` f64 scratch that is all 0 on entry and that its last
launch sets back to 0 (:func:`new_scratch`; one is made per call where none
is given). A caller that keeps one, as ``ZScoreDetector`` does, calls on
one stream at a time.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from . import build

KNUTH_SVC = 2654435761
KNUTH_NAME = 40503
_U32 = 0xFFFFFFFF
SMEM_LIMIT = 232448     # shared memory a block may use on Hopper (227 KB)
WARP_STAGING = 32 * 64 * 8   # bytes of per-warp staging (kWarps x kWarpBuf)
_ROUTES = {"shared": 0, "global": 1}
VAR_FLOOR = 1e-8

update_launches = 0
score_launches = 0
_count_lock = threading.Lock()
_fns: dict[str, object] = {}


# ------------------------------------------------------------- plain versions

def _mul_u32(a: torch.Tensor, b: int) -> torch.Tensor:
    """``(a * b) mod 2**32`` for int64 ``a`` and ``b`` in [0, 2**32), in
    int64 without overflow: ``a`` is split into 16-bit halves."""
    lo, hi = a & 0xFFFF, a >> 16
    return (lo * b + (((hi * b) & 0xFFFF) << 16)) & _U32


def group_ids(categorical: torch.Tensor, n_groups: int) -> torch.Tensor:
    """(service, name) → group id, int64: the reference's uint32 Knuth mix
    (``odigos_tpu/models/zscore.py`` ``_group_ids``), computed in int64 and
    masked to 32 bits before the xor and the modulo (torch has no uint32
    multiply on the CPU). ``n_groups`` need not be a power of two."""
    c = categorical[:, :2].long() & _U32  # the ids' uint32 bit patterns
    h = _mul_u32(c[:, 0], KNUTH_SVC) ^ _mul_u32(c[:, 1], KNUTH_NAME)
    return h % n_groups


def zscore_update_plain(count: torch.Tensor, mean: torch.Tensor,
                        m2: torch.Tensor, categorical: torch.Tensor,
                        x: torch.Tensor, weights: torch.Tensor,
                        n_groups: int
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of K3: the reference's weighted Welford merge, its
    per-span terms in f32, its per-group sums in f64 rounded once to f32
    (``index_add_``). Returns the new ``(count, mean, m2)``."""
    gid = group_ids(categorical, n_groups)
    x = x.float()
    w = weights.float()

    def seg_sum(v: torch.Tensor) -> torch.Tensor:
        acc = torch.zeros(n_groups, dtype=torch.float64, device=v.device)
        return acc.index_add_(0, gid, v.double()).float()

    n_b = seg_sum(w)
    b_mean = seg_sum(w * x) / n_b.clamp(min=1.0)
    b_m2 = seg_sum(w * (x - b_mean[gid]) ** 2)
    # Chan parallel merge, term for term as the reference writes it
    n_ab = count + n_b
    safe_ab = n_ab.clamp(min=1.0)
    delta = b_mean - mean
    mean_ab = mean + delta * (n_b / safe_ab)
    m2_ab = m2 + b_m2 + delta ** 2 * (count * n_b / safe_ab)
    return n_ab, mean_ab, m2_ab


def zscore_score_plain(count: torch.Tensor, mean: torch.Tensor,
                       m2: torch.Tensor, categorical: torch.Tensor,
                       x: torch.Tensor, n_groups: int,
                       min_count: int) -> torch.Tensor:
    """The plain version of K4's z: the reference's ``_score_kernel``."""
    gid = group_ids(categorical, n_groups)
    cnt = count[gid]
    var = m2[gid] / (cnt - 1.0).clamp(min=1.0)
    z = (x.float() - mean[gid]).abs() / var.clamp(min=VAR_FLOOR).sqrt()
    return torch.where(cnt >= min_count, z, torch.zeros_like(z))


def squash_plain(z: torch.Tensor) -> torch.Tensor:
    """|z| → (0, 1): ``1 - exp(-z / 4)`` puts z=3 near 0.53, z=8 near 0.86."""
    return 1.0 - torch.exp(-z / 4.0)


# ---------------------------------------------------------------- wrappers

def update_route(n_groups: int) -> str:
    """``"shared"`` where pass A's per-CTA sums (``2 * G`` doubles, with
    the warps' staging) fit a block's shared memory, else ``"global"``."""
    return ("shared" if WARP_STAGING + 2 * n_groups * 8 <= SMEM_LIMIT
            else "global")


def new_scratch(n_groups: int, device: torch.device) -> torch.Tensor:
    """A zeroed ``(3, G)`` f64 scratch for :func:`zscore_update`."""
    return torch.zeros((3, n_groups), dtype=torch.float64, device=device)


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        lib = build.load("zscore")
        if name == "update":
            fn = lib.zscore_update_launch
            fn.argtypes = ([ctypes.c_void_p] * 3
                           + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
                           + [ctypes.c_void_p] * 7
                           + [ctypes.c_int, ctypes.c_void_p])
        else:
            fn = lib.zscore_score_launch
            fn.argtypes = ([ctypes.c_void_p] * 2
                           + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
                           + [ctypes.c_void_p] * 3
                           + [ctypes.c_float] + [ctypes.c_void_p] * 3
                           + [ctypes.c_longlong, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check(state: tuple, categorical: torch.Tensor, x: torch.Tensor,
           n_groups: int, weights: Optional[torch.Tensor] = None) -> None:
    if n_groups <= 0 or n_groups >= 2 ** 31:
        raise ValueError(f"n_groups must be in [1, 2**31), got {n_groups}")
    if categorical.dim() != 2 or categorical.shape[1] < 2:
        raise ValueError(f"categorical must be (N, C>=2), got "
                         f"{tuple(categorical.shape)}")
    N = categorical.shape[0]
    if x.shape != (N,) or (weights is not None and weights.shape != (N,)):
        raise ValueError(f"x and weights must be ({N},)")
    for t in state:
        if t.shape != (n_groups,):
            raise ValueError(f"state tensors must be ({n_groups},), got "
                             f"{tuple(t.shape)}")
    inputs = [*state, categorical, x] + ([weights] if weights is not None
                                         else [])
    devices = {t.device for t in inputs}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {devices}")


def _check_cuda(state: tuple, categorical: torch.Tensor,
                floats: list[torch.Tensor]) -> None:
    if categorical.dtype != torch.int32:
        raise TypeError(f"categorical must be int32, got {categorical.dtype}")
    for t in [*state, *floats]:
        if t.dtype != torch.float32:
            raise TypeError(f"state, x and weights must be float32, got "
                            f"{t.dtype}")
    if not all(t.is_contiguous() for t in [*state, categorical, *floats]):
        raise ValueError("the zscore kernels need contiguous inputs")


def zscore_update(count: torch.Tensor, mean: torch.Tensor, m2: torch.Tensor,
                  categorical: torch.Tensor, x: torch.Tensor,
                  weights: torch.Tensor, n_groups: int,
                  scratch: Optional[torch.Tensor] = None
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The new ``(count, mean, m2)`` after merging the weighted batch; the
    inputs are left as they were. See the module docstring."""
    global update_launches
    state = (count, mean, m2)
    _check(state, categorical, x, n_groups, weights)
    dev = categorical.device
    if dev.type == "cpu":
        return zscore_update_plain(count, mean, m2, categorical, x, weights,
                                   n_groups)
    if dev.type != "cuda":
        raise ValueError(f"zscore_update runs on cuda or cpu, not {dev}")
    _check_cuda(state, categorical, [x, weights])
    if scratch is None:
        scratch = new_scratch(n_groups, dev)
    elif (scratch.shape != (3, n_groups) or scratch.dtype != torch.float64
          or scratch.device != dev or not scratch.is_contiguous()):
        raise ValueError(f"scratch must be a contiguous (3, {n_groups}) "
                         f"float64 tensor on {dev}")
    out = tuple(torch.empty_like(t) for t in state)
    fn = _kernel("update")
    with torch.cuda.device(dev):
        rc = fn(categorical.data_ptr(), x.data_ptr(), weights.data_ptr(),
                categorical.shape[0], categorical.shape[1], n_groups,
                count.data_ptr(), mean.data_ptr(), m2.data_ptr(),
                out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
                scratch.data_ptr(), _ROUTES[update_route(n_groups)],
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        scratch.zero_()  # a refused later pass must not leave sums behind
        raise RuntimeError(f"zscore_update launch failed: CUDA error {rc}")
    with _count_lock:
        update_launches += 1
    return out


def zscore_score(count: torch.Tensor, mean: torch.Tensor, m2: torch.Tensor,
                 categorical: torch.Tensor, x: torch.Tensor, n_groups: int,
                 min_count: int, squash: bool = False,
                 n_valid: Optional[int] = None):
    """``z`` (N,) f32; with ``squash``, ``(z, scores, cold)`` where
    ``scores = 1 - exp(-z / 4)`` and ``cold`` is a one-element int32 tensor
    counting ``z == 0`` among the first ``n_valid`` spans (all by default).
    Nothing is synchronised: the results are on the inputs' device."""
    global score_launches
    state = (count, mean, m2)
    _check(state, categorical, x, n_groups)
    N = categorical.shape[0]
    n_valid = N if n_valid is None else int(n_valid)
    if not 0 <= n_valid <= N:
        raise ValueError(f"n_valid must be in [0, {N}], got {n_valid}")
    dev = categorical.device
    if dev.type == "cpu":
        z = zscore_score_plain(count, mean, m2, categorical, x, n_groups,
                               min_count)
        if not squash:
            return z
        cold = (z[:n_valid] == 0).sum().to(torch.int32).reshape(1)
        return z, squash_plain(z), cold
    if dev.type != "cuda":
        raise ValueError(f"zscore_score runs on cuda or cpu, not {dev}")
    _check_cuda(state, categorical, [x])
    z = torch.empty(N, dtype=torch.float32, device=dev)
    s = torch.empty_like(z) if squash else None
    cold = torch.zeros(1, dtype=torch.int32, device=dev) if squash else None
    if N == 0:
        return (z, s, cold) if squash else z
    fn = _kernel("score")
    with torch.cuda.device(dev):
        rc = fn(categorical.data_ptr(), x.data_ptr(), N,
                categorical.shape[1], n_groups, count.data_ptr(),
                mean.data_ptr(), m2.data_ptr(), float(min_count),
                z.data_ptr(), s.data_ptr() if squash else None,
                cold.data_ptr() if squash else None, n_valid,
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"zscore_score launch failed: CUDA error {rc}")
    with _count_lock:
        score_launches += 1
    return (z, s, cold) if squash else z

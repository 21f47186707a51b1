"""K3 and K4: the streaming z-score detector's score and update, one launch.

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

A CUDA tensor launches the hand-written kernel (``csrc/zscore.cu``) or
raises. It is ONE kernel with its parts switchable:
:func:`zscore_score_update` scores a batch on the state before it and
folds the batch into the state in the same launch (what the engine calls),
:func:`zscore_update` is its update alone and :func:`zscore_score` its
score alone. The update's launch is cooperative: its phases (score and
pass A, pass B, merge) meet at grid barriers. :func:`update_route` says
whether each CTA's per-group sums live in shared memory (``"shared"``) or
go straight to device memory (``"global"``). A CPU tensor takes the plain
PyTorch versions (:func:`zscore_update_plain`, :func:`zscore_score_plain`;
:func:`zscore_score_update_plain` is the one then the other).
``score_launches`` and ``update_launches`` count launches that scored and
launches that updated (one launch of :func:`zscore_score_update` adds one
to each); ``device_launches`` counts kernel launches.

An update takes a scratch (:func:`new_scratch`: ``3 * G`` f64 sums, then a
bit map of touched groups and the merge's ticket) that is all 0 on entry
and that the launch sets back to 0; one is made per call where none is
given. A caller that keeps one, as ``ZScoreDetector`` does, calls on one
stream at a time. The cold count is added into a word that is 0 on entry:
:func:`zscore_score_update` takes it in ``out`` from its caller (the
detector's one host-to-device copy writes that 0), or zeroes it itself.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Optional

import torch

from . import build

KNUTH_SVC = 2654435761
KNUTH_NAME = 40503
_U32 = 0xFFFFFFFF
SMEM_LIMIT = 232448     # shared memory a block may use on Hopper (227 KB)
CTA_HEAD = 16 + 16 * 64 * 8  # bytes: the cold counter, 16 warps' staging
_ROUTES = {"shared": 0, "global": 1}
VAR_FLOOR = 1e-8
LAUNCHER = "zscore_step_launch"

score_launches = 0
update_launches = 0
device_launches = 0
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


def zscore_score_update_plain(count: torch.Tensor, mean: torch.Tensor,
                              m2: torch.Tensor, categorical: torch.Tensor,
                              x: torch.Tensor, n_groups: int, min_count: int,
                              weights: Optional[torch.Tensor] = None,
                              n_valid: Optional[int] = None):
    """The plain version of the one launch: :func:`zscore_score_plain` on
    the state before the batch (squashed, its cold spans counted among the
    first ``n_valid``), then :func:`zscore_update_plain` (weights of 1 where
    none are given). Returns ``(new_state, scores, cold)``."""
    z = zscore_score_plain(count, mean, m2, categorical, x, n_groups,
                           min_count)
    n_valid = len(z) if n_valid is None else n_valid
    cold = (z[:n_valid] == 0).sum().to(torch.int32).reshape(1)
    w = torch.ones_like(x, dtype=torch.float32) if weights is None \
        else weights
    state = zscore_update_plain(count, mean, m2, categorical, x, w,
                                n_groups)
    return state, squash_plain(z), cold


# ---------------------------------------------------------------- wrappers

def _words(n_groups: int) -> int:
    return (n_groups + 31) // 32


def update_route(n_groups: int) -> str:
    """``"shared"`` where a CTA's per-group sums (``2 * G`` doubles), its
    bit map of touched groups and the warps' staging fit a block's shared
    memory, else ``"global"``."""
    smem = CTA_HEAD + (4 * _words(n_groups) + 7) // 8 * 8 + 16 * n_groups
    return "shared" if smem <= SMEM_LIMIT else "global"


def scratch_len(n_groups: int) -> int:
    """f64 elements of the kernel's scratch: ``3 * G`` sums, then the bit
    map of ``ceil(G / 32)`` uint32 words (rounded up to an even count) and
    two words for the merge's ticket."""
    return 3 * n_groups + (_words(n_groups) + 1) // 2 + 1


def new_scratch(n_groups: int, device: torch.device) -> torch.Tensor:
    """A zeroed scratch for the kernel (:func:`scratch_len`)."""
    return torch.zeros(scratch_len(n_groups), dtype=torch.float64,
                       device=device)


class ScoreUpdate(NamedTuple):
    """What :func:`zscore_score_update` returns. ``cold`` and ``scores``
    are views of ``out``, ``(n + 1,)`` f32: the cold count's int32 bits,
    then the squashed scores, so one copy brings both to the host."""

    state: Optional[tuple]  # (count, mean, m2) after the batch, or None
    scores: torch.Tensor    # (n,) f32
    cold: torch.Tensor      # (1,) int32
    out: torch.Tensor       # (n + 1,) f32


def _kernel(name: str = LAUNCHER):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(build.load("zscore"), name)
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int]
                       + [ctypes.c_void_p] * 2
                       + [ctypes.c_longlong] * 2
                       + [ctypes.c_int, ctypes.c_float]
                       + [ctypes.c_void_p] * 10
                       + [ctypes.c_int, ctypes.c_void_p])
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
    dev = categorical.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the zscore kernel runs on cuda or cpu, not {dev}")


def _n_valid(N: int, n_valid: Optional[int]) -> int:
    n_valid = N if n_valid is None else int(n_valid)
    if not 0 <= n_valid <= N:
        raise ValueError(f"n_valid must be in [0, {N}], got {n_valid}")
    return n_valid


def _launch(state: tuple, categorical: torch.Tensor, x: torch.Tensor,
            n_groups: int, min_count: int, weights: Optional[torch.Tensor],
            out_state: Optional[tuple], z: Optional[torch.Tensor],
            s: Optional[torch.Tensor], cold: Optional[torch.Tensor],
            n_valid: int, scratch: Optional[torch.Tensor]) -> None:
    """One launch of the kernel on the current stream; counts it."""
    global score_launches, update_launches, device_launches
    dev = categorical.device
    if categorical.dtype != torch.int32:
        raise TypeError(f"categorical must be int32, got {categorical.dtype}")
    floats = [*state, x] + ([weights] if weights is not None else [])
    for t in floats:
        if t.dtype != torch.float32:
            raise TypeError(f"state, x and weights must be float32, got "
                            f"{t.dtype}")
    if not all(t.is_contiguous() for t in [*floats, categorical]):
        raise ValueError("the zscore kernel needs contiguous inputs")
    update = out_state is not None
    if update and (
            scratch.shape != (scratch_len(n_groups),)
            or scratch.dtype != torch.float64 or scratch.device != dev
            or not scratch.is_contiguous()):
        raise ValueError(f"scratch must be a contiguous "
                         f"({scratch_len(n_groups)},) float64 tensor on "
                         f"{dev} (new_scratch)")

    def ptr(t):
        return None if t is None else t.data_ptr()

    outs = out_state if update else (None, None, None)
    with torch.cuda.device(dev):
        rc = _kernel()(categorical.data_ptr(), categorical.shape[1],
                       x.data_ptr(), ptr(weights), categorical.shape[0],
                       n_valid, n_groups, float(min_count),
                       *(t.data_ptr() for t in state), *map(ptr, outs),
                       ptr(z), ptr(s), ptr(cold), ptr(scratch),
                       _ROUTES[update_route(n_groups)],
                       torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"zscore launch failed: CUDA error {rc}")
    scored = z is not None or s is not None or cold is not None
    with _count_lock:
        device_launches += 1
        score_launches += scored
        update_launches += update


def _scratch(scratch: Optional[torch.Tensor], n_groups: int,
             dev: torch.device) -> torch.Tensor:
    return new_scratch(n_groups, dev) if scratch is None else scratch


def zscore_score_update(count: torch.Tensor, mean: torch.Tensor,
                        m2: torch.Tensor, categorical: torch.Tensor,
                        x: torch.Tensor, n_groups: int, min_count: int, *,
                        weights: Optional[torch.Tensor] = None,
                        update: bool = True, n_valid: Optional[int] = None,
                        scratch: Optional[torch.Tensor] = None,
                        inplace: bool = False,
                        out: Optional[torch.Tensor] = None) -> ScoreUpdate:
    """Score a batch on the state before it — squashed ``1 - exp(-z / 4)``
    scores and the number of cold spans (``z == 0``) among the first
    ``n_valid`` (all by default) — and, with ``update``, fold the batch
    into the state (weights of 1 where none are given), in one launch.
    ``inplace`` writes the new state into ``count``, ``mean`` and ``m2``
    (the returned state is those tensors); otherwise they are left as they
    were. ``out``, ``(N + 1,)`` f32 on the card, receives the cold count
    (added to its first element's int32 bits, which must be 0) and the
    scores; where it is None one is made and its first element zeroed.
    Nothing is synchronised: the results are on the inputs' device."""
    state = (count, mean, m2)
    _check(state, categorical, x, n_groups, weights)
    N = categorical.shape[0]
    n_valid = _n_valid(N, n_valid)
    dev = categorical.device
    if out is not None and (out.shape != (N + 1,)
                            or out.dtype != torch.float32
                            or out.device != dev
                            or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous ({N + 1},) float32 "
                         f"tensor on {dev}")
    if dev.type == "cpu":
        if update:
            new, scores, cold = zscore_score_update_plain(
                count, mean, m2, categorical, x, n_groups, min_count,
                weights, n_valid)
            if inplace:
                for t, v in zip(state, new):
                    t.copy_(v)
                new = state
        else:
            new = None
            _, scores, cold = zscore_score(count, mean, m2, categorical, x,
                                           n_groups, min_count, squash=True,
                                           n_valid=n_valid)
        res = torch.cat([cold.view(torch.float32), scores])
        if out is not None:
            res = out.copy_(res)
        return ScoreUpdate(new, res[1:], res[:1].view(torch.int32), res)
    if out is None:
        out = torch.empty(N + 1, dtype=torch.float32, device=dev)
        out[:1].zero_()
    new = None
    if update:
        new = state if inplace else tuple(torch.empty_like(t)
                                          for t in state)
    cold = out[:1].view(torch.int32)
    _launch(state, categorical, x, n_groups, min_count, weights, new, None,
            out[1:], cold, n_valid,
            _scratch(scratch, n_groups, dev) if update else None)
    return ScoreUpdate(new, out[1:], cold, out)


def zscore_update(count: torch.Tensor, mean: torch.Tensor, m2: torch.Tensor,
                  categorical: torch.Tensor, x: torch.Tensor,
                  weights: Optional[torch.Tensor], n_groups: int,
                  scratch: Optional[torch.Tensor] = None
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The new ``(count, mean, m2)`` after merging the weighted batch
    (weights of 1 where ``weights`` is None); the inputs are left as they
    were. The kernel's update alone. See the module docstring."""
    state = (count, mean, m2)
    _check(state, categorical, x, n_groups, weights)
    dev = categorical.device
    if dev.type == "cpu":
        w = torch.ones_like(x) if weights is None else weights
        return zscore_update_plain(count, mean, m2, categorical, x, w,
                                   n_groups)
    out = tuple(torch.empty_like(t) for t in state)
    _launch(state, categorical, x, n_groups, 0, weights, out, None, None,
            None, categorical.shape[0], _scratch(scratch, n_groups, dev))
    return out


def zscore_score(count: torch.Tensor, mean: torch.Tensor, m2: torch.Tensor,
                 categorical: torch.Tensor, x: torch.Tensor, n_groups: int,
                 min_count: int, squash: bool = False,
                 n_valid: Optional[int] = None):
    """``z`` (N,) f32; with ``squash``, ``(z, scores, cold)`` where
    ``scores = 1 - exp(-z / 4)`` and ``cold`` is a one-element int32 tensor
    counting ``z == 0`` among the first ``n_valid`` spans (all by default).
    The kernel's score alone. Nothing is synchronised: the results are on
    the inputs' device."""
    state = (count, mean, m2)
    _check(state, categorical, x, n_groups)
    N = categorical.shape[0]
    n_valid = _n_valid(N, n_valid)
    dev = categorical.device
    if dev.type == "cpu":
        z = zscore_score_plain(count, mean, m2, categorical, x, n_groups,
                               min_count)
        if not squash:
            return z
        cold = (z[:n_valid] == 0).sum().to(torch.int32).reshape(1)
        return z, squash_plain(z), cold
    z = torch.empty(N, dtype=torch.float32, device=dev)
    s = torch.empty_like(z) if squash else None
    cold = torch.zeros(1, dtype=torch.int32, device=dev) if squash else None
    _launch(state, categorical, x, n_groups, min_count, None, None, z, s,
            cold, n_valid, None)
    return (z, s, cold) if squash else z

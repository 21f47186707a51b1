"""K14 and K15: the float encoder block's dense chain (queue B2).

``odigos_tpu/models/layers.py`` ``EncoderBlock`` (:68-81) runs, in the
working type over f32 parameters,

    h = LN1(x); q, k, v = Dense(d)(h) x 3; a = attention(q, k, v)   # K1
    x = x + Dense(d)(a); h = LN2(x)
    x = x + Dense(d)(gelu(Dense(d_ff)(h)))

and ``odigos_tpu/models/autoencoder.py`` (:78-80) adds ``dec_ff1`` → gelu →
``dec_ff2`` with no residual. Everything but the attention goes through
two kernels here:

* **K14** ``ln_bf16(x, weight, bias, eps, live, per)``: Flax's
  ``LayerNorm(dtype)`` over the last dimension, output in ``x``'s type,
  with f32 ``weight`` and ``bias``. With ``live``, a ``(1,)`` int32 count
  on ``x``'s device, the rows at or past ``live[0] * per`` are neither read
  nor written on the card (the fused routes' padding rows: every op after
  K14 is row-local, so no real score reads them), and the plain version
  writes NaN there, so that a CPU test shows the same. The statistics are
  :func:`quant.layer_norm_plain`'s (row sums
  taken exactly in f64 and rounded once to f32, two-pass variance, a
  correctly rounded ``1 / sqrt``, every step a separate IEEE op), so the
  kernel (``csrc/ln_exact.cuh``, shared with K9, K11 and K12) gives the
  plain version's bits in any summation order.
* **K15** ``gemm_bf16(x, w, b, epilogue, residual, planes, live, per)``:
  ``epilogue(x @ w.T + b)`` with ``x (M, K)``, ``w (N, K)`` (the Linear
  layout) and ``b (N,)`` all in the working type, the product summed in
  f32 and every later step rounded where Flax rounds (``Dense(dtype)``'s
  ``dot_general`` returns the working type, then ``y += bias`` in it):

  - ``"none"``: ``round(round(acc) + b)`` (q, k, v; ``dec_ff2``);
  - ``"residual"``: ``round(res + round(round(acc) + b))`` (the
    out-projection, FFN2);
  - ``"gelu_tanh"``: ``round(gelu(round(round(acc) + b)))`` (FFN1,
    ``dec_ff1``), the tanh form of ``jax.nn.gelu`` in f32 (``nn.gelu``'s
    default), as K10's mode 2 computes it. The GELU's input is a bf16
    value, so on the card it is looked up in a table of the formula's own
    bf16 results over ``y = +-0`` and ``2^-61 <= |y| < 8``
    (:func:`gelu_bf16_lookup_plain` is the lookup's plain twin); the
    formula runs elsewhere;
  - ``"gelu_tanh_formula"``: the same function with the formula evaluated
    per output on the card (no table), kept to hold the table to it;
  - ``"partial"``: ``acc`` itself, the ``(M, N)`` f32 accumulator,
    unrounded, with no bias (``b`` is None), no residual and no row
    count: a row-parallel product's share on one rank of the ``"model"``
    axis (the out-projection and FFN2 of a tensor-parallel block), whose
    sum over the axis K23 finishes.

  ``planes > 1`` splits the N columns into ``planes`` blocks returned as
  ``(planes, M, N / planes)``: the fused QKV product over ``[W_q; W_k;
  W_v]`` leaves q, k and v each contiguous for K1 in one launch.
  ``live``/``per`` is K14's row count: on the card the row tiles (128
  rows; on the f32 route 64 or 32 by shape, :func:`f32_tile`) that
  hold no row below ``live[0] * per`` are neither read nor written, and
  the rest of the last one holds whatever the product of its inputs gives;
  the plain version writes NaN in every row at or past the count.

* **K23** ``tp_epilogue(acc, b, residual)``: Flax's rounding chain on the
  all-reduced partials, ``round(res + round(round(acc) + b))`` in ``b``'s
  type, or ``round(round(acc) + b)`` without a residual: the arithmetic
  of K15's ``"residual"`` and ``"none"`` modes, so at tp = 1 K23 on a
  whole product's ``"partial"`` gives K15's bits. ``acc`` is f32, ``b``
  and the residual f32 or bf16; one elementwise launch of 16-byte vectors
  (``csrc/dense.cu``). Bound: bytes (acc, b, the residual read once, the
  output written once).

Both wrappers take an ``out`` buffer of their output's shape, type and
device (contiguous, 16-byte aligned), else allocate one: rows the kernel
skips keep what it held.

A CUDA tensor launches ``csrc/dense.cu`` or raises, never handing the work
to the plain version: K14 takes f32 or bf16 rows of ``d % 8 == 0`` from 8
to ``MAX_LN_D`` (1024: K14 normalises ``d_model`` rows), 16-byte aligned
(16-byte vectors a lane, several rows a warp at narrow d, a CTA a row past
512 f32 values; a persistent grid);
K15 takes bf16 (``wgmma`` tensor cores, TMA loads and stores) or f32
(``csrc/gemm_f32.cu``: CUDA cores, for the f32 model and the trainers'
forward; each output one ``fmaf`` chain over k ascending, so its bits do
not depend on the tile, in register blocks of up to 8 x 8 fed by 16-byte
shared-memory reads from a four-stage ``cp.async`` ring, the tile chosen by
shape to cover the SMs), with
``K % 16 == 0``, ``N % 8 == 0``, ``N / planes`` a multiple of 64 when
``planes > 1`` (each 64-column box of the output lies in one plane),
contiguous operands and 16-byte aligned ``x``, ``w``, ``residual`` and
output. A CPU tensor takes :func:`ln_bf16_plain` / :func:`gemm_bf16_plain`.
``ln_launches`` and ``gemm_launches`` count the calls that launched
(``gemm_mode_launches`` by epilogue), ``tp_epilogue_launches`` K23's.

On the card the plain product is f32 (TF32 off) rounded once, and the
kernel's bf16 x bf16 products are exact in its f32 accumulators: the two
differ in summation order only, so the rounded product may land one bf16
step apart and each rounding after it may add one more step (the bound
``chip_smoke.gemm_bound`` holds the kernel to).

The trainer's backward pass (f32) adds two kernels here:

* **K15's ``pre=``**: with a GELU epilogue on the f32 route, an ``(M, N)``
  f32 buffer (16-byte aligned on the card) that takes FFN1's
  pre-activation ``acc + b`` (K19's input); serving passes none and its
  launches are unchanged.
* **K17** ``ln_bwd(x, weight, dy, eps)`` (``csrc/ln_bwd.cu``): the
  LayerNorm's ``(dx, dweight, dbias)``, the statistics recomputed with
  K14's exact arithmetic (``ln_exact.cuh``: K14 stores none), ``dx =
  ((g - mean(g)) - xh * mean(g * xh)) * rstd`` with ``g = dy * weight``
  and ``xh = (x - mean) * rstd``, the row means and the column sums over
  the rows taken in f64 and rounded once, in one launch (per-CTA f64
  partials added by ticketed last CTAs, no float atomics) on an f64
  scratch cached per device and stream (its counters left zero by each
  call);
* **K19** ``gelu_tanh_bwd(dy, pre)`` (``csrc/gelu_bwd.cu``): ``dPre = dy *
  gelu'(pre)`` for ``jax.nn.gelu``'s tanh form in f32 IEEE steps, and
  FFN1's bias gradient (the column sums of ``dPre``, f64, rounded once)
  in the same launch: blocks of 16 rows folded in order, then the blocks
  in order by a folder CTA a 128-column group as the blocks' flags come up
  (each unit claimed by an atomic OR, and a folder whose next block is
  not up claims and produces it, so a folder waits only on a running CTA
  whatever else holds the card).

Both take f32 on the card (the trainer's type) and raise otherwise; a CPU
tensor takes :func:`ln_bwd_plain` / :func:`gelu_tanh_bwd_plain`.
``ln_bwd_launches`` and ``gelu_bwd_launches`` count the calls that
launched, ``gelu_bwd_device_launches`` the kernels K19's launcher reports
it launched. Their scratch is ``build.stream_scratch``'s, dropped after a
failed launch.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np
import torch

from . import build
from .qgemm import GELU_C, GELU_K, gelu_tanh_plain
from .quant import layer_norm_plain

LN_EPS = 1e-6
MAX_LN_D = 1024  # the models' widest d_model (coverage.MAX_D_MODEL)
EPILOGUES = {"none": 0, "residual": 1, "gelu_tanh": 2,
             "gelu_tanh_formula": 3, "partial": 4}
GELU_EPILOGUES = ("gelu_tanh", "gelu_tanh_formula")
# the f32 route's tiles (csrc/gemm_f32.cu kTiles): 8 x 8, 8 x 4 and 4 x 4
# outputs a thread of 128
F32_TILES = ((64, 128), (64, 64), (32, 64))
# the GELU table's bf16 range: |y|'s bits from 2^-61 (biased exponent
# 66) for 64 exponents of 128 mantissas (to |y| < 8), each sign
GELU_TABLE_LO = 66 << 7
GELU_TABLE_SPAN = 64 << 7
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

GELU_K3 = float(np.float32(3) * np.float32(GELU_K))  # the kernel's 3 K

ln_launches = 0
gemm_launches = 0
gemm_mode_launches = dict.fromkeys(EPILOGUES, 0)
tp_epilogue_launches = 0
ln_bwd_launches = 0
gelu_bwd_launches = 0
gelu_bwd_device_launches = 0
_count_lock = threading.Lock()
_fns: dict = {}
# K17's f64 scratch per (device, stream): its counters must start at zero,
# and each launch leaves them so; K19's flags (int32, likewise) and
# partials (f64, written before they are read) per (device, stream)


# ------------------------------------------------------------------ plain
def ln_bf16_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  eps: float = LN_EPS, live: Optional[torch.Tensor] = None,
                  per: int = 1) -> torch.Tensor:
    """K14's plain version: the exact LayerNorm, rounded to ``x``'s type;
    NaN in the rows at or past ``live[0] * per`` (read on the device, no
    sync)."""
    _check_ln(x, weight, bias, live, per)
    return _nan_past(layer_norm_plain(x, weight, bias, eps), live, per)


def _split(y: torch.Tensor, planes: int) -> torch.Tensor:
    if planes == 1:
        return y
    M, N = y.shape
    return y.view(M, planes, N // planes).transpose(0, 1).contiguous()


def _nan_past(y: torch.Tensor, live: Optional[torch.Tensor],
              per: int) -> torch.Tensor:
    """``y`` with NaN in its rows (over the last dimension) at or past
    ``live[0] * per``, the count read on the device (no sync)."""
    if live is None:
        return y
    d = y.shape[-1]
    rows = torch.arange(y.numel() // max(d, 1), device=y.device)
    keep = (rows < live.to(torch.int64) * per).view(*y.shape[:-1], 1)
    return torch.where(keep, y, torch.full((), float("nan"), dtype=y.dtype,
                                           device=y.device))


def gemm_bf16_plain(x: torch.Tensor, w: torch.Tensor,
                    b: Optional[torch.Tensor], epilogue: str = "none",
                    residual: Optional[torch.Tensor] = None,
                    planes: int = 1, live: Optional[torch.Tensor] = None,
                    per: int = 1,
                    pre: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K15's plain version: the product in f32 rounded to the working type,
    the bias added and rounded, then the epilogue (module docstring); NaN
    in the rows at or past ``live[0] * per``. ``pre`` takes the GELU's
    input (f64 inputs compute in f64: the gradient checks). ``"partial"``
    returns the product in f32 (f64), unrounded."""
    _check_gemm(x, w, b, epilogue, residual, planes, live, per, pre)
    dt = x.dtype
    acc = torch.float64 if dt == torch.float64 else torch.float32
    if epilogue == "partial":
        return x.to(acc) @ w.to(acc).t()
    y = (x.to(acc) @ w.to(acc).t()).to(dt)
    y = (y.to(acc) + b.to(acc)).to(dt)
    if epilogue == "residual":
        y = (residual.to(acc) + y.to(acc)).to(dt)
    elif epilogue in GELU_EPILOGUES:
        if pre is not None:
            pre.copy_(y)
        y = gelu_tanh_plain(y.to(acc)).to(dt)
    return _split(_nan_past(y, live, per), planes)


def gelu_bf16_lookup_plain(y: torch.Tensor) -> torch.Tensor:
    """The plain twin of K15's GELU lookup: ``round(gelu(y))`` for bf16
    ``y`` from a table of ``gelu_tanh_plain`` over the table's range and
    ``+-0``, indexed by ``y``'s bits as the kernel indexes it (entry ``2 x
    slot + sign``, the range's slots first, zero's last); the formula for
    the rare values (tiny ones, ``|y| >= 8``, inf and NaN). Equal to
    ``gelu_tanh_plain(y.float()).to(bfloat16)`` bit for bit."""
    entry = torch.arange(2 * (GELU_TABLE_SPAN + 1))
    slot = entry >> 1
    bits = ((entry & 1) << 15) | torch.where(slot < GELU_TABLE_SPAN,
                                             slot + GELU_TABLE_LO, 0)
    table = gelu_tanh_plain(bits.to(torch.int16).view(torch.bfloat16)
                            .float()).to(torch.bfloat16).to(y.device)
    b = y.contiguous().view(torch.int16).to(torch.int64) & 0xFFFF
    u = (b & 0x7FFF) - GELU_TABLE_LO
    inside = (u >= 0) & (u < GELU_TABLE_SPAN)
    rare = ~inside & ((b & 0x7FFF) != 0)
    looked = table[(torch.where(inside, u, GELU_TABLE_SPAN) << 1)
                   | (b >> 15)]
    return torch.where(rare, gelu_tanh_plain(y.float()).to(torch.bfloat16),
                       looked)


def tp_epilogue_plain(acc: torch.Tensor, b: torch.Tensor,
                      residual: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """K23's plain version: ``round(res + round(round(acc) + b))`` in
    ``b``'s type (without a residual ``round(round(acc) + b)``), every
    step in f32 (f64 for f64 inputs), as :func:`gemm_bf16_plain` rounds
    its ``"residual"`` and ``"none"`` modes."""
    _check_tp_epilogue(acc, b, residual)
    dt = b.dtype
    f = torch.float64 if dt == torch.float64 else torch.float32
    y = acc.to(dt)
    y = (y.to(f) + b.to(f)).to(dt)
    if residual is not None:
        y = (residual.to(f) + y.to(f)).to(dt)
    return y


# ----------------------------------------------------------------- checks
def _same_device(*ts) -> None:
    devs = {t.device for t in ts if t is not None}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")


def _check_count(live, per: int) -> None:
    if live is not None and (live.shape != (1,) or live.dtype != torch.int32):
        raise ValueError(f"live must be a (1,) int32 count, got "
                         f"{tuple(live.shape)} {live.dtype}")
    if per < 1:
        raise ValueError(f"per must be >= 1, got {per}")


def _check_ln(x, weight, bias, live=None, per: int = 1) -> None:
    d = x.shape[-1]
    for name, t in (("weight", weight), ("bias", bias)):
        if t.shape != (d,):
            raise ValueError(f"{name} must be ({d},), got {tuple(t.shape)}")
    _check_count(live, per)
    _same_device(x, weight, bias, live)


def _check_gemm(x, w, b, epilogue, residual, planes, live=None,
                per: int = 1, pre=None) -> None:
    if epilogue not in EPILOGUES:
        raise ValueError(f"epilogue must be one of {sorted(EPILOGUES)}, "
                         f"not {epilogue!r}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[1]:
        raise ValueError(f"x (M, K) and w (N, K) expected, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    M, N = x.shape[0], w.shape[0]
    if epilogue == "partial":
        if b is not None or planes != 1 or live is not None:
            raise ValueError("the 'partial' epilogue takes no bias, no "
                             "planes and no row count")
    elif b is None or b.shape != (N,):
        raise ValueError(f"b must be ({N},), got "
                         f"{None if b is None else tuple(b.shape)}")
    if (epilogue == "residual") != (residual is not None):
        raise ValueError("a residual is given exactly with the 'residual' "
                         "epilogue")
    if residual is not None and residual.shape != (M, N):
        raise ValueError(f"residual must be ({M}, {N})")
    if planes < 1 or N % planes or (epilogue == "residual" and planes != 1):
        raise ValueError(f"planes must divide N = {N} (1 with a residual)")
    for name, t in (("w", w), ("b", b), ("residual", residual)):
        if t is not None and t.dtype != x.dtype:
            raise TypeError(f"{name} must be {x.dtype} like x, not "
                            f"{t.dtype}")
    _check_count(live, per)
    _same_device(x, w, b, residual, live, pre)
    if pre is not None and (epilogue not in GELU_EPILOGUES or planes != 1
                            or tuple(pre.shape) != (M, N)
                            or pre.dtype != x.dtype
                            or not pre.is_contiguous()):
        raise ValueError(f"pre takes a GELU epilogue's input: a contiguous "
                         f"({M}, {N}) {x.dtype} buffer, planes 1")


def _check_tp_epilogue(acc, b, residual) -> None:
    if acc.dim() != 2 or b.shape != (acc.shape[1],):
        raise ValueError(f"acc (M, N) and b (N,) expected, got "
                         f"{tuple(acc.shape)} and {tuple(b.shape)}")
    want = torch.float64 if b.dtype == torch.float64 else torch.float32
    if acc.dtype != want:
        raise TypeError(f"acc must be {want} for a {b.dtype} bias, not "
                        f"{acc.dtype}")
    if residual is not None and (residual.shape != acc.shape
                                 or residual.dtype != b.dtype):
        raise ValueError(f"residual must be {tuple(acc.shape)} {b.dtype}")
    _same_device(acc, b, residual)


def _card(dev: torch.device, what: str) -> None:
    if dev.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, not {dev}")


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        lib = "gemm_f32" if name.startswith("gemm_f32") else "dense"
        fn = getattr(build.load(lib), name)
        if name == "ln_bf16_launch":
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_float,
                           ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                           ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        elif name == "gemm_bf16_launch":
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int]
                           + [ctypes.c_longlong] + [ctypes.c_int] * 3
                           + [ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_void_p])
        elif name == "gemm_f32_launch":
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int]
                           + [ctypes.c_longlong] + [ctypes.c_int] * 3
                           + [ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_void_p, ctypes.c_void_p])
        elif name == "gemm_f32_tile":
            fn.argtypes = [ctypes.c_longlong, ctypes.c_int]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def f32_tile(M: int, N: int) -> tuple[int, int]:
    """The (rows, columns) of the tile K15's f32 route takes at ``(M, N)``
    on the current card, one of ``F32_TILES``: a row count skips whole
    tiles of its height."""
    t = _kernel("gemm_f32_tile")(M, N)
    if t < 0:
        raise RuntimeError("gemm_f32_tile: no CUDA device")
    return F32_TILES[t]


# ---------------------------------------------------------------- kernels
def _out(out: Optional[torch.Tensor], shape, x: torch.Tensor,
         what: str, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The caller's output buffer, checked, or a new one (of ``dtype``,
    else ``x``'s)."""
    dtype = dtype or x.dtype
    if out is None:
        return torch.empty(shape, dtype=dtype, device=x.device)
    if (tuple(out.shape) != tuple(shape) or out.dtype != dtype
            or out.device != x.device or not out.is_contiguous()
            or out.data_ptr() % 16):
        raise ValueError(f"{what}: out must be a contiguous, 16-byte "
                         f"aligned {dtype} buffer of shape {tuple(shape)} "
                         f"on {x.device}")
    return out


def _ln_args(x, weight, bias) -> tuple[int, int]:
    """Check a card launch's inputs; ``(rows, d)``."""
    _card(x.device, "ln_bf16")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"x must be float32 or bfloat16, not {x.dtype}")
    if weight.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError("LayerNorm parameters must be float32")
    d = x.shape[-1]
    if d % 8 or not 8 <= d <= MAX_LN_D:
        raise ValueError(f"ln_bf16 takes d % 8 == 0 from 8 to {MAX_LN_D}, "
                         f"not {d}")
    if not all(t.is_contiguous() for t in (x, weight, bias)):
        raise ValueError("ln_bf16 needs contiguous inputs")
    if x.data_ptr() % 16:
        raise ValueError("ln_bf16 needs x 16-byte aligned")
    return x.numel() // d, d


def ln_bf16(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
            eps: float = LN_EPS, live: Optional[torch.Tensor] = None,
            per: int = 1, out: Optional[torch.Tensor] = None
            ) -> torch.Tensor:
    """K14: the LayerNorm over ``x``'s last dimension, in ``x``'s type and
    shape, into ``out`` if given; with ``live``, the rows at or past
    ``live[0] * per`` are left unwritten (see the module docstring).
    Nothing is synchronised."""
    global ln_launches
    dev = x.device
    if dev.type == "cpu":
        y = ln_bf16_plain(x, weight, bias, eps, live, per)
        return y if out is None else _out(out, x.shape, x, "ln_bf16").copy_(y)
    _check_ln(x, weight, bias, live, per)
    rows, d = _ln_args(x, weight, bias)
    out = _out(out, x.shape, x, "ln_bf16")
    if rows == 0:
        return out
    with torch.cuda.device(dev):
        rc = _kernel("ln_bf16_launch")(
            x.data_ptr(), _DTYPE_CODES[x.dtype], weight.data_ptr(),
            bias.data_ptr(), eps, rows, d,
            None if live is None else live.data_ptr(), per, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ln_bf16 launch failed: CUDA error {rc}")
    with _count_lock:
        ln_launches += 1
    return out


def gemm_bf16(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
              epilogue: str = "none",
              residual: Optional[torch.Tensor] = None,
              planes: int = 1, live: Optional[torch.Tensor] = None,
              per: int = 1, out: Optional[torch.Tensor] = None,
              pre: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K15: ``(M, N)`` (or ``(planes, M, N / planes)``) in ``x``'s type,
    into ``out`` if given; with ``live``, the row tiles past ``live[0] *
    per`` are left unwritten (see the module docstring). ``pre`` (the f32
    route's GELU epilogues): an ``(M, N)`` buffer that takes the GELU's
    input. ``"partial"``: the ``(M, N)`` f32 product, ``b`` None. Nothing
    is synchronised."""
    global gemm_launches
    dev = x.device
    odt = torch.float32 if epilogue == "partial" else None
    if dev.type == "cpu":
        y = gemm_bf16_plain(x, w, b, epilogue, residual, planes, live, per,
                            pre)
        return y if out is None else _out(out, y.shape, x, "gemm_bf16",
                                          y.dtype).copy_(y)
    _check_gemm(x, w, b, epilogue, residual, planes, live, per, pre)
    _card(dev, "gemm_bf16")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"x must be float32 or bfloat16, not {x.dtype}")
    if pre is not None and x.dtype != torch.float32:
        raise TypeError("pre= is the f32 route's (the trainer's FFN1)")
    M, K = x.shape
    N = w.shape[0]
    if K % 16 or N % 8 or (planes > 1 and (N // planes) % 64):
        raise ValueError(f"gemm_bf16 takes K % 16 == 0, N % 8 == 0 and, "
                         f"with planes, N / planes % 64 == 0; got K = {K}, "
                         f"N = {N}, planes = {planes}")
    ts = (x, w) + tuple(t for t in (b, residual) if t is not None)
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("gemm_bf16 needs contiguous inputs")
    if any(t.data_ptr() % 16 for t in (x, w, residual) if t is not None):
        raise ValueError("gemm_bf16 needs x, w and the residual 16-byte "
                         "aligned")
    if b is not None and b.data_ptr() % 4:
        raise ValueError("gemm_bf16 needs b 4-byte aligned")
    if pre is not None and pre.data_ptr() % 16:
        raise ValueError("gemm_bf16 needs pre 16-byte aligned")
    shape = (M, N) if planes == 1 else (planes, M, N // planes)
    out = _out(out, shape, x, "gemm_bf16", odt)
    if M == 0:
        return out
    ptrs = (x.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(),
            None if residual is None else residual.data_ptr(),
            out.data_ptr(), EPILOGUES[epilogue], M, N, K, planes,
            None if live is None else live.data_ptr(), per)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if x.dtype == torch.float32:
            rc = _kernel("gemm_f32_launch")(
                *ptrs, None if pre is None else pre.data_ptr(), stream)
        else:
            rc = _kernel("gemm_bf16_launch")(*ptrs, stream)
    if rc != 0:
        raise RuntimeError(f"gemm_bf16 launch failed: CUDA error {rc}")
    with _count_lock:
        gemm_launches += 1
        gemm_mode_launches[epilogue] += 1
    return out


def tp_epilogue(acc: torch.Tensor, b: torch.Tensor,
                residual: Optional[torch.Tensor] = None,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K23: the all-reduced ``(M, N)`` f32 partials through Flax's
    rounding chain (module docstring), in ``b``'s type, into ``out`` if
    given. A CUDA tensor launches the kernel or raises. Nothing is
    synchronised."""
    global tp_epilogue_launches
    dev = acc.device
    if dev.type == "cpu":
        y = tp_epilogue_plain(acc, b, residual)
        return y if out is None else _out(out, y.shape, b, "tp_epilogue",
                                          y.dtype).copy_(y)
    _check_tp_epilogue(acc, b, residual)
    _card(dev, "tp_epilogue")
    if b.dtype not in _DTYPE_CODES:
        raise TypeError(f"b must be float32 or bfloat16, not {b.dtype}")
    M, N = acc.shape
    if N % 8:
        raise ValueError(f"tp_epilogue takes N % 8 == 0, not {N}")
    ts = (acc, b) + (() if residual is None else (residual,))
    if not all(t.is_contiguous() for t in ts) or any(
            t.data_ptr() % 16 for t in ts):
        raise ValueError("tp_epilogue needs contiguous, 16-byte aligned "
                         "inputs")
    out = _out(out, (M, N), b, "tp_epilogue")
    if M == 0:
        return out
    fn = _fns.get("tp_epilogue_launch")
    if fn is None:
        fn = build.load("dense").tp_epilogue_launch
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int,
                                                ctypes.c_longlong,
                                                ctypes.c_int,
                                                ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns["tp_epilogue_launch"] = fn
    with torch.cuda.device(dev):
        rc = fn(acc.data_ptr(), b.data_ptr(),
                None if residual is None else residual.data_ptr(),
                out.data_ptr(), _DTYPE_CODES[b.dtype], M, N,
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"tp_epilogue launch failed: CUDA error {rc}")
    with _count_lock:
        tp_epilogue_launches += 1
    return out


# ------------------------------------------------------- backward (K17/K19)
def ln_bwd_plain(x: torch.Tensor, weight: torch.Tensor, dy: torch.Tensor,
                 eps: float = LN_EPS
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K17's plain version: ``(dx, dweight, dbias)`` of the LayerNorm over
    ``x``'s last dimension, the statistics as K14's plain version
    (``quant.layer_norm_plain``) computes them, the row means and the
    column sums taken in f64 and rounded once, every other step a
    separate IEEE op (f64 inputs compute in f64)."""
    _check_ln_bwd(x, weight, dy)
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    d = x.shape[-1]
    xf = x.reshape(-1, d).to(acc)
    e = dy.reshape(-1, d).to(acc)
    k = torch.full((), d, dtype=acc, device=x.device)

    def row_mean(t: torch.Tensor) -> torch.Tensor:
        return t.to(torch.float64).sum(-1, keepdim=True).to(acc) / k

    mean = row_mean(xf)
    dev = xf - mean
    var = row_mean(dev * dev)
    rstd = torch.ones_like(var) / torch.sqrt(var + eps)
    xh = dev * rstd
    g = e * weight.to(acc)
    c1 = row_mean(g)
    c2 = row_mean(g * xh)
    dx = ((g - c1) - xh * c2) * rstd
    dw = (e * xh).to(torch.float64).sum(0).to(acc)
    db = e.to(torch.float64).sum(0).to(acc)
    return dx.to(x.dtype).view(x.shape), dw, db


def _check_ln_bwd(x, weight, dy) -> None:
    d = x.shape[-1]
    if weight.shape != (d,):
        raise ValueError(f"weight must be ({d},), got {tuple(weight.shape)}")
    if dy.shape != x.shape:
        raise ValueError(f"dy must be {tuple(x.shape)}, got "
                         f"{tuple(dy.shape)}")
    _same_device(x, weight, dy)


def _partials(source: str, name: str, *shape: int) -> int:
    """The scratch a K17 launch over ``rows`` rows (its partial rows) or a
    K19 launch over ``(M, N)`` (its partials, its flags) needs: the
    source's own count."""
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(build.load(source), name)
        fn.argtypes = [ctypes.c_longlong] + [ctypes.c_int] * (len(shape) - 1)
        fn.restype = ctypes.c_longlong
        _fns[name] = fn
    return int(fn(*shape))


def _ln_bwd_kernel():
    fn = _fns.get("ln_bwd_launch")
    if fn is None:
        fn = build.load("ln_bwd").ln_bwd_launch
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_float,
                                                ctypes.c_longlong,
                                                ctypes.c_int]
                       + [ctypes.c_void_p] * 5)
        fn.restype = ctypes.c_int
        _fns["ln_bwd_launch"] = fn
    return fn


def _ln_bwd_part(dev: torch.device, stream, n: int) -> torch.Tensor:
    """K17's cached f64 scratch of at least ``n`` values on ``dev`` for
    ``stream`` (``build.stream_scratch``: zeroed when made or grown, then
    left to the kernel, which leaves its counters at zero)."""
    if n <= 0:
        raise RuntimeError("ln_bwd: the card's SM count could not be read")
    return build.stream_scratch("ln_bwd", dev, stream, n, torch.float64)[0]


def ln_bwd(x: torch.Tensor, weight: torch.Tensor, dy: torch.Tensor,
           eps: float = LN_EPS
           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K17: ``(dx, dweight, dbias)``, f32 (module docstring). Nothing is
    synchronised."""
    global ln_bwd_launches
    _check_ln_bwd(x, weight, dy)
    dev = x.device
    if dev.type == "cpu":
        return ln_bwd_plain(x, weight, dy, eps)
    _card(dev, "ln_bwd")
    if any(t.dtype != torch.float32 for t in (x, weight, dy)):
        raise TypeError("ln_bwd takes float32 (the trainer's type)")
    d = x.shape[-1]
    if not 1 <= d <= MAX_LN_D:
        raise ValueError(f"ln_bwd takes d from 1 to {MAX_LN_D}, not {d}")
    if not all(t.is_contiguous() for t in (x, weight, dy)):
        raise ValueError("ln_bwd needs contiguous inputs")
    rows = x.numel() // d
    dx = torch.empty_like(x)
    dw = torch.empty(d, dtype=torch.float32, device=dev)
    db = torch.empty(d, dtype=torch.float32, device=dev)
    if rows == 0:
        return dx, dw.zero_(), db.zero_()
    fn = _ln_bwd_kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        part = _ln_bwd_part(dev, stream,
                            _partials("ln_bwd", "ln_bwd_partials", rows) * 2
                            * d)
        rc = fn(x.data_ptr(), weight.data_ptr(), dy.data_ptr(), eps, rows, d,
                dx.data_ptr(), dw.data_ptr(), db.data_ptr(), part.data_ptr(),
                stream.cuda_stream)
        if rc != 0:
            build.drop_scratch("ln_bwd", dev, stream)
    if rc != 0:
        raise RuntimeError(f"ln_bwd launch failed: CUDA error {rc}")
    with _count_lock:
        ln_bwd_launches += 1
    return dx, dw, db


def gelu_tanh_grad_plain(x: torch.Tensor) -> torch.Tensor:
    """``gelu'(x)`` of ``jax.nn.gelu``'s tanh form, in ``x``'s type, one
    IEEE step per op (K19's ``gelu_tanh_grad``)."""
    x2 = x * x
    x3 = x2 * x
    t = torch.tanh((x + x3 * GELU_K) * GELU_C)
    cdf = (t + 1.0) * 0.5
    pdf = (x * 0.5) * (1.0 - t * t)
    dinner = (x2 * GELU_K3 + 1.0) * GELU_C
    return cdf + pdf * dinner


def gelu_tanh_bwd_plain(dy: torch.Tensor, pre: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """K19's plain version: ``(dPre, db)``, ``dPre = dy * gelu'(pre)`` and
    its column sums (f64, rounded once)."""
    _check_gelu_bwd(dy, pre)
    dpre = dy * gelu_tanh_grad_plain(pre)
    return dpre, dpre.to(torch.float64).sum(0).to(dy.dtype)


def _check_gelu_bwd(dy, pre) -> None:
    if dy.dim() != 2 or pre.shape != dy.shape:
        raise ValueError(f"dy and pre must be one (M, N) shape, got "
                         f"{tuple(dy.shape)} and {tuple(pre.shape)}")
    if dy.dtype != pre.dtype:
        raise TypeError("dy and pre must have one dtype")
    _same_device(dy, pre)


def gelu_tanh_bwd(dy: torch.Tensor, pre: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """K19: ``(dPre, db)`` (module docstring). Nothing is synchronised."""
    global gelu_bwd_launches, gelu_bwd_device_launches
    _check_gelu_bwd(dy, pre)
    dev = dy.device
    if dev.type == "cpu":
        return gelu_tanh_bwd_plain(dy, pre)
    _card(dev, "gelu_tanh_bwd")
    if dy.dtype != torch.float32:
        raise TypeError("gelu_tanh_bwd takes float32 (the trainer's type)")
    M, N = dy.shape
    if N % 4 or not (dy.is_contiguous() and pre.is_contiguous()) or any(
            t.data_ptr() % 16 for t in (dy, pre)):
        raise ValueError("gelu_tanh_bwd takes N % 4 == 0 and contiguous, "
                         "16-byte aligned dy and pre")
    dpre = torch.empty_like(dy)
    db = torch.empty(N, dtype=torch.float32, device=dev)
    if M == 0:
        return dpre, db.zero_()
    fn = _fns.get("gelu_tanh_bwd_launch")
    if fn is None:
        fn = build.load("gelu_bwd").gelu_tanh_bwd_launch
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong,
                                                ctypes.c_int]
                       + [ctypes.c_void_p] * 4
                       + [ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns["gelu_tanh_bwd_launch"] = fn
    launched = ctypes.c_int(0)  # the kernels launched (the launcher's own)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        flags, part = build.stream_scratch(
            "gelu_bwd", dev, stream,
            _partials("gelu_bwd", "gelu_bwd_flags", M, N), torch.int32,
            _partials("gelu_bwd", "gelu_bwd_scratch", M, N), torch.float64)
        rc = fn(dy.data_ptr(), pre.data_ptr(), M, N, dpre.data_ptr(),
                db.data_ptr(), flags.data_ptr(), part.data_ptr(),
                build.sm_count(dev), ctypes.byref(launched),
                stream.cuda_stream)
        if rc != 0:
            build.drop_scratch("gelu_bwd", dev, stream)
    if rc != 0:
        raise RuntimeError(f"gelu_tanh_bwd launch failed: CUDA error {rc}")
    with _count_lock:
        gelu_bwd_launches += 1
        gelu_bwd_device_launches += launched.value
    return dpre, db

"""K11: the autoencoder's decoder LayerNorm + four heads + reconstruction error.

``recon_ce(dec, ln_weight, ln_bias, heads, categorical, continuous, mask,
loss_weights)`` takes the decoder's ``(M, d)`` output BEFORE ``dec_ln``
(M = T·L positions, working type) and returns the ``(M,)`` f32 weighted
reconstruction error of ``odigos_tpu/models/autoencoder.py``
``SpanAutoencoder._errors`` (:112-120):

    y   = dec_ln(dec)                 # f32 statistics, rounded to the
                                      # working type (Flax's dtype=bf16)
    err = w_s·ce(y W_s + b_s, cat[:, 0]) + w_n·ce(y W_n + b_n, cat[:, 1])
          + w_k·ce(y W_k + b_k, cat[:, 2]) + w_d·(y W_d + b_d - cont[:, 0])²

summed in that order, 0 at masked positions. ``heads`` is the four
``(weight (V, d), bias (V,))`` f32 pairs in the order service, name, kind,
duration (V = 1). A label is read as the reference's ``_ce`` reads it,
``jnp.take_along_axis`` in fill mode (:func:`take_labels`): one in ``[-V,
0)`` wraps to ``V + label``, any other past its head makes the real
position's error NaN (its log-sum-exps stay finite), and the backward
gives that head zero gradient there, as ``jax.grad`` does.

With ``span_map`` (``(M,)`` int32, each position's original span index,
-1 at padding: K13's map) and ``n_out``, it also returns the ``(n_out,)``
f32 squashed scores ``1 - exp(-err)`` written at those indices, 0
elsewhere: ``_build_forward_spans``'s squash and inverse scatter
(``odigos_tpu/serving/fused.py:491-509``).

The LayerNorm is :func:`quant.layer_norm_plain`'s (exact f64 row sums), so
kernel and plain version normalise to the same bits; the heads' f32 dots
and the log-sum-exp are summed in another order (the kernel keeps an
online log-sum-exp and never writes the logits), so ``err`` agrees to
summation-order noise.

With ``lse`` (an ``(M, 3)`` f32 buffer; the trainer's forward) it also
writes each real position's log-sum-exps of the service, name and kind
logits (0 at padding): the f32 CUDA-core kernel only, as K1's f32 routes
write theirs for K16. :func:`recon_ce_bwd` (K20, ``csrc/recon_ce_bwd.cu``)
is the backward pass: from those log-sum-exps and the gradient of each
position's error, the gradient at ``dec_ln``'s output (``dy``, 0 at
padding; K17 takes it through ``dec_ln``) and the four heads' weight and
bias gradients, the LayerNorm recomputed with K11's bits.

A CUDA tensor launches ``csrc/recon_ce.cu`` or raises; a CPU tensor takes
:func:`recon_ce_plain`. :func:`kernel_route` names the kernel: bf16, the
served type, runs the service and name heads on tensor cores (``"tc"``,
two launches: compact the real positions, then a persistent scoring
kernel), which needs each head weight split into three bf16 planes, ``W =
W_hi + W_mid + W_lo`` exactly (:func:`head_planes`; dec_ln's output is a
bf16 value there, so each plane's products are exact in f32); the caller
passes them in ``planes`` (the autoencoder caches them per weight tree),
else they are made for the call. f32 (the parity path), and bf16 whose
heads the split cannot hold (:func:`split_planes` is None: the caller
says so with ``route="cuda_core"``, decided when the weights are loaded),
run the CUDA-core kernel (two launches: list the real positions, then
persistent CTAs over (tile of real positions, head, group of the head's
residue classes mod 16) items, the tile's last item merging them; its
counters and data are ``build.stream_scratch``'s, dropped after a failed
launch).
Neither falls back to the other on a launch. ``d % 16 == 0`` up to
``MAX_D`` (the tensor-core kernel's 128-position tiles at ``TC_WIDTHS``,
64-position tiles chunked along d elsewhere; the CUDA-core kernel takes
``d % 4 == 0``), ``M < 2^31``, the kind head at most ``MAX_KIND`` wide on
the tensor-core route. ``launches`` counts the calls
that launched, ``tc_launches`` those on the tensor-core kernel,
``device_launches`` the kernels; ``bwd_launches`` counts K20's calls and
``bwd_device_launches`` the kernels its launcher reports (two a call: the
real positions listed with their ``dec_ln`` output, then persistent CTAs
over (tile of listed positions, vocabulary slice) and dW items, paired by
programmatic dependent launch; its counters and data are
``build.stream_scratch``'s, dropped after a failed launch).

**The vocabulary on the ``"model"`` axis** (the reference's
``PARTITION_RULES`` put the service and name heads' columns on it; XLA
then takes ``_ce``'s ``log_softmax`` across the split vocabulary). Each
shard holds a slice of rows of each head (:class:`VocabSlice`: the whole
widths and its first rows; a head the mesh guard keeps whole is the whole
head on every shard). :func:`recon_ce_slice` is K11's ``"slice"`` mode on
both kernels: per real position, the ``(M, 8)`` record (``lse_s, zl_s,
lse_n, zl_n, ce_k, dd, lse_k, 0``) of the slice's log-sum-exps, the
label's logit where the slice holds it (NaN elsewhere; the label read
against the whole head, :func:`take_slice_labels`), the replicated kind
head's cross-entropy, ``duration - continuous[:, 0]`` and the kind head's
log-sum-exp (0 on the wide bf16 kernel). The model axis gathers the
shards' records in rank order (``parallel/tp.py``) and
:func:`vocab_ce_merge` (K24, ``csrc/vocab_merge.cu``) merges them: each
sliced head's log-sum-exp over the parts in rank order, the label's logit
from the shard that holds it, the error in K11's steps, and (the
trainer's) the merged ``(M, 3)`` log-sum-exps K20 reads. A whole head is
one part, rank 0's, counted once. At tp = 1 the two are K11's error bit
for bit. :func:`recon_ce_bwd` takes the same slice (``vslice``) and
``dy_heads``, the heads whose ``dlogit . W`` enters this shard's ``dy``
(a whole head on one shard only, so that the sum over the axis counts it
once). ``slice_launches`` counts K11's slice-mode calls that launched,
``merge_launches`` the kernels K24's launcher reports (one a call), and
``bwd_slice_launches`` the K20 calls that launched its slice mode (a
template argument of its kernels, taken where the heads are a slice or
``dy_heads`` leaves one out; ``launches`` and ``bwd_launches`` count them
too); the fused route's squash and scatter has no slice mode.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

from . import build
from .quant import layer_norm_plain

LN_EPS = 1e-6
TC_WIDTHS = (32, 64, 128, 256)  # the 128-position tensor-core kernel
MAX_D = 1024
ROUTES = ("tc", "cuda_core")
# the bf16 kernel's geometry (csrc/recon_ce.cu): columns each tensor-core
# head pads to, the kind head's width, positions a tile, the slices a tile
# may split into, and room for split tiles' partials per SM
PLANE_PAD = 64
MAX_KIND = 16
TILE = 128
MAX_SLICES = 16
PART_ITEMS_PER_SM = 8


launches = 0
tc_launches = 0
device_launches = 0
slice_launches = 0
merge_launches = 0
bwd_launches = 0
bwd_device_launches = 0
bwd_slice_launches = 0
REC = 8  # floats a slice-mode record
_count_lock = threading.Lock()
_fns: dict = {}

Heads = Sequence[tuple[torch.Tensor, torch.Tensor]]


def _acc(dtype: torch.dtype) -> torch.dtype:
    """The plain versions' arithmetic: f64 for f64 inputs, else f32."""
    return torch.float64 if dtype == torch.float64 else torch.float32


class HeadPlanes(NamedTuple):
    """The service and name heads as the tensor-core kernel reads them."""
    w: torch.Tensor  # (3, V_tc, d) bf16: W_hi, W_mid, W_lo of the rows
    b: torch.Tensor  # (V_tc,) f32, -inf at the padding rows
    vs_pad: int      # service rows, padded: name rows start here
    v_s: int         # the real widths
    v_n: int


class VocabSlice(NamedTuple):
    """A shard's rows of the service and name heads: each head's whole
    width and this shard's first row (its own rows: its weights')."""
    vf: tuple[int, int]
    lo: tuple[int, int]


def whole_slice(heads: Heads) -> VocabSlice:
    """The unsliced heads as a slice (every shard holds them whole)."""
    return VocabSlice((heads[0][0].shape[0], heads[1][0].shape[0]), (0, 0))


def take_labels(labels: torch.Tensor, rows: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """``jnp.take_along_axis``'s fill mode on a head of ``rows`` logits:
    ``(row, takes)``, ``row`` the logit each label reads (0 where it reads
    none) and ``takes`` False where the label lies outside ``[-rows,
    rows)`` (its cross-entropy is NaN, its gradient dropped). The kernels'
    rule is ``csrc/embed_take.cuh`` ``take_label``."""
    i = labels.long()
    i = torch.where(i < 0, i + rows, i)
    takes = (i >= 0) & (i < rows)
    return torch.where(takes, i, 0), takes


def take_slice_labels(labels: torch.Tensor, vf: int, lo: int, rows: int
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A label read against the whole head of ``vf`` rows, then found in
    the slice ``[lo, lo + rows)``: ``(row, takes, owned)``, ``row`` the
    slice's row (0 where it holds none), ``takes`` the whole head's rule
    (:func:`take_labels`) and ``owned`` True where this slice holds the
    label. The kernels' rule is ``csrc/embed_take.cuh``
    ``take_slice_label``."""
    i, takes = take_labels(labels, vf)
    owned = takes & (i >= lo) & (i < lo + rows)
    return torch.where(owned, i - lo, 0), takes, owned


def _heads_out(y: torch.Tensor, heads: Heads, acc: torch.dtype,
               labels: torch.Tensor, vslice: VocabSlice):
    """The four heads' logits of ``y`` and each cross-entropy head's
    ``(lse, zl, has)``: ``torch.logsumexp``, the logit of the label's row
    (row 0's where the (slice of the) head holds none) and where it holds
    it."""
    logits = [F.linear(y, w.to(acc), b.to(acc)) for w, b in heads]
    out = []
    for h in range(3):
        z = logits[h]
        if h < 2:
            lab, _, has = take_slice_labels(labels[:, h], vslice.vf[h],
                                            vslice.lo[h], z.shape[1])
        else:
            lab, has = take_labels(labels[:, h], z.shape[1])
        out.append((torch.logsumexp(z, -1), z.gather(1, lab[:, None])[:, 0],
                    has))
    return logits, out


def _nan_where_not(has: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.where(has, x, torch.full_like(x, float("nan")))


def recon_ce_plain(dec: torch.Tensor, ln_weight: torch.Tensor,
                   ln_bias: torch.Tensor, heads: Heads,
                   categorical: torch.Tensor, continuous: torch.Tensor,
                   mask: torch.Tensor, loss_weights: Sequence[float],
                   span_map: Optional[torch.Tensor] = None, n_out: int = 0,
                   eps: float = LN_EPS, lse: Optional[torch.Tensor] = None):
    """The plain version, on the real positions only: the LayerNorm, four
    ``F.linear`` heads in f32 (f64 for f64 inputs: the gradient checks),
    three cross-entropies as the kernel takes them (``torch.logsumexp``
    less the label's logit) and the squared error, summed in the
    reference's order; ``lse`` gets the three log-sum-exps at the real
    positions, 0 elsewhere."""
    M = dec.shape[0]
    acc = _acc(dec.dtype)
    err = torch.zeros(M, dtype=acc, device=dec.device)
    real = torch.nonzero(mask).flatten()
    y = layer_norm_plain(dec[real], ln_weight, ln_bias, eps).to(acc)
    logits, ces = _heads_out(y, heads, acc, categorical[real].long(),
                             whole_slice(heads))
    if lse is not None:
        lse.zero_()
        lse[real] = torch.stack([c[0] for c in ces], -1).to(lse.dtype)
    w_s, w_n, w_k, w_d = (float(w) for w in loss_weights)
    # each cross-entropy as K11 takes it, lse - zl; NaN (and no gradient)
    # where the label takes no row
    ce = [_nan_where_not(has, l - zl) for l, zl, has in ces]
    dd = logits[3][:, 0] - continuous[real, 0].to(acc)
    e = w_s * ce[0]
    e = e + w_n * ce[1]
    e = e + w_k * ce[2]
    e = e + w_d * (dd * dd)
    err[real] = e
    if span_map is None:
        return err
    scores = torch.zeros(n_out, dtype=acc, device=dec.device)
    idx = span_map[real].long()
    keep = idx >= 0
    scores[idx[keep]] = 1.0 - torch.exp(-e[keep])
    return err, scores


def split_planes(heads: Heads) -> Optional[HeadPlanes]:
    """The service and name heads (``heads[0]``, ``heads[1]``) split into
    three bf16 planes: ``W_hi = bf16(W)``, ``W_mid = bf16(W - W_hi)``,
    ``W_lo = W - W_hi - W_mid`` (8 + 8 + 8 significant bits), each head's
    rows padded with zeros to a multiple of ``PLANE_PAD`` (bias -inf
    there); None if the planes do not sum to ``W`` bit for bit (a value
    outside the split's range: beyond bf16's largest, below ~2^-110, or
    not finite). Compares on the host: made once per weight tree."""
    ws, bs, pads = [], [], []
    with torch.no_grad():
        for w, b in heads[:2]:
            V, d = w.shape
            pad = -(-V // PLANE_PAD) * PLANE_PAD
            wp = torch.zeros((pad, d), dtype=torch.float32, device=w.device)
            wp[:V] = w
            bp = torch.full((pad,), float("-inf"), dtype=torch.float32,
                            device=w.device)
            bp[:V] = b
            ws.append(wp)
            bs.append(bp)
            pads.append(pad)
        W = torch.cat(ws)
        hi = W.to(torch.bfloat16)
        r = W - hi.float()
        mid = r.to(torch.bfloat16)
        lo = (r - mid.float()).to(torch.bfloat16)
        if not torch.equal((hi.float() + mid.float()) + lo.float(), W):
            return None
        return HeadPlanes(torch.stack([hi, mid, lo]).contiguous(),
                          torch.cat(bs), pads[0], heads[0][0].shape[0],
                          heads[1][0].shape[0])


def head_planes(heads: Heads) -> HeadPlanes:
    """:func:`split_planes`, raising where the split cannot hold the
    heads."""
    planes = split_planes(heads)
    if planes is None:
        raise ValueError("head weights outside the three-plane split's "
                         "range (not finite, beyond bf16's largest or "
                         "below ~2^-110): the tensor-core kernel would "
                         "not compute f32 logits")
    return planes


def kernel_route(dtype: torch.dtype, splittable: bool = True) -> str:
    """The kernel a CUDA tensor of this working type takes: ``"tc"`` (bf16
    whose heads :func:`split_planes` holds, tensor cores) or
    ``"cuda_core"`` (f32, or bf16 heads the split cannot hold)."""
    return "tc" if dtype == torch.bfloat16 and splittable else "cuda_core"


def tc_slices(count: int, d: int, v_tc: int, grid: int,
              part_items: int) -> int:
    """The slices S the bf16 kernel splits each tile of ``TILE`` real
    positions into (``plan_slices`` in csrc/recon_ce.cu, which the card
    computes from its own count; ``grid``: its persistent CTAs, one an
    SM): the fewest rounds of items over the grid, an item costing its
    columns plus ~1.5 ring stages, split tiles within the partials'
    room."""
    nt = 64 if d <= 128 else 32
    tiles, vt = -(-count // TILE), v_tc // nt
    best, best_cost = 1, None
    for s in range(1, min(vt, MAX_SLICES) + 1):
        if s > 1 and tiles * s > part_items:
            break
        cost = -(-tiles * s // grid) * (4 * -(-vt // s) + 6)
        if best_cost is None or cost < best_cost:
            best, best_cost = s, cost
    return best


def _kernel(name: str):
    """The function ``name`` (``recon_ce_f32_launch``, its
    ``recon_ce_f32_scratch`` and ``recon_ce_f32_counters``, or
    ``recon_ce_tc_launch``) of the built library."""
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(build.load("recon_ce"), name)
        if name in ("recon_ce_f32_scratch", "recon_ce_f32_counters"):
            fn.argtypes = [ctypes.c_longlong] + [ctypes.c_int] * (
                3 if name == "recon_ce_f32_scratch" else 0)
            fn.restype = ctypes.c_longlong
            _fns[name] = fn
            return fn
        if name == "recon_ce_f32_launch":
            fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                            ctypes.c_float]
                           + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                           + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                              ctypes.c_int, ctypes.c_void_p]
                           + [ctypes.c_float] * 4 + [ctypes.c_void_p] * 4
                           + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
                           + [ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                              ctypes.c_void_p])
        else:
            fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float,
                            ctypes.c_void_p, ctypes.c_void_p]
                           + [ctypes.c_int] * 4
                           + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_void_p, ctypes.c_void_p,
                              ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                              ctypes.c_int, ctypes.c_void_p]
                           + [ctypes.c_float] * 4 + [ctypes.c_void_p] * 3
                           + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 5
                           + [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
                              ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check(dec, ln_weight, ln_bias, heads, categorical, continuous, mask,
           loss_weights, span_map, n_out) -> None:
    if dec.dim() != 2:
        raise ValueError(f"dec must be (M, d), got {tuple(dec.shape)}")
    M, d = dec.shape
    for name, t in (("ln_weight", ln_weight), ("ln_bias", ln_bias)):
        if t.shape != (d,):
            raise ValueError(f"{name} must be ({d},), got {tuple(t.shape)}")
    if len(heads) != 4 or len(loss_weights) != 4:
        raise ValueError("recon_ce takes four heads and four loss weights "
                         "(service, name, kind, duration)")
    for i, (w, b) in enumerate(heads):
        if w.dim() != 2 or w.shape[1] != d or b.shape != (w.shape[0],) \
                or w.shape[0] < 1:
            raise ValueError(f"head {i}: weight must be (V, {d}) and bias "
                             f"(V,), got {tuple(w.shape)} {tuple(b.shape)}")
    if heads[3][0].shape[0] != 1:
        raise ValueError("the duration head has one output")
    if (categorical.dim() != 2 or categorical.shape[0] != M
            or categorical.shape[1] < 3 or categorical.dtype != torch.int32):
        raise ValueError(f"categorical must be ({M}, C >= 3) int32")
    if (continuous.dim() != 2 or continuous.shape[0] != M
            or continuous.dtype != torch.float32):
        raise ValueError(f"continuous must be ({M}, D) float32")
    if mask.shape != (M,) or mask.dtype != torch.bool:
        raise ValueError(f"mask must be ({M},) bool")
    if span_map is not None and (span_map.shape != (M,)
                                 or span_map.dtype != torch.int32):
        raise ValueError(f"span_map must be ({M},) int32")
    if n_out < 0:
        raise ValueError(f"n_out must be >= 0, got {n_out}")
    tensors = [dec, ln_weight, ln_bias, categorical, continuous, mask,
               *(t for pair in heads for t in pair)]
    if span_map is not None:
        tensors.append(span_map)
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")


def recon_ce(dec: torch.Tensor, ln_weight: torch.Tensor,
             ln_bias: torch.Tensor, heads: Heads, categorical: torch.Tensor,
             continuous: torch.Tensor, mask: torch.Tensor,
             loss_weights: Sequence[float],
             span_map: Optional[torch.Tensor] = None, n_out: int = 0,
             eps: float = LN_EPS, planes: Optional[HeadPlanes] = None,
             route: Optional[str] = None,
             lse: Optional[torch.Tensor] = None):
    """``(M,)`` f32 errors, and with ``span_map`` also the ``(n_out,)``
    squashed scores by span; see the module docstring. ``route``: the
    kernel (:func:`kernel_route`), by default the working type's;
    ``planes``: the tensor-core kernel's :func:`head_planes` of ``heads``
    (made here when None); ``lse``: an ``(M, 3)`` buffer for the
    log-sum-exps (the CUDA-core kernel only). Nothing is synchronised."""
    n_out = int(n_out)
    _check(dec, ln_weight, ln_bias, heads, categorical, continuous, mask,
           loss_weights, span_map, n_out)
    M = dec.shape[0]
    if lse is not None and (lse.shape != (M, 3) or lse.device != dec.device
                            or not lse.is_contiguous()):
        raise ValueError(f"lse must be a contiguous ({M}, 3) tensor on the "
                         f"inputs' device")
    dev = dec.device
    if dev.type == "cpu":
        return recon_ce_plain(dec, ln_weight, ln_bias, heads, categorical,
                              continuous, mask, loss_weights, span_map,
                              n_out, eps, lse)
    if dev.type != "cuda":
        raise ValueError(f"recon_ce runs on cuda or cpu, not {dev}")
    err = torch.empty(M, dtype=torch.float32, device=dev)
    scores = None
    if span_map is not None:
        scores = torch.zeros(n_out, dtype=torch.float32, device=dev)
    _launch_k11(dec, ln_weight, ln_bias, heads, categorical, continuous,
                mask, loss_weights, span_map, err, scores, eps, planes,
                route, lse, whole_slice(heads), None)
    return err if span_map is None else (err, scores)


def _launch_k11(dec, ln_weight, ln_bias, heads, categorical, continuous,
                mask, loss_weights, span_map, err, scores, eps, planes,
                route, lse, vslice: VocabSlice,
                rec: Optional[torch.Tensor]) -> None:
    """K11's checks on the card and its launch: the errors into ``err``
    (and ``scores``, ``lse``), or in slice mode (``rec``) the records."""
    global launches, tc_launches, device_launches, slice_launches
    dev = dec.device
    M = dec.shape[0]
    if dev.type != "cuda":
        raise ValueError(f"recon_ce runs on cuda or cpu, not {dev}")
    if dec.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dec must be float32 or bfloat16, not {dec.dtype}")
    params = (ln_weight, ln_bias, *(t for pair in heads for t in pair))
    if any(t.dtype != torch.float32 for t in params):
        raise TypeError("LayerNorm and head parameters must be float32")
    d = dec.shape[1]
    route = kernel_route(dec.dtype) if route is None else route
    if route not in ROUTES or (route == "tc" and dec.dtype != torch.bfloat16):
        raise ValueError(f"recon_ce route {route!r}: 'tc' (bf16) or "
                         f"'cuda_core'")
    tc = route == "tc"
    if lse is not None and (tc or lse.dtype != torch.float32):
        raise ValueError("recon_ce writes an f32 lse on the 'cuda_core' "
                         "route only")
    if d > MAX_D or d % (16 if tc else 4) or d == 0:
        raise ValueError(f"recon_ce takes d % {16 if tc else 4} == 0 up to "
                         f"{MAX_D} on the {route} route, not {d}")
    ins = (dec, categorical, continuous, mask, *params) + (
        (span_map,) if span_map is not None else ())
    if not all(t.is_contiguous() for t in ins):
        raise ValueError("recon_ce needs contiguous inputs")
    if M >= 2 ** 31:
        raise ValueError(f"recon_ce takes M < 2^31 on the card, not {M}")
    if tc:
        if heads[2][0].shape[0] > MAX_KIND:
            raise ValueError(f"the bf16 kernel takes a kind head of at most "
                             f"{MAX_KIND} outputs")
        if dec.data_ptr() % 16 or any(w.data_ptr() % 16
                                      for w, _ in heads[2:]):
            raise ValueError("recon_ce needs a 16-byte aligned dec and kind "
                             "and duration weights")
        planes = head_planes(heads) if planes is None else planes
        v_tc = planes.w.shape[1]
        if (planes.w.shape != (3, v_tc, d) or planes.w.dtype != torch.bfloat16
                or planes.b.shape != (v_tc,)
                or planes.b.dtype != torch.float32
                or (planes.v_s, planes.v_n) != (heads[0][0].shape[0],
                                                heads[1][0].shape[0])
                or planes.vs_pad % PLANE_PAD or v_tc % PLANE_PAD
                or not planes.w.is_contiguous() or planes.w.data_ptr() % 16
                or not planes.b.is_contiguous() or planes.b.data_ptr() % 16
                or {planes.w.device, planes.b.device} != {dev}):
            raise ValueError("planes are not head_planes(heads) on the "
                             "inputs' device")
    elif dec.data_ptr() % 16 or any(w.data_ptr() % 16 for w, _ in heads):
        raise ValueError("recon_ce needs a 16-byte aligned dec and head "
                         "weights")
    if M == 0:
        return
    (w0, b0), (w1, b1), (w2, b2), (w3, b3) = heads
    w_s, w_n, w_k, w_d = (float(w) for w in loss_weights)
    smap = None if span_map is None else span_map.data_ptr()
    out = None if scores is None else scores.data_ptr()
    e_ptr = None if err is None else err.data_ptr()
    r_ptr = None if rec is None else rec.data_ptr()
    (vf0, vf1), (lo0, lo1) = vslice
    cur = torch.cuda.current_stream(dev)
    stream = cur.cuda_stream
    count = ctypes.c_int(0)  # the kernels launched (the launcher's own)
    with torch.cuda.device(dev):
        if tc:
            sms = build.sm_count(dev)
            part_items = PART_ITEMS_PER_SM * sms
            lst = torch.empty(M, dtype=torch.int32, device=dev)
            # (mean, 1 / std) a listed position; off TC_WIDTHS also the
            # kind CE and the duration logit
            stats = torch.empty((2 if d in TC_WIDTHS else 4) * M,
                                dtype=torch.float32, device=dev)
            # the count and each split tile's finished slices, zeroed
            zeros = torch.zeros(2 + part_items // 2, dtype=torch.int32,
                                device=dev)
            part = torch.empty(part_items * 6 * TILE, dtype=torch.float32,
                               device=dev)
            rc = _kernel("recon_ce_tc_launch")(
                dec.data_ptr(), M, d, ln_weight.data_ptr(),
                ln_bias.data_ptr(), eps, planes.w.data_ptr(),
                planes.b.data_ptr(), planes.vs_pad, v_tc, planes.v_s,
                planes.v_n, w2.data_ptr(), b2.data_ptr(), w2.shape[0],
                w3.data_ptr(), b3.data_ptr(), categorical.data_ptr(),
                categorical.shape[1], continuous.data_ptr(),
                continuous.shape[1], mask.data_ptr(), w_s, w_n, w_k, w_d,
                e_ptr, smap, out, vf0, lo0, vf1, lo1, r_ptr, lst.data_ptr(),
                stats.data_ptr(), zeros.data_ptr(), part.data_ptr(),
                part.numel(), zeros.data_ptr() + 4, sms,
                ctypes.byref(count), stream)
        else:
            # int32 counters, left at zero by every call, and bytes
            cnt, scratch = build.stream_scratch(
                "recon_ce_f32", dev, cur,
                _kernel("recon_ce_f32_counters")(M), torch.int32,
                _kernel("recon_ce_f32_scratch")(M, w0.shape[0], w1.shape[0],
                                                w2.shape[0]),
                torch.uint8)
            rc = _kernel("recon_ce_f32_launch")(
                dec.data_ptr(), int(dec.dtype == torch.bfloat16), M, d,
                ln_weight.data_ptr(), ln_bias.data_ptr(), eps, w0.data_ptr(),
                w1.data_ptr(), w2.data_ptr(), w3.data_ptr(), b0.data_ptr(),
                b1.data_ptr(), b2.data_ptr(), b3.data_ptr(), w0.shape[0],
                w1.shape[0], w2.shape[0], w3.shape[0],
                categorical.data_ptr(), categorical.shape[1],
                continuous.data_ptr(), continuous.shape[1],
                mask.data_ptr(), w_s, w_n, w_k, w_d, e_ptr, smap, out,
                None if lse is None else lse.data_ptr(), vf0, lo0, vf1, lo1,
                r_ptr, cnt.data_ptr(), scratch.data_ptr(),
                build.sm_count(dev), ctypes.byref(count), stream)
            if rc != 0:  # the list kernel may have left its count
                build.drop_scratch("recon_ce_f32", dev, cur)
    if rc != 0:
        raise RuntimeError(f"recon_ce launch failed: CUDA error {rc}")
    with _count_lock:
        launches += 1
        tc_launches += int(tc)
        slice_launches += int(rec is not None)
        device_launches += count.value


def recon_ce_slice_plain(dec: torch.Tensor, ln_weight: torch.Tensor,
                         ln_bias: torch.Tensor, heads: Heads,
                         categorical: torch.Tensor, continuous: torch.Tensor,
                         mask: torch.Tensor, vslice: VocabSlice,
                         eps: float = LN_EPS) -> torch.Tensor:
    """K11 ``"slice"``'s plain version: the ``(M, REC)`` records (module
    docstring) at the real positions, 0 elsewhere, in f32 (f64 for f64
    inputs), the heads' logits as :func:`recon_ce_plain` takes them."""
    M = dec.shape[0]
    acc = _acc(dec.dtype)
    rec = torch.zeros((M, REC), dtype=acc, device=dec.device)
    real = torch.nonzero(mask).flatten()
    y = layer_norm_plain(dec[real], ln_weight, ln_bias, eps).to(acc)
    logits, ces = _heads_out(y, heads, acc, categorical[real].long(), vslice)
    dd = logits[3][:, 0] - continuous[real, 0].to(acc)
    (ls, zs, hs), (ln, zn, hn), (lk, zk, hk) = ces
    rec[real] = torch.stack(
        [ls, _nan_where_not(hs, zs), ln, _nan_where_not(hn, zn),
         _nan_where_not(hk, lk - zk), dd, lk, torch.zeros_like(dd)], -1)
    return rec


def _check_slice(heads: Heads, vslice: VocabSlice) -> None:
    for h in range(2):
        v, vf, lo = heads[h][0].shape[0], vslice.vf[h], vslice.lo[h]
        if lo < 0 or lo + v > vf:
            raise ValueError(f"head {h}: a slice of {v} rows from {lo} lies "
                             f"outside a head of {vf}")


def recon_ce_slice(dec: torch.Tensor, ln_weight: torch.Tensor,
                   ln_bias: torch.Tensor, heads: Heads,
                   categorical: torch.Tensor, continuous: torch.Tensor,
                   mask: torch.Tensor, vslice: VocabSlice,
                   eps: float = LN_EPS, planes: Optional[HeadPlanes] = None,
                   route: Optional[str] = None) -> torch.Tensor:
    """K11 ``"slice"``: this shard's ``(M, REC)`` f32 records (module
    docstring; padding rows unwritten), ``heads`` the shard's (its rows of
    the service and name heads with their bias rows, the whole kind and
    duration heads). ``route`` and ``planes`` as :func:`recon_ce`'s, the
    planes those of this shard's heads. Nothing is synchronised."""
    _check(dec, ln_weight, ln_bias, heads, categorical, continuous, mask,
           (0.0,) * 4, None, 0)
    _check_slice(heads, vslice)
    if dec.device.type == "cpu":
        return recon_ce_slice_plain(dec, ln_weight, ln_bias, heads,
                                    categorical, continuous, mask, vslice,
                                    eps)
    if dec.device.type != "cuda":
        raise ValueError(f"recon_ce runs on cuda or cpu, not {dec.device}")
    rec = torch.empty((dec.shape[0], REC), dtype=torch.float32,
                      device=dec.device)
    _launch_k11(dec, ln_weight, ln_bias, heads, categorical, continuous,
                mask, (0.0,) * 4, None, None, None, eps, planes, route, None,
                vslice, rec)
    return rec


def vocab_ce_merge_plain(rec: torch.Tensor, categorical: torch.Tensor,
                         mask: torch.Tensor, vf: Sequence[int],
                         vs: Sequence[int], loss_weights: Sequence[float],
                         lse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K24's plain version: the ``(M,)`` errors from the ``(tp, M, REC)``
    records in rank order (``vf``: the service and name heads' whole
    widths, ``vs``: a shard's slice of each, ``vs = vf`` for a whole
    head), the arithmetic in the kernel's order; ``lse`` gets the merged
    log-sum-exps at the real positions, 0 elsewhere."""
    M = mask.shape[0]
    err = torch.zeros(M, dtype=rec.dtype, device=rec.device)
    real = torch.nonzero(mask).flatten()
    r = rec[:, real]
    rows = torch.arange(real.numel(), device=rec.device)
    labels = categorical[real].long()
    lses, zls = [], []
    for h in range(2):
        parts = vf[h] // vs[h]
        if parts == 1:
            l = r[0, :, 2 * h]
        else:
            m = r[:parts, :, 2 * h].max(0).values
            s = torch.zeros_like(m)
            for i in range(parts):
                s = s + torch.exp(r[i, :, 2 * h] - m)
            l = m + torch.log(s)
        lab, takes = take_labels(labels[:, h], vf[h])
        zl = r[lab // vs[h], rows, 2 * h + 1]
        lses.append(l)
        zls.append(torch.where(takes, zl, torch.full_like(zl, float("nan"))))
    w_s, w_n, w_k, w_d = (float(w) for w in loss_weights)
    dd = r[0, :, 5]
    e = w_s * (lses[0] - zls[0])
    e = e + w_n * (lses[1] - zls[1])
    e = e + w_k * r[0, :, 4]
    e = e + w_d * (dd * dd)
    err[real] = e
    if lse is not None:
        lse.zero_()
        lse[real] = torch.stack([lses[0], lses[1], r[0, :, 6]], -1).to(
            lse.dtype)
    return err


def _merge_fn():
    fn = _fns.get("vocab_ce_merge_launch")
    if fn is None:
        fn = build.load("vocab_merge").vocab_ce_merge_launch
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
                       + [ctypes.c_int] * 4 + [ctypes.c_float] * 4
                       + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                          ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns["vocab_ce_merge_launch"] = fn
    return fn


def vocab_ce_merge(rec: torch.Tensor, categorical: torch.Tensor,
                   mask: torch.Tensor, vf: Sequence[int], vs: Sequence[int],
                   loss_weights: Sequence[float],
                   lse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K24: the ``(M,)`` f32 errors merged from the shards' ``(tp, M,
    REC)`` records (:func:`vocab_ce_merge_plain`'s arguments); ``lse``: an
    ``(M, 3)`` f32 buffer for the merged log-sum-exps (the trainer's).
    Nothing is synchronised."""
    global merge_launches
    M = mask.shape[0]
    if rec.dim() != 3 or rec.shape[1:] != (M, REC):
        raise ValueError(f"rec must be (tp, {M}, {REC}), got "
                         f"{tuple(rec.shape)}")
    tp = rec.shape[0]
    if (categorical.dim() != 2 or categorical.shape[0] != M
            or categorical.shape[1] < 2 or categorical.dtype != torch.int32):
        raise ValueError(f"categorical must be ({M}, C >= 2) int32")
    if mask.dtype != torch.bool or mask.dim() != 1:
        raise ValueError(f"mask must be ({M},) bool")
    for h in range(2):
        if vs[h] < 1 or vf[h] % vs[h] or vf[h] // vs[h] not in (1, tp):
            raise ValueError(f"head {h}: slices of {vs[h]} rows of a head "
                             f"of {vf[h]} on a model axis of {tp}")
    if lse is not None and (lse.shape != (M, 3) or not lse.is_contiguous()
                            or lse.device != rec.device):
        raise ValueError(f"lse must be a contiguous ({M}, 3) tensor on the "
                         f"records' device")
    if len({rec.device, categorical.device, mask.device}) != 1:
        raise ValueError("inputs on several devices")
    dev = rec.device
    if dev.type == "cpu":
        return vocab_ce_merge_plain(rec, categorical, mask, vf, vs,
                                    loss_weights, lse)
    if dev.type != "cuda":
        raise ValueError(f"vocab_ce_merge runs on cuda or cpu, not {dev}")
    if rec.dtype != torch.float32 or (lse is not None
                                      and lse.dtype != torch.float32):
        raise TypeError("vocab_ce_merge takes float32 records")
    if not all(t.is_contiguous() for t in (rec, categorical, mask)) \
            or rec.data_ptr() % 16:
        raise ValueError("vocab_ce_merge needs contiguous inputs and 16-byte "
                         "aligned records")
    err = torch.empty(M, dtype=torch.float32, device=dev)
    if M > 0:
        count = ctypes.c_int(0)
        with torch.cuda.device(dev):
            rc = _merge_fn()(
                rec.data_ptr(), tp, M, categorical.data_ptr(),
                categorical.shape[1], mask.data_ptr(), int(vf[0]),
                int(vs[0]), int(vf[1]), int(vs[1]),
                *(float(w) for w in loss_weights), err.data_ptr(),
                None if lse is None else lse.data_ptr(), build.sm_count(dev),
                ctypes.byref(count),
                torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"vocab_ce_merge launch failed: CUDA error "
                               f"{rc}")
        with _count_lock:
            merge_launches += count.value
    return err


# ------------------------------------------------------- K20: the backward
class HeadGrads(NamedTuple):
    """``recon_ce_bwd``'s result: the gradient at ``dec_ln``'s output and
    the four heads' ``(dW, db)`` in K11's order."""
    dy: torch.Tensor                               # (M, d), 0 at padding
    heads: list[tuple[torch.Tensor, torch.Tensor]]  # (V_h, d), (V_h,)


def recon_ce_bwd_plain(dec: torch.Tensor, ln_weight: torch.Tensor,
                       ln_bias: torch.Tensor, heads: Heads, lse: torch.Tensor,
                       categorical: torch.Tensor, continuous: torch.Tensor,
                       mask: torch.Tensor, derr: torch.Tensor,
                       loss_weights: Sequence[float],
                       eps: float = LN_EPS,
                       vslice: Optional[VocabSlice] = None,
                       dy_heads: int = 15) -> HeadGrads:
    """K20's plain version, on the real positions: ``y = dec_ln(dec)``,
    each head's logits by ``F.linear``, ``dlogit_h = (w_h derr) (softmax_h
    - onehot(label_h))`` with the softmax from ``lse`` (the forward's), 0
    where the label takes no row of the head (:func:`take_labels`), the
    duration's ``(w_d derr) 2 (pred - cont[:, 0])``; ``dy = sum_h dlogit_h
    W_h`` over the heads of ``dy_heads`` (bit h), ``dW_h = dlogit_h^T y``,
    ``db_h = sum dlogit_h`` (f64 for f64 inputs). ``vslice``: the service
    and name heads are that slice (module docstring): a label another
    shard's slice holds keeps the softmax and takes no onehot here."""
    _check(dec, ln_weight, ln_bias, heads, categorical, continuous, mask,
           loss_weights, None, 0)
    vslice = whole_slice(heads) if vslice is None else vslice
    _check_slice(heads, vslice)
    M, d = dec.shape
    acc = _acc(dec.dtype)
    real = torch.nonzero(mask).flatten()
    y = layer_norm_plain(dec[real], ln_weight, ln_bias, eps).to(acc)
    g = derr[real].to(acc)
    labels = categorical[real].long()
    dy_real = torch.zeros((real.numel(), d), dtype=acc, device=dec.device)
    grads = []
    for h, ((w, b), wt) in enumerate(zip(heads, loss_weights)):
        w, b = w.to(acc), b.to(acc)
        z = F.linear(y, w, b)
        coef = float(wt) * g
        if h < 3:
            p = torch.exp(z - lse[real, h, None].to(acc))
            if h < 2:
                lab, takes, owned = take_slice_labels(
                    labels[:, h], vslice.vf[h], vslice.lo[h], w.shape[0])
            else:
                lab, takes = take_labels(labels[:, h], w.shape[0])
                owned = takes
            rows = torch.arange(real.numel(), device=dec.device)
            p[rows[owned], lab[owned]] -= 1.0
            # a label past the head: zero dlogit there (jax.grad's)
            dl = p * torch.where(takes, coef, torch.zeros_like(coef))[:, None]
        else:
            cont = continuous[real, 0].to(acc)
            dl = (coef * (2.0 * (z[:, 0] - cont)))[:, None]
        if (dy_heads >> h) & 1:
            dy_real = dy_real + dl @ w
        grads.append((dl.t() @ y, dl.sum(0)))
    dy = torch.zeros((M, d), dtype=acc, device=dec.device)
    dy[real] = dy_real
    return HeadGrads(dy, grads)


def _bwd_kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(build.load("recon_ce_bwd"), name)
        if name == "recon_ce_bwd_slices":
            fn.argtypes = [ctypes.c_int] * 4
        elif name == "recon_ce_bwd_counters":
            fn.argtypes = [ctypes.c_longlong] + [ctypes.c_int] * 4
            fn.restype = ctypes.c_longlong
        elif name == "recon_ce_bwd_scratch":
            fn.argtypes = [ctypes.c_longlong] + [ctypes.c_int] * 5
            fn.restype = ctypes.c_longlong
        else:
            fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float]
                           + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                           + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                              ctypes.c_void_p]
                           + [ctypes.c_float] * 4 + [ctypes.c_int] * 5
                           + [ctypes.c_void_p] * 5
                           + [ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                              ctypes.c_void_p])
        if name in ("recon_ce_bwd_slices", "recon_ce_bwd_launch"):
            fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def recon_ce_bwd(dec: torch.Tensor, ln_weight: torch.Tensor,
                 ln_bias: torch.Tensor, heads: Heads, lse: torch.Tensor,
                 categorical: torch.Tensor, continuous: torch.Tensor,
                 mask: torch.Tensor, derr: torch.Tensor,
                 loss_weights: Sequence[float],
                 eps: float = LN_EPS, vslice: Optional[VocabSlice] = None,
                 dy_heads: int = 15) -> HeadGrads:
    """K20: the gradients of ``recon_ce``'s errors (module docstring), f32.
    ``lse``: the ``(M, 3)`` log-sum-exps K11 wrote in the forward (K24's
    merged ones in slice mode); ``derr``: ``(M,)`` the gradient of each
    position's error; ``vslice`` and ``dy_heads`` as the plain version's
    (slice mode: a shard of the model axis). Nothing is synchronised."""
    global bwd_launches, bwd_device_launches, bwd_slice_launches
    _check(dec, ln_weight, ln_bias, heads, categorical, continuous, mask,
           loss_weights, None, 0)
    vslice = whole_slice(heads) if vslice is None else vslice
    # the launcher's own rule: the slice mode's instantiation where the
    # heads are a slice or dy_heads leaves a head out
    sliced = (any(vslice.lo) or dy_heads != 15
              or list(vslice.vf) != [w.shape[0] for w, _ in heads[:2]])
    _check_slice(heads, vslice)
    if not 0 <= dy_heads <= 15:
        raise ValueError(f"dy_heads is a mask of the four heads, not "
                         f"{dy_heads}")
    M, d = dec.shape
    if lse.shape != (M, 3) or derr.shape != (M,):
        raise ValueError(f"lse must be ({M}, 3) and derr ({M},), got "
                         f"{tuple(lse.shape)} {tuple(derr.shape)}")
    if {lse.device, derr.device} != {dec.device}:
        raise ValueError("lse and derr must be on the inputs' device")
    dev = dec.device
    if dev.type == "cpu":
        return recon_ce_bwd_plain(dec, ln_weight, ln_bias, heads, lse,
                                  categorical, continuous, mask, derr,
                                  loss_weights, eps, vslice, dy_heads)
    if dev.type != "cuda":
        raise ValueError(f"recon_ce_bwd runs on cuda or cpu, not {dev}")
    params = (ln_weight, ln_bias, *(t for pair in heads for t in pair))
    if any(t.dtype != torch.float32 for t in (dec, lse, derr) + params):
        raise TypeError("recon_ce_bwd takes float32 (the trainer's type)")
    if d > MAX_D or d % 4 or d == 0:
        raise ValueError(f"recon_ce_bwd takes d % 4 == 0 up to {MAX_D}, "
                         f"not {d}")
    if M >= 2 ** 31:
        raise ValueError(f"recon_ce_bwd takes M < 2^31, not {M}")
    ins = (dec, categorical, continuous, mask, lse, derr, *params)
    if not all(t.is_contiguous() for t in ins):
        raise ValueError("recon_ce_bwd needs contiguous inputs")
    if dec.data_ptr() % 16 or any(w.data_ptr() % 16 for w, _ in heads):
        raise ValueError("recon_ce_bwd needs a 16-byte aligned dec and head "
                         "weights")
    vs = [w.shape[0] for w, _ in heads]
    V = sum(vs)
    if M == 0:
        return HeadGrads(
            torch.zeros((0, d), dtype=torch.float32, device=dev),
            [(torch.zeros((v, d), dtype=torch.float32, device=dev),
              torch.zeros(v, dtype=torch.float32, device=dev)) for v in vs])
    # the kernels write all three whole (dy's padding rows as zeros)
    dy = torch.empty((M, d), dtype=torch.float32, device=dev)
    dw = torch.empty((V, d), dtype=torch.float32, device=dev)
    db = torch.empty(V, dtype=torch.float32, device=dev)
    (w0, b0), (w1, b1), (w2, b2), (w3, b3) = heads
    launched = ctypes.c_int(0)  # the kernels launched (the launcher's own)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        # int32 counters, left at zero by every call, and bytes
        cnt, scratch = build.stream_scratch(
            "recon_ce_bwd", dev, stream,
            _bwd_kernel("recon_ce_bwd_counters")(M, *vs), torch.int32,
            _bwd_kernel("recon_ce_bwd_scratch")(M, d, *vs), torch.uint8)
        rc = _bwd_kernel("recon_ce_bwd_launch")(
            dec.data_ptr(), M, d, ln_weight.data_ptr(), ln_bias.data_ptr(),
            eps, w0.data_ptr(), w1.data_ptr(), w2.data_ptr(), w3.data_ptr(),
            b0.data_ptr(), b1.data_ptr(), b2.data_ptr(), b3.data_ptr(), *vs,
            lse.data_ptr(), categorical.data_ptr(), categorical.shape[1],
            continuous.data_ptr(), continuous.shape[1], mask.data_ptr(),
            derr.data_ptr(), *(float(w) for w in loss_weights),
            vslice.vf[0], vslice.lo[0], vslice.vf[1], vslice.lo[1], dy_heads,
            cnt.data_ptr(), scratch.data_ptr(), dy.data_ptr(),
            dw.data_ptr(), db.data_ptr(), build.sm_count(dev),
            ctypes.byref(launched), stream.cuda_stream)
        if rc != 0:  # a kernel may have left its counters
            build.drop_scratch("recon_ce_bwd", dev, stream)
    if rc != 0:
        raise RuntimeError(f"recon_ce_bwd launch failed: CUDA error {rc}")
    with _count_lock:
        bwd_launches += 1
        bwd_slice_launches += int(sliced)
        bwd_device_launches += launched.value
    return HeadGrads(dy, list(zip(torch.split(dw, vs), torch.split(db, vs))))

"""Host models of K22's, K17's, K16's and K18's kernels, on the CPU.

The CUDA kernels run only on the card; what their designs claim about
numbers and indices is checked here, in numpy, against the plain versions
(which the JAX package's own tests hold to the reference):

* K22 ``ring_block_attention`` (``csrc/ring_attention.cu``): the
  split-operand TF32 arithmetic (each f32 operand as hi + lo TF32 values,
  three products a pair) over key tiles with the kernel's online softmax,
  mask fill and zeroed weights, against ``ring_block_attention_plain``
  within the reference's 1e-5 of the plain output's largest magnitude, at
  head dims 4 to 256 with f32 and bf16 q; a plain TF32 product misses that
  bound (why the operands are split); the ``mma.sync.m16n8k8`` fragment
  indices the kernel loads from its shared tiles (q, the (hi, lo) K and V
  pairs at their pitches) and the key permutation that lets the score
  accumulators serve as P.V's A fragments, replayed lane by lane against
  plain matrix products; the tiles' pitches free of bank conflicts for
  every padded head dim;
* K17 ``ln_bwd`` (``csrc/ln_bwd.cu``): the grid plan (its constants read
  from the source), the scratch's layout, and the column sums taken in
  the kernel's order (rows grid-strided over warps, warps in order within
  a CTA, CTAs in order within a group of 16, groups in order) bit-equal
  to ``ln_bwd_plain``'s; the wrapper's cached scratch;
* K16 ``segment_attention_bwd`` (``csrc/segment_attention_bwd.cu``): each
  output's f32 chain in the one-CTA route's order (the live list's
  same-segment entries, padding queries only where some padding dO is
  nonzero) bit-equal to the parent's chain over every slot, and both
  within 1e-4 of ``segment_attention_bwd_plain``; the route's limit read
  from the source's constants; the tiled route's tile skip;
* K18 ``span_embed_bwd`` (``csrc/span_embed_bwd.cu``): the stable order
  built by all of a CTA's warps equal to the one-warp order, and the
  kernel's sums (runs a warp, cut rows' parts in run order) bit-equal to
  ``span_embed_bwd_plain``, with the attr table and ids past every table
  and below zero (taken as ``jnp.take``'s fill mode takes them).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from odigos_tpu_torch.kernels import attention, build, dense, embed, recon
from odigos_tpu_torch.kernels import ring as kring

CSRC = Path(kring.__file__).parent / "csrc"


class _Stream:
    """A stand-in for a CUDA stream: the scratch caches key on the handle."""

    def __init__(self, handle):
        self.cuda_stream = handle
RING_RTOL = 1e-5  # the reference's ring bound (tests/test_parallel.py)


def _const(source: str, name: str) -> int:
    text = (CSRC / source).read_text()
    found = re.search(rf"constexpr (?:int|bool|long long) {name} = (\w+);",
                      text)
    assert found, (source, name)
    val = found.group(1)
    return int(val == "true") if val in ("true", "false") else int(val)


# ------------------------------------------------------------------- K22
def _tf32(x: np.ndarray) -> np.ndarray:
    """``cvt.rna.tf32.f32``: 10 mantissa bits, to nearest, ties away."""
    b = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    b = ((b + 0x1000) & 0xFFFFE000).astype(np.uint32)
    return b.view(np.float32)


def _split(x: np.ndarray):
    hi = _tf32(x)
    return hi, _tf32(np.asarray(x, np.float32) - hi)


def _mm3(a: np.ndarray, b: np.ndarray, spec: str, split_a: bool = True):
    """a.b as the kernel takes it: a_lo.b_hi + a_hi.b_lo + a_hi.b_hi (the
    TF32 products exact, summed in f64 here, rounded to f32)."""
    ah, al = _split(a)
    bh, bl = _split(b)
    out = (np.einsum(spec, ah.astype(np.float64), bl.astype(np.float64))
           + np.einsum(spec, ah.astype(np.float64), bh.astype(np.float64)))
    if split_a:
        out += np.einsum(spec, al.astype(np.float64), bh.astype(np.float64))
    return out.astype(np.float32)


def _k22_model(q, k, v, mask, o, m, s, scale, finalize, KT, q_bf16,
               split=True):
    """The kernel's algorithm on (B, Lq, H, D) numpy arrays (o, m, s
    updated copies returned): key tiles of KT, the score by split products
    (a bf16 q has no lo term), the online softmax with the -1e30 fill and
    masked weights zeroed, P split for P.V."""
    o, m, s = o.copy(), m.copy(), s.copy()
    Lk = k.shape[1]
    neg = np.float32(kring.NEG_INF)
    for kt0 in range(0, Lk, KT):
        kt = slice(kt0, min(Lk, kt0 + KT))
        allowed = mask[:, None, None, kt]
        if split:
            sc = _mm3(q, k[:, kt], "bqhd,bkhd->bhqk", split_a=not q_bf16)
        else:
            sc = np.einsum("bqhd,bkhd->bhqk", _tf32(q).astype(np.float64),
                           _tf32(k[:, kt]).astype(np.float64)
                           ).astype(np.float32)
        x = np.where(allowed, sc * np.float32(scale), neg)
        mn = np.maximum(m, x.max(-1))
        p = np.where(allowed, np.exp(x - mn[..., None]), np.float32(0))
        al = np.exp(m - mn)
        s = s * al + p.sum(-1, dtype=np.float32)
        m = mn
        if split:
            pv = _mm3(p, v[:, kt], "bhqk,bkhd->bqhd")
        else:
            pv = np.einsum("bhqk,bkhd->bqhd", _tf32(p).astype(np.float64),
                           _tf32(v[:, kt]).astype(np.float64)
                           ).astype(np.float32)
        o = o * al.transpose(0, 2, 1)[..., None] + pv
    if finalize:
        o = o / np.maximum(s, np.float32(kring.SUM_FLOOR)).transpose(
            0, 2, 1)[..., None]
    return o, m, s


def _ring_case(B, Lq, Lk, H, D, q_bf16, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Lq, H, D)).astype(np.float32)
    if q_bf16:
        q = torch.from_numpy(q).bfloat16().float().numpy()
    blocks = []
    for i in range(3):
        k = (rng.standard_normal((B, Lk, H, D)) * 2).astype(np.float32)
        v = rng.standard_normal((B, Lk, H, D)).astype(np.float32)
        mask = rng.random((B, Lk)) > 0.2
        if i == 0:
            mask[:] = False  # a block all masked first
        if i == 2:
            mask[1] = False  # a trace all masked in the last
        blocks.append((k, v, mask))
    return q, blocks


def _ring_state(B, Lq, H, D):
    return (np.zeros((B, Lq, H, D), np.float32),
            np.full((B, H, Lq), kring.NEG_INF, np.float32),
            np.zeros((B, H, Lq), np.float32))


def _kt(D: int) -> int:
    return 64 if D <= 64 else 32 if D <= 128 else 16


@pytest.mark.parametrize("D", [4, 8, 60, 64, 128, 256])
@pytest.mark.parametrize("q_bf16", [False, True])
@pytest.mark.parametrize("finalize", [False, True])
def test_k22_split_tf32_model_matches_plain(D, q_bf16, finalize):
    B, Lq, Lk, H = 2, 40, 200, 2
    q, blocks = _ring_case(B, Lq, Lk, H, D, q_bf16, seed=D)
    got = _ring_state(B, Lq, H, D)
    ref = tuple(torch.from_numpy(t.copy()) for t in got)
    qt = torch.from_numpy(q)
    if q_bf16:
        qt = qt.bfloat16()
    for i, (k, v, mask) in enumerate(blocks):
        last = finalize and i == 2
        got = _k22_model(q, k, v, mask, *got, D ** -0.5, last, _kt(D),
                         q_bf16)
        kring.ring_block_attention_plain(
            qt, torch.from_numpy(k), torch.from_numpy(v),
            torch.from_numpy(mask), *ref, finalize=last)
    for g, r in zip(got, ref):
        r = r.numpy()
        assert np.isfinite(g).all()
        top = max(np.abs(r).max(), 1e-30)
        assert np.abs(g - r).max() / top <= RING_RTOL


def test_k22_plain_tf32_misses_the_bound():
    """The premise of the split: one TF32 product a pair (10 mantissa
    bits) does not hold the reference's 1e-5 on f32 operands."""
    B, Lq, Lk, H, D = 2, 40, 200, 2, 64
    q, blocks = _ring_case(B, Lq, Lk, H, D, False, seed=1)
    k, v, mask = blocks[1]
    ref = tuple(torch.from_numpy(t) for t in _ring_state(B, Lq, H, D))
    kring.ring_block_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(mask), *ref, finalize=True)
    one = _k22_model(q, k, v, mask, *_ring_state(B, Lq, H, D), D ** -0.5,
                     True, 64, False, split=False)
    top = ref[0].abs().max().item()
    assert np.abs(one[0] - ref[0].numpy()).max() / top > RING_RTOL


# the m16n8k8 TF32 fragments (PTX ISA, mma.m16n8k8 .tf32): lane = 4 g + t
def _a_frag_matrix(frags):
    """A (16 x 8) from each lane's (a0, a1, a2, a3)."""
    a = np.zeros((16, 8))
    for lane, f in enumerate(frags):
        g, t = lane >> 2, lane & 3
        a[g, t], a[g + 8, t], a[g, t + 4], a[g + 8, t + 4] = f
    return a


def _b_frag_matrix(frags):
    """B (8 x 8, k x n) from each lane's (b0, b1)."""
    b = np.zeros((8, 8))
    for lane, (b0, b1) in enumerate(frags):
        g, t = lane >> 2, lane & 3
        b[t, g], b[t + 4, g] = b0, b1
    return b


def _c_frags(c):
    """Each lane's (c0, c1, c2, c3) of C (16 x 8)."""
    out = []
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        out.append((c[g, 2 * t], c[g, 2 * t + 1], c[g + 8, 2 * t],
                    c[g + 8, 2 * t + 1]))
    return out


@pytest.mark.parametrize("D", [8, 24, 64])
def test_k22_fragment_indices_replayed_lane_by_lane(D):
    """One warp's 16 query rows against a 64-key tile, with the kernel's
    own shared-memory indexing: S = Q K^T through the score fragments, then
    S as P through the permuted P.V fragments, equal to the matrix
    products (f64, no rounding)."""
    rng = np.random.default_rng(D)
    KT, dp = 64, (D + 7) // 8 * 8
    ldq, ldk, ldv = dp + 4, dp + 4, dp + 2
    Q = rng.standard_normal((16, dp))
    K = rng.standard_normal((KT, dp))
    V = rng.standard_normal((KT, dp))
    qs = np.zeros(16 * ldq)
    ks = np.zeros(KT * ldk)
    vs = np.zeros(KT * ldv)
    for r in range(16):
        qs[r * ldq:r * ldq + dp] = Q[r]
    for j in range(KT):
        ks[j * ldk:j * ldk + dp] = K[j]
        vs[j * ldv:j * ldv + dp] = V[j]
    sc = [[[0.0] * 4 for _ in range(KT // 8)] for _ in range(32)]
    for kk in range(dp // 8):
        a = []
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            qa = g * ldq + 8 * kk + t
            a.append((qs[qa], qs[qa + 8 * ldq], qs[qa + 4],
                      qs[qa + 8 * ldq + 4]))
        A = _a_frag_matrix(a)
        for j in range(KT // 8):
            b = []
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                kr = (8 * j + g) * ldk + 8 * kk + t
                b.append((ks[kr], ks[kr + 4]))
            C = A @ _b_frag_matrix(b)
            for lane, c in enumerate(_c_frags(C)):
                sc[lane][j] = [x + y for x, y in zip(sc[lane][j], c)]
    S = np.zeros((16, KT))
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for j in range(KT // 8):
            c = sc[lane][j]
            S[g, 8 * j + 2 * t], S[g, 8 * j + 2 * t + 1] = c[0], c[1]
            S[g + 8, 8 * j + 2 * t], S[g + 8, 8 * j + 2 * t + 1] = c[2], c[3]
    np.testing.assert_allclose(S, Q @ K.T, rtol=1e-12, atol=1e-12)
    acc = [[[0.0] * 4 for _ in range(dp // 8)] for _ in range(32)]
    for j in range(KT // 8):
        A = _a_frag_matrix([(c[0], c[2], c[1], c[3])
                            for c in (sc[lane][j] for lane in range(32))])
        for n in range(dp // 8):
            b = []
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                vr = (8 * j + 2 * t) * ldv + g + 8 * n
                b.append((vs[vr], vs[vr + ldv]))
            C = A @ _b_frag_matrix(b)
            for lane, c in enumerate(_c_frags(C)):
                acc[lane][n] = [x + y for x, y in zip(acc[lane][n], c)]
    O = np.zeros((16, dp))
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for n in range(dp // 8):
            c = acc[lane][n]
            O[g, 8 * n + 2 * t], O[g, 8 * n + 2 * t + 1] = c[0], c[1]
            O[g + 8, 8 * n + 2 * t], O[g + 8, 8 * n + 2 * t + 1] = c[2], c[3]
    np.testing.assert_allclose(O, S @ V, rtol=1e-12, atol=1e-10)


def test_k22_tile_pitches_are_free_of_bank_conflicts():
    """Every fragment load of the kernel hits distinct banks: q's 4-byte
    loads across the warp, the K and V (hi, lo) pairs' 8-byte loads across
    each half-warp (16 lanes, 16 two-bank pairs), at each padded head
    dim."""
    for dp in range(8, 257, 8):
        ldq, ldk, ldv = dp + 4, dp + 4, dp + 2
        q_banks = {((l >> 2) * ldq + (l & 3)) % 32 for l in range(32)}
        assert len(q_banks) == 32, dp
        for half in (range(16), range(16, 32)):
            k_pairs = {((l >> 2) * ldk + (l & 3)) % 16 for l in half}
            v_pairs = {(2 * (l & 3) * ldv + (l >> 2)) % 16 for l in half}
            assert len(k_pairs) == 16 and len(v_pairs) == 16, dp


def test_k22_shared_memory_fits_the_design():
    """The source's tiles at each head-dim bucket's widest D fit the
    card's 227 KB a block, two CTAs an SM at D <= 128 and one of twice the
    warps past it."""
    mt = _const("ring_attention.cu", "kMTiles64")
    kt = _const("ring_attention.cu", "kKeyTile64")
    warps = _const("ring_attention.cu", "kWarps")

    def smem(D, KT, MT, W=warps):
        dp = (D + 7) // 8 * 8
        return (16 * MT * W * (dp + 4) * 4 + KT * (dp + 4) * 8
                + KT * (dp + 2) * 8 + KT * 4)

    assert 2 * (smem(64, kt, mt) + 1024) <= 233472
    assert 2 * (smem(128, 32, 1) + 1024) <= 233472
    assert smem(256, 16, 1, 2 * warps) <= 232448


# ------------------------------------------------------------------- K17
def _k17_plan(rows: int, sms: int) -> dict:
    warps = _const("ln_bwd.cu", "kThreads") // 32
    rpw = _const("ln_bwd.cu", "kRowsPerWarp")
    per_sm = _const("ln_bwd.cu", "kCtasPerSm")
    group = _const("ln_bwd.cu", "kGroup")
    ctas = min(-(-rows // (warps * rpw)), sms * per_sm)
    groups = -(-ctas // group)
    lead = (1 + -(-(sms * per_sm) // group) + 3) // 4
    return {"warps": warps, "ctas": ctas, "group": group,
            "groups": groups, "lead": lead,
            "groups_max": -(-(sms * per_sm) // group)}


@pytest.mark.parametrize("rows", [1, 63, 2048, 50000])
def test_k17_grid_plan(rows):
    """At the trainers' 2048 rows every one of the H100's 132 SMs gets a
    CTA; the counters (top ticket and one a group) fit the scratch's lead
    rows at any d; the scratch counts every partial and group sum."""
    p = _k17_plan(rows, 132)
    if rows >= 2048:
        assert p["ctas"] >= 132
    assert p["ctas"] >= 1 and p["ctas"] * p["warps"] <= max(rows, 4)
    assert 4 * p["lead"] >= 1 + p["groups_max"]  # 4 d uint32 a row, d >= 1
    assert p["groups"] <= p["groups_max"]


def _k17_model_sums(x, w, dy, sms: int):
    """dgamma, dbeta in the kernel's order: rows grid-strided over warps,
    each warp's f64 sums, warps added in order into the CTA's partial,
    CTAs in order within each group of 16, groups in order, rounded once."""
    rows, d = x.shape
    p = _k17_plan(rows, sms)
    xt, wt, et = (torch.from_numpy(a) for a in (x, w, dy))
    # xh as the kernel computes it: K14's statistics (the plain version's)
    xf = xt.double()
    mean = (xf.sum(-1, keepdim=True).float() / d)
    dev = xt - mean
    var = (dev * dev).double().sum(-1, keepdim=True).float() / d
    rstd = torch.ones_like(var) / torch.sqrt(var + dense.LN_EPS)
    xh = dev * rstd
    tg = (et * xh).double().numpy()
    tb = et.double().numpy()
    W = p["ctas"] * p["warps"]
    parts = []
    for cta in range(p["ctas"]):
        red = np.zeros((2, d))
        for warp in range(p["warps"]):
            acc = np.zeros((2, d))
            for r in range(cta * p["warps"] + warp, rows, W):
                acc[0] += tg[r]
                acc[1] += tb[r]
            red = red + acc
        parts.append(red)
    gsums = []
    for gi in range(p["groups"]):
        a = np.zeros((2, d))
        for part in parts[gi * p["group"]:(gi + 1) * p["group"]]:
            a = a + part
        gsums.append(a)
    top = np.zeros((2, d))
    for a in gsums:
        top = top + a
    return top.astype(np.float32)


@pytest.mark.parametrize("rows,d", [(1, 1), (63, 33), (2048, 128),
                                    (2048, 256), (5000, 96)])
def test_k17_column_sums_in_kernel_order_match_plain(rows, d):
    rng = np.random.default_rng(rows + d)
    x = (rng.standard_normal((rows, d)) * 3 + 1).astype(np.float32)
    dy = rng.standard_normal((rows, d)).astype(np.float32)
    w = rng.standard_normal(d).astype(np.float32)
    if rows > 1:
        x[-1] = dy[-1] = 0.0  # a padding row
    _, dw, db = dense.ln_bwd_plain(torch.from_numpy(x), torch.from_numpy(w),
                                   torch.from_numpy(dy))
    got = _k17_model_sums(x, w, dy, sms=132)
    assert torch.equal(torch.from_numpy(got[0]), dw)
    assert torch.equal(torch.from_numpy(got[1]), db)


def test_k17_scratch_is_cached_zeroed_and_grown():
    """The wrapper's scratch: zeros when made, the same buffer while it is
    large enough (the kernel leaves its counters at zero), a new zeroed
    one when a call needs more, one per (device, stream)."""
    dev = torch.device("cpu")
    saved = dict(build._scratch)
    build._scratch.clear()
    try:
        a = dense._ln_bwd_part(dev, _Stream(1), 64)
        assert a.dtype == torch.float64 and (a == 0).all()
        a[:4] = 7.0  # what a launch leaves past the counters
        assert dense._ln_bwd_part(dev, _Stream(1), 32) is a
        b = dense._ln_bwd_part(dev, _Stream(1), 128)
        assert b is not a and b.numel() == 128 and (b == 0).all()
        c = dense._ln_bwd_part(dev, _Stream(2), 16)
        assert c is not b
        with pytest.raises(RuntimeError, match="SM count"):
            dense._ln_bwd_part(dev, _Stream(1), -2)
    finally:
        build._scratch.clear()
        build._scratch.update(saved)


# ------------------------------------------------------------------- K16
# f32 fmaf on the host: the f64 product of two f32 values is exact, so one
# f64 add and the cast give the f32 chain both orders below share
def _fma(a, b, c):
    return (np.asarray(a, np.float64) * b + c).astype(np.float32)


def _pitch(hd: int) -> int:
    """``row_pitch`` of ``csrc/segment_attention_bwd.cu``."""
    hp = (hd + 3) & ~3
    return hp if hp % 8 == 4 else hp + 4


def _k16_inputs(R, L, H, hd, seed, padding_do):
    """Rows of several segments (contiguous, then one interleaved row), an
    all-padding last row; dO zero at padding slots, or not; O and the LSE
    from the plain forward."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((R, L, H, hd)).astype(np.float32)
                   for _ in range(4))
    seg = np.zeros((R, L), np.int32)
    for r in range(R - 1):
        n = 1 + (r * 7 + L // 2) % L
        seg[r, :n] = np.arange(n) // max(1, n // 3) + 1
    seg[0, : L - 3] = np.arange(L - 3) % 3 + 1  # interleaved segments
    if not padding_do:
        do = do * (seg > 0)[..., None, None]
    lse = torch.empty(R, H, L)
    o = attention.segment_attention_plain(
        *(torch.from_numpy(t) for t in (q, k, v, seg)), lse)
    return q, k, v, seg, o.numpy(), lse.numpy(), do.astype(np.float32)


def _k16_model(q, k, v, seg, o, lse, do, kernel_order: bool):
    """(dq, dk, dv) as one f32 chain each: the parent's order over every
    slot (``kernel_order`` False), or the redesign's, which leaves out the
    masked pairs and, where no padding query's dO is nonzero, the padding
    queries (one-CTA route: the live list's same-segment entries)."""
    R, L, H, hd = q.shape
    sd = np.float32(attention._scale_div(hd, torch.float32))
    Q, K, V, O, DO = (t.transpose(0, 2, 1, 3) for t in (q / sd, k, v, o, do))
    S = np.zeros((R, H, L, L), np.float32)
    DP = np.zeros_like(S)
    for d in range(hd):
        S = _fma(Q[..., :, None, d], K[..., None, :, d], S)
        DP = _fma(DO[..., :, None, d], V[..., None, :, d], DP)
    live = seg > 0
    allowed = ((seg[:, :, None] == seg[:, None, :])
               & live[:, :, None])[:, None]
    with np.errstate(over="ignore"):  # masked pairs, dropped below
        e = np.exp((S - lse[..., None]).astype(np.float32))
    P = np.where(allowed, e, np.float32(0)).astype(np.float32)
    P = np.where(live[:, None, :, None], P,
                 np.float32(1) / np.float32(L)).astype(np.float32)
    prod = (DO * O).astype(np.float32)  # __fmul_rn
    lanes = np.zeros((R, H, L, 32))
    for d in range(hd):  # lane d % 32 adds d, d + 32, ... in order
        lanes[..., d % 32] += prod[..., d].astype(np.float64)
    for x in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[..., np.arange(32) ^ x]
    delta = lanes[..., 0].astype(np.float32)
    DS = np.where(allowed, P * (DP - delta[..., None]),
                  np.float32(0)).astype(np.float32)
    pad_nz = ((~live)[:, None, :] & (DO != 0).any(-1)).any(-1)  # (R, H)
    dq = np.zeros((R, H, L, hd), np.float32)
    dk = np.zeros_like(dq)
    dv = np.zeros_like(dq)
    for j in range(L):  # dq over keys ascending
        t = _fma(DS[..., :, j, None], K[..., j, None, :], dq)
        dq = np.where(allowed[..., :, j, None], t, dq) if kernel_order else t
    for i in range(L):  # dk, dv over queries ascending
        tk = _fma(DS[..., i, :, None], Q[..., i, None, :], dk)
        tv = _fma(P[..., i, :, None], DO[..., i, None, :], dv)
        if kernel_order:
            tk = np.where(allowed[..., i, :, None], tk, dk)
            keep = allowed[..., i, :, None] | (
                ~live[:, None, i, None, None] & pad_nz[..., None, None])
            tv = np.where(keep, tv, dv)
        dk, dv = tk, tv
    dq = (dq / sd).astype(np.float32)
    return tuple(t.transpose(0, 2, 1, 3) for t in (dq, dk, dv))


@pytest.mark.parametrize("L,H,hd", [(32, 4, 64), (32, 2, 64), (33, 2, 12),
                                    (64, 1, 8)])
@pytest.mark.parametrize("padding_do", [False, True])
def test_k16_kernel_order_is_bit_equal_to_the_parent_order(L, H, hd,
                                                           padding_do):
    """K16's redesign leaves out only exactly-zero terms (masked pairs,
    padding queries whose dO is zero): every output bit-equal to the
    parent's chain over every slot, on rows of several segments, an
    interleaved row, an all-padding row, padding dO zero and nonzero; both
    within the card's 1e-4 of ``segment_attention_bwd_plain``."""
    ins = _k16_inputs(5, L, H, hd, seed=L * hd + padding_do,
                      padding_do=padding_do)
    parent = _k16_model(*ins, kernel_order=False)
    new = _k16_model(*ins, kernel_order=True)
    ref = attention.segment_attention_bwd_plain(
        *(torch.from_numpy(np.ascontiguousarray(t)) for t in ins))
    for a, b, r, what in zip(parent, new, ref, ("dq", "dk", "dv")):
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32)), what
        lim = 1e-4 * r.abs().max().item()
        assert np.abs(b - r.numpy()).max() <= lim, what
    if not padding_do:  # the trainers' path: padding rows exactly zero
        pad = ins[3] == 0
        for t in new:
            assert (t[pad] == 0).all()


def test_k16_one_cta_limit_and_routes_read_from_the_source():
    """The one-CTA route's limit (the source's constants, the wrapper's):
    its staged tiles, P and dS fit a CTA's shared memory at the limit, the
    trainers' (L 32, hd 64) take it at four CTAs an SM; past the limit, at
    hd % 4 != 0 or off 16 bytes the tiled route; pitches are an odd count
    of 16-byte vectors (conflict-free) at every hd."""
    src = "segment_attention_bwd.cu"
    one_l, one_hd = _const(src, "kOneMaxL"), _const(src, "kOneMaxHd")
    assert (one_l, one_hd) == (attention.BWD_ONE_CTA_MAX_L,
                               attention.BWD_ONE_CTA_MAX_HD)
    dyn = _const(src, "kDynLimit")

    def one_smem(L, hd):
        ld = _pitch(hd)
        return (5 * L * ld + 2 * L * (L + 1) + 2 * L) * 4 + 4 * L * 4

    assert one_smem(one_l, one_hd) <= dyn
    assert 4 * (one_smem(32, 64) + 1024) <= 233472  # 228 KB an SM
    t = torch.empty(64)
    for L, hd, want in [(32, 64, "one_cta"), (1, 4, "one_cta"),
                        (64, 128, "one_cta"), (65, 64, "tiled"),
                        (32, 132, "tiled"), (32, 66, "tiled"),
                        (128, 128, "tiled")]:
        assert attention.bwd_route(L, hd, t) == want, (L, hd)
    assert attention.bwd_route(32, 64, t[1:]) == "tiled"
    for hd in range(1, attention.MAX_HD + 1):
        ld = _pitch(hd)
        assert ld >= hd and ld % 4 == 0 and (ld // 4) % 2 == 1


def test_k16_tiled_plan_fits_and_skips_only_dead_tile_pairs():
    """The tiled route: every instance's shared memory at L 1024 fits; a
    tile pair its segment ranges call dead holds no allowed pair."""
    src = "segment_attention_bwd.cu"
    dyn, max_tiles = _const(src, "kDynLimit"), _const(src, "kMaxTiles")
    for B, G in ((32, 1), (64, 1), (32, 2), (32, 4)):
        ld = _pitch(64 * G)
        smem = ((4 * B * ld + 2 * B * (B + 1) + 2 * B) * 4 + 1024 * 4
                + 3 * max_tiles * 4)
        assert smem <= dyn, (B, G)
        assert 1024 // B <= max_tiles
    rng = np.random.default_rng(3)
    for _ in range(50):
        L, B = int(rng.integers(33, 300)), int(rng.choice([32, 64]))
        seg = np.sort(rng.integers(0, 12, L)).astype(np.int32)
        rng.shuffle(seg[: L // 3])  # some rows are not sorted
        nt = -(-L // B)
        rng_lo, rng_hi = [], []
        for t in range(nt):
            s = seg[t * B:(t + 1) * B]
            s = s[s > 0]
            rng_lo.append(s.min() if s.size else 1 << 30)
            rng_hi.append(s.max() if s.size else 0)
        for a in range(nt):
            for b in range(nt):
                qa, kb = seg[a * B:(a + 1) * B], seg[b * B:(b + 1) * B]
                live_pair = bool(((qa[:, None] == kb[None, :])
                                  & (qa[:, None] > 0)).any())
                overlap = (rng_lo[a] <= rng_hi[a] and rng_lo[b] <= rng_hi[b]
                           and rng_lo[a] <= rng_hi[b]
                           and rng_lo[b] <= rng_hi[a])
                assert overlap or not live_pair


# ------------------------------------------------------------------- K18
def _k18_tables(d, attr, seed):
    rng = np.random.default_rng(seed)

    def tab(n):
        return torch.from_numpy(rng.standard_normal((n, d)).astype(
            np.float32))

    return embed.EmbedTables(
        service=tab(100), name=tab(70), kind=tab(8), status=tab(4),
        attr=tab(10) if attr else None, cont_w=tab(d).T[:, :3].contiguous()
        if False else torch.zeros(d, 3), cont_b=torch.zeros(d),
        pos=tab(32))


def _k18_inputs(R, L, d, attr_slots, seed):
    """Ids past every table and below zero (some wrapped, some dropped),
    a status column nearly all one row (the hot row), padding slots and an
    all-padding row."""
    rng = np.random.default_rng(seed)
    C = embed.N_BASE_FIELDS + attr_slots
    cat = rng.integers(-3, 120, (R, L, C)).astype(np.int32)
    cat[..., 3] = np.where(rng.random((R, L)) < 0.9, 1, cat[..., 3])
    pos = np.broadcast_to(np.arange(L, dtype=np.int32) + 2, (R, L)).copy()
    seg = (rng.random((R, L)) < 0.4).astype(np.int32) * rng.integers(
        1, 4, (R, L)).astype(np.int32)
    seg[-1] = 0
    dy = rng.standard_normal((R, L, d)).astype(np.float32)
    return dy, cat, pos, seg


def _k18_entry_ids(cat, pos, seg, spec):
    """Each entry's row id (-1 at a padding slot and where the id takes no
    row: ``jnp.take``'s fill mode, a negative id wrapped, a position held
    into its table) and slot, in entry order: column by column, slots
    ascending."""
    _, tab, id_rows, first, step, ncols, use_pos = spec
    N = seg.size
    live = seg.reshape(-1) > 0
    cols = [pos.reshape(-1)] if use_pos else [
        cat.reshape(N, -1)[:, first + j * step] for j in range(ncols)]
    if use_pos:
        ids = np.clip(cols[0], 0, id_rows - 1)
    else:
        ids = np.concatenate(cols).astype(np.int64)
        ids = np.where(ids < 0, ids + id_rows, ids)
        ids = np.where((ids >= 0) & (ids < id_rows), ids, -1)
    ids = np.where(np.tile(live, len(cols)), ids, -1)
    return ids, np.tile(np.arange(N), len(cols))


def _k18_cta_list(ids, slots, r0, nrows, warps):
    """The kernel's sort for the CTA of rows [r0, r0 + nrows): per-warp
    counts of contiguous entry chunks, an exclusive scan over (row, warp),
    the fill; and the count of entries below r0."""
    E = ids.size
    chunk = -(-E // warps)
    counts = np.zeros((nrows, warps), np.int64)
    in_blk = (ids >= r0) & (ids < r0 + nrows)
    for w in range(warps):
        sel = ids[w * chunk:(w + 1) * chunk]
        sel = sel[(sel >= r0) & (sel < r0 + nrows)] - r0
        np.add.at(counts[:, w], sel, 1)
    place = (np.cumsum(counts.reshape(-1)) - counts.reshape(-1)).reshape(
        nrows, warps)
    out = np.full(int(in_blk.sum()), -1, np.int64)
    for w in range(warps):
        for e in range(w * chunk, min(E, (w + 1) * chunk)):
            if in_blk[e]:
                row = ids[e] - r0
                out[place[row, w]] = slots[e]
                place[row, w] += 1
    below = int(((ids >= 0) & (ids < r0)).sum())
    rstart = np.concatenate([[0], np.cumsum(counts.sum(1))])
    return out, below, rstart


def _k18_model(dy, cat, pos, seg, tables):
    """Each table's gradient as the kernel sums it: the CTA's list cut
    into a run a warp, f64 sums in list order, whole rows rounded once,
    cut rows' parts added in run order by the run holding the row's first
    entry."""
    warps = _const("span_embed_bwd.cu", "kThreads") // 32
    rows_cta = _const("span_embed_bwd.cu", "kRows")
    d = dy.shape[-1]
    flat = dy.reshape(-1, d).astype(np.float64)
    out = {}
    for spec in embed._bwd_tables(torch.from_numpy(cat), tables):
        name, tab = spec[0], spec[1]
        ids, slots = _k18_entry_ids(cat, pos, seg, spec)
        g = np.zeros((tab.shape[0], d), np.float32)
        for r0 in range(0, tab.shape[0], rows_cta):
            nrows = min(rows_cta, tab.shape[0] - r0)
            lst, _, rstart = _k18_cta_list(ids, slots, r0, nrows, warps)
            M = lst.size
            parts = {}
            for w in range(warps):
                lo, hi = M * w // warps, M * (w + 1) // warps
                e = lo
                while e < hi:
                    row = int(np.searchsorted(rstart, e, side="right") - 1)
                    end = min(rstart[row + 1], hi)
                    acc = np.zeros(d)
                    for x in range(e, end):
                        acc = acc + flat[lst[x]]
                    if e == rstart[row] and end == rstart[row + 1]:
                        g[r0 + row] = acc.astype(np.float32)
                    else:
                        parts.setdefault(row, []).append(acc)  # run order
                    e = end
            for row, ps in parts.items():
                acc = ps[0]
                for p in ps[1:]:
                    acc = acc + p
                g[r0 + row] = acc.astype(np.float32)
        out[name] = g
    return out


@pytest.mark.parametrize("attr_slots", [0, 3])
def test_k18_all_warps_order_is_the_one_warp_order(attr_slots):
    """Each CTA's list, built by all its warps, is the one-warp stable
    order (entries by row, entry order within a row) of its rows, placed
    after the entries of the rows below it."""
    warps = _const("span_embed_bwd.cu", "kThreads") // 32
    rows_cta = _const("span_embed_bwd.cu", "kRows")
    assert rows_cta * warps == _const("span_embed_bwd.cu", "kThreads")
    dy, cat, pos, seg = _k18_inputs(64, 32, 8, attr_slots, seed=attr_slots)
    tables = _k18_tables(8, attr_slots > 0, seed=1)
    for spec in embed._bwd_tables(torch.from_numpy(cat), tables):
        ids, slots = _k18_entry_ids(cat, pos, seg, spec)
        keep = ids >= 0
        one_warp = slots[keep][np.argsort(ids[keep], kind="stable")]
        rows = spec[1].shape[0]
        for r0 in range(0, rows, rows_cta):
            lst, below, _ = _k18_cta_list(ids, slots, r0,
                                          min(rows_cta, rows - r0), warps)
            assert np.array_equal(lst, one_warp[below:below + lst.size]), \
                (spec[0], r0)


@pytest.mark.parametrize("attr_slots", [0, 3])
@pytest.mark.parametrize("d", [8, 24, 42])
def test_k18_kernel_sums_are_bit_equal_to_plain(attr_slots, d):
    """The kernel's runs, cut rows and parts (a hot status row summed by
    many warps), with the attr table and ids past every table and below
    zero: every table bit-equal to ``span_embed_bwd_plain``."""
    dy, cat, pos, seg = _k18_inputs(64, 32, d, attr_slots, seed=d)
    tables = _k18_tables(d, attr_slots > 0, seed=2)
    got = _k18_model(dy, cat, pos, seg, tables)
    ref = embed.span_embed_bwd_plain(
        *(torch.from_numpy(t) for t in (dy, cat, pos, seg)), tables)
    names = ["service", "name", "kind", "status", "pos"] + (
        ["attr"] if attr_slots else [])
    assert sorted(got) == sorted(names)
    for name in names:
        assert torch.equal(torch.from_numpy(got[name]), getattr(ref, name)), \
            name


# --------------------------------------------------------------- K15 f32
def _k15_tiles():
    """``kTiles`` of ``csrc/gemm_f32.cu`` as (bm, bn), and each
    ``launch_tile`` instance's (bm, bn, tm, tn), in tile order."""
    text = (CSRC / "gemm_f32.cu").read_text()
    table = re.search(r"kTiles\[3\] = \{(.*?)\};", text, re.S).group(1)
    tiles = [tuple(int(v) for v in t) for t in
             re.findall(r"\{(\d+), (\d+)\}", table)]
    inst = [tuple(int(v) for v in t) for t in re.findall(
        r"launch_tile<MODE, (\d+), (\d+), (\d+), (\d+)>", text)]
    return tiles, inst


def _k15_plan(M: int, N: int, sms: int = 132) -> int:
    """``plan_tile``: the largest tile whose grid gives each SM about two
    CTAs (15 / 8 of the SM count), else the smallest."""
    for t, (bm, bn) in enumerate(_k15_tiles()[0][:2]):
        if 8 * (-(-M // bm) * -(-N // bn)) >= 15 * sms:
            return t
    return 2


def _slab_at(row, chunk):
    """``slab_at``: a 16-byte chunk's float offset in a slab of 128-byte
    rows, chunk ^ ((row >> 2) & 7)."""
    return row * 32 + ((chunk ^ ((row >> 2) & 7)) << 2)


def _k15_thread_cols(tid, bn, tn):
    ntx = bn // tn
    tx = tid % ntx
    return [g * 4 * ntx + 4 * tx + q for g in range(tn // 4)
            for q in range(4)]


def test_k15_f32_tiles_and_plan_read_from_the_source():
    """Each tile has its instance (128 threads, 4 or 8 outputs a thread
    each way, a quarter warp on 8 column groups), the shared memory of its
    ring lets two CTAs share an SM, the plan is the model's, and at the
    trainers' products every grid covers most of the 132 SMs."""
    tiles, inst = _k15_tiles()
    assert tiles == [i[:2] for i in inst[:3]]
    assert dense.F32_TILES == tuple(tiles)
    assert _const("gemm_f32.cu", "kThreads") == 128
    bk, stages = _const("gemm_f32.cu", "kBK"), _const("gemm_f32.cu",
                                                      "kStages")
    assert (bk, stages) == (32, 4)
    for bm, bn, tm, tn in inst[:3]:
        assert (bm // tm) * (bn // tn) == 128 and tm in (4, 8) \
            and tn in (4, 8)
        assert bn // tn >= 8 and 32 % (bn // tn) == 0
        assert stages * (bm + bn) * bk * 4 <= 232448 // 2
        assert ((bm + bn) * (bk // 4)) % 128 == 0
    # the tiles measured fastest at the trainers' products (PERF.md §6)
    for N, want in ((1024, 0), (768, 1), (512, 1), (384, 2), (256, 2),
                    (128, 2)):
        assert _k15_plan(2048, N) == want, N
        bm, bn = tiles[want]
        assert -(-2048 // bm) * -(-N // bn) >= 128
    assert _k15_plan(131072, 256) == 0


@pytest.mark.parametrize("tile", [0, 1, 2])
def test_k15_f32_smem_map_reads_and_banks(tile):
    """The copies' chunk placement is one-to-one within each operand's
    slab; every thread's reads land on the chunk its rows and k need; the
    8 lanes of each quarter warp read 8 different bank groups of w's slab
    and one address of x's."""
    bm, bn, tm, tn = _k15_tiles()[1][tile]
    ntx = bn // tn
    for rows in (bm, bn):
        offs = {_slab_at(r, c) for r in range(rows) for c in range(8)}
        assert offs == set(range(0, rows * 32, 4))
    where_a = {_slab_at(r, c): (r, c) for r in range(bm) for c in range(8)}
    where_b = {_slab_at(r, c): (r, c) for r in range(bn) for c in range(8)}
    for tid in range(128):
        ty = tid // ntx
        for c in range(8):
            for i in range(tm):
                assert where_a[_slab_at(ty * tm + i, c)] == (ty * tm + i, c)
            for n in _k15_thread_cols(tid, bn, tn):
                assert where_b[_slab_at(n, c)] == (n, c)
    for w in range(4):
        for quarter in range(4):
            lanes = [32 * w + 8 * quarter + x for x in range(8)]
            for c in range(8):
                for j in range(tn):
                    groups = {(_slab_at(_k15_thread_cols(t, bn, tn)[j], c)
                               % 32) // 4 for t in lanes}
                    assert len(groups) == 8
                for i in range(tm):
                    assert len({_slab_at((t // ntx) * tm + i, c)
                                for t in lanes}) == 1


def _k15_walk(K: int, new: bool) -> list:
    """The k order of each output's chain: the redesign's slabs of 32 in
    16-byte chunks, chunks past K not summed; the first f32 kernel's slabs
    of 16."""
    if not new:
        return [k0 + kk for k0 in range(0, K, 16) for kk in range(16)]
    out = []
    for s in range(-(-K // 32)):
        nch = min(8, (K - 32 * s) // 4)
        out += [32 * s + 4 * c + q for c in range(nch) for q in range(4)]
    return out


def _k15_model(x, w, b, epi, res, planes, live, per, bm, new: bool,
               rows):
    """The kernel's outputs at ``rows`` (planes, rows, N / planes), NaN
    where a tile past the row count leaves the buffer as it was."""
    M, K = x.shape
    N = w.shape[0]
    acc = np.zeros((len(rows), N), np.float32)
    for k in _k15_walk(K, new):
        acc = _fma(x[rows, k][:, None], w[:, k][None, :], acc)
    y = (acc + b).astype(np.float32)
    pre = y.copy()
    if epi == "gelu_tanh":
        y = dense.gelu_tanh_plain(torch.from_numpy(y)).numpy()
    if epi == "residual":
        y = (res[rows] + y).astype(np.float32)
    n_live = M if live is None else min(M, live * per)
    written = np.asarray(rows) < -(-n_live // bm) * bm
    y = np.where(written[:, None], y, np.float32(np.nan))
    pre = np.where(written[:, None], pre, np.float32(np.nan))
    return y.reshape(len(rows), planes, N // planes).transpose(1, 0, 2), pre


@pytest.mark.parametrize("M,N,K,epi,planes,live,per", [
    (2048, 768, 256, "none", 3, None, 1),         # transformer QKV
    (2048, 256, 256, "residual", 1, None, 1),     # out + residual
    (2048, 1024, 256, "gelu_tanh", 1, None, 1),   # FFN1 + GELU + pre
    (2048, 256, 1024, "residual", 1, None, 1),    # FFN2 + residual
    (2048, 384, 128, "none", 3, None, 1),         # autoencoder QKV
    (2048, 128, 128, "residual", 1, None, 1),
    (2048, 512, 128, "gelu_tanh", 1, None, 1),    # FFN1, dec_ff1
    (2048, 128, 512, "none", 1, None, 1),         # FFN2 (+ res), dec_ff2
    (70, 40, 48, "gelu_tanh", 1, None, 1),        # ragged M, N; K % 32
    (131, 264, 1040, "residual", 1, None, 1),
    (1000, 256, 256, "residual", 1, 70, 7),       # a count mid-tile
    (2048, 128, 512, "none", 1, 45, 1)])
def test_k15_f32_walk_is_bit_equal_to_the_parent_order(M, N, K, epi,
                                                       planes, live, per):
    """Each output is one fmaf chain over k ascending in both walks (the
    redesign's chunks of 4 in slabs of 32, the first kernel's slabs of 16),
    so the
    redesign's outputs and ``pre`` equal the parent's bit for bit below
    the row count, at the tile the plan picks (rows at the first and last
    row tiles and around the count); the rows of tiles past the count are
    left as they were; both within 1e-5 of ``gemm_bf16_plain``'s largest
    output."""
    assert _k15_walk(K, True) == list(range(K)) == _k15_walk(K, False)
    rng = np.random.default_rng(M + N + K)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((N, K)) / np.sqrt(K)).astype(np.float32)
    b = (rng.standard_normal(N) * 0.1).astype(np.float32)
    res = rng.standard_normal((M, N)).astype(np.float32) \
        if epi == "residual" else None
    bm = _k15_tiles()[0][_k15_plan(M, N)][0]
    n_live = M if live is None else live * per
    rows = sorted({*range(min(M, 40)), *range(max(0, M - 40), M),
                   *range(max(0, n_live - 40), min(M, n_live + 40))})
    new, new_pre = _k15_model(x, w, b, epi, res, planes, live, per, bm,
                              True, rows)
    old, old_pre = _k15_model(x, w, b, epi, res, planes, live, per, 64,
                              False, rows)
    lv = None if live is None else torch.tensor([live], dtype=torch.int32)
    pre = torch.empty(M, N) if epi == "gelu_tanh" else None
    ref = dense.gemm_bf16_plain(
        *(torch.from_numpy(t) for t in (x, w, b)), epi,
        None if res is None else torch.from_numpy(res), planes, lv, per,
        pre).numpy()
    ref = ref if planes > 1 else ref[None]
    below = np.asarray(rows) < min(M, n_live)
    for a, o in ((new, old), (new_pre[None], old_pre[None])):
        assert np.array_equal(a[:, below].view(np.uint32),
                              o[:, below].view(np.uint32))
    past = np.asarray(rows) >= -(-min(M, n_live) // bm) * bm
    assert np.isnan(new[:, past]).all()
    lim = 1e-5 * np.abs(ref[:, np.asarray(rows)[below]]).max()
    assert np.abs(new[:, below] - ref[:, np.asarray(rows)[below]]).max() \
        <= lim
    if pre is not None:
        assert np.abs(new_pre[below] - pre.numpy()[rows][below]).max() \
            <= 1e-5 * np.abs(pre.numpy()).max()


# ---------------------------------------------------------------- K1 f32
def _k1_pitch(n: int) -> int:
    """``tile_pitch`` of ``csrc/segment_attention.cu``'s CUDA-core kernel:
    whole 16-byte vectors, an odd count of them."""
    return 4 * (((n + 3) // 4) | 1)


def _k1_simt_model(q, k, v, seg, new: bool):
    """K1's CUDA-core route, output and log-sum-exp: each score one fmaf
    chain over d, each output one over the keys, as the first CUDA-core
    kernel sums them (``new`` False) or as the redesign does: d in chunks
    of 4 up to
    hd rounded to 4 (q padded with +0, k with -0) and the keys in chunks
    of 4 up to L rounded to 4 (weights padded with +0, V with -0)."""
    R, L, H, hd = q.shape
    sd = np.float32(attention._scale_div(hd, torch.float32))
    Q, K_, V = (t.transpose(0, 2, 1, 3) for t in ((q / sd).astype(
        np.float32), k, v))
    D, Lk = (-(-hd // 4) * 4, -(-L // 4) * 4) if new else (hd, L)
    Qp = np.zeros((R, H, L, D), np.float32)
    Kp = np.full((R, H, L, D), np.float32(-0.0))
    Vp = np.full((R, H, Lk, hd), np.float32(-0.0))
    Qp[..., :hd], Kp[..., :hd], Vp[..., :L, :] = Q, K_, V
    S = np.zeros((R, H, L, L), np.float32)
    for d in range(D):
        S = _fma(Qp[..., :, None, d], Kp[..., None, :, d], S)
    big_neg = np.float32(np.finfo(np.float32).min)
    ok = ((seg[:, :, None] == seg[:, None, :]) & (seg[:, :, None] > 0))
    S = np.where(ok[:, None], S, big_neg)
    m = S.max(-1, keepdims=True)
    e = np.exp(S - m).astype(np.float32)
    lanes = np.zeros(S.shape[:-1] + (32,), np.float32)  # e0 + e1 a lane
    lanes[..., :min(L, 32)] = e[..., :32]
    if L > 32:
        lanes[..., :L - 32] = lanes[..., :L - 32] + e[..., 32:]
    for x in (16, 8, 4, 2, 1):
        lanes = (lanes + lanes[..., np.arange(32) ^ x]).astype(np.float32)
    s = lanes[..., :1]
    P = (e / s).astype(np.float32)
    Pp = np.zeros((R, H, L, Lk), np.float32)
    Pp[..., :L] = P
    O = np.zeros((R, H, L, hd), np.float32)
    for j in range(Lk):
        O = _fma(Pp[..., :, j, None], Vp[..., j, None, :], O)
    lse = (m[..., 0] + np.log(s[..., 0])).astype(np.float32)
    return O.transpose(0, 2, 1, 3), lse


@pytest.mark.parametrize("R,L,H,hd", [(6, 32, 4, 64), (6, 32, 2, 64),
                                      (3, 64, 4, 64), (4, 33, 2, 30),
                                      (3, 17, 3, 60), (2, 1, 1, 4),
                                      (3, 40, 2, 24), (2, 31, 2, 7)])
def test_k1_f32_walk_is_bit_equal_to_the_parent_order(R, L, H, hd):
    """The redesign's score chains (d in 16-byte chunks, pad dims q +0 x k
    -0) and output chains (keys in chunks of 4, pad keys weight +0 x V -0)
    add only -0 terms, which leave every f32 sum as it is, +0 and -0
    included: outputs and log-sum-exps bit-equal to the first kernel's
    order on rows
    of several segments with padding slots, an all-padding row, and values
    whose products underflow to signed zeros; within the card's bound of
    ``segment_attention_plain``."""
    rng = np.random.default_rng(R * L * hd)
    q, k, v = (rng.standard_normal((R, L, H, hd)).astype(np.float32)
               for _ in range(3))
    tiny = rng.random((R, L, H, hd)) < 0.3  # products that underflow
    q = np.where(tiny, np.float32(1e-30), q)
    k = np.where(tiny, np.float32(-1e-30), k)
    v = np.where(rng.random((R, L, H, hd)) < 0.2,
                 np.float32(-1e-40), v).astype(np.float32)
    # row 0: every score of head 0 exactly -0, and outputs of the last
    # head -0 where every product underflows
    q[0, :, 0], k[0, :, 0] = np.float32(1e-30), np.float32(-1e-30)
    v[0, :, -1] = np.float32(-1e-45)
    seg = np.zeros((R, L), np.int32)
    for r in range(R - 1):
        n = max(1, L - r * 3)
        seg[r, :n] = np.arange(n) // max(1, n // 3) + 1
    old = _k1_simt_model(q, k, v, seg, new=False)
    new = _k1_simt_model(q, k, v, seg, new=True)
    o = new[0][0, :, -1]
    assert H == 1 or (np.signbit(o) & (o == 0)).any()  # exactly -0
    for a, b in zip(old, new):
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32))
    lse = torch.empty(R, H, L)
    ref = attention.segment_attention_plain(
        *(torch.from_numpy(t) for t in (q, k, v, seg)), lse).numpy()
    assert np.abs(new[0] - ref).max() <= 1e-5 * max(1.0, np.abs(ref).max())
    live = (seg > 0)[:, None, :]
    assert np.abs(new[1] - lse.numpy())[np.broadcast_to(
        live, lse.shape)].max() <= 1e-5


def test_k1_f32_layout_fits_and_reads_free_of_bank_conflicts():
    """The shared tiles of every shape the route takes (L and hd to 64)
    fit the instance's attribute; the 8 lanes of a quarter warp read q
    from one row and k from 8 consecutive rows at an odd count of 16-byte
    vectors apart (8 bank groups), V as 8 consecutive vectors of one
    row."""
    text = (CSRC / "segment_attention.cu").read_text()
    assert "constexpr int kMaxSmemBytes = 3 * 64 * 68 * 4 + kMaxL * 4;" \
        in text
    limit = 3 * 64 * 68 * 4 + 64 * 4
    for L in range(1, 65):
        for hd in range(1, 65):
            rt = 32 if L <= 32 else 64
            pq, sp = _k1_pitch(hd), _k1_pitch(L)
            nbytes = (rt * max(pq, sp) + rt * pq + (-(-L // 4) * 4) * pq) \
                * 4 + L * 4
            assert nbytes <= limit, (L, hd)
            assert pq >= hd and sp >= -(-L // 4) * 4
            for d in range(0, hd, 4):
                for b in range(rt // 16):
                    assert len({((tx + 16 * b) * pq + d) % 32 // 4
                                for tx in range(8)}) == 8
            for j in range(-(-L // 4) * 4):
                assert len({(j * pq + 4 * tx) % 32 // 4
                            for tx in range(8)}) == 8


# ------------------------------------------------------------------- K11
def _f32(x):
    return np.float32(x)


def _lse_step(m, s, z):
    """``lse_step`` of csrc/recon_ce.cu on arrays (f32): where z > m the
    sum is rescaled by one FMA, else a term is added."""
    up = z > m
    with np.errstate(invalid="ignore"):  # -inf - -inf where unused
        e_up = np.exp(np.where(up, m - z, 0).astype(np.float32))
        e_dn = np.exp(np.where(up, 0, z - m).astype(np.float32))
    s_up = _fma(s, e_up, np.ones_like(s))
    s_dn = (s + e_dn).astype(np.float32)
    return np.where(up, z, m).astype(np.float32), np.where(up, s_up, s_dn)


def _lse_merge(m, s, mo, so):
    """``lse_merge`` of csrc/recon_ce.cu on arrays (f32)."""
    mn = np.maximum(m, mo)
    with np.errstate(invalid="ignore"):
        a = np.where(m == -np.inf, _f32(0),
                     (s * np.exp((m - mn).astype(np.float32))
                      ).astype(np.float32))
        b = np.where(mo == -np.inf, _f32(0),
                     (so * np.exp((mo - mn).astype(np.float32))
                      ).astype(np.float32))
    return mn.astype(np.float32), (a + b).astype(np.float32)


def _butterfly(m, s, offsets):
    """The xor butterfly over a group's lanes (axis 0): every lane merges
    its value with its partner's at each offset; lane 0's result."""
    m, s = m.copy(), s.copy()
    for o in offsets:
        part = np.arange(m.shape[0]) ^ o
        m, s = _lse_merge(m, s, m[part], s[part])
    return m[0], s[0]


def _k11_parent_lse(z):
    """The parent design's log-sum-exp of one head's logits z (P, V): lane
    tv walks the rows tv + 16 j ascending from (-inf, 0), the 16 lanes
    merge by xor 8, 4, 2, 1, lane 0 adds log(s)."""
    P, V = z.shape
    m = np.full((16, P), -np.inf, np.float32)
    s = np.zeros((16, P), np.float32)
    for tv in range(16):
        for v in range(tv, V, 16):
            m[tv], s[tv] = _lse_step(m[tv], s[tv], z[:, v])
    mm, ss = _butterfly(m, s, (8, 4, 2, 1))
    return (mm + np.log(ss).astype(np.float32)).astype(np.float32)


def _class_group(v: int) -> int:
    """``class_group`` of csrc/recon_ce.cu: the residue classes mod 16 an
    item walks in a head of ``v`` rows, a power of two up to 16, as many as
    keep the item within kItemRows rows where one class allows."""
    rows = -(-v // 16)
    cg = 16
    while cg > 1 and cg * rows > _const("recon_ce.cu", "kItemRows"):
        cg //= 2
    return cg


def _k11_f32_plan(d: int, M: int = 2048) -> tuple[int, int, bool]:
    """(positions a tile, rows a chunk, double-buffered) of the f32 kernel
    at width d and M positions, from its launch_f32_d."""
    text = (CSRC / "recon_ce.cu").read_text()
    body = text[text.index("int launch_f32_d("):]
    large = _const("recon_ce.cu", "kLargeM")
    cases = re.findall(r"(?:if \(a\.d <= (\d+)( && a\.M >= kLargeM)?\)\s+)?"
                       r"return launch_f32_t<T, (\d+), (\d+), "
                       r"(true|false)>", body)[:5]
    assert len(cases) == 5, cases
    for lim, big, tsp, tsr, db in cases:
        if (not lim or d <= int(lim)) and (not big or M >= large):
            return 8 * int(tsp), 32 * int(tsr), db == "true"
    raise AssertionError(d)


def _k11_new_lse(z, P, NR, cg=None):
    """The new design's log-sum-exp of one head (z (npos, V)): tiles of P
    listed positions; an item a group g of cg classes (those = g mod 16 /
    cg; the kernel's class_group unless given), its chunks of rj = NR
    / cg rows a class walked in order per (position, class), the item's
    subtree merged by xor cg / 2 .. 1 over its classes; the tile's last
    item merges the items by xor step / 2 .. 1."""
    npos, V = z.shape
    cg = _class_group(V) if cg is None else cg
    step, rj = 16 // cg, NR // cg
    nchunks = -(-(-(-V // 16)) // rj)
    out = np.zeros(npos, np.float32)
    for p0 in range(0, npos, P):
        zt = z[p0:p0 + P]
        n = zt.shape[0]
        items_m = np.full((step, n), -np.inf, np.float32)
        items_s = np.zeros((step, n), np.float32)
        for g in range(step):
            m = np.full((cg, n), -np.inf, np.float32)
            s = np.zeros((cg, n), np.float32)
            for k in range(nchunks):
                for ci in range(cg):
                    c = g + step * ci
                    for jj in range(rj):
                        v = c + 16 * (k * rj + jj)
                        if v >= V:
                            break
                        m[ci], s[ci] = _lse_step(m[ci], s[ci], zt[:, v])
            offs = [cg >> i for i in range(1, cg.bit_length())]
            items_m[g], items_s[g] = _butterfly(m, s, offs)
        offs = [step >> i for i in range(1, step.bit_length())]
        mm, ss = _butterfly(items_m, items_s, offs)
        out[p0:p0 + n] = mm + np.log(ss).astype(np.float32)
    return out


def test_k11_f32_plan_read_from_the_source():
    """The class groups (csrc/recon_ce.cu class_group, kItemRows) are
    powers of two within kItemRows rows; at the autoencoder's heads a tile
    has 10 items of 256 rows, so the trainer's 619 real positions make 200
    items for the H100's 132 SMs (2 CTAs an SM at d 128; 64-position tiles
    from kLargeM positions, the served T 2048); each width's shared tiles
    fit 227 KB."""
    rows = _const("recon_ce.cu", "kItemRows")
    assert rows == 256
    assert _const("recon_ce.cu", "kMinTile") == 8
    for V in (1, 3, 8, 16, 17, 64, 100, 300, 512, 513, 2048, 4096, 60000):
        cg = _class_group(V)
        assert cg in (1, 2, 4, 8, 16)
        assert cg == 1 or cg * -(-V // 16) <= rows
        assert cg == 16 or 2 * cg * -(-V // 16) > rows
    assert (_class_group(512), _class_group(2048)) == (8, 2)
    ni = 16 // 8 + 16 // 2
    assert _k11_f32_plan(128) == (32, 128, False)
    assert -(-619 // 32) * ni == 200 >= 132
    assert _k11_f32_plan(128, 131072) == (64, 64, False)  # served T 2048
    assert _k11_f32_plan(256, 131072) == _k11_f32_plan(256)
    for d, M in [(d, M) for d in (4, 128, 129 * 4, 256, 384, 512, 768, 1000,
                                  1024) for M in (2048, 131072)]:
        P, NR, double = _k11_f32_plan(d, M)
        assert P >= 8 and P % 8 == 0 and NR % 32 == 0
        pitch = d + 4 if (d // 4) % 2 == 0 else d + 8
        assert (pitch // 4) % 2 == 1  # 8 rows' 16-byte reads: 8 bank groups
        smem = ((P + (2 if double else 1) * NR) * pitch + P * (NR + 1)) * 4
        assert smem <= 227 * 1024, (d, smem)
        if d <= 128:
            assert 2 * smem <= 227 * 1024  # two CTAs an SM
        for V in (8, 512, 2048):
            assert NR % _class_group(V) == 0


@pytest.mark.parametrize("d,count", [(128, 0), (128, 1), (128, 619),
                                     (256, 619), (1000, 619), (128, 2048),
                                     (1000, 1)])
def test_k11_f32_class_split_walk_is_bit_equal_to_the_parent(d, count):
    """Each head's log-sum-exp through the new plan (tiles, items of class
    groups, chunks, subtree merges, the tree's top) against the parent's
    per-lane walks and butterfly, on logits spread over ~20 binades with
    ties, repeats and a row of -inf: the same f32 bits (lse_merge is
    commutative, each class's walk is unchanged, so the tree is the same
    tree)."""
    rng = np.random.default_rng(count + d)
    P, NR, _ = _k11_f32_plan(d, 65536 if count == 2048 else 2048)
    for V in (512, 2048, 8, 100):
        z = (rng.standard_normal((count, V))
             * np.exp2(rng.integers(-10, 10, (count, 1)))).astype(np.float32)
        if count > 1:
            z[0, ::3] = z[0, 1]  # ties
            z[1 % count, :] = np.float32(-np.inf)
            z[1 % count, V // 2] = 3.0
        ref = _k11_parent_lse(z)
        # the kind head: the tile's last item walks it as the parent; any
        # class group gives the parent's tree (the plan's, and all 16)
        for cg in ((None, 16, 1) if V > 16 else ()):
            new = _k11_new_lse(z, P, NR, cg)
            assert new.shape == (count,)
            np.testing.assert_array_equal(new.view(np.uint32),
                                          ref.view(np.uint32))


def test_k11_f32_logit_chain_is_the_parents():
    """A logit is one fmaf chain over k ascending from 0 plus the bias in
    both designs: the GEMM thread's 16-byte steps (x, y, z, w) and the
    parent's give the same bits, at widths off the 16-byte vectors' pairs
    and on products that underflow."""
    rng = np.random.default_rng(5)
    for d in (4, 12, 128, 1000):
        y = (rng.standard_normal((6, d)) * np.exp2(
            rng.integers(-60, 4, (6, d)))).astype(np.float32)
        w = rng.standard_normal((5, d)).astype(np.float32)
        b = rng.standard_normal(5).astype(np.float32)
        chains = []
        for step in (4, 1):  # the new kernel's k4 steps; one value a step
            acc = np.zeros((6, 5), np.float32)
            for k0 in range(0, d, step):
                for k in range(k0, k0 + step):
                    acc = _fma(y[:, None, k], w[None, :, k], acc)
            chains.append((acc + b).astype(np.float32))
        np.testing.assert_array_equal(chains[0].view(np.uint32),
                                      chains[1].view(np.uint32))


def test_k11_f32_scratch_is_cached_zeroed_and_grown():
    """The counters zero when made or grown and kept while large enough
    (the kernel leaves them at zero), apart from the data, which grows on
    its own; one pair a (device, stream), apart from K17's on the same
    stream; a failed launch's pair dropped."""
    dev = torch.device("cpu")
    saved = dict(build._scratch)
    build._scratch.clear()

    def get(stream, counters, nbytes):
        return build.stream_scratch("recon_ce_f32", dev, _Stream(stream),
                                    counters, torch.int32, nbytes,
                                    torch.uint8)
    try:
        c, d = get(1, 10, 64)
        assert c.dtype == torch.int32 and (c == 0).all() and c.numel() == 10
        assert d.dtype == torch.uint8 and d.numel() == 64
        d.fill_(7)  # the partials a launch leaves
        c2, d2 = get(1, 8, 256)
        assert c2 is c and d2 is not d and d2.numel() == 256
        c3, d3 = get(1, 40, 32)
        assert c3 is not c and (c3 == 0).all() and d3 is d2
        assert get(2, 1, 16)[0] is not c3
        assert dense._ln_bwd_part(dev, _Stream(1), 40) is not c3
        c3[0] = 5  # a count a failed launch left
        build.drop_scratch("recon_ce_f32", dev, _Stream(1))
        c4, d4 = get(1, 40, 32)
        assert c4 is not c3 and (c4 == 0).all() and d4 is not d3
        with pytest.raises(RuntimeError, match="scratch"):
            get(1, 4, -1)
    finally:
        build._scratch.clear()
        build._scratch.update(saved)


def _k19_parent_db(dpre):
    """The parent's db: a thread's f64 left fold over its block of 16
    rows from 0.0 (the partial), then a thread a column's left fold over
    the partials in block order from 0.0, rounded once."""
    M, N = dpre.shape
    parts = []
    for m0 in range(0, M, 16):
        acc = np.zeros(N)
        for t in range(m0, min(m0 + 16, M)):
            acc = acc + dpre[t].astype(np.float64)
        parts.append(acc)
    s = np.zeros(N)
    for p in parts:
        s = s + p
    return s


def _k19_new_db(dpre):
    """The new kernel's db: each (block, 128-column group) unit's fold, a
    thread a column over the block's rows from shared memory, in order
    from 0.0; the group's folder adds the partials in block order as they
    come up (here in ready prefixes of random lengths), kFoldBatch loads
    a batch, the adds guarded past the prefix."""
    M, N = dpre.shape
    rows, cols, batch = (_const("gelu_bwd.cu", n)
                         for n in ("kRows", "kCols", "kFoldBatch"))
    blocks = -(-M // rows)
    part = np.zeros((blocks, N))
    for grp in range(-(-N // cols)):
        c = slice(grp * cols, min((grp + 1) * cols, N))
        for b in range(blocks):
            acc = np.zeros(c.stop - c.start)
            for r in range(min(rows, M - b * rows)):
                acc = acc + dpre[b * rows + r, c].astype(np.float64)
            part[b, c] = acc
    s = np.zeros(N)
    rng = np.random.default_rng(blocks)
    b0 = 0
    while b0 < blocks:
        n = int(rng.integers(1, 40))  # the prefix whose flags are up
        for p0 in range(b0, min(b0 + n, blocks), batch):
            v = part[p0:min(p0 + batch, b0 + n, blocks)]
            for p in range(v.shape[0]):
                s = s + v[p]
        b0 += n
    return s


@pytest.mark.parametrize("M,N", [(2048, 1024), (2048, 512), (70, 44),
                                 (17, 260)])
def test_k19_fold_order_is_bit_equal_to_the_parent(M, N):
    """db through the new kernel's units and ticketed folds against the
    parent's two launches, on dPre spread over ~50 binades (so the f64
    sums round: the bits rest on the order, not on exact sums): the same
    f64 sums, so the same f32 db; a pairwise order gives other f64 sums
    there."""
    rng = np.random.default_rng(M + N)
    dy = (rng.standard_normal((M, N)) * np.exp2(
        rng.integers(-40, 12, (M, N)))).astype(np.float32)
    pre = (rng.standard_normal((M, N)) * 3).astype(np.float32)
    dpre, db = dense.gelu_tanh_bwd_plain(torch.from_numpy(dy),
                                         torch.from_numpy(pre))
    dpre = dpre.numpy()
    ref = _k19_parent_db(dpre)
    got = _k19_new_db(dpre)
    np.testing.assert_array_equal(got.view(np.uint64), ref.view(np.uint64))
    np.testing.assert_array_equal(got.astype(np.float32).view(np.uint32),
                                  db.numpy().view(np.uint32))
    if M >= 2048:
        pairwise = dpre.astype(np.float64)
        while pairwise.shape[0] > 1:
            if pairwise.shape[0] % 2:
                pairwise = np.vstack([pairwise, np.zeros((1, N))])
            pairwise = pairwise[0::2] + pairwise[1::2]
        assert not np.array_equal(pairwise[0].view(np.uint64),
                                  ref.view(np.uint64))


@pytest.mark.parametrize("M,N", [(2048, 1024), (2048, 512), (70, 44),
                                 (1, 4), (100000, 4096)])
def test_k19_grid_plan_and_scratch(M, N):
    """One launch: (16-row block, 128-column group) units on CTAs of 128
    threads (a warp a row of 128 columns, 4 rows a thread), a folder a
    column group, then producers as many as units up to 8 an SM: at both
    trainers' shapes every one of the H100's 132 SMs gets a producer. The
    flags: one a (group, block)."""
    threads, rows, cols, cap = (
        _const("gelu_bwd.cu", n) for n in ("kThreads", "kRows", "kCols",
                                           "kCtasPerSm"))
    assert cols == threads == 4 * 32 and rows % (threads // 32) == 0
    text = (CSRC / "gelu_bwd.cu").read_text()
    assert "kRowsPerThread = kRows / (kThreads / 32)" in text
    assert "(unsigned)(groups + (units < cap ? units : cap))" in text
    assert "return (M + kRows - 1) / kRows * (long long)((N + kCols - 1) " \
        "/ kCols);" in text
    groups = -(-N // cols)
    units = -(-M // rows) * groups
    grid = groups + min(units, 132 * cap)
    if M >= 2048:
        assert grid - groups >= 132


def _k19_run(producers, groups, blocks, slots, order, helping):
    """Whether one K19 launch ends on a card with room for ``slots`` of
    its CTAs (the rest held by other work), CTAs ``[0, groups)`` folding,
    dispatched in ``order``; producer ``p`` owns units ``p, p +
    producers, ...`` (block-major). With ``helping`` (the kernel's design)
    an owner claims each unit as it comes to it and a folder whose next
    block is unclaimed claims and produces it; without it (the design
    before) a folder only waits."""
    units = blocks * groups
    claimed, done = set(), set()
    resident, pending = [], list(order)
    todo = {p: list(range(p, units, producers)) for p in range(producers)}
    next_b = {g: 0 for g in range(groups)}
    while pending or resident:
        if pending and len(resident) < slots:
            resident.append(pending.pop(0))
            continue
        moved = False
        for cta in list(resident):
            if cta >= groups:            # an owner: its next unit, or out
                mine = todo[cta - groups]
                if mine:
                    u = mine.pop(0)
                    if u not in claimed:
                        claimed.add(u)
                        done.add(u)
                else:
                    resident.remove(cta)
                moved = True
                continue
            u = next_b[cta] * groups + cta
            if next_b[cta] == blocks:
                resident.remove(cta)     # its folds done
                moved = True
            elif u in done:
                next_b[cta] += 1
                moved = True
            elif helping and u not in claimed:
                claimed.add(u)           # the folder produces it
                done.add(u)
                moved = True
        if not moved:
            return False  # every resident CTA waits: the launch hangs
    return True


@pytest.mark.parametrize("slots", [1, 2, 3, 5, 40])
def test_k19_folders_wait_only_on_running_producers(slots):
    """Helping folders end in any room and any dispatch order; folders
    that only wait, dispatched first (the order a card dispatches in),
    hang once they fill the room."""
    producers, groups, blocks = 12, 3, 9
    rng = np.random.default_rng(slots)
    for _ in range(20):
        order = list(rng.permutation(producers + groups))
        assert _k19_run(producers, groups, blocks, slots, order, True)
    assert _k19_run(producers, groups, blocks, slots,
                    list(range(producers + groups)), False) == (
        slots > groups)
    assert "if (tried <= b0) {" in (CSRC / "gelu_bwd.cu").read_text()


@pytest.mark.parametrize("seed", range(8))
def test_k19_unit_flag_ends_zero_whoever_produces(seed):
    """One unit's flag under the kernel's atomic ORs, its owner and its
    folder interleaved at random (the folder trying a claim or not):
    exactly one of them produces it, the folder folds it once it is done,
    and the flag ends at zero, so the next call finds it free."""
    claim, done_bit, owner_bit, folded = (
        _const("gelu_bwd.cu", n) for n in ("kClaim", "kDone", "kOwner",
                                           "kFolded"))
    rng = np.random.default_rng(seed)
    for _ in range(200):
        flag, produced = 0, []

        def atomic_or(bits):
            nonlocal flag
            old, flag = flag, flag | bits
            return old

        def owner():
            nonlocal flag
            old = atomic_or(owner_bit | claim)
            if not old & claim:
                yield
                produced.append("owner")
                atomic_or(done_bit)
            elif old & folded:
                flag = 0

        def folder(steal):
            nonlocal flag
            if steal:
                while flag & done_bit == 0:
                    if not atomic_or(claim) & claim:
                        yield
                        produced.append("folder")
                        atomic_or(done_bit)
                        break
                    yield  # a running owner has it: wait
                    break
            while flag & done_bit == 0:
                yield
            if atomic_or(folded) & owner_bit:
                flag = 0

        actors = [owner(), folder(bool(rng.integers(2)))]
        while actors:
            a = actors[int(rng.integers(len(actors)))]
            try:
                next(a)
            except StopIteration:
                actors.remove(a)
        assert len(produced) == 1 and flag == 0


def test_k19_scratch_is_cached_zeroed_and_grown():
    """The flags zero when made or grown and kept while large enough (the
    kernel leaves them at zero), apart from the partials,
    which grow on their own (a launch writes them before it reads them);
    one pair a (device, stream), apart from K17's; a failed launch's pair
    dropped."""
    dev = torch.device("cpu")
    saved = dict(build._scratch)
    build._scratch.clear()

    def get(stream, flags, parts):
        return build.stream_scratch("gelu_bwd", dev, _Stream(stream), flags,
                                    torch.int32, parts, torch.float64)
    try:
        c, p = get(1, 8, 64)
        assert c.dtype == torch.int32 and (c == 0).all() and c.numel() == 8
        assert p.dtype == torch.float64 and p.numel() == 64
        p.fill_(7.0)
        c2, p2 = get(1, 4, 128)
        assert c2 is c and p2 is not p and p2.numel() == 128
        c3, p3 = get(1, 16, 32)
        assert c3 is not c and (c3 == 0).all() and p3 is p2
        assert get(2, 1, 1)[0] is not c3
        assert dense._ln_bwd_part(dev, _Stream(1), 16) is not c3
        c3[-1] = 3  # a flag a failed launch left
        build.drop_scratch("gelu_bwd", dev, _Stream(1))
        assert (get(1, 16, 32)[0] == 0).all()
        with pytest.raises(RuntimeError, match="scratch"):
            get(1, -1, 4)
    finally:
        build._scratch.clear()
        build._scratch.update(saved)


# ------------------------------------------------------------------- K21
def _k21_xh_terms(x, w, mask, dpool):
    """K21's per-row f32 values as the kernel forms them: g = dpool /
    max(count, 1), and at each position the terms g * xh (xh from K12's
    statistics: exact f64 row sums rounded once, IEEE steps)."""
    T, L, d = x.shape
    count = mask.sum(-1).astype(np.int64)
    denom = np.maximum(count, 1).astype(np.float32)
    g = (dpool / denom[:, None]).astype(np.float32)
    mean = (x.astype(np.float64).sum(-1).astype(np.float32)
            / np.float32(d)).astype(np.float32)
    dev = (x - mean[..., None]).astype(np.float32)
    sq = (dev * dev).astype(np.float32)
    var = (sq.astype(np.float64).sum(-1).astype(np.float32)
           / np.float32(d)).astype(np.float32)
    rstd = (np.float32(1.0) / np.sqrt((var + np.float32(dense.LN_EPS))
                                      .astype(np.float32))).astype(np.float32)
    xh = (dev * rstd[..., None]).astype(np.float32)
    return g, count, (g[:, None, :] * xh).astype(np.float32)


def _k21_parent_sums(mask, g, terms):
    """The parent's order: a warp a trace adds its real positions' f64
    terms in position order from 0.0 (and g once a real position), the
    warps' partials (zeros past T, 4 a CTA) added in warp order from 0.0
    by a thread a column, rounded once."""
    T, L, d = terms.shape
    parts = []
    for t in range(-(-T // 4) * 4):
        cg, cb = np.zeros(d), np.zeros(d)
        if t < T:
            for p in range(L):
                if mask[t, p]:
                    cg = cg + terms[t, p].astype(np.float64)
                    cb = cb + g[t].astype(np.float64)
        parts.append((cg, cb))
    sg, sb = np.zeros(d), np.zeros(d)
    for cg, cb in parts:
        sg, sb = sg + cg, sb + cb
    return sg, sb


def _k21_new_sums(mask, g, count, terms):
    """The kernel's order, its constants read from the source: a CTA a
    trace takes its positions a window of W at a time, the window's real
    rows dealt to warps k mod 8 and their terms put in shared memory at row
    k; a thread a column adds rows 0.. of each window in order into its
    f64 sum from 0.0; the trace's sum of g is count x g; the last CTA adds
    the traces' partials in trace order from 0.0."""
    T, L, d = terms.shape
    threads = _const("ae_pool_bwd.cu", "kThreads")
    cells = _const("ae_pool_bwd.cu", "kTermCells")
    per = next(p for p in (1, 2, 4, 8, 16, 32) if d <= 32 * p)
    W = 32 if per <= 8 else cells // (32 * per)
    warps = threads // 32
    assert W * d <= cells and W % warps == 0
    sg, sb = np.zeros(d), np.zeros(d)
    for t in range(T):
        acc = np.zeros(d)
        for l0 in range(0, L, W):
            real = [l for l in range(l0, min(l0 + W, L)) if mask[t, l]]
            rows = {}  # shared-memory row k <- the warp k mod 8's row
            for k, l in enumerate(real):
                assert k // warps < W // warps
                rows[k] = terms[t, l]
            for k in range(len(real)):
                acc = acc + rows[k].astype(np.float64)
        cb = (g[t].astype(np.float64) * float(count[t]) if count[t]
              else np.zeros(d))
        sg, sb = sg + acc, sb + cb
    return sg, sb


@pytest.mark.parametrize("d", [1, 33, 128, 1024])
@pytest.mark.parametrize("T,L", [(1, 1), (64, 32), (300, 17)])
def test_k21_column_sums_in_kernel_order_match_the_parent(T, L, d):
    """dgamma and dbeta in the one-launch kernel's order (windows of real
    rows through shared memory, count x g, the traces in order) against
    the parent's (a warp a trace, warps' partials in order), on dpool
    spread over ~50 binades (so the f64 sums round: the bits rest on the
    order) with empty traces: the same f64 sums, so the same bits."""
    rng = np.random.default_rng(T * d + L)
    x = (rng.standard_normal((T, L, d)) * 3 + 1).astype(np.float32)
    dpool = (rng.standard_normal((T, d)) * np.exp2(
        rng.integers(-40, 12, (T, d)))).astype(np.float32)
    mask = rng.random((T, L)) < 0.4
    if T > 1:
        mask[::3] = False  # traces with no real position
    g, count, terms = _k21_xh_terms(x, None, mask, dpool)
    ref = _k21_parent_sums(mask, g, terms)
    got = _k21_new_sums(mask, g, count, terms)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.view(np.uint64), b.view(np.uint64))


def test_k21_column_sums_on_the_trainers_pool_gradient(monkeypatch):
    """The same on the autoencoder trainer's own pool gradient: one CPU
    step of TrainConfig(model="autoencoder") at its full width (d 128, 64
    traces of L 32, the reference's seed-0 weights, the clean stream),
    K21's inputs captured: both orders give the same bits, and they lie
    within 1e-6 of the plain version's dgamma and dbeta (torch's f64 sums,
    another order) relative to its largest magnitude."""
    from odigos_tpu_torch.kernels import pool
    from odigos_tpu_torch.models import AutoencoderConfig, SpanAutoencoder
    from odigos_tpu_torch.models.jax_init import autoencoder_state
    from odigos_tpu_torch.training import labeled_sequences

    seen = []
    real = pool.ln_masked_pool_bwd

    def rec(*a, **k):
        seen.append([t.detach().clone() if hasattr(t, "clone") else t
                     for t in a])
        return real(*a, **k)

    monkeypatch.setattr(pool, "ln_masked_pool_bwd", rec)
    cfg = AutoencoderConfig(max_len=32, dtype=torch.float32)
    model = SpanAutoencoder(cfg, device="cpu")
    model.load_state_dict(autoencoder_state(cfg, 0))
    data = labeled_sequences(63, fault_fraction=0.0, max_len=32, seed=0,
                             pad_traces_to=64)
    model.module.train()
    model.loss_fn(data.categorical, data.continuous, data.mask).backward()
    assert len(seen) == 1
    x, w, mask, dpool = (seen[0][i] for i in range(4))
    assert x.shape == (64, 32, 128) and int(mask.sum()) > 0
    x, mask, dpool = x.numpy(), mask.numpy(), dpool.numpy()
    g, count, terms = _k21_xh_terms(x, None, mask, dpool)
    ref = _k21_parent_sums(mask, g, terms)
    got = _k21_new_sums(mask, g, count, terms)
    _, dw, db = pool.ln_masked_pool_bwd_plain(*(seen[0][i] for i in
                                                range(4)))
    for a, b, plain in zip(got, ref, (dw, db)):
        np.testing.assert_array_equal(a.view(np.uint64), b.view(np.uint64))
        plain = plain.numpy().astype(np.float64)
        assert np.abs(a.astype(np.float32) - plain).max() <= 1e-6 * np.abs(
            plain).max()


def test_k21_grid_plan_read_from_the_source():
    """One launch: a CTA of 8 warps a trace, min(T, 4 x SMs) CTAs (at the
    trainer's 64 traces, 64 CTAs with ~10 real rows each, one or two a
    warp); each window's terms fit the shared array at every d; the
    counter is one ticket; the wrapper no longer zero-fills dW and db."""
    threads = _const("ae_pool_bwd.cu", "kThreads")
    cap = _const("ae_pool_bwd.cu", "kCtasPerSm")
    cells = _const("ae_pool_bwd.cu", "kTermCells")
    assert threads == 256 and _const("ae_pool_bwd.cu", "kMaxD") == 1024
    for d in range(1, 1025):
        per = next(p for p in (1, 2, 4, 8, 16, 32) if d <= 32 * p)
        W = 32 if per <= 8 else cells // (32 * per)
        assert 8 <= W <= 32 and W * d <= cells and W % (threads // 32) == 0
    text = (CSRC / "ae_pool_bwd.cu").read_text()
    assert "const unsigned ctas = (unsigned)(T < cap ? T : cap);" in text
    assert "return PER <= 8 ? 32 : kTermCells / (32 * PER);" in text
    for T in (1, 64, 300, 100000):
        assert min(T, 132 * cap) == (T if T <= 528 else 528)
    src = Path(dense.__file__).with_name("pool.py").read_text()
    assert "dw = torch.zeros(d" not in src


def test_k21_scratch_is_cached_zeroed_and_grown():
    """The counter zero when made or grown and kept while large enough
    (the kernel leaves it at zero), apart from the f64 partials, which
    grow on their own; one pair a (device, stream), apart from K17's; a
    failed launch's pair dropped."""
    dev = torch.device("cpu")
    saved = dict(build._scratch)
    build._scratch.clear()

    def get(stream, counters, parts):
        return build.stream_scratch("ae_pool_bwd", dev, _Stream(stream),
                                    counters, torch.int32, parts,
                                    torch.float64)
    try:
        c, p = get(1, 1, 64 * 2 * 128)
        assert c.dtype == torch.int32 and (c == 0).all() and c.numel() == 1
        assert p.dtype == torch.float64 and p.numel() == 64 * 2 * 128
        p.fill_(7.0)  # the partials a launch leaves
        c2, p2 = get(1, 1, 300 * 2 * 128)
        assert c2 is c and p2 is not p and p2.numel() == 300 * 2 * 128
        c3, p3 = get(1, 2, 16)
        assert c3 is not c and (c3 == 0).all() and p3 is p2
        assert get(2, 1, 16)[0] is not c3
        assert dense._ln_bwd_part(dev, _Stream(1), 16) is not c3
        c3[0] = 5  # a ticket a failed launch left
        build.drop_scratch("ae_pool_bwd", dev, _Stream(1))
        assert (get(1, 2, 16)[0] == 0).all()
    finally:
        build._scratch.clear()
        build._scratch.update(saved)


# ------------------------------------------------------------------- K20
K20_PARENT_SLICE = 128  # the parent's vocabulary slice: dy's fold order
K20_PARENT_CHUNK = 64   # the parent's dW chunk (the chain does not see it)
K20_VOCABS = (512, 2048, 8, 1)  # the default autoencoder's heads


def _k20_ts(d: int) -> int:
    """The tile by d, as the source picks it: positions a tile (threads /
    16) TS, weight rows a ring stage 16 TS."""
    text = (CSRC / "recon_ce_bwd.cu").read_text()
    assert "return d <= 128 ? 4 : d <= 256 ? 2 : 1;" in text
    assert "return kThreads / 16 * ts;" in text
    return 4 if d <= 128 else 2 if d <= 256 else 1


def _k20_tile_positions(d: int) -> int:
    return _const("recon_ce_bwd.cu", "kThreads") // 16 * _k20_ts(d)


def _k20_slices(vs, kslice):
    """(head, first row, end row) of each vocabulary slice, in the order
    the slice items and dy's fold take them."""
    return [(h, v0, min(V, v0 + kslice)) for h, V in enumerate(vs)
            for v0 in range(0, V, kslice)]


def _k20_inputs(n, d, vs, seed):
    """n listed positions' y (spread over binades, so the chains round),
    the heads, log-sum-exps, labels (some wrapped, some past their head:
    coefficient 0) and targets, in f32."""
    rng = np.random.default_rng(seed)
    y = (rng.standard_normal((n, d)) * np.exp2(
        rng.integers(-8, 4, (n, d)))).astype(np.float32)
    heads = [((rng.standard_normal((V, d)) / np.sqrt(d)).astype(np.float32),
              (rng.standard_normal(V) / 4).astype(np.float32)) for V in vs]
    lse = (rng.standard_normal((n, 3)) + 4).astype(np.float32)
    lab = np.stack([rng.integers(-V, V + 3, n) for V in vs[:3]], 1)
    coef = (rng.random((n, 4)) + 0.5).astype(np.float32)
    for h in range(3):
        lab[:, h] = np.where(lab[:, h] < 0, lab[:, h] + vs[h], lab[:, h])
        past = lab[:, h] >= vs[h]
        coef[past, h] = 0.0
        lab[past, h] = -1
    c0 = (rng.random(n) * 4).astype(np.float32)
    return y, heads, lse, lab, coef, c0


def _k20_dlogit(y, heads, lse, lab, coef, c0):
    """Each head's dlogit (n, V_h): the logit one fmaf chain over k
    ascending from 0 plus the bias, then the parent's IEEE steps."""
    n, d = y.shape
    out = []
    for h, (W, b) in enumerate(heads):
        acc = np.zeros((n, W.shape[0]), np.float32)
        for k in range(d):
            acc = _fma(y[:, None, k], W[None, :, k], acc)
        z = (acc + b).astype(np.float32)
        if h < 3:
            pr = np.exp((z - lse[:, h, None]).astype(np.float32)).astype(
                np.float32)
            rows = np.arange(n)[lab[:, h] >= 0]
            pr[rows, lab[rows, h]] = (pr[rows, lab[rows, h]]
                                      - np.float32(1.0)).astype(np.float32)
            g = (pr * coef[:, h, None]).astype(np.float32)
        else:
            g = (coef[:, 3, None] * (np.float32(2.0) * (
                z - c0[:, None]).astype(np.float32))).astype(np.float32)
        out.append(g)
    return out


def _k20_grads(y, heads, dl, kslice, kvr, chunk):
    """dy, dW, db in a design's walk: dy a slice of ``kslice`` rows at a
    time, its rows in stages of ``kvr`` (those past the slice zero), one
    fmaf chain from 0 over the slice's rows, the slices added with one
    f32 add each from 0 in order; dW[v] and db[v] one chain over the
    positions in order, ``chunk`` at a time."""
    n, d = y.shape
    vs = [W.shape[0] for W, _ in heads]
    dy = np.zeros((n, d), np.float32)
    for h, v0, v1 in _k20_slices(vs, kslice):
        W = heads[h][0]
        acc = np.zeros((n, d), np.float32)
        for r0 in range(v0, v1, kvr):
            for v in range(r0, r0 + kvr):
                if v < v1:
                    acc = _fma(dl[h][:, v, None], W[None, v, :], acc)
                else:  # a zero row past the slice
                    acc = _fma(np.float32(0.0), np.float32(0.0), acc)
        dy = (dy + acc).astype(np.float32)
    dws, dbs = [], []
    for h, (W, _) in enumerate(heads):
        dw = np.zeros((W.shape[0], d), np.float32)
        db = np.zeros(W.shape[0], np.float32)
        for i0 in range(0, n, chunk):
            for i in range(i0, min(i0 + chunk, n)):
                dw = _fma(dl[h][i, :, None], y[None, i, :], dw)
                db = (db + dl[h][i]).astype(np.float32)
        dws.append(dw)
        dbs.append(db)
    return dy, dws, dbs


@pytest.mark.parametrize("n,d", [(0, 128), (1, 1024), (619, 128),
                                 (2048, 4)])
def test_k20_chains_in_kernel_order_match_the_parent(n, d):
    """The logit chain, dlogit, dy's slice chains and fold, and the dW and
    db chains in the new kernel's walk (its slice, ring stage and dW chunk
    read from the source) against the parent's (128-row slices, 64-row
    tiles at d <= 128, 64-position chunks), in f32 with fmaf emulated, on
    real-position counts 0, 1, 619 and 2048 at d 4, 128 and 1024, labels
    wrapped and past their heads: bit for bit."""
    vs = (40, 150, 8, 1)  # 5 slices, a head off 128 and under it
    y, heads, lse, lab, coef, c0 = _k20_inputs(n, d, vs, n + d)
    dl = _k20_dlogit(y, heads, lse, lab, coef, c0)
    ts = _k20_ts(d)
    ref = _k20_grads(y, heads, dl, K20_PARENT_SLICE, 16 * ts,
                     K20_PARENT_CHUNK)
    got = _k20_grads(y, heads, dl, _const("recon_ce_bwd.cu", "kSlice"),
                     16 * ts, _const("recon_ce_bwd.cu", "kBChunk"))
    np.testing.assert_array_equal(got[0].view(np.uint32),
                                  ref[0].view(np.uint32))
    for a, b in zip(got[1] + got[2], ref[1] + ref[2]):
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
    if n:  # and near the plain products (f64)
        dy64 = sum(dl[h].astype(np.float64) @ heads[h][0] for h in range(4))
        assert np.abs(got[0] - dy64).max() <= 1e-4 * np.abs(dy64).max()


def _k20_tickets(n, d, vs):
    """The main launch's ticket order, as the source walks it: every
    (slice, tile) item, slice-major, then every dW item ("dw", row block,
    column tile). Returns the order, each dW row block's slices and the
    tiles a slice."""
    kslice = _const("recon_ce_bwd.cu", "kSlice")
    brows = _const("recon_ce_bwd.cu", "kBRows")
    bcols = _const("recon_ce_bwd.cu", "kBCols")
    slices = _k20_slices(vs, kslice)
    offs = np.concatenate([[0], np.cumsum(vs)])
    vtot = int(offs[-1])
    ntiles = -(-n // _k20_tile_positions(d))
    nvt, ndt = -(-vtot // brows), -(-d // bcols)
    order = [("slice", s, t) for s in range(len(slices))
             for t in range(ntiles)]
    order += [("dw", j, k) for j in range(nvt) for k in range(ndt)]
    deps = {j: [s for s, (h, v0, v1) in enumerate(slices)
                if offs[h] + v0 < min((j + 1) * brows, vtot)
                and offs[h] + v1 > j * brows] for j in range(nvt)}
    return order, deps, ntiles


@pytest.mark.parametrize("n", [0, 1, 619, 2048])
@pytest.mark.parametrize("d", [4, 128, 1024])
def test_k20_plan_items_only_for_listed_positions(n, d):
    """Work items exist only for listed positions: a (tile, slice) item
    for each tile of (threads / 16) TS listed positions the count needs
    (none at 0), slice-major, then a dW item for each (32 rows, 64
    columns) block of dW, each after every slice item of the slices its
    rows lie in; every slice lies in one head from a multiple of 128 of
    its rows, and the slices cover each head's rows once; the counters
    hold the lead, a count a slice and a ticket a tile at every d."""
    kslice = _const("recon_ce_bwd.cu", "kSlice")
    brows = _const("recon_ce_bwd.cu", "kBRows")
    bcols = _const("recon_ce_bwd.cu", "kBCols")
    lead = _const("recon_ce_bwd.cu", "kLead")
    assert (kslice, _const("recon_ce_bwd.cu", "kThreads")) == (128, 256)
    slices = _k20_slices(K20_VOCABS, kslice)
    S = len(slices)
    assert S == 22
    for h, V in enumerate(K20_VOCABS):
        mine = [(v0, v1) for hh, v0, v1 in slices if hh == h]
        assert all(v0 % kslice == 0 and v1 <= V for v0, v1 in mine)
        assert sum(v1 - v0 for v0, v1 in mine) == V
    order, deps, ntiles = _k20_tickets(n, d, K20_VOCABS)
    tp = _k20_tile_positions(d)
    assert sorted(o for o in order if o[0] == "slice") == sorted(
        ("slice", s, t) for s in range(S) for t in range(ntiles))
    nvt, ndt = -(-sum(K20_VOCABS) // brows), -(-d // bcols)
    assert sorted(o for o in order if o[0] == "dw") == sorted(
        ("dw", j, k) for j in range(nvt) for k in range(ndt))
    at = {o: i for i, o in enumerate(order)}
    for o in order:
        if o[0] == "dw":
            assert deps[o[1]] and all(at[("slice", s, t)] < at[o]
                                      for s in deps[o[1]]
                                      for t in range(ntiles))
    listed = sorted(p for t in range(ntiles)
                    for p in range(t * tp, min(n, (t + 1) * tp)))
    assert listed == list(range(n))
    if n == 619 and d == 128:
        assert ntiles * S == 220  # the parent's grid: 32 x 22 = 704 CTAs
    M = 2048
    smallest = _k20_tile_positions(1024)
    assert lead + S + -(-M // smallest) >= lead + S + -(-M // tp)
    text = (CSRC / "recon_ce_bwd.cu").read_text()
    assert "(M + tile_positions(1) - 1) / tile_positions(1);" in text
    assert "if (item < slice_items)" in text


def _k20_run(slots, order, deps, cta_order, ntiles):
    """Whether one K20 main launch ends on a card with room for ``slots``
    of its CTAs, dispatched in ``cta_order``: each CTA draws tickets from
    one counter while it runs; a slice item is done once drawn (it never
    waits), a dW item waits until every tile of its slices is done."""
    ticket, done = 0, set()
    resident, pending = {}, list(cta_order)  # cta -> its item or None
    while pending or resident:
        if pending and len(resident) < slots:
            resident[pending.pop(0)] = None
            continue
        moved = False
        for cta in list(resident):
            item = resident[cta]
            if item is None:
                if ticket >= len(order):
                    del resident[cta]  # out
                else:
                    resident[cta] = order[ticket]
                    ticket += 1
                moved = True
            elif item[0] == "slice":
                done.add(item[1:])
                resident[cta] = None
                moved = True
            elif all((s, t) in done for s in deps[item[1]]
                     for t in range(ntiles)):
                resident[cta] = None
                moved = True
        if not moved:
            return False  # every resident CTA waits: the launch hangs
    return True


@pytest.mark.parametrize("slots", [1, 2, 3, 5, 40])
def test_k20_dw_items_wait_only_on_running_slice_items(slots):
    """The ticket order puts every dW item after the slice items, and
    slice items never wait, so the launch ends in any room and any
    dispatch order; dW items drawn before the slice items (an order the
    kernel does not use) hang once they fill the room."""
    vs, d, n = (40, 150, 8, 1), 128, 70
    order, deps, ntiles = _k20_tickets(n, d, vs)
    grid = 16
    rng = np.random.default_rng(slots)
    for _ in range(20):
        assert _k20_run(slots, order, deps, list(rng.permutation(grid)),
                        ntiles)
    dw_first = ([o for o in order if o[0] == "dw"]
                + [o for o in order if o[0] == "slice"])
    ndw = len(dw_first) - ntiles * 5
    assert _k20_run(slots, dw_first, deps, list(range(grid)),
                    ntiles) == (min(slots, grid) > ndw)
    text = (CSRC / "recon_ce_bwd.cu").read_text()
    assert "while (load_acquire(w.cnt + kLead + base + s) < w.ntiles)" in text


def test_k20_scratch_is_cached_zeroed_and_grown():
    """The counters zero when made or grown and kept while large enough
    (the kernels leave them at zero), apart from the data, which grows on
    its own; one pair a (device, stream), apart from K11's on the same
    stream; a failed launch's pair dropped."""
    dev = torch.device("cpu")
    saved = dict(build._scratch)
    build._scratch.clear()

    def get(stream, counters, nbytes):
        return build.stream_scratch("recon_ce_bwd", dev, _Stream(stream),
                                    counters, torch.int32, nbytes,
                                    torch.uint8)
    try:
        c, d = get(1, 4 + 22 + 128, 1 << 10)
        assert c.dtype == torch.int32 and (c == 0).all()
        assert d.dtype == torch.uint8 and d.numel() == 1 << 10
        d.fill_(7)  # the list, y, dlogit and partials a launch leaves
        c2, d2 = get(1, 10, 1 << 12)
        assert c2 is c and d2 is not d and d2.numel() == 1 << 12
        c3, d3 = get(1, 4 + 22 + 4096, 64)
        assert c3 is not c and (c3 == 0).all() and d3 is d2
        assert get(2, 1, 16)[0] is not c3
        k11 = build.stream_scratch("recon_ce_f32", dev, _Stream(1), 8,
                                   torch.int32, 8, torch.uint8)[0]
        assert k11 is not c3
        c3[0] = 3  # a ticket a failed launch left
        build.drop_scratch("recon_ce_bwd", dev, _Stream(1))
        assert (get(1, 4 + 22 + 4096, 64)[0] == 0).all()
        with pytest.raises(RuntimeError, match="scratch"):
            get(1, 4, -1)
    finally:
        build._scratch.clear()
        build._scratch.update(saved)

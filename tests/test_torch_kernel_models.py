"""Host models of K22's and K17's kernels, on the CPU.

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
  to ``ln_bwd_plain``'s; the wrapper's cached scratch.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from odigos_tpu_torch.kernels import dense
from odigos_tpu_torch.kernels import ring as kring

CSRC = Path(kring.__file__).parent / "csrc"
RING_RTOL = 1e-5  # the reference's ring bound (tests/test_parallel.py)


def _const(source: str, name: str) -> int:
    text = (CSRC / source).read_text()
    found = re.search(rf"constexpr (?:int|bool) {name} = (\w+);", text)
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
    class _Stream:
        def __init__(self, handle):
            self.cuda_stream = handle

    dev = torch.device("cpu")
    saved = dict(dense._ln_bwd_scratch)
    dense._ln_bwd_scratch.clear()
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
        dense._ln_bwd_scratch.clear()
        dense._ln_bwd_scratch.update(saved)

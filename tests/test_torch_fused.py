"""The port's fused columns route against the JAX package's, on the CPU.

The same frames go through the JAX package's fused route (its jnp device
twins on the CPU, as ``tests/test_fused.py`` runs them) and through the
port with ``device="cpu"``, where every kernel wrapper takes its plain
version. Weights cross with ``flax_to_torch``; the model is the reference's
tiny fused config (d 32, 2 heads, 1 layer, d_ff 64, max_len 16, f32).

Bounds:

* featurize twin vs ``featurize_columns_jax``: categorical exact;
  continuous at the reference's ``FUSED_RTOL``/``FUSED_ATOL`` (its f32
  duration recomposition against the port's exact f64 arithmetic); vs the
  port's host ``featurize_columns``: exact (measured bit-equal);
* sort + pack twin vs ``_build_pack_packed`` on the same features: exact
  on every row both produce, the other side's extra rows all padding;
* the slice (``dispatch_columns`` → ``harvest``) vs the JAX
  ``FusedSequenceBackend``: atol = rtol = 1e-5, the port's f32 model bound
  (``tests/test_torch_model.py``); vs the port's own host route at
  ``FUSED_RTOL``/``FUSED_ATOL``.

Ids at or above 2**63 are built here: ``synthesize_traces`` never sets the
top bit, and the port orders u64 columns unsigned.
"""

import os
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odigos_tpu.features.featurizer import featurize_columns_jax
from odigos_tpu.models.transformer import TransformerConfig as JaxConfig
from odigos_tpu.pdata import synthesize_traces as jsynth
from odigos_tpu.serving.engine import BucketLadder as JaxLadder
from odigos_tpu.serving.engine import EngineConfig as JaxEngineConfig
from odigos_tpu.serving.engine import ScoringEngine as JaxEngine
from odigos_tpu.serving.fused import FALLBACK_REASONS as JAX_REASONS
from odigos_tpu.serving.fused import _build_pack_packed
from odigos_tpu.serving.fused import extract_columns as jax_extract
from odigos_tpu.wire.codec import decode_frame as jax_decode_frame
from odigos_tpu.wire.codec import encode_batch as jax_encode
from odigos_tpu_torch.features import FeaturizerConfig, featurize
from odigos_tpu_torch.features.featurizer import (featurize_columns,
                                                  featurize_join_torch)
from odigos_tpu_torch.kernels import (featurize as kfeat, head as khead,
                                      pack as kpack, sort as ksort)
from odigos_tpu_torch.models import TransformerConfig, flax_to_torch
from odigos_tpu_torch.pdata import adversarial_traces, concat_batches
from odigos_tpu_torch.pdata import synthesize_traces as psynth
from odigos_tpu_torch.serving import EngineConfig, ScoringEngine
from odigos_tpu_torch.serving import fused
from odigos_tpu_torch.serving.engine import (FUSED_FALLBACK_METRIC,
                                             FUSED_FRAMES_METRIC)
from odigos_tpu_torch.serving.fused import (FALLBACK_REASONS,
                                            _device_tables, _span_bucket,
                                            device_table_bytes,
                                            extract_columns, fused_enabled)
from odigos_tpu_torch.wire.codec import decode_frame, encode_batch

torch.set_num_threads(1)

FUSED_RTOL = 2e-5   # tests/test_fused.py: the reference's own bound
FUSED_ATOL = 1e-6
F32_TOL = 1e-5      # the port's f32 model bound vs the JAX package
TINY = dict(d_model=32, n_heads=2, n_layers=1, d_ff=64, max_len=16)
HIGH = np.uint64(1 << 63)
ORPHAN = np.uint64(0xDEADBEEFCAFEF00D)


def _engines(max_len: int = 16):
    tiny = dict(TINY, max_len=max_len)
    je = JaxEngine(JaxEngineConfig(
        model="transformer", model_config=JaxConfig(**tiny,
                                                    dtype=jnp.float32),
        max_len=max_len, trace_bucket=8, bucket_ladder=2))
    pe = ScoringEngine(EngineConfig(
        model="transformer", device="cpu", max_len=max_len, trace_bucket=8,
        bucket_ladder=2,
        model_config=TransformerConfig(**tiny, dtype=torch.float32)))
    pe.backend.model.load_state_dict(flax_to_torch(
        jax.tree_util.tree_map(np.asarray, je.backend.variables),
        pe.backend.model.cfg))
    return je, pe


@pytest.fixture(scope="module")
def engines():
    """Unstarted JAX and port engines (direct backend use) with the same
    f32 weights."""
    return _engines()


@pytest.fixture(scope="module")
def engines8():
    """The same at max_len 8: synthetic traces (up to 17 spans) split."""
    return _engines(8)


# ------------------------------------------------------------- the frames


def _mutate(batch, kind: str):
    """The same change to a JAX or a port SpanBatch."""
    cols = dict(batch.columns)
    if kind == "orphan":
        par = cols["parent_span_id"].copy()
        par[::3] = ORPHAN  # no such span anywhere
        cols["parent_span_id"] = par
    elif kind == "high_bit":
        # top bit set on every id: unsigned order differs from signed
        for name in ("span_id", "trace_id_hi", "trace_id_lo"):
            cols[name] = cols[name] | HIGH
        par = cols["parent_span_id"]
        cols["parent_span_id"] = np.where(par == 0, par, par | HIGH)
        # and on half the traces' hi word only (a mixed-sign key word)
        flip = (cols["trace_id_hi"] & np.uint64(1)) == 0
        cols["trace_id_hi"] = np.where(flip, cols["trace_id_hi"] & ~HIGH,
                                       cols["trace_id_hi"])
    elif kind == "duplicate":
        span = cols["span_id"].copy()
        span[1::4] = span[0::4][:len(span[1::4])]  # two rows declare one id
        cols["span_id"] = span
    elif kind == "end_before_start":
        end = cols["end_unix_nano"].copy()
        end[::5] = cols["start_unix_nano"][::5] - np.uint64(7)
        cols["end_unix_nano"] = end
    elif kind == "tied_starts":
        start = cols["start_unix_nano"].copy()
        start[:] = start[0]  # every span starts at once: order is stability
        cols["start_unix_nano"] = start
    elif kind == "long_trace":
        # one trace of 40 spans: several chunks at any L <= 16
        lo = cols["trace_id_lo"].copy()
        hi = cols["trace_id_hi"].copy()
        lo[:40] = lo[0]
        hi[:40] = hi[0]
        cols["trace_id_lo"] = lo
        cols["trace_id_hi"] = hi
    else:
        assert kind == "plain", kind
    return replace(batch, columns=cols)


def _both(n_traces: int, seed: int, kind: str = "plain"):
    return (_mutate(jsynth(n_traces, seed=seed), kind),
            _mutate(psynth(n_traces, seed=seed), kind))


def _jax_cols(batches):
    cols = [jax_extract(b)[0] for b in batches]
    assert all(c is not None for c in cols)
    return cols


def _port_cols(batches):
    out = []
    for b in batches:
        c, reason = extract_columns(b)
        assert reason is None
        out.append(c)
    return out


def _jax_features_and_pack(je, cols, L, rows):
    """The JAX fused route's featurize and pack, as its jit composes
    them, on the CPU."""
    be = je.backend
    n = sum(len(c) for c in cols)
    N = _span_bucket(n)
    tables, arrays = be._prep_columns(cols, N)
    (svc, nam, kind, status, span_lo, span_hi, par_lo, par_hi, start_lo,
     start_hi, end_lo, end_hi, thi_lo, thi_hi, tlo_lo, tlo_hi,
     frame) = (jnp.asarray(a.copy()) for a in arrays)
    cat, cont = featurize_columns_jax(
        *tables, svc, nam, kind, status, span_hi, span_lo, par_hi, par_lo,
        end_hi, end_lo, start_hi, start_lo, frame)
    packed = _build_pack_packed(L)(cat, cont, start_lo, start_hi, thi_lo,
                                   thi_hi, tlo_lo, tlo_hi, frame, rows=rows)
    return n, N, np.asarray(cat), np.asarray(cont), [np.asarray(a)
                                                     for a in packed]


def _port_features(pe, cols):
    be = pe.backend
    n = sum(len(c) for c in cols)
    staged = be._prep_columns(cols, _span_bucket(n))
    c = staged.cols
    cat, cont = kfeat.featurize_columns(
        staged.service_table, staged.name_table, c["service"], c["name"],
        c["kind"], c["status_code"], c["span_id"], c["parent_span_id"],
        c["start_unix_nano"], c["end_unix_nano"], c["frame"], n)
    return staged, cat, cont


# ------------------------------------------------------- featurize twin

FEATURIZE_CASES = [("plain", 0), ("plain", 7), ("orphan", 11),
                   ("duplicate", 12), ("high_bit", 13),
                   ("end_before_start", 14)]


@pytest.mark.parametrize("kind,seed", FEATURIZE_CASES,
                         ids=[f"{k}-{s}" for k, s in FEATURIZE_CASES])
def test_featurize_twin_matches_jax_and_host(engines, kind, seed):
    je, pe = engines
    jb, pb = _both(48, seed, kind)
    n, N, jcat, jcont, _ = _jax_features_and_pack(je, _jax_cols([jb]), 16,
                                                  8)
    _, cat, cont = _port_features(pe, _port_cols([pb]))
    cat, cont = cat.numpy(), cont.numpy()
    assert cat.shape == (N, 5) and cont.shape == (N, 3)
    np.testing.assert_array_equal(cat[:n], jcat[:n])
    np.testing.assert_allclose(cont[:n], jcont[:n], rtol=FUSED_RTOL,
                               atol=FUSED_ATOL)
    assert not cat[n:].any() and not cont[n:].any()
    host = featurize_columns(_port_cols([pb])[0])
    np.testing.assert_array_equal(cat[:n], host.categorical)
    np.testing.assert_array_equal(cont[:n], host.continuous)


def test_featurize_twin_joins_each_frame_alone(engines):
    """A coalesced group of three frames, the first and last the same
    frame (the same span ids in two frames of one group): each joins only
    itself, as the host featurizes each request on its own."""
    je, pe = engines
    pairs = [_both(n, s) for n, s in ((9, 21), (13, 22), (9, 21))]
    jbs, pbs = [p[0] for p in pairs], [p[1] for p in pairs]
    n, _, jcat, jcont, _ = _jax_features_and_pack(je, _jax_cols(jbs), 16, 8)
    _, cat, cont = _port_features(pe, _port_cols(pbs))
    np.testing.assert_array_equal(cat.numpy()[:n], jcat[:n])
    np.testing.assert_allclose(cont.numpy()[:n], jcont[:n], rtol=FUSED_RTOL,
                               atol=FUSED_ATOL)
    host = [featurize(b) for b in pbs]
    np.testing.assert_array_equal(
        cat.numpy()[:n], np.concatenate([h.categorical for h in host]))
    np.testing.assert_array_equal(
        cont.numpy()[:n], np.concatenate([h.continuous for h in host]))


def test_featurize_join_first_duplicate_wins_and_orphans_miss():
    """Pinned by hand: rows 1 and 3 declare id 5 in frame 0, row 4 declares
    it in frame 1; the first row of the parent's own frame wins; an id
    that resolves nowhere is not found."""
    span = torch.tensor([9, 5, 7, 5, 5, 0], dtype=torch.int64)
    parent = torch.tensor([5, 0, 5, 8, 5, 0], dtype=torch.int64)
    frame = torch.tensor([0, 0, 0, 0, 1, -1], dtype=torch.int32)
    svc_ids = torch.tensor([10, 11, 12, 13, 14, 0], dtype=torch.int32)
    found, psvc = featurize_join_torch(svc_ids, span, parent, frame, 5)
    assert found.tolist() == [True, False, True, False, True, False]
    assert psvc.tolist() == [11, 0, 11, 0, 14, 0]


# ----------------------------------------------------- sort + pack twin

PACK_CASES = [(16, "plain", 0), (16, "high_bit", 13),
              (16, "tied_starts", 15), (8, "plain", 1),
              (8, "long_trace", 16)]


def _check_pack_twin(pk, perm, jpacked, n, N, R_port, R_jax):
    catp, contp, segs, poss, jperm, row_eff, span_col, pad_s = jpacked
    np.testing.assert_array_equal(perm.numpy(), jperm)
    np.testing.assert_array_equal(np.arange(N) >= n, pad_s)
    np.testing.assert_array_equal(pk.row_eff.numpy()[:n], row_eff[:n])
    np.testing.assert_array_equal(pk.span_col.numpy()[:n], span_col[:n])
    assert (pk.row_eff.numpy()[n:] == R_port).all()
    assert (row_eff[n:] == R_jax).all()
    r = min(R_port, R_jax)
    for mine, ref in ((pk.categorical, catp), (pk.continuous, contp),
                      (pk.segments, segs), (pk.positions, poss)):
        mine = mine.numpy()
        np.testing.assert_array_equal(mine[:r], ref[:r])
        assert not mine[r:].any() and not ref[r:].any()
    assert int(pk.rows_used[0]) == int(np.max(row_eff[:n])) + 1


@pytest.mark.parametrize("L,kind,seed", PACK_CASES,
                         ids=[f"L{L}-{k}-{s}" for L, k, s in PACK_CASES])
def test_sort_and_pack_twin_match_jax(engines, L, kind, seed):
    je, pe = engines
    jb, pb = _both(40, seed, kind)
    n = len(pb)
    N = _span_bucket(n)
    R_jax = JaxLadder(8, 2).round_rows(2 * N // L + 2)
    R_port = pe.backend.ladder.round_rows(2 * n // L + 2)
    assert R_port <= R_jax
    _, _, jcat, jcont, jpacked = _jax_features_and_pack(
        je, _jax_cols([jb]), L, R_jax)
    staged = pe.backend._prep_columns(_port_cols([pb]), N)
    c = staged.cols
    perm = ksort.radix_sort([c["trace_id_hi"], c["trace_id_lo"],
                             c["start_unix_nano"]], n)
    pk = kpack.next_fit_pack(perm, c["trace_id_hi"], c["trace_id_lo"],
                             torch.from_numpy(jcat.copy()), torch.from_numpy(jcont.copy()),
                             n, L, R_port)
    _check_pack_twin(pk, perm, jpacked, n, N, R_port, R_jax)


def test_sort_and_pack_twin_shared_trace_ids_across_frames(engines):
    """Frames 0 and 2 carry the same traces: they pack as one trace each,
    spans interleaved by start time, exactly as the host sort does."""
    je, pe = engines
    pairs = [_both(n, s) for n, s in ((9, 21), (13, 22), (9, 21))]
    jbs, pbs = [p[0] for p in pairs], [p[1] for p in pairs]
    n = sum(len(b) for b in pbs)
    N = _span_bucket(n)
    L = 16
    R_jax = JaxLadder(8, 2).round_rows(2 * N // L + 2)
    R_port = pe.backend.ladder.round_rows(2 * n // L + 2)
    _, _, jcat, jcont, jpacked = _jax_features_and_pack(
        je, _jax_cols(jbs), L, R_jax)
    staged = pe.backend._prep_columns(_port_cols(pbs), N)
    c = staged.cols
    perm = ksort.radix_sort([c["trace_id_hi"], c["trace_id_lo"],
                             c["start_unix_nano"]], n)
    pk = kpack.next_fit_pack(perm, c["trace_id_hi"], c["trace_id_lo"],
                             torch.from_numpy(jcat.copy()), torch.from_numpy(jcont.copy()),
                             n, L, R_port)
    _check_pack_twin(pk, perm, jpacked, n, N, R_port, R_jax)


def test_radix_sort_plain_is_stable_and_unsigned():
    keys = np.array([3, 1 << 63, 3, 1, (1 << 64) - 1, 1], np.uint64)
    sub = np.array([2, 0, 1, 0, 0, 0], np.int32)
    perm = ksort.radix_sort([torch.from_numpy(keys.view(np.int64)),
                             torch.from_numpy(sub)], 6)
    want = np.lexsort((sub, keys))  # numpy's lexsort is stable, unsigned
    np.testing.assert_array_equal(perm.numpy(), want)
    padded = ksort.radix_sort([torch.from_numpy(keys.view(np.int64))], 4)
    np.testing.assert_array_equal(padded.numpy()[4:], [4, 5])
    np.testing.assert_array_equal(padded.numpy()[:4],
                                  np.argsort(keys[:4], kind="stable"))


def _k6_model(keys, n: int, N: int, max_grid: int):
    """K6's own algorithm on the host: the grid of ``ksort.plan``, each
    block owning a run of ``ksort.TILE``-key tiles; the live digits from
    the OR and complement-OR of each word (a constant digit is skipped);
    per live digit the block counts, the offsets (smaller digits anywhere,
    then the same digit in earlier blocks) and each key's stable rank in
    its block. Returns the permutation (the identity past n) and the
    number of live passes."""
    grid, tpb = ksort.plan(n, N, max_grid)
    assert grid <= max_grid and grid * tpb * ksort.TILE >= n
    span = tpb * ksort.TILE
    words, bits = [], []
    for k in keys[::-1]:  # least significant first, as the kernel takes
        k = np.asarray(k)
        bits.append(8 * k.dtype.itemsize)
        words.append(k[:n].view(np.uint64) if k.dtype.itemsize == 8
                     else k[:n].view(np.uint32).astype(np.uint64))
    live = []
    for w, (word, nbits) in enumerate(zip(words, bits)):
        mask = np.uint64((1 << nbits) - 1)
        var = (np.bitwise_or.reduce(word) & np.bitwise_or.reduce(~word & mask)
               if n else np.uint64(0))
        live += [(w, sh) for sh in range(0, nbits, 8)
                 if int(var >> np.uint64(sh)) & 0xFF]
    order = np.arange(n)
    block = np.arange(n) // span
    for w, sh in live:
        d = ((words[w][order] >> np.uint64(sh)) & np.uint64(0xFF)).astype(
            np.int64)
        counts = np.zeros((grid, 256), np.int64)
        np.add.at(counts, (block, d), 1)
        total = counts.sum(0)
        base = np.cumsum(total) - total
        before = np.cumsum(counts, 0) - counts
        group = block * 256 + d
        by_group = np.argsort(group, kind="stable")
        starts = np.searchsorted(group[by_group], group[by_group])
        rank = np.empty(n, np.int64)
        rank[by_group] = np.arange(n) - starts
        new = np.empty(n, np.int64)
        new[base[d] + before[block, d] + rank] = order
        order = new
    return np.concatenate([order, np.arange(n, N)]), len(live)


@pytest.mark.parametrize("max_grid", [3, 264])
@pytest.mark.parametrize("sort", ["trace", "join"])
def test_k6_model_matches_lexsort_on_the_adversarial_frame(sort, max_grid):
    """K6's digit skip, grid plan and tile loop, run on the host, against
    np.lexsort on the adversarial frame (ids at or above 2^63, a 200-span
    trace, tied starts, duplicate span ids) with one frame holding every
    span; max_grid 3 makes each block walk several tiles."""
    cols = adversarial_traces(2400, seed=62).columns
    n = len(cols["span_id"])
    N = n + 37  # padding rows keep the identity
    assert n > 3 * ksort.TILE

    def padded(a):
        return np.concatenate([a, np.zeros(N - n, a.dtype)])

    if sort == "trace":
        keys = [padded(cols[k]) for k in ("trace_id_hi", "trace_id_lo",
                                          "start_unix_nano")]
    else:
        keys = [np.zeros(N, np.int32), padded(cols["span_id"])]
    got, passes = _k6_model(keys, n, N, max_grid)
    want = np.lexsort([k[:n] for k in keys[::-1]])
    np.testing.assert_array_equal(got[:n], want)
    np.testing.assert_array_equal(got[n:], np.arange(n, N))
    assert (sort == "join") == (passes <= 8)  # the frame word is constant
    plain = ksort.radix_sort_plain(
        [torch.from_numpy(k.view(np.int64) if k.dtype == np.uint64 else k)
         for k in keys], n)
    np.testing.assert_array_equal(plain.numpy(), got)


def _k7_walk_model(seg_start: np.ndarray, L: int, chunks: int, W: int):
    """K7's walk on the host: the row starts as the orbit of span 0 under
    nxt(p) (the highest segment start in (p, p + L]), found by chunks of W
    spans. (1) From each of a chunk's candidates (the segment starts in its
    first L spans) walk to the first start past the chunk: its candidate
    index in the next chunk (or the end, or a broken layout) and the rows
    started inside; (2) compose the chunks' tables from span 0; (3) walk
    each chunk again from its true entry. Returns the row starts and the
    rows used (-1 on a broken layout)."""
    n = len(seg_start)
    starts = np.flatnonzero(seg_start)
    END, BROKEN = -1, -2

    def nxt(p):
        i = np.searchsorted(starts, p + L, side="right") - 1
        return int(starts[i]) if i >= 0 and starts[i] > p else -1

    def candidates(c):
        lo = c * W
        return starts[(starts >= lo) & (starts < min(lo + L, n))]

    tab = {}
    for c in range(chunks):
        end = c * W + W
        for k, p in enumerate(candidates(c).tolist()):
            rows = 0
            while True:
                rows += 1
                if p + L >= n:
                    out = END
                    break
                b = nxt(p)
                if b < 0:
                    out = BROKEN
                    break
                p = b
                if p >= end:
                    out = int(((starts >= end) & (starts <= p)).sum()) - 1
                    break
            tab[c, k] = (out, rows)
    k, r, entry, base = 0, 0, [], []
    for c in range(chunks):
        entry.append(k)
        base.append(r)
        if k >= 0:
            out, rows = tab[c, k]
            r += rows
            k = out
    rows_used = -1 if k == BROKEN else r
    rs: list[int] = []
    for c in range(chunks):
        if entry[c] < 0:
            continue
        assert base[c] == len(rs)
        end, p = c * W + W, int(candidates(c)[entry[c]])
        while True:
            rs.append(p)
            if p + L >= n:
                break
            b = nxt(p)
            if b < 0 or b >= end:
                break
            p = b
    return np.asarray(rs, np.int64), rows_used


def _k7_frame(kind: str, seed: int):
    """A frame's trace ids, starts and row count: the otel mix, the
    adversarial frame, or traces longer than L (six otel traces merged
    into one, ~60 spans)."""
    if kind == "adversarial":
        cols = adversarial_traces(300, seed=seed).columns
    else:
        cols = psynth(300, seed=seed).columns
    hi, lo = cols["trace_id_hi"], cols["trace_id_lo"]
    if kind == "long":
        _, tr = np.unique(np.stack([hi, lo], 1), axis=0, return_inverse=True)
        tr = tr.reshape(-1) // 6
        hi, lo = (tr + 1).astype(np.uint64), np.zeros_like(lo)
    return hi, lo, cols["start_unix_nano"]


K7_GEOMETRY = ["plan", "W=L", "W=2L+3", "W=5L"]


@pytest.mark.parametrize("geometry", K7_GEOMETRY)
@pytest.mark.parametrize("L", [8, 16, 64])
@pytest.mark.parametrize("kind,seed", [("otel", 1), ("otel", 2),
                                       ("adversarial", 3),
                                       ("adversarial", 4), ("long", 5),
                                       ("long", 6)])
def test_k7_walk_model_matches_pack_arrays_rows(kind, seed, L, geometry):
    """K7's chunked walk, run on the host, gives the host packer's rows:
    each row's first span (in trace order) and the row count, with the
    walk's own plan and with chunks as short as L (every chunk boundary a
    candidate window)."""
    from odigos_tpu_torch.features.featurizer import pack_arrays

    hi, lo, start = _k7_frame(kind, seed)
    n = len(hi)
    pk = pack_arrays(hi, lo, start, np.zeros((n, 1), np.int32),
                     np.zeros((n, 1), np.float32), max_len=L)
    order = np.lexsort((start, lo, hi))
    sorted_at = np.empty(n, np.int64)
    sorted_at[order] = np.arange(n)
    want = sorted_at[pk.span_index[:, 0]]
    # the layout's segment starts: a position in the trace that is a
    # multiple of L
    hs, ls = hi[order], lo[order]
    new = np.ones(n, bool)
    new[1:] = (hs[1:] != hs[:-1]) | (ls[1:] != ls[:-1])
    idx = np.arange(n)
    first = np.maximum.accumulate(np.where(new, idx, 0))
    seg_start = (idx - first) % L == 0
    if kind == "long":
        assert (np.bincount(np.cumsum(new) - 1) > L).any()
    if geometry == "plan":
        chunks, W = kpack.walk_plan(n, L)
    else:
        W = {"W=L": L, "W=2L+3": 2 * L + 3, "W=5L": 5 * L}[geometry]
        chunks = -(-n // W)
    assert chunks * W >= n and (chunks == 1 or W >= L)
    rs, rows_used = _k7_walk_model(seg_start, L, chunks, W)
    assert rows_used == len(want) == len(rs)
    np.testing.assert_array_equal(rs, want)


def test_k7_walk_model_reports_a_broken_layout():
    """No segment start within L spans of a row start (a layout that
    cannot come from traces): rows_used is -1, as the walk signals it."""
    seg = np.zeros(40, bool)
    seg[[0, 5, 30]] = True
    for chunks, W in ((1, 40), (5, 8)):
        assert _k7_walk_model(seg, 8, chunks, W)[1] == -1


@pytest.mark.parametrize("n,L", [(0, 64), (1, 64), (2047, 64), (2048, 64),
                                 (2049, 64), (63112, 64), (126509, 64),
                                 (10 ** 6, 64), (5000, 1), (10 ** 6, 1024)])
def test_k7_walk_plan_covers_the_spans(n, L):
    chunks, W = kpack.walk_plan(n, L)
    assert chunks * W >= n and chunks * L <= kpack.WALK_SLOTS
    assert chunks == 0 if n == 0 else (chunks - 1) * W < n
    assert chunks <= 1 or W >= L


def test_span_head_scatter_plain_matches_the_model_path(engines):
    """K8's plain version is the port's LayerNorm → span_head → sigmoid →
    scatter: the same probabilities as ``score_packed`` at each span."""
    _, pe = engines
    model = pe.backend.model
    pb = psynth(20, seed=5)
    from odigos_tpu_torch.features import pack_sequences
    pk = pack_sequences(pb, featurize(pb), max_len=16)
    probs = model.score_packed(pk.categorical, pk.continuous, pk.segments,
                               pk.positions).numpy()
    want = np.zeros(len(pb), np.float32)
    want[pk.span_index[pk.mask]] = probs[pk.mask]
    rows, cols = np.nonzero(pk.mask)
    got = model.score_packed_scatter(
        pk.categorical, pk.continuous, pk.segments, pk.positions,
        torch.from_numpy(pk.span_index[rows, cols]),
        torch.from_numpy(rows.astype(np.int32)),
        torch.from_numpy(cols.astype(np.int32)), len(rows)).numpy()
    np.testing.assert_array_equal(got, want)
    assert khead.launches == 0  # the CPU never launches a kernel


# -------------------------------------------------------------- the slice

SLICE_CASES = [("plain", 3), ("plain", 4), ("orphan", 11),
               ("high_bit", 13)]


@pytest.mark.parametrize("kind,seed", SLICE_CASES,
                         ids=[f"{k}-{s}" for k, s in SLICE_CASES])
def test_fused_scores_match_jax_fused_backend(engines, kind, seed):
    je, pe = engines
    jb, pb = _both(40, seed, kind)
    ref = je.backend.harvest(je.backend.dispatch_columns(_jax_cols([jb])))
    got = pe.backend.harvest(pe.backend.dispatch_columns(_port_cols([pb])))
    assert got.shape == ref.shape == (len(pb),)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=F32_TOL, atol=F32_TOL)
    # the port's R is sized by the real spans, the reference's by the
    # bucket: fewer (or as many) rows, the same scores
    assert pe.backend.last_shape[0] <= je.backend.last_shape[0]
    host = pe.backend.score(pb, featurize(pb))
    np.testing.assert_allclose(got, host, rtol=FUSED_RTOL, atol=FUSED_ATOL)


def test_fused_scores_match_jax_on_truncated_traces(engines8):
    je, pe = engines8
    jb, pb = _both(30, 6, "long_trace")
    ref = je.backend.harvest(je.backend.dispatch_columns(_jax_cols([jb])))
    got = pe.backend.harvest(pe.backend.dispatch_columns(_port_cols([pb])))
    np.testing.assert_allclose(got, ref, rtol=F32_TOL, atol=F32_TOL)
    host = pe.backend.score(pb, featurize(pb))
    np.testing.assert_allclose(got, host, rtol=FUSED_RTOL, atol=FUSED_ATOL)


def test_fused_multi_frame_group_matches_jax_and_host(engines):
    je, pe = engines
    pairs = [_both(n, s) for n, s in ((9, 21), (13, 22), (9, 21))]
    jbs, pbs = [p[0] for p in pairs], [p[1] for p in pairs]
    ref = je.backend.harvest(je.backend.dispatch_columns(_jax_cols(jbs)))
    got = pe.backend.harvest(pe.backend.dispatch_columns(_port_cols(pbs)))
    np.testing.assert_allclose(got, ref, rtol=F32_TOL, atol=F32_TOL)
    from odigos_tpu_torch.features import SpanFeatures
    feats = [featurize(b) for b in pbs]
    merged = SpanFeatures(np.concatenate([f.categorical for f in feats]),
                          np.concatenate([f.continuous for f in feats]))
    host = pe.backend.score(concat_batches(pbs), merged)
    np.testing.assert_allclose(got, host, rtol=FUSED_RTOL, atol=FUSED_ATOL)


def test_fused_rows_follow_the_real_span_count(engines):
    """The departure, pinned: R = round_rows(2 n / L + 2) from the real
    span count, and next-fit's rows fit inside it."""
    _, pe = engines
    be = pe.backend
    pb = psynth(40, seed=3)
    be.harvest(be.dispatch_columns(_port_cols([pb])))
    n = len(pb)
    assert be.last_shape == [be.ladder.round_rows(2 * n // 16 + 2), 16]
    assert be.last_span_bucket == _span_bucket(n)
    assert 0 < be.last_rows_real <= be.last_shape[0]


# -------------------------------------------------------- fallback ladder


def _legacy_pair(seed: int = 0):
    jb, _ = jax_decode_frame(jax_encode(jsynth(8, seed=seed),
                                        attr_format="json"))
    pb, _ = decode_frame(encode_batch(psynth(8, seed=seed),
                                      attr_format="json"))
    return jb, pb


def _misaligned(batch):
    doubled = np.repeat(batch.col("span_id"), 2)
    cols = dict(batch.columns)
    cols["span_id"] = doubled[::2]
    return replace(batch, columns=cols)


def test_fallback_reasons_are_the_references():
    assert FALLBACK_REASONS == JAX_REASONS


@pytest.mark.parametrize("case", ["covered", "zero_span", "attr_slots",
                                  "legacy_attrs", "misaligned_columns"])
def test_fallback_ladder_matches_jax(case):
    jb, pb = jsynth(8, seed=0), psynth(8, seed=0)
    cfg = None
    if case == "zero_span":
        jb, pb = (b.filter(np.zeros(len(b), bool)) for b in (jb, pb))
    elif case == "attr_slots":
        cfg = 4
    elif case == "legacy_attrs":
        jb, pb = _legacy_pair()
    elif case == "misaligned_columns":
        jb, pb = _misaligned(jb), _misaligned(pb)
    from odigos_tpu.features import FeaturizerConfig as JaxFeatCfg
    jcols, jreason = jax_extract(
        jb, JaxFeatCfg(attr_slots=cfg) if cfg else None)
    pcols, preason = extract_columns(
        pb, FeaturizerConfig(attr_slots=cfg) if cfg else None)
    assert preason == jreason
    assert (pcols is None) == (jcols is None)
    assert preason == (None if case == "covered" else case)
    if pcols is not None:
        assert len(pcols) == len(pb) > 0


@pytest.mark.parametrize("model", ["mock", "zscore"])
def test_serial_backends_are_not_fused_capable(model):
    eng = ScoringEngine(EngineConfig(model=model, device="cpu"))
    assert not getattr(eng.backend, "supports_fused", False)


def test_attr_slot_transformer_is_not_fused_capable():
    eng = ScoringEngine(EngineConfig(
        model="transformer", device="cpu", max_len=16, trace_bucket=8,
        featurizer=FeaturizerConfig(attr_slots=2),
        model_config=TransformerConfig(**TINY, attr_slots=2,
                                       dtype=torch.float32)))
    assert not eng.backend.supports_fused


def test_kill_switch_env(monkeypatch):
    monkeypatch.delenv("ODIGOS_FUSED", raising=False)
    assert fused_enabled()
    monkeypatch.setenv("ODIGOS_FUSED", "0")
    assert not fused_enabled()
    monkeypatch.setenv("ODIGOS_FUSED", "1")
    assert fused_enabled()


def test_engine_does_not_read_the_kill_switch():
    src = open(os.path.join(os.path.dirname(fused.__file__),
                            "engine.py")).read()
    assert "ODIGOS_FUSED" not in src


# ------------------------------------------------------------- the engine


def _fresh_engine(model: str = "transformer", **kw) -> ScoringEngine:
    if model != "transformer":
        return ScoringEngine(EngineConfig(model=model, device="cpu", **kw))
    eng = ScoringEngine(EngineConfig(
        model="transformer", device="cpu", max_len=16, trace_bucket=8,
        bucket_ladder=2,
        model_config=TransformerConfig(**TINY, dtype=torch.float32), **kw))
    return eng


def test_engine_coalesces_columns_requests_into_one_fused_call():
    eng = _fresh_engine()
    batches = [psynth(n, seed=s) for n, s in ((7, 31), (11, 32), (5, 33))]
    # queued before the worker starts: the pack stage drains them together
    reqs = [eng.submit(b, columns=extract_columns(b)[0]) for b in batches]
    assert all(r is not None and r.features is None for r in reqs)
    eng.start()
    try:
        for r in reqs:
            assert r.done.wait(60)
        stats = eng.stats()
    finally:
        eng.shutdown()
    assert stats["fused_calls"] == 1
    assert stats[FUSED_FRAMES_METRIC] == 3
    assert stats["device_calls"] == 1
    assert stats["stage_ms_p50_by_route"]["fused"]["pack_ms"] > 0
    for b, r in zip(batches, reqs):
        want = eng.backend.score(b, featurize(b))
        np.testing.assert_allclose(r.scores, want, rtol=FUSED_RTOL,
                                   atol=FUSED_ATOL)


def test_engine_mixed_group_takes_the_host_route_and_is_counted():
    eng = _fresh_engine()
    b1, b2 = psynth(6, seed=41), psynth(9, seed=42)
    r1 = eng.submit(b1, columns=extract_columns(b1)[0])
    r2 = eng.submit(b2)
    eng.start()
    try:
        assert r1.done.wait(60) and r2.done.wait(60)
        stats = eng.stats()
    finally:
        eng.shutdown()
    assert stats["fused_calls"] == 0 and stats[FUSED_FRAMES_METRIC] == 0
    assert stats["fused_mixed_group_frames"] == 1
    assert r1.features is not None  # featurized in the pack stage
    for b, r in ((b1, r1), (b2, r2)):
        want = eng.backend.score(b, featurize(b))
        np.testing.assert_allclose(r.scores, want, rtol=FUSED_RTOL,
                                   atol=FUSED_ATOL)


def test_engine_counts_columns_on_a_backend_without_fused_kernels():
    eng = _fresh_engine("zscore")
    b = psynth(6, seed=43)
    eng.start()
    try:
        got = eng.score_sync(b, timeout_s=60)
        req = eng.submit(b, columns=extract_columns(b)[0])
        assert req.done.wait(60)
        stats = eng.stats()
    finally:
        eng.shutdown()
    assert req.scores is not None and req.scores.shape == got.shape
    assert stats[FUSED_FALLBACK_METRIC]["backend"] == 1
    assert set(stats[FUSED_FALLBACK_METRIC]) == set(FALLBACK_REASONS)


def test_engine_counts_a_callers_fallback_reason():
    eng = _fresh_engine()
    _, legacy = _legacy_pair()
    cols, reason = extract_columns(legacy)
    assert cols is None
    eng.count_fused_fallback(reason)
    assert eng.stats()[FUSED_FALLBACK_METRIC]["legacy_attrs"] == 1
    with pytest.raises(ValueError):
        eng.count_fused_fallback("no_such_reason")


def test_engine_shutdown_drains_fused_calls_losslessly():
    eng = _fresh_engine(max_batch_spans=64)
    batches = [psynth(4, seed=50 + i) for i in range(6)]
    reqs = [eng.submit(b, columns=extract_columns(b)[0]) for b in batches]
    eng.start()
    eng.shutdown()
    for b, r in zip(batches, reqs):
        assert r.done.is_set() and r.scores is not None
        assert r.scores.shape == (len(b),)
    assert eng.fused_frames == len(batches)
    assert eng.fused_calls >= 2  # the 64-span cap splits the queue


def test_warm_ladder_runs_the_fused_route_per_span_bucket():
    eng = _fresh_engine(max_batch_spans=1024, warm_ladder=True)
    eng.start()
    eng.shutdown()
    shapes = list(eng.backend._fused_shapes)
    assert [N for N, _ in shapes] == [512, 1024]


def test_device_tables_are_reused_and_counted():
    strings = ("table-test-svc", "table-test-op", "table-test-svc-2")
    before = device_table_bytes()
    a = _device_tables(strings, 512, 2048, "cpu")
    mid = device_table_bytes()
    b = _device_tables(strings, 512, 2048, "cpu")
    assert a[0] is b[0] and a[1] is b[1]
    assert device_table_bytes() == mid
    assert mid - before == 2 * 1024 * 4  # two int32 tables of 1024
    assert a[0].dtype == torch.int32 and a[0].shape == (1024,)

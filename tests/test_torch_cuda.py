"""The port's CUDA kernels and GPU serving path, held to the plain versions.

Every test here needs a CUDA device: each is marked ``cuda`` and skips
with a reason where ``torch.cuda.is_available()`` is false, so on the CPU
none of them runs. This file imports nothing of JAX or of ``odigos_tpu``,
so it runs on the card's machine, which has no JAX:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest``: ``tests/conftest.py`` imports jax.)

Bounds: a kernel and its plain version compute in f32 from the same inputs
and round once, so in bf16 they may differ by one rounding step at the
largest output magnitude (2^-7 relative); in f32 by summation order only.
The fused route's kernels: K6's permutation and K7's rows, K5's categorical
block and every integer output are held exactly; K5's log-duration within
one f32 step (``FEAT_CONT_RTOL``: both take log1p in f64 and round once to
f32, the card's log1p within an ulp of the CPU's); K8's probabilities
within ``HEAD_F32_ATOL`` in f32 and ``HEAD_BF16_ATOL`` in bf16 (its
LayerNorm output has the plain version's bits, K14's exact arithmetic, so
the two differ only by the f32 head dot's summation order and the
sigmoid's last bits).
The zscore kernels (K3, K4) take the same f32 per-span terms as their plain
versions and sum them in f64 as they do, in another order (atomics): the
state agrees with the plain version's within ``ZS_MEAN_ATOL`` /
``ZS_M2_RTOL`` / ``ZS_M2_ATOL`` (a rounding of an f64 sum to f32 may land
one f32 step apart; tighter than the reference's own streaming bound, mean
atol 1e-4 and M2 rtol 1e-3 / atol 1e-3), ``count`` exactly; z and the
squashed score are IEEE-rounded the same way, within ``ZS_Z_RTOL``.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from odigos_tpu_torch.features import featurize, pack_sequences
from odigos_tpu_torch.kernels import attention, embed, zscore
from odigos_tpu_torch.kernels.attention import (segment_attention,
                                                segment_attention_plain)
from odigos_tpu_torch.kernels.embed import (EmbedTables, span_embed,
                                            span_embed_plain)
from odigos_tpu_torch.features import FeaturizerConfig
from odigos_tpu_torch.models import (TraceTransformer, TransformerConfig,
                                     ZScoreDetector)
from odigos_tpu_torch.kernels import featurize as kfeat
from odigos_tpu_torch.kernels import head as khead
from odigos_tpu_torch.kernels import pack as kpack
from odigos_tpu_torch.kernels import sort as ksort
from odigos_tpu_torch.pdata import (adversarial_traces, join_stress_frames,
                                    synthesize_traces)
from odigos_tpu_torch.serving import EngineConfig, ScoringEngine
from odigos_tpu_torch.serving.fused import _span_bucket, extract_columns

pytestmark = pytest.mark.cuda

F32_ATOL = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is "
                    "false (chip_smoke.py runs these checks on the H100)")
    return torch.device("cuda")


def _step(ref: torch.Tensor) -> float:
    """One bf16 rounding step at the largest magnitude of ``ref``."""
    return 2.0 ** (math.floor(math.log2(ref.float().abs().max().item())) - 7)


def _packed(n_traces: int, max_len: int, attr_slots: int = 0, pad: int = 0):
    batch = synthesize_traces(n_traces, seed=3)
    return pack_sequences(batch, featurize(
        batch, FeaturizerConfig(attr_slots=attr_slots)), max_len=max_len,
        pad_rows_to=lambda r: r + pad)


def _qkv(dev, R, L, H, hd, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(R, L, H, hd, generator=g, device=dev).to(dtype)
            for _ in range(3)]


def _attend_and_check(q, k, v, seg, atol=None):
    """Launch K1 once, hold it to the plain version, return the output."""
    before = attention.launches
    got = segment_attention(q, k, v, seg)
    ref = segment_attention_plain(q, k, v, seg)
    torch.cuda.synchronize()
    assert attention.launches == before + 1
    assert torch.isfinite(got.float()).all()
    atol = _step(ref) if atol is None else atol
    assert (got.float() - ref.float()).abs().max().item() <= atol
    return got


@pytest.mark.parametrize("L,H,hd", [(64, 4, 64), (16, 2, 32), (40, 3, 48)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segment_attention_kernel_matches_plain(dev, L, H, hd, dtype):
    pk = _packed(300, L, pad=2)        # real rows + 2 all-padding rows
    R = pk.n_rows
    q, k, v = _qkv(dev, R, L, H, hd, getattr(torch, dtype))
    seg = torch.from_numpy(pk.segments).to(dev)
    # bf16 takes the tensor-core kernel (L = 40 pads to 16-key tiles whose
    # extra slots must weigh 0), f32 the CUDA-core one
    want = "tc" if dtype == "bfloat16" else "simt"
    assert attention.kernel_route(q, k, v, seg) == want
    _attend_and_check(q, k, v, seg,
                      atol=F32_ATOL if dtype == "float32" else None)


@pytest.mark.parametrize("R", [1, 133, 1000])
def test_segment_attention_tc_ragged_row_counts(dev, R):
    """R below, between and above multiples of the persistent grid (one
    CTA per SM walking rows), at the main path's geometry."""
    pk = _packed(300, 64, pad=2)
    seg = torch.from_numpy(np.resize(pk.segments, (R, 64))).to(dev)
    q, k, v = _qkv(dev, R, 64, 4, 64, torch.bfloat16, seed=R)
    assert attention.kernel_route(q, k, v, seg) == "tc"
    _attend_and_check(q, k, v, seg)


def test_segment_attention_tc_padding_rows_and_single_slots(dev):
    """An all-padding row (every query averages V uniformly over the L
    slots, as Flax's finite fill gives), rows with one live slot, and a
    row whose only live slots are the last ones."""
    L, H, hd = 40, 2, 64
    seg = np.zeros((5, L), np.int32)
    seg[1, 0] = 1                     # one live slot, first
    seg[2, 23] = 3                    # one live slot, middle
    seg[3, L - 2:] = 2                # two live slots at the end
    seg[4] = np.arange(1, L + 1)      # every slot its own segment
    q, k, v = _qkv(dev, 5, L, H, hd, torch.bfloat16, seed=7)
    seg = torch.from_numpy(seg).to(dev)
    assert attention.kernel_route(q, k, v, seg) == "tc"
    got = _attend_and_check(q, k, v, seg)
    uniform = v[0].float().mean(0)    # (H, hd): the mean over the L slots
    for i in range(L):
        assert (got[0, i].float() - uniform).abs().max().item() <= \
            _step(uniform)
    # a slot alone in its segment attends only to itself
    assert torch.equal(got[1, 0], v[1, 0])
    assert torch.equal(got[2, 23], v[2, 23])
    assert torch.equal(got[4], v[4])


@pytest.mark.parametrize("L,H,hd", [(32, 3, 20), (30, 4, 64)])
def test_segment_attention_simt_takes_bf16_shapes_tc_cannot(dev, L, H, hd):
    """hd % 16 != 0 or L % 4 != 0 has no 16-byte bulk copies: the
    CUDA-core kernel takes those bf16 shapes."""
    pk = _packed(100, L)
    q, k, v = _qkv(dev, pk.n_rows, L, H, hd, torch.bfloat16)
    seg = torch.from_numpy(pk.segments).to(dev)
    assert attention.kernel_route(q, k, v, seg) == "simt"
    _attend_and_check(q, k, v, seg)


def test_segment_attention_refuses_oversized_tiles(dev):
    q = torch.zeros(2, 1025, 1, 16, device=dev, dtype=torch.bfloat16)
    seg = torch.zeros(2, 1025, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="L <= 1024"):
        segment_attention(q, q, q, seg)
    wide = torch.zeros(1, 4, 1, 272, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="hd <= 256"):
        segment_attention(wide, wide, wide, seg[:1, :4].contiguous())
    with pytest.raises(TypeError):
        segment_attention(q[:, :64].contiguous().half(),
                          q[:, :64].contiguous().half(),
                          q[:, :64].contiguous().half(), seg[:, :64])


@pytest.mark.parametrize("attr_slots", [0, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_span_embed_kernel_matches_plain(dev, attr_slots, dtype):
    pk = _packed(300, 64, attr_slots=attr_slots, pad=2)
    model = TraceTransformer(TransformerConfig(attr_slots=attr_slots),
                             device=dev)
    tables = model.module.encoder.tables()
    args = [torch.from_numpy(a).to(dev) for a in (
        pk.categorical, pk.continuous, pk.positions, pk.segments)]
    tdt = getattr(torch, dtype)
    assert embed.vector_path(tables.service.shape[1], tables)
    before = embed.launches
    got = span_embed(*args, tables, tdt)
    ref = span_embed_plain(*args, tables, tdt)
    torch.cuda.synchronize()
    assert embed.launches == before + 1
    assert (got[args[3] == 0] == 0).all()
    atol = F32_ATOL if dtype == "float32" else _step(ref)
    assert (got.float() - ref.float()).abs().max().item() <= atol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_span_embed_scalar_path_odd_width_with_attr_slots(dev, dtype):
    """Hand-built tables at d = 100 (not a multiple of 8: the scalar path)
    with 3 attr slots, and ids out of their tables: one past the service
    table (its slot NaN in both versions, as Flax's nn.Embed gives), one
    below zero in the attr table (wrapped to its row id + rows)."""
    d, attr_slots = 100, 3
    pk = _packed(300, 64, attr_slots=attr_slots, pad=2)
    rng = np.random.default_rng(5)

    def tab(rows, cols=d):
        return torch.from_numpy(rng.standard_normal(
            (rows, cols)).astype(np.float32)).to(dev)

    tables = EmbedTables(service=tab(64), name=tab(128), kind=tab(8),
                         status=tab(4), attr=tab(32), cont_w=tab(d, 3),
                         cont_b=tab(1)[0].contiguous(), pos=tab(64))
    cat = pk.categorical.copy()
    for c, rows in enumerate((64, 128, 8, 4, 64, 32, 32, 32)):
        cat[..., c] %= rows            # the featurizer's ids in the tables
    cat[0, 0, 0] = 1000                # past the service table: NaN
    cat[0, 1, 5] = -3                  # below the attr table: row 29
    args = [torch.from_numpy(a).to(dev) for a in (
        cat, pk.continuous, pk.positions, pk.segments)]
    assert not embed.vector_path(d, tables)
    tdt = getattr(torch, dtype)
    before = embed.launches
    got = span_embed(*args, tables, tdt)
    ref = span_embed_plain(*args, tables, tdt)
    torch.cuda.synchronize()
    assert embed.launches == before + 1
    assert (got[args[3] == 0] == 0).all()
    nan = torch.isnan(ref.float())
    assert bool(nan[0, 0].all()) == bool(args[3][0, 0] > 0)
    assert int(nan.any(-1).sum()) == int(args[3][0, 0] > 0)
    assert torch.equal(torch.isnan(got.float()), nan)
    atol = F32_ATOL if dtype == "float32" else _step(ref[~nan])
    assert (got.float() - ref.float())[~nan].abs().max().item() <= atol


def test_span_embed_refuses_non_f32_tables(dev):
    pk = _packed(20, 64)
    model = TraceTransformer(TransformerConfig(), device=dev)
    t = model.module.encoder.tables()
    half = EmbedTables(**{f: (None if x is None else x.half())
                          for f, x in vars(t).items()})
    args = [torch.from_numpy(a).to(dev) for a in (
        pk.categorical, pk.continuous, pk.positions, pk.segments)]
    with pytest.raises(TypeError, match="float32"):
        span_embed(*args, half, torch.bfloat16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_kernel_path_matches_plain_path(dev, dtype):
    model = TraceTransformer(TransformerConfig(dtype=getattr(torch, dtype)),
                             device=dev)
    pk = _packed(400, 64, pad=1)
    args = (pk.categorical, pk.continuous, pk.segments, pk.positions)
    got = model.score_packed(*args).cpu().numpy()
    ref = model.score_packed(*args, reference=True).cpu().numpy()
    m = pk.segments > 0
    bound = 1e-5 if dtype == "float32" else 2e-2
    assert np.abs(got[m] - ref[m]).max() <= bound


def test_gpu_engine_scores_like_the_cpu_engine_in_f32(dev):
    """The card's engine (pinned copies, events, depth-2 window, several
    coalesced requests) against the CPU engine on the same weights."""
    cfg = dict(model="transformer",
               model_config=TransformerConfig(dtype=torch.float32),
               trace_bucket=16, warm_ladder=True)
    gpu = ScoringEngine(EngineConfig(device="cuda", **cfg))
    cpu = ScoringEngine(EngineConfig(device="cpu", **cfg))
    cpu.backend.model.load_state_dict(
        {k: v.cpu() for k, v in gpu.backend.model.state_dict().items()})
    batches = [synthesize_traces(20 + 7 * i, seed=40 + i) for i in range(6)]
    gpu.start()
    try:
        reqs = [gpu.submit(b) for b in batches]
        for r, b in zip(reqs, batches):
            assert r.done.wait(120) and r.scores is not None
            ref = cpu.backend.score(b, featurize(b))
            np.testing.assert_allclose(r.scores, ref, atol=1e-4, rtol=1e-4)
    finally:
        gpu.shutdown()
    assert gpu.stats()["errors"] == 0


# ------------------------------------------------------------ zscore (K3, K4)
ZS_MEAN_ATOL = 1e-5
ZS_M2_RTOL = 1e-4
ZS_M2_ATOL = 1e-4
ZS_Z_RTOL = 1e-6
ZS_GLOBAL_G = 20000  # 2 x G doubles exceed shared memory: the global route


@pytest.fixture(scope="module")
def otel_mix():
    """(ids, log-durations) of 140k spans of synthetic otel-demo traffic."""
    batch = synthesize_traces(14000, seed=5)
    f = featurize(batch)
    return f.categorical[:, :2].copy(), f.continuous[:, 0].copy()


def _mix(kind: str, n: int, otel_mix, seed: int = 0):
    rng = np.random.default_rng(seed)
    if kind == "otel":
        cat, x = otel_mix
        if len(x) < n:  # past the fixture's 140k spans: the traffic again
            return np.resize(cat, (n, 2)), np.resize(x, n)
        return cat[:n], x[:n]
    x = rng.normal(9.0, 1.5, n).astype(np.float32)
    if kind == "uniform":
        cat = rng.integers(0, 2 ** 31 - 1, (n, 2)).astype(np.int32)
    else:  # every span in one group: the worst contention
        cat = np.tile(np.array([[3, 17]], np.int32), (n, 1))
    return cat, x


def _zs_state(dev, G: int, otel_mix):
    """A non-empty state: one plain update of 20k otel-demo spans."""
    cat, x = otel_mix
    zero = [torch.zeros(G, device=dev) for _ in range(3)]
    t = [torch.from_numpy(a[:20000]).to(dev) for a in (cat, x)]
    return zscore.zscore_update_plain(*zero, t[0], t[1],
                                      torch.ones_like(t[1]), G)


def _assert_zs_state(got, ref):
    assert torch.equal(got[0], ref[0])
    assert (got[1] - ref[1]).abs().max().item() <= ZS_MEAN_ATOL
    assert ((got[2] - ref[2]).abs() <= ZS_M2_ATOL
            + ZS_M2_RTOL * ref[2].abs()).all()


@pytest.mark.parametrize("mix", ["otel", "uniform", "single"])
@pytest.mark.parametrize("G", [1000, 8192, ZS_GLOBAL_G])
@pytest.mark.parametrize("N", [1, 4095, 65536, 131072])
def test_zscore_kernels_match_plain(dev, otel_mix, N, G, mix):
    state = _zs_state(dev, G, otel_mix)
    cat_np, x_np = _mix(mix, N, otel_mix)
    cat = torch.from_numpy(np.ascontiguousarray(cat_np)).to(dev)
    x = torch.from_numpy(np.ascontiguousarray(x_np)).to(dev)
    w = torch.ones_like(x)
    w[::7] = 0.0  # padding rows weigh 0
    scratch = zscore.new_scratch(G, dev)
    u0, s0 = zscore.update_launches, zscore.score_launches
    got = zscore.zscore_update(*state, cat, x, w, G, scratch=scratch)
    ref = zscore.zscore_update_plain(*state, cat, x, w, G)
    z, s, cold = zscore.zscore_score(*got, cat, x, G, 32, squash=True,
                                     n_valid=N - N // 3)
    z_ref = zscore.zscore_score_plain(*got, cat, x, G, 32)
    torch.cuda.synchronize()
    assert zscore.update_launches == u0 + 1
    assert zscore.score_launches == s0 + 1
    _assert_zs_state(got, ref)
    assert not scratch.any()  # the merge left the scratch at 0
    assert torch.isfinite(z).all()
    assert ((z - z_ref).abs() <= ZS_Z_RTOL * z_ref.abs().clamp(min=1)).all()
    s_ref = zscore.squash_plain(z_ref)
    assert ((s - s_ref).abs() <= ZS_Z_RTOL).all()
    assert int(cold) == int((z[:N - N // 3] == 0).sum())


def test_zscore_all_zero_weights_leave_the_state_bit_identical(dev,
                                                               otel_mix):
    for G in (8192, ZS_GLOBAL_G):
        state = _zs_state(dev, G, otel_mix)
        cat, x = (torch.from_numpy(a[:65536]).to(dev) for a in otel_mix)
        got = zscore.zscore_update(*state, cat, x, torch.zeros_like(x), G)
        for a, b in zip(got, state):
            assert torch.equal(a, b)


def test_zscore_detector_warm_is_bit_safe_on_the_card(dev, otel_mix):
    det = ZScoreDetector(device=dev)
    cat, x = otel_mix
    feats = featurize(synthesize_traces(300, seed=9))
    det.update(feats)
    before = [t.clone() for t in det.state]
    det.warm(max_spans=65536, cat_width=feats.categorical.shape[1])
    torch.cuda.synchronize()
    for a, b in zip(before, det.state):
        assert torch.equal(a, b)
    assert sorted(det._staging) == [
        4096, 8192, 16384, 32768, 65536, 131072]


def test_zscore_200_updates_do_not_drift_from_the_plain_stream(dev,
                                                               otel_mix):
    """200 calls of K3 alone, and of the one launch in place (scoring each
    batch on the state before it), against the plain stream."""
    rng = np.random.default_rng(11)
    cat_np, x_np = otel_mix
    G = 8192
    k = [torch.zeros(G, device=dev) for _ in range(3)]
    p = [t.clone() for t in k]
    one = [t.clone() for t in k]
    scratch = zscore.new_scratch(G, dev)
    for i in range(200):
        n = int(rng.integers(1, 6000))
        lo = int(rng.integers(0, len(x_np) - n))
        cat = torch.from_numpy(cat_np[lo:lo + n]).to(dev)
        x = torch.from_numpy(x_np[lo:lo + n]).to(dev)
        w = torch.ones_like(x)
        k = zscore.zscore_update(*k, cat, x, w, G, scratch=scratch)
        r = zscore.zscore_score_update(*one, cat, x, G, 32, scratch=scratch,
                                       inplace=True)
        s_ref = zscore.squash_plain(zscore.zscore_score_plain(
            *p, cat, x, G, 32))
        assert ((r.scores - s_ref).abs() <= ZS_Z_RTOL).all()
        p = zscore.zscore_update_plain(*p, cat, x, w, G)
    torch.cuda.synchronize()
    _assert_zs_state(k, p)
    _assert_zs_state(one, p)
    assert not scratch.any()


@pytest.mark.parametrize("inplace", [False, True])
@pytest.mark.parametrize("mix", ["otel", "single"])
@pytest.mark.parametrize("G", [8192, ZS_GLOBAL_G])
@pytest.mark.parametrize("N", [1, 31, 4096, 65536, 131072, 200_000])
def test_zscore_one_launch_matches_plain(dev, otel_mix, N, G, mix, inplace):
    """K4 then K3 in one launch (``zscore_score_update``) against the plain
    version (``zscore_score_plain`` on the old state, then
    ``zscore_update_plain``), on both routes, 200,000 spans being more
    than the grid has threads; the state written in place (the output
    aliasing the input) or out of place; cold counted among the first
    n_valid < N spans; one device launch."""
    _one_launch_case(dev, otel_mix, N, G, mix, inplace)


def _zs_held() -> int:
    """kHeld of ``csrc/zscore.cu``: the spans a thread keeps in registers."""
    src = (Path(zscore.__file__).parent / "csrc" / "zscore.cu").read_text()
    return int(re.search(r"constexpr int kHeld = (\d+);", src).group(1))


@pytest.mark.parametrize("inplace", [False, True])
@pytest.mark.parametrize("mix", ["otel", "single"])
@pytest.mark.parametrize("N,G", [(300_000, 8192), (600_000, 8192),
                                 (1_200_000, ZS_GLOBAL_G)])
def test_zscore_one_launch_past_the_held_spans_matches_plain(
        dev, otel_mix, N, G, mix, inplace):
    """The one launch where a thread takes more spans than the kHeld it
    keeps in registers (each of the others reloaded in every pass, its
    group's state gathered in the score), on both routes. A shared-route
    CTA's 2 x G sums leave room for one CTA an SM, a global-route one
    holds at most 2048 threads an SM: these N give every thread more
    than kHeld spans."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    threads_an_sm = 512 if zscore.update_route(G) == "shared" else 2048
    assert N > _zs_held() * sms * threads_an_sm
    _one_launch_case(dev, otel_mix, N, G, mix, inplace)


def _one_launch_case(dev, otel_mix, N: int, G: int, mix: str,
                     inplace: bool) -> None:
    state = _zs_state(dev, G, otel_mix)
    cat_np, x_np = _mix(mix, N, otel_mix)
    cat = torch.from_numpy(np.ascontiguousarray(cat_np)).to(dev)
    x = torch.from_numpy(np.ascontiguousarray(x_np)).to(dev)
    n_valid = N - N // 3
    ref_state, ref_s, ref_cold = zscore.zscore_score_update_plain(
        *state, cat, x, G, 32, n_valid=n_valid)
    scratch = zscore.new_scratch(G, dev)
    counts = (zscore.device_launches, zscore.score_launches,
              zscore.update_launches)
    mine = [t.clone() for t in state] if inplace else state
    r = zscore.zscore_score_update(*mine, cat, x, G, 32, n_valid=n_valid,
                                   scratch=scratch, inplace=inplace)
    torch.cuda.synchronize()
    assert (zscore.device_launches, zscore.score_launches,
            zscore.update_launches) == tuple(c + 1 for c in counts)
    if inplace:
        assert all(a is b for a, b in zip(r.state, mine))
    _assert_zs_state(r.state, ref_state)
    assert not scratch.any()
    assert ((r.scores - ref_s).abs() <= ZS_Z_RTOL).all()
    assert int(r.cold) == int(ref_cold)


@pytest.mark.parametrize("G", [8192, ZS_GLOBAL_G])
def test_zscore_one_launch_score_only_and_zero_weights(dev, otel_mix, G):
    """Score only (``update=False``, the engine without online_update)
    leaves the state untouched; all-zero weights in place leave it bit
    for bit while the scores are still the plain version's."""
    state = _zs_state(dev, G, otel_mix)
    before = [t.clone() for t in state]
    cat, x = (torch.from_numpy(a[:65536]).to(dev) for a in otel_mix)
    _, ref_s, ref_cold = zscore.zscore_score_update_plain(*state, cat, x,
                                                          G, 32)
    scratch = zscore.new_scratch(G, dev)
    only = zscore.zscore_score_update(*state, cat, x, G, 32, update=False)
    # the engine's way: the caller's buffer, its cold word 0 on entry
    out = torch.full((len(x) + 1,), float("nan"), device=dev)
    out[:1].view(torch.int32).zero_()
    mine = zscore.zscore_score_update(*state, cat, x, G, 32, update=False,
                                      out=out)
    zero = zscore.zscore_score_update(*state, cat, x, G, 32,
                                      weights=torch.zeros_like(x),
                                      scratch=scratch, inplace=True)
    torch.cuda.synchronize()
    assert only.state is None and mine.out is out
    for r in (only, mine, zero):
        assert ((r.scores - ref_s).abs() <= ZS_Z_RTOL).all()
        assert int(r.cold) == int(ref_cold)
    for a, b in zip(state, before):
        assert torch.equal(a, b)
    assert not scratch.any()


def test_zscore_kernels_refuse_what_they_do_not_take(dev):
    G = 64
    state = [torch.zeros(G, device=dev) for _ in range(3)]
    x = torch.zeros(10, device=dev)
    with pytest.raises(TypeError, match="int32"):
        zscore.zscore_score(*state, torch.zeros((10, 5), dtype=torch.int64,
                                                device=dev), x, G, 32)
    with pytest.raises(ValueError, match="scratch"):
        zscore.zscore_update(*state, torch.zeros((10, 5), dtype=torch.int32,
                                                 device=dev), x,
                             torch.ones_like(x), G,
                             scratch=torch.zeros((3, G), device=dev))


def test_gpu_zscore_engine_scores_like_the_cpu_engine(dev):
    """The card's zscore engine (12 bytes a real span staged, K4 and K3 in
    ONE launch a call, one copy back, one wait) against the CPU engine
    (plain versions) over the same warm-up and stream; one K3 and one K4
    a call, one device launch a call."""
    gpu = ScoringEngine(EngineConfig(model="zscore", device="cuda",
                                     warm_ladder=True))
    cpu = ScoringEngine(EngineConfig(model="zscore", device="cpu"))
    warm = synthesize_traces(400, seed=7)
    gpu.warmup(warm)
    cpu.warmup(warm)
    batches = [synthesize_traces(20 + 300 * i, seed=40 + i)
               for i in range(6)]
    gpu.start()
    u0, s0 = zscore.update_launches, zscore.score_launches
    d0 = zscore.device_launches
    try:
        for b in batches:
            got = gpu.score_sync(b, timeout_s=120)
            ref = cpu.backend.score(b, featurize(b))
            assert got is not None
            np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    finally:
        gpu.shutdown()
    stats = gpu.stats()
    assert stats["pipeline_depth"] == 1 and stats["errors"] == 0
    assert zscore.update_launches - u0 == stats["device_calls"] == 6
    assert zscore.score_launches - s0 == 6
    assert zscore.device_launches - d0 == 6  # one launch an engine call
    assert gpu.backend.cold_spans == cpu.backend.cold_spans
    _assert_zs_state(gpu.backend.det.state, [
        t.to(dev) for t in cpu.backend.det.state])


# ------------------------------------------- the fused route (K5 to K8)
FEAT_CONT_RTOL = 2.0 ** -23
HEAD_F32_ATOL = 1e-6
HEAD_BF16_ATOL = 1e-5
TINY_CPU = dict(d_model=32, n_heads=2, n_layers=1, d_ff=64)


def _fused_batches(kind: str, n_traces: int):
    if kind == "otel":
        return [synthesize_traces(n_traces, seed=61)]
    if kind == "adversarial":
        return [adversarial_traces(n_traces, seed=62)]
    if kind == "huge":  # a trace of 5000 spans: past the layout's probes
        return [adversarial_traces(n_traces, seed=66, long_trace=5000)]
    if kind == "long":  # eight traces under one id: ~80 spans each
        from dataclasses import replace

        b = synthesize_traces(n_traces, seed=65)
        cols = dict(b.columns)
        _, first, tr = np.unique(np.stack([cols["trace_id_hi"],
                                           cols["trace_id_lo"]], 1), axis=0,
                                 return_index=True, return_inverse=True)
        lead = first[tr.reshape(-1) // 8 * 8]
        for name in ("trace_id_hi", "trace_id_lo"):
            cols[name] = cols[name][lead]
        return [replace(b, columns=cols)]
    if kind == "stress":  # one span id a frame, repeated across frames
        return join_stress_frames(n_traces, frames=4, seed=67)
    # three frames, the first and last the same traces
    a = synthesize_traces(n_traces, seed=63)
    return [a, adversarial_traces(n_traces, seed=64), a]


def _staged_on(dev, batches):
    """The group's staged columns (a CPU backend's staging), on the card."""
    be = ScoringEngine(EngineConfig(
        model="transformer", device="cpu", trace_bucket=8,
        model_config=TransformerConfig(**TINY_CPU,
                                       dtype=torch.float32))).backend
    cols = [extract_columns(b)[0] for b in batches]
    n = sum(len(c) for c in cols)
    st = be._prep_columns(cols, _span_bucket(n))
    moved = {k: v.to(dev).contiguous() for k, v in st.cols.items()}
    return (n, st.service_table.to(dev).contiguous(),
            st.name_table.to(dev).contiguous(), moved)


def _feat_args(tabs, c):
    return (*tabs, c["service"], c["name"], c["kind"], c["status_code"],
            c["span_id"], c["parent_span_id"], c["start_unix_nano"],
            c["end_unix_nano"], c["frame"])


# 1,700,001 rows: more tiles of ksort.TILE keys than the largest grid has
# blocks (one or two an SM), so each block walks several tiles
@pytest.mark.parametrize("n", [0, 1, 31, 2049, 65536, 131072, 1_700_001])
@pytest.mark.parametrize("keys", ["u64x3", "tied", "frame_span", "equal"])
def test_radix_sort_kernel_matches_plain(dev, keys, n):
    rng = np.random.default_rng(n + len(keys))
    N = max(n, 1) + 5  # padding rows keep the identity
    if keys == "u64x3":
        words = [rng.integers(0, 2 ** 63, N, dtype=np.uint64) * 2
                 + rng.integers(0, 2, N, dtype=np.uint64) for _ in range(3)]
        ks = [torch.from_numpy(w.view(np.int64)).to(dev) for w in words]
    elif keys == "tied":  # few distinct keys: the order is stability
        w = rng.integers(0, 3, N).astype(np.uint64) << np.uint64(62)
        ks = [torch.from_numpy(w.view(np.int64)).to(dev)]
    elif keys == "equal":  # no live digit: the identity
        ks = [torch.full((N,), -5, dtype=torch.int64, device=dev),
              torch.full((N,), 7, dtype=torch.int32, device=dev)]
    else:
        ks = [torch.from_numpy(rng.integers(0, 3, N).astype(np.int32)).to(
            dev), torch.from_numpy(rng.integers(
                -2 ** 63, 2 ** 63 - 1, N, dtype=np.int64)).to(dev)]
    before, dev_before = ksort.launches, ksort.device_launches
    passes = torch.zeros(1, dtype=torch.int32, device=dev)
    got = ksort.radix_sort(ks, n, passes=passes)
    ref = ksort.radix_sort_plain(ks, n)
    torch.cuda.synchronize()
    assert ksort.launches == before + 1
    assert ksort.device_launches - dev_before <= 2  # one sort, one launch
    assert torch.equal(got, ref)
    if n > ksort.TILE * ksort.max_grid(dev):
        assert ksort.plan(n, N, ksort.max_grid(dev))[1] > 1
    # a digit pass runs where the digit differs between two real keys
    want = 0
    for k in ks:
        a = k[:n].cpu().numpy()
        a = a.view(np.uint64) if a.dtype == np.int64 else a.astype(
            np.uint64)
        bits = 64 if k.dtype == torch.int64 else 32
        for s in range(0, bits, 8):
            d = (a >> np.uint64(s)) & np.uint64(255)
            want += int(n > 0 and (d != d[0]).any())
    assert int(passes) == want


@pytest.mark.parametrize("kind,n_traces", [("otel", 1), ("otel", 400),
                                           ("adversarial", 400),
                                           ("multi", 200),
                                           ("otel", 12800),
                                           ("stress", 400),
                                           ("stress", 12800)])
def test_featurize_kernel_matches_plain(dev, kind, n_traces):
    """Real, multi-frame and adversarial frames, and the join-stress
    frames (every row of a frame declaring one id: one insert a warp, the
    rest finding a lower owner or taking the atomicMin), up to 131072-span
    buckets; two kernels a call."""
    n, svc_t, nam_t, c = _staged_on(dev, _fused_batches(kind, n_traces))
    args = _feat_args((svc_t, nam_t), c)
    before = (kfeat.launches, kfeat.device_launches)
    cat, cont = kfeat.featurize_columns(*args, n)
    cat_p, cont_p = kfeat.featurize_columns_plain(*args, n)
    torch.cuda.synchronize()
    assert kfeat.launches == before[0] + 1
    assert kfeat.device_launches == before[1] + 2
    assert torch.equal(cat, cat_p)
    assert ((cont - cont_p).abs() <= FEAT_CONT_RTOL * cont_p.abs()).all()


@pytest.mark.parametrize("kind,n_traces,L", [("otel", 1, 64),
                                             ("otel", 400, 64),
                                             ("adversarial", 400, 64),
                                             ("adversarial", 400, 16),
                                             ("multi", 200, 64),
                                             ("otel", 12800, 64),
                                             ("adversarial", 400, 1024),
                                             ("otel", 4000, 1024)])
@pytest.mark.parametrize("extra_rows", [0, 40])
def test_next_fit_pack_kernel_matches_plain(dev, kind, n_traces, L,
                                            extra_rows):
    """Real frames, a trace of 200 spans, tied starts, high-bit ids, one
    span, 131072-span buckets and rows that stay all padding."""
    n, svc_t, nam_t, c = _staged_on(dev, _fused_batches(kind, n_traces))
    cat, cont = kfeat.featurize_columns_plain(
        *_feat_args((svc_t, nam_t), c), n)
    perm = ksort.radix_sort_plain(
        [c["trace_id_hi"], c["trace_id_lo"], c["start_unix_nano"]], n)
    R = 2 * n // L + 2 + extra_rows
    before = kpack.launches
    got = kpack.next_fit_pack(perm, c["trace_id_hi"], c["trace_id_lo"], cat,
                              cont, n, L, R)
    ref = kpack.next_fit_pack_plain(perm, c["trace_id_hi"],
                                    c["trace_id_lo"], cat, cont, n, L, R)
    torch.cuda.synchronize()
    assert kpack.launches == before + 1
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert 0 < int(got.rows_used) <= R


@pytest.mark.parametrize("kind,n_traces", [("otel", 12800),
                                           ("adversarial", 4000),
                                           ("long", 12000),
                                           ("huge", 4000)])
@pytest.mark.parametrize("L", [1, 8, 64])
@pytest.mark.parametrize("rows", ["bound", "half"])
def test_next_fit_pack_kernel_walks_many_chunks(dev, kind, n_traces, L,
                                                rows):
    """The walk's chunks at their smallest rows (L = 1: every span its own
    segment and row) and largest counts (L = 8), traces longer than L and
    than the layout's 1,056-span probes (a trace of 5000), and half the
    rows next-fit fills (the rest dropped)."""
    n, svc_t, nam_t, c = _staged_on(dev, _fused_batches(kind, n_traces))
    cat, cont = kfeat.featurize_columns_plain(
        *_feat_args((svc_t, nam_t), c), n)
    perm = ksort.radix_sort_plain(
        [c["trace_id_hi"], c["trace_id_lo"], c["start_unix_nano"]], n)
    full = kpack.next_fit_pack_plain(perm, c["trace_id_hi"],
                                     c["trace_id_lo"], cat, cont, n, L, 0)
    used = int(full.rows_used)
    R = used if rows == "bound" else used // 2
    got = kpack.next_fit_pack(perm, c["trace_id_hi"], c["trace_id_lo"], cat,
                              cont, n, L, R)
    ref = kpack.next_fit_pack_plain(perm, c["trace_id_hi"],
                                    c["trace_id_lo"], cat, cont, n, L, R)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert int(got.rows_used) == used


def test_next_fit_pack_kernel_empty_group(dev):
    z64 = torch.zeros(512, dtype=torch.int64, device=dev)
    perm = torch.arange(512, dtype=torch.int32, device=dev)
    cat = torch.zeros((512, 5), dtype=torch.int32, device=dev)
    cont = torch.zeros((512, 3), device=dev)
    got = kpack.next_fit_pack(perm, z64, z64, cat, cont, 0, 64, 256)
    torch.cuda.synchronize()
    assert int(got.rows_used) == 0
    assert not got.categorical.any() and not got.segments.any()
    assert (got.row_eff == 256).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,N", [(0, 512), (1, 512), (3000, 4096),
                                 (131072, 131072)])
@pytest.mark.parametrize("d", [256, 64, 128, 512, 1024])
def test_span_head_kernel_matches_plain(dev, dtype, n, N, d):
    rng = np.random.default_rng(n)
    L = 64
    R = max(1, 2 * n // L + 2)
    g = torch.Generator(device=dev).manual_seed(n)
    h = torch.randn(R, L, d, generator=g, device=dev).to(getattr(torch,
                                                                 dtype))
    gamma = 1 + 0.1 * torch.randn(d, generator=g, device=dev)
    beta = 0.1 * torch.randn(d, generator=g, device=dev)
    w = torch.randn(d, generator=g, device=dev) / math.sqrt(d)
    b = torch.randn(1, generator=g, device=dev)
    slots = rng.permutation(R * L)[:n]
    perm = np.concatenate([rng.permutation(n), np.arange(n, N)])
    row = np.full(N, R, np.int32)
    col = np.zeros(N, np.int32)
    row[:n], col[:n] = slots // L, slots % L
    row[:n:97] = R  # dropped spans score 0
    args = [torch.from_numpy(a.astype(np.int32)).to(dev)
            for a in (perm, row, col)]
    before = khead.launches
    got = khead.span_head_scatter(h, gamma, beta, w, b, *args, n)
    ref = khead.span_head_scatter_plain(h, gamma, beta, w, b, *args, n)
    torch.cuda.synchronize()
    assert khead.launches == before + (1 if N else 0)
    bound = HEAD_F32_ATOL if dtype == "float32" else HEAD_BF16_ATOL
    assert (got - ref).abs().max().item() <= bound
    assert (got[torch.from_numpy(perm[:n][row[:n] == R].astype(
        np.int64)).to(dev)] == 0).all()
    assert (got[n:] == 0).all()


def test_gpu_fused_engine_scores_like_the_cpu_fused_engine(dev):
    """The card's fused route (staging, one copy, K5-K8 and the encoder)
    against the CPU's (plain versions) on the same f32 weights, through
    ``submit(columns=)``, a coalesced group and an adversarial frame."""
    cfg = dict(model="transformer",
               model_config=TransformerConfig(dtype=torch.float32),
               trace_bucket=16, warm_ladder=True, max_batch_spans=8192)
    gpu = ScoringEngine(EngineConfig(device="cuda", **cfg))
    cpu = ScoringEngine(EngineConfig(device="cpu", **cfg))
    cpu.backend.model.load_state_dict(
        {k: v.cpu() for k, v in gpu.backend.model.state_dict().items()})
    batches = [synthesize_traces(20 + 7 * i, seed=40 + i) for i in range(5)]
    batches.append(adversarial_traces(300, seed=3))
    gpu.start()  # warms the ladder and every span bucket first
    launches0 = (kfeat.launches, ksort.launches, kpack.launches,
                 khead.launches)
    try:
        reqs = [gpu.submit(b, columns=extract_columns(b)[0])
                for b in batches]
        for r, b in zip(reqs, batches):
            assert r.done.wait(120) and r.scores is not None
            ref = cpu.backend.harvest(cpu.backend.dispatch_columns(
                [extract_columns(b)[0]]))
            np.testing.assert_allclose(r.scores, ref, atol=1e-4, rtol=1e-4)
    finally:
        gpu.shutdown()
    stats = gpu.stats()
    assert stats["errors"] == 0
    calls = stats["fused_calls"]
    assert calls >= 1 and stats["odigos_fastpath_fused_frames_total"] == 6
    assert kfeat.launches - launches0[0] == calls
    assert ksort.launches - launches0[1] == calls  # the trace sort only
    assert kpack.launches - launches0[2] == calls
    assert khead.launches - launches0[3] == calls


# ------------------------------------------------ K9 / K10, the int8 path
#
# K9 (ln_quantize) and K10 (qgemm) take the same IEEE-rounded steps as their
# plain versions in the same order, with the LayerNorm's sums taken exactly
# (f64) and the product exact (s32 on the card, f64 in the plain version):
# codes, scales and outputs are held to the bit.

from odigos_tpu_torch.kernels import qgemm as kq  # noqa: E402
from odigos_tpu_torch.kernels import quant as kquant  # noqa: E402
from odigos_tpu_torch.models import QuantizedTraceScorer  # noqa: E402


def _rows(dev, M, K, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    scale = torch.rand(M, 1, generator=g, device=dev) * 8 + 0.05
    x = torch.randn(M, K, generator=g, device=dev) * scale + 0.3
    x[M // 3] = 0.0  # an all-zero row: a_s 1, codes 0
    return x.to(getattr(torch, dtype))


def _quantize_and_check(x, ln):
    K = x.shape[1]
    g = torch.Generator(device=x.device).manual_seed(1)
    w = (1 + 0.2 * torch.randn(K, generator=g, device=x.device)) \
        if ln else None
    b = 0.1 * torch.randn(K, generator=g, device=x.device) if ln else None
    before = kquant.launches
    got = kquant.ln_quantize(x, w, b)
    ref = kquant.ln_quantize_plain(x, w, b)
    torch.cuda.synchronize()
    assert kquant.launches == before + 1
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    return got


@pytest.mark.parametrize("M,K", [(16384, 256), (16384, 1024), (1000, 264),
                                 (37, 8)])
@pytest.mark.parametrize("ln", [True, False], ids=["ln", "plain"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_ln_quantize_kernel_matches_plain(dev, M, K, ln, dtype):
    x_q, a_s = _quantize_and_check(_rows(dev, M, K, dtype), ln)
    z = M // 3
    if not ln:
        assert a_s[z].item() == 1.0 and (x_q[z] == 0).all()


def test_ln_quantize_rounds_half_to_even_on_the_card(dev):
    row = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, -3.5],
                       device=dev)
    x_q, a_s = _quantize_and_check(row.repeat(64, 1), False)
    assert a_s[0].item() == 1.0
    assert x_q[0].tolist() == [127, 0, 2, 2, 0, -2, 4, -4]


def _qgemm_inputs(dev, M, N, K, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x_q = torch.randint(-127, 128, (M, K), generator=g, device=dev,
                        dtype=torch.int8)
    w_q = torch.randint(-127, 128, (N, K), generator=g, device=dev,
                        dtype=torch.int8)
    a_s = torch.rand(M, generator=g, device=dev) * 0.05 + 1e-3
    w_s = torch.rand(N, generator=g, device=dev) * 2e-3 + 1e-4
    b = 0.1 * torch.randn(N, generator=g, device=dev)
    return x_q, w_q, a_s, w_s, b


@pytest.mark.parametrize("M,N,K,epilogue,planes", [
    (16384, 768, 256, "none", 3),         # QKV, split for K1
    (16384, 256, 256, "residual", 1),     # out-projection
    (16384, 1024, 256, "gelu_tanh", 1),   # FFN1
    (16384, 256, 1024, "residual", 1),    # FFN2
    (1000, 200, 80, "none", 1),           # ragged M, N and K
    (1000, 200, 80, "gelu_tanh", 1),
    (130, 24, 48, "residual", 1),
    (130, 24, 272, "residual", 1),        # streaming, half-tile residual
    (130, 24, 272, "gelu_tanh", 1),
    (130, 48, 16, "none", 2),             # bf16: planes off 64 columns
    (200, 96, 48, "gelu_tanh", 3),
    (130, 128, 16, "none", 2),            # planes of 64 columns
    (300, 192, 1024, "none", 3)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_qgemm_kernel_matches_plain(dev, M, N, K, epilogue, planes, dtype):
    out_dtype = getattr(torch, dtype)
    x_q, w_q, a_s, w_s, b = _qgemm_inputs(dev, M, N, K)
    res = torch.randn(M, N, device=dev).to(out_dtype) \
        if epilogue == "residual" else None
    before = kq.launches
    got = kq.qgemm(x_q, w_q, a_s, w_s, b, out_dtype, epilogue, res, planes)
    ref = kq.qgemm_plain(x_q, w_q, a_s, w_s, b, out_dtype, epilogue, res,
                         planes)
    torch.cuda.synchronize()
    assert kq.launches == before + 1
    assert got.shape == ref.shape and got.dtype == out_dtype
    assert torch.equal(got, ref)


@pytest.mark.parametrize("K", [256, 1024])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qgemm_kernel_is_exact_at_the_largest_sums(dev, K, dtype):
    """Codes of ±127 (and -128): |acc| = K * 127^2 (K = 1024: past 2^23;
    K = 256: the weight-stationary walk's s32 -> f32 addition at its
    edge, 256 * 128^2 = 2^22); s32 on the card, f64 in the plain version,
    both exact, then rounded once to the output type."""
    M, N = 256, 128
    out_dtype = getattr(torch, dtype)
    x_q = torch.full((M, K), 127, dtype=torch.int8, device=dev)
    x_q[1::2] = -127
    x_q[2] = -128
    w_q = torch.full((N, K), 127, dtype=torch.int8, device=dev)
    w_q[::3, ::5] = -127
    w_q[4] = -128
    one = torch.ones
    got = kq.qgemm(x_q, w_q, one(M, device=dev), one(N, device=dev),
                   torch.zeros(N, device=dev), out_dtype)
    acc = (x_q.double() @ w_q.double().t()).float()
    torch.cuda.synchronize()
    assert torch.equal(got, acc.to(out_dtype))
    assert acc.abs().max().item() == K * 128 * 128
    assert (acc.abs() == K * 127 * 127).any()


def _quant_pair(got, ref):
    assert got[0].dtype == torch.int8 and got[1].dtype == torch.float32
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


@pytest.mark.parametrize("M,N,K", [
    (16384, 1024, 256),  # FFN1 at R = 256
    (1000, 200, 80),     # ragged M, N and K; N / 2 not a multiple of 64
    (130, 24, 48),       # the second CTA of a cluster without columns
    (777, 1016, 256),
    (64, 8, 16),
    (3, 1024, 128)])     # fewer row blocks than clusters
def test_qgemm_gelu_quant_matches_plain(dev, M, N, K):
    """FFN1 + GELU + FFN2's activation quantize on the card: codes and
    scales bit-equal to the plain version (the two plain steps) and to the
    two kernels it replaces (K10 "gelu_tanh", then K9's plain mode)."""
    x_q, w_q, a_s, w_s, b = _qgemm_inputs(dev, M, N, K)
    args = (x_q, w_q, a_s, w_s, b, torch.bfloat16)
    before = kq.launches
    got = kq.qgemm(*args, "gelu_tanh_quant")
    ref = kq.qgemm_plain(*args, "gelu_tanh_quant")
    two = kquant.ln_quantize(kq.qgemm(*args, "gelu_tanh"))
    torch.cuda.synchronize()
    assert kq.launches == before + 2
    _quant_pair(got, ref)
    _quant_pair(got, two)


def test_qgemm_gelu_quant_zero_rows_and_ties(dev):
    """y = 1 + b exactly (one code of 1 a row, scales 1): the row maxima
    127 give a_s = 1, so h = gelu(y) = y at y >= 5.5 (tanh rounds to 1 in
    f32; y >= 8 takes the formula, y < 8 the table) lands on exact .5
    ties, rounded half to even. Then b = 0: the rows of zero codes have
    y = 0, h = 0, scale 1 and codes 0."""
    M, N, K = 200, 1024, 32
    x_q = torch.zeros(M, K, dtype=torch.int8, device=dev)
    x_q[::2, 0] = 1
    w_q = torch.zeros(N, K, dtype=torch.int8, device=dev)
    w_q[:, 0] = 1
    ties = torch.tensor([5.5, 6.5, 7.5, 8.5, 10.5, 100.5, 126.5, 127.0,
                         -6.5, 0.0], device=dev)
    y = ties.repeat(N // len(ties) + 1)[:N].contiguous()
    one = torch.ones
    for b in (y - 1.0, torch.zeros_like(y)):
        args = (x_q, w_q, one(M, device=dev), one(N, device=dev), b,
                torch.bfloat16)
        got = kq.qgemm(*args, "gelu_tanh_quant")
        ref = kq.qgemm_plain(*args, "gelu_tanh_quant")
        torch.cuda.synchronize()
        _quant_pair(got, ref)
    b = y - 1.0
    ref = kq.qgemm_plain(x_q, w_q, one(M, device=dev), one(N, device=dev),
                         b, torch.bfloat16, "gelu_tanh_quant")
    h = kq.qgemm_plain(x_q, w_q, one(M, device=dev), one(N, device=dev), b,
                       torch.bfloat16, "gelu_tanh").float()
    assert ref[1][0].item() == 1.0
    assert bool(((h[0] / ref[1][0]).frac().abs() == 0.5).sum() >= 5)
    assert ref[0][0, :3].tolist() == [6, 6, 8]  # 5.5, 6.5, 7.5: to even
    assert (got[1][1::2] == 1.0).all() and (got[0][1::2] == 0).all()


def test_qgemm_kernel_past_2_31_outputs(dev):
    """M x N past 2^31 elements (64-bit offsets, the cluster grid's row
    blocks past 2^15): the rows at both ends against the plain version on
    those rows alone, in "gelu_tanh" (bf16 out) and "gelu_tanh_quant"
    (int8 codes) mode."""
    M, N, K = (1 << 31) // 1024 + 3000, 1024, 256
    x_q, w_q, a_s, w_s, b = _qgemm_inputs(dev, M, N, K)
    for epi in ("gelu_tanh", "gelu_tanh_quant"):
        got = kq.qgemm(x_q, w_q, a_s, w_s, b, torch.bfloat16, epi)
        torch.cuda.synchronize()
        out = got[0] if epi == "gelu_tanh_quant" else got
        assert out.numel() > 2 ** 31
        for rows in (slice(0, 4096), slice(M - 4096, M)):
            ref = kq.qgemm_plain(x_q[rows], w_q, a_s[rows], w_s, b,
                                 torch.bfloat16, epi)
            if epi == "gelu_tanh_quant":
                _quant_pair((got[0][rows], got[1][rows]), ref)
            else:
                assert torch.equal(got[rows], ref)
        del got, out


def test_int8_kernels_refuse_what_they_do_not_take(dev):
    x_q, w_q, a_s, w_s, b = _qgemm_inputs(dev, 64, 64, 48)
    with pytest.raises(ValueError, match="K % 16"):
        kq.qgemm(x_q[:, :24].contiguous(), w_q[:, :24].contiguous(), a_s,
                 w_s, b, torch.bfloat16)
    with pytest.raises(ValueError, match="N, N / planes % 8"):
        kq.qgemm(x_q, w_q[:60].contiguous(), a_s, w_s[:60], b[:60],
                 torch.bfloat16)
    flat = torch.zeros(64 * 48 + 1, dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="aligned"):
        kq.qgemm(flat[1:].view(64, 48), w_q, a_s, w_s, b, torch.bfloat16)
    strided = torch.zeros(64, 96, dtype=torch.int8, device=dev)[:, :48]
    with pytest.raises(ValueError, match="contiguous"):
        kq.qgemm(strided, w_q, a_s, w_s, b, torch.bfloat16)
    with pytest.raises(TypeError, match="out_dtype"):
        kq.qgemm(x_q, w_q, a_s, w_s, b, torch.float16)
    wide = torch.zeros(1032, 48, dtype=torch.int8, device=dev)
    ones = torch.ones(1032, device=dev)
    for args, dt in (((x_q, wide, a_s, ones, ones), torch.bfloat16),
                     ((x_q, w_q, a_s, w_s, b), torch.float32),
                     ((torch.zeros(64, 272, dtype=torch.int8, device=dev),
                       torch.zeros(64, 272, dtype=torch.int8, device=dev),
                       a_s, w_s, b), torch.bfloat16)):
        with pytest.raises(ValueError, match="gelu_tanh_quant"):
            kq.qgemm(*args, dt, "gelu_tanh_quant")
    with pytest.raises(ValueError, match="residual"):
        kq.qgemm(x_q, w_q, a_s, w_s, b, torch.bfloat16, "gelu_tanh_quant",
                 torch.zeros(64, 64, dtype=torch.bfloat16, device=dev))
    with pytest.raises(ValueError, match="8-byte aligned"):
        kq.qgemm(x_q, w_q, a_s, torch.ones(65, device=dev)[1:], b,
                 torch.bfloat16)
    x = torch.randn(8, 12, device=dev)
    with pytest.raises(ValueError, match="K % 8"):
        kquant.ln_quantize(x)
    with pytest.raises(ValueError, match="K % 8"):
        kquant.ln_quantize(torch.randn(8, 4104, device=dev))
    with pytest.raises(TypeError):
        kquant.ln_quantize(torch.randn(8, 64, device=dev).half())


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_int8_forward_kernel_path_matches_plain_path(dev, dtype):
    """The int8 scorer's kernel path against its plain path on the card,
    with K9 and K10 launched four times a layer each."""
    cfg = TransformerConfig(n_layers=2, dtype=getattr(torch, dtype))
    model = QuantizedTraceScorer(cfg, device=dev)
    pk = _packed(200, 64, pad=3)
    k9, k10 = kquant.launches, kq.launches
    got = model.score_packed(pk.categorical, pk.continuous, pk.segments,
                             pk.positions)
    ref = model.score_packed(pk.categorical, pk.continuous, pk.segments,
                             pk.positions, reference=True)
    torch.cuda.synchronize()
    assert kquant.launches - k9 == 4 * cfg.n_layers
    assert kq.launches - k10 == 4 * cfg.n_layers
    live = torch.from_numpy(pk.segments > 0).to(dev)
    assert (got - ref)[live].abs().max().item() <= 2e-2


def test_gpu_int8_engine_scores_like_the_cpu_int8_engine(dev):
    """Host route and fused route of the int8 engine on the card against
    the CPU's, same int8 tree, f32. Bound 1e-2: K1, K2 and the final
    LayerNorm sum in another order on the card, and a last-bit change of
    an activation can move its int8 code by one, which moves a span's
    score by ~1e-3 (tests/test_torch_quantized.py measures up to 1.3e-3
    against the JAX scorer for the same reason)."""
    cfg = dict(model="transformer", quantized=True,
               model_config=TransformerConfig(dtype=torch.float32),
               trace_bucket=16)
    gpu = ScoringEngine(EngineConfig(device="cuda", **cfg))
    cpu = ScoringEngine(EngineConfig(device="cpu", **cfg))
    cpu.backend.model.load_quantized(
        {k: v.cpu() for k, v in gpu.backend.model.state_dict().items()})
    for seed in (41, 42):
        b = synthesize_traces(60, seed=seed)
        got = gpu.backend.score(b, featurize(b))
        ref = cpu.backend.score(b, featurize(b))
        assert np.abs(got - ref).max() <= 1e-2
        cols = extract_columns(b)[0]
        got = gpu.backend.harvest(gpu.backend.dispatch_columns([cols]))
        ref = cpu.backend.harvest(cpu.backend.dispatch_columns([cols]))
        assert np.abs(got - ref).max() <= 1e-2


# ------------------------------------- K11 / K12 / K13, the autoencoder
#
# K12 (ln_masked_pool) takes the plain version's IEEE-rounded steps with
# every sum exact (f64): bit-equal. K13 (trace_rows_pack) is integer
# bookkeeping: exact. K11 (recon_ce) normalises to the same bits and then
# sums the heads' dots and the log-sum-exp in another order:
# RECON_ATOL absolute on the error, RECON_RTOL on the squashed score.

from odigos_tpu_torch.kernels import pool as kpool  # noqa: E402
from odigos_tpu_torch.kernels import recon as krecon  # noqa: E402
from odigos_tpu_torch.models import (AutoencoderConfig,  # noqa: E402
                                     SpanAutoencoder)

RECON_ATOL = 1e-4


def _masked_rows(dev, T, L, d, dtype, density, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn(T, L, d, generator=g, device=dev) * 2 + 0.5).to(
        getattr(torch, dtype))
    mask = torch.rand(T, L, generator=g, device=dev) < density
    if T > 1:
        mask[T // 2] = False  # a row of padding only
    return x, mask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [32, 128, 256, 64])
@pytest.mark.parametrize("T,density", [(1, 1.0), (300, 0.16), (2048, 0.5)])
def test_ln_masked_pool_kernel_matches_plain(dev, dtype, d, T, density):
    x, mask = _masked_rows(dev, T, 64, d, dtype, density, seed=T + d)
    g = torch.Generator(device=dev).manual_seed(d)
    w = 1 + 0.2 * torch.randn(d, generator=g, device=dev)
    b = 0.1 * torch.randn(d, generator=g, device=dev)
    before = kpool.launches
    got = kpool.ln_masked_pool(x, w, b, mask)
    ref = kpool.ln_masked_pool_plain(x, w, b, mask)
    torch.cuda.synchronize()
    assert kpool.launches == before + 1
    assert got.dtype == x.dtype and got.shape == (T, d)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [32, 64, 128, 144, 256, 512, 1024])
@pytest.mark.parametrize("masks", ["prefix", "holes"])
@pytest.mark.parametrize("live", ["zero", "middle", "all"])
def test_ln_masked_pool_kernel_with_a_row_count(dev, dtype, d, masks, live):
    """K12 with K13's device row count: rows below it bit-equal to the
    plain version (prefix masks as K13 writes them, masks with holes as the
    host route's rows may hold, empty rows), rows at or past it zeros
    although their mask and x are garbage there (neither may be read)."""
    T, L = 700, 64
    x, mask = _masked_rows(dev, T, L, d, dtype, 0.2, seed=d)
    if masks == "prefix":  # K13's rows: a trace's spans from slot 0 on
        lens = mask.sum(-1, keepdim=True)
        mask = torch.arange(L, device=dev) < lens
    count = {"zero": 0, "middle": T // 2 + 1, "all": T}[live]
    live_t = torch.tensor([count], dtype=torch.int32, device=dev)
    x[count:] = float("nan")  # unread past the count
    mask[count:] = True
    g = torch.Generator(device=dev).manual_seed(d)
    w = 1 + 0.2 * torch.randn(d, generator=g, device=dev)
    b = 0.1 * torch.randn(d, generator=g, device=dev)
    before = kpool.launches
    got = kpool.ln_masked_pool(x, w, b, mask, live=live_t)
    ref = kpool.ln_masked_pool_plain(x, w, b, mask, live=live_t)
    torch.cuda.synchronize()
    assert kpool.launches == before + 1
    assert torch.equal(got, ref)
    assert (got[count:] == 0).all()
    if count:
        assert torch.equal(got[:count], kpool.ln_masked_pool_plain(
            x[:count], w, b, mask[:count]))


def test_ln_masked_pool_and_span_head_refuse_what_they_do_not_take(dev):
    """K12 and K8 raise, never fall back, off their widths (d % 8 to
    1024), off K12's rows (L <= 1024) and on h not 16-byte aligned."""
    w = torch.ones(1032, device=dev)
    for d in (12, 1032):
        x = torch.zeros(2, 4, d, dtype=torch.bfloat16, device=dev)
        with pytest.raises(ValueError, match="d % 8"):
            kpool.ln_masked_pool(x, w[:d], w[:d], torch.ones(
                2, 4, dtype=torch.bool, device=dev))
        idx = torch.zeros(4, dtype=torch.int32, device=dev)
        with pytest.raises(ValueError, match="d % 8"):
            khead.span_head_scatter(x, w[:d], w[:d], w[:d], w[:1], idx,
                                    idx, idx, 1)
    x = torch.zeros(1, 1025, 8, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="L up to"):
        kpool.ln_masked_pool(x, w[:8], w[:8], torch.ones(
            1, 1025, dtype=torch.bool, device=dev))
    flat = torch.zeros(2 * 4 * 64 + 1, dtype=torch.bfloat16, device=dev)
    x = flat[1:].view(2, 4, 64)  # 2 bytes past an aligned address
    with pytest.raises(ValueError, match="16-byte"):
        kpool.ln_masked_pool(x, w[:64], w[:64], torch.ones(
            2, 4, dtype=torch.bool, device=dev))
    idx = torch.zeros(4, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="16-byte"):
        khead.span_head_scatter(x, w[:64], w[:64], w[:64], w[:1], idx, idx,
                                idx, 1)


def _heads(dev, d, vocabs=(512, 2048, 8, 1), seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [(torch.randn(V, d, generator=g, device=dev) / math.sqrt(d),
             0.1 * torch.randn(V, generator=g, device=dev)) for V in vocabs]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,vocabs", [(128, (512, 2048, 8, 1)),
                                      (32, (64, 64, 8, 1)),
                                      (256, (100, 300, 8, 1))])
@pytest.mark.parametrize("M,density", [(1, 1.0), (4096, 0.16),
                                       (20000, 0.9), (300000, 0.5)])
def test_recon_ce_kernel_matches_plain(dev, dtype, d, vocabs, M, density):
    """Both kernels (bf16: tensor cores, tiles split into vocabulary slices
    at the smaller M and whole at M = 300000; f32: CUDA cores) against
    the plain version."""
    x, mask = _masked_rows(dev, M, 1, d, dtype, density, seed=M + d)
    x, mask = x.view(M, d), mask.view(M)
    g = torch.Generator(device=dev).manual_seed(M)
    cat = torch.stack([torch.randint(0, V, (M,), generator=g, device=dev)
                       for V in vocabs[:3]] + [torch.zeros(
                           M, dtype=torch.int64, device=dev)] * 2,
                      1).to(torch.int32)
    cat[::7, 1] = vocabs[1] + 5  # past its head: a NaN error (fault C5)
    cont = torch.rand(M, 3, generator=g, device=dev) * 10
    w = 1 + 0.2 * torch.randn(d, generator=g, device=dev)
    b = 0.1 * torch.randn(d, generator=g, device=dev)
    heads = _heads(dev, d, vocabs, seed=d)
    weights = (1.0, 1.0, 0.5, 1.0)
    smap = torch.randperm(M, generator=g, device=dev).to(torch.int32)
    smap[::5] = -1
    args = (x, w, b, heads, cat, cont, mask, weights)
    before = krecon.launches, krecon.tc_launches
    got = krecon.recon_ce(*args)
    got_e, got_s = krecon.recon_ce(*args, span_map=smap, n_out=M + 3)
    ref_e, ref_s = krecon.recon_ce_plain(*args, span_map=smap, n_out=M + 3)
    torch.cuda.synchronize()
    tc = 2 if dtype == "bfloat16" else 0
    assert (krecon.launches, krecon.tc_launches) == (before[0] + 2,
                                                     before[1] + tc)
    # the NaN errors (and scores) are the plain version's: the real
    # positions whose name label lies past the head; the rest finite
    past = torch.zeros_like(mask)
    past[::7] = True
    past &= mask
    assert torch.equal(got.isnan(), past) and torch.equal(ref_e.isnan(), past)
    assert torch.equal(got_s.isnan(), ref_s.isnan())
    assert torch.equal(got.nan_to_num(), got_e.nan_to_num())
    assert ((got - ref_e)[~past].abs() <= RECON_ATOL).all()
    assert (got[~mask] == 0).all()
    fin = ~ref_s.isnan()
    assert ((got_s - ref_s)[fin].abs() <= RECON_ATOL).all()
    assert (got_s[M:] == 0).all()


def test_recon_ce_bf16_planes_from_the_model_cache(dev):
    """The autoencoder's cached planes give the kernel the same errors as
    planes made for the call, and as the CPU's split of the same heads;
    planes of other heads, and a kind head wider than MAX_KIND, are
    refused."""
    model = SpanAutoencoder(AutoencoderConfig(), device=dev, seed=2)
    m = model.module
    heads = m.heads()
    planes = m.head_planes()
    assert m.head_planes() is planes
    cpu = krecon.head_planes([(w.cpu(), b.cpu()) for w, b in heads])
    assert torch.equal(planes.w.cpu(), cpu.w)
    assert torch.equal(planes.b.cpu(), cpu.b)
    M, d = 5000, 128
    x, mask = _masked_rows(dev, M, 1, d, "bfloat16", 0.3, seed=4)
    x, mask = x.view(M, d), mask.view(M)
    g = torch.Generator(device=dev).manual_seed(4)
    cat = torch.stack([torch.randint(0, V, (M,), generator=g, device=dev)
                       for V in (512, 2048, 8)], 1).to(torch.int32)
    cont = torch.rand(M, 1, generator=g, device=dev) * 10
    args = (x, m.dec_ln.weight, m.dec_ln.bias, heads, cat, cont, mask,
            (1.0, 1.0, 0.5, 1.0))
    a = krecon.recon_ce(*args, planes=planes)
    b = krecon.recon_ce(*args)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    other = krecon.head_planes(_heads(dev, d, (512, 1024, 8, 1)))
    with pytest.raises(ValueError, match="planes"):
        krecon.recon_ce(*args, planes=other)
    wide = list(heads)
    wide[2] = (torch.randn(20, d, device=dev), torch.zeros(20, device=dev))
    with pytest.raises(ValueError, match="kind head"):
        krecon.recon_ce(*args[:3], wide, *args[4:])


@pytest.mark.parametrize("kind,n_traces,L", [("otel", 1, 64),
                                             ("otel", 400, 64),
                                             ("adversarial", 400, 64),
                                             ("adversarial", 400, 16),
                                             ("multi", 200, 64),
                                             ("otel", 12800, 64),
                                             ("huge", 4000, 64),
                                             ("adversarial", 400, 1024)])
@pytest.mark.parametrize("rows", ["bucket", "traces", "fewer"])
def test_trace_rows_pack_kernel_matches_plain(dev, kind, n_traces, L, rows):
    """One trace per row: real frames, a trace of 200 spans (truncated at
    L), tied starts, high-bit ids, 131072-span buckets, all-padding rows,
    and fewer rows than traces (the rest dropped)."""
    n, svc_t, nam_t, c = _staged_on(dev, _fused_batches(kind, n_traces))
    cat, cont = kfeat.featurize_columns_plain(
        *_feat_args((svc_t, nam_t), c), n)
    perm = ksort.radix_sort_plain(
        [c["trace_id_hi"], c["trace_id_lo"], c["start_unix_nano"]], n)
    ref = kpack.trace_rows_pack_plain(perm, c["trace_id_hi"],
                                      c["trace_id_lo"], cat, cont, n, L, n)
    traces = int(ref.rows_used)
    R = {"bucket": n, "traces": traces, "fewer": max(1, traces // 3)}[rows]
    before = kpack.rows_launches
    got = kpack.trace_rows_pack(perm, c["trace_id_hi"], c["trace_id_lo"],
                                cat, cont, n, L, R)
    ref = kpack.trace_rows_pack_plain(perm, c["trace_id_hi"],
                                      c["trace_id_lo"], cat, cont, n, L, R)
    torch.cuda.synchronize()
    assert kpack.rows_launches == before + 1
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert int(got.rows_used) == traces


def test_trace_rows_pack_kernel_empty_group(dev):
    z64 = torch.zeros(512, dtype=torch.int64, device=dev)
    perm = torch.arange(512, dtype=torch.int32, device=dev)
    cat = torch.zeros((512, 5), dtype=torch.int32, device=dev)
    cont = torch.zeros((512, 3), device=dev)
    got = kpack.trace_rows_pack(perm, z64, z64, cat, cont, 0, 64, 256)
    torch.cuda.synchronize()
    assert int(got.rows_used) == 0
    assert not got.categorical.any() and not got.mask.any()
    assert (got.span_map == -1).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_autoencoder_kernel_path_matches_plain_path(dev, dtype):
    """The autoencoder's forward with K2, K1, K12 and K11 against its plain
    path on the card, with all-padding rows: K1, K2 and K11 sum in another
    order, so the errors agree to a relative bound (1e-5 in f32, 2e-2 in
    bf16, where a last-bit change of an activation rounds on)."""
    from odigos_tpu_torch.features import assemble_sequences

    model = SpanAutoencoder(AutoencoderConfig(dtype=getattr(torch, dtype)),
                            device=dev)
    seqs = assemble_sequences(synthesize_traces(300, seed=5), max_len=64,
                              pad_traces_to=lambda t: t + 20)
    args = (seqs.categorical, seqs.continuous, seqs.mask)
    launches = (kpool.launches, krecon.launches, attention.launches,
                embed.launches)
    got = model.span_errors(*args)
    ref = model.span_errors(*args, reference=True)
    torch.cuda.synchronize()
    assert (kpool.launches - launches[0], krecon.launches - launches[1],
            attention.launches - launches[2],
            embed.launches - launches[3]) == (1, 1, 2, 1)
    m = torch.from_numpy(seqs.mask).to(dev)
    assert torch.isfinite(got).all() and (got[~m] == 0).all()
    rel = ((got - ref).abs() / ref.abs().clamp(min=1))[m].max().item()
    assert rel <= (1e-5 if dtype == "float32" else 2e-2)


def test_gpu_autoencoder_engine_scores_like_the_cpu_engine(dev):
    """Host route and fused route of the autoencoder engine on the card
    against the CPU's, same f32 weights; the loss weights scaled down so
    the squash does not saturate (tests/test_torch_autoencoder.py)."""
    cfg = dict(model="autoencoder", trace_bucket=16, max_batch_spans=8192,
               model_config=AutoencoderConfig(
                   dtype=torch.float32, w_service=0.01, w_name=0.01,
                   w_kind=0.005, w_duration=0.002))
    gpu = ScoringEngine(EngineConfig(device="cuda", **cfg))
    cpu = ScoringEngine(EngineConfig(device="cpu", **cfg))
    cpu.backend.model.load_state_dict(
        {k: v.cpu() for k, v in gpu.backend.model.state_dict().items()})
    batches = [synthesize_traces(20 + 7 * i, seed=40 + i) for i in range(3)]
    batches.append(adversarial_traces(300, seed=3))
    launches0 = (kpool.launches, krecon.launches, kpack.rows_launches)
    for b in batches:
        got = gpu.backend.score(b, featurize(b))
        ref = cpu.backend.score(b, featurize(b))
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
        cols = extract_columns(b)[0]
        fgot = gpu.backend.harvest(gpu.backend.dispatch_columns([cols]))
        np.testing.assert_allclose(fgot, ref, atol=1e-4, rtol=1e-4)
        assert 0 < fgot.max() < 1
    assert (kpool.launches - launches0[0], krecon.launches - launches0[1],
            kpack.rows_launches - launches0[2]) == (8, 8, 4)


# -------------------------------------------- the float block's chain (B2)
from odigos_tpu_torch.kernels import dense as kdense  # noqa: E402


def _gemm_close(got: torch.Tensor, ref: torch.Tensor, x: torch.Tensor,
                w: torch.Tensor, epilogue: str) -> None:
    """K15 against its plain version. The two sum the same f32 products in
    another order: in bf16 the rounded product may land one step apart and
    each later rounding (the bias add; the GELU or the residual add) one
    more, so each output is within one bf16 step per rounding (2 for
    "none", 3 otherwise) at the largest magnitude of the rounded product
    or the output; in f32 within F32_ATOL of that magnitude."""
    assert got.shape == ref.shape and got.dtype == ref.dtype
    g, r = got.float(), ref.float()
    assert torch.isfinite(g).all()
    pre = kdense.gemm_bf16_plain(x, w, torch.zeros_like(w[:, 0]))
    top = max(r.abs().max().item(), pre.float().abs().max().item(),
              2.0 ** -20)
    lim = (F32_ATOL * max(1.0, top) if got.dtype == torch.float32
           else (2 if epilogue == "none" else 3)
           * 2.0 ** (math.floor(math.log2(top)) - 7))
    assert (g - r).abs().max().item() <= lim


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("M,d", [(16384, 256), (1, 256), (1000, 128),
                                 (333, 32), (77, 1024)])
def test_ln_bf16_kernel_is_bit_equal_to_plain(dev, M, d, dtype):
    g = torch.Generator(device=dev).manual_seed(M + d)
    x = (torch.randn(M, d, generator=g, device=dev) * 3 + 1).to(
        getattr(torch, dtype))
    w = torch.randn(d, generator=g, device=dev) * 0.2 + 1
    b = torch.randn(d, generator=g, device=dev) * 0.2
    before = kdense.ln_launches
    got = kdense.ln_bf16(x, w, b)
    ref = kdense.ln_bf16_plain(x, w, b)
    torch.cuda.synchronize()
    assert kdense.ln_launches == before + 1
    assert torch.equal(got, ref)


def _dense_inputs(dev, M, N, K, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    dt = getattr(torch, dtype)
    x = torch.randn(M, K, generator=g, device=dev).to(dt)
    w = (torch.randn(N, K, generator=g, device=dev) / math.sqrt(K)).to(dt)
    b = (0.3 * torch.randn(N, generator=g, device=dev)).to(dt)
    return x, w, b


@pytest.mark.parametrize("M,N,K,epilogue,planes", [
    (16384, 768, 256, "none", 3),         # QKV, split for K1
    (16384, 256, 256, "residual", 1),     # out-projection
    (16384, 1024, 256, "gelu_tanh", 1),   # FFN1
    (16384, 256, 1024, "residual", 1),    # FFN2
    (4096, 384, 128, "none", 3),          # the autoencoder's QKV
    (4096, 512, 128, "gelu_tanh", 1),     # its FFN1, dec_ff1
    (4096, 128, 512, "none", 1),          # dec_ff2
    (1000, 200, 80, "none", 1),           # ragged M, N and K
    (1000, 200, 80, "gelu_tanh", 1),
    (130, 24, 48, "residual", 1),
    (130, 24, 272, "residual", 1),        # streaming, half-tile residual
    (1, 128, 16, "none", 2)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_gemm_bf16_kernel_matches_plain(dev, M, N, K, epilogue, planes,
                                        dtype):
    x, w, b = _dense_inputs(dev, M, N, K, dtype)
    res = torch.randn(M, N, device=dev).to(x.dtype) \
        if epilogue == "residual" else None
    before = kdense.gemm_launches
    got = kdense.gemm_bf16(x, w, b, epilogue, res, planes)
    ref = kdense.gemm_bf16_plain(x, w, b, epilogue, res, planes)
    torch.cuda.synchronize()
    assert kdense.gemm_launches == before + 1
    _gemm_close(got, ref, x, w, epilogue)
    differing = int((got.float() != ref.float()).sum())
    print(f"gemm_bf16 {M}x{N}x{K} {epilogue} {dtype}: {differing} of "
          f"{got.numel()} outputs differ from the plain version")


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int16)


def test_gemm_bf16_gelu_table_is_bit_equal_to_formula_on_every_bf16(dev):
    """x = 0, so every output is round(gelu(b_n)): b walks all 65,536 bf16
    bit patterns (|y| < 2^-61, |y| >= 8, +-inf and NaN included) in chunks
    of 8192 columns; the table's lookup gives the formula's bits."""
    patterns = torch.arange(65536, dtype=torch.int32).to(torch.int16).view(
        torch.bfloat16).to(dev)
    x = torch.zeros(256, 16, dtype=torch.bfloat16, device=dev)
    for c in range(0, 65536, 8192):
        b = patterns[c:c + 8192].contiguous()
        w = torch.zeros(8192, 16, dtype=torch.bfloat16, device=dev)
        got = kdense.gemm_bf16(x, w, b, "gelu_tanh")
        ref = kdense.gemm_bf16(x, w, b, "gelu_tanh_formula")
        torch.cuda.synchronize()
        assert torch.equal(_bits(got), _bits(ref))


@pytest.mark.parametrize("M,N,K", [(16384, 1024, 256), (4096, 512, 128),
                                   (1000, 200, 80), (16384, 1024, 1024)])
def test_gemm_bf16_gelu_table_is_bit_equal_to_formula(dev, M, N, K):
    """On FFN1's and dec_ff1's shapes (the weight-stationary walk), a
    ragged one and a deep one (the streaming walk), scaled so that some
    outputs fall below 2^-10 (the table's low end) and some at or past 8
    (the formula's)."""
    x, w, b = _dense_inputs(dev, M, N, K, "bfloat16", seed=7)
    x = x * 3
    got = kdense.gemm_bf16(x, w, b, "gelu_tanh")
    ref = kdense.gemm_bf16(x, w, b, "gelu_tanh_formula")
    torch.cuda.synchronize()
    assert torch.equal(_bits(got), _bits(ref))
    y = kdense.gemm_bf16_plain(x, w, b).float().abs()
    assert bool((y < 2 ** -10).any()) and bool((y >= 8).any())


def test_gemm_bf16_kernel_past_2_31_outputs(dev):
    """M x N past 2^31 elements (the autoencoder's fused FFN1 reaches
    2^32): the rows at both ends against the plain version on those rows
    alone (each output row depends on its input row only)."""
    M, N, K = (1 << 31) // 512 + 3000, 512, 128
    x, w, b = _dense_inputs(dev, M, N, K, "bfloat16")
    got = kdense.gemm_bf16(x, w, b, "gelu_tanh")
    torch.cuda.synchronize()
    assert got.numel() > 2 ** 31
    for rows in (slice(0, 4096), slice(M - 4096, M)):
        _gemm_close(got[rows], kdense.gemm_bf16_plain(x[rows], w, b,
                                                      "gelu_tanh"),
                    x[rows], w, "gelu_tanh")


def test_dense_kernels_refuse_what_they_do_not_take(dev):
    x, w, b = _dense_inputs(dev, 64, 64, 48, "bfloat16")
    with pytest.raises(ValueError, match="K % 16"):
        kdense.gemm_bf16(x[:, :24].contiguous(), w[:, :24].contiguous(), b)
    with pytest.raises(ValueError, match="N % 8 == 0"):
        kdense.gemm_bf16(x, w[:60].contiguous(), b[:60])
    with pytest.raises(ValueError, match="N / planes % 64"):
        kdense.gemm_bf16(x, w, b, planes=2)
    flat = torch.zeros(64 * 48 + 8, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="aligned"):
        kdense.gemm_bf16(flat[1:64 * 48 + 1].view(64, 48), w, b)
    strided = torch.zeros(64, 96, dtype=torch.bfloat16, device=dev)[:, :48]
    with pytest.raises(ValueError, match="contiguous"):
        kdense.gemm_bf16(strided, w, b)
    with pytest.raises(TypeError):
        kdense.gemm_bf16(x.half(), w.half(), b.half())
    with pytest.raises(TypeError):
        kdense.gemm_bf16(x, w.float(), b)
    with pytest.raises(ValueError, match="d % 8"):
        kdense.ln_bf16(torch.randn(8, 44, device=dev), torch.ones(44,
                                                                   device=dev),
                       torch.zeros(44, device=dev))
    with pytest.raises(ValueError, match="d % 8"):
        kdense.ln_bf16(torch.randn(8, 1032, device=dev),
                       torch.ones(1032, device=dev),
                       torch.zeros(1032, device=dev))
    with pytest.raises(TypeError):
        kdense.ln_bf16(torch.randn(8, 64, device=dev).half(),
                       torch.ones(64, device=dev), torch.zeros(64, device=dev))
    with pytest.raises(TypeError, match="float32"):
        kdense.ln_bf16(torch.randn(8, 64, device=dev),
                       torch.ones(64, device=dev).bfloat16(),
                       torch.zeros(64, device=dev))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_forward_launches_the_dense_chain(dev, dtype):
    """One host-route forward of the default transformer: K14 twice a layer
    and once for the final LayerNorm, K15 four times a layer (QKV as one
    launch); the autoencoder's: K14 twice a layer, K15 four times a layer
    and twice in the decoder."""
    model = TraceTransformer(TransformerConfig(dtype=getattr(torch, dtype)),
                             device=dev)
    pk = _packed(100, 64)
    ln0, gemm0 = kdense.ln_launches, kdense.gemm_launches
    model.score_packed(pk.categorical, pk.continuous, pk.segments,
                       pk.positions)
    torch.cuda.synchronize()
    n = model.cfg.n_layers
    assert (kdense.ln_launches - ln0, kdense.gemm_launches - gemm0) == \
        (2 * n + 1, 4 * n)
    from odigos_tpu_torch.features import assemble_sequences

    ae = SpanAutoencoder(AutoencoderConfig(dtype=getattr(torch, dtype)),
                         device=dev)
    seqs = assemble_sequences(synthesize_traces(50, seed=5), max_len=64)
    ln0, gemm0 = kdense.ln_launches, kdense.gemm_launches
    ae.span_errors(seqs.categorical, seqs.continuous, seqs.mask)
    torch.cuda.synchronize()
    n = ae.cfg.n_layers
    assert (kdense.ln_launches - ln0, kdense.gemm_launches - gemm0) == \
        (2 * n, 4 * n + 2)


# ----------------------------------------------------------------------
# The geometries past the default one (the coverage contract,
# kernels/coverage.py): each kernel at the new widths against its plain
# version, with the bounds above.

@pytest.mark.parametrize("L,H,hd,dtype,route", [
    (128, 2, 128, "bfloat16", "flash"),   # L 128, hd 128 (d 256, 2 heads)
    (256, 4, 64, "bfloat16", "flash"),
    (1024, 1, 64, "bfloat16", "flash"),   # K7's longest rows
    (128, 2, 256, "bfloat16", "flash"),   # hd 256
    (64, 16, 64, "bfloat16", "flash"),    # a row past one stage (d 1024)
    (72, 3, 48, "bfloat16", "flash"),     # L off 16-key tiles
    (128, 2, 128, "float32", "tiled"),
    (100, 3, 40, "bfloat16", "tiled"),    # hd % 16 != 0
    (1024, 1, 256, "float32", "tiled"),
])
def test_segment_attention_tiled_kernels_match_plain(dev, L, H, hd, dtype,
                                                     route):
    """The tiled kernels (64-key tiles, online softmax) on packed rows at
    L: padding rows, padding slots in live rows, single-slot segments and
    segments across tile edges."""
    pk = _packed(400 if L <= 256 else 2000, L, pad=2)
    R = pk.n_rows
    q, k, v = _qkv(dev, R, L, H, hd, getattr(torch, dtype), seed=L + hd)
    seg_np = pk.segments.copy()
    seg_np[0, 5] = 999                  # a single-slot segment mid-row
    seg = torch.from_numpy(seg_np).to(dev)
    assert attention.kernel_route(q, k, v, seg) == route
    got = _attend_and_check(q, k, v, seg,
                            atol=F32_ATOL if dtype == "float32" else None)
    uniform = v[R - 1].float().mean(0)  # an all-padding row: the mean of V
    tol = F32_ATOL if dtype == "float32" else _step(uniform)
    assert (got[R - 1].float() - uniform).abs().max().item() <= 2 * tol


@pytest.mark.parametrize("M,K", [(4096, 2048), (4096, 4096), (333, 1032)])
@pytest.mark.parametrize("ln", [True, False], ids=["ln", "plain"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_ln_quantize_wide_rows_match_plain(dev, M, K, ln, dtype):
    """K9 past K = 1024 (a CTA a row): codes and scales bit-equal."""
    _quantize_and_check(_rows(dev, M, K, dtype), ln)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [96, 512, 1024, 144, 8])
def test_ln_masked_pool_any_width_matches_plain(dev, dtype, d):
    x, mask = _masked_rows(dev, 700, 64, d, dtype, 0.2, seed=d)
    g = torch.Generator(device=dev).manual_seed(d)
    w = 1 + 0.2 * torch.randn(d, generator=g, device=dev)
    b = 0.1 * torch.randn(d, generator=g, device=dev)
    before = kpool.launches
    got = kpool.ln_masked_pool(x, w, b, mask)
    ref = kpool.ln_masked_pool_plain(x, w, b, mask)
    torch.cuda.synchronize()
    assert kpool.launches == before + 1
    assert torch.equal(got, ref)


def _recon_args(dev, M, d, dtype, vocabs=(512, 2048, 8, 1), density=0.3,
                heads=None):
    x, mask = _masked_rows(dev, M, 1, d, dtype, density, seed=M + d)
    x, mask = x.view(M, d), mask.view(M)
    g = torch.Generator(device=dev).manual_seed(M)
    cat = torch.stack([torch.randint(0, V, (M,), generator=g, device=dev)
                       for V in vocabs[:3]], 1).to(torch.int32)
    cont = torch.rand(M, 3, generator=g, device=dev) * 10
    w = 1 + 0.2 * torch.randn(d, generator=g, device=dev)
    b = 0.1 * torch.randn(d, generator=g, device=dev)
    heads = _heads(dev, d, vocabs, seed=d) if heads is None else heads
    return (x, w, b, heads, cat, cont, mask, (1.0, 1.0, 0.5, 1.0))


@pytest.mark.parametrize("dtype,route", [("bfloat16", "tc"),
                                         ("float32", "cuda_core"),
                                         ("bfloat16", "cuda_core")])
@pytest.mark.parametrize("d", [96, 384, 512, 1024])
@pytest.mark.parametrize("M", [4096, 60000])
def test_recon_ce_any_width_matches_plain(dev, dtype, route, d, M):
    """K11 off the four tensor-core widths: the 64-position tensor-core
    kernel chunked along d (bf16), the CUDA-core kernel (f32, and bf16
    by route), within RECON_ATOL of the plain version."""
    args = _recon_args(dev, M, d, dtype)
    smap = torch.randperm(M, device=dev).to(torch.int32)
    before = krecon.launches, krecon.tc_launches
    got_e, got_s = krecon.recon_ce(*args, span_map=smap, n_out=M,
                                   route=route)
    ref_e, ref_s = krecon.recon_ce_plain(*args, span_map=smap, n_out=M)
    torch.cuda.synchronize()
    assert (krecon.launches - before[0], krecon.tc_launches - before[1]) \
        == (1, int(route == "tc"))
    assert torch.isfinite(got_e).all()
    assert (got_e - ref_e).abs().max().item() <= RECON_ATOL
    assert (got_s - ref_s).abs().max().item() <= RECON_ATOL
    assert (got_e[~args[6]] == 0).all()


def test_autoencoder_serves_unsplittable_heads_on_the_cuda_core_kernel(dev):
    """Heads of 1e-36 (below the three planes' range): the model picks the
    CUDA-core kernel when the weights load, names it, and scores within
    RECON_ATOL of the plain path."""
    model = SpanAutoencoder(AutoencoderConfig(), device=dev, seed=3)
    assert model.recon_route == "tc"
    with torch.no_grad():
        model.module.name_head.weight.mul_(1e-36)
    assert model.recon_route == "cuda_core"
    from odigos_tpu_torch.features import assemble_sequences

    seqs = assemble_sequences(synthesize_traces(60, seed=4), max_len=64)
    before = krecon.launches, krecon.tc_launches
    got = model.span_errors(seqs.categorical, seqs.continuous, seqs.mask)
    ref = model.span_errors(seqs.categorical, seqs.continuous, seqs.mask,
                            reference=True)
    torch.cuda.synchronize()
    assert (krecon.launches - before[0], krecon.tc_launches - before[1]) \
        == (1, 0)
    assert ((got - ref).abs() / ref.abs().clamp(min=1)).max().item() \
        <= 2e-2


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("M,d", [(4096, 8), (4096, 96), (16384, 128),
                                 (3000, 384), (3000, 768), (1000, 1016),
                                 (777, 1024)])
def test_ln_bf16_any_width_is_bit_equal_to_plain(dev, M, d, dtype):
    g = torch.Generator(device=dev).manual_seed(M + d)
    x = (torch.randn(M, d, generator=g, device=dev) * 3 + 1).to(
        getattr(torch, dtype))
    w = torch.randn(d, generator=g, device=dev) * 0.2 + 1
    b = torch.randn(d, generator=g, device=dev) * 0.2
    before = kdense.ln_launches
    got = kdense.ln_bf16(x, w, b)
    ref = kdense.ln_bf16_plain(x, w, b)
    torch.cuda.synchronize()
    assert kdense.ln_launches == before + 1
    assert torch.equal(got, ref)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("d,per,live", [(128, 64, 7), (256, 64, 0),
                                        (1024, 1, 100), (96, 3, 10 ** 6)])
def test_ln_bf16_with_a_row_count_writes_no_row_past_it(dev, dtype, d,
                                                         per, live):
    """Rows at or past live * per keep what the buffer held (a sentinel
    written before the launch); the rows before it equal the plain
    version's, which writes NaN past the count."""
    M = 300 * per if per > 1 else 600
    g = torch.Generator(device=dev).manual_seed(d)
    x = torch.randn(M, d, generator=g, device=dev).to(getattr(torch, dtype))
    w = torch.randn(d, generator=g, device=dev) * 0.2 + 1
    b = torch.randn(d, generator=g, device=dev) * 0.2
    cnt = torch.tensor([live], dtype=torch.int32, device=dev)
    got = kdense.ln_bf16(x, w, b, live=cnt, per=per,
                         out=torch.full_like(x, 12345.0))
    ref = kdense.ln_bf16_plain(x, w, b, live=cnt, per=per)
    torch.cuda.synchronize()
    n = min(M, live * per)
    assert torch.equal(got[:n], ref[:n])
    assert (got[n:] == 12345.0).all()
    assert torch.isnan(ref[n:]).all()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("M,N,K,epilogue,planes,per,live", [
    (64 * 300, 768, 256, "none", 3, 64, 7),        # QKV, 7 of 300 rows
    (64 * 300, 1024, 256, "gelu_tanh", 1, 64, 0),  # FFN1, no real row
    (64 * 300, 256, 1024, "residual", 1, 64, 299),  # FFN2, a streamed K
    (64 * 300, 128, 512, "none", 1, 64, 10 ** 6),  # dec_ff2, all real
    (1000, 512, 128, "gelu_tanh", 1, 1, 130)])     # a count off a tile
def test_gemm_bf16_with_a_row_count_skips_the_tiles_past_it(
        dev, dtype, M, N, K, epilogue, planes, per, live):
    """Rows below live * per equal the launch without a count, bit for bit;
    the row tiles wholly past it (128 rows; on f32 the tile the shape takes,
    64 or 32 rows) keep what the buffer held (a sentinel written before the
    launch, NaN here: the GELU's rare value); the plain version writes NaN
    in every row past the count."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device=dev).manual_seed(M + N + K)
    x = (torch.randn(M, K, generator=g, device=dev) * 0.5).to(dt)
    w = (torch.randn(N, K, generator=g, device=dev) / K ** 0.5).to(dt)
    b = (torch.randn(N, generator=g, device=dev) * 0.1).to(dt)
    res = (torch.randn(M, N, generator=g, device=dev).to(dt)
           if epilogue == "residual" else None)
    cnt = torch.tensor([live], dtype=torch.int32, device=dev)
    shape = (M, N) if planes == 1 else (planes, M, N // planes)
    full = kdense.gemm_bf16(x, w, b, epilogue, res, planes)
    got = kdense.gemm_bf16(x, w, b, epilogue, res, planes, live=cnt, per=per,
                           out=torch.full(shape, float("nan"), dtype=dt,
                                          device=dev))
    ref = kdense.gemm_bf16_plain(x, w, b, epilogue, res, planes, live=cnt,
                                 per=per)
    torch.cuda.synchronize()
    n = min(M, live * per)
    tile = 128 if dtype == "bfloat16" else kdense.f32_tile(M, N)[0]
    past = min(M, -(-n // tile) * tile)
    rows = (lambda t: t) if planes == 1 else (lambda t: t.transpose(0, 1))
    assert torch.equal(rows(got)[:n], rows(full)[:n])
    assert torch.isnan(rows(got)[past:].float()).all()
    assert torch.isnan(rows(ref)[n:].float()).all()
    assert not torch.isnan(rows(ref)[:n].float()).any()


@pytest.mark.parametrize("d", [512, 1024])
def test_ln_bf16_outside_the_exact_sum_condition_stays_close(dev, d):
    """Rows whose values span more binades than the f64 sums hold exactly
    (spread + log2(d) + 24 > 53 for the squared deviations): kernel and
    plain may round the statistics apart: a mean or 1 / std one f32 step
    apart moves each output by a few steps of the row's largest output
    (bound 8 steps)."""
    g = torch.Generator(device=dev).manual_seed(d)
    mag = torch.pow(2.0, torch.randint(-40, 40, (64, d), generator=g,
                                       device=dev).float())
    x = (torch.randn(64, d, generator=g, device=dev) * mag).to(torch.float32)
    w = torch.ones(d, device=dev)
    b = torch.zeros(d, device=dev)
    got = kdense.ln_bf16(x, w, b)
    ref = kdense.ln_bf16_plain(x, w, b)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    top = ref.abs().amax(1, keepdim=True)
    assert ((got - ref).abs() <= 8 * torch.finfo(torch.float32).eps
            * top).all()


# ------------------------------------------------ training: K16-K19 (f32)
# Bounds, each relative to the largest magnitude of the plain version's
# output (the kernels and their plain versions compute in f32 in other
# summation orders): K16 1e-4 (sums of up to L hd products in another
# order, then P (dP - Delta), which cancels); K17, K18 and K19 1e-6 (their
# sums are f64 sums of the same f32 terms, rounded once, and every other
# step the same IEEE op); K1's log-sum-exp 1e-5 absolute on live queries.
BWD_ATTN_RTOL = 1e-4
BWD_EXACT_RTOL = 1e-6
LSE_ATOL = 1e-5
TRAIN_GRAD_RTOL = 1e-4   # a step's gradients, kernels vs plain, on the card


def _close(got, ref, rtol, what):
    lim = rtol * ref.abs().max().item()
    err = (got - ref).abs().max().item()
    assert err <= lim, (what, err, lim)
    assert torch.isfinite(got).all(), what


def _attn_inputs(dev, R, L, H, hd, seed=0):
    g = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn(R, L, H, hd, generator=g).to(dev)
                   for _ in range(4))
    seg = torch.zeros(R, L, dtype=torch.int32)
    for r in range(R - 1):  # the last row all padding
        n = 1 + (r * 7 + L // 2) % L
        seg[r, :n] = torch.arange(n) // max(1, n // 3) + 1
    do = do * (seg > 0)[..., None, None].to(dev)  # the loss masks padding
    return q, k, v, seg.to(dev), do


@pytest.mark.parametrize("R,L,H,hd", [(64, 32, 4, 64), (8, 128, 2, 128),
                                      (4, 96, 2, 256), (16, 64, 4, 32),
                                      (2, 1024, 2, 64), (3, 200, 1, 40)])
def test_k16_attention_bwd_matches_plain(dev, R, L, H, hd):
    q, k, v, seg, do = _attn_inputs(dev, R, L, H, hd)
    lse = torch.empty(R, H, L, device=dev)
    lse_p = torch.empty(R, H, L, device=dev)
    o = segment_attention(q, k, v, seg, lse=lse)
    o_p = segment_attention_plain(q, k, v, seg, lse_p)
    torch.testing.assert_close(o, o_p, atol=F32_ATOL, rtol=F32_ATOL)
    live = (seg > 0)[:, None, :].expand(R, H, L)
    assert (lse - lse_p)[live].abs().max().item() <= LSE_ATOL
    before = attention.bwd_launches
    got = attention.segment_attention_bwd(q, k, v, seg, o, lse, do)
    assert attention.bwd_launches == before + 1
    ref = attention.segment_attention_bwd_plain(q, k, v, seg, o, lse, do)
    for a, b, what in zip(got, ref, ("dq", "dk", "dv")):
        _close(a, b, BWD_ATTN_RTOL, what)


@pytest.mark.parametrize("hd", [4, 64, 100, 128, 256])
@pytest.mark.parametrize("L", [1, 32, 33, 64, 128, 1024])
@pytest.mark.parametrize("padding_do", [False, True])
def test_k16_routes_lengths_widths_and_padding_do(dev, L, hd, padding_do):
    """K16 on both routes (one CTA a (row, head) up to L 64, hd 128; the
    tiled grid past that) with an all-padding row and padding queries'
    dO zero (the trainers') or not: within the plain bound, one launch a
    call, and a second call bit-equal."""
    R = max(2, min(6, 4096 // L))
    q, k, v, seg, do = _attn_inputs(dev, R, L, 2, hd, seed=L + hd)
    if padding_do:
        g = torch.Generator().manual_seed(L * hd)
        do = torch.randn(R, L, 2, hd, generator=g).to(dev)
    lse = torch.empty(R, 2, L, device=dev)
    o = segment_attention(q, k, v, seg, lse=lse)
    before = attention.bwd_launches
    got = attention.segment_attention_bwd(q, k, v, seg, o, lse, do)
    again = attention.segment_attention_bwd(q, k, v, seg, o, lse, do)
    assert attention.bwd_launches == before + 2
    ref = attention.segment_attention_bwd_plain(q, k, v, seg, o, lse, do)
    want = "one_cta" if (L <= attention.BWD_ONE_CTA_MAX_L
                         and hd <= attention.BWD_ONE_CTA_MAX_HD
                         and hd % 4 == 0) else "tiled"
    assert attention.bwd_route(L, hd, q, k, v, o, do) == want
    for a, b, r, what in zip(got, again, ref, ("dq", "dk", "dv")):
        if L == 1 and what != "dv":
            # a live query's only key is itself: P = 1 and dS = dP - Delta
            # is the rounding of dO . v, so dq and dk are rounding noise;
            # hold them to the size of the terms that cancel
            top = (do.abs().max() * v.abs().max() * hd
                   * torch.maximum(q.abs().max(), k.abs().max())
                   / math.sqrt(hd)).item()
            assert (a - r).abs().max().item() <= BWD_ATTN_RTOL * top, what
        else:
            _close(a, r, BWD_ATTN_RTOL, what)
        assert torch.equal(a, b), what
    pad = seg == 0
    assert (got[0][pad] == 0).all() and (got[1][pad] == 0).all()
    if not padding_do:
        assert (got[2][pad] == 0).all()


def test_serving_launches_unchanged_by_the_training_outputs(dev):
    """K1 with and without its log-sum-exp, and K15's GELU with and
    without its pre-activation, write the same bits; bf16 takes neither."""
    from odigos_tpu_torch.kernels import dense

    q, k, v, seg, _ = _attn_inputs(dev, 16, 32, 4, 64)
    lse = torch.empty(16, 4, 32, device=dev)
    assert torch.equal(segment_attention(q, k, v, seg),
                       segment_attention(q, k, v, seg, lse=lse))
    g = torch.Generator().manual_seed(3)
    x = torch.randn(512, 256, generator=g).to(dev)
    w = (torch.randn(1024, 256, generator=g) / 16).to(dev)
    b = torch.randn(1024, generator=g).to(dev)
    pre = torch.empty(512, 1024, device=dev)
    y = dense.gemm_bf16(x, w, b, "gelu_tanh")
    assert torch.equal(y, dense.gemm_bf16(x, w, b, "gelu_tanh", pre=pre))
    ref_pre = torch.empty_like(pre)
    dense.gemm_bf16_plain(x, w, b, "gelu_tanh", pre=ref_pre)
    _close(pre, ref_pre, 1e-5, "pre")
    with pytest.raises(TypeError):
        dense.gemm_bf16(x.bfloat16(), w.bfloat16(), b.bfloat16(),
                        "gelu_tanh", pre=pre.bfloat16())
    with pytest.raises(ValueError):
        segment_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(), seg,
                          lse=lse)


@pytest.mark.parametrize("rows,d", [(2048, 256), (1000, 96), (64, 1024)])
def test_k17_ln_bwd_matches_plain(dev, rows, d):
    from odigos_tpu_torch.kernels import dense

    g = torch.Generator().manual_seed(rows + d)
    x = (torch.randn(rows, d, generator=g) * 3 + 1).to(dev)
    x[-1] = 0.0  # a padding row
    w = torch.randn(d, generator=g).to(dev)
    dy = torch.randn(rows, d, generator=g).to(dev)
    dy[-1] = 0.0
    before = dense.ln_bwd_launches
    got = dense.ln_bwd(x, w, dy)
    assert dense.ln_bwd_launches == before + 1
    ref = dense.ln_bwd_plain(x, w, dy)
    for a, r, what in zip(got, ref, ("dx", "dgamma", "dbeta")):
        _close(a, r, BWD_EXACT_RTOL, what)
    assert (got[0][-1] == 0).all()


@pytest.mark.parametrize("d", [1, 33, 128, 256, 1000, 1024])
@pytest.mark.parametrize("rows", [1, 63, 2048, 50000])
def test_k17_widths_rows_padding_and_a_second_call(dev, d, rows):
    """K17's one launch at every width bucket (vector and scalar rows),
    from one row to a grid past its cap, with zero padding rows: within
    the plain bound, one launch a call, and a second call bit-equal (the
    cached scratch's counters are left at zero)."""
    from odigos_tpu_torch.kernels import dense

    g = torch.Generator().manual_seed(rows * 7 + d)
    x = torch.randn(rows, d, generator=g) * 3 + 1
    w = torch.randn(d, generator=g)
    dy = torch.randn(rows, d, generator=g)
    pad = min(3, rows - 1)
    if pad:
        x[-pad:] = 0.0
        dy[-pad:] = 0.0
    x, w, dy = x.to(dev), w.to(dev), dy.to(dev)
    before = dense.ln_bwd_launches
    got = dense.ln_bwd(x, w, dy)
    again = dense.ln_bwd(x, w, dy)
    assert dense.ln_bwd_launches == before + 2
    ref = dense.ln_bwd_plain(x, w, dy)
    for a, b, r, what in zip(got, again, ref, ("dx", "dgamma", "dbeta")):
        _close(a, r, BWD_EXACT_RTOL, what)
        assert torch.equal(a, b), what
    if pad:
        assert (got[0][-pad:] == 0).all()


@pytest.mark.parametrize("M,N", [(2048, 1024), (300, 64), (4096, 4096),
                                 (2048, 512), (70, 44), (1, 4)])
def test_k19_gelu_bwd_matches_plain(dev, M, N):
    from odigos_tpu_torch.kernels import dense

    g = torch.Generator().manual_seed(M + N)
    pre = (torch.randn(M, N, generator=g) * 3).to(dev)
    dy = torch.randn(M, N, generator=g).to(dev)
    before = dense.gelu_bwd_launches
    got = dense.gelu_tanh_bwd(dy, pre)
    assert dense.gelu_bwd_launches == before + 1
    ref = dense.gelu_tanh_bwd_plain(dy, pre)
    _close(got[0], ref[0], BWD_EXACT_RTOL, "dpre")
    _close(got[1], ref[1], BWD_EXACT_RTOL, "db")


def _scratch_of(kernel, dev):
    """The scratch ``kernel``'s wrapper cached for the current stream."""
    from odigos_tpu_torch.kernels import build

    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(dev)
    return build._scratch[(kernel, idx, stream.cuda_stream)]


@pytest.mark.parametrize("M,N", [(2048, 1024), (2048, 512), (33, 260)])
def test_k19_one_launch_leaves_its_scratch_zeroed(dev, M, N):
    """K19's one launch: the launcher reports one kernel a call, the
    profiler sees that kernel and no other (no fill), its cached flags are
    zero after every call, and a second call on the same scratch gives the
    same bits."""
    from odigos_tpu_torch.kernels import dense

    g = torch.Generator().manual_seed(M * N)
    pre = (torch.randn(M, N, generator=g) * 3).to(dev)
    dy = torch.randn(M, N, generator=g).to(dev)
    d0 = dense.gelu_bwd_device_launches
    a = dense.gelu_tanh_bwd(dy, pre)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        b = dense.gelu_tanh_bwd(dy, pre)
        torch.cuda.synchronize()
    assert dense.gelu_bwd_device_launches - d0 == 2
    names = [e.key for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert names and all("gelu_bwd_kernel" in n for n in names), names
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    flags, _ = _scratch_of("gelu_bwd", dev)
    assert (flags == 0).all()


@pytest.mark.parametrize("d", [128, 256, 512, 1000])
def test_k11_f32_leaves_its_scratch_zeroed_and_repeats(dev, d):
    """K11's f32 route: two launches a call (the list, the persistent
    scoring kernel), the cached scratch's count and tickets zero after
    every call, and a second call bit-equal (errors, log-sum-exps)."""
    M = 3000
    args = _recon_args(dev, M, d, "float32")
    outs = []
    for _ in range(2):
        lse = torch.empty(M, 3, device=dev)
        d0 = krecon.device_launches
        outs.append((krecon.recon_ce(*args, route="cuda_core", lse=lse), lse))
        torch.cuda.synchronize()
        assert krecon.device_launches - d0 == 2
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    counters, _ = _scratch_of("recon_ce_f32", dev)
    assert (counters == 0).all()  # the count, the CTAs' and tiles' tickets


@pytest.mark.parametrize("attr_slots", [0, 2])
def test_k18_span_embed_bwd_matches_plain(dev, attr_slots):
    model = TraceTransformer(TransformerConfig(
        attr_slots=attr_slots, max_len=32, dtype=torch.float32), device=dev)
    pk = _packed(200, 32, attr_slots=attr_slots, pad=2)
    cat = torch.from_numpy(pk.categorical).to(dev)
    pos = torch.from_numpy(pk.positions).to(dev)
    seg = torch.from_numpy(pk.segments).to(dev)
    tables = model.module.encoder.tables()
    g = torch.Generator().manual_seed(5)
    dy = torch.randn(*seg.shape, tables.service.shape[1], generator=g).to(dev)
    before = embed.bwd_launches
    got = embed.span_embed_bwd(dy, cat, pos, seg, tables)
    assert embed.bwd_launches == before + 1
    ref = embed.span_embed_bwd_plain(dy, cat, pos, seg, tables)
    for name in ("service", "name", "kind", "status", "attr", "pos"):
        a, r = getattr(got, name), getattr(ref, name)
        if r is None:
            assert a is None
            continue
        _close(a, r, BWD_EXACT_RTOL, name)


@pytest.mark.parametrize("d", [256, 42])
@pytest.mark.parametrize("R,L", [(64, 32), (512, 64)])
def test_k18_attr_table_hot_row_and_clamped_ids(dev, d, R, L):
    """K18 with the attr table, one status row holding every live slot
    (a hot row cut across many warps) and ids past every table (their
    gradients dropped) and below zero (wrapped), at d 256 (16-byte
    vectors) and 42 (scalar columns), at the trainer's 2048 slots and at
    32768: every table bit-equal to the plain version, one launch a call,
    a second call bit-equal."""
    g = torch.Generator().manual_seed(d + R)

    def tab(n):
        return torch.randn(n, d, generator=g).to(dev)

    tables = EmbedTables(service=tab(512), name=tab(2048), kind=tab(8),
                         status=tab(4), attr=tab(30),
                         cont_w=torch.zeros(d, 3, device=dev),
                         cont_b=torch.zeros(d, device=dev), pos=tab(L))
    C = embed.N_BASE_FIELDS + 3
    cat = torch.randint(-5, 5000, (R, L, C), generator=g, dtype=torch.int32)
    cat[..., 3] = 1  # the hot row
    seg = (torch.rand(R, L, generator=g) < 0.4).to(torch.int32) * \
        torch.randint(1, 4, (R, L), generator=g, dtype=torch.int32)
    seg[-1] = 0
    pos = (torch.arange(L, dtype=torch.int32) + 7).expand(R, L).contiguous()
    dy = torch.randn(R, L, d, generator=g)
    cat, seg, pos, dy = (t.to(dev) for t in (cat, seg, pos, dy))
    before = embed.bwd_launches
    got = embed.span_embed_bwd(dy, cat, pos, seg, tables)
    again = embed.span_embed_bwd(dy, cat, pos, seg, tables)
    assert embed.bwd_launches == before + 2
    ref = embed.span_embed_bwd_plain(dy, cat, pos, seg, tables)
    for name in ("service", "name", "kind", "status", "attr", "pos"):
        a, b, r = (getattr(x, name) for x in (got, again, ref))
        assert torch.equal(a, r), name
        assert torch.equal(a, b), name


def test_training_step_on_the_card_runs_no_plain_backward(dev, monkeypatch):
    """One step of the trainer's path: every kernel launches its expected
    count, no plain version of a backward kernel is called, and the
    gradients equal the same step through the plain versions on the
    card within TRAIN_GRAD_RTOL of each parameter's largest gradient."""
    from odigos_tpu_torch.kernels import dense
    from odigos_tpu_torch.training import labeled_sequences

    n_layers = 2
    model = TraceTransformer(TransformerConfig(
        n_layers=n_layers, max_len=32, dtype=torch.float32), device=dev)
    d = labeled_sequences(64, max_len=32, seed=0, pad_traces_to=64)
    args = (d.categorical, d.continuous, d.mask, d.span_labels,
            d.trace_labels)
    model.module.train()
    calls = []
    for mod, name in ((attention, "segment_attention_bwd_plain"),
                      (dense, "ln_bwd_plain"),
                      (dense, "gelu_tanh_bwd_plain"),
                      (embed, "span_embed_bwd_plain")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=name, **k: (
            calls.append(_n), _r(*a, **k))[1])
    counters = ((attention, "launches"), (attention, "bwd_launches"),
                (embed, "launches"), (embed, "bwd_launches"),
                (dense, "ln_launches"), (dense, "gemm_launches"),
                (dense, "ln_bwd_launches"), (dense, "gelu_bwd_launches"))
    before = [getattr(m, c) for m, c in counters]
    model.module.zero_grad(set_to_none=True)
    model.loss_fn(*args).backward()
    torch.cuda.synchronize()
    after = [getattr(m, c) for m, c in counters]
    L_ = n_layers
    assert [a - b for a, b in zip(after, before)] == [
        L_, L_, 1, 1, 2 * L_ + 1, 4 * L_, 2 * L_ + 1, L_]
    assert calls == []
    grads = {n: p.grad.clone() for n, p in model.module.named_parameters()}
    monkeypatch.undo()
    model.module.zero_grad(set_to_none=True)
    model.loss_fn(*args, reference=True).backward()
    top = max(p.grad.abs().max().item() for p in model.module.parameters())
    for n, p in model.module.named_parameters():
        lim = TRAIN_GRAD_RTOL * p.grad.abs().max().item() + 1e-6 * top
        assert (grads[n] - p.grad).abs().max().item() <= lim, n
    model.module.eval()


def test_trainer_refuses_what_the_card_cannot_train(dev):
    from odigos_tpu_torch.training import TrainConfig, Trainer

    for model in ("transformer", "autoencoder"):
        with pytest.raises(ValueError, match="float32"):
            Trainer(TrainConfig(model=model,
                                model_kwargs={"dtype": torch.bfloat16}),
                    device=dev)
        with pytest.raises(ValueError, match="d_model"):
            Trainer(TrainConfig(model=model, model_kwargs={"d_model": 2048}),
                    device=dev)
        with pytest.raises(ValueError, match="K18"):
            Trainer(TrainConfig(model=model,
                                model_kwargs={"name_vocab": 60000}),
                    device=dev)


# ---------------------------------------------- the autoencoder's trainer
# K20 against its plain version, relative to the plain output's largest
# magnitude: the logits are f32 sums of d products in another order (the
# softmax inherits their rounding), dy sums up to 2569 products and dW /
# db up to the real positions' count, each in another order: 1e-4, K16's
# bound. K21 sums the same f32 terms in f64 and rounds once (K17's
# arithmetic): BWD_EXACT_RTOL. K11's log-sum-exps: LSE_ATOL.
RECON_BWD_RTOL = 1e-4


def _k20_inputs(dev, M, d, density, vocabs=(512, 2048, 8, 1)):
    x, w, b, heads, cat, cont, mask, wts = _recon_args(
        dev, M, d, "float32", vocabs, density)
    lse = torch.empty(M, 3, device=dev)
    krecon.recon_ce(x, w, b, heads, cat, cont, mask, wts,
                    route="cuda_core", lse=lse)
    g = torch.Generator(device=dev).manual_seed(d)
    derr = torch.rand(M, generator=g, device=dev) + 0.5
    return x, w, b, heads, lse, cat, cont, mask, derr, wts


@pytest.mark.parametrize("M,d,density", [(2048, 128, 0.3), (2048, 512, 0.3),
                                         (700, 1024, 0.6), (64, 96, 0.0)])
def test_k20_recon_ce_bwd_matches_plain(dev, M, d, density):
    args = _k20_inputs(dev, M, d, density)
    before = krecon.bwd_launches
    got = krecon.recon_ce_bwd(*args)
    assert krecon.bwd_launches == before + 1
    ref = krecon.recon_ce_bwd_plain(*args)
    mask = args[7]
    assert (got.dy[~mask] == 0).all()
    _close(got.dy, ref.dy, RECON_BWD_RTOL, "dy")
    for h, ((dw, db), (rw, rb)) in enumerate(zip(got.heads, ref.heads)):
        if density == 0.0:
            assert (dw == 0).all() and (db == 0).all()
            continue
        _close(dw, rw, RECON_BWD_RTOL, f"dW{h}")
        _close(db, rb, RECON_BWD_RTOL, f"db{h}")
    # deterministic: no atomics in any sum
    again = krecon.recon_ce_bwd(*args)
    assert torch.equal(again.dy, got.dy)
    assert all(torch.equal(a[0], b[0]) for a, b in zip(again.heads,
                                                       got.heads))


@pytest.mark.parametrize("d", [128, 512])
def test_k11_lse_matches_logsumexp_and_leaves_the_errors(dev, d):
    x, w, b, heads, cat, cont, mask, wts = _recon_args(dev, 4096, d,
                                                       "float32")
    lse = torch.full((4096, 3), float("nan"), device=dev)
    err = krecon.recon_ce(x, w, b, heads, cat, cont, mask, wts,
                          route="cuda_core", lse=lse)
    assert torch.equal(err, krecon.recon_ce(x, w, b, heads, cat, cont, mask,
                                            wts, route="cuda_core"))
    lse_p = torch.empty_like(lse)
    krecon.recon_ce_plain(x, w, b, heads, cat, cont, mask, wts, lse=lse_p)
    assert (lse - lse_p)[mask].abs().max().item() <= LSE_ATOL
    assert (lse[~mask] == 0).all()
    with pytest.raises(ValueError, match="lse"):
        krecon.recon_ce(x.bfloat16(), w, b, heads, cat, cont, mask, wts,
                        route="tc", lse=lse)


def _labels_past_heads(cat, mask, vocabs):
    """(bad, wrapped, past): ``cat`` with the labels -1, -V, V and V + 7
    at real positions of each categorical head and V + 3 at padding ones;
    the same labels wrapped as ``jnp.take_along_axis``'s fill mode wraps
    them (past ones left); and the (M, 3) flags of labels past a head."""
    bad = cat.clone()
    real = torch.nonzero(mask).flatten()
    pad = torch.nonzero(~mask).flatten()
    for h, V in enumerate(vocabs):
        pick = real[h::7][:48]
        bad[pick, h] = torch.tensor([-1, -V, V, V + 7], dtype=torch.int32,
                                    device=cat.device).repeat(12)[
                                        :pick.numel()]
        bad[pad[h::5][:8], h] = V + 3
    vs = torch.tensor(vocabs, dtype=torch.int32, device=cat.device)
    wrapped = bad.clone()
    wrapped[:, :3] = torch.where(bad[:, :3] < 0, bad[:, :3] + vs, bad[:, :3])
    past = (wrapped[:, :3] < 0) | (wrapped[:, :3] >= vs)
    return bad, wrapped, past


@pytest.mark.parametrize("dtype,route,d", [("bfloat16", "tc", 128),
                                           ("bfloat16", "tc", 96),
                                           ("float32", "cuda_core", 128),
                                           ("bfloat16", "cuda_core", 128),
                                           ("float32", "cuda_core", 1000)])
def test_k11_labels_past_their_heads_as_plain(dev, dtype, route, d):
    """Fault C5 on the card: both K11 kernels read a label as the
    reference's _ce does (jnp.take_along_axis, fill mode). A label in [-V,
    0) gives the bits of its wrapped label; one past its head makes that
    real position's error and score NaN, as the plain version does, and
    leaves every other position (and every log-sum-exp) bit-equal to a run
    on in-range labels; padding stays 0."""
    M = 5000
    x, w, b, heads, cat, cont, mask, wts = _recon_args(dev, M, d, dtype)
    vocabs = [h[0].shape[0] for h in heads[:3]]
    bad, wrapped, past = _labels_past_heads(cat, mask, vocabs)
    clean = torch.where(past, torch.zeros_like(wrapped[:, :3]),
                        wrapped[:, :3]).contiguous()
    smap = torch.randperm(M, device=dev).to(torch.int32)
    f32 = route == "cuda_core"
    outs = []
    for labels in (bad, clean):
        lse = torch.empty(M, 3, device=dev) if f32 else None
        e, sc = krecon.recon_ce(x, w, b, heads, labels, cont, mask, wts,
                                span_map=smap, n_out=M, route=route, lse=lse)
        outs.append((e, sc, lse))
    ref_e, ref_s = krecon.recon_ce_plain(x, w, b, heads, bad, cont, mask,
                                         wts, span_map=smap, n_out=M)
    torch.cuda.synchronize()
    (got_e, got_s, got_l), (cln_e, cln_s, cln_l) = outs
    nan_pos = mask & past.any(1)
    assert nan_pos.any() and (mask & ~past.any(1)).any()
    assert torch.equal(got_e.isnan(), nan_pos)
    assert torch.equal(ref_e.isnan(), nan_pos)
    assert torch.equal(got_e[~nan_pos], cln_e[~nan_pos])
    assert (got_e[~mask] == 0).all()
    assert (got_e - ref_e)[~nan_pos].abs().max().item() <= RECON_ATOL
    nan_idx = torch.zeros(M, dtype=torch.bool, device=dev)
    nan_idx[smap[nan_pos].long()] = True
    assert torch.equal(got_s.isnan(), nan_idx)
    assert torch.equal(got_s[~nan_idx], cln_s[~nan_idx])
    if f32:
        assert torch.isfinite(got_l).all() and torch.equal(got_l, cln_l)


@pytest.mark.parametrize("d", [128, 512])
def test_k20_labels_past_their_heads_as_plain(dev, d):
    """Fault C5 in K20: a wrapped label gives the bits of its wrapped
    value; where a head's label lies past it that head gets zero dlogit
    (its dW and db are exactly 0 when only such positions carry a
    gradient) and the other heads keep theirs, within RECON_BWD_RTOL of
    the plain version."""
    x, w, b, heads, lse, cat, cont, mask, derr, wts = _k20_inputs(
        dev, 2048, d, 0.3)
    vocabs = [h[0].shape[0] for h in heads[:3]]
    bad, wrapped, past = _labels_past_heads(cat, mask, vocabs)
    # the wrapped labels only: bit-equal to their in-range values
    only_wrap = torch.where(past, cat, bad[:, :3]).contiguous()
    pre = torch.where(past, cat, wrapped[:, :3]).contiguous()
    a = krecon.recon_ce_bwd(x, w, b, heads, lse, only_wrap, cont, mask,
                            derr, wts)
    r = krecon.recon_ce_bwd(x, w, b, heads, lse, pre, cont, mask, derr, wts)
    assert torch.equal(a.dy, r.dy)
    assert all(torch.equal(p[0], q[0]) and torch.equal(p[1], q[1])
               for p, q in zip(a.heads, r.heads))
    # every label: as plain
    got = krecon.recon_ce_bwd(x, w, b, heads, lse, bad, cont, mask, derr,
                              wts)
    ref = krecon.recon_ce_bwd_plain(x, w, b, heads, lse, bad, cont, mask,
                                    derr, wts)
    assert (got.dy[~mask] == 0).all() and torch.isfinite(got.dy).all()
    _close(got.dy, ref.dy, RECON_BWD_RTOL, "dy")
    for h, ((dw, db), (rw, rb)) in enumerate(zip(got.heads, ref.heads)):
        _close(dw, rw, RECON_BWD_RTOL, f"dW{h}")
        _close(db, rb, RECON_BWD_RTOL, f"db{h}")
    # a gradient only where the name label lies past its head (and no
    # other): the name head's rows are zero, the others are not
    only = mask & past[:, 1] & ~past[:, 0] & ~past[:, 2]
    assert only.any()
    d1 = torch.where(only, derr, torch.zeros_like(derr))
    got = krecon.recon_ce_bwd(x, w, b, heads, lse, bad, cont, mask, d1, wts)
    ref = krecon.recon_ce_bwd_plain(x, w, b, heads, lse, bad, cont, mask, d1,
                                    wts)
    torch.cuda.synchronize()
    assert (got.heads[1][0] == 0).all() and (got.heads[1][1] == 0).all()
    assert (ref.heads[1][0] == 0).all() and (ref.heads[1][1] == 0).all()
    for h in (0, 2, 3):
        assert got.heads[h][0].abs().max().item() > 0
        _close(got.heads[h][0], ref.heads[h][0], RECON_BWD_RTOL, f"dW{h}")
        _close(got.heads[h][1], ref.heads[h][1], RECON_BWD_RTOL, f"db{h}")


@pytest.mark.parametrize("T,L,d", [(64, 32, 128), (16, 64, 512),
                                   (5, 1024, 96)])
def test_k21_ln_masked_pool_bwd_matches_plain(dev, T, L, d):
    x, mask = _masked_rows(dev, T, L, d, "float32", 0.3, seed=T + d)
    g = torch.Generator(device=dev).manual_seed(d)
    w = 1 + 0.2 * torch.randn(d, generator=g, device=dev)
    dpool = torch.randn(T, d, generator=g, device=dev)
    before = kpool.bwd_launches
    got = kpool.ln_masked_pool_bwd(x, w, mask, dpool)
    assert kpool.bwd_launches == before + 1
    ref = kpool.ln_masked_pool_bwd_plain(x, w, mask, dpool)
    for a, r, what in zip(got, ref, ("dx", "dgamma", "dbeta")):
        _close(a, r, BWD_EXACT_RTOL, what)
    assert (got[0][~mask] == 0).all()


@pytest.mark.parametrize("T,L,d", [(64, 32, 128), (300, 17, 33),
                                   (5, 1024, 1024)])
def test_k21_one_launch_leaves_its_scratch_zeroed(dev, T, L, d):
    """K21's one launch: the launcher reports one kernel a call, the
    profiler sees that kernel and no other (no fill of dW or db), its
    cached ticket is zero after every call, and a second call on the same
    scratch gives the same bits."""
    x, mask = _masked_rows(dev, T, L, d, "float32", 0.3, seed=T + d)
    g = torch.Generator(device=dev).manual_seed(d)
    w = 1 + 0.2 * torch.randn(d, generator=g, device=dev)
    dpool = torch.randn(T, d, generator=g, device=dev)
    d0 = kpool.bwd_device_launches
    a = kpool.ln_masked_pool_bwd(x, w, mask, dpool)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        b = kpool.ln_masked_pool_bwd(x, w, mask, dpool)
        torch.cuda.synchronize()
    assert kpool.bwd_device_launches - d0 == 2
    names = [e.key for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert names and all("pool_bwd_kernel" in n for n in names), names
    assert all(torch.equal(p, q) for p, q in zip(a, b))
    cnt, _ = _scratch_of("ae_pool_bwd", dev)
    assert (cnt == 0).all()


@pytest.mark.parametrize("M,d,density", [(2048, 128, 0.3), (700, 1024, 0.6),
                                         (64, 96, 0.0)])
def test_k20_two_launches_leave_their_scratch_zeroed(dev, M, d, density):
    """K20's two launches: the launcher reports two kernels a call, the
    profiler sees the prep and main kernels and no other (no fill of dy),
    its cached counters are zero after every call, and a second call on the
    same scratch gives the same bits."""
    args = _k20_inputs(dev, M, d, density)
    d0 = krecon.bwd_device_launches
    a = krecon.recon_ce_bwd(*args)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        b = krecon.recon_ce_bwd(*args)
        torch.cuda.synchronize()
    assert krecon.bwd_device_launches - d0 == 4
    names = sorted(e.key for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    assert len(names) == 2 and "recon_bwd_main_kernel" in names[0] \
        and "recon_bwd_prep_kernel" in names[1], names
    assert torch.equal(a.dy, b.dy) and all(
        torch.equal(p[0], q[0]) and torch.equal(p[1], q[1])
        for p, q in zip(a.heads, b.heads))
    cnt, _ = _scratch_of("recon_ce_bwd", dev)
    assert (cnt == 0).all()


def test_autoencoder_training_step_on_the_card(dev, monkeypatch):
    """One step of the autoencoder's trainer at its full default width:
    every kernel launches its count, no plain version of a backward kernel
    is called, and the gradients equal the same step through the plain
    versions on the card within TRAIN_GRAD_RTOL of each parameter's
    largest gradient (+ 1e-6 of the largest of all)."""
    from odigos_tpu_torch.kernels import dense
    from odigos_tpu_torch.models.jax_init import autoencoder_state
    from odigos_tpu_torch.training import labeled_sequences

    cfg = AutoencoderConfig(max_len=32, dtype=torch.float32)
    model = SpanAutoencoder(cfg, device=dev)
    model.load_state_dict(autoencoder_state(cfg, 0))
    d = labeled_sequences(63, fault_fraction=0.0, max_len=32, seed=0,
                          pad_traces_to=64)
    args = (d.categorical, d.continuous, d.mask)
    model.module.train()
    calls = []
    for mod, name in ((attention, "segment_attention_bwd_plain"),
                      (dense, "ln_bwd_plain"),
                      (dense, "gelu_tanh_bwd_plain"),
                      (embed, "span_embed_bwd_plain"),
                      (kpool, "ln_masked_pool_bwd_plain"),
                      (krecon, "recon_ce_bwd_plain")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=name, **k: (
            calls.append(_n), _r(*a, **k))[1])
    counters = ((attention, "launches"), (attention, "bwd_launches"),
                (embed, "launches"), (embed, "bwd_launches"),
                (dense, "ln_launches"), (dense, "gemm_launches"),
                (dense, "ln_bwd_launches"), (dense, "gelu_bwd_launches"),
                (kpool, "launches"), (kpool, "bwd_launches"),
                (krecon, "launches"), (krecon, "bwd_launches"))
    before = [getattr(m, c) for m, c in counters]
    model.module.zero_grad(set_to_none=True)
    model.loss_fn(*args).backward()
    torch.cuda.synchronize()
    after = [getattr(m, c) for m, c in counters]
    nl = cfg.n_layers
    assert [a - b for a, b in zip(after, before)] == [
        nl, nl, 1, 1, 2 * nl, 4 * nl + 2, 2 * nl + 1, nl + 1, 1, 1, 1, 1]
    assert calls == []
    grads = {n: p.grad.clone() for n, p in model.module.named_parameters()}
    monkeypatch.undo()
    model.module.zero_grad(set_to_none=True)
    model.loss_fn(*args, reference=True).backward()
    top = max(p.grad.abs().max().item() for p in model.module.parameters())
    for n, p in model.module.named_parameters():
        lim = TRAIN_GRAD_RTOL * p.grad.abs().max().item() + 1e-6 * top
        assert (grads[n] - p.grad).abs().max().item() <= lim, n
    model.module.eval()


# ------------------------------------------------ K22 ring_block_attention
from odigos_tpu_torch.kernels import ring as kring  # noqa: E402

RING_RTOL = 1e-5  # of the plain version's largest magnitude: f32 sums in
                  # another order (64-key tiles vs the block's max first)


def _ring_block_inputs(B, Lq, Lk, H, D, q_dtype, dev, seed=0, masked=()):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((B, Lq, H, D), generator=g).to(q_dtype)
    k = torch.randn((B, Lk, H, D), generator=g) * 2
    v = torch.randn((B, Lk, H, D), generator=g)
    mask = torch.rand((B, Lk), generator=g) > 0.2
    for b in masked:
        mask[b] = False
    return [t.to(dev) for t in (q, k, v, mask)]


def _ring_state(B, Lq, H, D, dev):
    return (torch.zeros((B, Lq, H, D), device=dev),
            torch.full((B, H, Lq), kring.NEG_INF, device=dev),
            torch.zeros((B, H, Lq), device=dev))


def _rel(got, ref):
    return (got - ref).abs().max().item() / max(ref.abs().max().item(),
                                                1e-30)


@pytest.mark.parametrize("D", [8, 16, 64, 128, 256])
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Lq,Lk", [(100, 37), (64, 200), (130, 130)])
def test_k22_ring_block_matches_plain(dev, D, q_dtype, Lq, Lk):
    B, H = 2, 3
    blocks = [_ring_block_inputs(B, Lq, Lk, H, D, q_dtype, dev, seed=s,
                                 masked=(1,) if s == 1 else ())
              for s in range(3)]
    got, ref = _ring_state(B, Lq, H, D, dev), _ring_state(B, Lq, H, D, dev)
    launched = kring.launches
    for i, (q, k, v, mask) in enumerate(blocks):
        q = blocks[0][0]
        kring.ring_block_attention(q, k, v, mask, *got, finalize=i == 2)
        kring.ring_block_attention_plain(q, k, v, mask, *ref,
                                         finalize=i == 2)
    torch.cuda.synchronize()
    assert kring.launches == launched + 3
    for g, r in zip(got, ref):
        assert torch.isfinite(g).all()
        assert _rel(g, r) <= RING_RTOL


@pytest.mark.parametrize("D", [4, 8, 60, 64, 128, 256])
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("finalize", [False, True])
def test_k22_head_dims_masked_block_and_second_call(dev, D, q_dtype,
                                                    finalize):
    """Three blocks of Lk 200 (not a multiple of a key tile), the first all
    masked, trace 1 masked in the last, merged with and without the final
    division: within the plain bound, and a second run bit-equal."""
    B, Lq, Lk, H = 2, 130, 200, 3
    blocks = [_ring_block_inputs(B, Lq, Lk, H, D, q_dtype, dev, seed=s,
                                 masked=(1,) if s == 2 else ())
              for s in range(3)]
    blocks[0][3] = torch.zeros_like(blocks[0][3])
    q = blocks[0][0]
    runs = []
    for _ in range(2):
        st = _ring_state(B, Lq, H, D, dev)
        for i, (_, k, v, mask) in enumerate(blocks):
            kring.ring_block_attention(q, k, v, mask, *st,
                                       finalize=finalize and i == 2)
        runs.append(st)
    ref = _ring_state(B, Lq, H, D, dev)
    for i, (_, k, v, mask) in enumerate(blocks):
        kring.ring_block_attention_plain(q, k, v, mask, *ref,
                                         finalize=finalize and i == 2)
    torch.cuda.synchronize()
    for g, r in zip(runs[0], ref):
        assert torch.isfinite(g).all()
        assert _rel(g, r) <= RING_RTOL
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("where", ["first", "last"])
def test_k22_fully_masked_block_first_or_last(dev, where):
    B, L, H, D = 2, 256, 4, 64
    n = 4
    blocks = [_ring_block_inputs(B, L, L, H, D, torch.float32, dev, seed=s)
              for s in range(n)]
    dead = 0 if where == "first" else n - 1
    blocks[dead][3] = torch.zeros_like(blocks[dead][3])
    # and a trace whose every key is masked: its output is 0, not NaN
    for blk in blocks:
        blk[3][1] = False
    q = blocks[0][0]
    got, ref = _ring_state(B, L, H, D, dev), _ring_state(B, L, H, D, dev)
    for i, (_, k, v, mask) in enumerate(blocks):
        kring.ring_block_attention(q, k, v, mask, *got, finalize=i == n - 1)
        kring.ring_block_attention_plain(q, k, v, mask, *ref,
                                         finalize=i == n - 1)
    torch.cuda.synchronize()
    assert torch.isfinite(got[0]).all() and (got[0][1] == 0).all()
    assert _rel(got[0], ref[0]) <= RING_RTOL


def test_k22_second_call_is_bit_equal(dev):
    q, k, v, mask = _ring_block_inputs(2, 300, 500, 4, 64, torch.float32,
                                       dev)
    outs = []
    for _ in range(2):
        st = _ring_state(2, 300, 4, 64, dev)
        kring.ring_block_attention(q, k, v, mask, *st, finalize=True)
        outs.append(st)
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_k22_refusals(dev):
    q, k, v, mask = _ring_block_inputs(1, 8, 8, 2, 8, torch.float32, dev)
    st = _ring_state(1, 8, 2, 8, dev)
    with pytest.raises(TypeError):
        kring.ring_block_attention(q, k.bfloat16(), v, mask, *st)
    with pytest.raises(ValueError, match="contiguous"):
        qt = q.transpose(2, 3).contiguous().transpose(2, 3)
        kring.ring_block_attention(qt, k, v, mask, *st)
    big = _ring_block_inputs(1, 8, 8, 1, 264, torch.float32, dev)
    with pytest.raises(ValueError, match="head dim"):
        kring.ring_block_attention(*big, *_ring_state(1, 8, 1, 264, dev))


def test_ring_attention_on_a_world_of_one(dev):
    """``ring_attention`` on an NCCL ``{"seq": 1}`` mesh launches K22 once,
    and the in-process ring of 4 blocks matches ``reference_attention``."""
    import torch.distributed as dist

    from odigos_tpu_torch.parallel import (LocalRotation, make_mesh,
                                           reference_attention,
                                           ring_attention, ring_body)

    q, k, v, mask = _ring_block_inputs(2, 512, 512, 4, 64, torch.float32,
                                       dev)
    ref = reference_attention(q, k, v, mask)
    mesh = make_mesh({"seq": 1}, axes=("seq",))
    try:
        launched = kring.launches
        out = ring_attention(q, k, v, mask, mesh)
        torch.cuda.synchronize()
        assert kring.launches == launched + 1
        assert _rel(out, ref) <= RING_RTOL
    finally:
        dist.destroy_process_group()
    n, Lb = 4, 128
    blocks = [(k[:, i * Lb:(i + 1) * Lb].contiguous(),
               v[:, i * Lb:(i + 1) * Lb].contiguous(),
               mask[:, i * Lb:(i + 1) * Lb].to(torch.uint8).contiguous())
              for i in range(n)]
    out = torch.cat([ring_body(q[:, j * Lb:(j + 1) * Lb], *blocks[j], n,
                               LocalRotation(blocks, j))
                     for j in range(n)], dim=1)
    torch.cuda.synchronize()
    assert _rel(out, ref) <= RING_RTOL


# --------------------------- K15's and K1's f32 routes, ids past a table
@pytest.mark.parametrize("N,K,epilogue", [(128, 128, "residual"),
                                          (256, 1024, "residual"),
                                          (384, 128, "none"),
                                          (768, 256, "none"),
                                          (1024, 256, "gelu_tanh")])
def test_k15_f32_tiles_give_the_same_bits(dev, N, K, epilogue):
    """K15's f32 route keeps each output's one fmaf chain over k whatever
    its tile: the first 64 rows alone (a small grid: the smallest tile)
    and inside 2048 and 8192 rows (larger tiles) give the same bits, with
    the pre-activation; within f32 summation noise of the plain
    version."""
    g = torch.Generator(device=dev).manual_seed(N + K)
    x = torch.randn(8192, K, generator=g, device=dev)
    w = torch.randn(N, K, generator=g, device=dev) / K ** 0.5
    b = torch.randn(N, generator=g, device=dev) * 0.1
    res = torch.randn(8192, N, generator=g, device=dev)
    gelu = epilogue == "gelu_tanh"
    got, tiles = [], set()
    for M in (64, 2048, 8192):
        pre = torch.empty(M, N, device=dev) if gelu else None
        y = kdense.gemm_bf16(x[:M], w, b, epilogue,
                             res[:M] if epilogue == "residual" else None,
                             pre=pre)
        got.append((y[:64], None if pre is None else pre[:64]))
        tiles.add(kdense.f32_tile(M, N))
    torch.cuda.synchronize()
    assert len(tiles) >= 2
    for y, pre in got[1:]:
        assert torch.equal(y, got[0][0])
        assert pre is None or torch.equal(pre, got[0][1])
    ref = kdense.gemm_bf16_plain(x[:64], w, b, epilogue,
                                 res[:64] if epilogue == "residual"
                                 else None)
    assert (got[0][0] - ref).abs().max().item() <= \
        F32_ATOL * ref.abs().max().item()


def test_k15_f32_refuses_a_misaligned_pre(dev):
    x = torch.randn(64, 32, device=dev)
    w = torch.randn(64, 32, device=dev)
    b = torch.zeros(64, device=dev)
    pre = torch.empty(64 * 64 + 1, device=dev)[1:].view(64, 64)
    with pytest.raises(ValueError, match="pre"):
        kdense.gemm_bf16(x, w, b, "gelu_tanh", pre=pre)


@pytest.mark.parametrize("R,L,H,hd", [(64, 32, 4, 64), (64, 32, 2, 64),
                                      (32, 64, 4, 64), (8, 33, 3, 60)])
def test_k1_f32_staging_paths_give_the_same_bits(dev, R, L, H, hd):
    """K1's CUDA-core route stages 16-byte vectors from aligned tensors
    and one value a thread from misaligned ones: the same output and
    log-sum-exp bits either way; within f32 summation noise of the plain
    version, its log-sum-exp within 1e-5 on live queries."""
    g = torch.Generator(device=dev).manual_seed(R * L + hd)
    n = R * L * H * hd
    raw = [torch.randn(n + 1, generator=g, device=dev) for _ in range(3)]
    qm, km, vm = (t[1:].view(R, L, H, hd) for t in raw)  # 4 bytes off 16
    q, k, v = (t.clone() for t in (qm, km, vm))          # aligned copies
    batch = synthesize_traces(4 * R, seed=R)
    pk = pack_sequences(batch, featurize(batch), max_len=L,
                        pad_rows_to=lambda r: max(r, R))
    seg = torch.from_numpy(pk.segments[:R]).to(dev).contiguous()
    assert attention.kernel_route(q, k, v, seg) == "simt"
    lse_a, lse_m = (torch.empty(R, H, L, device=dev) for _ in range(2))
    out_a = segment_attention(q, k, v, seg, lse_a)
    out_m = segment_attention(qm, km, vm, seg, lse_m)
    lse_p = torch.empty(R, H, L, device=dev)
    ref = segment_attention_plain(q, k, v, seg, lse_p)
    torch.cuda.synchronize()
    assert torch.equal(out_a, out_m) and torch.equal(lse_a, lse_m)
    assert (out_a - ref).abs().max().item() <= F32_ATOL * max(
        1.0, ref.abs().max().item())
    live = (seg > 0)[:, None, :].expand(R, H, L)
    assert (lse_a - lse_p)[live].abs().max().item() <= 1e-5


def test_k1_f32_score_blocks_give_the_same_bits(dev):
    """Rows of L 32 (2 x 2 score blocks a thread) and the same rows padded
    to L 40 with padding slots (4 x 4): the live queries' outputs and
    log-sum-exps bit-equal (the padding keys weigh exactly 0)."""
    R, H, hd = 16, 4, 64
    g = torch.Generator(device=dev).manual_seed(40)
    q, k, v = (torch.randn(R, 40, H, hd, generator=g, device=dev)
               for _ in range(3))
    batch = synthesize_traces(60, seed=40)
    pk = pack_sequences(batch, featurize(batch), max_len=32,
                        pad_rows_to=lambda r: max(r, R))
    seg32 = torch.from_numpy(pk.segments[:R]).to(dev).contiguous()
    seg40 = torch.zeros(R, 40, dtype=torch.int32, device=dev)
    seg40[:, :32] = seg32
    outs = []
    for L, seg in ((32, seg32), (40, seg40)):
        lse = torch.empty(R, H, L, device=dev)
        o = segment_attention(*(t[:, :L].contiguous() for t in (q, k, v)),
                              seg, lse)
        outs.append((o[:, :32], lse[..., :32]))
    torch.cuda.synchronize()
    live = seg32 > 0
    assert torch.equal(outs[0][0][live], outs[1][0][live])
    lv = live[:, None, :].expand(R, H, 32)
    assert torch.equal(outs[0][1][lv], outs[1][1][lv])


@pytest.mark.parametrize("d", [256, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_span_embed_ids_past_their_tables_as_plain(dev, d, dtype):
    """K2 (the sliced path at d 256, the scalar one at d 128) and K18 on
    ids past every table and below zero, as ``nn.Embed``'s fill mode
    takes them: K2's NaN slots those of the plain version and the rest
    bit-equal; K18's tables bit-equal (gradients of ids past a table
    dropped, negative ids wrapped)."""
    g = torch.Generator().manual_seed(d)
    R, L, C = 64, 32, embed.N_BASE_FIELDS + 2

    def tab(rows, cols=d):
        return torch.randn(rows, cols, generator=g).to(dev)

    tables = EmbedTables(service=tab(512), name=tab(2048), kind=tab(8),
                         status=tab(4), attr=tab(30), cont_w=tab(d, 3),
                         cont_b=tab(1)[0].contiguous(), pos=tab(L))
    cat = torch.stack([torch.randint(-n - 5, n + 40, (R, L), generator=g)
                       for n in (512, 2048, 8, 4, 512, 30, 30)],
                      -1).to(torch.int32)
    seg = torch.randint(0, 4, (R, L), generator=g, dtype=torch.int32)
    pos = torch.arange(L, dtype=torch.int32).expand(R, L).contiguous()
    cont = torch.randn(R, L, 3, generator=g)
    dy = torch.randn(R, L, d, generator=g)
    cat, seg, pos, cont, dy = (t.to(dev) for t in (cat, seg, pos, cont, dy))
    dt = getattr(torch, dtype)
    got = span_embed(cat, cont, pos, seg, tables, dt)
    ref = span_embed_plain(cat, cont, pos, seg, tables, dt)
    gb = embed.span_embed_bwd(dy, cat, pos, seg, tables)
    rb = embed.span_embed_bwd_plain(dy, cat, pos, seg, tables)
    torch.cuda.synchronize()
    nan = torch.isnan(ref.float())
    assert nan.any() and (~nan.any(-1) & (seg > 0)).any()
    assert torch.equal(torch.isnan(got.float()), nan)
    assert torch.equal(got[~nan], ref[~nan])
    for name in ("service", "name", "kind", "status", "attr", "pos"):
        assert torch.equal(getattr(gb, name), getattr(rb, name)), name


# --------------------------------------------- the engine's failover on card

def _score_all(eng, batches):
    out = []
    for b in batches:
        s = eng.score_sync(b, timeout_s=120)
        out.append(s)
    return out


def test_gpu_engine_fails_over_to_the_cpu_zscore_and_recovers(dev):
    """The transformer on the card (2 layers, bf16) behind an armed
    breaker: healthy it scores bit-equal to an engine without one and
    launches K1, K2, K14 and K15; under ``inject_device_fault`` the breaker
    opens within ``trip_errors`` failed groups and the CPU zscore fallback
    scores like a zscore engine on the CPU fed the same stream; cleared,
    probes close it and the card scores the same bits again."""
    fo = {"trip_errors": 2, "probe_interval_s": 0.2,
          "recovery_successes": 2, "window_s": 60.0}
    cfg = dict(model="transformer", model_config=TransformerConfig(
        n_layers=2), trace_bucket=16, warm_ladder=True)
    eng = ScoringEngine(EngineConfig(device="cuda", failover=fo, **cfg))
    plain = ScoringEngine(EngineConfig(device="cuda", **cfg))
    plain.backend.model.load_state_dict(eng.backend.model.state_dict())
    replay = ScoringEngine(EngineConfig(model="zscore", device="cpu"))
    warm = synthesize_traces(200, seed=7)
    eng.warmup(warm)
    replay.warmup(warm)
    batches = [synthesize_traces(40 + 9 * i, seed=60 + i) for i in range(3)]
    sup = eng.failover
    eng.start()
    plain.start()
    try:
        counts0 = (attention.launches, embed.launches, kdense.ln_launches,
                   kdense.gemm_launches)
        before = _score_all(eng, batches)
        counts1 = (attention.launches, embed.launches, kdense.ln_launches,
                   kdense.gemm_launches)
        assert all(b > a for a, b in zip(counts0, counts1)), counts1
        for got, want in zip(before, _score_all(plain, batches)):
            assert got is not None
            np.testing.assert_array_equal(got, want)
        assert sup.state == "closed" and sup.trips == 0

        eng.inject_device_fault()
        failed = 0
        while not sup.active:
            assert eng.score_sync(synthesize_traces(10, seed=90 + failed),
                                  timeout_s=120) is None
            failed += 1
            assert failed <= fo["trip_errors"]
        fallback = []
        for i in range(4):
            b = synthesize_traces(12, seed=100 + i)
            spans0 = sup.fallback_spans
            s = eng.score_sync(b, timeout_s=120)
            if sup.fallback_spans - spans0 == len(b):
                fallback.append((b, s))
        assert fallback and sup.fallback_spans == sum(
            len(b) for b, _ in fallback)
        for b, s in fallback:
            want = replay.backend.score(b, featurize(b))
            np.testing.assert_allclose(s, want, rtol=0, atol=1e-5)

        eng.clear_device_fault()
        k = 0
        while sup.active:
            assert k < 3000, "the breaker never closed"
            b = synthesize_traces(8, seed=200 + k)
            spans0 = sup.fallback_spans
            s = eng.score_sync(b, timeout_s=120)
            if sup.fallback_spans - spans0 == len(b):
                np.testing.assert_allclose(
                    s, replay.backend.score(b, featurize(b)), rtol=0,
                    atol=1e-5)
            k += 1
        assert sup.recoveries == 1
        for got, want in zip(_score_all(eng, batches), before):
            np.testing.assert_array_equal(got, want)
    finally:
        eng.shutdown()
        plain.shutdown()


# ------------------------------------ the autoencoder on the model axis
# K11 "slice" writes each real position's record (the slice's log-sum-exps
# and label logits, the kind CE, duration - target, the kind LSE); K24
# merges the shards' records (kernels/recon.py). Records: within
# RECON_ATOL of the plain version's (another summation order); K24: bit
# for bit (the same IEEE steps, expf/logf as torch's on the card); at tp 1
# K11 "slice" + K24 is K11 bit for bit on both routes.
def _slice_heads(heads, tp, r):
    """Rank r's heads and slice: the service and name heads' rows where tp
    divides them."""
    out, lo = [], []
    for h, (w, b) in enumerate(heads):
        V = w.shape[0]
        if h < 2 and V % tp == 0:
            n = V // tp
            out.append((w[r * n:(r + 1) * n].contiguous(),
                        b[r * n:(r + 1) * n].contiguous()))
            lo.append(r * n)
        else:
            out.append((w, b))
            lo.append(0)
    vf = (heads[0][0].shape[0], heads[1][0].shape[0])
    return out, krecon.VocabSlice(vf, tuple(lo[:2]))


def _labels_past_every_slice(cat, mask, vocabs):
    cat = cat.clone()
    cat[::9, 0] = -vocabs[0] + 3  # wrapped from [-V, 0)
    cat[1::11, 1] = vocabs[1] + 4  # past every slice: NaN (C5)
    past = torch.zeros_like(mask)
    past[1::11] = True
    return cat, past & mask


@pytest.mark.parametrize("dtype,route", [("bfloat16", "tc"),
                                         ("float32", "cuda_core")])
@pytest.mark.parametrize("tp", [1, 2, 4])
@pytest.mark.parametrize("d,M", [(128, 32768), (96, 4096)])
@pytest.mark.parametrize("vocabs", [(512, 2048, 8, 1), (96, 200, 8, 1)],
                         ids=["served", "ragged"])
def test_k11_slice_and_k24_match_plain_and_k11(dev, dtype, route, tp, d, M,
                                               vocabs):
    # "ragged": slices of 48 / 24 and 100 / 50 rows, which K11's planes pad
    # to whole PLANE_PAD rows as they pad a whole head
    x, w, b, heads, cat, cont, mask, wts = _recon_args(dev, M, d, dtype,
                                                       vocabs, 0.2)
    cat, past = _labels_past_every_slice(cat, mask, vocabs)
    recs, recs_p = [], []
    s0 = krecon.slice_launches
    for r in range(tp):
        hs, vsl = _slice_heads(heads, tp, r)
        planes = krecon.head_planes(hs) if route == "tc" else None
        recs.append(krecon.recon_ce_slice(x, w, b, hs, cat, cont, mask, vsl,
                                          planes=planes, route=route))
        recs_p.append(krecon.recon_ce_slice_plain(x, w, b, hs, cat, cont,
                                                  mask, vsl))
    assert krecon.slice_launches == s0 + tp
    rec, rec_p = torch.stack(recs), torch.stack(recs_p)
    torch.cuda.synchronize()
    m = mask
    cols = [0, 2, 4, 5] + ([6] if route == "cuda_core" else [])
    diff = (rec[:, m][..., cols] - rec_p[:, m][..., cols]).abs()
    assert diff.max().item() <= RECON_ATOL
    zl, zl_p = rec[:, m][..., [1, 3]], rec_p[:, m][..., [1, 3]]
    assert torch.equal(zl.isnan(), zl_p.isnan())
    assert (zl - zl_p).nan_to_num().abs().max().item() <= RECON_ATOL
    vs = tuple(h[0].shape[0] for h in _slice_heads(heads, tp, 0)[0][:2])
    m0 = krecon.merge_launches
    err = krecon.vocab_ce_merge(rec, cat, mask, vocabs[:2], vs, wts)
    assert krecon.merge_launches == m0 + 1
    err_p = krecon.vocab_ce_merge_plain(rec, cat, mask, vocabs[:2], vs, wts)
    assert torch.equal(err.isnan(), past) and torch.equal(err_p.isnan(), past)
    assert torch.equal(err.nan_to_num(), err_p.nan_to_num())  # K24: bits
    ref = krecon.recon_ce_plain(x, w, b, heads, cat, cont, mask, wts)
    assert (err - ref)[~past].abs().max().item() <= RECON_ATOL
    if tp == 1:  # K11 "slice" + K24 is K11
        k11 = krecon.recon_ce(x, w, b, heads, cat, cont, mask, wts,
                              route=route, planes=krecon.head_planes(heads)
                              if route == "tc" else None)
        assert torch.equal(err.nan_to_num(), k11.nan_to_num())
        assert torch.equal(err.isnan(), k11.isnan())


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_k24_merged_lse_is_its_plain_version_s(dev, tp):
    M = 50000
    g = torch.Generator(device=dev).manual_seed(tp)
    rec = torch.randn(tp, M, 8, generator=g, device=dev) * 5
    mask = torch.rand(M, generator=g, device=dev) < 0.4
    cat = torch.stack([torch.randint(-512, 520, (M,), generator=g,
                                     device=dev),
                       torch.randint(0, 2048, (M,), generator=g, device=dev),
                       torch.zeros(M, dtype=torch.int64, device=dev)],
                      1).to(torch.int32)
    vs = (512 // tp, 2048)  # the name head whole on every shard
    lse = torch.full((M, 3), float("nan"), device=dev)
    lse_p = torch.zeros(M, 3, device=dev)
    err = krecon.vocab_ce_merge(rec, cat, mask, (512, 2048), vs,
                                (1.0, 1.0, 0.5, 1.0), lse=lse)
    err_p = krecon.vocab_ce_merge_plain(rec, cat, mask, (512, 2048), vs,
                                        (1.0, 1.0, 0.5, 1.0), lse=lse_p)
    torch.cuda.synchronize()
    assert torch.equal(err.isnan(), err_p.isnan())
    assert torch.equal(err.nan_to_num(), err_p.nan_to_num())
    assert torch.equal(lse, lse_p)
    assert (err[~mask] == 0).all() and (lse[~mask] == 0).all()


@pytest.mark.parametrize("tp", [1, 2])
@pytest.mark.parametrize("M,d", [(2048, 128), (700, 256)])
def test_k20_slice_matches_plain_and_is_k20_at_tp1(dev, tp, M, d):
    vocabs = (512, 2048, 8, 1)
    x, w, b, heads, lse, cat, cont, mask, derr, wts = _k20_inputs(
        dev, M, d, 0.3, vocabs)
    cat, past = _labels_past_every_slice(cat, mask, vocabs)
    derr[past] = 0.0
    s0, b0 = krecon.bwd_slice_launches, krecon.bwd_launches
    for r in range(tp):
        hs, vsl = _slice_heads(heads, tp, r)
        dyh = 15 if r == 0 else 3
        got = krecon.recon_ce_bwd(x, w, b, hs, lse, cat, cont, mask, derr,
                                  wts, vslice=vsl, dy_heads=dyh)
        ref = krecon.recon_ce_bwd_plain(x, w, b, hs, lse, cat, cont, mask,
                                        derr, wts, vslice=vsl, dy_heads=dyh)
        _close(got.dy, ref.dy, RECON_BWD_RTOL, f"dy r{r}")
        for h, ((dw, db), (rw, rb)) in enumerate(zip(got.heads, ref.heads)):
            _close(dw, rw, RECON_BWD_RTOL, f"dW{h} r{r}")
            _close(db, rb, RECON_BWD_RTOL, f"db{h} r{r}")
        if tp == 1:  # the slice mode of the whole heads is K20's bits
            k20 = krecon.recon_ce_bwd(x, w, b, heads, lse, cat, cont, mask,
                                      derr, wts)
            assert torch.equal(got.dy, k20.dy)
            assert all(torch.equal(a, c) for p, q in zip(got.heads,
                                                         k20.heads)
                       for a, c in zip(p, q))
    # the slice mode's instantiation runs where the heads are a slice; the
    # whole heads (tp 1) take the unsliced kernel
    assert krecon.bwd_slice_launches == s0 + (tp if tp > 1 else 0)
    assert krecon.bwd_launches == b0 + tp + (tp == 1)

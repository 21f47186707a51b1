"""The port's span autoencoder against the JAX package's, on the CPU.

Inputs come from ``synthesize_traces`` (the same seed in both packages
gives the same batch) and from numpy; weights come from the JAX model's
``init`` and cross through ``flax_autoencoder_to_torch``. Every kernel
wrapper takes its plain version on CPU tensors.

Bounds:

* ``assemble_sequences`` and K13's plain version against the reference's
  ``assemble_sequences`` and ``_build_pack_spans``: exact;
* f32 ``score_spans`` (span errors and the per-trace mean) at atol = rtol
  = 1e-5: the same f32 arithmetic in another summation order (measured
  <= 4.4e-7 relative on the errors, three seeds);
* bf16: squashed scores within ``BF16_ATOL`` (2e-2; measured <= 3e-11,
  the squash saturates, see below) and span errors within
  ``BF16_ERR_RTOL`` relative (1e-2; measured <= 7.2e-3 at SMALL, the
  worst of three seeds). The two round at different places: Flax rounds
  every embedding partial sum, the attention scores and softmax to bf16,
  the port keeps them in f32 and rounds once per kernel output;
* K12's and K11's plain versions against the reference's pool and
  ``_errors`` on the same input: 1e-5 in f32; in bf16 K12 within one bf16
  step of the pooled value and K11 within ``BF16_ERR_RTOL`` (measured
  2.2e-7: Flax's LayerNorm takes the variance as E[x^2] - E[x]^2, the
  port two-pass, so a bf16-rounded LN output can land one step apart);
* the engine's host and fused routes against the JAX engine's: 1e-5 (f32
  model); the fused route against the port's own host route at the
  reference's ``FUSED_RTOL``/``FUSED_ATOL``.

With random weights the reconstruction errors are large (the duration
head's squared error alone is ~50 on log-durations of 5-12, each
cross-entropy ~log of its vocabulary), so ``1 - exp(-err)`` rounds to ~1
for every span and a comparison of squashed scores would say nothing. The
engine tests therefore scale the four loss weights down (``WEIGHTS``: a
config field both packages take), which puts the scores across (0, 1).
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from odigos_tpu.features.featurizer import FeaturizerConfig as JaxFeatConfig
from odigos_tpu.features.featurizer import assemble_sequences as jassemble
from odigos_tpu.features.featurizer import featurize as jfeaturize
from odigos_tpu.features.featurizer import featurize_columns_jax
from odigos_tpu.models.autoencoder import AutoencoderConfig as JaxConfig
from odigos_tpu.models.autoencoder import SpanAutoencoder as JaxAutoencoder
from odigos_tpu.models.autoencoder import _ce
from odigos_tpu.pdata import synthesize_traces as jsynth
from odigos_tpu.serving.engine import EngineConfig as JaxEngineConfig
from odigos_tpu.serving.engine import ScoringEngine as JaxEngine
from odigos_tpu.serving.fused import _build_pack_spans
from odigos_tpu.serving.fused import extract_columns as jax_extract
from odigos_tpu.serving.sidecar import SidecarClient as JaxClient
from odigos_tpu_torch.features import (FeaturizerConfig, SpanFeatures,
                                       assemble_sequences, featurize)
from odigos_tpu_torch.kernels import pack as kpack
from odigos_tpu_torch.kernels import pool as kpool
from odigos_tpu_torch.kernels import recon as krecon
from odigos_tpu_torch.kernels import sort as ksort
from odigos_tpu_torch.kernels.quant import layer_norm_plain
from odigos_tpu_torch.models import (AutoencoderConfig, SpanAutoencoder,
                                     flax_autoencoder_to_torch)
from odigos_tpu_torch.pdata import concat_batches
from odigos_tpu_torch.pdata import synthesize_traces as psynth
from odigos_tpu_torch.serving import (BucketLadder, EngineConfig,
                                      ScoringEngine, SidecarClient,
                                      SidecarServer)
from odigos_tpu_torch.serving.fused import _span_bucket, extract_columns
from odigos_tpu_torch.serving.sidecar import build_parser

torch.set_num_threads(1)

F32_TOL = 1e-5
BF16_ATOL = 2e-2
BF16_ERR_RTOL = 1e-2
RECON_ATOL = 1e-4   # K11 on the card vs its plain version (chip_smoke.py)
FUSED_RTOL = 2e-5   # tests/test_fused.py: the reference's own bound
FUSED_ATOL = 1e-6
SEEDS = (0, 1, 2)
SMALL = dict(d_model=64, d_latent=32, n_heads=2, n_layers=2, d_ff=128,
             max_len=16)
# tests/test_fused.py's TINY_AE (d 32, 2 heads, 1 layer, d_ff 64, L 16,
# vocabs 64/64), with the featurizer's vocabularies matched to it (the
# reference gathers NaN past a table) and the loss weights scaled down
TINY = dict(d_model=32, n_heads=2, n_layers=1, d_ff=64, max_len=16,
            service_vocab=64, name_vocab=64)
VOCAB = dict(service_vocab=64, name_vocab=64)
WEIGHTS = dict(w_service=0.01, w_name=0.01, w_kind=0.005, w_duration=0.002)
HIGH = np.uint64(1 << 63)


def _pair(geometry: dict, f32: bool, seed: int = 0, **extra):
    jcfg = JaxConfig(**geometry, **extra,
                     dtype=jnp.float32 if f32 else jnp.bfloat16)
    jm = JaxAutoencoder(jcfg)
    variables = jm.init(jax.random.PRNGKey(seed))
    pm = SpanAutoencoder(AutoencoderConfig(
        **geometry, **extra, dtype=torch.float32 if f32 else torch.bfloat16),
        device="cpu")
    pm.load_state_dict(flax_autoencoder_to_torch(
        jax.tree_util.tree_map(np.asarray, variables), pm.cfg))
    return jm, variables, pm


def _mutate(batch, kind: str):
    """The same change to a JAX or a port SpanBatch."""
    cols = dict(batch.columns)
    if kind == "high_bit":
        for name in ("trace_id_hi", "trace_id_lo"):
            cols[name] = cols[name] | HIGH
        flip = (cols["trace_id_hi"] & np.uint64(1)) == 0
        cols["trace_id_hi"] = np.where(flip, cols["trace_id_hi"] & ~HIGH,
                                       cols["trace_id_hi"])
    elif kind == "tied_starts":
        start = cols["start_unix_nano"].copy()
        start[:] = start[0]
        cols["start_unix_nano"] = start
    elif kind == "long_trace":
        # one trace of 40 spans: truncated at any L <= 16
        for name in ("trace_id_lo", "trace_id_hi"):
            col = cols[name].copy()
            col[:40] = col[0]
            cols[name] = col
    else:
        assert kind == "plain", kind
    return replace(batch, columns=cols)


def _both(n_traces: int, seed: int, kind: str = "plain"):
    return (_mutate(jsynth(n_traces, seed=seed), kind),
            _mutate(psynth(n_traces, seed=seed), kind))


def _seqs(seed: int, max_len: int, n: int = 12, pad=None):
    return jassemble(jsynth(n, seed=seed), max_len=max_len,
                     pad_traces_to=pad)


# ------------------------------------------------------ assemble_sequences

ASSEMBLE_CASES = [(0, 16, "plain", None), (1, 64, "plain", 8),
                  (2, 16, "long_trace", None), (3, 8, "long_trace", 16),
                  (4, 16, "high_bit", "ladder"), (5, 16, "tied_starts", 3)]


@pytest.mark.parametrize("seed,max_len,kind,pad", ASSEMBLE_CASES,
                         ids=[f"{k}-L{L}-{p}" for _, L, k, p in
                              ASSEMBLE_CASES])
def test_assemble_sequences_matches_the_reference(seed, max_len, kind, pad):
    jb, pb = _both(30, seed, kind)
    if pad == "ladder":
        jpad = ppad = BucketLadder(8, 2).round_rows
    else:
        jpad = ppad = pad
    ref = jassemble(jb, max_len=max_len, pad_traces_to=jpad)
    got = assemble_sequences(pb, max_len=max_len, pad_traces_to=ppad)
    for name in ("categorical", "continuous", "mask", "span_index"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(ref, name))
        assert getattr(got, name).dtype == getattr(ref, name).dtype
    assert got.n_truncated == ref.n_truncated
    if kind == "long_trace":
        assert got.n_truncated >= 40 - max_len


@pytest.mark.parametrize("pad", [None, 8, "ladder"])
def test_assemble_sequences_empty_batch(pad):
    jb, pb = jsynth(0, seed=0), psynth(0, seed=0)
    assert len(jb) == len(pb) == 0
    spec = BucketLadder(8, 2).round_rows if pad == "ladder" else pad
    ref = jassemble(jb, max_len=16, pad_traces_to=spec)
    got = assemble_sequences(pb, max_len=16, pad_traces_to=spec)
    for name in ("categorical", "continuous", "mask", "span_index"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(ref, name))
    assert got.n_truncated == ref.n_truncated == 0


# ------------------------------------------------------------------ model


@pytest.mark.parametrize("seed", SEEDS)
def test_score_spans_f32_parity(seed):
    jm, v, pm = _pair(SMALL, f32=True, seed=seed)
    seqs = _seqs(seed, SMALL["max_len"], pad=16)
    ref_err, ref_mean = jm.score_spans(v, seqs.categorical, seqs.continuous,
                                       seqs.mask)
    err, mean = pm.score_spans(seqs.categorical, seqs.continuous, seqs.mask)
    assert err.shape == seqs.mask.shape and err.dtype == torch.float32
    np.testing.assert_allclose(err.numpy(), np.asarray(ref_err),
                               atol=F32_TOL, rtol=F32_TOL)
    np.testing.assert_allclose(mean.numpy(), np.asarray(ref_mean),
                               atol=F32_TOL, rtol=F32_TOL)
    assert (err.numpy()[~seqs.mask] == 0).all()


def test_score_spans_f32_parity_default_width():
    """One case at the served config's full width (d 128, d_latent 64, 2
    heads, 2 layers, d_ff 512, L 64, vocabs 512/2048)."""
    jm, v, pm = _pair({}, f32=True)
    seqs = _seqs(3, 64, n=10)
    ref_err, ref_mean = jm.score_spans(v, seqs.categorical, seqs.continuous,
                                       seqs.mask)
    err, mean = pm.score_spans(seqs.categorical, seqs.continuous, seqs.mask)
    np.testing.assert_allclose(err.numpy(), np.asarray(ref_err),
                               atol=F32_TOL, rtol=F32_TOL)
    np.testing.assert_allclose(mean.numpy(), np.asarray(ref_mean),
                               atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("seed", SEEDS)
def test_score_spans_bf16_bound(seed):
    jm, v, pm = _pair(SMALL, f32=False, seed=seed)
    seqs = _seqs(seed, SMALL["max_len"], n=20, pad=24)
    ref_err, _ = jm.score_spans(v, seqs.categorical, seqs.continuous,
                                seqs.mask)
    err, mean = pm.score_spans(seqs.categorical, seqs.continuous, seqs.mask)
    ref_err, err = np.asarray(ref_err), err.numpy()
    m = seqs.mask
    assert np.isfinite(err).all() and np.isfinite(mean.numpy()).all()
    rel = np.abs(err[m] - ref_err[m]) / np.abs(ref_err[m])
    assert rel.max() <= BF16_ERR_RTOL
    squash = np.abs(np.exp(-err[m]) - np.exp(-ref_err[m]))
    assert squash.max() <= BF16_ATOL


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_all_padding_rows_stay_finite(f32):
    """Rows with no real span: K1's finite fill gives a uniform softmax,
    so nothing non-finite reaches the pool or the trace mean (one NaN at a
    padding position would poison a whole trace through NaN * 0)."""
    jm, v, pm = _pair(SMALL, f32=f32, seed=4)
    seqs = _seqs(4, SMALL["max_len"], n=3, pad=8)
    assert (~seqs.mask.any(-1)).sum() >= 4
    err, mean = pm.score_spans(seqs.categorical, seqs.continuous, seqs.mask)
    assert torch.isfinite(err).all() and torch.isfinite(mean).all()
    empty = ~torch.from_numpy(seqs.mask).any(-1)
    assert (mean[empty] == 0).all() and (err[empty] == 0).all()
    ref_err, ref_mean = jm.score_spans(v, seqs.categorical, seqs.continuous,
                                       seqs.mask)
    assert np.isfinite(np.asarray(ref_mean)).all()
    if f32:
        np.testing.assert_allclose(mean.numpy(), np.asarray(ref_mean),
                                   atol=F32_TOL, rtol=F32_TOL)


def test_loss_fn_matches_the_reference():
    jm, v, pm = _pair(SMALL, f32=True, seed=5)
    seqs = _seqs(5, SMALL["max_len"], pad=16)
    ref = float(jm.loss_fn(v, seqs.categorical, seqs.continuous, seqs.mask))
    got = float(pm.loss_fn(seqs.categorical, seqs.continuous, seqs.mask))
    assert abs(got - ref) <= F32_TOL * max(1.0, abs(ref))


def test_kernel_free_reference_route_is_the_same_on_cpu():
    _, _, pm = _pair(SMALL, f32=False, seed=6)
    seqs = _seqs(6, SMALL["max_len"])
    args = (seqs.categorical, seqs.continuous, seqs.mask)
    assert torch.equal(pm.span_errors(*args),
                       pm.span_errors(*args, reference=True))


def test_flax_autoencoder_to_torch_default_tree():
    jm = JaxAutoencoder(JaxConfig())
    v = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    pm = SpanAutoencoder(AutoencoderConfig(dtype=torch.float32),
                         device="cpu")
    sd = flax_autoencoder_to_torch(v, pm.cfg)
    own = pm.state_dict()
    assert set(sd) == set(own)
    for k, t in sd.items():
        assert t.shape == own[k].shape and t.dtype == torch.float32, k
    # the flattened form and the "params"-less form carry the same
    flat = {"/".join(str(p.key) for p in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(v["params"])[0]}
    assert all(torch.equal(sd[k], t) for k, t in
               flax_autoencoder_to_torch(flat, pm.cfg).items())
    np.testing.assert_array_equal(
        sd["service_head.weight"].numpy(),
        v["params"]["service_head"]["kernel"].T)


def test_flax_autoencoder_to_torch_refuses_mismatched_trees():
    jm = JaxAutoencoder(JaxConfig(**TINY))
    v = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    cfg = AutoencoderConfig(**TINY)
    extra = {"params": {**v["params"], "stray": {"kernel": np.zeros(1)}}}
    with pytest.raises(KeyError, match="not carried across"):
        flax_autoencoder_to_torch(extra, cfg)
    missing = {"params": {k: t for k, t in v["params"].items()
                          if k != "dec_ln"}}
    with pytest.raises(KeyError, match="dec_ln"):
        flax_autoencoder_to_torch(missing, cfg)
    pm = SpanAutoencoder(AutoencoderConfig(**TINY), device="cpu")
    sd = flax_autoencoder_to_torch(v, cfg)
    sd.pop("kind_head.bias")
    with pytest.raises(KeyError, match="kind_head.bias"):
        pm.load_state_dict(sd)


def test_seeded_init_is_deterministic():
    torch.manual_seed(123)  # the global generator is not the one drawn
    a = SpanAutoencoder(AutoencoderConfig(**TINY), device="cpu", seed=3)
    torch.manual_seed(456)
    b = SpanAutoencoder(AutoencoderConfig(**TINY), device="cpu", seed=3)
    c = SpanAutoencoder(AutoencoderConfig(**TINY), device="cpu", seed=4)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["name_head.weight"], sc["name_head.weight"])
    # Flax's shapes and working-type decoder products
    bf = SpanAutoencoder(AutoencoderConfig(**TINY), device="cpu")
    assert bf.module.dec_ff1.weight.dtype == torch.bfloat16
    assert bf.module.service_head.weight.dtype == torch.float32
    assert bf.module.dec_pos_embed.weight.shape == (16, 32)


def test_autoencoder_defaults_to_cuda_and_raises_without_a_card():
    import inspect

    assert inspect.signature(SpanAutoencoder).parameters[
        "device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this pins the no-card path")
    with pytest.raises(RuntimeError, match="is_available"):
        SpanAutoencoder(AutoencoderConfig(**TINY))


# ------------------------------------------- the kernels' plain versions


def _jax_layer_norm(x, scale, bias, dtype):
    ln = fnn.LayerNorm(dtype=dtype)
    return ln.apply({"params": {"scale": scale, "bias": bias}}, x)


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_ln_masked_pool_plain_matches_the_reference_pool(f32):
    """K12's plain version on a pre-LN state against the reference's
    final LayerNorm followed by ``_AutoencoderModule``'s pool (:69-70)."""
    rng = np.random.default_rng(7)
    T, L, d = 12, 16, 64
    x = rng.normal(0, 2, (T, L, d)).astype(np.float32)
    mask = rng.random((T, L)) < 0.4
    mask[3] = False  # a row of padding only
    scale = rng.normal(1, 0.1, d).astype(np.float32)
    bias = rng.normal(0, 0.1, d).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if f32 else (jnp.bfloat16,
                                                        torch.bfloat16)
    xj = jnp.asarray(x).astype(jdt)
    h = _jax_layer_norm(xj, scale, bias, jdt)
    denom = jnp.maximum(mask.sum(-1, keepdims=True), 1).astype(h.dtype)
    ref = (h * jnp.asarray(mask)[..., None].astype(h.dtype)).sum(-2) / denom
    ref = np.asarray(ref.astype(jnp.float32))
    got = kpool.ln_masked_pool(torch.from_numpy(x).to(tdt),
                               torch.from_numpy(scale),
                               torch.from_numpy(bias),
                               torch.from_numpy(mask))
    assert got.shape == (T, d) and got.dtype == tdt
    got = got.float().numpy()
    if f32:
        np.testing.assert_allclose(got, ref, atol=F32_TOL, rtol=F32_TOL)
    else:
        step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 2 ** -60)))
                       - 7)
        assert (np.abs(got - ref) <= step).all()
    assert (got[3] == 0).all()


@pytest.mark.parametrize("live", [0, 5, 12, 20])
@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_ln_masked_pool_plain_with_a_row_count(f32, live):
    """K12's plain version given K13's row count, on rows laid out as K13
    and the host route lay them out (the traces' rows, then rows of
    padding): equal to the plain version without the count, zero at every
    row past it, whatever those rows hold (the encoder's plain path writes
    NaN there)."""
    seqs = _seqs(21, 16, n=12, pad=lambda t: 20)
    T, L = seqs.mask.shape
    assert T == 20 and not seqs.mask[12:].any()
    rng = np.random.default_rng(21)
    tdt = torch.float32 if f32 else torch.bfloat16
    x = torch.from_numpy(rng.normal(0, 2, (T, L, 64)).astype(
        np.float32)).to(tdt)
    w = torch.from_numpy(rng.normal(1, 0.1, 64).astype(np.float32))
    b = torch.from_numpy(rng.normal(0, 0.1, 64).astype(np.float32))
    mask = torch.from_numpy(seqs.mask)
    count = torch.tensor([live], dtype=torch.int32)
    free = kpool.ln_masked_pool_plain(x, w, b, mask)
    if live >= 12:  # every trace below the count: the same rows
        assert torch.equal(kpool.ln_masked_pool_plain(x, w, b, mask,
                                                      live=count), free)
    x[live:] = float("nan")
    got = kpool.ln_masked_pool_plain(x, w, b, mask, live=count)
    assert torch.equal(got[:live], free[:live])
    assert (got[live:] == 0).all() and not got.isnan().any()
    assert torch.equal(kpool.ln_masked_pool(x, w, b, mask, live=count), got)


def k12_listing_model(row: np.ndarray, p0: int, words: bool) -> list:
    """K12's list of a trace's real positions among mask bytes p0 .. p0 +
    127 (list_real_positions): lane k reads bytes p0 + 4k .. p0 + 4k + 3
    (one word when ``words``, else byte by byte up to L), four ballots
    give each lane its count of real bytes in the lower lanes, and the
    lane writes its real positions from there on."""
    L = row.size
    lane_bytes = []
    for k in range(32):
        p = p0 + 4 * k
        if words:
            lane_bytes.append([row[p + e] if p < L else 0 for e in range(4)])
        else:
            lane_bytes.append([row[p + e] if p + e < L else 0
                               for e in range(4)])
    bal = [[bool(lane_bytes[k][e]) for k in range(32)] for e in range(4)]
    out = [None] * sum(sum(bl) for bl in bal)
    for k in range(32):
        at = sum(sum(bal[e][:k]) for e in range(4))
        for e in range(4):
            if lane_bytes[k][e]:
                out[at] = p0 + 4 * k + e
                at += 1
    return out


def k12_walk_model(n: int, G: int, S: int) -> list:
    """The list slots K12's warp copies through its ring and reduces, in
    order: steps of 32 / G positions (group g takes slot s * P + g), the
    copies of step s + S - 1 issued before step s is reduced; a group
    past n copies nothing and idles. Checks that a slot is reduced only
    after its copy and from the ring stage it was copied into."""
    P = 32 // G
    steps = -(-n // P)
    stage: dict = {}
    done = []

    def issue(s):
        for g in range(P):
            if s * P + g < n:
                stage[s * P + g] = s % S

    for s in range(S - 1):
        issue(s)
    for s in range(steps):
        issue(s + S - 1)
        for g in range(P):
            i = s * P + g
            if i < n:
                assert stage.pop(i) == s % S
                done.append(i)
    assert not stage
    return done


@pytest.mark.parametrize("L", [1, 3, 8, 64, 130, 1024])
@pytest.mark.parametrize("kind", ["prefix", "holes", "empty", "full"])
def test_k12_model_lists_every_real_position_once(L, kind):
    """The host model of K12's mask listing (128 positions a pass) and its
    walk through the ring: every real position of a row listed once, in
    order, with the word reads (L % 4 == 0) and the byte reads, and
    reduced once at every group width and ring depth the launcher
    picks."""
    rng = np.random.default_rng(L)
    row = {"prefix": np.arange(L) < rng.integers(0, L + 1),
           "holes": rng.random(L) < 0.3,
           "empty": np.zeros(L, bool),
           "full": np.ones(L, bool)}[kind].astype(np.uint8)
    want = list(np.flatnonzero(row))
    for words in ([True, False] if L % 4 == 0 else [False]):
        got = []
        for p0 in range(0, L, 128):
            part = k12_listing_model(row, p0, words)
            for G, S in ((1, 4), (2, 4), (4, 4), (8, 4), (16, 4), (32, 4),
                         (32, 2), (32, 1)):
                assert k12_walk_model(len(part), G, S) == list(
                    range(len(part)))
            got += part
        assert got == want


def _jax_errors(v, cfg, dec, cat, cont, mask):
    """``SpanAutoencoder._errors`` from ``dec_ln`` on: the reference's own
    modules and ``_ce`` on the given decoder output."""
    p = v["params"]
    y = _jax_layer_norm(dec, p["dec_ln"]["scale"], p["dec_ln"]["bias"],
                        cfg.dtype)
    return _jax_head_errors(v, cfg, y, cat, cont, mask)


def _jax_head_errors(v, cfg, y, cat, cont, mask):
    """The reference's four heads and ``_ce`` on ``dec_ln``'s output y."""
    p = v["params"]
    out = {}
    for name, V in (("service", cfg.service_vocab),
                    ("name", cfg.name_vocab), ("kind", 8),
                    ("duration", 1)):
        out[name] = fnn.Dense(V, dtype=jnp.float32).apply(
            {"params": p[f"{name}_head"]}, y)
    err = cfg.w_service * _ce(out["service"], cat[..., 0])
    err += cfg.w_name * _ce(out["name"], cat[..., 1])
    err += cfg.w_kind * _ce(out["kind"], cat[..., 2])
    err += cfg.w_duration * (out["duration"][..., 0] - cont[..., 0]) ** 2
    return np.asarray(err * mask.astype(jnp.float32))


def _recon_args(pm, dec, seqs):
    m = pm.module
    T, L = seqs.mask.shape
    return (torch.from_numpy(np.array(dec, np.float32)).to(
        pm.cfg.dtype).reshape(T * L, -1), m.dec_ln.weight, m.dec_ln.bias,
        m.heads(), torch.from_numpy(seqs.categorical).reshape(T * L, -1),
        torch.from_numpy(seqs.continuous).reshape(T * L, -1),
        torch.from_numpy(seqs.mask).reshape(-1),
        (pm.cfg.w_service, pm.cfg.w_name, pm.cfg.w_kind,
         pm.cfg.w_duration))


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_recon_ce_plain_matches_the_reference_errors(f32):
    jm, v, pm = _pair(SMALL, f32=f32, seed=8)
    seqs = _seqs(8, SMALL["max_len"], pad=16)
    T, L = seqs.mask.shape
    rng = np.random.default_rng(8)
    dec = rng.normal(0, 1, (T, L, SMALL["d_model"])).astype(np.float32)
    jdec = jnp.asarray(dec).astype(jm.cfg.dtype)
    ref = _jax_errors(v, jm.cfg, jdec, seqs.categorical, seqs.continuous,
                      seqs.mask)
    with torch.inference_mode():
        got = krecon.recon_ce(*_recon_args(pm, np.array(
            jdec.astype(jnp.float32)), seqs)).view(T, L).numpy()
    if f32:
        np.testing.assert_allclose(got, ref, atol=F32_TOL, rtol=F32_TOL)
    else:
        m = seqs.mask
        assert (np.abs(got[m] - ref[m]) / np.abs(ref[m])).max() \
            <= BF16_ERR_RTOL
    assert (got[~seqs.mask] == 0).all()


# ---- K11's bf16 kernel: the premises of its three-plane split

def _split_product_errors(y, heads, planes, cat, cont, weights):
    """The bf16 kernel's arithmetic in plain torch, on the real positions'
    LayerNorm output y (bf16 values): the service and name logits as y
    times each of the three bf16 planes, in f32, summed, plus the bias;
    the kind and duration heads as f32 products; each cross-entropy as
    log-sum-exp minus the label's logit; the error in the reference's
    order."""
    yf = y.float()
    z = sum(yf @ planes.w[p].float().T for p in range(3)) + planes.b
    logits = [z[:, :planes.v_s],
              z[:, planes.vs_pad:planes.vs_pad + planes.v_n],
              torch.nn.functional.linear(yf, *heads[2]),
              torch.nn.functional.linear(yf, *heads[3])]
    lab = cat.long()

    def ce(h):
        lg = logits[h]
        return (torch.logsumexp(lg, 1)
                - lg.gather(1, lab[:, h:h + 1].clamp(0, lg.shape[1] - 1))[
                    :, 0])

    e = weights[0] * ce(0)
    e = e + weights[1] * ce(1)
    e = e + weights[2] * ce(2)
    return e + weights[3] * (logits[3][:, 0] - cont[:, 0]) ** 2


def _assert_planes_exact(w, planes, v0):
    """The planes are bf16 and sum to w bit for bit (f64 sums, exact for
    three bf16 values)."""
    assert planes.w.dtype == torch.bfloat16
    got = planes.w.double().sum(0)[v0:v0 + w.shape[0]]
    assert torch.equal(got, w.double())


@pytest.mark.parametrize("weights", ["default", "random"])
def test_k11_head_planes_sum_to_the_weights_bit_for_bit(weights):
    """W_hi + W_mid + W_lo == W for the default autoencoder's heads and for
    f32 weights spread over 1e-30 ... 1e30 (signs, zeros, powers of two,
    values one f32 step off a bf16 value); each head padded to a multiple
    of 64 rows with zero planes and a -inf bias."""
    if weights == "default":
        heads = SpanAutoencoder(AutoencoderConfig(), device="cpu",
                                seed=0).module.heads()
    else:
        rng = np.random.default_rng(11)
        heads = []
        for V, d in ((300, 128), (700, 128), (8, 128), (1, 128)):
            w = (rng.standard_normal((V, d))
                 * 10.0 ** rng.uniform(-30, 30, (V, d))).astype(np.float32)
            w[0, :4] = [0.0, -0.0, 2.0 ** -100, -(2.0 ** 100)]
            w[-1, :2] = np.nextafter(np.float32([1.0, -3.0]),
                                     np.float32(np.inf))
            heads.append((torch.from_numpy(w),
                          torch.from_numpy(rng.standard_normal(V).astype(
                              np.float32))))
    planes = krecon.head_planes(heads)
    (ws, bs), (wn, bn) = heads[:2]
    pad_s = -(-ws.shape[0] // krecon.PLANE_PAD) * krecon.PLANE_PAD
    pad_n = -(-wn.shape[0] // krecon.PLANE_PAD) * krecon.PLANE_PAD
    assert planes.w.shape == (3, pad_s + pad_n, ws.shape[1])
    assert (planes.vs_pad, planes.v_s, planes.v_n) == (
        pad_s, ws.shape[0], wn.shape[0])
    _assert_planes_exact(ws, planes, 0)
    _assert_planes_exact(wn, planes, pad_s)
    pad = torch.ones(pad_s + pad_n, dtype=torch.bool)
    pad[:ws.shape[0]] = False
    pad[pad_s:pad_s + wn.shape[0]] = False
    assert (planes.w[:, pad] == 0).all()
    assert torch.isinf(planes.b[pad]).all() and (planes.b[pad] < 0).all()
    assert torch.equal(planes.b[~pad], torch.cat([bs, bn]))


@pytest.mark.parametrize("bad", [float("inf"), float("nan"), 3.3999e38,
                                 1e-38])
def test_k11_head_planes_refuse_weights_outside_the_split(bad):
    """A weight the three planes cannot hold (not finite, rounding to inf
    in bf16, or with bits below the planes' reach) raises: the tensor-core
    kernel would not compute f32 logits."""
    w = torch.randn(64, 32)
    w[3, 5] = bad * (1 + 2 ** -20)
    heads = [(w, torch.zeros(64)), (torch.randn(64, 32), torch.zeros(64)),
             (torch.randn(8, 32), torch.zeros(8)),
             (torch.randn(1, 32), torch.zeros(1))]
    with pytest.raises(ValueError, match="three-plane"):
        krecon.head_planes(heads)


@pytest.mark.parametrize("seed", [8, 12])
def test_k11_split_product_matches_plain_and_reference(seed):
    """The three-plane split product on bf16 LayerNorm outputs is within
    RECON_ATOL (the kernel's bound on the card) of recon_ce_plain on the
    port's own LN output, and of the reference's heads and _ce on the
    reference's own bf16 LN output."""
    jm, v, pm = _pair(SMALL, f32=False, seed=seed)
    seqs = _seqs(seed, SMALL["max_len"], pad=16)
    T, L = seqs.mask.shape
    rng = np.random.default_rng(seed)
    dec = (rng.normal(0, 1, (T, L, SMALL["d_model"])) * 2 + 0.5).astype(
        np.float32)
    args = _recon_args(pm, dec, seqs)
    m = pm.module
    planes = m.head_planes()
    assert planes is m.head_planes()  # cached on the module
    mask = args[6]
    real = torch.nonzero(mask).flatten()
    wts = args[7]
    cat, cont = args[4][real], args[5][real]
    with torch.inference_mode():
        plain = krecon.recon_ce_plain(*args)[real]
        y = layer_norm_plain(args[0][real], m.dec_ln.weight, m.dec_ln.bias)
        got = _split_product_errors(y, m.heads(), planes, cat, cont, wts)
    assert y.dtype == torch.bfloat16
    assert (got - plain).abs().max().item() <= RECON_ATOL
    # the reference's LN output, the same split product
    p = v["params"]
    jy = _jax_layer_norm(jnp.asarray(dec).astype(jnp.bfloat16),
                         p["dec_ln"]["scale"], p["dec_ln"]["bias"],
                         jnp.bfloat16)
    ref = _jax_head_errors(v, jm.cfg, jy, seqs.categorical,
                           seqs.continuous, seqs.mask).reshape(-1)[
        real.numpy()]
    ty = torch.from_numpy(np.array(jy.astype(jnp.float32))).reshape(
        T * L, -1)[real].to(torch.bfloat16)
    with torch.inference_mode():
        got_j = _split_product_errors(ty, m.heads(), planes, cat, cont, wts)
    assert np.abs(got_j.numpy() - ref).max() <= RECON_ATOL


def test_k11_head_planes_cache_follows_the_weights():
    """The module's planes are rebuilt when a head changes (an in-place
    copy, a load_state_dict), never per call otherwise."""
    pm = SpanAutoencoder(AutoencoderConfig(**SMALL), device="cpu", seed=3)
    m = pm.module
    first = m.head_planes()
    assert m.head_planes() is first
    with torch.no_grad():
        m.name_head.weight.mul_(2)
    second = m.head_planes()
    assert second is not first
    _assert_planes_exact(m.name_head.weight, second, second.vs_pad)
    pm.load_state_dict({k: v.clone() for k, v in pm.state_dict().items()})
    assert m.head_planes() is not second


def test_recon_ce_scatter_mode_writes_squashed_scores_by_span():
    _, _, pm = _pair(SMALL, f32=True, seed=9)
    seqs = _seqs(9, SMALL["max_len"], pad=16)
    T, L = seqs.mask.shape
    rng = np.random.default_rng(9)
    dec = rng.normal(0, 1, (T, L, SMALL["d_model"])).astype(np.float32)
    args = _recon_args(pm, dec, seqs)
    smap = torch.from_numpy(seqs.span_index).reshape(-1)
    n = int(seqs.span_index.max()) + 1  # the batch's spans
    with torch.inference_mode():
        err, scores = krecon.recon_ce(*args, span_map=smap, n_out=n + 5)
        assert torch.equal(err, krecon.recon_ce(*args))
    want = np.zeros(n + 5, np.float32)
    m = seqs.mask.reshape(-1)
    want[seqs.span_index.reshape(-1)[m]] = 1.0 - np.exp(-err.numpy()[m])
    np.testing.assert_allclose(scores.numpy(), want, rtol=1e-6, atol=1e-7)
    assert (scores.numpy()[n:] == 0).all()


def _jax_pack_spans(je, cols, L, rows):
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
    packed = _build_pack_spans(L)(cat, cont, start_lo, start_hi, thi_lo,
                                  thi_hi, tlo_lo, tlo_hi, frame, rows=rows)
    return n, N, np.asarray(cat), np.asarray(cont), [np.asarray(a)
                                                     for a in packed]


def _engines(max_len: int = 16, **engine_kw):
    tiny = dict(TINY, max_len=max_len)
    je = JaxEngine(JaxEngineConfig(
        model="autoencoder",
        model_config=JaxConfig(**tiny, **WEIGHTS, dtype=jnp.float32),
        featurizer=JaxFeatConfig(**VOCAB), max_len=max_len, trace_bucket=8,
        bucket_ladder=2))
    pe = ScoringEngine(EngineConfig(
        model="autoencoder", device="cpu", max_len=max_len, trace_bucket=8,
        bucket_ladder=2, featurizer=FeaturizerConfig(**VOCAB),
        model_config=AutoencoderConfig(**tiny, **WEIGHTS,
                                       dtype=torch.float32), **engine_kw))
    pe.backend.model.load_state_dict(flax_autoencoder_to_torch(
        jax.tree_util.tree_map(np.asarray, je.backend.variables),
        pe.backend.model.cfg))
    return je, pe


@pytest.fixture(scope="module")
def engines():
    """Unstarted JAX and port autoencoder engines (direct backend use)
    with the same f32 weights."""
    return _engines()


@pytest.fixture(scope="module")
def engines8():
    """The same at max_len 8: synthetic traces (up to 17 spans) truncate."""
    return _engines(8)


def _port_cols(batches):
    out = []
    for b in batches:
        c, reason = extract_columns(b)
        assert reason is None
        out.append(c)
    return out


PACK_CASES = [(16, "plain", 0), (16, "high_bit", 13),
              (16, "tied_starts", 15), (8, "long_trace", 16)]


@pytest.mark.parametrize("L,kind,seed", PACK_CASES,
                         ids=[f"L{L}-{k}-{s}" for L, k, s in PACK_CASES])
def test_trace_rows_pack_plain_matches_build_pack_spans(engines, L, kind,
                                                        seed):
    """K13's plain version on the reference's own features: exactly the
    rows of ``_build_pack_spans`` (whose R is the span bucket; the port's
    is the ladder's rung over the span count, the extra rows padding)."""
    je, pe = engines
    jb, pb = _both(40, seed, kind)
    n = len(pb)
    N = _span_bucket(n)
    R_port = pe.backend.ladder.round_rows(n)
    _, _, jcat, jcont, jp = _jax_pack_spans(
        je, [jax_extract(jb)[0]], L, N)
    catp, contp, maskp, jperm, row_eff, col, pad_s = jp
    staged = pe.backend._prep_columns(_port_cols([pb]), N)
    c = staged.cols
    perm = ksort.radix_sort([c["trace_id_hi"], c["trace_id_lo"],
                             c["start_unix_nano"]], n)
    np.testing.assert_array_equal(perm.numpy(), jperm)
    tr = kpack.trace_rows_pack(perm, c["trace_id_hi"], c["trace_id_lo"],
                               torch.from_numpy(jcat.copy()),
                               torch.from_numpy(jcont.copy()), n, L, R_port)
    r = min(R_port, N)
    for mine, ref in ((tr.categorical, catp), (tr.continuous, contp),
                      (tr.mask, maskp)):
        mine = mine.numpy()
        np.testing.assert_array_equal(mine[:r], ref[:r])
        assert not mine[r:].any() and not ref[r:].any()
    want = np.full((R_port, L), -1, np.int32)
    keep = ~pad_s & (col < L) & (row_eff < R_port)
    want[row_eff[keep], col[keep]] = jperm[keep]
    np.testing.assert_array_equal(tr.span_map.numpy(), want)
    assert int(tr.rows_used[0]) == int(row_eff[~pad_s].max()) + 1


def test_trace_rows_pack_plain_is_the_host_assembly(engines):
    """On one frame K13 builds the host route's rows: the same tensors as
    ``assemble_sequences``, and its span map is the host's span index."""
    _, pe = engines
    pb = _mutate(psynth(30, seed=17), "long_trace")
    n = len(pb)
    seqs = assemble_sequences(pb, featurize(pb), max_len=16,
                              pad_traces_to=pe.backend.ladder.round_rows)
    N = _span_bucket(n)
    staged = pe.backend._prep_columns(_port_cols([pb]), N)
    c = staged.cols
    f = featurize(pb)
    pad = N - n
    cat = torch.from_numpy(np.concatenate(
        [f.categorical, np.zeros((pad, f.categorical.shape[1]), np.int32)]))
    cont = torch.from_numpy(np.concatenate(
        [f.continuous, np.zeros((pad, 3), np.float32)]))
    perm = ksort.radix_sort([c["trace_id_hi"], c["trace_id_lo"],
                             c["start_unix_nano"]], n)
    R = seqs.n_traces
    tr = kpack.trace_rows_pack(perm, c["trace_id_hi"], c["trace_id_lo"],
                               cat, cont, n, 16, R)
    np.testing.assert_array_equal(tr.categorical.numpy(), seqs.categorical)
    np.testing.assert_array_equal(tr.continuous.numpy(), seqs.continuous)
    np.testing.assert_array_equal(tr.mask.numpy(), seqs.mask)
    np.testing.assert_array_equal(tr.span_map.numpy(), seqs.span_index)


def test_trace_rows_pack_drops_rows_past_R_and_counts_every_trace():
    rng = np.random.default_rng(3)
    n, N, L, R = 50, 64, 4, 6
    tid = np.sort(rng.integers(0, 15, n)).astype(np.int64)
    hi = torch.from_numpy(np.concatenate([tid, np.zeros(N - n, np.int64)]))
    lo = torch.zeros(N, dtype=torch.int64)
    perm = torch.arange(N, dtype=torch.int32)
    cat = torch.from_numpy(rng.integers(1, 9, (N, 5)).astype(np.int32))
    cont = torch.from_numpy(rng.normal(size=(N, 3)).astype(np.float32))
    tr = kpack.trace_rows_pack(perm, hi, lo, cat, cont, n, L, R)
    traces = len(np.unique(tid))
    assert int(tr.rows_used[0]) == traces > R
    starts = np.r_[0, np.nonzero(np.diff(tid))[0] + 1]
    for r in range(R):
        length = min(L, (starts[r + 1] if r + 1 < traces else n) - starts[r])
        assert tr.mask[r, :length].all() and not tr.mask[r, length:].any()
        np.testing.assert_array_equal(
            tr.span_map[r, :length].numpy(),
            np.arange(starts[r], starts[r] + length))
        assert torch.equal(tr.categorical[r, :length],
                           cat[starts[r]:starts[r] + length])


def _k13_fill_range(written, e0, e1, itemsize):
    """``trace_pack.cu`` fill_range's stores over ``[e0, e1)`` of a flat
    array 16-byte aligned at element 0: scalars up to the first 16-byte
    boundary, whole aligned vectors, scalars past the last boundary. Each
    element's store is counted in ``written``."""
    V = 16 // itemsize
    if e0 >= e1:
        return
    a0 = min(e1, -(-e0 // V) * V)
    a1 = max(a0, e1 // V * V)
    assert e0 <= a0 <= a1 <= e1 and a0 - e0 < V and e1 - a1 < V
    if a0 < a1:  # vectors: aligned
        assert a0 % V == 0 and a1 % V == 0
    written[e0:a0] += 1
    written[a0:a1] += 1  # (a1 - a0) / V vectors
    written[a1:e1] += 1


def k13_model(perm, hi, lo, cat, cont, n, L, R, block=kpack.ROWS_BLOCK):
    """K13's two launches on the host. Layout: each sorted span's new-trace
    flag, the trace-start bitmask by words of 32 and each block's count of
    starts. Scatter, a thread a sorted span j of block b: its trace's
    ordinal (b's prefix of the counts + the starts in b's earlier words +
    its own word's starts up to j, less one) and its column (j less the
    last start at or before j, looked for at most L spans back), its slot
    written; each trace start finds the next start within L spans (its
    trace's length) and its warp fills the rest of the row through
    fill_range; the rows past the trace count are a zero fill. Returns the
    four outputs and the trace count, and checks that every element is
    stored exactly once."""
    C, D = cat.shape[1], cont.shape[1]
    catp = np.full(R * L * C, -7, np.int32)
    contp = np.full(R * L * D, np.nan, np.float32)
    maskp = np.full(R * L, 7, np.uint8)
    smap = np.full(R * L, -7, np.int32)
    written = [np.zeros(a.size, np.int64) for a in (catp, contp, maskp,
                                                    smap)]
    p = perm[:n]
    h, lw = hi[p], lo[p]
    fresh = np.ones(n, bool)
    fresh[1:] = (h[1:] != h[:-1]) | (lw[1:] != lw[:-1])
    nb = -(-n // block)
    bits = np.zeros(nb * block, bool)
    bits[:n] = fresh
    words = [int(sum(1 << k for k in np.flatnonzero(bits[w * 32:w * 32 + 32])))
             for w in range(nb * block // 32)]
    per = block // 32
    counts = [sum(bin(words[b * per + k]).count("1") for k in range(per))
              for b in range(nb)]
    tot = sum(counts)
    rows = min(tot, R)
    arrays = ((catp, C, 4, 0), (contp, D, 4, 0), (maskp, 1, 1, 0),
              (smap, 1, 4, -1))

    def high(x):  # the highest set bit
        return x.bit_length() - 1

    def low(x):  # the lowest set bit
        return (x & -x).bit_length() - 1

    for b in range(nb):
        pre = sum(counts[:b])
        for k in range(per):
            wd = b * per + k
            mw = words[wd]
            before = pre + sum(bin(words[b * per + q]).count("1")
                               for q in range(k))
            starts = []  # (row, length) of the word's trace starts
            for lane in range(32):
                j = wd * 32 + lane
                if j >= n:
                    break
                upto = mw & ((2 << lane) - 1)
                r = before + bin(upto).count("1") - 1
                c = L
                if upto:
                    c = lane - high(upto)
                else:
                    w = wd - 1
                    while w >= 0 and j - (w * 32 + 31) < L:
                        if words[w]:
                            c = j - (w * 32 + high(words[w]))
                            break
                        w -= 1
                if not (r < R and c < L):
                    continue
                idx = int(p[j])
                e = r * L + c
                for arr, cnt, val, width in ((catp, written[0], cat[idx], C),
                                             (contp, written[1], cont[idx], D),
                                             (maskp, written[2], 1, 1),
                                             (smap, written[3], idx, 1)):
                    arr[e * width:(e + 1) * width] = val
                    cnt[e * width:(e + 1) * width] += 1
                if c == 0:
                    lim = min(j + L, n)
                    nxt = lim
                    after = mw & ~((2 << lane) - 1)
                    if after:
                        nxt = min(lim, wd * 32 + low(after))
                    else:
                        w = wd + 1
                        while w * 32 < lim:
                            if words[w]:
                                nxt = min(lim, w * 32 + low(words[w]))
                                break
                            w += 1
                    starts.append((r, nxt - j))
            for r, length in starts:  # the warp fills each row's rest
                for (arr, width, size, zero), cnt in zip(arrays, written):
                    e0, e1 = (r * L + length) * width, (r + 1) * L * width
                    _k13_fill_range(cnt, e0, e1, size)
                    arr[e0:e1] = zero
    for (arr, width, size, zero), cnt in zip(arrays, written):
        e0, e1 = rows * L * width, R * L * width
        _k13_fill_range(cnt, e0, e1, size)
        arr[e0:e1] = zero
    for cnt in written:
        assert (cnt == 1).all()
    return (catp.reshape(R, L, C), contp.reshape(R, L, D),
            maskp.reshape(R, L).astype(bool), smap.reshape(R, L), tot)


def _k13_frame(kind: str, n_traces: int, seed: int):
    """A frame's trace ids, starts and features: the otel mix, the
    adversarial frame (a 200-span trace, tied starts, high-bit ids) or
    traces longer than L (six otel traces under one id)."""
    from odigos_tpu_torch.pdata import adversarial_traces

    b = (adversarial_traces if kind == "adversarial" else psynth)(
        n_traces, seed=seed)
    cols = b.columns
    hi, lo = cols["trace_id_hi"], cols["trace_id_lo"]
    if kind == "long":
        _, tr = np.unique(np.stack([hi, lo], 1), axis=0, return_inverse=True)
        hi = (tr.reshape(-1) // 6 + 1).astype(np.uint64)
        lo = np.zeros_like(lo)
    n = len(hi)
    rng = np.random.default_rng(seed)
    cat = rng.integers(-5, 600, (n, 5)).astype(np.int32)
    cont = rng.normal(size=(n, 3)).astype(np.float32)
    return hi, lo, cols["start_unix_nano"], cat, cont


@pytest.mark.parametrize("rows", ["bucket", "traces", "fewer"])
@pytest.mark.parametrize("L,kind,n_traces", [
    (8, "otel", 300), (8, "long", 300), (64, "otel", 300),
    (64, "adversarial", 300), (64, "long", 300), (1024, "otel", 30),
    (1024, "adversarial", 40), (1024, "long", 40)])
def test_k13_model_matches_trace_rows_pack_plain(L, kind, n_traces, rows):
    """K13's layout counts, per-block prefixes and span-wise scatter, on
    the host, give ``trace_rows_pack_plain``'s outputs exactly (traces longer
    than L truncated, traces past R dropped, padding rows and columns
    zero, -1 in the span map), with every element stored once; and the
    trace count."""
    hi, lo, start, cat, cont = _k13_frame(kind, n_traces, seed=L + n_traces)
    n = len(hi)
    N = n + 9
    order = np.lexsort((start, lo, hi))
    perm = np.concatenate([order, np.arange(n, N)]).astype(np.int32)

    def pad(a):
        return np.concatenate([a, np.zeros((N - n,) + a.shape[1:], a.dtype)])

    hi64, lo64 = (pad(a).view(np.int64) for a in (hi, lo))
    traces = len(np.unique(np.stack([hi, lo], 1), axis=0))
    R = {"bucket": BucketLadder(64, 4).round_rows(n), "traces": traces,
         "fewer": max(1, traces // 3)}[rows]
    got = k13_model(perm, hi64, lo64, pad(cat), pad(cont), n, L, R)
    want = kpack.trace_rows_pack_plain(
        *(torch.from_numpy(a) for a in (perm, hi64, lo64, pad(cat),
                                        pad(cont))), n, L, R)
    for mine, ref in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(mine, ref.numpy())
    assert got[4] == int(want.rows_used[0]) == traces
    if kind in ("adversarial", "long"):  # some trace is longer than L
        assert want.mask[:, -1].any() or L == 1024


def test_k13_model_empty_group_is_all_padding():
    z = np.zeros(16, np.int64)
    catp, contp, maskp, smap, tot = k13_model(
        np.arange(16, dtype=np.int32), z, z, np.ones((16, 5), np.int32),
        np.ones((16, 3), np.float32), 0, 8, 5)
    assert tot == 0 and not catp.any() and not contp.any()
    assert not maskp.any() and (smap == -1).all()


def test_wrappers_take_the_plain_version_on_the_cpu():
    _, _, pm = _pair(SMALL, f32=False, seed=10)
    seqs = _seqs(10, SMALL["max_len"], pad=16)
    T, L = seqs.mask.shape
    rng = np.random.default_rng(10)
    x = torch.from_numpy(rng.normal(size=(T, L, 64)).astype(
        np.float32)).to(torch.bfloat16)
    ln = pm.module.encoder.final_ln
    mask = torch.from_numpy(seqs.mask)
    before = kpool.launches, krecon.launches, kpack.rows_launches
    assert torch.equal(kpool.ln_masked_pool(x, ln.weight, ln.bias, mask),
                       kpool.ln_masked_pool_plain(x, ln.weight, ln.bias,
                                                  mask))
    args = _recon_args(pm, x.float().numpy(), seqs)
    with torch.inference_mode():
        assert torch.equal(krecon.recon_ce(*args),
                           krecon.recon_ce_plain(*args))
    assert (kpool.launches, krecon.launches, kpack.rows_launches) == before
    with pytest.raises(ValueError, match="mask"):
        kpool.ln_masked_pool(x, ln.weight, ln.bias, mask.int())
    with pytest.raises(ValueError, match="four heads"):
        krecon.recon_ce(args[0], args[1], args[2], args[3][:3], *args[4:])


# ----------------------------------------------------------------- engine


@pytest.mark.parametrize("n_traces,seed", [(1, 0), (12, 1), (60, 2)])
def test_engine_host_route_matches_the_jax_engine(engines, n_traces, seed):
    je, pe = engines
    jb, pb = _both(n_traces, seed)
    ref = je.backend.score(jb, jfeaturize(jb, JaxFeatConfig(**VOCAB)))
    got = pe.backend.score(pb, featurize(pb, FeaturizerConfig(**VOCAB)))
    assert got.shape == ref.shape == (len(pb),) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=F32_TOL, rtol=F32_TOL)
    # the loss weights keep the squash off its ceiling; spans truncated
    # from a trace longer than L score 0, as in the reference
    seqs = assemble_sequences(pb, max_len=16)
    assert (got == 0).sum() == seqs.n_truncated
    assert got.max() < 0.9
    assert pe.backend.last_shape == [pe.backend.ladder.round_rows(
        len(np.unique(pb.col("trace_id_lo")))), 16]


SLICE_CASES = [("plain", 3), ("plain", 4), ("high_bit", 13),
               ("tied_starts", 15)]


@pytest.mark.parametrize("kind,seed", SLICE_CASES,
                         ids=[f"{k}-{s}" for k, s in SLICE_CASES])
def test_fused_route_matches_jax_fused_backend_and_host(engines, kind, seed):
    je, pe = engines
    jb, pb = _both(40, seed, kind)
    ref = je.backend.harvest(je.backend.dispatch_columns(
        [jax_extract(jb, JaxFeatConfig(**VOCAB))[0]]))
    got = pe.backend.harvest(pe.backend.dispatch_columns(_port_cols([pb])))
    assert got.shape == ref.shape == (len(pb),) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=F32_TOL, atol=F32_TOL)
    host = pe.backend.score(pb, featurize(pb, FeaturizerConfig(**VOCAB)))
    np.testing.assert_allclose(got, host, rtol=FUSED_RTOL, atol=FUSED_ATOL)


def test_fused_route_matches_on_truncated_traces(engines8):
    je, pe = engines8
    jb, pb = _both(30, 6, "long_trace")
    ref = je.backend.harvest(je.backend.dispatch_columns(
        [jax_extract(jb, JaxFeatConfig(**VOCAB))[0]]))
    got = pe.backend.harvest(pe.backend.dispatch_columns(_port_cols([pb])))
    np.testing.assert_allclose(got, ref, rtol=F32_TOL, atol=F32_TOL)
    host = pe.backend.score(pb, featurize(pb, FeaturizerConfig(**VOCAB)))
    np.testing.assert_allclose(got, host, rtol=FUSED_RTOL, atol=FUSED_ATOL)
    # the truncated spans score 0 on both routes, as in the reference
    truncated = assemble_sequences(pb, max_len=8).n_truncated
    assert truncated >= 40 - 8
    assert (got == 0).sum() == (host == 0).sum() == truncated


def test_fused_multi_frame_group_matches_the_host_route(engines):
    _, pe = engines
    pbs = [psynth(n, seed=s) for n, s in ((9, 21), (13, 22), (7, 23))]
    got = pe.backend.harvest(pe.backend.dispatch_columns(_port_cols(pbs)))
    fc = FeaturizerConfig(**VOCAB)
    feats = [featurize(b, fc) for b in pbs]
    merged = SpanFeatures(np.concatenate([f.categorical for f in feats]),
                          np.concatenate([f.continuous for f in feats]))
    host = pe.backend.score(concat_batches(pbs), merged)
    np.testing.assert_allclose(got, host, rtol=FUSED_RTOL, atol=FUSED_ATOL)


def test_fused_rows_follow_the_span_count_and_count_the_traces(engines):
    """The departure, pinned: R = round_rows(n) (a trace holds at least
    one span), and K13's row count is the real trace count."""
    _, pe = engines
    be = pe.backend
    pb = psynth(40, seed=3)
    be.harvest(be.dispatch_columns(_port_cols([pb])))
    n = len(pb)
    assert be.last_shape == [be.ladder.round_rows(n), 16]
    traces = len({(h, lo) for h, lo in zip(pb.col("trace_id_hi"),
                                           pb.col("trace_id_lo"))})
    assert be.last_rows_real == traces == 40


def test_started_engine_scores_through_submit_columns_and_warm_ladder():
    _, pe = _engines(warm_ladder=True)
    pe.start()
    try:
        assert pe.backend.ladder.stats()["buckets"] == [8, 16]
        pbs = [psynth(6, seed=40 + i) for i in range(3)]
        reqs = [pe.submit(b, columns=extract_columns(b)[0]) for b in pbs]
        for r, b in zip(reqs, pbs):
            assert r is not None and r.done.wait(120)
            assert r.scores.shape == (len(b),)
            assert np.isfinite(r.scores).all()
            assert ((r.scores >= 0) & (r.scores < 1)).all()
            host = pe.score_sync(b, timeout_s=120)
            np.testing.assert_allclose(r.scores, host, rtol=FUSED_RTOL,
                                       atol=FUSED_ATOL)
        assert pe.fused_calls >= 1
        assert pe.stats()["model"] == "autoencoder"
    finally:
        pe.shutdown()


def test_quantized_remote_and_mismatched_configs_are_refused():
    with pytest.raises(ValueError, match="transformer"):
        EngineConfig(model="autoencoder", quantized=True, device="cpu")
    # the remote model without a socket: the reference's refusal
    with pytest.raises(ValueError, match="socket_path"):
        ScoringEngine(EngineConfig(model="remote", device="cpu"))
    from odigos_tpu_torch.models import TransformerConfig
    with pytest.raises(ValueError, match="AutoencoderConfig"):
        ScoringEngine(EngineConfig(model="autoencoder", device="cpu",
                                   model_config=TransformerConfig()))


def test_attr_slot_autoencoder_serves_the_host_route_only():
    fc = FeaturizerConfig(attr_slots=2, **VOCAB)
    pe = ScoringEngine(EngineConfig(
        model="autoencoder", device="cpu", max_len=16, trace_bucket=8,
        featurizer=fc, model_config=AutoencoderConfig(
            **TINY, attr_slots=2, **WEIGHTS, dtype=torch.float32)))
    assert not pe.backend.supports_fused
    pb = psynth(5, seed=2)
    got = pe.backend.score(pb, featurize(pb, fc))
    assert got.shape == (len(pb),) and np.isfinite(got).all()


# ---------------------------------------------------------------- sidecar


def test_sidecar_serves_the_autoencoder_on_the_cpu(engines, tmp_path):
    je, _ = engines
    _, pe = _engines()  # a server of its own: its shutdown stops it
    sock = str(tmp_path / "score.sock")
    server = SidecarServer(pe, sock).start()
    jclient, pclient = JaxClient(sock), SidecarClient(sock)
    try:
        pclient.ping()
        for client, synth in ((jclient, jsynth), (pclient, psynth)):
            batch = synth(15, seed=31)
            got = client.score(batch)
            assert got.shape == (len(batch),)
            jb = jsynth(15, seed=31)
            ref = je.backend.score(jb, jfeaturize(jb,
                                                  JaxFeatConfig(**VOCAB)))
            np.testing.assert_allclose(got, ref, atol=F32_TOL, rtol=F32_TOL)
        assert len(pclient.score(psynth(0, seed=1))) == 0
    finally:
        jclient.close()
        pclient.close()
        server.shutdown()


def test_sidecar_parser_takes_the_autoencoder():
    args = build_parser().parse_args(["--socket", "s", "--model",
                                      "autoencoder", "--device", "cpu"])
    assert args.model == "autoencoder" and args.device == "cpu"
    with pytest.raises(SystemExit):
        build_parser().parse_args(["--socket", "s", "--model", "remote"])

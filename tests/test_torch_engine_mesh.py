"""The engine's own device mesh, against the JAX package's engine.

Mirrors ``tests/test_multichip_serving.py``. The reference engine owns a
``jax.sharding.Mesh`` over the 8 virtual CPU devices ``tests/conftest.py``
provides; the port's is SPMD: every rank of a ``DeviceMesh`` builds the
same ``ScoringEngine``, the first rank leads (the queue, coalescing and
the window) and the others follow its broadcast calls. One 4-rank gloo
spawn (``torch_parallel_ranks.engine_mesh_rank``) serves a bundle of the
reference's seed weights on ``{"data": 4}`` and ``{"data": 2, "model":
2}``:

* the config's mesh normalization and hashability (no spawn);
* one mesh, one owner: the backend holds the engine's mesh, the plan was
  built on it; the ladder's rungs are ``lcm(base, dp)``;
* the dp scores equal the port's one-device engine within ``DP_ATOL`` and
  tag the same spans; the dp x tp scores match the JAX engine on the same
  mesh within ``SCORE_ATOL`` and tag the same spans;
* zero ladder misses after ``warm_ladder``; the adaptive estimates are
  learned per mesh (a new engine on the mesh starts from them, a
  one-device engine does not);
* a mesh the world cannot back serves one device and is counted; a mesh
  with ``quantized=True`` is refused; with columns the fused route falls
  back with reason ``"backend"``;
* a follower's ``submit`` raises, and every rank shuts down cleanly;
* the autoencoder on ``{"data": 4}`` scores as the one-device engine; on
  ``{"data": 2, "model": 2}`` (its decoder FFN and vocabulary heads on
  the model axis), serving a bundle of the JAX engine's weights, it
  matches the JAX engine on the same mesh within ``SCORE_ATOL`` and tags
  the same spans;
* a mesh of three of the four ranks: the fourth rank's engine raises
  "this rank holds no coordinate of the engine's mesh".
"""

import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odigos_tpu.features import featurize as jfeaturize
from odigos_tpu.models import TraceTransformer as JTraceTransformer
from odigos_tpu.models import TransformerConfig as JTransformerConfig
from odigos_tpu.models.autoencoder import AutoencoderConfig as JAEConfig
from odigos_tpu.pdata import synthesize_traces as jsynth
from odigos_tpu.serving.engine import EngineConfig as JEngineConfig
from odigos_tpu.serving.engine import ScoringEngine as JEngine
from odigos_tpu_torch.models import (AutoencoderConfig, TransformerConfig,
                                     flax_autoencoder_to_torch,
                                     flax_to_torch)
from odigos_tpu_torch.parallel.launch import spawn
from odigos_tpu_torch.pdata import synthesize_traces as psynth
from odigos_tpu_torch.serving.engine import (BucketLadder, EngineConfig,
                                             ScoringEngine, _mesh_label)
from odigos_tpu_torch.training.checkpoint import save_bundle

import jax
import torch_parallel_ranks as ranks

torch.set_num_threads(1)

SCORE_ATOL = 2e-5   # the reference's sharded-scoring bound
DP_ATOL = 1e-6      # rows split over ranks: the same per-row program
THRESHOLD = 0.5
TINY = dict(d_model=32, n_heads=4, n_layers=1, d_ff=64, max_len=16)
BATCHES = ((20, 3), (6, 7), (3, 11))  # (traces, seed)
SPAWN_TIMEOUT = 240.0
BUCKET, RUNGS = 6, 3  # rungs 6 (dp 4: 12), 12, 24: every call warm
AE = dict(d_model=32, d_latent=16, n_heads=2, n_layers=1, d_ff=64,
          max_len=16, dtype=torch.float32)
# the autoencoder on the model axis: the loss weights scaled down so that
# the squashed scores spread (random weights put every error near 20)
AE_TP = dict(d_model=32, d_latent=16, n_heads=2, n_layers=1, d_ff=64,
             max_len=16, w_service=0.05, w_name=0.05, w_kind=0.02,
             w_duration=0.01)


# ------------------------------------------------------------- the config
def test_engine_config_mesh_normalization_and_hashability():
    c = EngineConfig(model="transformer", mesh={"data": 4, "model": 2})
    assert c.mesh == (("data", 4), ("model", 2))
    assert c.mesh_shape() == {"data": 4, "model": 2}
    hash(c)
    assert EngineConfig(model="transformer", mesh=(("data", 2),)).mesh == \
        (("data", 2),)
    assert EngineConfig(model="transformer", data_parallel=4).mesh == \
        (("data", 4),)
    assert EngineConfig(mesh={"data": 1, "model": 1}).mesh is None
    assert EngineConfig(data_parallel=1).mesh is None
    assert EngineConfig(mesh={"data": 2}, data_parallel=8).mesh == \
        (("data", 2),)
    assert EngineConfig().mesh_shape() is None
    with pytest.raises(ValueError, match="positive"):
        EngineConfig(mesh={"data": 4, "model": 0})
    # the reference normalizes the same specs to the same tuples
    for spec in ({"data": 4, "model": 2}, (("data", 2),), {"data": 1}):
        assert EngineConfig(mesh=spec).mesh == JEngineConfig(mesh=spec).mesh
    assert _mesh_label((("data", 4), ("model", 2))) == "data4xmodel2"
    assert _mesh_label(None) == "single"


def test_bucket_ladder_aligns_rungs_to_the_data_axis():
    lad = BucketLadder(base=6, n_buckets=3, align=4)
    assert lad.base == 12 and lad.buckets == [12, 24, 48]
    assert lad.round_rows(100) % 4 == 0 and lad.floor_rows(100) % 4 == 0
    assert lad.stats()["align"] == 4
    assert BucketLadder(8).stats()["align"] == 1


def test_a_one_device_engine_has_no_mesh():
    eng = ScoringEngine(EngineConfig(model="transformer", device="cpu",
                                     model_config=TransformerConfig(
                                         dtype=torch.float32, **TINY),
                                     max_len=16, trace_bucket=4))
    assert eng.mesh is None and eng.backend._plan is None
    assert not eng.is_follower
    assert eng.stats()["adaptive"]["mesh"] == "single"
    assert "mesh" not in eng.stats()
    # zscore and mock take no mesh
    assert ScoringEngine(EngineConfig(model="mock", device="cpu",
                                      mesh={"data": 2})).mesh is None


# ------------------------------------------------------ four gloo ranks
@pytest.fixture(scope="module")
def mesh_case():
    jcfg = JTransformerConfig(dtype=jnp.float32, **TINY)
    variables = jax.tree_util.tree_map(
        np.asarray, JTraceTransformer(jcfg).init(jax.random.PRNGKey(0)))
    cfg = TransformerConfig(dtype=torch.float32, **TINY)
    jae = JEngine(JEngineConfig(
        model="autoencoder", model_config=JAEConfig(dtype=jnp.float32,
                                                    **AE_TP),
        mesh={"data": 2, "model": 2}, max_len=16, trace_bucket=BUCKET,
        bucket_ladder=RUNGS, seed=0))
    acfg = AutoencoderConfig(dtype=torch.float32, **AE_TP)
    with tempfile.TemporaryDirectory() as tmp:
        bundle = save_bundle(tmp + "/bundle", flax_to_torch(variables, cfg),
                             model="transformer", model_config=cfg)
        ae_bundle = save_bundle(
            tmp + "/ae", flax_autoencoder_to_torch(jax.tree_util.tree_map(
                np.asarray, jae.backend.variables), acfg),
            model="autoencoder", model_config=acfg)
        batches = [psynth(n, seed=s) for n, s in BATCHES]
        got = spawn(ranks.engine_mesh_rank, 4, device="cpu",
                    args=(bundle, batches, 16, BUCKET, RUNGS, AE, ae_bundle),
                    timeout=SPAWN_TIMEOUT)
        one = ScoringEngine(EngineConfig(
            model="transformer", checkpoint_path=bundle, max_len=16,
            trace_bucket=BUCKET, bucket_ladder=RUNGS, device="cpu")).start()
        try:
            single = [one.score_sync(b, timeout_s=120.0) for b in batches]
        finally:
            one.shutdown()
        ae_one = ScoringEngine(EngineConfig(
            model="autoencoder", max_len=16, trace_bucket=BUCKET,
            bucket_ladder=RUNGS, device="cpu",
            model_config=AutoencoderConfig(**AE))).start()
        try:
            ae_single = [ae_one.score_sync(b, timeout_s=120.0)
                         for b in batches]
        finally:
            ae_one.shutdown()
    jeng = JEngine(JEngineConfig(
        model="transformer", model_config=jcfg, mesh={"data": 2, "model": 2},
        max_len=16, trace_bucket=BUCKET, bucket_ladder=RUNGS,
        seed=0)).start()
    try:
        jscores = []
        for n, s in BATCHES:
            b = jsynth(n, seed=s)
            jscores.append(jeng.score_sync(b, jfeaturize(b), timeout_s=120.0))
    finally:
        jeng.shutdown()
    jae.start()
    try:
        jae_scores = []
        for n, s in BATCHES:
            b = jsynth(n, seed=s)
            jae_scores.append(jae.score_sync(b, jfeaturize(b),
                                             timeout_s=120.0))
    finally:
        jae.shutdown()
    return got, single, jscores, ae_single, jae_scores


def _leader(got):
    (lead,) = [r for r in got if not r["dp"]["follower"]]
    assert lead["rank"] == 0
    return lead


def _same_tags(a, b):
    assert not np.any(np.abs(b - THRESHOLD) < 1e-5), "threshold too close"
    np.testing.assert_array_equal(a > THRESHOLD, b > THRESHOLD)


@pytest.mark.parametrize("key,shape,dp", [
    ("dp", {"data": 4}, 4), ("tp", {"data": 2, "model": 2}, 2)])
def test_one_mesh_one_owner_and_aligned_rungs(mesh_case, key, shape, dp):
    for r in mesh_case[0]:
        m = r[key]
        assert m["owner"] and m["mesh_shape"] == shape
        assert m["align"] == dp
        assert all(b % dp == 0 for b in m["buckets"])
        assert m["buckets"][0] == int(np.lcm(BUCKET, dp))


def test_dp_scores_match_the_one_device_engine_with_the_same_tags(mesh_case):
    got, single = mesh_case[:2]
    lead = _leader(got)["dp"]
    for s, ref in zip(lead["scores"], single):
        assert s is not None and s.shape == ref.shape
        np.testing.assert_allclose(s, ref, atol=DP_ATOL, rtol=0)
        _same_tags(s, ref)


def test_the_autoencoder_serves_on_the_data_axis(mesh_case):
    got, ae_single = mesh_case[0], mesh_case[3]
    for s, ref in zip(_leader(got)["ae_scores"], ae_single):
        assert s is not None and s.shape == ref.shape
        np.testing.assert_allclose(s, ref, atol=DP_ATOL, rtol=0)


def test_the_autoencoder_on_dp_x_tp_matches_the_jax_engine(mesh_case):
    """The autoencoder engine on ``{"data": 2, "model": 2}`` against the JAX
    engine on the same mesh and weights: the squashed scores within
    ``SCORE_ATOL``, and the same spans tagged at a threshold between two
    of the reference's scores (the middle widest gap)."""
    got, jae_scores = mesh_case[0], mesh_case[4]
    for r in got:
        assert r["ae_tp_runner"] == (2, 256)  # the service head's rows
    ref_all = np.concatenate(jae_scores)
    vals = np.unique(ref_all)
    mid = vals[len(vals) // 4:3 * len(vals) // 4 + 1]
    gaps = np.diff(mid)
    thr = float(mid[gaps.argmax()] + gaps.max() / 2)
    assert gaps.max() / 2 > 2 * SCORE_ATOL
    assert 0.05 < (ref_all > thr).mean() < 0.95
    for s, ref in zip(_leader(got)["ae_tp_scores"], jae_scores):
        assert s is not None and s.shape == ref.shape
        np.testing.assert_allclose(s, ref, atol=SCORE_ATOL, rtol=0)
        np.testing.assert_array_equal(s > thr, ref > thr)


def test_a_rank_outside_the_engine_s_mesh_is_refused(mesh_case):
    for r in mesh_case[0]:
        if r["rank"] < 3:
            assert r["prefix"] == "", r["prefix"]
        else:
            assert r["prefix"].startswith("ValueError")
            assert "this rank holds no coordinate of the engine's mesh" in \
                r["prefix"]


def test_dp_tp_scores_match_the_jax_engine_with_the_same_tags(mesh_case):
    got, jscores = mesh_case[0], mesh_case[2]
    lead = _leader(got)["tp"]
    for s, ref in zip(lead["scores"], jscores):
        assert s is not None and s.shape == ref.shape
        np.testing.assert_allclose(s, ref, atol=SCORE_ATOL, rtol=0)
        _same_tags(s, ref)


@pytest.mark.parametrize("key", ["dp", "tp"])
def test_zero_ladder_misses_after_warm(mesh_case, key):
    m = _leader(mesh_case[0])[key]
    assert m["misses_after_warm"] == 0
    assert m["misses"] == 0 and m["hits"] >= 2 * len(BATCHES)


@pytest.mark.parametrize("key,label", [("dp", "data4"),
                                       ("tp", "data2xmodel2")])
def test_adaptive_estimates_are_learned_per_mesh(mesh_case, key, label):
    m = _leader(mesh_case[0])[key]
    assert m["learned"] and m["prior"]
    assert m["stats_mesh"][0] == label
    assert m["stats_mesh"][1] == dict(
        {"dp": (("data", 4),), "tp": (("data", 2), ("model", 2))}[key])
    # a one-device engine keeps its cold start
    eng = ScoringEngine(EngineConfig(
        model="transformer", device="cpu", max_len=16, trace_bucket=4,
        model_config=TransformerConfig(dtype=torch.float32, **TINY)))
    assert eng._ms_per_span() is None


def test_an_unbackable_mesh_serves_one_device_and_is_counted(mesh_case):
    for r in mesh_case[0]:
        no_mesh, no_plan, align, counted, label = r["unbackable"]
        assert no_mesh and no_plan and align == 1
        assert counted == 1 and label == "single"


def test_a_quantized_mesh_is_refused(mesh_case):
    for r in mesh_case[0]:
        assert r["quantized"].startswith("ValueError")
        assert "does not compose with a device mesh" in r["quantized"]


@pytest.mark.parametrize("key", ["dp", "tp"])
def test_the_fused_route_falls_back_with_reason_backend(mesh_case, key):
    m = _leader(mesh_case[0])[key]
    assert m["fused_calls"] == 0
    assert m["fallback_backend"] == len(BATCHES)
    for s, ref in zip(m["col_scores"], m["scores"]):
        np.testing.assert_array_equal(s, ref)


@pytest.mark.parametrize("key", ["dp", "tp"])
def test_followers_refuse_submit_and_every_rank_shuts_down(mesh_case, key):
    got = mesh_case[0]
    followers = [r[key] for r in got if r[key]["follower"]]
    assert len(followers) == 3
    for m in followers:
        assert m["submit"].startswith("RuntimeError")
        assert "submit on its leader, rank 0" in m["submit"]
    for r in got:
        assert not r[key]["loop_alive"]

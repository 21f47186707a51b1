"""The port's engine and sidecar on the CPU, against the JAX package's.

The port's ``SidecarServer`` (``device="cpu"``) is driven by the JAX
package's ``SidecarClient`` over the same wire protocol, and its scores
match the JAX engine's on the same weights within the f32 bound (1e-5:
the two forwards compute the same f32 arithmetic in another summation
order). The port's client also talks to the JAX package's server. The
engine contract is pinned too: coalescing, the bounded queue, deadline
pass-through, the lossless shutdown drain, the warmed ladder.
"""

import os
import tempfile
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odigos_tpu.models.transformer import TransformerConfig as JaxConfig
from odigos_tpu.pdata import synthesize_traces as jsynth
from odigos_tpu.serving.engine import EngineConfig as JaxEngineConfig
from odigos_tpu.serving.engine import ScoringEngine as JaxEngine
from odigos_tpu.serving.sidecar import SidecarClient as JaxClient
from odigos_tpu.serving.sidecar import SidecarServer as JaxServer
from odigos_tpu_torch.models import TransformerConfig, flax_to_torch
from odigos_tpu_torch.pdata import synthesize_traces as psynth
from odigos_tpu_torch.serving import (EngineConfig, ScoringEngine,
                                      SidecarClient, SidecarServer)
from odigos_tpu_torch.serving.sidecar import build_parser, main

torch.set_num_threads(1)

SMALL = dict(d_model=64, n_heads=2, n_layers=2, d_ff=128, max_len=16)
F32_TOL = 1e-5


def _port_engine(**kw) -> ScoringEngine:
    cfg = dict(model="transformer",
               model_config=TransformerConfig(**SMALL, dtype=torch.float32),
               max_len=16, trace_bucket=8, device="cpu")
    cfg.update(kw)
    return ScoringEngine(EngineConfig(**cfg))


@pytest.fixture(scope="module")
def engines():
    """A JAX engine and a port engine holding the same f32 weights."""
    je = JaxEngine(JaxEngineConfig(
        model="transformer", max_len=16, trace_bucket=8,
        model_config=JaxConfig(**SMALL, dtype=jnp.float32)))
    pe = _port_engine(warm_ladder=True)
    pe.backend.model.load_state_dict(flax_to_torch(
        jax.tree_util.tree_map(np.asarray, je.backend.variables),
        pe.backend.model.cfg))
    je.start()
    yield je, pe
    je.shutdown()
    pe.shutdown()


@pytest.fixture
def sock_path():
    with tempfile.TemporaryDirectory() as d:
        yield os.path.join(d, "score.sock")


@pytest.mark.parametrize("n_traces,seed", [(1, 0), (12, 1), (60, 2)])
def test_port_engine_matches_jax_engine(engines, n_traces, seed):
    je, pe = engines
    pe.start()
    batch = jsynth(n_traces, seed=seed)
    ref = je.score_sync(batch, timeout_s=120)
    got = pe.score_sync(psynth(n_traces, seed=seed), timeout_s=120)
    assert ref is not None and got is not None
    assert got.shape == (len(batch),) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=F32_TOL, rtol=F32_TOL)


def test_port_sidecar_driven_by_jax_client(engines, sock_path):
    je, pe = engines
    server = SidecarServer(pe, sock_path).start()
    client = JaxClient(sock_path)
    try:
        client.ping()
        client.warmup(jsynth(4, seed=9))
        for n, seed in ((3, 3), (40, 4), (0, 5)):
            batch = jsynth(n, seed=seed)
            got = client.score(batch)
            assert got.shape == (len(batch),)
            if len(batch):
                ref = je.score_sync(batch, timeout_s=120)
                np.testing.assert_allclose(got, ref, atol=F32_TOL,
                                           rtol=F32_TOL)
    finally:
        client.close()
        server.shutdown()


def test_port_client_talks_to_jax_sidecar(engines, sock_path):
    _, pe = engines
    # a server of its own (its shutdown stops its engine); the same
    # config and seed give the same weights as the shared JAX engine
    server = JaxServer(JaxEngine(JaxEngineConfig(
        model="transformer", max_len=16, trace_bucket=8,
        model_config=JaxConfig(**SMALL, dtype=jnp.float32))),
        sock_path).start()
    client = SidecarClient(sock_path)
    try:
        client.ping()
        batch = psynth(10, seed=6)
        got = client.score(batch)
        pe.start()
        ref = pe.score_sync(batch, timeout_s=120)
        np.testing.assert_allclose(got, ref, atol=F32_TOL, rtol=F32_TOL)
    finally:
        client.close()
        server.shutdown()


def test_sidecar_reports_errors_and_unknown_ops(sock_path):
    pe = _port_engine()
    server = SidecarServer(pe, sock_path).start()
    client = SidecarClient(sock_path)
    try:
        with pytest.raises(RuntimeError, match="unknown op"):
            client.request(7)
        with pytest.raises(RuntimeError, match="sidecar error"):
            client.request(0, b"\x00\x00\x00\x00not a frame")
        client.ping()  # the connection survives both
    finally:
        client.close()
        server.shutdown()


def test_coalesced_requests_score_like_single_ones():
    pe = _port_engine()
    batches = [psynth(5 + i, seed=20 + i) for i in range(4)]
    singles = [pe.backend.score(b, _feats(pe, b)) for b in batches]
    reqs = [pe.submit(b) for b in batches]  # queued before the worker runs
    pe.start()
    try:
        for r, s in zip(reqs, singles):
            assert r.done.wait(60)
            np.testing.assert_allclose(r.scores, s, atol=F32_TOL,
                                       rtol=F32_TOL)
        assert pe.device_calls == 1  # one coalesced device call
    finally:
        pe.shutdown()


def _feats(pe, batch):
    from odigos_tpu_torch.features import featurize

    return featurize(batch, pe.cfg.featurizer)


def test_queue_bound_timeout_and_lossless_drain():
    pe = _port_engine(max_queue=2)
    a = pe.submit(psynth(3, seed=1))
    assert a is not None
    late = psynth(3, seed=2)
    # no worker yet: the deadline passes and the caller passes through
    assert pe.score_sync(late, timeout_s=0.01) is None
    assert pe.stats()["passthrough_spans"] == len(late)
    assert pe.submit(psynth(3, seed=3)) is None        # queue full
    pe.start()
    pe.shutdown()                                      # drains both
    assert a.done.is_set() and a.scores is not None
    assert pe.stats()["device_calls"] == 1             # coalesced pair
    assert pe.submit(psynth(3, seed=5)) is None        # shut down
    assert pe.stats()["rejected"] == 2


def test_warm_ladder_serves_warm_shapes():
    pe = _port_engine(warm_ladder=True, bucket_ladder=3)
    pe.start()
    try:
        assert pe.score_sync(psynth(6, seed=7), timeout_s=60) is not None
        ladder = pe.stats()["bucket_ladder"]
        assert ladder["buckets"] == [8, 16, 32]
        assert ladder["hits"] == 1 and ladder["misses"] == 0
    finally:
        pe.shutdown()


def test_concurrent_submitters_all_get_their_scores():
    pe = _port_engine(max_queue=64)
    pe.start()
    out = {}

    def worker(i):
        b = psynth(4, seed=100 + i)
        out[i] = (len(b), pe.score_sync(b, timeout_s=120))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    pe.shutdown()
    assert not any(t.is_alive() for t in threads)
    for n, scores in out.values():
        assert scores is not None and scores.shape == (n,)
        assert np.isfinite(scores).all()
        assert ((scores >= 0) & (scores <= 1)).all()


def test_unported_models_and_missing_card_raise(sock_path):
    # zscore (the default, as in the JAX package), mock, the autoencoder
    # and the remote model are ported; remote without a socket is refused
    # as in the reference
    assert EngineConfig(model="zscore").model == EngineConfig().model
    EngineConfig(model="mock")
    EngineConfig(model="autoencoder")
    with pytest.raises(ValueError, match="socket_path"):
        ScoringEngine(EngineConfig(model="remote"))
    with pytest.raises(ValueError, match="unknown scoring model"):
        EngineConfig(model="nope")
    assert EngineConfig().device == "cuda"
    assert build_parser().parse_args(["--socket", "s"]).model == "zscore"
    assert build_parser().parse_args(["--socket", "s"]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this pins the no-card path")
    with pytest.raises(RuntimeError, match="is_available"):
        ScoringEngine(EngineConfig(
            model="transformer", model_config=TransformerConfig(**SMALL)))
    with pytest.raises(RuntimeError, match="is_available"):
        main(["--socket", sock_path])
    assert not os.path.exists(sock_path)

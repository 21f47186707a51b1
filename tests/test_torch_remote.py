"""The JAX package's stock collector scoring through the port's sidecar.

The seam that moves a stock deployment's scoring onto the card: the
``tpuanomaly`` processor with ``model: remote`` and a ``socket_path``
(``odigos_tpu/serving/sidecar.py`` ``RemoteBackend``) talks to any OTS1
sidecar, the port's included. Here the port's sidecar serves the default
model, zscore, on the CPU (the plain versions of K3 and K4), behind the e2e
pipeline of ``tests/test_anomaly_e2e.py``, and tags the same spans as the
same pipeline scoring with the JAX package's own ``model: zscore``.

The two states are not the same fold for fold: through the remote seam the
collector's warm-up reaches the sidecar twice (``RemoteBackend.warmup``
sends WARMUP, which folds the batch in twice on the sidecar like any
engine's warm-up, then the engine scores it, which folds it once more), so
the detector has seen the warm-up batch three times against the local
engine's two. The means are the same, and the variances differ by a factor
of ``3n/(3n-1)`` against ``2n/(2n-1)``; tags are compared away from the
threshold, ``|score - 0.6| > TAG_MARGIN``.

The receivers are drained before the warm-up so that their two batches are
scored (cold) before it in both runs — the order is otherwise a race
between the receiver thread and the warm-up.

The port's own ``EngineConfig(model="remote", socket_path=...)``
(``serving/sidecar.py`` ``RemoteBackend``) scores through a port sidecar
serving a small transformer on the CPU exactly as the sidecar's engine
scores the same batches itself; a short reply raises and fails its group,
a dead socket is counted under ``odigos_sidecar_client_errors_total`` and
passes through, and a remote engine without ``socket_path`` is refused as
the reference refuses it.
"""

import os
import tempfile

import numpy as np
import pytest
import torch

from odigos_tpu.components.processors.tpuanomaly import (
    FLAG_ATTR, SCORE_ATTR, TpuAnomalyProcessor)
from odigos_tpu.pdata import synthesize_traces as jsynth
from odigos_tpu.pipeline import Collector
from odigos_tpu.serving.engine import EngineConfig as JaxEngineConfig
from odigos_tpu.serving.engine import ScoringEngine as JaxEngine
from odigos_tpu.serving.sidecar import SidecarClient as JaxClient
from odigos_tpu_torch.models import TransformerConfig
from odigos_tpu_torch.pdata import synthesize_traces as psynth
from odigos_tpu_torch.serving.fused import extract_columns
from odigos_tpu_torch.serving.sidecar import REMOTE_ERRORS_METRIC
from odigos_tpu_torch.utils.telemetry import meter
from odigos_tpu_torch.serving import (EngineConfig, ScoringEngine,
                                      SidecarClient, SidecarServer)
from tests.test_anomaly_e2e import e2e_config, spike_batch

torch.set_num_threads(1)

THRESHOLD = 0.6
# the remote and the local run's scores differ by the fold count alone:
# 8.5e-4 at most on this stream (measured on the CPU), a twelfth of this
TAG_MARGIN = 0.01


@pytest.fixture
def port_sidecar():
    """The port's sidecar serving zscore on the CPU on a fresh socket."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "score.sock")
        engine = ScoringEngine(EngineConfig(model="zscore", device="cpu",
                                            warm_ladder=True))
        server = SidecarServer(engine, path).start()
        try:
            yield path, engine
        finally:
            server.shutdown()


def _run(processor_cfg):
    """The e2e slice with one tpuanomaly config: every scored span's score
    by (trace id, span id), the exported spans of both pipelines, and the
    spiked span's key."""
    scores: dict = {}
    with Collector(e2e_config(processor_cfg)) as c:
        proc = c.component("tpuanomaly")
        assert isinstance(proc, TpuAnomalyProcessor)
        score_sync = proc.engine.score_sync

        def recording(batch, features=None, timeout_s=0.005):
            out = score_sync(batch, features, timeout_s=timeout_s)
            assert out is not None, "scoring passed through (timeout)"
            for i, s in enumerate(out):
                d = batch.span_dict(i)
                scores[(d["trace_id"], d["span_id"])] = float(s)
            return out

        proc.engine.score_sync = recording
        c.drain_receivers()
        proc.engine.warmup(jsynth(400, seed=7))
        spiked, i = spike_batch()
        c.graph.pipeline_entries["traces/in"].consume(spiked)
        c.drain_receivers()
        anomaly = c.component("debug/anomaly").all_spans()
        normal = c.component("debug/normal").all_spans()
        d = spiked.span_dict(i)
        return scores, anomaly, normal, spiked, (d["trace_id"], d["span_id"])


def _tagged(spans) -> set:
    return {(d["trace_id"], d["span_id"]) for d in spans
            if FLAG_ATTR in d["attributes"]}


def test_stock_collector_scores_through_the_port_sidecar(port_sidecar):
    path, engine = port_sidecar
    remote = _run({"model": "remote", "socket_path": path,
                   "threshold": THRESHOLD, "timeout_ms": 3000,
                   "shared_engine": False})
    local = _run({"model": "zscore", "threshold": THRESHOLD,
                  "timeout_ms": 3000, "shared_engine": False})
    r_scores, r_anomaly, r_normal, spiked, spike_key = remote
    l_scores, l_anomaly, l_normal, _, _ = local
    # the port scored every span on its own engine, serially
    assert engine.stats()["pipeline_depth"] == 1
    assert engine.stats()["errors"] == 0
    # the spiked trace reached debug/anomaly whole, its span tagged
    assert r_scores[spike_key] >= THRESHOLD
    assert spike_key in _tagged(r_anomaly)
    trace = spike_key[0]
    want = sum(1 for d in spiked.iter_spans() if d["trace_id"] == trace)
    assert sum(1 for d in r_anomaly if d["trace_id"] == trace) == want
    assert all(s["attributes"][SCORE_ATTR] >= THRESHOLD for s in r_anomaly
               if FLAG_ATTR in s["attributes"])
    # the same spans were scored, and tagged alike away from the threshold
    assert r_scores.keys() == l_scores.keys()
    away = {k for k in r_scores
            if abs(r_scores[k] - THRESHOLD) > TAG_MARGIN
            and abs(l_scores[k] - THRESHOLD) > TAG_MARGIN}
    tagged_r = _tagged(r_anomaly) | _tagged(r_normal)
    tagged_l = _tagged(l_anomaly) | _tagged(l_normal)
    assert tagged_r & away == tagged_l & away
    assert tagged_r & away  # the comparison is not vacuous
    diff = max(abs(r_scores[k] - l_scores[k]) for k in r_scores)
    assert diff < TAG_MARGIN, diff


def test_jax_client_warms_and_scores_the_port_zscore_sidecar(port_sidecar):
    """WARMUP over the wire fits the port's detector as the engine's
    warm-up does; SCORE then answers like an in-process engine fed the same
    traffic."""
    path, engine = port_sidecar
    ref = ScoringEngine(EngineConfig(model="zscore", device="cpu"))
    client = JaxClient(path)
    try:
        client.warmup(jsynth(200, seed=7))
        ref.warmup(psynth(200, seed=7))
        for n, seed in ((30, 1), (0, 2), (70, 3)):
            got = client.score(jsynth(n, seed=seed))
            b = psynth(n, seed=seed)
            want = ref.backend.score(b, _features(b))
            assert got.shape == (len(b),)
            np.testing.assert_array_equal(got, want)
    finally:
        client.close()
    assert torch.equal(engine.backend.det.state.count,
                       ref.backend.det.state.count)


def test_port_client_drives_the_port_zscore_sidecar(port_sidecar):
    path, engine = port_sidecar
    client = SidecarClient(path)
    try:
        client.ping()
        got = client.score(psynth(5, seed=9))
        # no warm-up: every group is cold and scores 0
        assert got.shape == (len(psynth(5, seed=9)),) and not got.any()
    finally:
        client.close()
    assert engine.stats()["odigos_anomaly_cold_spans_total"] == len(got)


def _features(batch):
    from odigos_tpu_torch.features import featurize

    return featurize(batch)


SMALL = dict(d_model=64, n_heads=2, n_layers=2, d_ff=128, max_len=16)
ERRORS_METRIC = "odigos_anomaly_engine_errors_total"


@pytest.fixture
def transformer_sidecar():
    """A port sidecar serving a small f32 transformer on the CPU."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "score.sock")
        engine = ScoringEngine(EngineConfig(
            model="transformer", device="cpu", max_len=16, trace_bucket=8,
            model_config=TransformerConfig(**SMALL, dtype=torch.float32)))
        server = SidecarServer(engine, path, score_timeout_s=60.0).start()
        try:
            yield path, engine, server
        finally:
            server.shutdown()


def test_port_remote_engine_scores_as_the_sidecar_engine(
        transformer_sidecar):
    path, side, _ = transformer_sidecar
    remote = ScoringEngine(EngineConfig(model="remote", socket_path=path,
                                        remote_timeout_s=60.0)).start()
    try:
        st = remote.stats()
        assert st["device"] == "remote" and st["pipeline_depth"] == 1
        remote.warmup(psynth(20, seed=1))  # WARMUP over the wire
        for n, seed in ((3, 1), (12, 2), (40, 3)):
            b = psynth(n, seed=seed)
            req = remote.submit(b)
            assert req.features is None  # the sidecar featurizes
            assert req.done.wait(60)
            want = side.score_sync(b, timeout_s=60)
            assert req.scores is not None and want is not None
            np.testing.assert_array_equal(req.scores, want)
        # a columns-carrying request takes the host route over the wire
        b = psynth(6, seed=4)
        req = remote.submit(b, columns=extract_columns(b)[0])
        assert req.done.wait(60)
        np.testing.assert_array_equal(req.scores,
                                      side.score_sync(b, timeout_s=60))
        assert remote.stats()["errors"] == 0
    finally:
        remote.shutdown()


def test_a_short_reply_raises_and_fails_its_group(transformer_sidecar,
                                                  monkeypatch):
    path, _, _ = transformer_sidecar
    remote = ScoringEngine(EngineConfig(model="remote", socket_path=path))
    b = psynth(4, seed=5)
    real = remote.backend.client.score
    monkeypatch.setattr(remote.backend.client, "score",
                        lambda batch, timeout_s: real(batch, timeout_s)[:-1])
    with pytest.raises(RuntimeError, match="sidecar returned"):
        remote.backend.score(b, None)
    e0 = meter.counter(ERRORS_METRIC)
    remote.start()
    try:
        assert remote.score_sync(b, timeout_s=60) is None
    finally:
        remote.shutdown()
    assert remote.stats()["errors"] == 1
    assert meter.counter(ERRORS_METRIC) == e0 + 1


def test_a_dead_socket_is_counted_and_passes_through(transformer_sidecar):
    path, _, server = transformer_sidecar
    remote = ScoringEngine(EngineConfig(model="remote", socket_path=path,
                                        remote_timeout_s=10.0))
    remote.backend.client.connect_timeout_s = 0.2
    remote.start()
    try:
        assert remote.score_sync(psynth(3, seed=6), timeout_s=60) \
            is not None
        server.shutdown()  # the sidecar dies
        c0 = meter.counter(REMOTE_ERRORS_METRIC)
        e0 = remote.stats()["errors"]
        for seed in (7, 8):
            assert remote.score_sync(psynth(3, seed=seed),
                                     timeout_s=60) is None
        assert meter.counter(REMOTE_ERRORS_METRIC) == c0 + 2
        assert remote.stats()["errors"] == e0 + 2
    finally:
        remote.shutdown()


def test_remote_without_a_socket_is_refused_like_the_reference():
    for eng_cls, cfg_cls in ((JaxEngine, JaxEngineConfig),
                             (ScoringEngine, EngineConfig)):
        with pytest.raises(ValueError, match="requires socket_path"):
            eng_cls(cfg_cls(model="remote"))

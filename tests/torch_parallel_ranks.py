"""Rank functions for ``tests/test_torch_parallel.py``.

``parallel.launch.spawn`` starts each rank in a fresh interpreter that
imports the rank function's module; this one imports nothing of JAX (the
test module does, and eight children importing it would pay for JAX eight
times). Each function runs on one gloo rank of the CPU and returns numpy
arrays and plain values.
"""

import numpy as np
import torch
import torch.distributed as dist


def _raises(fn) -> str:
    try:
        fn()
    except (ValueError, RuntimeError) as e:
        return f"{type(e).__name__}: {e}"
    return ""


def ring_rank(q, k, v, mask, masked_inputs, mesh_cases=False):
    """The port's ring attention on a ``{"seq": n}`` mesh of every rank,
    on the reference's inputs and on its all-masked input; the refusal of
    a length that is not a multiple of n; with ``mesh_cases``, then
    :func:`mesh_rank`'s on the same world."""
    from odigos_tpu_torch.parallel import (gather_seq, make_mesh,
                                           ring_attention, shard_seq)

    mesh = make_mesh({"seq": dist.get_world_size()}, axes=("seq",),
                     device="cpu")

    def run(q, k, v, mask):
        parts = (shard_seq(torch.from_numpy(t), mesh) for t in (q, k, v, mask))
        return gather_seq(ring_attention(*parts, mesh), mesh).numpy()

    n = dist.get_world_size()
    odd = torch.zeros((1, 4 * n + 1, 1, 4))
    out = {"out": run(q, k, v, mask), "masked": run(*masked_inputs),
           "uneven": _raises(lambda: shard_seq(odd, mesh))}
    if mesh_cases:
        out["mesh"] = mesh_rank()
    return out


def mesh_rank():
    """``make_mesh`` on 8 ranks: the default shape, a prefix of the ranks,
    a shape that needs more; on a ``"model"`` axis of 2 the transformer's
    and the autoencoder's entry points built (the transformer's shard for
    the train step)."""
    from odigos_tpu_torch.models import (AutoencoderConfig, SpanAutoencoder,
                                         TraceTransformer, TransformerConfig)
    from odigos_tpu_torch.parallel import (make_mesh, make_sharded_score_fn,
                                           make_sharded_train_step, mesh_key,
                                           shard_model)

    full = make_mesh(device="cpu")
    prefix = make_mesh({"data": 3, "model": 2}, device="cpu")
    needs = _raises(lambda: make_mesh({"data": 3, "model": 3}, device="cpu"))
    tp = make_mesh({"data": 4, "model": 2}, device="cpu")
    model = TraceTransformer(TransformerConfig(
        d_model=16, n_heads=2, n_layers=1, d_ff=32, max_len=8,
        dtype=torch.float32), device="cpu")
    shard = shard_model(model, tp)
    opt = torch.optim.Adam(shard.parameters(), lr=1e-3)
    ae = SpanAutoencoder(AutoencoderConfig(
        d_model=16, d_latent=8, n_heads=2, n_layers=1, d_ff=32, max_len=8,
        dtype=torch.float32), device="cpu")
    return {"full": (mesh_key(full), dict(zip(full.mesh_dim_names,
                                               full.mesh.shape))),
            "prefix": (prefix.mesh.numel(), prefix.get_coordinate(),
                       mesh_key(prefix)),
            "needs": needs,
            "tp_shard": (shard.model_axis.tp, shard.model_axis.shards,
                         shard.module.encoder.blocks[0].n_heads),
            "tp_step": _raises(lambda: make_sharded_train_step(shard, opt,
                                                               tp)),
            "tp_score": _raises(lambda: make_sharded_score_fn(model, tp)),
            "ae_score": _raises(lambda: make_sharded_score_fn(ae, tp))}


def dp_rank(cfg_kwargs, state, score_inputs, train_inputs, steps, lr):
    """Data-parallel scoring and ``steps`` train steps on a ``{"data":
    n}`` mesh of every rank, from the given weights: the scores of each
    score input, each step's loss, the first step's gradients and the
    final parameters."""
    from odigos_tpu_torch.models import TraceTransformer, TransformerConfig
    from odigos_tpu_torch.parallel import (make_mesh, make_sharded_score_fn,
                                           make_sharded_train_step)

    cfg = TransformerConfig(dtype=torch.float32, **cfg_kwargs)
    model = TraceTransformer(cfg, device="cpu")
    model.load_state_dict(state)
    mesh = make_mesh({"data": dist.get_world_size()}, axes=("data",),
                     device="cpu")
    score = make_sharded_score_fn(model, mesh)
    scores = [tuple(t.numpy() for t in score(*args)) for args in score_inputs]
    opt = torch.optim.Adam(model.module.parameters(), lr=lr)
    step = make_sharded_train_step(model, opt, mesh)
    losses = [float(step(*train_inputs))]
    # the first step's gradients, as all-reduced and stepped on
    grads = {name: p.grad.numpy().copy()
             for name, p in model.module.named_parameters()}
    losses += [float(step(*train_inputs)) for _ in range(steps - 1)]
    params = {k: v.detach().numpy().copy()
              for k, v in model.state_dict().items()}
    return {"scores": scores, "losses": losses, "grads": grads,
            "params": params, "training": model.module.training}


# ------------------------------------------------- the model axis (tp)
def tp_rank(cfg_kwargs, state, score_inputs, packed_inputs, train_inputs,
            steps, lr):
    """The transformer on ``{"data": 2, "model": 2}`` of four ranks, from
    the whole model's weights: ``make_sharded_score_fn`` and the plan's
    ``score_packed`` in f32 and bf16 (and the plan's refusal of rows not
    divisible by dp), ``steps`` train steps on this rank's shard (its
    losses, its first step's gradients and its final parameters, in its
    own layout)."""
    from odigos_tpu_torch.models import TraceTransformer, TransformerConfig
    from odigos_tpu_torch.parallel import (compile_plan, make_mesh,
                                           make_sharded_score_fn,
                                           make_sharded_train_step,
                                           shard_model)

    mesh = make_mesh({"data": 2, "model": 2}, device="cpu")
    out = {"coord": tuple(mesh.get_coordinate())}
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        whole = TraceTransformer(TransformerConfig(dtype=dt, **cfg_kwargs),
                                 device="cpu")
        whole.load_state_dict(state)
        score = make_sharded_score_fn(whole, mesh)
        out[f"scores_{name}"] = [tuple(t.float().numpy() for t in score(*a))
                                 for a in score_inputs]
        plan = compile_plan(whole, mesh)
        out[f"packed_{name}"] = [plan.score_packed(state, *a).numpy()
                                 for a in packed_inputs]
        out[f"placed_bytes_{name}"] = plan.placed_bytes()
    odd = [a[:-1] for a in packed_inputs[0]]
    out["odd_rows"] = _raises(lambda: plan.score_packed(state, *odd))
    whole = TraceTransformer(TransformerConfig(dtype=torch.float32,
                                               **cfg_kwargs), device="cpu")
    whole.load_state_dict(state)
    model = shard_model(whole, mesh)
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    step = make_sharded_train_step(model, opt, mesh)
    losses = [float(step(*train_inputs))]
    out["grads"] = {name: p.grad.numpy().copy()
                    for name, p in model.module.named_parameters()}
    losses += [float(step(*train_inputs)) for _ in range(steps - 1)]
    out["losses"] = losses
    out["params"] = {k: v.detach().numpy().copy()
                     for k, v in model.state_dict().items()}
    out["unsharded_step"] = _raises(
        lambda: make_sharded_train_step(whole, opt, mesh))
    return out


def engine_mesh_rank(bundle, batches, max_len, trace_bucket, rungs,
                     ae_kwargs, ae_bundle=None):
    """The engine on the meshes ``{"data": 4}`` and ``{"data": 2,
    "model": 2}`` of four ranks, serving a bundle: who owns the mesh, the
    ladder's alignment and misses, the leader's scores of ``batches`` on
    the host route and with columns (the fused route falling back), the
    per-mesh priors, a follower's ``submit`` refusal and every rank's
    shutdown; the autoencoder (``ae_kwargs``) on ``{"data": 4}``, and the
    autoencoder bundle ``ae_bundle`` on ``{"data": 2, "model": 2}``; then
    a mesh of three of the four ranks (the fourth holds no coordinate of
    it), an unbackable mesh and the quantized refusal."""
    from odigos_tpu_torch.serving.engine import (
        MESH_UNAVAILABLE_METRIC, EngineConfig, ScoringEngine)
    from odigos_tpu_torch.serving.fused import extract_columns
    from odigos_tpu_torch.utils.telemetry import labeled_key, meter

    def cfg(mesh, **kw):
        return EngineConfig(model="transformer", checkpoint_path=bundle,
                            mesh=mesh, max_len=max_len,
                            trace_bucket=trace_bucket, bucket_ladder=rungs,
                            device="cpu", **kw)

    out = {"rank": dist.get_rank()}
    for key, mesh in (("dp", {"data": 4}), ("tp", {"data": 2, "model": 2})):
        eng = ScoringEngine(cfg(mesh, warm_ladder=True)).start()
        r = {"owner": (eng.mesh is not None and eng.backend.mesh is eng.mesh
                       and eng.backend._plan is not None
                       and eng.backend._plan.mesh is eng.mesh),
             "mesh_shape": dict(zip(eng.mesh.mesh_dim_names,
                                    eng.mesh.mesh.shape)),
             "align": eng.backend.ladder.align,
             "buckets": list(eng.backend.ladder.buckets),
             "follower": eng.is_follower}
        if eng.is_follower:
            r["submit"] = _raises(lambda: eng.submit(batches[0]))
        else:
            r["misses_after_warm"] = eng.backend.ladder.misses
            r["scores"] = [eng.score_sync(b, timeout_s=120.0)
                           for b in batches]
            r["col_scores"] = []
            for b in batches:  # one at a time: the host route's groups
                q = eng.submit(b, columns=extract_columns(b)[0])
                r["col_scores"].append(q.scores if q.done.wait(120.0)
                                       else None)
            st = eng.stats()
            r["fallback_backend"] = st["odigos_fastpath_fused_fallback_total"][
                "backend"]
            r["fused_calls"] = st["fused_calls"]
            r["misses"] = eng.backend.ladder.misses
            r["hits"] = eng.backend.ladder.hits
            r["stats_mesh"] = (st["adaptive"]["mesh"], st.get("mesh"))
            r["learned"] = eng._ms_per_span() is not None
        loop = eng._follower
        eng.shutdown()
        r["loop_alive"] = loop is not None and loop.is_alive()
        # a new engine on the same mesh starts from the learned estimates
        # (the leader's: the followers retire no calls)
        eng2 = ScoringEngine(cfg(mesh))
        r["prior"] = eng2._ms_per_span() is not None
        eng2.shutdown()
        out[key] = r
    # the autoencoder on the data axis, its weights from the seed
    from odigos_tpu_torch.models import AutoencoderConfig

    ae = ScoringEngine(EngineConfig(
        model="autoencoder", mesh={"data": 4}, max_len=max_len,
        trace_bucket=trace_bucket, bucket_ladder=rungs, device="cpu",
        model_config=AutoencoderConfig(**ae_kwargs))).start()
    if not ae.is_follower:
        out["ae_scores"] = [ae.score_sync(b, timeout_s=120.0)
                            for b in batches]
    ae.shutdown()
    if ae_bundle is not None:  # ... and on the model axis, from a bundle
        ae = ScoringEngine(EngineConfig(
            model="autoencoder", checkpoint_path=ae_bundle,
            mesh={"data": 2, "model": 2}, max_len=max_len,
            trace_bucket=trace_bucket, bucket_ladder=rungs,
            device="cpu")).start()
        runner = ae.backend._plan.runner
        out["ae_tp_runner"] = (runner.model_axis.tp,
                               runner.module.service_head.weight.shape[0])
        if not ae.is_follower:
            out["ae_tp_scores"] = [ae.score_sync(b, timeout_s=120.0)
                                   for b in batches]
        ae.shutdown()
    # a mesh of the first three ranks: the fourth is refused
    try:
        eng = ScoringEngine(cfg({"data": 3}))
    except ValueError as e:
        out["prefix"] = f"{type(e).__name__}: {e}"
    else:
        out["prefix"] = ""
        eng.shutdown()
    meter.reset()
    eng = ScoringEngine(cfg({"data": 64}))
    out["unbackable"] = (eng.mesh is None, eng.backend._plan is None,
                         eng.backend.ladder.align,
                         meter.counter(labeled_key(MESH_UNAVAILABLE_METRIC,
                                                   model="transformer")),
                         eng.stats()["adaptive"]["mesh"])
    out["quantized"] = _raises(lambda: ScoringEngine(
        cfg({"data": 2, "model": 2}, quantized=True)))
    return out


# ----------------------------------------- the autoencoder on the axis
def ae_tp_rank(cfg_kwargs, state, score_inputs, train_inputs, steps, lr):
    """The autoencoder on ``{"data": 2, "model": 2}`` of four ranks, from
    the whole model's weights: ``make_sharded_score_fn`` and the plan's
    ``score_spans`` in f32 and bf16, ``steps`` train steps on this rank's
    shard (its losses, its first step's gradients and its final
    parameters, in its own layout); then the same steps on ``{"data": 4}``
    (the data axis alone) from the same weights."""
    from odigos_tpu_torch.models import AutoencoderConfig, SpanAutoencoder
    from odigos_tpu_torch.parallel import (compile_plan, make_mesh,
                                           make_sharded_score_fn,
                                           make_sharded_train_step,
                                           shard_model)

    def whole(dt):
        m = SpanAutoencoder(AutoencoderConfig(dtype=dt, **cfg_kwargs),
                            device="cpu")
        m.load_state_dict(state)
        return m

    def train(model, mesh):
        opt = torch.optim.Adam(model.parameters(), lr=lr)
        step = make_sharded_train_step(model, opt, mesh)
        losses = [float(step(*train_inputs))]
        grads = {name: p.grad.numpy().copy()
                 for name, p in model.module.named_parameters()}
        losses += [float(step(*train_inputs)) for _ in range(steps - 1)]
        params = {k: v.detach().numpy().copy()
                  for k, v in model.state_dict().items()}
        return losses, grads, params

    mesh = make_mesh({"data": 2, "model": 2}, device="cpu")
    out = {"coord": tuple(mesh.get_coordinate())}
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        m = whole(dt)
        score = make_sharded_score_fn(m, mesh)
        out[f"scores_{name}"] = [tuple(t.float().numpy() for t in score(*a))
                                 for a in score_inputs]
        plan = compile_plan(m, mesh)
        out[f"plan_{name}"] = [tuple(t.float().numpy()
                                     for t in plan.score_spans(state, *a))
                               for a in score_inputs]
    out["losses"], out["grads"], out["params"] = train(
        shard_model(whole(torch.float32), mesh), mesh)
    dp = make_mesh({"data": 4}, axes=("data",), device="cpu")
    out["dp_losses"], out["dp_grads"], out["dp_params"] = train(
        whole(torch.float32), dp)
    return out

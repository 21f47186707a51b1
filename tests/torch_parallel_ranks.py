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
    a shape that needs more, and the refusals of a ``"model"`` axis."""
    from odigos_tpu_torch.models import TraceTransformer, TransformerConfig
    from odigos_tpu_torch.parallel import (make_mesh, make_sharded_score_fn,
                                           make_sharded_train_step, mesh_key)

    full = make_mesh(device="cpu")
    prefix = make_mesh({"data": 3, "model": 2}, device="cpu")
    needs = _raises(lambda: make_mesh({"data": 3, "model": 3}, device="cpu"))
    tp = make_mesh({"data": 4, "model": 2}, device="cpu")
    model = TraceTransformer(TransformerConfig(
        d_model=16, n_heads=2, n_layers=1, d_ff=32, max_len=8,
        dtype=torch.float32), device="cpu")
    opt = torch.optim.Adam(model.module.parameters(), lr=1e-3)
    return {"full": (mesh_key(full), dict(zip(full.mesh_dim_names,
                                               full.mesh.shape))),
            "prefix": (prefix.mesh.numel(), prefix.get_coordinate(),
                       mesh_key(prefix)),
            "needs": needs,
            "tp_step": _raises(lambda: make_sharded_train_step(model, opt,
                                                               tp)),
            "tp_score": _raises(lambda: make_sharded_score_fn(model, tp))}


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

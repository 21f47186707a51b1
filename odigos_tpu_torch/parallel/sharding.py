"""The data axis: data-parallel scoring and training over a mesh.

The port of the data-parallel half of ``odigos_tpu/parallel/sharding.py``.
The reference places a global batch on the ``"data"`` axis
(``_shard_inputs``: the leading axis padded with zeros to a multiple of
dp, so padding rows' masks stay False) and lets XLA partition the jitted
step. The port is SPMD over ranks: every rank is handed the same global
batch, :func:`shard_batch` pads it the same way and keeps this rank's
part, each rank runs the model on its part (on the card: K1, K2, K14 and
K15 forward, K16-K19 backward, as ``Trainer`` does), and collectives over
the axis group join the results:

* :func:`make_sharded_score_fn` all-gathers the span and trace scores and
  trims them to the caller's rows;
* :func:`make_sharded_train_step` takes the reference's loss over the
  GLOBAL batch, not a mean of the ranks' means: each rank all-reduces its
  count of real spans and of valid traces first, backpropagates its local
  loss sums divided by those global counts, and all-reduces the gradients
  with SUM before the optimizer steps, so every replica takes the same
  update.

Parameters are replicated: the ``"model"`` axis (tensor parallelism, the
model-axis rules of :data:`PARTITION_RULES`) is ROADMAP A8.2, and a mesh
whose ``"model"`` axis is above 1 raises. ``PARTITION_RULES`` is carried
over as data for it.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .mesh import axis_size
from .ring_attention import gather_seq

# The reference's rule table (first match wins over the '/'-joined Flax
# parameter path), each spec as a tuple of mesh axes (None: replicated
# along that dim). Only the catch-all applies until A8.2 ports the model
# axis.
PARTITION_RULES: tuple[tuple[str, tuple], ...] = (
    (r"Attention_\d+/(query|key|value)/kernel$", (None, "model", None)),
    (r"Attention_\d+/out/kernel$", ("model", None, None)),
    (r"block_\d+/Dense_0/kernel$", (None, "model")),
    (r"block_\d+/Dense_1/kernel$", ("model", None)),
    (r"dec_ff1/kernel$", (None, "model")),
    (r"dec_ff2/kernel$", ("model", None)),
    (r"(service|name)_head/kernel$", (None, "model")),
    (r"", ()),
)


def _data_axis(mesh: DeviceMesh) -> tuple[Any, int, int]:
    """``(group, dp, this rank's index)`` of the mesh's ``"data"`` axis;
    raises for a ``"model"`` axis above 1."""
    tp = axis_size(mesh, "model")
    if tp > 1:
        raise ValueError(f"a 'model' axis of {tp} is tensor parallelism, "
                         f"ROADMAP A8.2, not ported yet: use a mesh whose "
                         f"'model' axis is 1")
    if "data" not in mesh.mesh_dim_names:
        raise ValueError(f"mesh axes {mesh.mesh_dim_names} have no 'data'")
    return (mesh.get_group("data"), axis_size(mesh, "data"),
            mesh.get_local_rank("data"))


def shard_batch(mesh: DeviceMesh, arrays: Sequence[Any]) -> tuple:
    """The reference's ``_shard_inputs`` for one rank: each batch-leading
    host array padded with zeros to a multiple of the data axis (mask rows
    stay False, labels 0) and this rank's contiguous part kept."""
    _, dp, r = _data_axis(mesh)
    out = []
    for a in arrays:
        a = np.asarray(a)
        pad = (-a.shape[0]) % dp
        if pad:
            a = np.pad(a, [(0, pad)] + [(0, 0)] * (a.ndim - 1))
        per = a.shape[0] // dp
        out.append(np.ascontiguousarray(a[r * per:(r + 1) * per]))
    return tuple(out)


def make_sharded_score_fn(model, mesh: DeviceMesh):
    """Data-parallel scoring: ``fn(cat, cont, mask) -> (span, trace)``,
    every rank given the same global ``(T, L, *)`` host batch, each
    scoring its part with ``model.score_spans``; returns the ``(T, L)``
    span and ``(T,)`` trace probabilities all-gathered on the model's
    device and trimmed to the caller's T rows."""
    _data_axis(mesh)

    @torch.no_grad()
    def score(cat, cont, mask):
        n = mask.shape[0]
        cat, cont, mask = shard_batch(mesh, (cat, cont, mask))
        span, trace = model.score_spans(cat, cont, mask)
        span = gather_seq(span.clone(), mesh, "data", dim=0)
        trace = gather_seq(trace.clone(), mesh, "data", dim=0)
        return span[:n], trace[:n]

    return score


def make_sharded_train_step(model, optimizer: torch.optim.Optimizer,
                            mesh: DeviceMesh):
    """Data-parallel train step: ``fn(cat, cont, mask, span_labels,
    trace_labels) -> loss`` (a 0-dim tensor, the global batch's loss),
    every rank given the same global batch. The reference's
    ``make_sharded_train_step`` returns new variables and optimizer state;
    here ``model``'s parameters and ``optimizer`` (built over them, the
    same on every rank) are updated in place. The model must be the
    trainer's: a ``TraceTransformer`` in f32 on the card (the backward
    kernels' type, ``trainer.card_checks``)."""
    group, _, _ = _data_axis(mesh)
    if model.device.type != mesh.device_type:
        raise ValueError(f"the mesh is on {mesh.device_type!r}, the model on "
                         f"{model.device}")
    if model.device.type == "cuda":
        from ..training.trainer import card_checks

        card_checks(model.cfg)
    module = model.module
    params = [p for p in module.parameters() if p.requires_grad]

    def step(cat, cont, mask, span_labels, trace_labels) -> torch.Tensor:
        cat, cont, mask, span_labels, trace_labels = shard_batch(
            mesh, (cat, cont, mask, span_labels, trace_labels))
        was_training = module.training
        module.train()
        try:
            optimizer.zero_grad(set_to_none=True)
            with torch.enable_grad():
                span_sum, span_n, trace_sum, trace_n = model.loss_terms(
                    cat, cont, mask, span_labels, trace_labels)
                counts = torch.stack([span_n, trace_n]).detach()
                dist.all_reduce(counts, op=dist.ReduceOp.SUM, group=group)
                loss = (span_sum / counts[0].clamp(min=1.0)
                        + trace_sum / counts[1].clamp(min=1.0))
                loss.backward()
        finally:
            module.train(was_training)
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        at = 0
        for p in params:
            p.grad = flat[at:at + p.numel()].view_as(p)
            at += p.numel()
        optimizer.step()
        total = loss.detach().clone()
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        return total

    return step

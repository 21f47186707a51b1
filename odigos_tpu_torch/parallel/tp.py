"""The ``"model"`` axis: how a tensor-parallel block sums its partials.

The reference shards the transformer's attention heads and FFN columns on
the mesh's ``"model"`` axis (``PARTITION_RULES``) and lets XLA insert a
``psum`` after each row-parallel product (the out-projection and FFN2).
The port's block on a shard (``models/layers.py`` :func:`run_block`) runs
its column-parallel products on its own heads and columns, K15's
``"partial"`` epilogue for each row-parallel one, then hands the ``(M,
d)`` f32 partials to a model axis, which returns their sum over the axis,
and K23 rounds it. Two axes:

* :class:`GroupModelAxis` — one shard a rank: ``dist.all_reduce`` (SUM,
  f32) over the mesh's ``"model"`` process group (NCCL on the card, gloo
  on the CPU). For training it is the Megatron pair as
  ``torch.autograd.Function``s: identity forward and all-reduce backward
  before each column-parallel product (:meth:`enter`), all-reduce forward
  and identity backward after each row-parallel one (:meth:`reduce`).
* :class:`LocalModelAxis` — every shard in this process, on one device:
  the partials added in rank order (``p0 + p1 + ...``), as
  ``LocalRotation`` stands in for the ring's ``isend``/``irecv``. At tp = 2
  the sum is NCCL's (a + b); at tp = 4 NCCL's ring may add in another
  order. ``chip_smoke.py`` drives the tensor-parallel path on one card
  with it. Autograd differentiates its sum and the fan-out of the
  replicated input itself.

Both also gather a tensor over the axis (:meth:`gather`): each shard's
``(n, ...)`` tensor into one ``(tp, n, ...)`` in rank order, every rank
given the same bytes (``dist.all_gather_into_tensor``; in one process a
``torch.stack``). The autoencoder's vocabulary-sliced heads gather each
shard's per-position cross-entropy record this way, so that every rank
merges them (K24) to the same bits.

``shards`` is the shards a process holds: ``(rank in the group,)`` or
``range(tp)``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist


class _CopyToModel(torch.autograd.Function):
    """Identity forward, all-reduce backward: the input of a
    column-parallel product, replicated over the axis."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, dy):
        dy = dy.contiguous().clone()
        dist.all_reduce(dy, op=dist.ReduceOp.SUM, group=ctx.group)
        return dy, None


class _ReduceFromModel(torch.autograd.Function):
    """All-reduce forward, identity backward: the sum of a row-parallel
    product's partials."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class GroupModelAxis:
    """The model axis over a process group, one shard a rank."""

    def __init__(self, group, tp: int, rank: int):
        self.group = group
        self.tp = int(tp)
        self.shards = (int(rank),)

    @classmethod
    def of(cls, mesh) -> "GroupModelAxis":
        """The ``"model"`` axis of a ``DeviceMesh``."""
        return cls(mesh.get_group("model"),
                   dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))["model"],
                   mesh.get_local_rank("model"))

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        if x.requires_grad and torch.is_grad_enabled():
            return _CopyToModel.apply(x, self.group)
        return x

    def reduce(self, partials: Sequence[torch.Tensor]) -> torch.Tensor:
        (p,) = partials
        if p.requires_grad and torch.is_grad_enabled():
            return _ReduceFromModel.apply(p, self.group)
        dist.all_reduce(p, op=dist.ReduceOp.SUM, group=self.group)
        return p

    def gather(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """This rank's ``(n, ...)`` tensor from every rank of the group,
        as one ``(tp, n, ...)`` tensor in rank order (no gradient)."""
        (p,) = parts
        p = p.contiguous()
        out = p.new_empty((self.tp * p.shape[0],) + tuple(p.shape[1:]))
        dist.all_gather_into_tensor(out, p, group=self.group)
        return out.view((self.tp,) + tuple(p.shape))


class LocalModelAxis:
    """The model axis in one process: all ``tp`` shards on one device, the
    partials added in rank order."""

    def __init__(self, tp: int):
        if tp < 1:
            raise ValueError(f"a model axis of {tp}")
        self.tp = int(tp)
        self.shards = tuple(range(self.tp))

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def reduce(self, partials: Sequence[torch.Tensor]) -> torch.Tensor:
        if len(partials) != self.tp:
            raise ValueError(f"{len(partials)} partials on a model axis of "
                             f"{self.tp}")
        acc = partials[0]
        for p in partials[1:]:
            acc = acc + p
        return acc

    def gather(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """Every shard's tensor stacked in rank order."""
        if len(parts) != self.tp:
            raise ValueError(f"{len(parts)} parts on a model axis of "
                             f"{self.tp}")
        return torch.stack(list(parts))

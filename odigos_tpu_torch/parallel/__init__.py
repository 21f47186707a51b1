"""Multi-device modes of the port: meshes, ring attention, the data axis.

Twin of ``odigos_tpu/parallel`` for the parts ported so far (ROADMAP A8):
``mesh`` (``DeviceMesh``es over ``torch.distributed`` ranks, NCCL on the
card, gloo on the CPU), ``launch`` (n ranks, one process each),
``ring_attention`` (sequence parallelism over a ``"seq"`` axis, one K22
launch a step), ``sharding`` (data-parallel scoring and training over a
``"data"`` axis) and ``dryrun`` (``dryrun_multichip``, imported from its
module: ``python -m odigos_tpu_torch.parallel.dryrun``). The reference is
single-controller over a ``jax.sharding.Mesh``; the port is SPMD, one rank
a device: each module's docstring says where that changes its API.
Tensor parallelism (the ``"model"`` axis, A8.2) and the engine's mesh
(A8.3) are not ported.
"""

from .launch import spawn
from .mesh import (axis_size, init_group, make_mesh, mesh_axes, mesh_key,
                   mesh_shape)
from .ring_attention import (PARTITION_SPECS, GroupRotation, LocalRotation,
                             gather_seq, reference_attention, ring_attention,
                             ring_body, shard_seq)
from .sharding import (PARTITION_RULES, make_sharded_score_fn,
                       make_sharded_train_step, shard_batch)

__all__ = [
    "spawn",
    "axis_size",
    "init_group",
    "make_mesh",
    "mesh_axes",
    "mesh_key",
    "mesh_shape",
    "PARTITION_SPECS",
    "GroupRotation",
    "LocalRotation",
    "gather_seq",
    "reference_attention",
    "ring_attention",
    "ring_body",
    "shard_seq",
    "PARTITION_RULES",
    "make_sharded_score_fn",
    "make_sharded_train_step",
    "shard_batch",
]

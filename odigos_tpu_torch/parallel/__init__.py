"""Multi-device modes of the port: meshes, ring attention, the data and
model axes.

Twin of ``odigos_tpu/parallel`` (ROADMAP A8): ``mesh`` (``DeviceMesh``es
over ``torch.distributed`` ranks, NCCL on the card, gloo on the CPU),
``launch`` (n ranks, one process each), ``ring_attention`` (sequence
parallelism over a ``"seq"`` axis, one K22 launch a step), ``tp`` (the
``"model"`` axis's sum of partials: over a process group, or in one
process), ``sharding`` (the rule table, ``shard_state``, data- and
tensor-parallel scoring and training, the scoring plan the engine's mesh
serves through) and ``dryrun`` (``dryrun_multichip``, imported from its
module: ``python -m odigos_tpu_torch.parallel.dryrun``). The reference is
single-controller over a ``jax.sharding.Mesh``; the port is SPMD, one rank
a device: each module's docstring says where that changes its API.
``PARTITION_SPECS`` here is ``ring_attention``'s, as in the reference;
the sharded entry points' is ``sharding.PARTITION_SPECS``.
"""

from .launch import spawn
from .mesh import (axis_size, init_group, make_mesh, mesh_axes, mesh_key,
                   mesh_shape)
from .ring_attention import (PARTITION_SPECS, GroupRotation, LocalRotation,
                             gather_seq, reference_attention, ring_attention,
                             ring_body, shard_seq)
from .sharding import (PARTITION_RULES, ScoringPlan, batch_spec,
                       compile_plan, make_sharded_packed_score_fn,
                       make_sharded_score_fn, make_sharded_train_step,
                       match_partition_rules, param_specs, shard_batch,
                       shard_model,
                       shard_state, transformer_param_spec, unshard_state)
from .tp import GroupModelAxis, LocalModelAxis

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
    "ScoringPlan",
    "batch_spec",
    "compile_plan",
    "make_sharded_packed_score_fn",
    "make_sharded_score_fn",
    "make_sharded_train_step",
    "match_partition_rules",
    "param_specs",
    "shard_batch",
    "shard_model",
    "shard_state",
    "transformer_param_spec",
    "unshard_state",
    "GroupModelAxis",
    "LocalModelAxis",
]

"""Ring attention: exact masked attention with the sequence axis sharded.

The port of ``odigos_tpu/parallel/ring_attention.py``. Each rank of the
``"seq"`` axis holds one block of the sequence; K/V blocks (and the kv
mask) rotate one step round the ring each step while every rank merges
the block it holds into its queries' running state with a streaming
log-sum-exp: n steps, exact softmax attention. Each step is one launch
of K22 (``kernels.ring.ring_block_attention``), which updates the f32
accumulators in place and on the last step writes the output.

Where the reference and the port differ:

* The reference wraps the per-device body in ``shard_map`` over a global
  array. The port is SPMD over ranks: each rank calls
  :func:`ring_attention` with its own ``(B, L/n, H, D)`` block and gets its
  output block back; :func:`shard_seq` cuts this rank's block out of a
  global tensor and :func:`gather_seq` all-gathers the result.
* ``ppermute`` becomes a rotation the body takes as an argument: the
  public function passes :class:`GroupRotation`, which posts the next
  block's ``isend`` to rank j + 1 and ``irecv`` from rank j - 1 of the
  axis group (the reference's direction, so the merges run in its order)
  into a second buffer before K22 runs on the current block, and waits on
  them before the next step. :class:`LocalRotation` is the same ring
  inside one process (every block held locally; ``chip_smoke.py`` drives
  the body at full width on one card with it). A ring of 1 rotates
  nothing, as ``ppermute`` on a size-1 axis.
* The kv mask travels as ``uint8``.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..kernels import ring as kring
from .mesh import axis_size

NEG_INF = kring.NEG_INF

# Partition-spec declaration per sharded entry point, as the reference
# keeps it: ring attention shards the SEQUENCE axis, nothing else.
PARTITION_SPECS = {
    "ring_attention": "q/k/v (B, L, H, D) and mask (B, L) sharded on "
                      "the 'seq' axis (each rank passes its block; "
                      "shard_seq / gather_seq cut and join them); K/V "
                      "blocks rotate by isend/irecv, output sharded like q",
}


class _Pending:
    def __init__(self, works, bufs):
        self._works, self._bufs = works, bufs

    def wait(self):
        for w in self._works:
            w.wait()
        return self._bufs


class GroupRotation:
    """One step of the ring over a process group: rank j's block goes to
    rank j + 1, and rank j - 1's arrives (all ranks of ``group``)."""

    def __init__(self, group: dist.ProcessGroup):
        self.group = group
        n = dist.get_world_size(group)
        me = dist.get_rank(group)
        self.dst = dist.get_global_rank(group, (me + 1) % n)
        self.src = dist.get_global_rank(group, (me - 1) % n)

    def __call__(self, cur: Sequence[torch.Tensor],
                 nxt: Sequence[torch.Tensor]):
        ops = []
        for a, b in zip(cur, nxt):
            ops.append(dist.P2POp(dist.isend, a, self.dst, self.group))
            ops.append(dist.P2POp(dist.irecv, b, self.src, self.group))
        return _Pending(dist.batch_isend_irecv(ops), tuple(nxt))


class LocalRotation:
    """The ring inside one process: every rank's block is held here, and
    the rotation for ``rank`` hands it, step by step, the blocks rank
    ``rank`` would receive (``rank - 1``, ``rank - 2``, ...), copied into
    the body's second buffer."""

    def __init__(self, blocks: Sequence[Sequence[torch.Tensor]], rank: int):
        self.blocks = [tuple(b) for b in blocks]
        self.at = rank

    def __call__(self, cur, nxt):
        self.at = (self.at - 1) % len(self.blocks)
        for src, dst in zip(self.blocks[self.at], nxt):
            dst.copy_(src, non_blocking=True)
        return _Pending((), tuple(nxt))


def ring_body(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              kv_mask: torch.Tensor, n: int, rotate: Callable,
              reference: bool = False) -> torch.Tensor:
    """One rank's ring: ``n`` steps of K22 on its ``q`` block against the
    kv blocks ``rotate(cur, into)`` brings (the first is its own), the next
    block received into another buffer while K22 runs on the current one.
    ``reference=True`` merges with K22's plain version (a check, not a
    route). Returns the ``(B, Lq, H, D)`` f32 output."""
    B, Lq, H, D = q.shape
    scale = 1.0 / (D ** 0.5)
    dev = q.device
    o = torch.zeros((B, Lq, H, D), dtype=torch.float32, device=dev)
    m = torch.full((B, H, Lq), NEG_INF, dtype=torch.float32, device=dev)
    s = torch.zeros((B, H, Lq), dtype=torch.float32, device=dev)
    cur = (k.to(torch.float32).contiguous(), v.to(torch.float32).contiguous(),
           kv_mask.to(torch.uint8).contiguous())
    # the blocks received, alternately into two buffers of the body's own
    # (never into the caller's k, v and mask, which the first step reads)
    bufs = [tuple(torch.empty_like(t) for t in cur)
            for _ in range(min(n - 1, 2))]
    step = (kring.ring_block_attention_plain if reference
            else kring.ring_block_attention)
    q = q.contiguous()
    for i in range(n):
        last = i == n - 1
        pending = None if last else rotate(cur, bufs[i % 2])
        step(q, *cur, o, m, s, scale, last)
        if pending is not None:
            cur = pending.wait()
    return o


def _group_of(mesh: DeviceMesh, axis_name: str):
    if axis_name not in mesh.mesh_dim_names:
        raise ValueError(f"mesh axes {mesh.mesh_dim_names} have no "
                         f"{axis_name!r}")
    return mesh.get_group(axis_name), axis_size(mesh, axis_name)


def shard_seq(x: torch.Tensor, mesh: DeviceMesh, axis_name: str = "seq",
              dim: int = 1) -> torch.Tensor:
    """This rank's block of a global tensor along ``dim`` (the sequence:
    1 for ``(B, L, H, D)`` and ``(B, L)``). Raises where the length is not
    a multiple of the axis size."""
    _, n = _group_of(mesh, axis_name)
    L = x.shape[dim]
    if L % n:
        raise ValueError(f"sequence length {L} is not a multiple of the "
                         f"{axis_name!r} axis size {n}")
    r = mesh.get_local_rank(axis_name)
    return x.narrow(dim, r * (L // n), L // n).contiguous()


def gather_seq(x: torch.Tensor, mesh: DeviceMesh, axis_name: str = "seq",
               dim: int = 1) -> torch.Tensor:
    """The global tensor from every rank's block along ``dim`` (an
    all-gather over the axis group; the data axis gathers rows with it
    too)."""
    group, n = _group_of(mesh, axis_name)
    if n == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask: torch.Tensor, mesh: DeviceMesh,
                   axis_name: str = "seq") -> torch.Tensor:
    """Exact masked attention with the sequence axis sharded over the
    ``axis_name`` axis of ``mesh``. Each rank passes its own block:
    q/k/v ``(B, L/n, H, D)`` (the same block length on every rank) and
    its ``(B, L/n)`` bool padding mask; returns its ``(B, L/n, H, D)``
    float32 output block. On the card every step launches K22."""
    group, n = _group_of(mesh, axis_name)
    if q.device.type != mesh.device_type:
        raise ValueError(f"the mesh is on {mesh.device_type!r}, the inputs "
                         f"on {q.device}")
    rotate = GroupRotation(group) if n > 1 else None
    return ring_body(q, k, v, mask, n, rotate)


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask: torch.Tensor) -> torch.Tensor:
    """Single-device exact attention, the reference's oracle: f32 logits
    times ``1 / sqrt(D)``, the -1e30 fill, softmax, masked weights zeroed,
    P.V. Plain PyTorch ops (a check, not a route)."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    allowed = mask.to(torch.bool)[:, None, None, :]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    logits = logits.masked_fill(~allowed, NEG_INF)
    p = torch.softmax(logits, dim=-1).masked_fill(~allowed, 0.0)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float())

"""Partition rules, the data and model axes, and the scoring plan.

The port of ``odigos_tpu/parallel/sharding.py``. The reference annotates
placements (the rule table below over the ``/``-joined Flax parameter
path, the batch on ``"data"``) and XLA partitions the jitted calls,
inserting the model axis's ``psum`` after each row-parallel product. The
port is SPMD over ranks, one rank a device:

* **the rule table** resolves as the reference's: :func:`match_partition_rules`
  (first match wins; scalars and size-1 leaves never partition; a leaf
  with no rule raises), :func:`_guard_spec` (an axis that is absent, or
  that does not divide its dimension, replicates) and
  :meth:`ScoringPlan.param_specs` give the reference's guarded specs leaf
  for leaf on a Flax tree (numpy leaves). :func:`shard_state` takes this
  rank's shard of the port's state dict (``models/convert.py``'s names and
  layouts), the port's ``shard_variables``: the specs name axes of Flax's
  layouts, so the query/key/value heads are the rows of their torch
  weights (and of their biases), the ``out`` heads its columns, FFN1's
  columns the rows of ``ff1`` (and its bias), FFN2's rows the columns of
  ``ff2``. The ``out`` and ``ff2`` biases stay whole: the block adds them
  once, after the all-reduce (K23). The attention group (``H``) and the
  FFN group (``d_ff``) are each guarded as a unit, from the rules
  resolved on block 0's kernels. The autoencoder adds three groups, each
  guarded on its own kernel: its decoder FFN (``dec_ff1``'s columns, the
  rows of its weight and bias; ``dec_ff2``'s rows, the columns of its
  weight; the ``dec_ff2`` bias whole) and the service and name heads (the
  rows of each weight; each bias whole, the reference's ``P()``: a shard
  reads its rows of it);
* **the data axis**: every rank is handed the same global batch,
  :func:`shard_batch` pads it to a multiple of dp (``_shard_inputs``:
  mask rows stay False) and keeps this rank's rows; scores are
  all-gathered over the data group, gradients all-reduced over it with
  SUM after the loss is taken over the GLOBAL batch (the counts of real
  spans and valid traces all-reduced first), so every replica takes the
  same update;
* **the model axis** (tensor parallelism): each rank holds its shard of
  the blocks (``models/layers.py`` ``run_block``, a ``GroupModelAxis``
  over the mesh's ``"model"`` group), K15's ``"partial"`` products
  all-reduced in f32 and finished by K23; in training the Megatron pair
  (``parallel/tp.py``). ``SpanAutoencoder`` shards its decoder FFN the
  same way (K23 without a residual) and its vocabulary heads by rows: each
  rank's K11 ``"slice"`` records are all-gathered over the model group and
  merged by K24 in rank order, so the errors are bit-equal there; in
  training each rank's K20 ``"slice"`` part of ``dy`` is all-reduced
  before K17 (``models/autoencoder.py``). Every replicated parameter's
  gradient is the same on every rank of the model group (its inputs are
  all-reduced or gathered), so it stays bit-equal there; the optimizer
  steps each rank's own shard.

All-reducing f32 partials and rounding once departs from the reference in
bf16, where XLA's ``psum`` adds the Dense outputs in the working type:
each partial rounded to bf16 and their sum rounded again. The port's sum
is the f32 sum of the unrounded partials, rounded once by K23: at tp = 2
it differs from XLA's by at most one bf16 step of the larger partial plus
one of the sum before the bias add (``tests/test_torch_tensor_parallel.py``
holds the bf16 scores to the JAX plan within ``BF16_ATOL``).
"""

from __future__ import annotations

import math
import re
from typing import Any, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .mesh import mesh_key
from .ring_attention import gather_seq
from .tp import GroupModelAxis

# the reference's declarations, kept as data (its package-hygiene lint
# reads them there): each sharded entry point's recompile bound and where
# each tensor class lands. The port builds no executables, so its bound is
# the kernels' shapes: the engine's ladder keeps the row counts on warmed
# rungs.
SHAPE_BUCKETING = {
    "make_sharded_score_fn": "delegates to model.score_spans — leading axis "
                             "padded to a data-axis multiple by "
                             "shard_batch on top of the engine bucketing",
    "make_sharded_packed_score_fn": "delegates to compile_plan — row "
                                    "axis bucketed by the engine's ladder "
                                    "(rungs lcm-aligned to the data axis)",
    "make_sharded_train_step": "training loop feeds fixed (batch, L) "
                               "shapes from data.py batching",
    "compile_plan": "packed row axis bucketed by the engine's "
                    "BucketLadder (rungs lcm-aligned to the data axis, "
                    "warmed once per mesh shape); L/C fixed by the model "
                    "config",
    "packed_score": "the call compile_plan builds — same row-axis "
                    "bucketing as compile_plan (each warmed rung run once "
                    "per mesh shape)",
}

PARTITION_SPECS = {
    "compile_plan": "params via PARTITION_RULES (heads/d_ff/vocab on "
                    "'model', rest replicated; shard_state); packed inputs "
                    "and scores on 'data' by rows",
    "make_sharded_score_fn": "params via PARTITION_RULES; (T, L, *) "
                             "inputs on 'data' by traces",
    "make_sharded_packed_score_fn": "alias of compile_plan (packed rows "
                                    "on 'data', params by rule table)",
    "make_sharded_train_step": "params/grads/optimizer state of this "
                               "rank's shard (shard_model); batch inputs "
                               "on 'data'; loss replicated",
    "shard_variables": "shard_state: the rule table over the Flax paths; "
                       "non-dividing or absent axes fall back to "
                       "replication",
    "packed_score": "the plan's call: params by the rule table, (R, L, *) "
                    "inputs and (R, L) scores on 'data' by rows",
    "shard_inputs": "shard_batch: batch-leading arrays on 'data', leading "
                    "dim padded to a data-axis multiple (pad rows stay "
                    "masked)",
}

# The reference's rule table (first match wins over the '/'-joined Flax
# parameter path), each spec as a tuple of mesh axes (None: replicated
# along that dim).
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

_MHA = "MultiHeadDotProductAttention_0"


# ------------------------------------------------------- partition rules
def _flatten(tree: Mapping[str, Any], prefix: str = "") -> dict[str, Any]:
    out: dict[str, Any] = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, key))
        else:
            out[key] = v
    return out


def _unflatten(flat: Mapping[str, Any]) -> dict[str, Any]:
    out: dict[str, Any] = {}
    for path, v in flat.items():
        node = out
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def _rule_spec(name: str, shape: Sequence[int], rules: tuple) -> tuple:
    """The first matching rule's spec for one leaf (``()`` for a scalar
    or a size-1 leaf)."""
    if len(shape) == 0 or math.prod(shape) == 1:
        return ()
    for rule, spec in rules:
        if re.search(rule, name) is not None:
            return tuple(spec)
    raise ValueError(f"partition rule not found for param: {name}")


def match_partition_rules(params: Mapping[str, Any],
                          rules: tuple = PARTITION_RULES) -> dict[str, Any]:
    """Specs (tuples of mesh axes) per the rule table, in ``params``'
    own nesting (a Flax tree of arrays): scalars and size-1 leaves never
    partition; otherwise the first rule whose regex matches the
    ``/``-joined path wins; a leaf no rule matches raises."""
    flat = _flatten(params)
    return _unflatten({name: _rule_spec(name, np.shape(v), rules)
                       for name, v in flat.items()})


def transformer_param_spec(path: tuple, leaf: Any) -> tuple:
    """The reference's shape-heuristic fallback (pre-rule-table API, for
    trees with no stable names): q/k/v/out by position, a large 2D kernel
    by its grown dimension."""
    names = [str(p) for p in path]
    joined = "/".join(names)
    ndim = len(np.shape(leaf))
    if "attention" in joined or any(n in ("query", "key", "value", "out")
                                    for n in names):
        if any(n in ("query", "key", "value") for n in names) and ndim == 3:
            return (None, "model", None)
        if "out" in names and ndim == 3:
            return ("model", None, None)
    if ndim == 2 and names[-1] == "kernel":
        in_dim, out_dim = np.shape(leaf)
        if min(in_dim, out_dim) >= 64:
            if out_dim > in_dim:
                return (None, "model")
            if in_dim > out_dim:
                return ("model", None)
    return ()


def _dims(mesh: Any) -> dict[str, int]:
    """``{axis: size}`` of a ``DeviceMesh`` or a shape mapping."""
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    return {str(a): int(n) for a, n in dict(mesh).items()}


def _guard_spec(spec: tuple, leaf: Any, mesh: Any) -> tuple:
    """Axes must exist in the mesh and divide their dimension; otherwise
    the leaf replicates (a pure ``"data"`` mesh replicates every
    ``"model"``-sharded leaf)."""
    dims = _dims(mesh)
    for axis, dim in zip(spec, np.shape(leaf)):
        if axis is None:
            continue
        if axis not in dims or dim % dims[axis] != 0:
            return ()
    return tuple(spec)


def param_specs(variables: Mapping[str, Any], mesh: Any,
                rules: tuple = PARTITION_RULES) -> dict[str, Any]:
    """The rule-matched, mesh-guarded specs of a Flax weight tree (numpy
    leaves) on ``mesh`` (a ``DeviceMesh`` or a shape mapping), in the
    tree's own nesting: the reference's ``ScoringPlan.param_specs``."""
    specs = _flatten(match_partition_rules(variables, rules))
    return _unflatten({k: _guard_spec(specs[k], v, mesh)
                       for k, v in _flatten(variables).items()})


def batch_spec(mesh: Any) -> tuple:
    return ("data",)


def group_tp(cfg: Any, mesh: Any, rules: tuple = PARTITION_RULES
              ) -> dict[str, int]:
    """The model axis's width over each group of a config's leaves: the
    rules resolved and guarded on the group's Flax kernel (``attn``: block
    0's query, ``ffn``: its Dense_0, and the groups the config declares in
    ``tp_kernels()``: the autoencoder's ``dec_ff`` on ``dec_ff1``,
    ``service`` and ``name`` on the two heads), tp where it shards, 1 where
    the guard replicates the group."""
    tp = _dims(mesh).get("model", 1)
    hd = cfg.d_model // cfg.n_heads
    kernels = {"attn": (f"encoder/block_0/{_MHA}/query/kernel",
                        (cfg.d_model, cfg.n_heads, hd)),
               "ffn": ("encoder/block_0/Dense_0/kernel",
                       (cfg.d_model, cfg.d_ff)),
               **cfg.tp_kernels()}
    out = {}
    for group, (path, shape) in kernels.items():
        spec = _guard_spec(_rule_spec(path, shape, rules), np.empty(shape),
                           mesh)
        out[group] = tp if "model" in spec else 1
    return out


_BLOCK_LEAF = re.compile(
    r"encoder\.blocks\.\d+\.(query|key|value|out|ff1|ff2)\.(weight|bias)$")
_AE_LEAF = re.compile(r"^(dec_ff1|dec_ff2|service_head|name_head)\."
                      r"(weight|bias)$")


def _split_dim(name: str, groups: Mapping[str, int]
               ) -> tuple[Optional[int], int]:
    """``(dim, ways)`` a port state-dict leaf is cut along on the model
    axis (``groups``: :func:`group_tp`'s), ``(None, 1)`` where it is
    whole."""
    m = _AE_LEAF.search(name)
    if m is not None:
        lin, kind = m.groups()
        td = groups.get("dec_ff", 1)
        if lin == "dec_ff1" and td > 1:
            return 0, td  # the columns: rows of the weight and the bias
        if lin == "dec_ff2" and kind == "weight" and td > 1:
            return 1, td
        ways = groups.get(lin[:-len("_head")], 1)
        if lin.endswith("_head") and kind == "weight" and ways > 1:
            return 0, ways  # the vocabulary's rows; the bias stays whole
        return None, 1
    m = _BLOCK_LEAF.search(name)
    if m is None:
        return None, 1
    ta, tf = groups["attn"], groups["ffn"]
    lin, kind = m.groups()
    if lin in ("query", "key", "value") and ta > 1:
        return 0, ta  # the heads' rows (and their bias)
    if lin == "out" and kind == "weight" and ta > 1:
        return 1, ta  # the heads' columns
    if lin == "ff1" and tf > 1:
        return 0, tf
    if lin == "ff2" and kind == "weight" and tf > 1:
        return 1, tf
    return None, 1


def _model_rank(mesh: Any, rank: Optional[int]) -> int:
    if rank is not None:
        return int(rank)
    if isinstance(mesh, DeviceMesh) and "model" in mesh.mesh_dim_names:
        return mesh.get_local_rank("model")
    if _dims(mesh).get("model", 1) > 1:
        raise ValueError("a shape mapping with a 'model' axis needs rank=")
    return 0


def shard_state(state: Mapping[str, Any], mesh: Any, cfg: Any,
                rank: Optional[int] = None) -> dict[str, torch.Tensor]:
    """This rank's shard of the port's state dict of a ``TraceTransformer``
    or a ``SpanAutoencoder`` (``cfg`` its config) on ``mesh`` (a
    ``DeviceMesh``, or a shape mapping with ``rank=`` the model-axis
    index): the module docstring's slices, each contiguous; every other
    leaf as given."""
    groups = group_tp(cfg, mesh)
    r = _model_rank(mesh, rank)
    out = {}
    for name, v in state.items():
        t = v if isinstance(v, torch.Tensor) else torch.as_tensor(
            np.asarray(v))
        dim, ways = _split_dim(name, groups)
        out[name] = t if dim is None else torch.chunk(
            t, ways, dim)[r].contiguous()
    return out


def unshard_state(shards: Sequence[Mapping[str, Any]], mesh: Any, cfg: Any
                  ) -> dict[str, torch.Tensor]:
    """The whole state dict from every model-axis rank's shard, in rank
    order (the inverse of :func:`shard_state`; replicated leaves are
    rank 0's)."""
    groups = group_tp(cfg, mesh)
    out = {}
    for name in shards[0]:
        ts = [s[name] if isinstance(s[name], torch.Tensor)
              else torch.as_tensor(np.asarray(s[name])) for s in shards]
        dim, _ = _split_dim(name, groups)
        out[name] = ts[0] if dim is None else torch.cat(ts, dim)
    return out


# --------------------------------------------------------------- the axes
def _data_axis(mesh: DeviceMesh) -> tuple[Any, int, int]:
    """``(group, dp, this rank's index)`` of the mesh's ``"data"`` axis;
    a mesh with none is one data rank (no group)."""
    if "data" not in mesh.mesh_dim_names:
        return None, 1, 0
    return (mesh.get_group("data"), _dims(mesh)["data"],
            mesh.get_local_rank("data"))


def _model_axis(model: Any, mesh: DeviceMesh) -> Optional[GroupModelAxis]:
    """The mesh's model axis above 1, else None (a model with no model
    axis raises)."""
    tp = _dims(mesh).get("model", 1)
    if tp <= 1:
        return None
    if not hasattr(model, "model_axis"):
        raise ValueError(f"a 'model' axis of {tp} shards the transformer and "
                         f"the autoencoder, not a {type(model).__name__}")
    return GroupModelAxis.of(mesh)


def shard_model(model: Any, mesh: DeviceMesh) -> Any:
    """``model`` (a whole ``TraceTransformer`` or ``SpanAutoencoder``) as
    this rank's shard of the mesh's model axis: the same class on a
    ``GroupModelAxis`` with the same weights. Without a model axis above 1,
    ``model`` itself."""
    axis = _model_axis(model, mesh)
    if axis is None or model.model_axis is not None:
        return model
    shard = type(model)(model.cfg, device=model.device, model_axis=axis)
    shard.load_state_dict(model.state_dict())
    return shard


def _rows(a: Any, dp: int, r: int) -> Any:
    """Rank ``r``'s contiguous part of a batch-leading array (numpy or a
    tensor), padded with zeros to a multiple of ``dp`` first."""
    if isinstance(a, torch.Tensor):
        pad = (-a.shape[0]) % dp
        if pad:
            a = torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))])
        per = a.shape[0] // dp
        return a[r * per:(r + 1) * per]
    a = np.asarray(a)
    pad = (-a.shape[0]) % dp
    if pad:
        a = np.pad(a, [(0, pad)] + [(0, 0)] * (a.ndim - 1))
    per = a.shape[0] // dp
    return np.ascontiguousarray(a[r * per:(r + 1) * per])


def shard_batch(mesh: DeviceMesh, arrays: Sequence[Any]) -> tuple:
    """The reference's ``_shard_inputs`` for one rank: each batch-leading
    array padded with zeros to a multiple of the data axis (mask rows stay
    False, labels 0) and this rank's contiguous part kept."""
    _, dp, r = _data_axis(mesh)
    return tuple(_rows(a, dp, r) for a in arrays)


def _gather_rows(t: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    if _data_axis(mesh)[1] == 1:
        return t
    return gather_seq(t.clone(), mesh, "data", dim=0)


# ---------------------------------------------------------- entry points
def make_sharded_score_fn(model, mesh: DeviceMesh):
    """Data/tensor-parallel scoring: ``fn(cat, cont, mask) -> (span,
    trace)``, every rank given the same global ``(T, L, *)`` host batch,
    each scoring its part with ``score_spans`` (on a model axis above 1,
    through :func:`shard_model` of ``model``); returns the ``(T, L)`` span
    and ``(T,)`` trace scores all-gathered on the model's device and
    trimmed to the caller's T rows."""
    runner = shard_model(model, mesh)

    @torch.no_grad()
    def score(cat, cont, mask):
        n = mask.shape[0]
        cat, cont, mask = shard_batch(mesh, (cat, cont, mask))
        span, trace = runner.score_spans(cat, cont, mask)
        return _gather_rows(span, mesh)[:n], _gather_rows(trace, mesh)[:n]

    return score


def make_sharded_train_step(model, optimizer: torch.optim.Optimizer,
                            mesh: DeviceMesh):
    """Data/tensor-parallel train step: ``fn(cat, cont, mask, span_labels,
    trace_labels) -> loss`` (a 0-dim tensor, the global batch's loss),
    every rank given the same global batch. The reference's
    ``make_sharded_train_step`` returns new variables and optimizer state;
    here ``model``'s parameters and ``optimizer`` (built over them) are
    updated in place. The model must be the trainer's: a
    ``TraceTransformer`` or a ``SpanAutoencoder`` in f32 on the card (the
    backward kernels' type, ``trainer.card_checks``); on a model axis above
    1, this rank's shard (:func:`shard_model`), its optimizer over
    ``model.parameters()``. The loss is the model's ``loss_terms``: each
    sum over the GLOBAL batch's count (the transformer's span and trace
    terms, the autoencoder's masked error over its real spans), the counts
    all-reduced over the data axis first."""
    group, dp, _ = _data_axis(mesh)
    axis = _model_axis(model, mesh)
    if axis is not None and (model.model_axis is None
                             or model.model_axis.tp != axis.tp):
        raise ValueError(f"a 'model' axis of {axis.tp} trains this rank's "
                         f"shard: pass shard_model(model, mesh)")
    if model.device.type != mesh.device_type:
        raise ValueError(f"the mesh is on {mesh.device_type!r}, the model on "
                         f"{model.device}")
    if model.device.type == "cuda":
        from ..training.trainer import card_checks

        card_checks(model.cfg)
    params = [p for p in model.parameters() if p.requires_grad]

    def all_reduce(t: torch.Tensor) -> None:
        if dp > 1:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)

    def step(cat, cont, mask, span_labels, trace_labels) -> torch.Tensor:
        cat, cont, mask, span_labels, trace_labels = shard_batch(
            mesh, (cat, cont, mask, span_labels, trace_labels))
        was_training = model.module.training
        model.train()
        try:
            optimizer.zero_grad(set_to_none=True)
            with torch.enable_grad():
                terms = model.loss_terms(cat, cont, mask, span_labels,
                                         trace_labels)
                counts = torch.stack(terms[1::2]).detach()
                all_reduce(counts)
                loss = terms[0] / counts[0].clamp(min=1.0)
                for i in range(1, len(terms) // 2):
                    loss = loss + terms[2 * i] / counts[i].clamp(min=1.0)
                loss.backward()
        finally:
            model.train(was_training)
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        flat = torch.cat([g.reshape(-1) for g in grads])
        all_reduce(flat)
        at = 0
        for p in params:
            p.grad = flat[at:at + p.numel()].view_as(p)
            at += p.numel()
        optimizer.step()
        total = loss.detach().clone()
        all_reduce(total)
        return total

    return step


# ------------------------------------------------------- scoring plans
class ScoringPlan:
    """One (model, mesh) pairing for serving: the engine's device layer.

    Holds the rule table, the mesh's ``dp`` and ``tp``, this rank's
    runner (the model itself, or its shard on the mesh's model axis), and
    an identity cache of the placed weights: ``place_variables`` loads a
    state dict into the runner once per state-dict object, and the cache
    holds that object (keyed by ``id`` alone a freed dict's address could
    come back and serve stale weights, as the reference warns). Neither
    entry synchronises: the scores come back as a device tensor, and the
    engine's harvest waits for them."""

    def __init__(self, model: Any, mesh: DeviceMesh,
                 rules: tuple = PARTITION_RULES):
        self.model = model
        self.mesh = mesh
        self.rules = rules
        dims = _dims(mesh)
        self.dp = int(dims.get("data", 1))
        self.tp = int(dims.get("model", 1))
        self.key = mesh_key(mesh)
        self.runner = shard_model(model, mesh)
        self._cache: dict[str, Any] = {"source": None, "placed": None}

    def param_specs(self, variables: Mapping[str, Any]) -> dict[str, Any]:
        """:func:`param_specs` on the plan's mesh and rules."""
        return param_specs(variables, self.mesh, self.rules)

    def place_variables(self, variables: Mapping[str, Any]
                        ) -> dict[str, torch.Tensor]:
        """This rank's shard of a whole state dict, loaded into the runner
        once per state-dict object (the reference's cached placement)."""
        if self._cache["source"] is not variables:
            self.runner.load_state_dict(variables)
            self._cache["source"] = variables
            self._cache["placed"] = {
                f"{i}.{k}": v for i, m in enumerate(self.runner.shards)
                for k, v in m.state_dict().items()} \
                if hasattr(self.runner, "shards") else \
                self.runner.state_dict()
        return self._cache["placed"]

    def placed_bytes(self) -> int:
        """Bytes of the placed weights (0 until ``place_variables`` ran)."""
        placed = self._cache.get("placed")
        if placed is None:
            return 0
        return sum(t.numel() * t.element_size() for t in placed.values())

    def _check_rows(self, R: int) -> None:
        if R % self.dp:
            raise ValueError(
                f"packed rows {R} not divisible by data axis {self.dp}; "
                f"the engine's BucketLadder aligns rungs to the mesh — "
                f"pad rows with ladder.round_rows")

    def score_packed(self, variables, categorical, continuous, segments,
                     positions) -> torch.Tensor:
        """Sharded packed scoring: this rank's rows through the runner,
        the ``(R, L)`` probabilities all-gathered over the data axis.
        Nothing is synchronised."""
        self._check_rows(segments.shape[0])
        self.place_variables(variables)
        parts = shard_batch(self.mesh, (categorical, continuous, segments,
                                        positions))
        return _gather_rows(self.runner.score_packed(*parts), self.mesh)

    def score_spans(self, variables, categorical, continuous, mask
                    ) -> tuple[torch.Tensor, torch.Tensor]:
        """One trace a row (the autoencoder's route): this rank's rows
        through the runner's ``score_spans``, both outputs all-gathered
        over the data axis. Nothing is synchronised."""
        self._check_rows(mask.shape[0])
        self.place_variables(variables)
        parts = shard_batch(self.mesh, (categorical, continuous, mask))
        span, trace = self.runner.score_spans(*parts)
        return _gather_rows(span, self.mesh), _gather_rows(trace, self.mesh)


def compile_plan(model, mesh: DeviceMesh, *,
                 rules: tuple = PARTITION_RULES) -> ScoringPlan:
    """The (model, mesh) serving plan (the reference's ``donate`` has no
    twin: the port's calls allocate no buffer a caller could donate)."""
    return ScoringPlan(model, mesh, rules=rules)


def make_sharded_packed_score_fn(model, mesh: DeviceMesh, block: bool = True):
    """Data/tensor-parallel packed scoring over :func:`compile_plan`:
    ``fn(variables, cat, cont, segments, positions)``, the ``(R, L)``
    scores as numpy, or with ``block=False`` the device tensor unfetched
    (the engine harvests it)."""
    plan = compile_plan(model, mesh)

    def score(variables, cat, cont, segments, positions):
        span = plan.score_packed(variables, cat, cont, segments, positions)
        return span if not block else span.float().cpu().numpy()

    return score

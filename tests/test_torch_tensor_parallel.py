"""Tensor parallelism on the ``"model"`` axis, against the JAX package's.

The reference runs one process over the 8 virtual CPU devices
``tests/conftest.py`` provides and lets XLA partition its calls by
``PARTITION_RULES``; the port runs one gloo process a rank
(``parallel.launch.spawn``, one 4-rank spawn in this file, its rank
function in ``torch_parallel_ranks.py``) or every shard in one process
(``LocalModelAxis``, the stand-in ``chip_smoke.py`` drives on one card).

* the rule table: the shape heuristic ``transformer_param_spec`` and
  ``batch_spec`` are the reference's on every leaf; the port's
  ``param_specs`` equal the reference's
  ``ScoringPlan.param_specs`` leaf for leaf on ``{"data": 2, "model": 2}``,
  ``{"data": 1, "model": 4}`` and a non-dividing case (2 heads on a model
  axis of 4: the attention replicates, the FFN shards);
* ``shard_state``: each shard's leaves are the Flax leaves sliced by their
  guarded specs (the q/k/v heads as rows, ``out``'s as columns, FFN1's
  columns as rows, FFN2's rows as columns; the ``out`` and ``ff2`` biases
  whole), and ``unshard_state`` of the shards gives the state back;
* K23's plain version of K15's ``"partial"`` product is bit-equal to
  ``gemm_bf16_plain``'s ``"residual"`` and ``"none"`` at tp = 1, in bf16
  and f32, and the two partials' sum through it equals the whole product
  in f32;
* one block on the in-process model axis at tp 2 and 4 (and the
  non-dividing case) against the JAX ``EncoderBlock``, f32 within
  ``F32_TOL``;
* on four gloo ranks ``{"data": 2, "model": 2}``: ``make_sharded_score_fn``
  and the plan's ``score_packed`` against the JAX ``make_sharded_score_fn``
  and ``compile_plan`` on the same mesh within ``SCORE_ATOL`` in f32 and
  ``BF16_ATOL`` in bf16 (``tests/test_torch_model.py``'s bound of the port's
  bf16 path against JAX; the all-reduce adds the f32 partials where XLA
  adds bf16 ones, ``parallel/sharding.py``); three train steps against the
  JAX ``make_sharded_train_step`` with ``optax.adam``: losses within
  ``LOSS_RTOL``, the first step's gradients (the shards joined) within
  ``GRAD_RTOL``/``GRAD_ATOL`` of ``jax.grad``, the parameters within
  ``PARAM_ATOL`` (``tests/test_torch_parallel.py``'s bounds and reasons),
  every replicated parameter bit-equal over the model group and every
  parameter over the data group. The autoencoder on the axis is
  ``tests/test_torch_ae_tensor_parallel.py``'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from odigos_tpu.features import assemble_sequences, featurize
from odigos_tpu.features import pack_sequences as jpack
from odigos_tpu.models import TraceTransformer as JTraceTransformer
from odigos_tpu.models import TransformerConfig as JTransformerConfig
from odigos_tpu.models.layers import EncoderBlock as JaxBlock
from odigos_tpu.parallel import compile_plan as j_compile_plan
from odigos_tpu.parallel import make_mesh as j_make_mesh
from odigos_tpu.parallel import make_sharded_score_fn as j_score_fn
from odigos_tpu.parallel import make_sharded_train_step as j_train_step
from odigos_tpu.parallel import batch_spec as j_batch_spec
from odigos_tpu.parallel import shard_variables
from odigos_tpu.parallel import transformer_param_spec as \
    j_transformer_param_spec
from odigos_tpu.pdata import synthesize_traces
from odigos_tpu_torch.kernels.dense import (gemm_bf16_plain, tp_epilogue,
                                            tp_epilogue_plain)
from odigos_tpu_torch.models import TraceTransformer, TransformerConfig
from odigos_tpu_torch.models import flax_to_torch
from odigos_tpu_torch.models.layers import run_block
from odigos_tpu_torch.parallel import (LocalModelAxis, batch_spec,
                                       param_specs, shard_state,
                                       transformer_param_spec, unshard_state)
from odigos_tpu_torch.parallel.launch import spawn

import torch_parallel_ranks as ranks

torch.set_num_threads(1)

F32_TOL = 1e-5       # one block, f32 (the partials add in another order)
SCORE_ATOL = 2e-5    # the reference's sharded-scoring bound
BF16_ATOL = 2e-2     # the port's bf16 path against JAX (test_torch_model)
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-5
GRAD_ATOL = 1e-8
LR = 1e-3
STEPS = 3
PARAM_ATOL = 0.01 * STEPS * LR
SPAWN_TIMEOUT = 240.0
TINY = dict(d_model=32, n_heads=4, n_layers=1, d_ff=64, max_len=16)
GEOM = dict(d_model=64, n_heads=4, n_layers=1, d_ff=128, max_len=16)
MESHES = {"dp2xtp2": {"data": 2, "model": 2},
          "tp4": {"data": 1, "model": 4},
          "heads2_on_tp4": {"data": 2, "model": 4}}


def _jvars(cfg_kwargs, seed=0, dtype=jnp.float32):
    jm = JTraceTransformer(JTransformerConfig(dtype=dtype, **cfg_kwargs))
    return jm, jax.tree_util.tree_map(
        np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(seed)))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flat(v, key))
        else:
            out[key] = v
    return out


# ---------------------------------------------------------- the rule table
@pytest.mark.parametrize("which", list(MESHES))
def test_param_specs_are_the_reference_s(which):
    shape = MESHES[which]
    geom = dict(GEOM, n_heads=2) if which == "heads2_on_tp4" else GEOM
    jm, variables = _jvars(geom)
    want = j_compile_plan(jm, j_make_mesh(shape)).param_specs(variables)
    want = {"/".join(str(k.key) for k in path): tuple(s)
            for path, s in jax.tree_util.tree_leaves_with_path(
                want, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))}
    got = _flat(param_specs(variables, shape))
    assert got == want
    sharded = {k for k, s in got.items() if "model" in s}
    if which == "heads2_on_tp4":  # the attention group replicates
        assert sharded and not any("Attention" in k for k in sharded)
    else:
        assert any("query/kernel" in k for k in sharded)


@pytest.mark.parametrize("geom", [GEOM, dict(GEOM, d_model=32, d_ff=48)],
                         ids=["d64", "d32"])
def test_the_shape_heuristic_and_batch_spec_are_the_reference_s(geom):
    _, variables = _jvars(geom)
    leaves = jax.tree_util.tree_leaves_with_path(variables)
    for path, leaf in leaves:
        keys = tuple(k.key for k in path)
        assert transformer_param_spec(keys, leaf) == tuple(
            j_transformer_param_spec(keys, leaf)), keys
    assert batch_spec({"data": 2}) == tuple(j_batch_spec(None))


@pytest.mark.parametrize("which", list(MESHES))
def test_shard_state_slices_the_flax_leaves_and_reassembles(which):
    shape = MESHES[which]
    geom = dict(GEOM, n_heads=2) if which == "heads2_on_tp4" else GEOM
    _, variables = _jvars(geom)
    cfg = TransformerConfig(dtype=torch.float32, **geom)
    state = flax_to_torch(variables, cfg)
    specs = _flat(param_specs(variables, shape))
    flat = _flat(variables)
    tp = shape["model"]
    shards = [shard_state(state, shape, cfg, rank=r) for r in range(tp)]
    mha = "params/encoder/block_0/MultiHeadDotProductAttention_0"
    d, H = geom["d_model"], geom["n_heads"]
    for r, sh in enumerate(shards):
        def cut(path):  # the Flax leaf's rank-r slice by its spec
            a, spec = flat[path], specs[path]
            if "model" not in spec:
                return a
            ax = spec.index("model")
            return np.split(a, tp, axis=ax)[r]
        for proj in ("query", "key", "value"):
            k = cut(f"{mha}/{proj}/kernel")
            np.testing.assert_array_equal(
                sh[f"encoder.blocks.0.{proj}.weight"].numpy(),
                k.reshape(d, -1).T)
            heads = k.shape[1]
            np.testing.assert_array_equal(
                sh[f"encoder.blocks.0.{proj}.bias"].numpy(),
                np.split(flat[f"{mha}/{proj}/bias"], H // heads)[
                    r if heads < H else 0].reshape(-1))
        np.testing.assert_array_equal(sh["encoder.blocks.0.out.weight"].numpy(),
                                      cut(f"{mha}/out/kernel").reshape(-1, d).T)
        np.testing.assert_array_equal(
            sh["encoder.blocks.0.ff1.weight"].numpy(),
            cut("params/encoder/block_0/Dense_0/kernel").T)
        np.testing.assert_array_equal(
            sh["encoder.blocks.0.ff2.weight"].numpy(),
            cut("params/encoder/block_0/Dense_1/kernel").T)
        for whole in ("out.bias", "ff2.bias", "ln1.weight"):
            assert torch.equal(sh[f"encoder.blocks.0.{whole}"],
                               state[f"encoder.blocks.0.{whole}"])
    back = unshard_state(shards, shape, cfg)
    assert back.keys() == state.keys()
    for k in state:
        assert torch.equal(back[k], state[k]), k


# ------------------------------------------------------ K15 partial + K23
@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
def test_k23_of_a_whole_partial_is_k15_bit_for_bit(dt, residual):
    g = torch.Generator().manual_seed(7)
    M, K, N = 96, 64, 48
    x = torch.randn(M, K, generator=g).to(dt)
    w = (torch.randn(N, K, generator=g) / 8).to(dt)
    b = torch.randn(N, generator=g).to(dt)
    res = torch.randn(M, N, generator=g).to(dt) if residual else None
    acc = gemm_bf16_plain(x, w, None, "partial")
    assert acc.dtype == torch.float32 and acc.shape == (M, N)
    want = gemm_bf16_plain(x, w, b, "residual" if residual else "none",
                           res)
    got = tp_epilogue_plain(acc, b, res)
    assert got.dtype == dt and torch.equal(got, want)
    # the CPU wrapper is the plain version
    assert torch.equal(tp_epilogue(acc, b, res), got)
    # two shards' partials (K split in halves) add to the whole product
    if dt == torch.float32:
        p = [gemm_bf16_plain(x[:, h].contiguous(), w[:, h].contiguous(),
                             None, "partial")
             for h in (slice(0, K // 2), slice(K // 2, K))]
        np.testing.assert_allclose((p[0] + p[1]).numpy(), acc.numpy(),
                                   rtol=1e-6, atol=1e-5)


def test_partial_and_k23_refusals():
    x = torch.zeros(4, 16)
    w = torch.zeros(8, 16)
    with pytest.raises(ValueError, match="partial"):
        gemm_bf16_plain(x, w, torch.zeros(8), "partial")
    with pytest.raises(ValueError, match="partial"):
        gemm_bf16_plain(x, w, None, "partial", planes=2)
    with pytest.raises(ValueError, match="b must be"):
        gemm_bf16_plain(x, w, None, "none")
    with pytest.raises(TypeError, match="acc must be"):
        tp_epilogue_plain(torch.zeros(4, 8, dtype=torch.bfloat16),
                          torch.zeros(8, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="residual"):
        tp_epilogue_plain(torch.zeros(4, 8), torch.zeros(8),
                          torch.zeros(4, 9))


# ------------------------------------------------- a block on the axis
@pytest.mark.parametrize("heads,tp", [(4, 2), (4, 4), (2, 4)])
def test_a_block_on_the_in_process_axis_matches_flax(heads, tp):
    geom = dict(GEOM, n_heads=heads)
    _, variables = _jvars(geom, seed=1)
    cfg = TransformerConfig(dtype=torch.float32, **geom)
    axis = LocalModelAxis(tp)
    pm = TraceTransformer(cfg, device="cpu", model_axis=axis)
    pm.load_state_dict(flax_to_torch(variables, cfg))
    blocks = [e.blocks[0] for e in pm.module.encoder.peers]
    assert len(blocks) == tp
    assert blocks[0].tp_attn == (tp if heads % tp == 0 else 1)
    assert blocks[0].n_heads == heads // blocks[0].tp_attn
    L, d = geom["max_len"], geom["d_model"]
    pk = jpack(synthesize_traces(12, seed=1), max_len=L,
               pad_rows_to=lambda r: max(r, 6))
    seg = pk.segments[:6]
    x = np.random.default_rng(1).normal(0, 1, (6, L, d)).astype(np.float32)
    mask = seg > 0
    attn = ((seg[..., None] == seg[..., None, :]) & mask[..., None]
            & mask[..., None, :])[:, None]
    block = JaxBlock(d, heads, geom["d_ff"], jnp.float32)
    ref = np.asarray(jax.jit(block.apply)(
        {"params": variables["params"]["encoder"]["block_0"]},
        jnp.asarray(x), jnp.asarray(attn)))
    with torch.inference_mode():
        got = run_block(blocks, axis, torch.from_numpy(x),
                        torch.from_numpy(seg.astype(np.int32))).numpy()
    assert np.abs(got[mask] - ref[mask]).max() <= F32_TOL


# ---------------------------------------------- four gloo ranks, dp x tp
def _seqs(n_traces: int, seed: int):
    b = synthesize_traces(n_traces, seed=seed)
    return assemble_sequences(b, featurize(b), max_len=16)


def _packed(n_traces: int, seed: int):
    b = synthesize_traces(n_traces, seed=seed)
    pk = jpack(b, featurize(b), max_len=16,
               pad_rows_to=lambda r: r + (r % 2))
    return (pk.categorical, pk.continuous, pk.segments, pk.positions)


@pytest.fixture(scope="module")
def tp_case():
    jm, variables = _jvars(TINY)
    jm_bf = JTraceTransformer(JTransformerConfig(dtype=jnp.bfloat16, **TINY))
    cfg = TransformerConfig(dtype=torch.float32, **TINY)
    state = {k: v.numpy() for k, v in flax_to_torch(variables, cfg).items()}
    score_inputs = [(s.categorical, s.continuous, s.mask)
                    for s in (_seqs(5, 1), _seqs(12, 0))]
    packed_inputs = [_packed(9, 2), _packed(20, 5)]
    seqs = _seqs(14, 2)
    rng = np.random.default_rng(0)
    span_labels = (rng.random(seqs.mask.shape) < 0.2) & seqs.mask
    trace_labels = rng.random(seqs.mask.shape[0]) < 0.5
    train_inputs = (seqs.categorical, seqs.continuous, seqs.mask,
                    span_labels, trace_labels)
    got = spawn(ranks.tp_rank, 4, device="cpu",
                args=(TINY, state, score_inputs, packed_inputs, train_inputs,
                      STEPS, LR), timeout=SPAWN_TIMEOUT)
    mesh = j_make_mesh({"data": 2, "model": 2})
    ref = {}
    for name, model in (("f32", jm), ("bf16", jm_bf)):
        placed = shard_variables(variables, mesh)
        score = j_score_fn(model, mesh)
        ref[f"scores_{name}"] = [
            tuple(np.asarray(t, np.float32) for t in score(placed, *a))
            for a in score_inputs]
        plan = j_compile_plan(model, mesh)
        ref[f"packed_{name}"] = [np.asarray(plan.score_packed(variables, *a),
                                            np.float32)
                                 for a in packed_inputs]
    tx = optax.adam(LR)
    jvars = shard_variables(variables, mesh)
    opt_state = tx.init(jvars)
    jstep = j_train_step(jm, tx, mesh)
    losses = []
    for _ in range(STEPS):
        jvars, opt_state, loss = jstep(jvars, opt_state, *train_inputs)
        losses.append(float(loss))
    ref["losses"] = losses
    ref["params"] = {k: v.numpy() for k, v in flax_to_torch(
        jax.tree_util.tree_map(np.asarray, jvars), cfg).items()}
    grads = jax.jit(jax.grad(lambda vv: jm.loss_fn(
        vv, *(jnp.asarray(a) for a in train_inputs))))(variables)
    ref["grads"] = {k: v.numpy() for k, v in flax_to_torch(
        jax.tree_util.tree_map(np.asarray, grads), cfg).items()}
    return got, ref, cfg


def _joined(got, key, data, cfg):
    """The whole state from the model group of data coordinate ``data``."""
    group = sorted((r for r in got if r["coord"][0] == data),
                   key=lambda r: r["coord"][1])
    return {k: v.numpy() for k, v in unshard_state(
        [r[key] for r in group], {"model": 2}, cfg).items()}


@pytest.mark.parametrize("which", ["f32", "bf16"])
@pytest.mark.parametrize("case", [0, 1], ids=["5_traces_padded", "12_traces"])
def test_tp_scores_match_the_sharded_reference(tp_case, which, case):
    got, ref, _ = tp_case
    tol = SCORE_ATOL if which == "f32" else BF16_ATOL
    ref_span, ref_trace = ref[f"scores_{which}"][case]
    for r in got:
        span, trace = r[f"scores_{which}"][case]
        assert span.shape == ref_span.shape and trace.shape == ref_trace.shape
        np.testing.assert_allclose(span, ref_span, atol=tol)
        np.testing.assert_allclose(trace, ref_trace, atol=tol)


@pytest.mark.parametrize("which", ["f32", "bf16"])
@pytest.mark.parametrize("case", [0, 1])
def test_tp_plan_score_packed_matches_compile_plan(tp_case, which, case):
    got, ref, _ = tp_case
    tol = SCORE_ATOL if which == "f32" else BF16_ATOL
    want = ref[f"packed_{which}"][case]
    for r in got:
        p = r[f"packed_{which}"][case]
        assert p.shape == want.shape
        np.testing.assert_allclose(p, want, atol=tol)
        assert r[f"placed_bytes_{which}"] > 0
        assert "not divisible by data axis 2" in r["odd_rows"]


def test_tp_train_losses_match_the_sharded_reference(tp_case):
    got, ref, _ = tp_case
    for r in got:
        np.testing.assert_allclose(r["losses"], ref["losses"],
                                   rtol=LOSS_RTOL)
        assert r["unsharded_step"].startswith("ValueError")
        assert "shard_model" in r["unsharded_step"]


def test_tp_first_step_gradients_match_jax_grad(tp_case):
    got, ref, cfg = tp_case
    for data in (0, 1):
        grads = _joined(got, "grads", data, cfg)
        for name, want in ref["grads"].items():
            bound = GRAD_RTOL * np.abs(want).max() + GRAD_ATOL
            err = np.abs(grads[name] - want).max()
            assert err <= bound, (name, err, bound)


def test_tp_train_parameters_match_and_replicas_agree(tp_case):
    got, ref, cfg = tp_case
    params = [_joined(got, "params", data, cfg) for data in (0, 1)]
    for name, want in ref["params"].items():
        p = params[0][name]
        if name.endswith("key.bias"):
            assert np.abs(p).max() <= 1.01 * STEPS * LR, name
        else:
            err = np.abs(p - want).max()
            assert err <= PARAM_ATOL, (name, err, PARAM_ATOL)
        # the data group took the same updates
        np.testing.assert_array_equal(p, params[1][name])
    # each replicated parameter is bit-equal over the model group
    by = {r["coord"]: r["params"] for r in got}
    for name, v in by[(0, 0)].items():
        if v.shape == by[(0, 1)][name].shape and not any(
                name.endswith(f"{lin}.weight") or name.endswith(f"{lin}.bias")
                for lin in ("query", "key", "value", "ff1")) and not (
                name.endswith(("out.weight", "ff2.weight"))):
            np.testing.assert_array_equal(v, by[(0, 1)][name], err_msg=name)

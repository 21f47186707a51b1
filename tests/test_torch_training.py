"""The port's trainer and its backward passes on the CPU, against the JAX
package's.

At ``TINY`` (d 32, d_ff 64, 2 layers, 2 heads), ``max_len`` 16 and 16
traces a step, in f32, with inputs made from seeds:

* the labelled stream (``inject_faults``, ``labeled_sequences``,
  ``training_stream`` and its resume) is bit-equal to the JAX package's;
* each backward plain version (K16-K19's twins) equals ``torch.autograd``
  of its plain forward in f64 within ``F64_ATOL``, and its Function
  passes ``torch.autograd.gradcheck`` (f64, padding slots and an
  all-padding row);
* one step's gradients through the Functions equal ``jax.grad`` of the
  reference ``loss_fn`` within ``GRAD_RTOL`` of each parameter's largest
  gradient (plus ``GRAD_ATOL``: each key bias's true gradient is 0, the
  softmax being blind to a constant a query, so both sides hold rounding
  noise there);
* the port's ``Trainer`` and the JAX ``Trainer`` from the same initial
  weights agree on 8 losses within ``LOSS_RTOL`` and on every parameter
  after them within ``PARAM_ATOL``, but the key biases: Adam normalises
  their noise gradients to steps of about the learning rate, so both
  wander within the schedule's total learning rate;
* the learning-rate schedule equals optax's at every step (``LR_RTOL``:
  optax computes in f32) and one AdamW update equals ``optax.adamw``'s
  within ``ADAM_ATOL``;
* twins of ``tests/test_training.py`` and ``tests/test_checkpoint.py``,
  and a JAX bundle imported by ``tools/torch_import_bundle.py`` scoring in
  the port's engine within ``F32_TOL`` of the JAX engine (and within the
  int8 bound of ``tests/test_torch_quantized.py`` when quantized).
"""

import importlib.util
import os
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from odigos_tpu.pdata import inject_faults as j_inject
from odigos_tpu.pdata import synthesize_traces as j_synth
from odigos_tpu.serving.engine import EngineConfig as JEngineConfig
from odigos_tpu.serving.engine import ScoringEngine as JEngine
from odigos_tpu.training import TrainConfig as JTrainConfig
from odigos_tpu.training import Trainer as JTrainer
from odigos_tpu.training import labeled_sequences as j_labeled
from odigos_tpu.training import training_stream as j_stream
from odigos_tpu_torch.features import featurize
from odigos_tpu_torch.kernels import attention, autograd, dense, embed
from odigos_tpu_torch.models import (TransformerConfig, flax_to_torch)
from odigos_tpu_torch.pdata import FAULT_KINDS, inject_faults
from odigos_tpu_torch.pdata import synthesize_traces
from odigos_tpu_torch.serving import EngineConfig, ScoringEngine
from odigos_tpu_torch.serving.sidecar import (SidecarClient, SidecarServer,
                                              build_parser, engine_config)
from odigos_tpu_torch.training import (TrainConfig, Trainer,
                                       evaluate_detector, labeled_sequences,
                                       load_bundle, make_model_config,
                                       roc_auc, save_bundle,
                                       training_stream)
from odigos_tpu_torch.training.evaluate import (quantized_transformer_scorer,
                                                transformer_scorer)
from odigos_tpu_torch.training.trainer import lr_schedule

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(d_model=32, d_ff=64, n_layers=2, n_heads=2)
SEEDS = (0, 1, 2)
F64_ATOL = 1e-10      # backward plain vs autograd of the plain forward
# K19 takes 3 K as f32(3 K), a relative 2^-24 off: at most 2^-24 of
# |0.5 x (1 - t^2) C 3K x^2 dy| < 0.2 on these inputs
GELU_ATOL = 2e-8
GRAD_RTOL = 1e-5      # measured ~1e-6 of each parameter's largest gradient
GRAD_ATOL = 1e-8      # the key biases' zero gradient, rounding noise
LOSS_RTOL = 1e-5      # measured 7e-7 over 8 steps
PARAM_ATOL = 1e-5     # measured 1.5e-6 after 8 steps
LR_RTOL = 1e-6        # optax's schedule in f32 ...
LR_ATOL = 2.0 ** -21  # ... near its end: f32 steps of the peak (x peak)
ADAM_ATOL = 2.5e-7    # two f32 steps at |p| < 2: the updates' rounding
F32_TOL = 1e-5        # tests/test_torch_serving.py's engine bound
INT8_MAX = 2.7e-3     # tests/test_torch_quantized.py's SCORER_F32_MAX

COMMON = dict(traces_per_step=16, max_len=16, learning_rate=3e-3,
              warmup_steps=2, seed=0)


def _j_state(jtrainer, variables):
    return flax_to_torch(jax.tree.map(np.asarray, variables),
                         jtrainer.model.cfg)


def _import_tool():
    spec = importlib.util.spec_from_file_location(
        "torch_import_bundle", ROOT / "tools" / "torch_import_bundle.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------------- (a) data
@pytest.mark.parametrize("seed", SEEDS)
def test_inject_faults_bit_equal(seed):
    b, jb = synthesize_traces(120, seed=seed), j_synth(120, seed=seed)
    got = inject_faults(b, fault_fraction=0.3, seed=seed + 1)
    ref = j_inject(jb, fault_fraction=0.3, seed=seed + 1)
    assert (got[1] == ref[1]).all()
    assert [(r.kind, r.trace_id_lo, r.service) for r in got[2]] == \
        [(r.kind, r.trace_id_lo, r.service) for r in ref[2]]
    assert set(got[0].columns) == set(ref[0].columns)
    for name, col in got[0].columns.items():
        np.testing.assert_array_equal(col, ref[0].columns[name])
    assert FAULT_KINDS == ("latency_spike", "error_storm", "slow_dependency",
                           "missing_subtree")


def _same_sequences(a, b):
    for f in ("categorical", "continuous", "mask", "span_labels",
              "trace_labels"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("seed", SEEDS)
def test_labeled_sequences_and_stream_bit_equal(seed):
    _same_sequences(labeled_sequences(24, max_len=16, seed=seed,
                                      pad_traces_to=32),
                    j_labeled(24, max_len=16, seed=seed, pad_traces_to=32))
    ours = training_stream(8, max_len=16, seed=seed)
    theirs = j_stream(8, max_len=16, seed=seed)
    for _ in range(3):
        (s1, a), (s2, b) = next(ours), next(theirs)
        assert s1 == s2
        _same_sequences(a, b)
    # resume: step 2 regenerated on its own
    (s3, c) = next(training_stream(8, max_len=16, seed=seed, start_step=2))
    assert s3 == 2
    _same_sequences(c, b)


# ------------------------------------- the reference's initial weights
# jax_init reproduces JAX's threefry bits and uniforms exactly; its f32
# erfinv is XLA's polynomial in numpy's ops (XLA may fuse or round its
# log1p otherwise): measured 4.3e-7 of each parameter's largest magnitude
INIT_RTOL = 2.0 ** -20


@pytest.mark.parametrize("kw,seed", [
    (dict(TINY, max_len=16, attr_slots=2), 3),
    (dict(max_len=32), 0)])   # the trainer's default geometry and seed
def test_jax_init_reproduces_the_reference_draws(kw, seed):
    from odigos_tpu.models import TraceTransformer as JT
    from odigos_tpu.models import TransformerConfig as JC
    from odigos_tpu_torch.models import jax_init

    jc = JC(dtype=jnp.float32, **kw)
    ref = jax.tree.map(np.asarray, JT(jc).init(jax.random.PRNGKey(seed)))
    cfg = TransformerConfig(dtype=torch.float32, **kw)
    got = jax_init.transformer_state(cfg, seed)
    want = flax_to_torch(ref, cfg)
    assert set(got) == set(want)
    for name, r in want.items():
        lim = INIT_RTOL * r.abs().max().item()
        assert (got[name] - r).abs().max().item() <= lim, name
    # the trainer starts there
    tr = Trainer(TrainConfig(model_kwargs=dict(kw), max_len=kw["max_len"],
                             seed=seed), device="cpu")
    for name, t in tr.model.state_dict().items():
        torch.testing.assert_close(t, got[name], atol=0, rtol=0)


def test_jax_prng_pieces_are_the_reference_bits():
    from odigos_tpu_torch.models import jax_init

    key = jax.random.fold_in(jax.random.PRNGKey(7), 123456789)
    mine = jax_init.fold_in(jax_init.prng_key(7), 123456789)
    assert mine == tuple(int(w) for w in jax.random.key_data(key))
    np.testing.assert_array_equal(jax_init.random_bits(mine, (3, 5)),
                                  np.asarray(jax.random.bits(key, (3, 5))))
    np.testing.assert_array_equal(
        jax_init.uniform(mine, (1000,), -0.5, 2.0),
        np.asarray(jax.random.uniform(key, (1000,), minval=-0.5,
                                      maxval=2.0)))
    for mine_draw, ref in (
            (jax_init.normal(mine, (4096,)), jax.random.normal(key, (4096,))),
            (jax_init.truncated_normal(mine, (4096,)),
             jax.random.truncated_normal(key, -2.0, 2.0, (4096,)))):
        np.testing.assert_allclose(mine_draw, np.asarray(ref), rtol=0,
                                   atol=1e-6)


def test_init_parameters_draws_lecun_variance():
    """The port's own random init (serving's random weights): a dense
    kernel's variance after the truncation is 1 / fan_in, as Flax's
    lecun_normal (the truncated normal is widened by 1 / 0.8796)."""
    from odigos_tpu_torch.models.layers import init_parameters

    lin = torch.nn.Linear(256, 1024)
    init_parameters(lin, torch.Generator().manual_seed(0))
    std = lin.weight.std().item()
    assert abs(std * 16.0 - 1.0) < 0.01, std
    assert lin.weight.abs().max().item() <= 2 / 16 / 0.87962566103423978


# ------------------------------------------------ (b) backward plain versions
def _rng_inputs(seed: int = 0):
    """Attention inputs in f64 with padding slots and an all-padding row."""
    g = np.random.default_rng(seed)
    R, L, H, hd = 3, 6, 2, 4
    qkv = torch.from_numpy(g.standard_normal((3, R, L, H, hd)))
    seg = torch.tensor([[1, 1, 2, 2, 2, 0],      # two traces and padding
                        [1, 1, 1, 1, 0, 0],
                        [0, 0, 0, 0, 0, 0]],     # an all-padding row
                       dtype=torch.int32)
    return qkv, seg


def test_attention_bwd_plain_is_autograd_of_the_plain_forward():
    qkv, seg = _rng_inputs()
    q, k, v = (t.clone().requires_grad_() for t in qkv)
    R, L, H, _ = q.shape
    lse = torch.empty((R, H, L), dtype=torch.float64)
    o = attention.segment_attention_plain(q, k, v, seg, lse)
    do = torch.from_numpy(np.random.default_rng(1).standard_normal(o.shape))
    ref = torch.autograd.grad(o, (q, k, v), do)
    got = attention.segment_attention_bwd_plain(
        q.detach(), k.detach(), v.detach(), seg, o.detach(), lse, do)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, atol=F64_ATOL, rtol=0)
    # the padding query's gradients: dq is 0; it still feeds dv (uniform)
    assert (got[0][2] == 0).all() and (got[0][0, 5] == 0).all()
    assert np.isfinite(torch.stack(got).numpy()).all()


def test_attention_function_gradcheck():
    qkv, seg = _rng_inputs(2)
    qkv.requires_grad_()
    assert torch.autograd.gradcheck(
        lambda t: autograd.attention(t, seg), (qkv,), eps=1e-6, atol=1e-7)


def test_ln_bwd_plain_is_autograd_of_the_plain_forward():
    g = np.random.default_rng(3)
    x = torch.from_numpy(g.standard_normal((7, 16)) * 3 + 1)
    x[4] = 0.0  # a padding row: var 0, rstd 1 / sqrt(eps)
    w = torch.from_numpy(g.standard_normal(16))
    b = torch.from_numpy(g.standard_normal(16))
    dy = torch.from_numpy(g.standard_normal((7, 16)))
    dy[4] = 0.0
    xs, ws, bs = (t.clone().requires_grad_() for t in (x, w, b))
    y = dense.ln_bf16_plain(xs, ws, bs, 1e-6)
    ref = torch.autograd.grad(y, (xs, ws, bs), dy)
    got = dense.ln_bwd_plain(x, w, dy, 1e-6)
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, atol=F64_ATOL, rtol=0)
    assert (got[0][4] == 0).all()
    assert torch.autograd.gradcheck(
        lambda t, u, c: autograd.layer_norm(t, u, c, 1e-6),
        (xs, ws, bs), eps=1e-6, atol=1e-6)


@pytest.mark.parametrize("epilogue", ["none", "residual", "gelu_tanh"])
def test_dense_bwd_is_autograd_of_the_plain_forward(epilogue):
    g = np.random.default_rng(4)
    x = torch.from_numpy(g.standard_normal((5, 8))).requires_grad_()
    w = torch.from_numpy(g.standard_normal((6, 8)) / 3).requires_grad_()
    b = torch.from_numpy(g.standard_normal(6)).requires_grad_()
    res = torch.from_numpy(g.standard_normal((5, 6))).requires_grad_() \
        if epilogue == "residual" else None
    ins = (x, w, b) + ((res,) if res is not None else ())
    y = dense.gemm_bf16_plain(x, w, b, epilogue, res)
    dy = torch.from_numpy(g.standard_normal(y.shape))
    ref = torch.autograd.grad(y, ins, dy)
    y2 = autograd.dense(x, [w], [b], epilogue, res)
    got = torch.autograd.grad(y2, ins, dy)
    atol = GELU_ATOL if epilogue == "gelu_tanh" else F64_ATOL
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, atol=atol, rtol=0)
    assert torch.autograd.gradcheck(
        lambda *t: autograd.dense(t[0], [t[1]], [t[2]], epilogue,
                                  t[3] if len(t) > 3 else None),
        ins, eps=1e-6, atol=1e-6)


def test_gelu_bwd_plain_is_autograd_of_the_plain_gelu():
    g = np.random.default_rng(5)
    pre = torch.from_numpy(g.standard_normal((9, 12)) * 3).requires_grad_()
    dy = torch.from_numpy(g.standard_normal((9, 12)))
    y = dense.gelu_tanh_plain(pre)
    (ref,) = torch.autograd.grad(y, pre, dy)
    dpre, db = dense.gelu_tanh_bwd_plain(dy, pre.detach())
    torch.testing.assert_close(dpre, ref, atol=GELU_ATOL, rtol=0)
    torch.testing.assert_close(db, ref.sum(0), atol=9 * GELU_ATOL, rtol=0)


def test_fused_qkv_planes_route_gradients_to_their_parts():
    g = np.random.default_rng(6)
    x = torch.from_numpy(g.standard_normal((5, 8))).requires_grad_()
    ws = [torch.from_numpy(g.standard_normal((8, 8)) / 3).requires_grad_()
          for _ in range(3)]
    bs = [torch.from_numpy(g.standard_normal(8)).requires_grad_()
          for _ in range(3)]
    y = autograd.dense(x, ws, bs, planes=3)
    assert y.shape == (3, 5, 8)
    dy = torch.from_numpy(g.standard_normal(y.shape))
    got = torch.autograd.grad(y, [x, *ws, *bs], dy)
    ref_y = torch.stack([x @ w.t() + b for w, b in zip(ws, bs)])
    ref = torch.autograd.grad(ref_y, [x, *ws, *bs], dy)
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, atol=F64_ATOL, rtol=0)


@pytest.mark.parametrize("attr_slots", [0, 2])
def test_span_embed_bwd_is_autograd_of_the_plain_forward(attr_slots):
    g = np.random.default_rng(7 + attr_slots)
    R, L, d = 3, 5, 8
    C = 5 + attr_slots
    cat = torch.from_numpy(g.integers(-1, 9, (R, L, C)).astype(np.int32))
    cont = torch.from_numpy(g.standard_normal((R, L, 3)).astype(np.float32))
    pos = torch.from_numpy(g.integers(0, 7, (R, L)).astype(np.int32))
    seg = torch.tensor([[1, 1, 2, 0, 0], [1, 1, 1, 1, 1], [0] * 5],
                       dtype=torch.int32)

    def tab(rows, cols=d):
        return torch.from_numpy(g.standard_normal((rows, cols))
                                ).requires_grad_()

    tables = embed.EmbedTables(
        service=tab(6), name=tab(7), kind=tab(8), status=tab(4),
        attr=tab(5) if attr_slots else None, cont_w=tab(d, 3),
        cont_b=torch.from_numpy(g.standard_normal(d)).requires_grad_(),
        pos=tab(6))
    params = tables.tensors()
    y = embed.span_embed_plain(cat, cont, pos, seg, tables, torch.float64)
    dy = torch.from_numpy(g.standard_normal(y.shape))
    ref = torch.autograd.grad(y, params, dy)
    y2 = autograd.span_embed(cat, cont, pos, seg, tables, torch.float64)
    got = torch.autograd.grad(y2, params, dy)
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, atol=F64_ATOL, rtol=0)
    # ids past a table make their live slots NaN (nn.Embed's fill mode):
    # finite differences run on the slots that stay finite
    finite = torch.isfinite(y.detach()).all(-1)
    assert (~finite).any() and finite.any()
    assert torch.autograd.gradcheck(
        lambda *t: autograd.span_embed(
            cat, cont, pos, seg, embed.EmbedTables(
                *(t[:4] + ((t[4],) if attr_slots else (None,))
                  + t[-3:])), torch.float64)[finite],
        tuple(params), eps=1e-6, atol=1e-6)


# ------------------------------------------- (c) one step vs jax.grad
def test_one_step_gradients_match_jax_grad():
    from odigos_tpu.models import TraceTransformer as JT
    from odigos_tpu.models import TransformerConfig as JC
    from odigos_tpu_torch.models import TraceTransformer

    jm = JT(JC(max_len=16, dtype=jnp.float32, **TINY))
    v = jm.init(jax.random.PRNGKey(0))
    d = j_labeled(16, max_len=16, seed=0, pad_traces_to=16)
    args = [jnp.asarray(a) for a in (d.categorical, d.continuous, d.mask,
                                     d.span_labels, d.trace_labels)]
    jl, jg = jax.value_and_grad(lambda vv: jm.loss_fn(vv, *args))(v)
    cfg = TransformerConfig(max_len=16, dtype=torch.float32, **TINY)
    m = TraceTransformer(cfg, device="cpu")
    m.load_state_dict(flax_to_torch(jax.tree.map(np.asarray, v), cfg))
    m.module.train()
    loss = m.loss_fn(d.categorical, d.continuous, d.mask, d.span_labels,
                     d.trace_labels)
    loss.backward()
    assert abs(loss.item() - float(jl)) <= 1e-6
    ref = flax_to_torch(jax.tree.map(np.asarray, jg), cfg)
    for name, p in m.module.named_parameters():
        r = ref[name]
        bound = GRAD_RTOL * r.abs().max().item() + GRAD_ATOL
        err = (p.grad - r).abs().max().item()
        assert err <= bound, (name, err, bound)


# --------------------------------------- (d) 8 steps vs the JAX Trainer
def test_eight_steps_match_the_jax_trainer():
    jt = JTrainer(JTrainConfig(steps=8, model_kwargs=TINY, **COMMON))
    jres = jt.train()
    init = _j_state(jt, jt._init_variables())
    pt = Trainer(TrainConfig(steps=8, model_kwargs=TINY, **COMMON),
                 device="cpu", initial_state=init)
    pres = pt.train()
    np.testing.assert_allclose(pres.losses, jres.losses, rtol=LOSS_RTOL)
    final = _j_state(jt, jres.variables)
    total_lr = sum(lr_schedule(s, COMMON["learning_rate"],
                               COMMON["warmup_steps"], 8) for s in range(8))
    for name, ref in final.items():
        got = pres.variables[name]
        if name.endswith("key.bias"):
            # zero true gradient: each side walks Adam-normalised noise
            assert got.abs().max() <= 1.01 * total_lr
            assert ref.abs().max() <= 1.01 * total_lr
            continue
        err = (got - ref).abs().max().item()
        assert err <= PARAM_ATOL, (name, err)


# ------------------------------------------- (e) schedule and AdamW
@pytest.mark.parametrize("warmup,decay", [(20, 200), (2, 8), (0, 10)])
def test_schedule_matches_optax(warmup, decay):
    ref = optax.warmup_cosine_decay_schedule(0.0, 3e-3, warmup, decay)
    for step in range(decay + 10):
        np.testing.assert_allclose(lr_schedule(step, 3e-3, warmup, decay),
                                   float(ref(step)), rtol=LR_RTOL,
                                   atol=LR_ATOL * 3e-3)
    # the trainer's LambdaLR: lr 0 at step 0 after warmup > 0
    tr = Trainer(TrainConfig(steps=decay, warmup_steps=warmup,
                             model_kwargs=TINY, max_len=16,
                             learning_rate=3e-3), device="cpu")
    opt, sched = tr._optimizer()
    for step in range(decay + 2):
        np.testing.assert_allclose(opt.param_groups[0]["lr"],
                                   float(ref(step)), rtol=LR_RTOL,
                                   atol=LR_ATOL * 3e-3)
        opt.step()
        sched.step()
    assert float(ref(0)) == 0.0 or warmup == 0


def test_schedule_refuses_what_optax_refuses():
    with pytest.raises(ValueError):
        optax.warmup_cosine_decay_schedule(0.0, 3e-3, 20, 8)(0)
    with pytest.raises(ValueError, match="decay"):
        Trainer(TrainConfig(steps=8, warmup_steps=20, model_kwargs=TINY,
                            max_len=16), device="cpu").train()


def test_adamw_update_matches_optax():
    g = np.random.default_rng(8)
    params = {n: g.standard_normal(s).astype(np.float32)
              for n, s in (("a", (4, 3)), ("b", (5,)))}
    grads = [{n: g.standard_normal(p.shape).astype(np.float32)
              for n, p in params.items()} for _ in range(3)]
    tx = optax.adamw(1e-2, weight_decay=1e-4)
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)
    tp = {n: torch.tensor(p, requires_grad=True) for n, p in params.items()}
    opt = torch.optim.AdamW(list(tp.values()), lr=1e-2, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=1e-4)
    for gr in grads:
        upd, state = tx.update(jax.tree.map(jnp.asarray, gr), state, jp)
        jp = optax.apply_updates(jp, upd)
        for n, t in tp.items():
            t.grad = torch.from_numpy(gr[n])
        opt.step()
        for n, t in tp.items():
            np.testing.assert_allclose(t.detach().numpy(),
                                       np.asarray(jp[n]), rtol=0,
                                       atol=ADAM_ATOL)


# ------------------------------------------ (f) twins of test_training.py
def test_transformer_loss_decreases():
    cfg = TrainConfig(steps=12, model_kwargs=TINY, **COMMON)
    res = Trainer(cfg, device="cpu").train()
    assert len(res.losses) == 12
    assert res.losses[-1] < res.losses[0]
    assert set(res.step_seconds) == {"data", "forward", "backward",
                                     "optimizer"}


def test_reference_run_retraces_the_kernels_run_on_the_cpu():
    """``train(reference=True)`` (the smoke run's check of the first steps
    on the card) restarts from the same weights; on the CPU both runs take
    the plain versions, so they agree bit for bit."""
    cfg = TrainConfig(steps=3, schedule_steps=12, model_kwargs=TINY,
                      **COMMON)
    trainer = Trainer(cfg, device="cpu")
    a = trainer.train()
    b = trainer.train(reference=True)
    assert a.losses == b.losses
    for name, t in a.variables.items():
        torch.testing.assert_close(b.variables[name], t, atol=0, rtol=0)


def test_checkpoint_resume_is_bit_equal(tmp_path):
    common = dict(traces_per_step=8, max_len=16, model_kwargs=TINY,
                  warmup_steps=2, seed=3, schedule_steps=8,
                  checkpoint_dir=str(tmp_path / "ckpt"), checkpoint_every=4)
    Trainer(TrainConfig(steps=4, **common), device="cpu").train()
    res_b = Trainer(TrainConfig(steps=8, **common), device="cpu").train()
    assert res_b.start_step == 4
    assert len(res_b.losses) == 4  # only the remaining steps ran
    common["checkpoint_dir"] = str(tmp_path / "ckpt2")
    res_full = Trainer(TrainConfig(steps=8, **common), device="cpu").train()
    np.testing.assert_array_equal(res_full.losses[4:], res_b.losses)
    for name, t in res_full.variables.items():
        torch.testing.assert_close(res_b.variables[name], t, atol=0, rtol=0)


def test_restore_latest_and_keep_three(tmp_path):
    cfg = TrainConfig(steps=5, traces_per_step=8, max_len=16,
                      model_kwargs=TINY, warmup_steps=2, seed=1,
                      checkpoint_dir=str(tmp_path / "ckpt"),
                      checkpoint_every=1)
    res = Trainer(cfg, device="cpu").train()
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["3", "4", "5"]
    step, state = Trainer(cfg, device="cpu").restore_latest()
    assert step == 5
    assert set(state) == {"step", "variables", "optimizer", "scheduler"}
    for name, t in res.variables.items():
        torch.testing.assert_close(state["variables"][name], t, atol=0,
                                   rtol=0)
    assert Trainer(TrainConfig(model_kwargs=TINY, max_len=16,
                               checkpoint_dir=str(tmp_path / "none")),
                   device="cpu").restore_latest() == (None, None)


def test_trained_transformer_beats_chance_quickly():
    cfg = TrainConfig(steps=30, traces_per_step=32, max_len=32,
                      model_kwargs=TINY, learning_rate=5e-3,
                      warmup_steps=5, seed=7)
    tr = Trainer(cfg, device="cpu")
    res = tr.train()
    ev = evaluate_detector(transformer_scorer(tr.model, res.variables,
                                              max_len=32),
                           n_traces=300, seed=70)
    assert ev["auc"] > 0.6, ev
    qev = evaluate_detector(quantized_transformer_scorer(
        tr.model, res.variables, max_len=32), n_traces=300, seed=70)
    assert qev["auc"] > 0.6, qev


def test_autoencoder_and_card_only_refusals():
    from odigos_tpu_torch.models import AutoencoderConfig
    from odigos_tpu_torch.training.trainer import _build_model

    with pytest.raises(ValueError, match="unknown model"):
        Trainer(TrainConfig(model="zscore"), device="cpu")
    # the card-only refusals, for both models, before any card is touched
    for model in ("transformer", "autoencoder"):
        for kw, what in ((dict(dtype=torch.bfloat16), "float32"),
                         (dict(name_vocab=1 << 20), "embedding tables"),
                         (dict(d_model=40, n_heads=2), "d_model")):
            with pytest.raises(ValueError, match=what):
                _build_model(TrainConfig(model=model, model_kwargs=kw),
                             torch.device("cuda"))
    # the autoencoder trains on the CPU (tests/test_torch_ae_training.py)
    tr = Trainer(TrainConfig(model="autoencoder", model_kwargs=TINY,
                             max_len=16), device="cpu")
    assert isinstance(tr.model.cfg, AutoencoderConfig)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this pins the no-card path")
    for model in ("transformer", "autoencoder"):
        with pytest.raises(RuntimeError, match="is_available"):
            Trainer(TrainConfig(model=model))


class TestRocAuc:
    def test_perfect_separation(self):
        labels = np.array([0, 0, 0, 1, 1], dtype=bool)
        assert roc_auc(labels, np.array([.1, .2, .3, .8, .9])) == 1.0

    def test_random_is_half(self):
        rng = np.random.default_rng(0)
        labels = rng.random(5000) < 0.1
        assert abs(roc_auc(labels, rng.random(5000)) - 0.5) < 0.05

    def test_inverted_is_zero(self):
        labels = np.array([1, 1, 0, 0], dtype=bool)
        assert roc_auc(labels, np.array([.1, .2, .8, .9])) == 0.0

    def test_ties_midrank(self):
        labels = np.array([0, 1], dtype=bool)
        assert roc_auc(labels, np.array([.5, .5])) == 0.5

    def test_degenerate_nan(self):
        assert np.isnan(roc_auc(np.zeros(3, bool), np.zeros(3)))


# -------------------------------------- (g) twins of test_checkpoint.py
BUNDLE_TINY = {"d_model": 64, "n_layers": 1, "d_ff": 128, "n_heads": 2,
               "max_len": 16}


@pytest.fixture(scope="module")
def tiny_bundle(tmp_path_factory):
    cfg = TrainConfig(steps=2, traces_per_step=8, max_len=16, seed=3,
                      warmup_steps=1, model_kwargs=dict(BUNDLE_TINY))
    tr = Trainer(cfg, device="cpu")
    res = tr.train()
    path = tr.export(str(tmp_path_factory.mktemp("ck") / "b"), res.variables)
    return tr, res, path


def test_bundle_round_trip(tiny_bundle):
    tr, res, path = tiny_bundle
    b = load_bundle(path)
    assert b.model == "transformer"
    assert b.model_config == tr.model.cfg
    assert b.model_config.d_model == 64 and b.model_config.max_len == 16
    assert b.model_config.dtype == torch.float32
    assert set(b.variables) == set(res.variables)
    for name, t in res.variables.items():
        torch.testing.assert_close(b.variables[name], t, atol=0, rtol=0)
    # the artifact is plain tensors: it loads with weights_only
    torch.load(os.path.join(path, "variables.pt"), weights_only=True)


def test_engine_loads_bundle_geometry(tiny_bundle):
    tr, _, path = tiny_bundle
    for quantized in (False, True):
        eng = ScoringEngine(EngineConfig(model="transformer",
                                         checkpoint_path=path, device="cpu",
                                         quantized=quantized))
        be = eng.backend
        assert be.model.cfg.d_model == 64 and be.max_len == 16
        batch = synthesize_traces(5, seed=9)
        scores = be.score(batch, featurize(batch))
        assert scores.shape == (len(batch),)
        assert np.isfinite(scores).all() and (scores >= 0).all()
    # the bundle's weights, not the seed's
    batch = synthesize_traces(6, seed=4)
    eng = ScoringEngine(EngineConfig(model="transformer",
                                     checkpoint_path=path, device="cpu"))
    own = eng.backend.score(batch, featurize(batch))
    tr.model.load_state_dict(load_bundle(path).variables)
    ref = ScoringEngine(EngineConfig(model="transformer", device="cpu",
                                     model_config=tr.model.cfg, max_len=16))
    ref.backend.model.load_state_dict(load_bundle(path).variables)
    np.testing.assert_array_equal(own, ref.backend.score(batch,
                                                         featurize(batch)))


def test_engine_rejects_model_mismatch(tiny_bundle):
    _, _, path = tiny_bundle
    with pytest.raises(ValueError, match="transformer"):
        ScoringEngine(EngineConfig(model="autoencoder", checkpoint_path=path,
                                   device="cpu"))
    with pytest.raises(ValueError, match="disagrees"):
        ScoringEngine(EngineConfig(
            model="transformer", checkpoint_path=path, device="cpu",
            model_config=TransformerConfig(**dict(BUNDLE_TINY, d_model=32))))


def test_load_bundle_rejects_non_bundle(tmp_path):
    with pytest.raises(FileNotFoundError, match="serving bundle"):
        load_bundle(str(tmp_path))


def test_make_model_config_validation():
    cfg = make_model_config("transformer", {"d_model": 32,
                                            "dtype": "float32"})
    assert isinstance(cfg, TransformerConfig) and cfg.d_model == 32
    assert cfg.dtype == torch.float32
    with pytest.raises(TypeError):
        make_model_config("transformer", {"not_a_field": 1})
    with pytest.raises(ValueError, match="unsupported checkpoint dtype"):
        make_model_config("transformer", {"dtype": "int8"})
    with pytest.raises(ValueError, match="no config class"):
        make_model_config("zscore", {})


def test_save_bundle_writes_the_reference_schema(tmp_path):
    import json

    cfg = TransformerConfig(d_model=32, n_heads=2, n_layers=1, d_ff=64,
                            max_len=8, dtype=torch.float32)
    path = save_bundle(str(tmp_path / "b"), {"w": torch.ones(2)},
                       model="transformer", model_config=cfg)
    meta = json.loads((Path(path) / "model.json").read_text())
    assert meta["model"] == "transformer"
    assert meta["config"]["dtype"] == "float32"
    assert make_model_config("transformer", meta["config"]) == cfg


# ---------------------------- (h) a JAX bundle imported, scored alike
@pytest.fixture(scope="module")
def imported(tmp_path_factory):
    root = tmp_path_factory.mktemp("imp")
    jt = JTrainer(JTrainConfig(steps=2, traces_per_step=8, max_len=16,
                               seed=3, warmup_steps=1,
                               model_kwargs=dict(TINY)))
    jres = jt.train()
    jpath = jt.export(str(root / "jax"), jres.variables)
    ppath = _import_tool().import_bundle(jpath, str(root / "port"))
    return jpath, ppath


def test_imported_bundle_scores_like_the_jax_engine(imported):
    from odigos_tpu.features import featurize as j_featurize

    jpath, ppath = imported
    batch_j, batch_p = j_synth(20, seed=11), synthesize_traces(20, seed=11)
    for quantized, tol in ((False, F32_TOL), (True, INT8_MAX)):
        je = JEngine(JEngineConfig(model="transformer", checkpoint_path=jpath,
                                   quantized=quantized))
        pe = ScoringEngine(EngineConfig(model="transformer",
                                        checkpoint_path=ppath, device="cpu",
                                        quantized=quantized))
        assert pe.backend.model.cfg.max_len == 16
        ref = je.backend.score(batch_j, j_featurize(batch_j))
        got = pe.backend.score(batch_p, featurize(batch_p))
        np.testing.assert_allclose(got, ref, atol=tol, rtol=0)


def test_imported_autoencoder_bundle_loads_into_the_span_autoencoder(
        tmp_path):
    """An autoencoder bundle of the JAX package, imported by the tool,
    loads into the port's ``SpanAutoencoder`` and scores within F32_TOL of
    the JAX engine."""
    from odigos_tpu.features import featurize as j_featurize

    kw = dict(d_model=32, d_ff=64, d_latent=16, n_layers=1, n_heads=2)
    jt = JTrainer(JTrainConfig(model="autoencoder", steps=2,
                               traces_per_step=8, max_len=16, seed=3,
                               warmup_steps=1, model_kwargs=kw))
    jres = jt.train()
    jpath = jt.export(str(tmp_path / "jax"), jres.variables)
    ppath = _import_tool().import_bundle(jpath, str(tmp_path / "port"))
    assert load_bundle(ppath).model == "autoencoder"
    je = JEngine(JEngineConfig(model="autoencoder", checkpoint_path=jpath))
    pe = ScoringEngine(EngineConfig(model="autoencoder",
                                    checkpoint_path=ppath, device="cpu"))
    assert type(pe.backend.model).__name__ == "SpanAutoencoder"
    assert pe.backend.max_len == 16
    batch_j, batch_p = j_synth(12, seed=13), synthesize_traces(12, seed=13)
    np.testing.assert_allclose(
        pe.backend.score(batch_p, featurize(batch_p)),
        je.backend.score(batch_j, j_featurize(batch_j)), atol=F32_TOL,
        rtol=F32_TOL)


# ---------------------------------------------- (i) sidecar --checkpoint
def test_sidecar_checkpoint_flag_loads_on_the_cpu(tiny_bundle):
    _, _, path = tiny_bundle
    with tempfile.TemporaryDirectory() as d:  # a short socket path
        _serve_bundle_through_the_sidecar(path, os.path.join(d, "s.sock"))
    assert build_parser().parse_args(["--socket", "s"]).checkpoint is None


def _serve_bundle_through_the_sidecar(path: str, sock: str) -> None:
    args = build_parser().parse_args(
        ["--socket", sock, "--model", "transformer",
         "--checkpoint", path, "--device", "cpu", "--trace-bucket", "8",
         "--no-warm-ladder"])
    assert args.checkpoint == path
    cfg = engine_config(args)
    assert cfg.checkpoint_path == path
    engine = ScoringEngine(cfg)
    assert engine.backend.max_len == 16  # the bundle's geometry
    server = SidecarServer(engine, args.socket).start()
    client = SidecarClient(args.socket)
    try:
        client.ping()
        batch = synthesize_traces(6, seed=5)
        got = client.score(batch)
        ref = ScoringEngine(EngineConfig(model="transformer",
                                         checkpoint_path=path, device="cpu",
                                         trace_bucket=8)).backend.score(
            batch, featurize(batch))
        np.testing.assert_allclose(got, ref, atol=F32_TOL, rtol=0)
    finally:
        client.close()
        server.shutdown()

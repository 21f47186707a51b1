"""The port's autoencoder training on the CPU, against the JAX package's.

At ``TINY`` (d 32, d_ff 64, d_latent 16, 1 layer, 2 heads), ``max_len`` 16
and 16 traces a step, in f32, with inputs made from seeds:

* ``jax_init.autoencoder_params`` reproduces ``SpanAutoencoder.init(
  PRNGKey(seed))`` within ``INIT_RTOL`` (the transformer's bound), and the
  trainer starts there;
* the clean stream (``fault_fraction`` 0, the autoencoder's) is bit-equal
  to the reference's;
* K20's and K21's plain versions (``recon_ce_bwd_plain``,
  ``ln_masked_pool_bwd_plain``) equal ``torch.autograd`` of their plain
  forwards in f64 within ``F64_ATOL``, and their Functions pass
  ``torch.autograd.gradcheck`` (f64, padding positions and a trace with no
  real position); K11's plain log-sum-exps equal ``torch.logsumexp`` of
  the logits at real positions (0 elsewhere) and leave the errors as they
  were;
* one step's loss and gradients through the Functions equal
  ``jax.value_and_grad`` of the reference ``loss_fn`` within the
  transformer's ``GRAD_RTOL`` of each parameter's largest gradient, plus
  ``GRAD_FLOOR`` of the largest gradient of all: the key biases' true
  gradient is 0 here too, and their rounding noise grows with the
  gradients (the loss is ~80 here, ~1.9 for the transformer: the
  transformer's absolute ``GRAD_ATOL`` of 1e-8 scaled);
* the port's ``Trainer(model="autoencoder")`` and the JAX one from the same
  weights agree on 8 losses within ``LOSS_RTOL`` and on every parameter
  after them within ``PARAM_ATOL`` but the key biases (Adam-normalised
  noise: each side stays within the schedule's total learning rate);
* the loss falls; checkpoint resume is bit-equal; an exported bundle
  served by the engine on both CPU routes equals the trained model's own
  ``span_errors``, squashed and scattered to the spans (``F32_TOL``);
* the trainer's card-only refusals, by name, for both models.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odigos_tpu.models.autoencoder import AutoencoderConfig as JConfig
from odigos_tpu.models.autoencoder import SpanAutoencoder as JAutoencoder
from odigos_tpu.training import TrainConfig as JTrainConfig
from odigos_tpu.training import Trainer as JTrainer
from odigos_tpu.training import labeled_sequences as j_labeled
from odigos_tpu.training import training_stream as j_stream
from odigos_tpu_torch.features import (FeaturizerConfig, assemble_sequences,
                                       featurize)
from odigos_tpu_torch.kernels import autograd, pool, recon
from odigos_tpu_torch.models import (AutoencoderConfig, SpanAutoencoder,
                                     TransformerConfig,
                                     flax_autoencoder_to_torch)
from odigos_tpu_torch.models import jax_init
from odigos_tpu_torch.pdata import synthesize_traces
from odigos_tpu_torch.serving import EngineConfig, ScoringEngine
from odigos_tpu_torch.serving.fused import extract_columns
from odigos_tpu_torch.training import (TrainConfig, Trainer, load_bundle,
                                       training_stream)
from odigos_tpu_torch.training.trainer import card_checks, lr_schedule

torch.set_num_threads(1)

TINY = dict(d_model=32, d_ff=64, d_latent=16, n_layers=1, n_heads=2)
SEEDS = (0, 1, 2)
INIT_RTOL = 2.0 ** -20  # tests/test_torch_training.py's (XLA's erfinv)
F64_ATOL = 1e-10        # backward plain vs autograd of the plain forward
GRAD_RTOL = 1e-5        # the transformer's (tests/test_torch_training.py)
GRAD_FLOOR = 1e-9       # x the largest gradient (37 at TINY): the key
                        # biases' noise, measured 1.1e-8
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5
F32_TOL = 1e-5          # tests/test_torch_serving.py's engine bound
# loss weights that keep 1 - exp(-err) off its ceiling
WEIGHTS = dict(w_service=0.01, w_name=0.01, w_kind=0.005, w_duration=0.002)
COMMON = dict(model="autoencoder", traces_per_step=16, max_len=16,
              learning_rate=3e-3, warmup_steps=2, seed=0)


def _port_state(cfg, variables):
    return flax_autoencoder_to_torch(jax.tree.map(np.asarray, variables),
                                     cfg)


# ------------------------------------------------------- initial weights
@pytest.mark.parametrize("kw,seed", [
    (dict(TINY, max_len=16, attr_slots=2), 3),
    (dict(max_len=32), 0)])   # the trainer's default geometry and seed
def test_autoencoder_params_reproduce_the_reference_draws(kw, seed):
    jc = JConfig(dtype=jnp.float32, **kw)
    ref = jax.tree.map(np.asarray, JAutoencoder(jc).init(
        jax.random.PRNGKey(seed)))
    cfg = AutoencoderConfig(dtype=torch.float32, **kw)
    got = jax_init.autoencoder_state(cfg, seed)
    want = flax_autoencoder_to_torch(ref, cfg)
    assert set(got) == set(want)
    for name, r in want.items():
        lim = INIT_RTOL * r.abs().max().item()
        assert (got[name] - r).abs().max().item() <= lim, name
    tr = Trainer(TrainConfig(model="autoencoder", model_kwargs=dict(kw),
                             max_len=kw["max_len"], seed=seed), device="cpu")
    for name, t in tr.model.state_dict().items():
        torch.testing.assert_close(t, got[name], atol=0, rtol=0)


@pytest.mark.parametrize("seed", SEEDS)
def test_clean_stream_bit_equal(seed):
    ours = training_stream(8, fault_fraction=0.0, max_len=16, seed=seed)
    theirs = j_stream(8, fault_fraction=0.0, max_len=16, seed=seed)
    for _ in range(2):
        (s1, a), (s2, b) = next(ours), next(theirs)
        assert s1 == s2
        for f in ("categorical", "continuous", "mask", "span_labels",
                  "trace_labels"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert not a.span_labels.any()


# ------------------------------------------------ backward plain versions
def _positions(g, T=3, L=5, C=5):
    """``(T * L,)`` positions with padding and a trace (the last) with no
    real position."""
    mask = torch.tensor([[1, 1, 1, 0, 0], [1, 0, 1, 1, 1], [0] * 5],
                        dtype=torch.bool)[:T, :L]
    cat = torch.from_numpy(g.integers(0, 9, (T, L, C)).astype(np.int32))
    cont = torch.from_numpy(g.standard_normal((T, L, 3)).astype(np.float32))
    return mask, cat, cont


def _heads(g, d, vs=(7, 9, 8, 1)):
    return [(torch.from_numpy(g.standard_normal((v, d)) / 2).requires_grad_(),
             torch.from_numpy(g.standard_normal(v) / 2).requires_grad_())
            for v in vs]


WTS = (1.0, 0.7, 0.5, 0.3)


def test_recon_ce_bwd_plain_is_autograd_of_the_plain_forward():
    g = np.random.default_rng(0)
    mask, cat, cont = _positions(g)
    M, d = mask.numel(), 8
    dec = torch.from_numpy(g.standard_normal((M, d)) * 2 + 0.5)
    lw = torch.from_numpy(1 + g.standard_normal(d) / 4)
    lb = torch.from_numpy(g.standard_normal(d) / 4)
    heads = _heads(g, d)
    args = (cat.reshape(M, -1), cont.reshape(M, -1), mask.reshape(M))
    params = [dec, lw, lb] + [t for h in heads for t in h]
    for t in params[:3]:
        t.requires_grad_()
    err = recon.recon_ce_plain(dec, lw, lb, heads, *args, WTS)
    derr = torch.from_numpy(g.standard_normal(M))
    ref = torch.autograd.grad(err, params, derr)
    # K20's plain version then K17's plain version through dec_ln
    lse = torch.empty((M, 3), dtype=torch.float64)
    with torch.no_grad():
        recon.recon_ce_plain(dec, lw, lb, heads, *args, WTS, lse=lse)
        got = recon.recon_ce_bwd_plain(dec, lw, lb, heads, lse, *args, derr,
                                       WTS)
    assert (got.dy[~mask.reshape(M)] == 0).all()
    from odigos_tpu_torch.kernels import dense
    ddec, dlw, dlb = dense.ln_bwd_plain(dec.detach(), lw.detach(), got.dy)
    mine = [ddec, dlw, dlb] + [t for pair in got.heads for t in pair]
    for a, r in zip(mine, ref):
        torch.testing.assert_close(a, r, atol=F64_ATOL, rtol=0)
    # the Function (the trainer's route) and its gradient check; labels
    # 7 and 8 lie past the service head (7 rows) and 8 past the kind head:
    # those real positions' errors are NaN, as the reference's _ce gives
    # (fault C5), so gradcheck runs on the finite positions
    err2 = autograd.recon_ce(dec, lw, lb, heads, *args, WTS, 1e-6)
    torch.testing.assert_close(err2, err, atol=0, rtol=0, equal_nan=True)
    vs = torch.tensor([w.shape[0] for w, _ in heads[:3]])
    past = (args[0][:, :3] >= vs).any(1) & args[2]
    assert torch.equal(err.isnan(), past) and past.any()
    assert torch.autograd.gradcheck(
        lambda *t: autograd.recon_ce(
            t[0], t[1], t[2], list(zip(t[3::2], t[4::2])), *args, WTS,
            1e-6)[~past],
        tuple(params), eps=1e-6, atol=1e-6)


def test_recon_ce_plain_lse_is_logsumexp_at_real_positions():
    g = np.random.default_rng(1)
    mask, cat, cont = _positions(g)
    M, d = mask.numel(), 16
    dec = torch.from_numpy(g.standard_normal((M, d)).astype(np.float32))
    lw, lb = torch.ones(d), torch.zeros(d)
    heads = [(w.detach().float(), b.detach().float())
             for w, b in _heads(g, d)]
    args = (cat.reshape(M, -1), cont.reshape(M, -1), mask.reshape(M))
    lse = torch.full((M, 3), float("nan"))
    err = recon.recon_ce(dec, lw, lb, heads, *args, WTS, lse=lse)
    # labels past the service and kind heads: NaN errors there (fault C5),
    # the same with and without the buffer
    torch.testing.assert_close(
        err, recon.recon_ce(dec, lw, lb, heads, *args, WTS), atol=0, rtol=0,
        equal_nan=True)
    real = mask.reshape(M)
    from odigos_tpu_torch.kernels.quant import layer_norm_plain
    y = layer_norm_plain(dec[real], lw, lb)
    want = torch.stack([torch.logsumexp(y @ w.t() + b, -1)
                        for w, b in heads[:3]], -1)
    torch.testing.assert_close(lse[real], want, atol=1e-6, rtol=1e-6)
    assert (lse[~real] == 0).all()
    with pytest.raises(ValueError, match="lse"):
        recon.recon_ce(dec, lw, lb, heads, *args, WTS,
                       lse=torch.empty(M, 2))


def test_ln_masked_pool_bwd_plain_is_autograd_of_the_plain_forward():
    g = np.random.default_rng(2)
    mask, _, _ = _positions(g)
    T, L = mask.shape
    d = 8
    x = torch.from_numpy(g.standard_normal((T, L, d)) * 3 + 1)
    lw = torch.from_numpy(1 + g.standard_normal(d) / 4)
    lb = torch.from_numpy(g.standard_normal(d) / 4)
    xs, ws, bs = (t.clone().requires_grad_() for t in (x, lw, lb))
    y = pool.ln_masked_pool_plain(xs, ws, bs, mask)
    dpool = torch.from_numpy(g.standard_normal(y.shape))
    ref = torch.autograd.grad(y, (xs, ws, bs), dpool)
    got = pool.ln_masked_pool_bwd_plain(x, lw, mask, dpool)
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, atol=F64_ATOL, rtol=0)
    assert (got[0][~mask] == 0).all()
    assert torch.autograd.gradcheck(
        lambda t, u, c: autograd.ln_masked_pool(t, u, c, mask, 1e-6),
        (xs, ws, bs), eps=1e-6, atol=1e-6)


# -------------------------------------------- one step vs jax.grad
def test_one_step_loss_and_gradients_match_jax_grad():
    jm = JAutoencoder(JConfig(max_len=16, dtype=jnp.float32, **TINY))
    v = jm.init(jax.random.PRNGKey(0))
    d = j_labeled(16, fault_fraction=0.0, max_len=16, seed=0,
                  pad_traces_to=16)
    args = [jnp.asarray(a) for a in (d.categorical, d.continuous, d.mask)]
    jl, jg = jax.value_and_grad(lambda vv: jm.loss_fn(vv, *args))(v)
    cfg = AutoencoderConfig(max_len=16, dtype=torch.float32, **TINY)
    m = SpanAutoencoder(cfg, device="cpu")
    m.load_state_dict(_port_state(cfg, v))
    m.module.train()
    loss = m.loss_fn(d.categorical, d.continuous, d.mask)
    loss.backward()
    assert abs(loss.item() - float(jl)) <= LOSS_RTOL * abs(float(jl))
    ref = _port_state(cfg, jg)
    top = max(r.abs().max().item() for r in ref.values())
    for name, p in m.module.named_parameters():
        r = ref[name]
        bound = GRAD_RTOL * r.abs().max().item() + GRAD_FLOOR * top
        err = (p.grad - r).abs().max().item()
        assert err <= bound, (name, err, bound)
    # eval mode: the same loss, forward only
    m.module.eval()
    assert abs(m.loss_fn(d.categorical, d.continuous, d.mask).item()
               - loss.item()) <= 1e-6 * loss.item()


# ---------------------------------------- 8 steps vs the JAX Trainer
def test_eight_steps_match_the_jax_trainer():
    jt = JTrainer(JTrainConfig(steps=8, model_kwargs=TINY, **COMMON))
    jres = jt.train()
    cfg = jt.model.cfg
    pt = Trainer(TrainConfig(steps=8, model_kwargs=TINY, **COMMON),
                 device="cpu", initial_state=_port_state(
                     cfg, jt._init_variables()))
    pres = pt.train()
    np.testing.assert_allclose(pres.losses, jres.losses, rtol=LOSS_RTOL)
    final = _port_state(cfg, jres.variables)
    total_lr = sum(lr_schedule(s, COMMON["learning_rate"],
                               COMMON["warmup_steps"], 8) for s in range(8))
    for name, ref in final.items():
        got = pres.variables[name]
        if name.endswith("key.bias"):
            assert got.abs().max() <= 1.01 * total_lr
            assert ref.abs().max() <= 1.01 * total_lr
            continue
        err = (got - ref).abs().max().item()
        assert err <= PARAM_ATOL, (name, err)


# ------------------------------------------- twins of test_training.py
def test_autoencoder_loss_decreases():
    cfg = TrainConfig(steps=12, model_kwargs=TINY, **COMMON)
    res = Trainer(cfg, device="cpu").train()
    assert len(res.losses) == 12
    assert res.losses[-1] < res.losses[0]
    assert set(res.step_seconds) == {"data", "forward", "backward",
                                     "optimizer"}


def test_reference_run_retraces_the_kernels_run_on_the_cpu():
    cfg = TrainConfig(steps=3, schedule_steps=12, model_kwargs=TINY,
                      **COMMON)
    trainer = Trainer(cfg, device="cpu")
    a = trainer.train()
    b = trainer.train(reference=True)
    assert a.losses == b.losses
    for name, t in a.variables.items():
        torch.testing.assert_close(b.variables[name], t, atol=0, rtol=0)


def test_checkpoint_resume_is_bit_equal(tmp_path):
    common = dict(model="autoencoder", traces_per_step=8, max_len=16,
                  model_kwargs=TINY, warmup_steps=2, seed=3,
                  schedule_steps=8, checkpoint_dir=str(tmp_path / "ckpt"),
                  checkpoint_every=4)
    Trainer(TrainConfig(steps=4, **common), device="cpu").train()
    res_b = Trainer(TrainConfig(steps=8, **common), device="cpu").train()
    assert res_b.start_step == 4
    assert len(res_b.losses) == 4
    common["checkpoint_dir"] = str(tmp_path / "ckpt2")
    res_full = Trainer(TrainConfig(steps=8, **common), device="cpu").train()
    np.testing.assert_array_equal(res_full.losses[4:], res_b.losses)
    for name, t in res_full.variables.items():
        torch.testing.assert_close(res_b.variables[name], t, atol=0, rtol=0)
    step, state = Trainer(TrainConfig(steps=8, **common),
                          device="cpu").restore_latest()
    assert step == 8
    for name, t in res_full.variables.items():
        torch.testing.assert_close(state["variables"][name], t, atol=0,
                                   rtol=0)


# ------------------------------------------------ export, then serve
# the training stream's own vocabularies (the featurizer's defaults): an id
# past a model's table is NaN, as in the reference's nn.Embed
VOCAB = dict(service_vocab=512, name_vocab=2048)


def test_exported_bundle_serves_its_span_errors_on_both_routes(tmp_path):
    kw = dict(TINY, **VOCAB, **WEIGHTS)
    tr = Trainer(TrainConfig(model="autoencoder", steps=3,
                             traces_per_step=8, max_len=16, seed=4,
                             warmup_steps=1, model_kwargs=kw), device="cpu")
    res = tr.train()
    path = tr.export(str(tmp_path / "b"), res.variables)
    b = load_bundle(path)
    assert b.model == "autoencoder" and b.model_config == tr.model.cfg
    feat = FeaturizerConfig(**VOCAB)
    eng = ScoringEngine(EngineConfig(model="autoencoder",
                                     checkpoint_path=path, device="cpu",
                                     featurizer=feat, trace_bucket=8))
    be = eng.backend
    assert be.max_len == 16 and be.model.cfg.dtype == torch.float32
    batch = synthesize_traces(30, seed=44)
    host = be.score(batch, featurize(batch, feat))
    fused = be.harvest(be.dispatch_columns([extract_columns(batch,
                                                            feat)[0]]))
    # the trained model's own span errors, squashed and scattered
    tr.model.load_state_dict(res.variables)
    seqs = assemble_sequences(batch, featurize(batch, feat), max_len=16)
    err = tr.model.span_errors(seqs.categorical, seqs.continuous,
                               seqs.mask).numpy()
    want = np.zeros(len(batch), np.float32)
    real = seqs.span_index >= 0
    want[seqs.span_index[real]] = 1.0 - np.exp(-err[real])
    assert 0 < want.max() < 0.99  # off the squash's ceiling
    np.testing.assert_allclose(host, want, atol=F32_TOL, rtol=F32_TOL)
    np.testing.assert_allclose(fused, want, atol=F32_TOL, rtol=F32_TOL)


# ------------------------------------------------- card-only refusals
@pytest.mark.parametrize("model", ["transformer", "autoencoder"])
def test_card_checks_refuse_what_the_card_cannot_train(model):
    cls = TransformerConfig if model == "transformer" else AutoencoderConfig
    card_checks(cls(dtype=torch.float32, max_len=32))  # the default: taken
    with pytest.raises(ValueError, match="float32"):
        card_checks(cls(dtype=torch.bfloat16, max_len=32))
    with pytest.raises(ValueError, match="embedding tables"):
        card_checks(cls(dtype=torch.float32, max_len=32, name_vocab=1 << 20))
    with pytest.raises(ValueError, match="d_model"):
        card_checks(cls(dtype=torch.float32, max_len=32, d_model=40,
                        n_heads=2))

"""The autoencoder on the ``"model"`` axis, against the JAX package's.

The reference shards the autoencoder's encoder blocks, its decoder FFN
(``dec_ff1`` columns, ``dec_ff2`` rows) and its two vocabulary heads
(``(service|name)_head/kernel`` columns) on the ``"model"`` axis by
``PARTITION_RULES`` and lets XLA partition ``score_spans``, ``loss_fn``
and the train step, the cross-shard ``log_softmax`` of ``_ce`` included.
The port runs one gloo process a rank (one 4-rank spawn in this file, its
rank function in ``torch_parallel_ranks.py``) or every shard in one
process (``LocalModelAxis``):

* the rule table: the port's ``param_specs`` equal the reference's
  ``ScoringPlan.param_specs`` leaf for leaf on the autoencoder's Flax tree
  on ``{"data": 2, "model": 2}``, ``{"data": 1, "model": 4}`` and a case
  where the service head's vocabulary does not divide 4 (it replicates,
  the name head shards);
* ``shard_state`` / ``unshard_state``: the decoder FFN's and the heads'
  leaves are the Flax leaves cut by their guarded specs (the heads' and
  ``dec_ff2``'s biases whole), and the shards give the state back;
* K11 ``"slice"`` and K24's plain versions: at tp = 1 bit-equal to
  ``recon_ce_plain``; at tp 2 and 4 (and with a head the guard keeps
  whole) within ``SLICE_RTOL`` of it and of the JAX heads and ``_ce``
  (f32), labels wrapped from ``[-V, 0)`` and labels past every slice
  (NaN at real positions, fault C5's rule; the merged log-sum-exps
  finite);
* K20 ``"slice"``'s plain version: the shards' parts of ``dy`` summed,
  each slice's weight gradient and the gathered bias gradients, then K17's
  plain version through ``dec_ln``, against ``jax.grad`` of the
  reference's heads and ``_ce``;
* the whole model on the in-process axis at tp 2 and 4 against the
  unsharded port and the JAX ``score_spans`` (f32), its step's gradients
  against the unsharded port's, the card's coverage on a model axis (any
  vocabulary slice, the decoder FFN's local width a multiple of 16) and
  K11's planes of a ragged slice;
* on four gloo ranks ``{"data": 2, "model": 2}``: ``make_sharded_score_fn``
  and the plan's ``score_spans`` against the JAX ``make_sharded_score_fn``
  and ``compile_plan`` within ``SCORE_ATOL`` (f32) and the port's bf16
  bound against JAX (``tests/test_torch_autoencoder.py``); three train
  steps against the JAX ``make_sharded_train_step`` with ``optax.adam``
  (``tests/test_torch_tensor_parallel.py``'s bounds), every replicated
  parameter bit-equal over the model group and every parameter over the
  data group; the same steps on ``{"data": 4}`` alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from flax import linen as fnn

from odigos_tpu.features import assemble_sequences
from odigos_tpu.models import SpanAutoencoder as JAutoencoder
from odigos_tpu.models.autoencoder import AutoencoderConfig as JConfig
from odigos_tpu.models.autoencoder import _ce
from odigos_tpu.parallel import compile_plan as j_compile_plan
from odigos_tpu.parallel import make_mesh as j_make_mesh
from odigos_tpu.parallel import make_sharded_score_fn as j_score_fn
from odigos_tpu.parallel import make_sharded_train_step as j_train_step
from odigos_tpu.parallel import shard_variables
from odigos_tpu.pdata import synthesize_traces
from odigos_tpu_torch.kernels import coverage
from odigos_tpu_torch.kernels import recon as krecon
from odigos_tpu_torch.kernels.dense import ln_bwd_plain
from odigos_tpu_torch.kernels.quant import layer_norm_plain
from odigos_tpu_torch.models import (AutoencoderConfig, SpanAutoencoder,
                                     flax_autoencoder_to_torch)
from odigos_tpu_torch.parallel import (LocalModelAxis, param_specs,
                                       shard_state, unshard_state)
from odigos_tpu_torch.parallel.launch import spawn

import torch_parallel_ranks as ranks

torch.set_num_threads(1)

F32_TOL = 1e-5
SLICE_RTOL = 1e-5    # the slices' log-sum-exps merged in another order
SCORE_ATOL = 2e-5    # the reference's sharded-scoring bound
BF16_ERR_RTOL = 1e-2  # the port's bf16 errors against JAX
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-5
GRAD_ATOL = 1e-8
LR = 1e-3
STEPS = 3
PARAM_ATOL = 0.01 * STEPS * LR
SPAWN_TIMEOUT = 240.0
WEIGHTS = dict(w_service=0.01, w_name=0.01, w_kind=0.005, w_duration=0.002)
# the featurizer's default vocabularies (512 / 2048) feed the heads
TINY = dict(d_model=32, d_latent=16, n_heads=2, n_layers=1, d_ff=64,
            max_len=16, **WEIGHTS)
GEOM = dict(d_model=64, d_latent=32, n_heads=4, n_layers=1, d_ff=128,
            max_len=16, service_vocab=64, name_vocab=128, **WEIGHTS)
MESHES = {"dp2xtp2": ({"data": 2, "model": 2}, GEOM),
          "tp4": ({"data": 1, "model": 4}, GEOM),
          "service66_on_tp4": ({"data": 2, "model": 4},
                               dict(GEOM, service_vocab=66))}


def _jvars(geom, seed=0, dtype=jnp.float32):
    jm = JAutoencoder(JConfig(dtype=dtype, **geom))
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


def _cfg(geom, dt=torch.float32):
    return AutoencoderConfig(dtype=dt, **geom)


# ---------------------------------------------------------- the rule table
@pytest.mark.parametrize("which", list(MESHES))
def test_ae_param_specs_are_the_reference_s(which):
    shape, geom = MESHES[which]
    jm, variables = _jvars(geom)
    want = j_compile_plan(jm, j_make_mesh(shape)).param_specs(variables)
    want = {"/".join(str(k.key) for k in path): tuple(s)
            for path, s in jax.tree_util.tree_leaves_with_path(
                want, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec))}
    got = _flat(param_specs(variables, shape))
    assert got == want
    sharded = {k for k, s in got.items() if "model" in s}
    assert any("name_head/kernel" in k for k in sharded)
    assert any("dec_ff1/kernel" in k for k in sharded)
    assert any("dec_ff2/kernel" in k for k in sharded)
    assert (which == "service66_on_tp4") != any(
        "service_head/kernel" in k for k in sharded)


@pytest.mark.parametrize("which", list(MESHES))
def test_ae_shard_state_slices_the_flax_leaves_and_reassembles(which):
    shape, geom = MESHES[which]
    _, variables = _jvars(geom)
    cfg = _cfg(geom)
    state = flax_autoencoder_to_torch(variables, cfg)
    specs = _flat(param_specs(variables, shape))
    flat = _flat(variables)
    tp = shape["model"]
    shards = [shard_state(state, shape, cfg, rank=r) for r in range(tp)]
    for r, sh in enumerate(shards):
        def cut(path):  # the Flax leaf's rank-r slice by its spec
            a, spec = flat[f"params/{path}"], specs[f"params/{path}"]
            if "model" not in spec:
                return a
            return np.split(a, tp, axis=spec.index("model"))[r]
        for lin in ("dec_ff1", "dec_ff2", "service_head", "name_head"):
            np.testing.assert_array_equal(sh[f"{lin}.weight"].numpy(),
                                          cut(f"{lin}/kernel").T)
        d1 = cut("dec_ff1/kernel").shape[1]
        np.testing.assert_array_equal(
            sh["dec_ff1.bias"].numpy(),
            np.split(flat["params/dec_ff1/bias"], geom["d_ff"] // d1)[
                r if d1 < geom["d_ff"] else 0])
        for whole in ("dec_ff2.bias", "service_head.bias", "name_head.bias",
                      "kind_head.weight", "dec_ln.weight",
                      "bottleneck.weight"):
            assert torch.equal(sh[whole], state[whole]), whole
    back = unshard_state(shards, shape, cfg)
    assert back.keys() == state.keys()
    for k in state:
        assert torch.equal(back[k], state[k]), k


# -------------------------------------------- K11 "slice" + K24, plain
def _heads_case(seed, d=32, vocab=(24, 40), M=96):
    """Random (M, d) decoder rows, the four heads, and labels that wrap
    from [-V, 0) or lie past every slice (labels V and V + 5)."""
    g = np.random.default_rng(seed)
    dec = torch.from_numpy(g.normal(0, 1, (M, d)).astype(np.float32))
    lw = torch.from_numpy((1 + g.normal(0, 0.1, d)).astype(np.float32))
    lb = torch.from_numpy(g.normal(0, 0.1, d).astype(np.float32))
    heads = [(torch.from_numpy(g.normal(0, 0.3, (v, d)).astype(np.float32)),
              torch.from_numpy(g.normal(0, 0.3, v).astype(np.float32)))
             for v in (*vocab, 8, 1)]
    cat = np.stack([g.integers(-v, v, M) for v in (*vocab, 8)], 1)
    cat[3, 0], cat[5, 1], cat[7, 0] = vocab[0], vocab[1] + 5, -vocab[0] - 1
    cont = torch.from_numpy(g.normal(0, 1, (M, 3)).astype(np.float32))
    mask = torch.from_numpy(g.random(M) < 0.7)
    mask[[3, 5, 7]] = True
    return (dec, lw, lb, heads, torch.from_numpy(cat.astype(np.int32)),
            cont, mask)


def _shards(heads, tp):
    """Each rank's four heads and slice: a head whose width tp divides cut
    by rows (its bias rows), else whole."""
    out = []
    for r in range(tp):
        hs, lo, vs = [], [], []
        for h, (w, b) in enumerate(heads):
            v = w.shape[0]
            if h < 2 and v % tp == 0:
                n = v // tp
                hs.append((w[r * n:(r + 1) * n], b[r * n:(r + 1) * n]))
                lo.append(r * n)
                vs.append(n)
            else:
                hs.append((w, b))
                if h < 2:
                    lo.append(0)
                    vs.append(v)
        vf = (heads[0][0].shape[0], heads[1][0].shape[0])
        out.append((hs, krecon.VocabSlice(vf, tuple(lo[:2])), tuple(vs)))
    return out


WTS = (1.0, 0.7, 0.5, 0.3)


def _sliced_errors(case, tp, lse=None):
    dec, lw, lb, heads, cat, cont, mask = case
    sh = _shards(heads, tp)
    recs = [krecon.recon_ce_slice(dec, lw, lb, hs, cat, cont, mask, vsl)
            for hs, vsl, _ in sh]
    return krecon.vocab_ce_merge(LocalModelAxis(tp).gather(recs), cat, mask,
                                 sh[0][1].vf, sh[0][2], WTS, lse=lse)


def _jax_heads_errors(case):
    """The reference's heads and ``_ce`` on ``dec_ln``'s output."""
    dec, lw, lb, heads, cat, cont, mask = case
    y = jnp.asarray(layer_norm_plain(dec, lw, lb).numpy())
    z = [fnn.Dense(w.shape[0], dtype=jnp.float32).apply(
        {"params": {"kernel": jnp.asarray(w.numpy().T),
                    "bias": jnp.asarray(b.numpy())}}, y) for w, b in heads]
    c = jnp.asarray(cat.numpy())
    err = WTS[0] * _ce(z[0], c[:, 0])
    err += WTS[1] * _ce(z[1], c[:, 1])
    err += WTS[2] * _ce(z[2], c[:, 2])
    err += WTS[3] * (z[3][:, 0] - jnp.asarray(cont.numpy())[:, 0]) ** 2
    return np.asarray(err * jnp.asarray(mask.numpy()))


@pytest.mark.parametrize("seed", [0, 1])
def test_k11_slice_and_k24_at_tp1_are_recon_ce_plain_bit_for_bit(seed):
    case = _heads_case(seed)
    want_lse = torch.zeros(case[0].shape[0], 3)
    want = krecon.recon_ce_plain(*case, WTS, lse=want_lse)
    lse = torch.full_like(want_lse, float("nan"))
    got = _sliced_errors(case, 1, lse)
    assert torch.equal(got.isnan(), want.isnan())
    assert got.isnan().sum() == 3  # the labels past every slice
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
    assert torch.equal(lse, want_lse)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("vocab", [(24, 40), (24, 42)],
                         ids=["both_sliced", "name_whole"])
def test_k11_slice_and_k24_match_recon_ce_plain_and_jax(tp, vocab):
    case = _heads_case(tp, vocab=vocab)
    want_lse = torch.zeros(case[0].shape[0], 3)
    want = krecon.recon_ce_plain(*case, WTS, lse=want_lse)
    lse = torch.zeros_like(want_lse)
    got = _sliced_errors(case, tp, lse)
    ref = _jax_heads_errors(case)
    nan = want.isnan()
    assert torch.equal(got.isnan(), nan) and np.array_equal(np.isnan(ref),
                                                            nan.numpy())
    assert nan.sum() == 3 and torch.isfinite(lse).all()
    g, w = got[~nan], want[~nan]
    assert ((g - w).abs() <= SLICE_RTOL * w.abs().clamp(min=1)).all()
    np.testing.assert_allclose(g.numpy(), ref[~nan.numpy()], rtol=SLICE_RTOL,
                               atol=F32_TOL)
    torch.testing.assert_close(lse, want_lse, rtol=SLICE_RTOL, atol=F32_TOL)
    assert (got[~case[-1]] == 0).all()


def test_k11_slice_and_k24_refusals():
    dec, lw, lb, heads, cat, cont, mask = _heads_case(0)
    (hs, vsl, vs), _ = _shards(heads, 2)
    with pytest.raises(ValueError, match="outside a head"):
        krecon.recon_ce_slice(dec, lw, lb, hs, cat, cont, mask,
                              krecon.VocabSlice(vsl.vf, (20, 0)))
    rec = krecon.recon_ce_slice(dec, lw, lb, hs, cat, cont, mask, vsl)
    with pytest.raises(ValueError, match="slices of"):
        krecon.vocab_ce_merge(rec[None], cat, mask, vsl.vf, vs, WTS)
    with pytest.raises(ValueError, match="rec must be"):
        krecon.vocab_ce_merge(rec, cat, mask, vsl.vf, vs, WTS)


# --------------------------------------------------- K20 "slice", plain
@pytest.mark.parametrize("tp", [1, 2, 4])
def test_k20_slice_plain_matches_jax_grad(tp):
    case = _heads_case(10 + tp, vocab=(24, 42))
    dec, lw, lb, heads, cat, cont, mask = case
    past = (cat[:, 0] >= 24) | (cat[:, 0] < -24) | (cat[:, 1] >= 42)
    derr = torch.from_numpy(np.random.default_rng(tp).normal(
        0, 1, dec.shape[0]).astype(np.float32))
    derr[past] = 0.0  # NaN errors there: no gradient flows from them
    lse = torch.zeros(dec.shape[0], 3)
    _sliced_errors(case, tp, lse)
    sh = _shards(heads, tp)
    gs = [krecon.recon_ce_bwd_plain(
        dec, lw, lb, hs, lse, cat, cont, mask, derr, WTS, vslice=vsl,
        dy_heads=sum(1 << h for h in range(4)
                     if r == 0 or (h < 2 and vs[h] < vsl.vf[h])))
        for r, (hs, vsl, vs) in enumerate(sh)]
    dy = LocalModelAxis(tp).reduce([g.dy for g in gs])
    ddec, dlw, dlb = ln_bwd_plain(dec, lw, dy)
    got = [ddec, dlw, dlb]
    for h in range(4):
        sliced = h < 2 and sh[0][2][h] < sh[0][1].vf[h]
        ws = [g.heads[h][0] for g in gs]
        bs = [g.heads[h][1] for g in gs]
        got += [torch.cat(ws) if sliced else ws[0],
                torch.cat(bs) if sliced else bs[0]]
        if not sliced:  # every shard's copy of a whole head: the same bits
            assert all(torch.equal(w, ws[0]) for w in ws)

    def loss(dec_, lw_, lb_, *hp):
        mean = dec_.mean(-1, keepdims=True)
        var = ((dec_ - mean) ** 2).mean(-1, keepdims=True)
        y = (dec_ - mean) / jnp.sqrt(var + 1e-6) * lw_ + lb_
        z = [y @ hp[2 * h].T + hp[2 * h + 1] for h in range(4)]
        c = jnp.asarray(cat.numpy())
        err = WTS[0] * _ce(z[0], c[:, 0]) + WTS[1] * _ce(z[1], c[:, 1])
        err += WTS[2] * _ce(z[2], c[:, 2])
        err += WTS[3] * (z[3][:, 0] - jnp.asarray(cont.numpy())[:, 0]) ** 2
        live = jnp.asarray((mask & ~past).numpy())
        return jnp.sum(jnp.where(live, err, 0.0) * jnp.asarray(derr.numpy()))

    args = [jnp.asarray(t.numpy()) for t in
            (dec, lw, lb, *(t for pair in heads for t in pair))]
    ref = jax.grad(loss, argnums=tuple(range(len(args))))(*args)
    for a, r in zip(got, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(a.numpy(), r, rtol=0,
                                   atol=GRAD_RTOL * np.abs(r).max() + 1e-7)


# --------------------------------- the whole model on the in-process axis
def _seqs(n, seed, L=16, pad=None):
    return assemble_sequences(synthesize_traces(n, seed=seed), max_len=L,
                              pad_traces_to=pad)


@pytest.mark.parametrize("tp", [2, 4])
def test_the_model_on_the_in_process_axis_matches_jax_and_unsharded(tp):
    jm, variables = _jvars(TINY, seed=2)
    cfg = _cfg(TINY)
    state = flax_autoencoder_to_torch(variables, cfg)
    whole = SpanAutoencoder(cfg, device="cpu")
    whole.load_state_dict(state)
    m = SpanAutoencoder(cfg, device="cpu", model_axis=LocalModelAxis(tp))
    m.load_state_dict(state)
    assert m.module.dec_ff1.weight.shape[0] == TINY["d_ff"] // tp
    assert m.module.name_head.weight.shape[0] == 2048 // tp
    assert m.module.name_head.bias.shape[0] == 2048
    s = _seqs(10, tp)
    ref, ref_mean = jm.score_spans(variables, s.categorical, s.continuous,
                                   s.mask)
    got, mean = m.score_spans(s.categorical, s.continuous, s.mask)
    base, _ = whole.score_spans(s.categorical, s.continuous, s.mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=F32_TOL,
                               rtol=F32_TOL)
    np.testing.assert_allclose(mean.numpy(), np.asarray(ref_mean),
                               atol=F32_TOL, rtol=F32_TOL)
    np.testing.assert_allclose(got.numpy(), base.numpy(), atol=F32_TOL,
                               rtol=F32_TOL)
    # one step's gradients, joined over the shards, are the unsharded
    # model's; every shard's copy of a replicated head is the same
    grads = []
    for model in (whole, m):
        model.train()
        model.loss_fn(s.categorical, s.continuous, s.mask).backward()
        sh = [{n: (p.grad if p.grad is not None else torch.zeros_like(p))
               for n, p in mod.named_parameters()} for mod in model.shards]
        grads.append(sh[0] if model is whole else
                     unshard_state(sh, {"model": tp}, cfg))
        if model is m:
            for n in ("kind_head.weight", "duration_head.bias",
                      "service_head.bias", "name_head.bias"):
                assert all(torch.equal(x[n], sh[0][n]) for x in sh[1:]), n
    for n, want in grads[0].items():
        if n.endswith("key.bias"):  # no gradient: softmax's invariance
            continue
        bound = GRAD_RTOL * want.abs().max() + GRAD_ATOL
        assert (grads[1][n] - want).abs().max() <= bound, n


def test_the_fused_route_has_no_model_axis_mode():
    m = SpanAutoencoder(_cfg(TINY), device="cpu",
                        model_axis=LocalModelAxis(2))
    s = _seqs(3, 0)
    with pytest.raises(ValueError, match="no model-axis mode"):
        m.score_spans_scatter(s.categorical, s.continuous, s.mask,
                              np.zeros(s.mask.shape, np.int32), 8)


@pytest.mark.parametrize("tp,geom,ok", [
    (2, {}, True), (4, {}, True), (8, {}, True),
    (4, dict(service_vocab=384), True),        # slices of 96
    (4, dict(service_vocab=386), True),        # not divisible: whole
    (2, dict(name_vocab=2048 + 64), True),     # slices of 1056
    (2, dict(service_vocab=96, name_vocab=200), True),  # 48 and 100
    (4, dict(service_vocab=384, dtype=torch.float32), True),
    (4, dict(d_ff=96), False),                 # decoder FFN slices of 24
    (4, dict(d_ff=1056, dtype=torch.float32), False)],  # slices of 264
    ids=["tp2", "tp4", "tp8", "service96", "service_whole", "name1056",
         "ragged48_100", "f32_cuda_core", "dec_ff24", "dec_ff264"])
def test_the_card_takes_any_vocabulary_slice_on_the_model_axis(tp, geom, ok):
    """The refusal of the model axis the autoencoder had (ROADMAP A8.4)
    is gone. A vocabulary slice of any width runs on the card (K11's
    planes pad a shard's heads to whole ``PLANE_PAD`` rows, as a whole
    head's); the limit left is the row-parallel products' local width, the
    decoder FFN's ``d_ff / tp`` a multiple of 16, named in the
    ``ValueError``."""
    cfg = AutoencoderConfig(**geom)
    if ok:
        coverage.check(cfg, tp)
    else:
        with pytest.raises(ValueError, match="multiple of 16"):
            coverage.check(cfg, tp)


@pytest.mark.parametrize("tp,vocabs", [(2, (96, 200)), (4, (96, 200)),
                                       (2, (512, 2048))])
def test_a_ragged_slice_pads_its_planes_as_a_whole_head(tp, vocabs):
    """Each shard's slices of the service and name heads split into K11's
    three planes (``recon.split_planes``) padded to whole ``PLANE_PAD``
    rows with a -inf bias, summing to the slice bit for bit; the planes'
    logits over the real rows are the slice's own logits."""
    g = torch.Generator().manual_seed(tp)
    d = 32
    heads = [(torch.randn(v, d, generator=g) / 6, torch.randn(v, generator=g))
             for v in (*vocabs, 8, 1)]
    y = torch.randn(40, d, generator=g).to(torch.bfloat16).float()
    for r in range(tp):
        hs = [(w[r * (w.shape[0] // tp):(r + 1) * (w.shape[0] // tp)], b[
            r * (w.shape[0] // tp):(r + 1) * (w.shape[0] // tp)])
            for w, b in heads[:2]] + heads[2:]
        vs = [w.shape[0] for w, _ in hs[:2]]
        planes = krecon.head_planes(hs)
        pads = [-(-v // krecon.PLANE_PAD) * krecon.PLANE_PAD for v in vs]
        assert (planes.v_s, planes.v_n, planes.vs_pad) == (*vs, pads[0])
        assert planes.w.shape == (3, sum(pads), d)
        W = planes.w.float().sum(0)
        for h, off in enumerate((0, pads[0])):
            assert torch.equal(W[off:off + vs[h]], hs[h][0])
            assert torch.equal(W[off + vs[h]:off + pads[h]],
                               torch.zeros(pads[h] - vs[h], d))
            assert torch.equal(planes.b[off:off + vs[h]], hs[h][1])
            assert bool(torch.isneginf(planes.b[off + vs[h]:off
                                                + pads[h]]).all())
            z = sum(y @ planes.w[i, off:off + vs[h]].float().t()
                    for i in range(3)) + planes.b[off:off + vs[h]]
            np.testing.assert_allclose(
                z.numpy(), F.linear(y, *hs[h]).numpy(), rtol=0, atol=1e-4)


# ---------------------------------------------- four gloo ranks, dp x tp
@pytest.fixture(scope="module")
def ae_case():
    jm, variables = _jvars(TINY)
    jm_bf = JAutoencoder(JConfig(dtype=jnp.bfloat16, **TINY))
    cfg = _cfg(TINY)
    state = {k: v.numpy()
             for k, v in flax_autoencoder_to_torch(variables, cfg).items()}
    score_inputs = [(s.categorical, s.continuous, s.mask)
                    for s in (_seqs(5, 1, pad=6), _seqs(12, 0))]
    s = _seqs(14, 2)
    rng = np.random.default_rng(0)
    train_inputs = (s.categorical, s.continuous, s.mask,
                    (rng.random(s.mask.shape) < 0.2) & s.mask,
                    rng.random(s.mask.shape[0]) < 0.5)
    got = spawn(ranks.ae_tp_rank, 4, device="cpu",
                args=(TINY, state, score_inputs, train_inputs, STEPS, LR),
                timeout=SPAWN_TIMEOUT)
    ref = {}
    for mesh_shape in ({"data": 2, "model": 2}, {"data": 4}):
        mesh = j_make_mesh(mesh_shape)
        tx = optax.adam(LR)
        jvars = shard_variables(variables, mesh)
        opt_state = tx.init(jvars)
        jstep = j_train_step(jm, tx, mesh)
        losses = []
        for _ in range(STEPS):
            jvars, opt_state, loss = jstep(jvars, opt_state, *train_inputs)
            losses.append(float(loss))
        key = "tp" if "model" in mesh_shape else "dp"
        ref[f"{key}_losses"] = losses
        ref[f"{key}_params"] = {k: v.numpy() for k, v in
                                flax_autoencoder_to_torch(
                                    jax.tree_util.tree_map(np.asarray, jvars),
                                    cfg).items()}
    mesh = j_make_mesh({"data": 2, "model": 2})
    for name, model in (("f32", jm), ("bf16", jm_bf)):
        score = j_score_fn(model, mesh)
        placed = shard_variables(variables, mesh)
        ref[f"scores_{name}"] = [
            tuple(np.asarray(t, np.float32) for t in score(placed, *a))
            for a in score_inputs]
        plan = j_compile_plan(model, mesh)
        ref[f"plan_{name}"] = [
            tuple(np.asarray(t, np.float32)
                  for t in plan.score_spans(variables, *a))
            for a in score_inputs]
    grads = jax.jit(jax.grad(lambda vv: jm.loss_fn(
        vv, *(jnp.asarray(a) for a in train_inputs[:3]))))(variables)
    ref["grads"] = {k: v.numpy() for k, v in flax_autoencoder_to_torch(
        jax.tree_util.tree_map(np.asarray, grads), cfg).items()}
    return got, ref, cfg


def _joined(got, key, data, cfg):
    """The whole state from the model group of data coordinate ``data``."""
    group = sorted((r for r in got if r["coord"][0] == data),
                   key=lambda r: r["coord"][1])
    return {k: v.numpy() for k, v in unshard_state(
        [r[key] for r in group], {"model": 2}, cfg).items()}


def _check_scores(got, want, which):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        if which == "f32":
            np.testing.assert_allclose(g, w, atol=SCORE_ATOL, rtol=F32_TOL)
        else:
            assert np.isfinite(g).all()
            real = w != 0
            assert (g[~real] == 0).all()
            assert (np.abs(g[real] - w[real]) / np.abs(w[real])).max() \
                <= BF16_ERR_RTOL


@pytest.mark.parametrize("entry", ["scores", "plan"])
@pytest.mark.parametrize("which", ["f32", "bf16"])
@pytest.mark.parametrize("case", [0, 1],
                         ids=["5_traces_padded_to_6", "12_traces"])
def test_ae_tp_scores_match_the_sharded_reference(ae_case, entry, which,
                                                  case):
    got, ref, _ = ae_case
    want = ref[f"{entry}_{which}"][case]
    for r in got:
        _check_scores(r[f"{entry}_{which}"][case], want, which)


@pytest.mark.parametrize("key", ["tp", "dp"])
def test_ae_train_losses_match_the_sharded_reference(ae_case, key):
    got, ref, _ = ae_case
    name = "losses" if key == "tp" else "dp_losses"
    for r in got:
        np.testing.assert_allclose(r[name], ref[f"{key}_losses"],
                                   rtol=LOSS_RTOL)


def test_ae_tp_first_step_gradients_match_jax_grad(ae_case):
    got, ref, cfg = ae_case
    for data in (0, 1):
        grads = _joined(got, "grads", data, cfg)
        for name, want in ref["grads"].items():
            if name.endswith("key.bias"):
                continue
            bound = GRAD_RTOL * np.abs(want).max() + GRAD_ATOL
            err = np.abs(grads[name] - want).max()
            assert err <= bound, (name, err, bound)


def test_ae_dp_first_step_gradients_match_jax_grad(ae_case):
    got, ref, _ = ae_case
    for r in got:
        for name, want in ref["grads"].items():
            if name.endswith("key.bias"):
                continue
            bound = GRAD_RTOL * np.abs(want).max() + GRAD_ATOL
            assert np.abs(r["dp_grads"][name] - want).max() <= bound, name


def test_ae_tp_train_parameters_match_and_replicas_agree(ae_case):
    got, ref, cfg = ae_case
    params = [_joined(got, "params", data, cfg) for data in (0, 1)]
    for name, want in ref["tp_params"].items():
        p = params[0][name]
        if name.endswith("key.bias"):
            assert np.abs(p).max() <= 1.01 * STEPS * LR, name
        else:
            err = np.abs(p - want).max()
            assert err <= PARAM_ATOL, (name, err, PARAM_ATOL)
        np.testing.assert_array_equal(p, params[1][name])
    # each replicated parameter is bit-equal over the model group
    by = {r["coord"]: r["params"] for r in got}
    sharded = ("query.", "key.", "value.", "ff1.", "out.weight",
               "ff2.weight", "dec_ff1.", "dec_ff2.weight",
               "service_head.weight", "name_head.weight")
    n = 0
    for name, v in by[(0, 0)].items():
        if not any(s in name for s in sharded):
            np.testing.assert_array_equal(v, by[(0, 1)][name], err_msg=name)
            n += 1
    assert n > 10


def test_ae_dp_train_parameters_match_and_replicas_agree(ae_case):
    got, ref, _ = ae_case
    for r in got:
        for name, want in ref["dp_params"].items():
            p = r["dp_params"][name]
            if name.endswith("key.bias"):
                assert np.abs(p).max() <= 1.01 * STEPS * LR, name
            else:
                assert np.abs(p - want).max() <= PARAM_ATOL, name
            np.testing.assert_array_equal(p, got[0]["dp_params"][name])

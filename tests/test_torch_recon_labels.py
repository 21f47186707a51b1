"""K11's and K20's labels past their heads, against the reference (ROADMAP C5).

The reference's ``_ce`` (``odigos_tpu/models/autoencoder.py:93-95``) takes
a label's log-probability with ``jnp.take_along_axis`` in fill mode: a
label in ``[-V, 0)`` wraps to ``V + label``, any other label past the head
gives a NaN cross-entropy, and ``jax.grad`` gives that head zero gradient
at that position. On the CPU, with inputs made from seeds with numpy:

* ``recon.take_labels`` is ``jnp.take_along_axis``'s rule for every label
  in ``[-2V - 2, 2V + 2)``;
* ``recon_ce_plain`` (K11's plain version) against the reference's heads
  and ``_ce`` on the same ``dec_ln`` output, with the labels -1, -V, V and
  V + 7 in each categorical head: the same NaN positions, the other
  errors within ``F32_TOL``, its log-sum-exps finite; padding positions
  stay 0 (the reference's ``err * mask`` keeps NaN there: the residue the
  packers never reach, as they write label 0 at padding);
* ``recon_ce_bwd_plain`` (K20's plain version) against ``jax.grad`` of
  those errors' weighted sum: dy and each head's (dW, db) within
  ``GRAD_RTOL`` of their largest magnitudes, and exactly zero for a head
  whose only real position takes no row;
* the port's ``SpanAutoencoder.score_spans`` on the CPU route against the
  JAX model's with negative categorical ids (wrapped in both the
  embeddings and the labels, or past both): the same NaN spans, the rest
  within ``F32_TOL``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from odigos_tpu.features.featurizer import assemble_sequences as jassemble
from odigos_tpu.models.autoencoder import AutoencoderConfig as JaxConfig
from odigos_tpu.models.autoencoder import SpanAutoencoder as JaxAutoencoder
from odigos_tpu.models.autoencoder import _ce
from odigos_tpu.pdata import synthesize_traces as jsynth
from odigos_tpu_torch.kernels import recon
from odigos_tpu_torch.kernels.quant import layer_norm_plain
from odigos_tpu_torch.models import (AutoencoderConfig, SpanAutoencoder,
                                     flax_autoencoder_to_torch)

F32_TOL = 1e-5    # tests/test_torch_autoencoder.py's f32 bound
GRAD_RTOL = 1e-5  # of each gradient's largest magnitude (f32 sums)
VOCABS = (40, 72, 8, 1)
WEIGHTS = (1.0, 0.7, 0.5, 0.3)
SMALL = dict(d_model=64, d_latent=32, n_heads=2, n_layers=2, d_ff=128,
             max_len=16)


def _bad_labels(V: int) -> list[int]:
    return [-1, -V, V, V + 7]


def _inputs(seed: int, d: int = 32, T: int = 6, L: int = 16):
    """(dec, mask, cat, cont, heads, ln weight, ln bias) as numpy, with
    every label of ``_bad_labels`` at real positions of each head, and one
    past the service head at a padding position."""
    g = np.random.default_rng(seed)
    M = T * L
    mask = g.random(M) < 0.7
    mask[:16] = True
    cat = np.stack([g.integers(0, V, M) for V in VOCABS[:3]]
                   + [np.zeros(M, np.int64)] * 2, 1).astype(np.int32)
    for h in range(3):
        for i, lab in enumerate(_bad_labels(VOCABS[h])):
            cat[4 * h + i, h] = lab  # real positions (mask[:16])
    pad = int(np.flatnonzero(~mask)[0])
    cat[pad, 0] = VOCABS[0] + 1
    cont = (g.random((M, 3)) * 4).astype(np.float32)
    dec = (g.standard_normal((M, d)) * 2 + 0.5).astype(np.float32)
    heads = [(g.standard_normal((V, d)).astype(np.float32) / np.sqrt(d),
              (g.standard_normal(V) / 4).astype(np.float32)) for V in VOCABS]
    lw = (1 + g.standard_normal(d) / 4).astype(np.float32)
    lb = (g.standard_normal(d) / 4).astype(np.float32)
    return dec, mask, cat, cont, heads, lw, lb


def _jax_errors(y, heads, cat, cont, mask):
    """``SpanAutoencoder._errors``' body from ``dec_ln``'s output on: the
    reference's ``nn.Dense`` heads and ``_ce``."""
    out = [fnn.Dense(w.shape[0], dtype=jnp.float32).apply(
        {"params": {"kernel": jnp.asarray(w).T, "bias": jnp.asarray(b)}}, y)
        for w, b in heads]
    err = WEIGHTS[0] * _ce(out[0], cat[:, 0])
    err += WEIGHTS[1] * _ce(out[1], cat[:, 1])
    err += WEIGHTS[2] * _ce(out[2], cat[:, 2])
    err += WEIGHTS[3] * (out[3][:, 0] - cont[:, 0]) ** 2
    return err * mask.astype(jnp.float32)


def _port_args(dec, mask, cat, cont, heads, lw, lb):
    t = torch.from_numpy
    return (t(dec), t(lw), t(lb), [(t(w), t(b)) for w, b in heads],
            t(cat), t(cont), t(mask), WEIGHTS)


@pytest.mark.parametrize("V", [1, 8, 72])
def test_take_labels_is_take_along_axis_fill_mode(V):
    labels = np.arange(-2 * V - 2, 2 * V + 2, dtype=np.int32)
    logits = np.arange(V, dtype=np.float32)[None].repeat(labels.size, 0)
    ref = np.asarray(jnp.take_along_axis(jnp.asarray(logits),
                                         jnp.asarray(labels)[:, None],
                                         axis=-1)[:, 0])
    row, takes = recon.take_labels(torch.from_numpy(labels), V)
    np.testing.assert_array_equal(takes.numpy(), np.isfinite(ref))
    np.testing.assert_array_equal(row.numpy()[takes.numpy()],
                                  ref[np.isfinite(ref)].astype(np.int64))
    assert (row.numpy()[~takes.numpy()] == 0).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_recon_ce_plain_nan_positions_are_the_references(seed):
    dec, mask, cat, cont, heads, lw, lb = _inputs(seed)
    M = mask.size
    args = _port_args(dec, mask, cat, cont, heads, lw, lb)
    lse = torch.empty((M, 3))
    smap = torch.arange(M, dtype=torch.int32)
    got, scores = recon.recon_ce_plain(*args, span_map=smap, n_out=M,
                                       lse=lse)
    got, scores = got.numpy(), scores.numpy()
    y = layer_norm_plain(args[0], args[1], args[2]).numpy()
    ref = np.asarray(_jax_errors(jnp.asarray(y), heads, jnp.asarray(cat),
                                 jnp.asarray(cont), jnp.asarray(mask)))
    bad = np.isnan(ref[mask])
    np.testing.assert_array_equal(np.isnan(got[mask]), bad)
    assert bad.sum() == 6  # V and V + 7 in each head (-1 and -V wrap)
    np.testing.assert_allclose(got[mask][~bad], ref[mask][~bad],
                               atol=F32_TOL, rtol=F32_TOL)
    # the squashed score is NaN where the error is (1 - exp(-err))
    np.testing.assert_array_equal(np.isnan(scores[mask]), bad)
    assert torch.isfinite(lse).all()
    # padding: the port writes 0; the reference's err * mask keeps the NaN
    # of a label past its head (the residue)
    assert (got[~mask] == 0).all() and (scores[~mask] == 0).all()
    assert np.isnan(ref[~mask]).sum() == 1


def _jax_grads(y, heads, cat, cont, mask, derr):
    """``jax.grad`` of ``sum(derr * errors)`` with respect to y and the
    four heads' (W, b) (torch layout)."""
    def f(y, *params):
        hs = [(params[2 * h], params[2 * h + 1]) for h in range(4)]
        out = [y @ w.T + b for w, b in hs]
        err = WEIGHTS[0] * _ce(out[0], cat[:, 0])
        err += WEIGHTS[1] * _ce(out[1], cat[:, 1])
        err += WEIGHTS[2] * _ce(out[2], cat[:, 2])
        err += WEIGHTS[3] * (out[3][:, 0] - cont[:, 0]) ** 2
        return jnp.sum(derr * err * mask.astype(jnp.float32))

    params = [jnp.asarray(t) for pair in heads for t in pair]
    return jax.grad(f, argnums=tuple(range(9)))(jnp.asarray(y), *params)


def _close(a, r, what):
    a, r = np.asarray(a), np.asarray(r)
    bound = GRAD_RTOL * max(np.abs(r).max(), 1e-30)
    assert np.abs(a - r).max() <= bound, (what, np.abs(a - r).max(), bound)


@pytest.mark.parametrize("seed", [0, 1])
def test_recon_ce_bwd_plain_is_jax_grad_past_the_heads(seed):
    dec, mask, cat, cont, heads, lw, lb = _inputs(seed)
    M = mask.size
    g = np.random.default_rng(seed + 10)
    derr = g.standard_normal(M).astype(np.float32)
    args = _port_args(dec, mask, cat, cont, heads, lw, lb)
    lse = torch.empty((M, 3))
    recon.recon_ce_plain(*args, lse=lse)
    got = recon.recon_ce_bwd_plain(*args[:4], lse, *args[4:7],
                                   torch.from_numpy(derr), WEIGHTS)
    y = layer_norm_plain(args[0], args[1], args[2]).numpy()
    ref = _jax_grads(y, heads, jnp.asarray(cat), jnp.asarray(cont),
                     jnp.asarray(mask), jnp.asarray(derr))
    assert torch.isfinite(got.dy).all()
    _close(got.dy[torch.from_numpy(mask)], np.asarray(ref[0])[mask], "dy")
    assert (got.dy[~torch.from_numpy(mask)] == 0).all()
    for h, (dw, db) in enumerate(got.heads):
        _close(dw, ref[1 + 2 * h], f"dW{h}")
        _close(db, ref[2 + 2 * h], f"db{h}")


@pytest.mark.parametrize("h", [0, 1, 2])
@pytest.mark.parametrize("which", [0, 1, 2, 3])
def test_recon_ce_bwd_plain_zero_rows_where_jax_grad_gives_zeros(h, which):
    """One real position whose head-h label is -1, -V, V or V + 7: past the
    head (V and V + 7) that head's dW and db are zero in both, and the
    other heads keep their gradients; -1 and -V wrap."""
    dec, mask, cat, cont, heads, lw, lb = _inputs(7)
    M = mask.size
    mask[:] = False
    mask[3] = True
    cat[3, :3] = [1, 2, 3]
    cat[3, h] = _bad_labels(VOCABS[h])[which]
    derr = np.zeros(M, np.float32)
    derr[3] = 1.5
    args = _port_args(dec, mask, cat, cont, heads, lw, lb)
    lse = torch.empty((M, 3))
    recon.recon_ce_plain(*args, lse=lse)
    got = recon.recon_ce_bwd_plain(*args[:4], lse, *args[4:7],
                                   torch.from_numpy(derr), WEIGHTS)
    y = layer_norm_plain(args[0], args[1], args[2]).numpy()
    ref = _jax_grads(y, heads, jnp.asarray(cat), jnp.asarray(cont),
                     jnp.asarray(mask), jnp.asarray(derr))
    past = which >= 2
    for k, (dw, db) in enumerate(got.heads):
        rw, rb = np.asarray(ref[1 + 2 * k]), np.asarray(ref[2 + 2 * k])
        if k == h and past:
            assert (rw == 0).all() and (rb == 0).all()
            assert (dw == 0).all() and (db == 0).all()
        else:
            assert np.abs(rw).max() > 0
            _close(dw, rw, f"dW{k}")
            _close(db, rb, f"db{k}")
    _close(got.dy[3], np.asarray(ref[0])[3], "dy")


@pytest.mark.parametrize("seed", [0, 3])
def test_score_spans_negative_ids_match_the_reference(seed):
    """Negative service, name and kind ids on the JAX model and the port's
    (CPU route): -1 and -8 wrap in both the embeddings and the labels
    (finite errors that a clamp would change), -(V + 3) takes no row of
    either (NaN spans)."""
    jcfg = JaxConfig(**SMALL, dtype=jnp.float32)
    jm = JaxAutoencoder(jcfg)
    v = jm.init(jax.random.PRNGKey(seed))
    pm = SpanAutoencoder(AutoencoderConfig(**SMALL, dtype=torch.float32),
                         device="cpu")
    pm.load_state_dict(flax_autoencoder_to_torch(
        jax.tree_util.tree_map(np.asarray, v), pm.cfg))
    seqs = jassemble(jsynth(12, seed=seed), max_len=SMALL["max_len"])
    cat = seqs.categorical.copy()
    real = np.argwhere(seqs.mask)
    g = np.random.default_rng(seed)
    picks = real[g.choice(len(real), 9, replace=False)]
    wraps = [(0, -1), (1, -1), (2, -8), (0, -jcfg.service_vocab),
             (2, -1)]
    for (t, l), (col, val) in zip(picks[:5], wraps):
        cat[t, l, col] = val
    cat[tuple(picks[5])][1] = -(jcfg.name_vocab + 3)
    ref_err, _ = jm.score_spans(v, cat, seqs.continuous, seqs.mask)
    ref_err = np.asarray(ref_err)
    err, _ = pm.score_spans(cat, seqs.continuous, seqs.mask)
    err = err.numpy()
    m = seqs.mask
    bad = np.isnan(ref_err[m])
    np.testing.assert_array_equal(np.isnan(err[m]), bad)
    assert bad.any() and (~bad).any()
    np.testing.assert_allclose(err[m][~bad], ref_err[m][~bad],
                               atol=F32_TOL, rtol=F32_TOL)
    # the wrapped labels' spans are finite in both
    for t, l in picks[:5]:
        if not np.isnan(ref_err[t, l]):
            assert np.isfinite(err[t, l])

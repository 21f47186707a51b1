"""Embedding ids past their tables: the port against Flax's ``nn.Embed``.

The reference embeds every categorical column with ``nn.Embed``
(``odigos_tpu/models/layers.py`` ``SpanEmbedder``), which is ``jnp.take``
in fill mode: an id in ``[0, rows)`` takes its row, one in ``[-rows, 0)``
row ``id + rows``, any other id a NaN row (so the slot's sum is NaN), and
``jax.grad`` drops the gradient of an id that took no row; a one-row table
is broadcast to every id. The model's vocabularies and the featurizer's
are set apart, so a featurizer whose vocabulary exceeds the model's hands
the model such ids. Here, on the CPU, with inputs from numpy seeds:

* K2's plain version ``span_embed_plain`` against ``SpanEmbedder`` + the
  positional add + the mask, on ids in range, past each table and below
  zero, with and without attribute slots and with one-row tables: the NaN
  slots the same, the rest within the f32 bound of
  ``tests/test_torch_kernels.py`` (1e-6);
* K18's plain version ``span_embed_bwd_plain`` against ``jax.grad`` of the
  same embedding: every table's gradient within 1e-6 of its largest (f64
  sums rounded once against f32 scatter-adds);
* the transformer on the host route (``TraceTransformer.score_packed``,
  plain versions) against the JAX model with the same weights, on rows
  packed by a featurizer whose vocabularies exceed the model's: the spans
  whose scores are not finite are the same set, and the finite scores
  agree within ``tests/test_torch_model.py``'s 1e-5.

The kernels (K2 ``csrc/span_embed.cu``, K18 ``csrc/span_embed_bwd.cu``)
are held to these plain versions on such ids by ``tests/test_torch_cuda.py``
and ``chip_smoke.py`` on a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from odigos_tpu.features.featurizer import FeaturizerConfig
from odigos_tpu.features.featurizer import pack_sequences as jpack
from odigos_tpu.models.layers import SpanEmbedder
from odigos_tpu.models.transformer import TraceTransformer as JaxTransformer
from odigos_tpu.models.transformer import TransformerConfig as JaxConfig
from odigos_tpu.pdata import synthesize_traces as jsynth
from odigos_tpu_torch.kernels import embed
from odigos_tpu_torch.kernels.embed import (EmbedTables, span_embed_bwd_plain,
                                            span_embed_plain, take_rows)
from odigos_tpu_torch.models import (TraceTransformer, TransformerConfig,
                                     flax_to_torch)

torch.set_num_threads(1)

R, L, D = 6, 16, 32
F32_ATOL = 1e-6       # tests/test_torch_kernels.py's K2 bound
GRAD_RTOL = 1e-6      # f64 sums rounded once vs f32 scatter-adds, of
                      # each table's largest gradient
MODEL_TOL = 1e-5      # tests/test_torch_model.py's f32 bound
SEEDS = (0, 1, 2)
# (service, name, attr) vocabularies: the default kind, a one-row
# service table (broadcast), and tables of a few rows
VOCABS = ((64, 128, 256), (1, 5, 3), (7, 2, 1))


class _EmbedPosMask(nn.Module):
    """SpanEmbedder + the positional add + the mask, as the first lines of
    the reference's ``Encoder.__call__``."""

    vocabs: tuple

    @nn.compact
    def __call__(self, cat, cont, positions, mask):
        x = SpanEmbedder(*self.vocabs, D, jnp.float32, name="embed")(cat,
                                                                    cont)
        x = x + nn.Embed(L, D, dtype=jnp.float32,
                         name="pos_embed")(positions)
        return x * mask[..., None].astype(jnp.float32)


def _ids(rng, rows: int, shape) -> np.ndarray:
    """Ids of a column of a table of ``rows`` rows: most in range, the
    rest from ``[-rows - 3, rows + 4)`` (past the table, wrapped and
    dropped below zero)."""
    wild = rng.integers(-rows - 3, rows + 4, shape)
    return np.where(rng.random(shape) < 0.6, rng.integers(0, rows, shape),
                    wild).astype(np.int32)


def _case(seed: int, attr_slots: int, vocabs: tuple):
    rng = np.random.default_rng(seed)
    svc, name, attr = vocabs
    C = embed.N_BASE_FIELDS + attr_slots
    cat = np.stack([_ids(rng, n, (R, L)) for n in
                    (svc, name, embed.KIND_VOCAB, embed.STATUS_VOCAB, svc)]
                   + [_ids(rng, attr, (R, L)) for _ in range(attr_slots)],
                   -1)
    seg = rng.integers(1, 4, (R, L)).astype(np.int32)
    seg[:, -3:] = 0
    seg[-1] = 0
    cat[seg == 0] = 0  # the packers' padding slots hold id 0
    assert cat.shape[-1] == C
    cont = rng.standard_normal((R, L, 3)).astype(np.float32)
    pos = np.broadcast_to(np.arange(L, dtype=np.int32), (R, L)).copy()
    mod = _EmbedPosMask(vocabs)
    params = mod.init(jax.random.PRNGKey(seed), cat, cont, pos, seg > 0)
    p = jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a, np.float32)), params)["params"]
    e = p["embed"]
    tables = EmbedTables(
        service=e["service_embed"]["embedding"],
        name=e["name_embed"]["embedding"],
        kind=e["kind_embed"]["embedding"],
        status=e["status_embed"]["embedding"],
        attr=e["attr_embed"]["embedding"] if attr_slots else None,
        cont_w=e["cont_proj"]["kernel"].T.contiguous(),
        cont_b=e["cont_proj"]["bias"],
        pos=p["pos_embed"]["embedding"])
    return mod, params, tables, (cat, cont, pos, seg)


def test_take_rows_is_jnp_take_fill_mode():
    ids = np.arange(-9, 10, dtype=np.int32)
    for rows in (1, 2, 4, 8):
        table = np.arange(rows, dtype=np.float32)[:, None] * np.ones(
            (1, 3), np.float32)
        e = nn.Embed(rows, 3)
        ref = np.asarray(e.apply({"params": {"embedding": table}}, ids))
        row, takes = take_rows(torch.from_numpy(ids), rows)
        got = np.where(takes.numpy()[:, None], table[row.numpy()], np.nan)
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("attr_slots", [0, 3])
@pytest.mark.parametrize("vocabs", VOCABS)
def test_k2_plain_takes_ids_as_flax_embed(seed, attr_slots, vocabs):
    mod, params, tables, (cat, cont, pos, seg) = _case(seed, attr_slots,
                                                       vocabs)
    ref = np.asarray(mod.apply(params, cat, cont, pos, seg > 0))
    got = span_embed_plain(*(torch.from_numpy(a) for a in (cat, cont, pos,
                                                            seg)),
                           tables, torch.float32).numpy()
    nan = np.isnan(ref)
    np.testing.assert_array_equal(np.isnan(got), nan)
    live = seg > 0
    # the cases reach both: slots made NaN by an id and finite live slots
    assert nan.any(-1)[live].any() and (~nan.any(-1))[live].any()
    assert (got[~live] == 0).all()
    np.testing.assert_allclose(got[~nan], ref[~nan], atol=F32_ATOL,
                               rtol=1e-6)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("attr_slots", [0, 3])
@pytest.mark.parametrize("vocabs", VOCABS)
def test_k18_plain_drops_and_wraps_as_jax_grad(seed, attr_slots, vocabs):
    mod, params, tables, (cat, cont, pos, seg) = _case(seed, attr_slots,
                                                       vocabs)
    dy = np.random.default_rng(seed + 50).standard_normal(
        (R, L, D)).astype(np.float32)

    def f(prm):
        return jnp.sum(mod.apply(prm, cat, cont, pos, seg > 0) * dy)

    # the forward's NaN slots make the loss NaN; the gradients do not see
    # them: jax.grad of the sum's terms, each the product with dy
    jg = jax.grad(f)(params)["params"]
    got = span_embed_bwd_plain(*(torch.from_numpy(a) for a in (dy, cat, pos,
                                                               seg)), tables)
    names = {"service": ("embed", "service_embed"),
             "name": ("embed", "name_embed"),
             "kind": ("embed", "kind_embed"),
             "status": ("embed", "status_embed"),
             "attr": ("embed", "attr_embed"), "pos": ("pos_embed",)}
    for field, path in names.items():
        g = getattr(got, field)
        if field == "attr" and not attr_slots:
            assert g is None
            continue
        ref = jg
        for k in path:
            ref = ref[k]
        ref = np.asarray(ref["embedding"])
        assert np.isfinite(ref).all()
        np.testing.assert_allclose(
            g.numpy(), ref, atol=GRAD_RTOL * max(1.0, np.abs(ref).max()),
            rtol=0, err_msg=field)


@pytest.mark.parametrize("seed", SEEDS)
def test_score_packed_nan_spans_match_the_reference(seed):
    """The transformer's host route (plain versions) on rows packed by a
    featurizer whose service and name vocabularies exceed the model's:
    the ids past the model's tables make the same spans' scores NaN as in
    the JAX model, and the other scores agree."""
    geom = dict(d_model=32, n_heads=2, n_layers=2, d_ff=64, max_len=16,
                service_vocab=56, name_vocab=112)
    jm = JaxTransformer(JaxConfig(**geom, dtype=jnp.float32))
    variables = jm.init(jax.random.PRNGKey(seed))
    pm = TraceTransformer(TransformerConfig(**geom, dtype=torch.float32),
                          device="cpu")
    pm.load_state_dict(flax_to_torch(
        jax.tree_util.tree_map(np.asarray, variables), pm.cfg))
    pk = jpack(jsynth(40, seed=seed), max_len=geom["max_len"],
               config=FeaturizerConfig(service_vocab=64, name_vocab=128),
               pad_rows_to=lambda r: r + 1)
    assert (pk.categorical[..., [0, 4]] >= geom["service_vocab"]).any()
    ref = np.asarray(jm.score_packed(variables, pk.categorical,
                                     pk.continuous, pk.segments,
                                     pk.positions))
    got = pm.score_packed(pk.categorical, pk.continuous, pk.segments,
                          pk.positions).numpy()
    m = pk.segments > 0
    bad = ~np.isfinite(ref[m])
    np.testing.assert_array_equal(~np.isfinite(got[m]), bad)
    assert bad.any() and (~bad).any()
    np.testing.assert_allclose(got[m][~bad], ref[m][~bad], atol=MODEL_TOL,
                               rtol=MODEL_TOL)

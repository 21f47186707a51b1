"""The port's multi-device modes on the CPU, against the JAX package's.

The reference runs one process over the 8 virtual CPU devices
``tests/conftest.py`` provides; the port runs one gloo process a rank,
started by ``odigos_tpu_torch.parallel.launch.spawn`` (three spawns in this
file: rings of 2 and 8 ranks, the 8-rank mesh cases in the second, and a
4-rank data axis). The rank functions live in ``torch_parallel_ranks.py``,
which imports no JAX.

* K22's plain version (``ring_block_attention_plain``) merging two blocks,
  one of them fully masked, against the reference's ``_block_attention``
  and ``_ring_body`` merge, in f32 and with bf16 q, within ``BLOCK_TOL``
  (both sum f32 products, in other orders);
* ``ring_attention`` on gloo rings of 2 and 8 ranks, and ``ring_body`` with
  the in-process rotation ``chip_smoke.py`` uses on the card, against the
  JAX ``ring_attention`` on the 8-device mesh and ``reference_attention``
  on the reference's own inputs (2, 32, 2, 8; 80% of keys kept) within
  ``RING_TOL`` atol and rtol, the reference's own bound
  (``tests/test_parallel.py:116``); the all-masked input gives finite zeros;
  a length that is not a multiple of the ring raises;
* ``mesh_key`` gives the reference's labels; ``make_mesh``'s default,
  prefix and "needs" cases; on a ``"model"`` axis above 1 the
  transformer's score function and (on its shard) train step are built,
  and the autoencoder's build too (ROADMAP A8.4, ported); the entry points
  default to the card and raise without one;
* the data-parallel score function on ``{"data": 4}`` against the JAX
  ``make_sharded_score_fn`` on ``{"data": 4, "model": 1}`` (5 traces, padded
  to 8, and 12) within ``SCORE_ATOL``, the reference's own bound;
* three data-parallel train steps on ``{"data": 4}`` (14 traces, so the
  ranks hold different numbers of real spans) from the reference's seed
  weights against the JAX ``make_sharded_train_step`` with ``optax.adam``:
  losses within ``LOSS_RTOL`` (a mean of the ranks' means would miss by
  percents); the first step's all-reduced gradients against ``jax.grad``
  of the reference ``loss_fn`` over the global batch within ``GRAD_RTOL``
  of each parameter's largest gradient plus ``GRAD_ATOL``
  (``tests/test_torch_training.py``'s one-step bounds); the parameters
  after three steps within ``PARAM_ATOL``, every replica equal. The
  parameters are held to 1% of the steps' total learning rate, not to a
  share of their magnitude: Adam divides each gradient element by its own
  root mean square, so an element whose gradient is a cancellation near 0
  turns the two frameworks' f32 summation orders into steps a fraction of
  the rate apart, and XLA's CPU summation order depends on its threads:
  the worst parameter read 9.4e-6 (the FFN1 weight) with XLA's default
  threads and 1.57e-5 (the query weight) with its Eigen threads off
  (``--xla_cpu_multi_thread_eigen=false``), so 1e-5 absolute would hold on
  one setting and not the other. The key biases, whose true gradient is
  0, are held to the steps' total rate, as ``tests/test_torch_training.py``
  holds them.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from odigos_tpu.features import assemble_sequences
from odigos_tpu.models import TraceTransformer as JTraceTransformer
from odigos_tpu.models import TransformerConfig as JTransformerConfig
from odigos_tpu.parallel import make_mesh as j_make_mesh
from odigos_tpu.parallel import make_sharded_score_fn as j_score_fn
from odigos_tpu.parallel import make_sharded_train_step as j_train_step
from odigos_tpu.parallel import mesh_key as j_mesh_key
from odigos_tpu.parallel import ring_attention as j_ring_attention
from odigos_tpu.parallel import shard_variables
from odigos_tpu.parallel.ring_attention import \
    PARTITION_SPECS as J_PARTITION_SPECS
from odigos_tpu.parallel.sharding import \
    PARTITION_RULES as J_PARTITION_RULES
from odigos_tpu.parallel.ring_attention import NEG_INF as J_NEG_INF
from odigos_tpu.parallel.ring_attention import _block_attention
from odigos_tpu.parallel.ring_attention import \
    reference_attention as j_reference_attention
from odigos_tpu.pdata import synthesize_traces
from odigos_tpu_torch.kernels import coverage
from odigos_tpu_torch.kernels.ring import (NEG_INF, ring_block_attention,
                                           ring_block_attention_plain)
from odigos_tpu_torch.models import TraceTransformer, TransformerConfig
from odigos_tpu_torch.models import flax_to_torch
from odigos_tpu_torch.parallel import (PARTITION_RULES, PARTITION_SPECS,
                                       LocalRotation, make_mesh, mesh_key,
                                       reference_attention, ring_body)
from odigos_tpu_torch.parallel.dryrun import dryrun_multichip
from odigos_tpu_torch.parallel.launch import spawn

import torch_parallel_ranks as ranks

torch.set_num_threads(1)

BLOCK_TOL = 1e-5     # one block pair: f32 sums in another order (~1e-7)
RING_TOL = 1e-5      # the reference's ring bound, atol and rtol
SCORE_ATOL = 2e-5    # the reference's sharded-scoring bound
LOSS_RTOL = 1e-5     # three steps' losses, relative (measured 1e-7)
GRAD_RTOL = 1e-5     # the first step's gradients, of each largest ...
GRAD_ATOL = 1e-8     # ... plus the key biases' zero gradient's noise
LR = 1e-3            # optax.adam(1e-3), the reference's dry run
STEPS = 3
PARAM_ATOL = 0.01 * STEPS * LR  # 1% of the total rate (worst 1.57e-5)
SPAWN_TIMEOUT = 240.0
TINY = dict(d_model=32, n_heads=4, n_layers=1, d_ff=64, max_len=16)


# ------------------------------------------------- the reference's inputs
def _ring_inputs():
    """``tests/test_parallel.py``'s ring inputs, as numpy arrays."""
    B, L, H, D = 2, 32, 2, 8
    q, k, v = (np.array(jax.random.normal(key, (B, L, H, D)))
               for key in jax.random.split(jax.random.PRNGKey(0), 3))
    mask = np.random.default_rng(0).random((B, L)) < 0.8
    return q, k, v, mask


def _masked_inputs():
    """``tests/test_parallel.py``'s all-masked input (1, 16, 1, 4)."""
    ones = np.ones((1, 16, 1, 4), np.float32)
    return ones, ones.copy(), ones.copy(), np.zeros((1, 16), bool)


@pytest.fixture(scope="module")
def ring_ref():
    q, k, v, mask = _ring_inputs()
    mesh = j_make_mesh({"seq": 8}, axes=("seq",))
    out = j_ring_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           jnp.asarray(mask), mesh, axis_name="seq")
    ref = j_reference_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jnp.asarray(mask))
    masked = j_ring_attention(*(jnp.asarray(a) for a in _masked_inputs()),
                              mesh)
    return {"ring": np.asarray(out), "ref": np.asarray(ref),
            "masked": np.asarray(masked)}


@pytest.fixture(scope="module")
def ring2():
    return spawn(ranks.ring_rank, 2, device="cpu",
                 args=(*_ring_inputs(), _masked_inputs()),
                 timeout=SPAWN_TIMEOUT)


@pytest.fixture(scope="module")
def ring8():
    """The 8-rank spawn: the ring, then the mesh cases, on one world."""
    got = spawn(ranks.ring_rank, 8, device="cpu",
                args=(*_ring_inputs(), _masked_inputs(), True),
                timeout=SPAWN_TIMEOUT)
    return got, [r["mesh"] for r in got]


# ------------------------------------------------------ K22's plain version
def _j_merge(o, m, s, o_i, m_i, s_i):
    """``_ring_body``'s merge (odigos_tpu/parallel/ring_attention.py)."""
    m_new = jnp.maximum(m, m_i)
    alpha = jnp.exp(m - m_new)
    beta = jnp.exp(m_i - m_new)
    o = o * alpha.transpose(0, 2, 1)[..., None] \
        + o_i * beta.transpose(0, 2, 1)[..., None]
    return o, m_new, s * alpha + s_i * beta


@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked_first", [True, False])
def test_block_plain_matches_the_reference_block_and_merge(q_dtype,
                                                           masked_first):
    rng = np.random.default_rng(3)
    B, Lq, Lk, H, D = 2, 7, 9, 3, 16
    q = rng.standard_normal((B, Lq, H, D)).astype(np.float32)
    ks = [rng.standard_normal((B, Lk, H, D)).astype(np.float32) * 2
          for _ in range(2)]
    vs = [rng.standard_normal((B, Lk, H, D)).astype(np.float32)
          for _ in range(2)]
    masks = [rng.random((B, Lk)) < 0.7, rng.random((B, Lk)) < 0.7]
    masks[0 if masked_first else 1][1] = False  # a fully masked block
    scale = 1.0 / (D ** 0.5)
    jdt, tdt = getattr(jnp, q_dtype), getattr(torch, q_dtype)
    jq = jnp.asarray(q, jdt)
    o = jnp.zeros((B, Lq, H, D), jnp.float32)
    m = jnp.full((B, H, Lq), J_NEG_INF, jnp.float32)
    s = jnp.zeros((B, H, Lq), jnp.float32)
    tq = torch.from_numpy(q).to(tdt)
    to = torch.zeros((B, Lq, H, D))
    tm = torch.full((B, H, Lq), NEG_INF)
    ts = torch.zeros((B, H, Lq))
    for k, v, mask in zip(ks, vs, masks):
        o, m, s = _j_merge(o, m, s, *_block_attention(
            jq, jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask), scale))
        ring_block_attention(tq, torch.from_numpy(k), torch.from_numpy(v),
                             torch.from_numpy(mask), to, tm, ts)
        for got, ref in ((to, o), (tm, m), (ts, s)):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       atol=BLOCK_TOL, rtol=BLOCK_TOL)
    out = np.asarray(o / jnp.maximum(s, 1e-30).transpose(0, 2, 1)[..., None])
    # the last step again, finalized: the output over o
    to2, tm2, ts2 = (torch.zeros_like(to), torch.full_like(tm, NEG_INF),
                     torch.zeros_like(ts))
    for i, (k, v, mask) in enumerate(zip(ks, vs, masks)):
        ring_block_attention_plain(
            tq, torch.from_numpy(k), torch.from_numpy(v),
            torch.from_numpy(mask).to(torch.uint8), to2, tm2, ts2,
            finalize=i == 1)
    np.testing.assert_allclose(to2.numpy(), out, atol=BLOCK_TOL,
                               rtol=BLOCK_TOL)
    assert np.isfinite(to2.numpy()).all()


def test_block_refusals_and_the_card_geometry():
    q = torch.zeros((1, 4, 1, 8))
    kv = torch.zeros((1, 5, 1, 8))
    mask = torch.ones((1, 5), dtype=torch.bool)
    o, m, s = torch.zeros((1, 4, 1, 8)), torch.zeros((1, 1, 4)), \
        torch.zeros((1, 1, 4))
    with pytest.raises(TypeError, match="k must be float32"):
        ring_block_attention(q, kv.double(), kv, mask, o, m, s)
    with pytest.raises(TypeError, match="q must be"):
        ring_block_attention(q.half(), kv, kv, mask, o, m, s)
    with pytest.raises(ValueError, match="kv_mask"):
        ring_block_attention(q, kv, kv, mask[:, :4], o, m, s)
    with pytest.raises(ValueError, match="m must be"):
        ring_block_attention(q, kv, kv, mask, o, m[..., :3], s)
    for d in (1, 4, 8, 16, 64, 128, 256):
        coverage.check_ring(d)
    for d in (0, 257, 512):
        with pytest.raises(ValueError, match="head dim from 1 to 256"):
            coverage.check_ring(d)


# ------------------------------------------------------------ the ring
@pytest.mark.parametrize("n", [2, 8])
def test_ring_attention_matches_the_reference(n, ring_ref, ring2, ring8):
    got = (ring2 if n == 2 else ring8[0])
    for r in got:  # every rank gathers the same global output
        np.testing.assert_allclose(r["out"], ring_ref["ring"], atol=RING_TOL,
                                   rtol=RING_TOL)
        np.testing.assert_allclose(r["out"], ring_ref["ref"], atol=RING_TOL,
                                   rtol=RING_TOL)


@pytest.mark.parametrize("n", [2, 8])
def test_ring_all_masked_gives_finite_zeros(n, ring_ref, ring2, ring8):
    got = (ring2 if n == 2 else ring8[0])[0]["masked"]
    assert np.isfinite(got).all() and (got == 0).all()
    np.testing.assert_array_equal(got, ring_ref["masked"])


@pytest.mark.parametrize("n", [2, 8])
def test_ring_refuses_an_uneven_split(n, ring2, ring8):
    got = (ring2 if n == 2 else ring8[0])
    for r in got:
        assert r["uneven"].startswith("ValueError") and \
            "not a multiple" in r["uneven"], r["uneven"]


@pytest.mark.parametrize("n", [1, 2, 8])
def test_in_process_ring_matches_the_reference(n, ring_ref):
    """``ring_body`` with :class:`LocalRotation` (every block in this
    process, as ``chip_smoke.py`` drives it on the card)."""
    q, k, v, mask = (torch.from_numpy(a) for a in _ring_inputs())
    L = q.shape[1] // n
    blocks = [(k[:, i * L:(i + 1) * L].contiguous(),
               v[:, i * L:(i + 1) * L].contiguous(),
               mask[:, i * L:(i + 1) * L].to(torch.uint8).contiguous())
              for i in range(n)]
    out = torch.cat([ring_body(q[:, j * L:(j + 1) * L], *blocks[j], n,
                               LocalRotation(blocks, j))
                     for j in range(n)], dim=1)
    np.testing.assert_allclose(out.numpy(), ring_ref["ring"], atol=RING_TOL,
                               rtol=RING_TOL)
    # the port's own single-device oracle is the reference's
    np.testing.assert_allclose(
        reference_attention(*(torch.from_numpy(a) for a in _ring_inputs())
                            ).numpy(), ring_ref["ref"], atol=RING_TOL,
        rtol=RING_TOL)


# ------------------------------------------------------------ the mesh
@pytest.mark.parametrize("shape", [
    {"data": 4, "model": 2}, {"data": 8, "model": 1}, {"data": 1},
    (("seq", 8),), {"data": 2, "seq": 4}, {}])
def test_mesh_key_is_the_reference_label(shape):
    assert mesh_key(shape) == j_mesh_key(shape)


def test_make_mesh_default_prefix_and_needs(ring8):
    cases = ring8[1]
    for rank, c in enumerate(cases):
        assert c["full"] == ("data8", {"data": 8, "model": 1})
        numel, coord, key = c["prefix"]
        assert (numel, key) == (6, "data3xmodel2")
        assert coord == (None if rank >= 6 else (rank // 2, rank % 2))
        assert c["needs"].startswith("ValueError") and "needs 9" in c["needs"]


def test_a_model_axis_raises_naming_a8_2(ring8):
    """A model axis above 1 (ROADMAP A8.2, the transformer's, and A8.4,
    the autoencoder's): the transformer's entry points take ``{"model":
    2}``, each rank holding its shard (one of the two heads); so do the
    autoencoder's, which raised (naming A8.4) before it was ported."""
    for rank, c in enumerate(ring8[1]):
        assert c["tp_shard"] == (2, (rank % 2,), 1)
        assert c["tp_step"] == "" and c["tp_score"] == "", c
        assert c["ae_score"] == "", c["ae_score"]


def test_partition_data_is_the_reference_s():
    """``PARTITION_SPECS`` declares the reference's sharded ring entry
    point, and ``PARTITION_RULES`` is the reference's rule table, pattern
    for pattern and axis for axis (a ``PartitionSpec`` as a tuple)."""
    assert set(PARTITION_SPECS) == set(J_PARTITION_SPECS)
    assert all(isinstance(v, str) and v for v in PARTITION_SPECS.values())
    assert [(pat, tuple(spec)) for pat, spec in PARTITION_RULES] == \
        [(pat, tuple(spec)) for pat, spec in J_PARTITION_RULES]


def test_entry_points_default_to_the_card():
    assert inspect.signature(make_mesh).parameters["device"].default == \
        "cuda"
    assert inspect.signature(dryrun_multichip).parameters[
        "device"].default == "cuda"
    assert inspect.signature(spawn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this pins the no-card path")
    with pytest.raises(RuntimeError, match="cuda"):
        make_mesh({"data": 1})
    with pytest.raises(RuntimeError, match="cuda"):
        dryrun_multichip(1)
    with pytest.raises(RuntimeError, match="cards"):
        spawn(ranks.mesh_rank, 2)


# --------------------------------------------------------- the data axis
def _seqs(n_traces: int, seed: int):
    return assemble_sequences(synthesize_traces(n_traces, seed=seed),
                              max_len=16)


@pytest.fixture(scope="module")
def dp_case():
    jmodel = JTraceTransformer(JTransformerConfig(dtype=jnp.float32, **TINY))
    variables = jmodel.init(jax.random.PRNGKey(0))
    cfg = TransformerConfig(dtype=torch.float32, **TINY)
    state = {k: v.numpy() for k, v in flax_to_torch(
        jax.tree.map(np.asarray, variables), cfg).items()}
    score_inputs = [(s.categorical, s.continuous, s.mask)
                    for s in (_seqs(5, 1), _seqs(12, 0))]
    seqs = _seqs(14, 2)
    rng = np.random.default_rng(0)
    span_labels = (rng.random(seqs.mask.shape) < 0.2) & seqs.mask
    trace_labels = rng.random(seqs.mask.shape[0]) < 0.5
    train_inputs = (seqs.categorical, seqs.continuous, seqs.mask,
                    span_labels, trace_labels)
    got = spawn(ranks.dp_rank, 4, device="cpu",
                args=(TINY, state, score_inputs, train_inputs, STEPS, LR),
                timeout=SPAWN_TIMEOUT)
    # the reference on {"data": 4, "model": 1} of the 8 virtual devices
    mesh = j_make_mesh({"data": 4, "model": 1})
    jscore = j_score_fn(jmodel, mesh)
    ref_scores = [jscore(shard_variables(variables, mesh), *args)
                  for args in score_inputs]
    tx = optax.adam(LR)
    jvars = shard_variables(variables, mesh)
    opt_state = tx.init(jvars)
    jstep = j_train_step(jmodel, tx, mesh)
    ref_losses = []
    for _ in range(STEPS):
        jvars, opt_state, loss = jstep(jvars, opt_state, *train_inputs)
        ref_losses.append(float(loss))
    ref_params = {k: v.numpy() for k, v in flax_to_torch(
        jax.tree.map(np.asarray, jvars), cfg).items()}
    grads = jax.grad(lambda vv: jmodel.loss_fn(
        vv, *(jnp.asarray(a) for a in train_inputs)))(variables)
    ref_grads = {k: v.numpy() for k, v in flax_to_torch(
        jax.tree.map(np.asarray, grads), cfg).items()}
    return got, ref_scores, ref_losses, ref_params, ref_grads


@pytest.mark.parametrize("case", [0, 1], ids=["5_traces_padded", "12_traces"])
def test_dp_scores_match_the_sharded_reference(dp_case, case):
    got, ref_scores = dp_case[:2]
    ref_span, ref_trace = ref_scores[case]
    for r in got:
        span, trace = r["scores"][case]
        assert span.shape == ref_span.shape and trace.shape == ref_trace.shape
        np.testing.assert_allclose(span, ref_span, atol=SCORE_ATOL)
        np.testing.assert_allclose(trace, ref_trace, atol=SCORE_ATOL)


def test_dp_train_losses_match_the_sharded_reference(dp_case):
    got, ref_losses = dp_case[0], dp_case[2]
    for r in got:
        np.testing.assert_allclose(r["losses"], ref_losses, rtol=LOSS_RTOL)
        assert r["training"] is False  # the step restores eval mode


def test_dp_first_step_gradients_match_jax_grad(dp_case):
    got, ref_grads = dp_case[0], dp_case[4]
    for name, ref in ref_grads.items():
        bound = GRAD_RTOL * np.abs(ref).max() + GRAD_ATOL
        for r in got:
            err = np.abs(r["grads"][name] - ref).max()
            assert err <= bound, (name, err, bound)


def test_dp_train_parameters_match_the_sharded_reference(dp_case):
    got, ref_params = dp_case[0], dp_case[3]
    for name, ref in ref_params.items():
        for r in got:
            p = r["params"][name]
            if name.endswith("key.bias"):
                assert np.abs(p).max() <= 1.01 * STEPS * LR, name
                continue
            err = np.abs(p - ref).max()
            assert err <= PARAM_ATOL, (name, err, PARAM_ATOL)
        # every replica took the same updates
        np.testing.assert_array_equal(got[0]["params"][name],
                                      got[-1]["params"][name])


def test_loss_terms_give_loss_fn_exactly():
    seqs = _seqs(6, 4)
    rng = np.random.default_rng(1)
    labels = ((rng.random(seqs.mask.shape) < 0.2) & seqs.mask,
              rng.random(seqs.mask.shape[0]) < 0.5)
    model = TraceTransformer(TransformerConfig(dtype=torch.float32, **TINY),
                             device="cpu")
    args = (seqs.categorical, seqs.continuous, seqs.mask, *labels)
    span_sum, span_n, trace_sum, trace_n = model.loss_terms(*args)
    loss = model.loss_fn(*args)
    assert float(span_n) == seqs.mask.sum()
    assert float(trace_n) == seqs.mask.any(-1).sum()
    assert loss.item() == (span_sum / span_n + trace_sum / trace_n).item()

"""K5's hash join (``csrc/featurize.cu``) as an algorithm, on the CPU.

The card's kernel cannot run here, so its join is replayed on the host:
the table of ``featurize.table_slots(N)`` slots holding (row, hash tag),
the warp's one insert a key (its lowest lane), the linear probe by 4-slot
group loads (a snapshot each), the tag test before the owner's key, the
CAS claim and the ``atomicMin`` of the lower row, each load, CAS and
atomicMin a step interleaved with the other threads' in a random order;
then each span's probe of ``(frame, parent_id)``. The result must not
depend on the order:
for several orders, and with a table of the fewest slots the keys allow
(every probe collides), or with every key hashed to one slot and one tag
(every step reads the owner's key), the model's
``(found, parent_service)`` equals the port's plain join
(``featurize_join_torch``) and the JAX package's ``featurize_join_jax``
exactly, on the otel mix, the adversarial frame and the stress frames
(``join_stress_frames``: one span id a frame, repeated across frames,
span id 0 declared, parents resolving nowhere or to the frame's first
row).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from odigos_tpu.features.featurizer import featurize_join_jax
from odigos_tpu_torch.features.featurizer import featurize_join_torch
from odigos_tpu_torch.kernels import featurize as kfeat
from odigos_tpu_torch.pdata import (adversarial_traces, join_stress_frames,
                                    synthesize_traces)

torch.set_num_threads(1)

EMPTY = (1 << 64) - 1
M64 = (1 << 64) - 1


def key_hash(frame: int, span: int) -> int:
    """``featurize.cu`` key_hash: splitmix64's finalizer over the span id
    and the frame times an odd constant (the slot from its low bits, the
    tag from its high word)."""
    z = span ^ ((frame * 0x9E3779B97F4A7C15) & M64)
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & M64
    return z ^ (z >> 31)


GROUP = 4  # slots a probe step loads (featurize.cu kGroup)


def _walk(tab, P, h):
    """The probe order from slot h: (slot, the value its group's load saw),
    one 4-slot group load at a time, in order, wrapping at P; yields None
    after each group load."""
    while True:
        g = h & ~(GROUP - 1)
        snap = tab[g:g + GROUP]
        yield None
        for t in range(h - g, GROUP):
            yield g + t, snap[t]
        h = (g + GROUP) & (P - 1)


def _insert(i, frame, span, tab, P, home):
    """One warp leader's insert, yielding after each memory operation (a
    group load, a CAS, an atomicMin) so that the caller interleaves
    threads."""
    f, s = frame[i], span[i]
    z = home(f, s)
    tag = z >> 32
    v = (i << 32) | tag
    for step in _walk(tab, P, z & (P - 1)):
        if step is None:
            yield
            continue
        slot, cur = step
        if cur == EMPTY:
            cur = tab[slot]  # atomicCAS(tab + slot, EMPTY, v)
            if cur == EMPTY:
                tab[slot] = v
            yield
            if cur == EMPTY:
                return
        if cur & 0xFFFFFFFF != tag:
            continue  # another key
        o = cur >> 32
        if frame[o] == f and span[o] == s:
            if o > i:
                tab[slot] = min(tab[slot], v)  # atomicMin
                yield
            return


def k5_join_model(frame, span, parent, svc, n, P, rng, home=key_hash):
    """The kernel's join on the host: ``(found, parent_service, table)``
    for the first ``n`` rows, the inserts interleaved in ``rng``'s order
    (a numpy Generator), or with ``rng=None`` run one after another from
    the highest row down (every lower row of a key arriving after a
    higher one has claimed its slot)."""
    frame = [int(x) for x in frame[:n]]
    span = [int(x) for x in span[:n]]
    svc = [int(x) for x in svc[:n]]
    tab = [EMPTY] * P
    leaders = []
    for w0 in range(0, n, 32):  # a warp's lanes of one key: the lowest
        seen = set()
        for i in range(w0, min(w0 + 32, n)):
            if (frame[i], span[i]) not in seen:
                seen.add((frame[i], span[i]))
                leaders.append(i)
    live = [_insert(i, frame, span, tab, P, home) for i in leaders]
    if rng is None:
        for thread in reversed(live):
            for _ in thread:
                pass
        live = []
    while live:
        k = int(rng.integers(len(live)))
        try:
            next(live[k])
        except StopIteration:
            live[k] = live[-1]
            live.pop()
    found = np.zeros(n, bool)
    psvc = np.zeros(n, np.int32)
    for i in range(n):
        f, p = frame[i], int(parent[i])
        z = home(f, p)
        for step in _walk(tab, P, z & (P - 1)):
            if step is None:
                continue
            _, cur = step
            if cur == EMPTY:
                break
            o = cur >> 32
            if cur & 0xFFFFFFFF == z >> 32 and frame[o] == f \
                    and span[o] == p:
                found[i] = True
                psvc[i] = svc[o]
                break
    return found, psvc, tab


def _frame_columns(kind: str, seed: int):
    """``(frame, span_id, parent_id, service ids)`` of a group as numpy
    arrays (u64 ids), several frames for the stress kind."""
    if kind == "stress":
        batches = join_stress_frames(120, frames=4, seed=seed)
    elif kind == "adversarial":
        batches = [adversarial_traces(40, seed=seed)]
    else:
        batches = [synthesize_traces(25, seed=seed),
                   synthesize_traces(15, seed=seed + 1)]
    fr, sp, pa = [], [], []
    for k, b in enumerate(batches):
        fr.append(np.full(len(b), k, np.int32))
        sp.append(b.columns["span_id"])
        pa.append(b.columns["parent_span_id"])
    fr, sp, pa = (np.concatenate(a) for a in (fr, sp, pa))
    svc = np.random.default_rng(seed).integers(0, 512, len(sp)).astype(
        np.int32)
    return fr, sp, pa, svc


def _plain_and_jax(fr, sp, pa, svc):
    n = len(sp)
    N = n + 7  # padding rows past n
    pad = np.zeros(N - n, np.int64)

    def t(a):
        return torch.from_numpy(np.concatenate([a.view(np.int64), pad]))

    found, psvc = featurize_join_torch(
        torch.from_numpy(np.concatenate([svc, pad.astype(np.int32)])),
        t(sp), t(pa),
        torch.from_numpy(np.concatenate([fr, np.full(N - n, -1, np.int32)])),
        n)
    split = [jnp.asarray((a >> np.uint64(s)).astype(np.uint32))
             for a in (sp, pa) for s in (32, 0)]
    jfound, jpsvc = featurize_join_jax(jnp.asarray(svc), *split,
                                       jnp.asarray(fr))
    return (found.numpy()[:n], psvc.numpy()[:n], np.asarray(jfound),
            np.asarray(jpsvc))


def _distinct_keys(fr, sp) -> int:
    return len(set(zip(fr.tolist(), sp.tolist())))


TABLES = ["kernel", "tiny", "one_home"]


@pytest.mark.parametrize("table", TABLES)
@pytest.mark.parametrize("kind,seed", [("otel", 3), ("adversarial", 4),
                                       ("stress", 5), ("stress", 6)])
def test_k5_join_model_matches_plain_and_jax(kind, seed, table):
    """The hash join, replayed in three thread orders, gives the plain
    join's and the reference's (found, parent_service) bit for bit: in the
    kernel's table (``table_slots(N)``), in the smallest power of two that
    holds the keys (long probe chains), and with every key's home the same
    slot (each probe walks every key before it)."""
    fr, sp, pa, svc = _frame_columns(kind, seed)
    n = len(sp)
    found, psvc, jfound, jpsvc = _plain_and_jax(fr, sp, pa, svc)
    np.testing.assert_array_equal(found, jfound)
    np.testing.assert_array_equal(psvc, jpsvc)
    keys = _distinct_keys(fr, sp)
    home = key_hash
    if table == "kernel":
        P = kfeat.table_slots(n + 7)
    else:  # > keys: one empty slot at least; one group at least
        P = max(GROUP, 1 << keys.bit_length())
        if table == "one_home":
            home = lambda f, s: 0  # noqa: E731
    assert P > keys
    for order in range(3):
        rng = np.random.default_rng(100 * seed + order)
        got_found, got_psvc, tab = k5_join_model(fr, sp, pa, svc, n, P,
                                                 rng, home)
        np.testing.assert_array_equal(got_found, found)
        np.testing.assert_array_equal(got_psvc, psvc)
        assert sum(v != EMPTY for v in tab) == keys
    if kind == "stress":  # one key a frame: the four frames' ids
        assert keys == 4 and found.any() and not found.all()


@pytest.mark.parametrize("schedule", ["highest_first", 0, 1, 2, 3])
@pytest.mark.parametrize("table", ["kernel", "one_home"])
def test_k5_join_model_keeps_the_first_row_of_a_key(schedule, table):
    """Pinned by hand: rows 10, 40 and 65 (three warps) declare id 5 in
    frame 0, row 66 in frame 1; the slot of (0, 5) ends holding row 10,
    whichever row claims it first (the highest row does under
    "highest_first"), and its parents resolve there; row 1 and row 2 (one
    warp) declare id 9, inserted once, by row 1."""
    n = 70
    span = np.arange(1000, 1000 + n, dtype=np.uint64)
    span[[10, 40, 65, 66]] = 5
    span[[1, 2]] = 9
    frame = np.zeros(n, np.int32)
    frame[66:] = 1
    parent = np.full(n, 77, np.uint64)  # nowhere
    parent[[0, 41]] = 5
    parent[[67, 3]] = [5, 9]
    svc = np.arange(n, dtype=np.int32) + 300
    home = key_hash if table == "kernel" else (lambda f, s: 0)
    rng = None if schedule == "highest_first" else np.random.default_rng(
        schedule)
    found, psvc, tab = k5_join_model(frame, span, parent, svc, n, 128, rng,
                                     home)
    assert np.flatnonzero(found).tolist() == [0, 3, 41, 67]
    assert psvc[[0, 3, 41, 67]].tolist() == [310, 301, 310, 366]
    owners = sorted(v >> 32 for v in tab if v != EMPTY)
    assert 10 in owners and 1 in owners and 66 in owners
    assert not {2, 40, 65} & set(owners)
    assert len(owners) == _distinct_keys(frame, span)


@pytest.mark.parametrize("N", [0, 1, 2, 3, 4096, 65536, 65537, 131072])
def test_k5_table_is_at_most_a_quarter_full(N):
    P = kfeat.table_slots(N)
    assert P >= 4 * N and P >= GROUP and P & (P - 1) == 0
    assert P < 8 * max(N, 1)

"""The device trainer's kernels K13-K16 (their plain versions, which the
wrappers run on CPU tensors) against the JAX package's jitted programs of
``parallel/trainer.py``, bit for bit: every quantity is int32, so the
comparison is exact (the kernels' integer atomics give the same sums in any
order; ``tests/test_torch_gpu.py`` holds them to these plain versions on
the card).

Inputs come from numpy seeds: random rows with tombstones, runs of
``a == b``, adjacent occurrences, rows of one token and of none
(``utils/corpus.py:merge_edge_rows``), ``new_id = V - 1``.  The block and
the window run through ``parallel/trainer.py:run_steps``, the trainer's own
step loop, against ``make_k_merge_steps`` and ``make_inl_window_steps`` on a
one-device mesh.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from complexity_tokenizer_tpu.parallel.mesh import DATA_AXIS, data_mesh
from complexity_tokenizer_tpu.parallel.trainer import (
    make_initial_hist,
    make_inl_window_steps,
    make_k_merge_steps,
    make_merge_step,
)
from complexity_tokenizer_tpu_torch.ops.trainer_device import merge_step, pair_hist
from complexity_tokenizer_tpu_torch.parallel.trainer import run_steps
from complexity_tokenizer_tpu_torch.utils.corpus import merge_edge_rows


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many ops on small tensors: with the test
    workers sharing the machine, torch's intra-op threads only wait on each
    other (one thread runs these tests many times faster under load)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_rows(seed: int, n: int = 64, w: int = 13, ids: int = 4, holes: float = 0.3):
    rng = np.random.RandomState(seed)
    words = rng.randint(0, ids, size=(n, w)).astype(np.int32)
    words[rng.rand(n, w) < holes] = -1
    freqs = rng.randint(1, 1000, size=n).astype(np.int32)
    return rng, words, freqs


@pytest.mark.parametrize("seed", range(4))
def test_k13_matches_make_initial_hist(seed):
    _, words, freqs = _random_rows(seed, ids=7, holes=0.2)
    # the seed rows: tokens then padding
    words = np.sort(words, axis=1)[:, ::-1].copy()
    v0 = 7
    want = np.asarray(jax.jit(make_initial_hist(v0))(words, freqs))
    got = pair_hist(torch.from_numpy(words), torch.from_numpy(freqs), v0)
    assert got.dtype == torch.int32 and got.shape == (v0 * v0,)
    np.testing.assert_array_equal(got.numpy(), want)


def _k14(words, freqs, a, b, new, V):
    w = torch.from_numpy(words.copy())
    delta = torch.zeros(V, 4, dtype=torch.int32)
    minted = torch.zeros(1, dtype=torch.int32)
    merge_step(w, torch.from_numpy(freqs), new, delta, minted, a=a, b=b)
    return w.numpy(), delta.numpy(), int(minted)


def _jax_k14(words, freqs, a, b, new, V):
    out, delta, minted = jax.jit(make_merge_step(V))(
        words, freqs, np.int32(a), np.int32(b), np.int32(new))
    return np.asarray(out), np.asarray(delta), int(minted)


@pytest.mark.parametrize("case", range(6))
def test_k14_matches_make_merge_step_on_edge_rows(case):
    label, words, freqs, a, b, new = merge_edge_rows()[case]
    V = new + 1
    got, want = _k14(words, freqs, a, b, new, V), _jax_k14(words, freqs, a, b, new, V)
    np.testing.assert_array_equal(got[0], want[0], err_msg=label)
    np.testing.assert_array_equal(got[1], want[1], err_msg=label)  # entry for entry
    assert got[2] == want[2], label


@pytest.mark.parametrize("seed", range(6))
def test_k14_matches_make_merge_step_on_random_rows(seed):
    """Random tombstoned rows over few ids (so runs, adjacent occurrences and
    tombstones between a pair's tokens are common), several pairs in turn
    on the same rows, ``a == b`` included; ``new = V - 1``."""
    rng, words, freqs = _random_rows(seed, n=200, w=(2, 5, 13, 13, 31, 64)[seed], ids=3)
    V = 16
    for step in range(5):
        a, b = int(rng.randint(0, 3)), int(rng.randint(0, 3))
        if step == 4:
            b = a
        new = V - 1 - step
        got, want = _k14(words, freqs, a, b, new, V), _jax_k14(words, freqs, a, b, new, V)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        words = got[0]


def _mesh_fn(fn, n_in: int, n_out: int):
    mesh = data_mesh(1)
    return jax.jit(jax.shard_map(
        fn, mesh=mesh, in_specs=(P(DATA_AXIS), P(DATA_AXIS)) + (P(),) * (n_in - 2),
        out_specs=(P(DATA_AXIS),) + (P(),) * (n_out - 1)))


def _seed_hist(words, freqs, V):
    v0 = int(words.max()) + 1
    hist = np.zeros((V, V), np.int32)
    hist[:v0, :v0] = pair_hist(torch.from_numpy(words), torch.from_numpy(freqs), v0).numpy().reshape(v0, v0)
    return v0, hist


@pytest.mark.parametrize("n_do,rows", [(32, 300), (13, 300), (32, 2)])
def test_block_matches_make_k_merge_steps(n_do, rows):
    """A classic block (K15 -> K14 -> K16 a step) against
    ``make_k_merge_steps``: words, histogram, ma, mb, mf; a full block, a
    block with ``n_do < k``, and few rows, where the histogram is exhausted
    mid-block."""
    k, V = 32, 64
    _, words, freqs = _random_rows(7, n=rows, w=9, ids=5)
    v0, hist = _seed_hist(words, freqs, V)
    fn = _mesh_fn(make_k_merge_steps(V, k), 5, 5)
    jw, jh, jma, jmb, jmf = (np.asarray(x) for x in fn(
        words, freqs, hist, jnp.int32(v0), jnp.int32(n_do)))
    w = torch.from_numpy(words.copy())
    h = torch.from_numpy(hist.copy())
    log = torch.tensor([[-1] * k, [-1] * k, [0] * k], dtype=torch.int32)
    deltas = torch.zeros(k, V, 4, dtype=torch.int32)
    run_steps(n_do, v0, w, torch.from_numpy(freqs), h, log, deltas)
    np.testing.assert_array_equal(w.numpy(), jw)
    np.testing.assert_array_equal(h.numpy(), jh)
    np.testing.assert_array_equal(log.numpy(), np.stack([jma, jmb, jmf]))
    if rows == 2:
        assert (jma[:n_do] < 0).any() and (jma >= 0).any()


@pytest.mark.parametrize("T,n_cand", [(64, 60), (4, 4), (64, 40)])
def test_window_matches_make_inl_window_steps(T, n_cand):
    """An INL window (the K15 walk over the candidates -> K14 -> K16) against
    ``make_inl_window_steps``: words, histogram, ma, mb, mf, the logged
    deltas and the cursor; with T = 4, and with 40 candidates over the 25
    pairs of 5 ids, the walk runs out before the window's end."""
    k, V = 100, 128
    rng, words, freqs = _random_rows(11, n=300, w=9, ids=5)
    v0, hist = _seed_hist(words, freqs, V)
    # candidates: live pairs and dead ones, in a shuffled walk order
    ca = rng.randint(0, v0, size=T).astype(np.int32)
    cb = rng.randint(0, v0, size=T).astype(np.int32)
    n_do = min(k, n_cand)
    fn = _mesh_fn(make_inl_window_steps(V, k, T), 8, 7)
    jw, jh, jma, jmb, jmf, jd, jlast = (np.asarray(x) for x in fn(
        words, freqs, hist, ca, cb, jnp.int32(n_cand), jnp.int32(v0), jnp.int32(n_do)))
    w = torch.from_numpy(words.copy())
    h = torch.from_numpy(hist.copy())
    log = torch.tensor([[-1] * k, [-1] * k, [0] * k], dtype=torch.int32)
    deltas = torch.zeros(k, V, 4, dtype=torch.int32)
    state = torch.tensor([-1, 0], dtype=torch.int32)
    run_steps(n_do, v0, w, torch.from_numpy(freqs), h, log, deltas,
              cand=(torch.from_numpy(ca), torch.from_numpy(cb), n_cand, state))
    np.testing.assert_array_equal(w.numpy(), jw)
    np.testing.assert_array_equal(h.numpy(), jh)
    np.testing.assert_array_equal(log.numpy(), np.stack([jma, jmb, jmf]))
    np.testing.assert_array_equal(deltas.numpy(), jd)
    assert int(state[0]) == int(jlast)
    assert (jma >= 0).any()
    if n_cand < 60:
        assert (jma[:n_do] < 0).any()  # the candidates ran out


def test_k14_drops_ids_past_the_histogram():
    """Neighbours whose ids are at or past V: JAX's scatter drops their
    updates, and so do K14 and its plain version."""
    _, words, freqs = _random_rows(3, n=100, w=9, ids=12)
    V = 8
    got, want = _k14(words, freqs, 1, 2, V - 1, V), _jax_k14(words, freqs, 1, 2, V - 1, V)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (words >= V).any() and got[2] > 0

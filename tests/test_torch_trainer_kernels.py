"""The device trainer's kernels K13-K16 (their plain versions, which the
wrappers run on CPU tensors) against the JAX package's jitted programs of
``parallel/trainer.py``, bit for bit: every quantity is int32, so the
comparison is exact (the kernels' integer atomics give the same sums in any
order; ``tests/test_torch_gpu.py`` holds them to these plain versions on
the card).

Inputs come from numpy seeds: random rows with tombstones, runs of
``a == b``, adjacent occurrences, rows of one token and of none, rows
with a and no b after it, rows wider than 32 slots, a late state of mostly
tombstones (``utils/corpus.py:merge_edge_rows``), ``new_id = V - 1``.  The block and
the window run through ``parallel/trainer.py:run_steps``, the trainer's own
step loop, against ``make_k_merge_steps`` and ``make_inl_window_steps`` on a
one-device mesh.
"""

import os
import re

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
from complexity_tokenizer_tpu_torch.ops import trainer_device
from complexity_tokenizer_tpu_torch.ops.trainer_device import (
    merge_step,
    pair_hist,
    pair_hist_plan,
)
from complexity_tokenizer_tpu_torch.parallel.trainer import run_steps
from complexity_tokenizer_tpu_torch.utils.corpus import merge_edge_rows, zipf_pair_rows


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


@pytest.mark.parametrize("v0", [58, 241, 242, 260])
def test_k13_zipf_keys_and_aliasing_match_make_initial_hist(v0):
    """K13's plain version against ``make_initial_hist`` at the side of the
    bench corpus's alphabet (58), at the last side whose histogram fits one
    block's shared memory (241) and the first past it (242), and at a
    byte-level alphabet's (260): rows of the trainer's shape with
    Zipf-skewed ids, and rows whose right id is at or past v0.  JAX's key
    ``l * v0 + r`` makes such an id add into line l + 1 (and drops a key at
    or past ``v0 * v0``), not a 2-D bound on each id."""
    _, words, freqs = _random_rows(v0, n=400, w=13, holes=0.25)
    words = zipf_pair_rows(words, v0, seed=v0)
    alias = np.full((4, 13), -1, np.int32)
    alias[0, :2] = (3, v0 + 5)  # adds into (4, 5)
    alias[1, :3] = (v0 - 1, v0 - 1, v0 + 2)  # (v0-1, v0-1), then a key past the histogram
    alias[2, :2] = (0, 2 * v0)  # adds into (2, 0)
    alias[3, :2] = (v0 - 1, v0 - 1)
    words = np.concatenate([words, alias])
    freqs = np.concatenate([freqs, np.array([11, 13, 17, 19], np.int32)])
    want = np.asarray(jax.jit(make_initial_hist(v0))(words, freqs))
    got = pair_hist(torch.from_numpy(words), torch.from_numpy(freqs), v0)
    assert got.dtype == torch.int32 and got.shape == (v0 * v0,)
    np.testing.assert_array_equal(got.numpy(), want)
    # the aliased keys landed where JAX puts them
    assert want[4 * v0 + 5] >= 11 and want[2 * v0] >= 17 and want[v0 * v0 - 1] >= 13 + 19
    # the Zipf curve: the hottest pair holds far more than its share
    assert want.max() > 20 * want.sum() / (v0 * v0)


@pytest.mark.parametrize("v0,branch,slices", [
    (58, 0, 1), (241, 0, 1), (242, 1, 2), (260, 1, 2), (340, 1, 2), (341, 1, 3), (681, 1, 8),
    (682, 2, 0), (1000, 2, 0),
])
def test_k13_plan_branch(v0, branch, slices):
    """K13's plan (mirrored in ``csrc/train.cu``): a block's histogram while
    ``v0 * v0`` int32 bins fit its 232,448 bytes (v0 <= 241), slices of
    it, up to 8 (v0 <= 681), global atomics past that; every slice within
    one block's shared memory."""
    plan = pair_hist_plan(48_968, 13, v0)
    assert (plan["branch"], plan["slices"]) == (branch, slices)
    if branch < 2:
        assert plan["slice_bins"] * 4 <= 232_448
        assert plan["slice_bins"] * slices >= v0 * v0
        assert plan["slice_bins"] * (slices - 1) < v0 * v0
        assert plan["groups"] == 132 // slices  # the classic rows fill the card


@pytest.mark.parametrize("N,W,sms,groups", [
    (48_968, 13, 132, 132), (48_968, 13, 114, 114), (100, 13, 132, 1), (5_000, 13, 132, 16),
    (0, 13, 132, 1),
])
def test_k13_plan_grid(N, W, sms, groups):
    """K13's groups at v0 = 58: a block an SM, fewer when the rows give
    fewer than a 128-slot step to each of a block's 32 warps, at least one."""
    assert pair_hist_plan(N, W, 58, sms)["groups"] == groups


@pytest.mark.parametrize("c_name,py_name", [
    ("kHistThreads", "_HIST_THREADS"), ("kHistStep", "_HIST_STEP"),
    ("kHistSmemBytes", "_HIST_SLICE_BINS"), ("kHistMaxSlices", "_HIST_MAX_SLICES"),
])
def test_k13_plan_constants_mirror_the_source(c_name, py_name):
    """The Python plan's constants are ``csrc/train.cu``'s (the card reads
    its own plan; ``tests/test_torch_gpu.py`` compares the two there)."""
    src = os.path.join(os.path.dirname(trainer_device.__file__), "..", "csrc", "train.cu")
    with open(src, encoding="utf-8") as f:
        value = int(re.search(rf"constexpr int {c_name} = (\d+);", f.read()).group(1))
    want = getattr(trainer_device, py_name)
    assert (value // 4 if c_name == "kHistSmemBytes" else value) == want


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


@pytest.mark.parametrize("case", range(10))
def test_k14_matches_make_merge_step_on_edge_rows(case):
    label, words, freqs, a, b, new = merge_edge_rows()[case]
    V = new + 1
    got, want = _k14(words, freqs, a, b, new, V), _jax_k14(words, freqs, a, b, new, V)
    np.testing.assert_array_equal(got[0], want[0], err_msg=label)
    np.testing.assert_array_equal(got[1], want[1], err_msg=label)  # entry for entry
    assert got[2] == want[2], label


@pytest.mark.parametrize("case", [0, 4, 6, 9])
def test_k14_zeroes_the_other_buffer_as_it_merges(case):
    """``zero`` (the per-merge route's two buffers taking turns): the merge
    adds JAX's delta and count of the one merge into zeroed buffers and
    zeroes the other buffer, stale before; a logged step that does nothing
    zeroes it too and changes nothing else; the route's turns give each
    merge JAX's delta."""
    label, words, freqs, a, b, new = merge_edge_rows()[case]
    V = new + 1
    want = _jax_k14(words, freqs, a, b, new, V)
    rng = np.random.RandomState(case)
    bufs = torch.zeros((2, 1 + 4 * V), dtype=torch.int32)
    bufs[1] = torch.from_numpy(rng.randint(-50, 50, size=1 + 4 * V).astype(np.int32))
    w = torch.from_numpy(words.copy())
    merge_step(w, torch.from_numpy(freqs), new, bufs[0, 1:].view(V, 4), bufs[0, :1], a=a, b=b,
               zero=bufs[1])
    np.testing.assert_array_equal(w.numpy(), want[0], err_msg=label)
    np.testing.assert_array_equal(bufs[0, 1:].view(V, 4).numpy(), want[1], err_msg=label)
    assert int(bufs[0, 0]) == want[2] and not bufs[1].any(), label
    bufs[0].fill_(7)
    ma = torch.full((2,), -1, dtype=torch.int32)
    merge_step(w, torch.from_numpy(freqs), new, bufs[1, 1:].view(V, 4), bufs[1, :1],
               log=(ma, ma.clone()), step=1, zero=bufs[0])
    np.testing.assert_array_equal(w.numpy(), want[0], err_msg=label)
    assert not bufs.any(), label
    # two merges in turns, as the per-merge route runs them
    w = torch.from_numpy(words.copy())
    for turn, (pa, pb) in enumerate(((a, b), (b, a))):
        nid = new - 1 + turn
        exp = _jax_k14(w.numpy().copy(), freqs, pa, pb, nid, V)
        cur, other = bufs[turn % 2], bufs[1 - turn % 2]
        merge_step(w, torch.from_numpy(freqs), nid, cur[1:].view(V, 4), cur[:1], a=pa, b=pb,
                   zero=other)
        np.testing.assert_array_equal(cur[1:].view(V, 4).numpy(), exp[1], err_msg=label)
        assert int(cur[0]) == exp[2] and not other.any(), label


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

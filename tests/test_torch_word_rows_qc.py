"""K22, the one-word-a-row merge fixpoint on the u16 cuckoo table
(``ops/merge.py:merge_word_rows_qc``), on the CPU: its dense plain version
``merge_word_rows_qc_plain`` and its ragged form (the wrapper on CPU
tensors, ``merge_word_rows_qc_ragged_plain``) against the JAX package's
``merge_word_rows_qc`` on the same words, exactly (ids and counts).  The
words are the test tokenizer's (``tests/helpers.py``) seeded from its byte
table, with tombstones inside words and symbol ids at and past 65,535,
which alias in the u32 key ``(a << 16) | b`` as they do in JAX."""

import numpy as np
import pytest

from helpers import SAMPLE_TEXT, conformance_corpus, trained_tokenizer_json

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from complexity_tokenizer_tpu.ops.merge import merge_word_rows_qc as jax_word_rows_qc  # noqa: E402
from complexity_tokenizer_tpu_torch.ops.hashtable import (  # noqa: E402
    _mix_hash2_np,
    _mix_hash_np,
    build_chd_table,
)
from complexity_tokenizer_tpu_torch.ops.merge import (  # noqa: E402
    WORD_LANES,
    merge_word_rows_qc,
    merge_word_rows_qc_plain,
    merge_word_rows_qc_ragged_plain,
    merge_word_rows_ragged_plain,
    word_tiles,
)
from complexity_tokenizer_tpu_torch.tokenizer import Tokenizer  # noqa: E402

# every dense case is padded to this many rows for JAX, so that one compile
# serves all
_JAX_ROWS = 256


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many ops on small tensors: with the test
    workers sharing the machine, torch's intra-op threads only wait on each
    other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tables():
    """The test tokenizer's byte table, merges and cuckoo table (as built,
    u32) and its CHD table."""
    tok = Tokenizer.from_str(trained_tokenizer_json())
    dt = tok.device_tables()
    assert dt.qc is not None
    chd = build_chd_table(tok.bpe.merge_ranks, tok.bpe.merge_ops)
    return dt.byte_token_table, tok.bpe.merge_ranks, dt.qc, chd


def _corpus_words(byte_table) -> list[list[int]]:
    """The test texts' space-led words as seed ids (OOV bytes dropped), at
    most 128 symbols each."""
    out = []
    for text in conformance_corpus() + [SAMPLE_TEXT]:
        for k, w in enumerate(text.encode("utf-8").split(b" ")):
            ids = [int(byte_table[c]) for c in (b" " + w if k else w)]
            ids = [i for i in ids if i >= 0][:WORD_LANES]
            if ids:
                out.append(ids)
    return out


def _alias_words(pairs, qc) -> list[list[int]]:
    """For each pair (a, b) of the table, [a + 65536 k, b] with the least
    k >= 1 whose hash lands on the slot that holds (a, b): a pair that JAX's
    u32 key turns into a hit, and merges."""
    mask = qc.size - 1
    k = np.arange(1, 32768, dtype=np.int64)
    out = []
    for a, b in pairs:
        key = (a << 16) | b
        cand = a + 65536 * k
        p1 = int(_mix_hash_np(np.array([a]), np.array([b]), mask)[0])
        if int(qc.t1[p1, 0]) == key:
            hit = _mix_hash_np(cand, np.full_like(cand, b), mask) == p1
        else:
            hit = _mix_hash2_np(cand, np.full_like(cand, b), mask) == \
                int(_mix_hash2_np(np.array([a]), np.array([b]), mask)[0])
        out.append([int(cand[np.argmax(hit)])] if hit.any() else [])
    return out


def _words(case: str, byte_table, merge_ranks, rng, qc=None) -> list[list[int]]:
    words = _corpus_words(byte_table)
    if case == "corpus words":
        return words
    if case == "tombstones mid-row":
        out = []
        for w in words[:200]:
            w = list(w)
            if len(w) > 2:
                for _ in range(rng.randint(1, 3)):
                    w[rng.randint(1, len(w) - 1)] = -1
            out.append(w)
        return out
    if case == "runs of one symbol":
        same = sorted(a for (a, b) in merge_ranks if a == b)
        return [[same[k % len(same)]] * n for k, n in enumerate(range(2, 60))]
    # ids at and past 65,535: a left id past u16 packs to its low 16 bits'
    # key, a hit where it hashes to that pair's slot (_alias_words); a right
    # id past u16 ORs its high bits into the key; (65535, 65535) and
    # (131071, 65535) pack to the empty-slot key 0xFFFFFFFF and never hit
    pairs = sorted(merge_ranks, key=merge_ranks.get)
    out = [w + [b] for w, (_a, b) in zip(_alias_words(pairs[:40], qc), pairs)]
    for k, (a, b) in enumerate(pairs[:120]):
        out.append([a + 65536 * (1 + k % 3), b])
        out.append([a, b + 65536])
        w = list(words[k])
        w[rng.randint(len(w))] = int(rng.choice([65535, 65536, 131071, 2**31 - 1, a + 65536]))
        out.append(w)
    out += [[65535, 65535], [131071, 65535], [65535] * 5, [131071, 65535, 65535]]
    return out


CASES = ["corpus words", "tombstones mid-row", "runs of one symbol", "ids past u16"]


def _dense(words, W: int = WORD_LANES) -> np.ndarray:
    rows = np.full((len(words), W), -1, dtype=np.int32)
    for i, w in enumerate(words):
        rows[i, : len(w)] = w
    return rows


def _jax(rows: np.ndarray, qc):
    """JAX's merge_word_rows_qc over the rows, in chunks of _JAX_ROWS."""
    toks, counts = [], []
    t1, t2 = jnp.asarray(qc.t1), jnp.asarray(qc.t2)
    for c0 in range(0, len(rows), _JAX_ROWS):
        chunk = rows[c0 : c0 + _JAX_ROWS]
        pad = np.full((_JAX_ROWS, rows.shape[1]), -1, dtype=np.int32)
        pad[: len(chunk)] = chunk
        t, c = jax_word_rows_qc(jnp.asarray(pad), t1, t2, qc.size)
        toks.append(np.asarray(t)[: len(chunk)])
        counts.append(np.asarray(c)[: len(chunk)])
    return np.concatenate(toks), np.concatenate(counts)


def _qc_args(qc):
    return (torch.from_numpy(qc.t1.view(np.int32)), torch.from_numpy(qc.t2.view(np.int32)),
            qc.size)


@pytest.mark.parametrize("case", CASES)
def test_dense_plain_equals_jax(tables, case):
    byte_table, merge_ranks, qc, _chd = tables
    words = _words(case, byte_table, merge_ranks, np.random.RandomState(len(case)), qc)
    rows = _dense(words)
    exp_t, exp_c = _jax(rows, qc)
    got_t, got_c = merge_word_rows_qc_plain(torch.from_numpy(rows), *_qc_args(qc))
    np.testing.assert_array_equal(got_t.numpy(), exp_t)
    np.testing.assert_array_equal(got_c.numpy(), exp_c)
    assert (exp_c < (rows >= 0).sum(1)).any()  # the case merges something


@pytest.mark.parametrize("case", CASES)
def test_ragged_wrapper_on_cpu_equals_jax(tables, case):
    """The wrapper on CPU tensors (the ragged plain version): the words end
    to end with their offsets, the JAX fixpoint on them scattered into
    rows; no launch is counted."""
    byte_table, merge_ranks, qc, _chd = tables
    words = _words(case, byte_table, merge_ranks, np.random.RandomState(len(case)), qc)
    exp_t, exp_c = _jax(_dense(words), qc)
    offs = np.concatenate([[0], np.cumsum([len(w) for w in words])]).astype(np.int32)
    syms = np.concatenate([np.asarray(w, np.int32) for w in words])
    before = merge_word_rows_qc.launches
    got_t, got_c = merge_word_rows_qc(
        torch.from_numpy(syms), torch.from_numpy(offs), torch.from_numpy(word_tiles(offs)),
        *_qc_args(qc))
    assert merge_word_rows_qc.launches == before
    exp_flat = np.concatenate([exp_t[i, : len(w)] for i, w in enumerate(words)])
    np.testing.assert_array_equal(got_t.numpy(), exp_flat)
    np.testing.assert_array_equal(got_c.numpy(), exp_c)


def test_ids_past_u16_alias_as_in_jax(tables):
    """A left id past 65,535 hits its low 16 bits' pair, and the pairs that
    pack to the empty-slot key never hit: the JAX key, not a fixed one."""
    byte_table, merge_ranks, qc, _chd = tables
    pairs = sorted(merge_ranks, key=merge_ranks.get)[:40]
    alias = [w + [b] for w, (_a, b) in zip(_alias_words(pairs, qc), pairs) if w]
    assert len(alias) >= 20
    rows = _dense(alias + [[65535, 65535], [131071, 65535]])
    got_t, got_c = merge_word_rows_qc_plain(torch.from_numpy(rows), *_qc_args(qc))
    exp_t, exp_c = _jax(rows, qc)
    np.testing.assert_array_equal(got_t.numpy(), exp_t)
    np.testing.assert_array_equal(got_c.numpy(), exp_c)
    # every aliased pair merged into its pair's product; the sentinel did not
    assert got_c[: len(alias)].tolist() == [1] * len(alias)
    assert got_c[len(alias):].tolist() == [2, 2]


def test_ragged_qc_equals_ragged_chd(tables):
    """On ids below 65,535 the cuckoo and the CHD tables hold the same
    pairs: K22's plain version equals K9's on the corpus words."""
    byte_table, _merge_ranks, qc, chd = tables
    words = _corpus_words(byte_table)
    offs = torch.from_numpy(
        np.concatenate([[0], np.cumsum([len(w) for w in words])]).astype(np.int32))
    syms = torch.from_numpy(np.concatenate([np.asarray(w, np.int32) for w in words]))
    got = merge_word_rows_qc_ragged_plain(syms, offs, *_qc_args(qc))
    exp = merge_word_rows_ragged_plain(syms, offs, torch.from_numpy(chd.disp),
                                       torch.from_numpy(chd.rows), chd.size, chd.n_buckets)
    for g, e in zip(got, exp):
        assert torch.equal(g, e)


def test_wrapper_refuses_other_devices():
    z = torch.zeros(4, dtype=torch.int32, device="meta")
    t = torch.zeros((8, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        merge_word_rows_qc(z, z, z, t, t, 8)

"""A Python model of K2's per-word walk (``csrc/kernels.cu``), checked
exactly against the JAX ``merge_words_qc`` and the port's plain
``merge_fixpoint_qc_plain``.

The CUDA kernel cannot run on the CPU, so this model repeats its procedure
step for step: the row's boundary list, words over ``WARP_WORD_BYTES``
bytes on the warp path and the rest on the thread path, the compacted
alive list, the cached probes and which of them a step probes again, the
greedy apply of every non-overlapping occurrence of the word's best pair,
and the warp path's ballot masks, run starts and parity carry across
32-entry chunks.  The probe is the kernel's: two u32 hashes into the
cuckoo tables.  The order in which the kernel's threads take words does
not change a row, since words never interact.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from helpers import SAMPLE_TEXT, conformance_corpus, trained_tokenizer_json

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from complexity_tokenizer_tpu.ops import merge as JM  # noqa: E402
from complexity_tokenizer_tpu_torch.core.bpe import BpeTokenizer  # noqa: E402
from complexity_tokenizer_tpu_torch.ops import merge as M  # noqa: E402
from complexity_tokenizer_tpu_torch.ops.presplit import presplit  # noqa: E402
from complexity_tokenizer_tpu_torch.ops.seed import seed_tokens_plain  # noqa: E402
from complexity_tokenizer_tpu_torch.ops.tables import build_device_tables  # noqa: E402
from complexity_tokenizer_tpu_torch.tokenizer import Tokenizer  # noqa: E402
from complexity_tokenizer_tpu_torch.utils.unicode_tables import gpt2_class_table  # noqa: E402

M32 = 0xFFFFFFFF
MISS = 0xFFFFFFFF
FLAG = 0x8000
POS = 0x7FFF
WARP_WORD_BYTES = 32  # kWarpWordBytes of csrc/kernels.cu


def _mix_hash(a, b):
    h = ((a * 0x85EBCA6B) & M32) ^ ((b * 0xC2B2AE35) & M32)
    h ^= h >> 15
    h = (h * 0x27D4EB2F) & M32
    return h ^ (h >> 13)


def _mix_hash2(a, b):
    g = ((a * 0x9E3779B1) & M32) ^ ((b * 0x7FEB352D) & M32)
    g ^= g >> 16
    return (g * 0x45D9F3B) & M32


class KernelModel:
    """K2's procedure on one ``[B, L]`` batch, with a count of probes."""

    def __init__(self, qc, warp_word_bytes=WARP_WORD_BYTES):
        self.t1 = qc.t1.astype(np.uint64).tolist()
        self.t2 = qc.t2.astype(np.uint64).tolist()
        self.mask = qc.size - 1
        self.warp_word_bytes = warp_word_bytes
        self.probes = 0

    def probe(self, has_pair, a, b):
        key = ((a << 16) | b) & M32 if has_pair else MISS
        if key == MISS:
            return MISS
        self.probes += 1
        r1 = self.t1[_mix_hash(a, b) & self.mask]
        r2 = self.t2[_mix_hash2(a, b) & self.mask]
        if r1[0] == key:
            return r1[1]
        if r2[0] == key:
            return r2[1]
        return MISS

    # --- one thread per word ---------------------------------------------

    def thread_word(self, t, rm, aux, p, e):
        """One pass per step: greedy pick on the cached (old) pairs, compaction,
        a probe of each kept entry's pair once its right neighbour is final
        and the pair changed, and the next step's minimum."""
        m, left, best = 0, -1, MISS
        for q in range(p, e):
            if t[q] < 0:
                continue
            if left >= 0:
                rm[left] = self.probe(True, t[left], t[q])
                best = min(best, rm[left])
            aux[p + m] = q
            m += 1
            left = q
        if left >= 0:
            rm[left] = MISS
        while best != MISS:
            nxt, out, lpos, lchanged, consumed = MISS, 0, -1, False, False
            for k in range(m):
                pos = aux[p + k]
                if consumed:
                    t[pos] = -1
                    consumed = False
                    continue
                v = rm[pos]
                taken = v == best
                if taken:
                    t[pos] = v & 0xFFFF
                    consumed = True
                if lpos >= 0:
                    if lchanged or taken:
                        rm[lpos] = self.probe(True, t[lpos], t[pos])
                    nxt = min(nxt, rm[lpos])
                aux[p + out] = pos
                out += 1
                lpos, lchanged = pos, taken
            if lchanged:
                rm[lpos] = MISS
            m, best = out, nxt

    # --- one warp per word -------------------------------------------------

    def warp_probe_pass(self, t, rm, aux, p, m):
        mn = MISS
        for base in range(0, m, 32):
            lanes = range(base, min(base + 32, m))
            a = {k: aux[p + k] for k in lanes}  # every lane reads, then writes
            an = {k: aux[p + k + 1] for k in lanes if k + 1 < m}
            # the lanes' probes of one chunk go out together
            for k in lanes:
                pos = a[k] & POS
                if a[k] & FLAG:
                    has_pair = k + 1 < m
                    v = self.probe(has_pair, t[pos], t[an[k] & POS] if has_pair else 0)
                    rm[pos] = v
                    aux[p + k] = pos
                else:
                    v = rm[pos]
                mn = min(mn, v)
        return mn

    @staticmethod
    def chunk_pick(isb: int, carry: int) -> int:
        """The kernel's greedy pick in one chunk: from the best-pair ballot
        ``isb`` and the previous chunk's last pick ``carry``, the mask of
        picked entries (lane by lane, as each lane computes it)."""
        sel = 0
        for lane in range(32):
            below = ~isb & ((1 << lane) - 1) & M32
            run_start = below.bit_length() if below else 0  # 32 - __clz
            parity = lane - run_start + (carry if run_start == 0 else 0)
            if (isb >> lane) & 1 and not parity & 1:
                sel |= 1 << lane
        return sel

    def warp_apply(self, t, rm, aux, p, m, best):
        out, carry = 0, 0
        for base in range(0, m, 32):
            n = min(32, m - base)
            pos = [aux[p + base + i] for i in range(n)]
            vals = [rm[x] for x in pos]
            isb = sum(1 << i for i in range(n) if vals[i] == best)
            S = self.chunk_pick(isb, carry)
            consumed = ((S << 1) | carry) & M32
            K = sum(1 << i for i in range(n) if not (consumed >> i) & 1)
            for i in range(n):
                sel = (S >> i) & 1
                if sel:
                    t[pos[i]] = vals[i] & 0xFFFF
                if (consumed >> i) & 1:
                    t[pos[i]] = -1
                if (K >> i) & 1:
                    nidx = out + bin(K & ((1 << i) - 1)).count("1")
                    again = sel or (i < 31 and (S >> (i + 1)) & 1)
                    aux[p + nidx] = pos[i] | (FLAG if again else 0)
            if S & 1 and out > 0:
                aux[p + out - 1] |= FLAG
            out += bin(K).count("1")
            carry = S >> 31
        return out

    def warp_word(self, t, rm, aux, p, e):
        m = 0
        for q in range(p, e):
            if t[q] >= 0:
                aux[p + m] = q | FLAG
                m += 1
        best = self.warp_probe_pass(t, rm, aux, p, m)
        while best != MISS:
            m = self.warp_apply(t, rm, aux, p, m, best)
            best = self.warp_probe_pass(t, rm, aux, p, m)

    # --- the row's block -----------------------------------------------------

    def row(self, tokens, wid):
        L = len(tokens)
        t = list(tokens)
        rm = [0] * L
        aux = [0] * L
        bnd = [q | (FLAG if wid[q] < 0 else 0) for q in range(L) if q == 0 or wid[q] != wid[q - 1]]
        bnd.append(L)
        words = [
            (bnd[k], bnd[k + 1] & POS) for k in range(len(bnd) - 1) if not bnd[k] & FLAG
        ]
        for s, e in words:  # the warps' long words first, then the rest
            if e - s > self.warp_word_bytes:
                self.warp_word(t, rm, aux, s, e)
        for s, e in words:
            if e - s <= self.warp_word_bytes:
                self.thread_word(t, rm, aux, s, e)
        return t

    def __call__(self, tokens: np.ndarray, wid: np.ndarray):
        out = np.array(
            [self.row(tr.tolist(), wr.tolist()) for tr, wr in zip(tokens, wid)], np.int32
        ).reshape(tokens.shape)
        return out, (out >= 0).sum(axis=1).astype(np.int32)


def _reference(tokens: np.ndarray, wid: np.ndarray, qc):
    """(JAX merge_words_qc, plain merge_fixpoint_qc_plain), each as numpy."""
    jt, jc = JM.merge_words_qc(
        jnp.asarray(tokens), jnp.asarray(wid), jnp.asarray(qc.t1), jnp.asarray(qc.t2), qc.size
    )
    pt, pc = M.merge_fixpoint_qc_plain(
        torch.from_numpy(tokens), torch.from_numpy(wid),
        torch.from_numpy(qc.t1.view(np.int32)), torch.from_numpy(qc.t2.view(np.int32)), qc.size,
    )
    return (np.asarray(jt), np.asarray(jc)), (pt.numpy(), pc.numpy())


def _check(tokens, wid, qc, warp_word_bytes=WARP_WORD_BYTES):
    """The model equals JAX and the plain version, and probes each initial
    pair once and at most two pairs per merge."""
    model = KernelModel(qc, warp_word_bytes)
    got_t, got_c = model(tokens, wid)
    (jt, jc), (pt, pc) = _reference(tokens, wid, qc)
    np.testing.assert_array_equal(got_t, jt)
    np.testing.assert_array_equal(got_c, jc)
    np.testing.assert_array_equal(got_t, pt)
    np.testing.assert_array_equal(got_c, pc)
    alive = tokens >= 0
    pairs = 0
    for wr, ar in zip(wid, alive):
        w = wr[ar]
        pairs += int(((w[1:] == w[:-1]) & (w[1:] >= 0)).sum())
    merges = int(alive.sum() - got_c.sum())
    assert model.probes <= pairs + 2 * merges
    return got_t, got_c


@pytest.fixture(scope="module")
def fixture_tables():
    tok = Tokenizer.from_str(trained_tokenizer_json())
    return build_device_tables(tok.bpe)


def _seeded_rows(texts, L, tables):
    B = len(texts)
    arr = np.zeros((B, L), np.uint8)
    lens = np.zeros(B, np.int32)
    for i, t in enumerate(texts):
        d = t.encode("utf-8")[:L]
        arr[i, : len(d)] = np.frombuffer(d, np.uint8)
        lens[i] = len(d)
    arr_t, lens_t = torch.from_numpy(arr), torch.from_numpy(lens)
    _, wid, _ = presplit(arr_t, lens_t, torch.from_numpy(gpt2_class_table()))
    tokens = seed_tokens_plain(arr_t, lens_t, torch.from_numpy(tables.byte_token_table))
    return tokens.numpy(), wid.numpy()


@pytest.mark.parametrize("L", [128, 512])
def test_walk_matches_jax_on_conformance_corpus(fixture_tables, L):
    texts = (conformance_corpus() + [SAMPLE_TEXT.replace("\n", " ")] * 2)[:16]
    tokens, wid = _seeded_rows(texts, L, fixture_tables)
    _check(tokens, wid, fixture_tables.qc)


@pytest.mark.parametrize("warp_word_bytes", [0, 4, 1 << 20])
def test_walk_paths_each_match_jax(fixture_tables, warp_word_bytes):
    """Every word on the warp path, a mix, and every word on the thread
    path: each gives the same rows."""
    texts = (conformance_corpus() + [SAMPLE_TEXT.replace("\n", " ")] * 2)[:16]
    tokens, wid = _seeded_rows(texts, 512, fixture_tables)
    _check(tokens, wid, fixture_tables.qc, warp_word_bytes)


def _run_bpe():
    """A toy well-formed table with deep chains over runs of ``a``."""
    vocab = {"a": 0, "b": 1, "c": 2, "aa": 3, "aaa": 4, "aaaa": 5, "ab": 6, "aab": 7,
             "aaaaaaaa": 8, "ba": 9, "bab": 10}
    merges = [("a", "a"), ("aa", "a"), ("aa", "aa"), ("a", "b"), ("aa", "b"),
              ("aaaa", "aaaa"), ("b", "a"), ("ba", "b")]
    bpe = BpeTokenizer(vocab, merges)
    tb = build_device_tables(bpe)
    assert tb.well_formed and tb.qc is not None
    return bpe, tb


def _rows_of_words(words_per_row, L, bpe, tombstones=()):
    """[B, L] tokens and word ids for rows of words over the toy alphabet;
    ``tombstones`` lists (row, position) slots set to -1 inside words."""
    B = len(words_per_row)
    tokens = np.full((B, L), -1, np.int32)
    wid = np.full((B, L), -1, np.int32)
    for r, words in enumerate(words_per_row):
        pos = 0
        for w, s in enumerate(words):
            assert pos + len(s) <= L
            tokens[r, pos : pos + len(s)] = [bpe.vocab[c] for c in s]
            wid[r, pos : pos + len(s)] = w
            pos += len(s)
    for r, q in tombstones:
        tokens[r, q] = -1
    return tokens, wid


def test_walk_on_long_runs_across_chunk_edges():
    """Words over the warp threshold whose runs of best pairs cross the
    32-entry chunk edges at both parities, with and without a taken entry
    carried into the next chunk."""
    bpe, tb = _run_bpe()
    rows = [
        ["a" * n] for n in (31, 32, 33, 34, 63, 64, 65, 66, 97, 130)
    ] + [
        ["b" * 31 + "a" * 40],
        ["c" * 30 + "a" * 70 + "b"],
        ["ab" * 40, "a" * 5],
        ["ba" * 33 + "b", "aab" * 20],
        ["c" + "a" * 31 + "c" + "a" * 33],
        ["a" * 200],
    ]
    tokens, wid = _rows_of_words(rows, 256, bpe, tombstones=[(12, 40), (12, 41), (13, 7)])
    got_t, _ = _check(tokens, wid, tb.qc)
    for r in (0, 5, 9, 15):  # no tombstones: the oracle's ids, in order
        ids = got_t[r][got_t[r] >= 0].tolist()
        assert ids == [i for w in rows[r] for i in bpe.encode(w)]


@pytest.mark.parametrize("carry", [0, 1])
def test_chunk_pick_is_the_serial_greedy(carry):
    """The mask arithmetic equals ``sel[k] = best[k] and not sel[k-1]``."""
    rng = np.random.RandomState(carry)
    masks = [0, M32, 1, 1 << 31, 0x55555555, 0xAAAAAAAA] + rng.randint(0, 1 << 32, 200, dtype=np.int64).tolist()
    for isb in masks:
        prev, want = carry, 0
        for lane in range(32):
            s = (isb >> lane) & 1 and not prev
            want |= int(s) << lane
            prev = s
        assert KernelModel.chunk_pick(isb, carry) == want


_WORD = st.lists(
    st.tuples(st.sampled_from("abc"), st.integers(1, 40)), min_size=1, max_size=6
).map(lambda runs: "".join(ch * n for ch, n in runs))


@settings(max_examples=40, deadline=None, database=None)
@given(
    rows=st.lists(st.lists(_WORD, min_size=1, max_size=4), min_size=4, max_size=4),
    holes=st.lists(st.tuples(st.integers(0, 3), st.integers(0, 511)), max_size=12),
)
def test_walk_matches_jax_on_random_runs(rows, holes):
    """Words built from runs of one to 40 equal tokens, some slots inside
    them tombstoned: the model, JAX and the plain version agree."""
    bpe, tb = _run_bpe()
    L = 512
    trimmed = []
    for ws in rows:
        out, n = [], 0
        for w in ws:
            if n + len(w) <= L:
                out.append(w)
                n += len(w)
        trimmed.append(out)
    tokens, wid = _rows_of_words(trimmed, L, bpe, tombstones=holes)
    _check(tokens, wid, tb.qc)

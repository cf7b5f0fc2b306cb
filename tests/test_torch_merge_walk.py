"""Python models of the merge walks of K2 and K5 (``csrc/kernels.cu``),
checked exactly against the JAX ``merge_words_qc`` / ``merge_words`` and
the port's plain ``merge_fixpoint_qc_plain`` / ``merge_fixpoint_chd_plain``.

The CUDA kernel cannot run on the CPU, so each model repeats its procedure
step for step: the row's boundary list, words over the warp threshold on
the warp path and the rest on the thread path, the compacted alive list,
the cached probes and which of them a step probes again, the greedy apply
of every non-overlapping occurrence of the word's best pair, and the warp
path's ballot masks, run starts and parity carry across 32-entry chunks.

K2 (:class:`KernelModel`) probes the cuckoo tables pair by pair as its
walk reaches them.  K5 (:class:`ChdKernelModel`) probes the CHD table in
rounds: one first round over the whole row (the pairs it leaves, past a
run of more than ``CHD_REACH`` tombstones, are probed by their word's
walk), then per step the pairs the step changed (a thread word's queue
of ``CHD_QUEUE``, a warp word's marked entries gathered across all chunks
into 32 lane slots), and it takes no barrier between long and short
words.  After every step it asserts that
the cached entry of each alive position equals a fresh probe of its pair,
so a pair missing from a re-probe round fails here.  The order in which
the kernel's threads take words does not change a row, since words never
interact; the K5 model can take them in a random order to show it.
"""

import os

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
from complexity_tokenizer_tpu_torch.ops.hashtable import build_chd_table  # noqa: E402
from complexity_tokenizer_tpu_torch.ops.presplit import presplit  # noqa: E402
from complexity_tokenizer_tpu_torch.ops.seed import seed_tokens_plain  # noqa: E402
from complexity_tokenizer_tpu_torch.ops.tables import build_device_tables  # noqa: E402
from complexity_tokenizer_tpu_torch.tokenizer import Tokenizer  # noqa: E402
from complexity_tokenizer_tpu_torch.utils.corpus import RUN_BREAKS, run_rows, zipf_corpus  # noqa: E402
from complexity_tokenizer_tpu_torch.utils.unicode_tables import gpt2_class_table  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many ops on small tensors: with the test
    workers sharing the machine, torch's intra-op threads only wait on each
    other (one thread runs these tests many times faster under load)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

M32 = 0xFFFFFFFF
MISS = 0xFFFFFFFF
FLAG = 0x8000
POS = 0x7FFF
WARP_WORD_BYTES = 32  # kWarpWordBytes of csrc/kernels.cu
MISS64 = (1 << 64) - 1  # K5's cached miss (ChdProbe::kMissEntry)
# K5's launch constants in csrc/kernels.cu
CHD_WARP_WORD_BYTES = 32  # kChdWarpWordBytes
CHD_QUEUE = 4  # kChdQueue
CHD_REACH = 8  # kChdReach
PENDING = (1 << 64) - 2  # ChdProbe::kPendingEntry
BENCH_100K = os.path.join(
    os.path.dirname(__file__), "..", ".cache", "bench_tokenizer_100k.json"
)


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

    @staticmethod
    def key(v):
        """The 32-bit key whose minimum picks a word's best pair."""
        return v

    @staticmethod
    def minted(v):
        return v & 0xFFFF

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
            isb = sum(1 << i for i in range(n) if self.key(vals[i]) == best)
            S = self.chunk_pick(isb, carry)
            consumed = ((S << 1) | carry) & M32
            K = sum(1 << i for i in range(n) if not (consumed >> i) & 1)
            for i in range(n):
                sel = (S >> i) & 1
                if sel:
                    t[pos[i]] = self.minted(vals[i])
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


def nth_set_bit(x: int, n: int) -> int:
    """The kernel's ``nth_set_bit``: the n-th set bit (from 0) of x, by
    halving with popcounts."""
    pos = 0
    s = 16
    while s:
        c = bin(x & ((1 << s) - 1)).count("1")
        if n >= c:
            n -= c
            x >>= s
            pos += s
        s >>= 1
    return pos


class ChdKernelModel(KernelModel):
    """K5's procedure on one ``[B, L]`` batch, with counts of probes and of
    probe rounds.  ``shuffle`` (a ``numpy`` RandomState) takes each row's
    words in a random order: the kernel sets no barrier between its long
    and short words."""

    def __init__(self, chd, warp_word_bytes=CHD_WARP_WORD_BYTES, queue=CHD_QUEUE,
                 shuffle=None, reach=CHD_REACH):
        self.disp = chd.disp.tolist()
        self.rows = chd.rows.tolist()
        self.size_mask = chd.size - 1
        self.bucket_mask = chd.n_buckets - 1
        self.warp_word_bytes = warp_word_bytes
        self.queue = queue
        self.shuffle = shuffle
        self.reach = reach
        self.pending = 0  # positions the first round left to their walks
        self.probes = 0
        self.rounds = []  # the size of each probe round after the first

    @staticmethod
    def key(v):
        return v >> 32

    @staticmethod
    def minted(v):
        return v & M32

    def fresh(self, a, b):
        """ChdProbe::probe: the displacement, then the row."""
        d = self.disp[_mix_hash(a, b) & self.bucket_mask]
        r = self.rows[(_mix_hash2(a, b) + d) & self.size_mask]
        if r[0] != a or r[1] != b:
            return MISS64
        return (r[2] << 32) | (r[3] & M32)

    def probe_round(self, pairs):
        """One round: ``pairs`` is [(a, b)]; every probe issued together."""
        self.probes += len(pairs)
        return [self.fresh(a, b) for a, b in pairs]

    def check_cache(self, t, rm, aux, p, m):
        """Every alive entry caches a fresh probe of its pair, the last a miss."""
        for k in range(m):
            pos = aux[p + k] & POS
            want = self.fresh(t[pos], t[aux[p + k + 1] & POS]) if k + 1 < m else MISS64
            assert rm[pos] == want, (pos, rm[pos], want)

    # --- the row's first round -------------------------------------------

    def first_round(self, t, rm, flags):
        """Each alive position of a word and the next alive one of the same
        word: one round over the whole row; the last alive one a miss.  The
        search stops after ``reach`` tombstones: the position is pending,
        and its word's walk probes it."""
        L = len(t)
        lefts, pairs = [], []
        for i in range(L):
            if t[i] < 0 or flags[i] & 2:
                continue
            q = i + 1
            reach = min(L, i + 1 + self.reach)
            while q < reach and not flags[q] & 1 and t[q] < 0:
                q += 1
            if q == L or flags[q] & 1:
                rm[i] = MISS64
            elif t[q] < 0:
                rm[i] = PENDING
                self.pending += 1
            else:
                lefts.append(i)
                pairs.append((t[i], t[q]))
        for i, v in zip(lefts, self.probe_round(pairs)):
            rm[i] = v

    # --- one thread per word ---------------------------------------------

    def flush(self, t, rm, q):
        vals = self.probe_round([(t[lp], t[rp]) for lp, rp in q])
        self.rounds.append(len(q))
        for (lp, _), v in zip(q, vals):
            rm[lp] = v
        return min((self.key(v) for v in vals), default=MISS)

    def thread_word(self, t, rm, aux, p, e):
        m, best, left = 0, MISS, -1
        for q in range(p, e):
            if t[q] >= 0:
                if left >= 0 and rm[left] == PENDING:  # a pair the first round left
                    best = min(best, self.flush(t, rm, [(left, q)]))
                aux[p + m] = q
                m += 1
                best = min(best, self.key(rm[q]))
                left = q
        if left >= 0 and rm[left] == PENDING:
            rm[left] = MISS64
        self.check_cache(t, rm, aux, p, m)
        while best != MISS:
            nxt, out, lpos, lchanged, consumed, queue = MISS, 0, -1, False, False, []
            for k in range(m):
                pos = aux[p + k]
                if consumed:
                    t[pos] = -1
                    consumed = False
                    continue
                v = rm[pos]
                taken = self.key(v) == best
                if taken:
                    t[pos] = self.minted(v)
                    consumed = True
                if lpos >= 0:
                    if lchanged or taken:
                        queue.append((lpos, pos))
                        if len(queue) == self.queue:
                            nxt = min(nxt, self.flush(t, rm, queue))
                            queue = []
                    else:
                        nxt = min(nxt, self.key(rm[lpos]))
                aux[p + out] = pos
                out += 1
                lpos, lchanged = pos, taken
            if lchanged:
                rm[lpos] = MISS64
            if queue:
                nxt = min(nxt, self.flush(t, rm, queue))
            m, best = out, nxt
            self.check_cache(t, rm, aux, p, m)

    # --- one warp per word -------------------------------------------------

    def warp_probe_pass(self, t, rm, aux, p, m):
        """warp_probe_chd: the marked entries of all chunks gathered into one
        slot a lane, in order, a round of 32 probes when the slots are full
        and one at the end."""
        mn, cnt, slots = MISS, 0, [None] * 32

        def probe_slots(lanes):
            rnd = [slots[ln] for ln in lanes]
            real = [(lp, rp) for lp, rp in rnd if rp is not None]
            vals = iter(self.probe_round([(t[lp], t[rp]) for lp, rp in real]))
            self.rounds.append(len(rnd))
            out = MISS
            for lp, rp in rnd:
                rm[lp] = next(vals) if rp is not None else MISS64
                out = min(out, self.key(rm[lp]))
            return out

        for base in range(0, m, 32):
            lanes = range(base, min(base + 32, m))
            a = {k: aux[p + k] for k in lanes}  # every lane reads, then writes
            right = {k: (aux[p + k + 1] & POS if k + 1 < m else None) for k in lanes}
            F = 0
            for k in lanes:
                if a[k] & FLAG:
                    F |= 1 << (k - base)
                else:
                    mn = min(mn, self.key(rm[a[k] & POS]))
            n = bin(F).count("1")

            def pair(src):
                k = base + src
                return (a[k] & POS, right[k])

            for lane in range(32):  # lanes cnt.. take the chunk's marked entries
                j = lane - cnt
                if 0 <= j < n:
                    slots[lane] = pair(nth_set_bit(F, j))
            for k in lanes:
                aux[p + k] = a[k] & POS
            if cnt + n >= 32:
                mn = min(mn, probe_slots(range(32)))
                used = 32 - cnt
                for lane in range(32):
                    if lane + used < n:
                        slots[lane] = pair(nth_set_bit(F, lane + used))
                cnt = n - used
            else:
                cnt += n
        if cnt:
            mn = min(mn, probe_slots(range(cnt)))
        self.check_cache(t, rm, aux, p, m)
        return mn

    def warp_word(self, t, rm, aux, p, e):
        m, mn = 0, MISS
        for q in range(p, e):
            if t[q] >= 0:
                aux[p + m] = q | (FLAG if rm[q] == PENDING else 0)
                m += 1
                mn = min(mn, self.key(rm[q]))
        if any(aux[p + k] & FLAG for k in range(m)):  # the pairs the first round left
            mn = self.warp_probe_pass(t, rm, aux, p, m)
        self.check_cache(t, rm, aux, p, m)
        best = mn
        while best != MISS:
            m = self.warp_apply(t, rm, aux, p, m, best)
            best = self.warp_probe_pass(t, rm, aux, p, m)

    # --- the row's block -----------------------------------------------------

    def row(self, tokens, wid):
        L = len(tokens)
        t = list(tokens)
        rm = [0] * L
        # aux holds the flags (1: the word id changes, 2: word id -1) until
        # the walks take it over
        flags = [(1 if q == 0 or wid[q] != wid[q - 1] else 0) | (2 if wid[q] < 0 else 0)
                 for q in range(L)]
        self.first_round(t, rm, flags)
        bnd = [q | (FLAG if flags[q] & 2 else 0) for q in range(L) if flags[q] & 1]
        bnd.append(L)
        words = [(bnd[k], bnd[k + 1] & POS) for k in range(len(bnd) - 1)
                 if not bnd[k] & FLAG and (bnd[k + 1] & POS) - bnd[k] > 1]
        # the counting sort's order: long words, then the short ones longest first
        words.sort(key=lambda w: (w[1] - w[0] <= self.warp_word_bytes, w[0] - w[1]))
        if self.shuffle is not None:
            words = [words[i] for i in self.shuffle.permutation(len(words))]
        aux = [0] * L
        for s, e in words:
            if e - s > self.warp_word_bytes:
                self.warp_word(t, rm, aux, s, e)
            else:
                self.thread_word(t, rm, aux, s, e)
        return t


def _reference(tokens: np.ndarray, wid: np.ndarray, table):
    """(JAX fixpoint, plain fixpoint), each as numpy: ``merge_words_qc`` and
    ``merge_fixpoint_qc_plain`` on a cuckoo table, ``merge_words`` and
    ``merge_fixpoint_chd_plain`` on a CHD table."""
    if hasattr(table, "disp"):
        jt, jc = JM.merge_words(
            jnp.asarray(tokens), jnp.asarray(wid), jnp.asarray(table.disp),
            jnp.asarray(table.rows), table.size, table.n_buckets,
        )
        pt, pc = M.merge_fixpoint_chd_plain(
            torch.from_numpy(tokens), torch.from_numpy(wid), torch.from_numpy(table.disp),
            torch.from_numpy(table.rows), table.size, table.n_buckets,
        )
        return (np.asarray(jt), np.asarray(jc)), (pt.numpy(), pc.numpy())
    jt, jc = JM.merge_words_qc(
        jnp.asarray(tokens), jnp.asarray(wid), jnp.asarray(table.t1), jnp.asarray(table.t2),
        table.size,
    )
    pt, pc = M.merge_fixpoint_qc_plain(
        torch.from_numpy(tokens), torch.from_numpy(wid),
        torch.from_numpy(table.t1.view(np.int32)), torch.from_numpy(table.t2.view(np.int32)),
        table.size,
    )
    return (np.asarray(jt), np.asarray(jc)), (pt.numpy(), pc.numpy())


def _check(tokens, wid, table, warp_word_bytes=None, **chd_kw):
    """The model of K2 (a cuckoo ``table``) or K5 (a CHD ``table``) equals
    JAX and the plain version, and probes each initial pair once and at
    most two pairs per merge."""
    if hasattr(table, "disp"):
        wwb = CHD_WARP_WORD_BYTES if warp_word_bytes is None else warp_word_bytes
        model = ChdKernelModel(table, wwb, **chd_kw)
    else:
        model = KernelModel(table, WARP_WORD_BYTES if warp_word_bytes is None else warp_word_bytes)
    got_t, got_c = model(tokens, wid)
    (jt, jc), (pt, pc) = _reference(tokens, wid, table)
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
    if isinstance(model, ChdKernelModel):
        assert all(0 < n <= 32 for n in model.rounds)
    return got_t, got_c


@pytest.fixture(scope="module")
def fixture_tables():
    tok = Tokenizer.from_str(trained_tokenizer_json())
    return build_device_tables(tok.bpe)


@pytest.fixture(scope="module")
def fixture_chd():
    """The fixture's CHD table (the pipeline builds it only past u16)."""
    tok = Tokenizer.from_str(trained_tokenizer_json())
    return build_chd_table(tok.bpe.merge_ranks, tok.bpe.merge_ops)


def _table(probe, tables, chd):
    return tables.qc if probe == "qc" else chd


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


@pytest.mark.parametrize(
    "probe,L", [("qc", 128), ("qc", 512), ("chd", 128), ("chd", 512)],
    ids=["128", "512", "chd-128", "chd-512"],
)
def test_walk_matches_jax_on_conformance_corpus(fixture_tables, fixture_chd, probe, L):
    texts = (conformance_corpus() + [SAMPLE_TEXT.replace("\n", " ")] * 2)[:16]
    tokens, wid = _seeded_rows(texts, L, fixture_tables)
    _check(tokens, wid, _table(probe, fixture_tables, fixture_chd))


@pytest.mark.parametrize(
    "probe,warp_word_bytes",
    [("qc", 0), ("qc", 4), ("qc", 1 << 20), ("chd", 0), ("chd", 4), ("chd", 1 << 20)],
    ids=["0", "4", "1048576", "chd-0", "chd-4", "chd-1048576"],
)
def test_walk_paths_each_match_jax(fixture_tables, fixture_chd, probe, warp_word_bytes):
    """Every word on the warp path, a mix, and every word on the thread
    path: each gives the same rows."""
    texts = (conformance_corpus() + [SAMPLE_TEXT.replace("\n", " ")] * 2)[:16]
    tokens, wid = _seeded_rows(texts, 512, fixture_tables)
    _check(tokens, wid, _table(probe, fixture_tables, fixture_chd), warp_word_bytes)


@pytest.mark.parametrize("queue", [1, 2, CHD_QUEUE, 32])
def test_chd_walk_queue_sizes_match_jax(fixture_tables, fixture_chd, queue):
    """The thread path's re-probe queue flushed after every pair, every
    second pair, at the kernel's size and only at the end of each step;
    words taken in a random order (no barrier between long and short
    words)."""
    texts = (conformance_corpus() + [SAMPLE_TEXT.replace("\n", " ")] * 2)[:16]
    tokens, wid = _seeded_rows(texts, 512, fixture_tables)
    _check(tokens, wid, fixture_chd, queue=queue, shuffle=np.random.RandomState(queue))


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


def _run_chd():
    """The toy table's CHD form."""
    bpe, _ = _run_bpe()
    return build_chd_table(bpe.merge_ranks, bpe.merge_ops)


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


_CHUNK_EDGE_ROWS = [
    ["a" * n] for n in (31, 32, 33, 34, 63, 64, 65, 66, 97, 130)
] + [
    ["b" * 31 + "a" * 40],
    ["c" * 30 + "a" * 70 + "b"],
    ["ab" * 40, "a" * 5],
    ["ba" * 33 + "b", "aab" * 20],
    ["c" + "a" * 31 + "c" + "a" * 33],
    ["a" * 200],
]


def test_walk_on_long_runs_across_chunk_edges():
    """Words over the warp threshold whose runs of best pairs cross the
    32-entry chunk edges at both parities, with and without a taken entry
    carried into the next chunk."""
    bpe, tb = _run_bpe()
    rows = _CHUNK_EDGE_ROWS
    tokens, wid = _rows_of_words(rows, 256, bpe, tombstones=[(12, 40), (12, 41), (13, 7)])
    got_t, _ = _check(tokens, wid, tb.qc)
    for r in (0, 5, 9, 15):  # no tombstones: the oracle's ids, in order
        ids = got_t[r][got_t[r] >= 0].tolist()
        assert ids == [i for w in rows[r] for i in bpe.encode(w)]


@pytest.mark.parametrize("warp_word_bytes", [CHD_WARP_WORD_BYTES, 4])
def test_chd_walk_on_long_runs_across_chunk_edges(warp_word_bytes):
    """K5's model on the same rows, and with most words on the warp path:
    steps that mark more than 32 entries fill several rounds of slots,
    with a chunk's marked entries split across two rounds."""
    bpe, _ = _run_bpe()
    chd = _run_chd()
    rows = _CHUNK_EDGE_ROWS
    tokens, wid = _rows_of_words(rows, 256, bpe, tombstones=[(12, 40), (12, 41), (13, 7)])
    got_t, _ = _check(tokens, wid, chd, warp_word_bytes)
    for r in (0, 5, 9, 15):
        ids = got_t[r][got_t[r] >= 0].tolist()
        assert ids == [i for w in rows[r] for i in bpe.encode(w)]
    # "a" * 200: the first step takes 100 pairs and marks all 100 kept
    # entries, three full rounds of slots and one of 4
    model = ChdKernelModel(chd, warp_word_bytes)
    model(tokens[15:16], wid[15:16])
    assert model.rounds[:4] == [32, 32, 32, 4]


def test_nth_set_bit_is_the_serial_scan():
    """The kernel's halving search equals counting set bits from bit 0."""
    rng = np.random.RandomState(3)
    masks = [M32, 1, 1 << 31, 0x55555555, 0xAAAAAAAA, 0x80000001] + rng.randint(
        1, 1 << 32, 200, dtype=np.int64
    ).tolist()
    for x in masks:
        bits = [i for i in range(32) if (x >> i) & 1]
        assert [nth_set_bit(x, n) for n in range(len(bits))] == bits


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


@pytest.mark.parametrize("reach", [0, 1, CHD_REACH, 1 << 20])
def test_chd_walk_tombstone_runs_past_the_reach(reach):
    """Runs of OOV tombstones inside words, shorter and longer than the
    first round's reach, on the thread and the warp path: the pairs the
    first round leaves are probed by the walks, and the rows equal JAX's."""
    bpe, _ = _run_bpe()
    chd = _run_chd()
    rows = [
        ["ab" + "c" * 20 + "ab", "a" * 12 + "b" * 12],
        ["a" * 60 + "b" * 40, "ba" * 30],
        ["x" * 1 + "a" * 100, "aab" * 10],
        ["a" * 200, "b" * 9 + "a"],
    ]
    rows = [[w.replace("x", "c") for w in ws] for ws in rows]
    holes = [(0, q) for q in range(2, 22)] + [(0, q) for q in range(27, 36)]
    holes += [(1, q) for q in range(3, 45)] + [(1, q) for q in range(70, 79)]
    holes += [(2, q) for q in range(1, 90)] + [(3, q) for q in range(0, 150, 2)]
    holes += [(3, q) for q in range(150, 199)]
    tokens, wid = _rows_of_words(rows, 256, bpe, tombstones=holes)
    _check(tokens, wid, chd, reach=reach)
    model = ChdKernelModel(chd, reach=reach)
    model(tokens, wid)
    assert (model.pending > 0) == (reach < 40)


@settings(max_examples=40, deadline=None, database=None)
@given(
    rows=st.lists(st.lists(_WORD, min_size=1, max_size=4), min_size=4, max_size=4),
    holes=st.lists(st.tuples(st.integers(0, 3), st.integers(0, 511)), max_size=12),
    edge_holes=st.lists(
        st.tuples(st.integers(0, 3), st.sampled_from([31, 32, 33, 63, 64, 65, 95, 96])),
        max_size=6,
    ),
    hole_runs=st.lists(
        st.tuples(st.integers(0, 3), st.integers(0, 511), st.integers(1, 40)), max_size=4
    ),
    seed=st.integers(0, 2**16),
)
def test_chd_walk_matches_jax_on_random_runs(rows, holes, edge_holes, hole_runs, seed):
    """K5's model on words built from runs of one to 40 equal tokens, with
    OOV tombstones anywhere, at the 32-entry chunk edges and in runs of up
    to 40 (past the first round's reach), its words taken in a random
    order: the model, the JAX ``merge_words`` and the plain version
    agree."""
    bpe, _ = _run_bpe()
    chd = _run_chd()
    L = 512
    trimmed = []
    for ws in rows:
        out, n = [], 0
        for w in ws:
            if n + len(w) <= L:
                out.append(w)
                n += len(w)
        trimmed.append(out)
    runs = [(r, q) for r, q0, n in hole_runs for q in range(q0, min(q0 + n, L))]
    tokens, wid = _rows_of_words(trimmed, L, bpe, tombstones=holes + edge_holes + runs)
    _check(tokens, wid, chd, shuffle=np.random.RandomState(seed))


@pytest.fixture(scope="module")
def bench100k_chd():
    """The CHD table and byte table of the 100,000-entry tokenizer
    (``scripts/make_bench_tokenizer_100k.py``: ids and ranks past u16)."""
    tok = Tokenizer.from_file(BENCH_100K)
    tb = build_device_tables(tok.bpe)
    assert tb.qc is None and tb.chd is not None
    return tb


@pytest.mark.parametrize("L", [128, 512])
def test_chd_walk_matches_jax_at_100k(bench100k_chd, L):
    """K5's model on the 100K table: the conformance corpus, Zipf texts and
    rows of long runs with OOV bytes inside words, equal to the JAX
    ``merge_words`` and the plain version; ids past u16 are minted."""
    tb = bench100k_chd
    texts = conformance_corpus() + [SAMPLE_TEXT.replace("\n", " ")]
    texts += zipf_corpus(6, seed=L, lo=L // 2, hi=L)
    tokens, wid = _seeded_rows(texts[:16], L, tb)
    runs = run_rows(" ".join(zipf_corpus(40, seed=L)).encode("utf-8"), 4, L, True)
    arr = np.zeros((4, L), np.uint8)
    lens = np.array([len(r) for r in runs], np.int32)
    for i, r in enumerate(runs):
        arr[i, : len(r)] = np.frombuffer(r, np.uint8)
    table = tb.byte_token_table.copy()
    table[list(RUN_BREAKS)] = -1  # OOV bytes inside the runs
    arr_t, lens_t = torch.from_numpy(arr), torch.from_numpy(lens)
    _, rwid, _ = presplit(arr_t, lens_t, torch.from_numpy(gpt2_class_table()))
    rtok = seed_tokens_plain(arr_t, lens_t, torch.from_numpy(table))
    tokens = np.concatenate([tokens, rtok.numpy()])
    wid = np.concatenate([wid, rwid.numpy()])
    got_t, _ = _check(tokens, wid, tb.chd)
    assert int(got_t.max()) >= 65_536

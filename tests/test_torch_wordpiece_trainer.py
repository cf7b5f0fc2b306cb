"""The port's WordPiece trainers against the JAX package's, on the CPU:
``WordPieceTrainer`` against JAX's host trainer, and
``DistributedWordPieceTrainer(device="cpu")`` (the plain versions of K18 and
K19) against JAX's ``DistributedWordPieceTrainer`` on the 8-device CPU mesh
and the host trainer, vocabulary for vocabulary, on the JAX package's
cases (over-wide words, the fallback that resets the vocabulary, the int32
bound); the longest-match tables array for array; one round of K18 and
K19's plain versions against JAX's ``_match_count_program`` on the same
tables, also with forged rows that poison words and on a word list where
one pair dominates; the one-process readback's copies; the selection rule
against a brute-force ``min``; and world size 2 over gloo against world
size 1.
"""

import json
from collections import Counter

import numpy as np
import pytest
import torch

from complexity_tokenizer_tpu.parallel.wordpiece_trainer import (
    DistributedWordPieceTrainer as JaxDistributed,
)
from complexity_tokenizer_tpu.parallel.wordpiece_trainer import _MatchTables as JaxTables
from complexity_tokenizer_tpu.trainers.wordpiece_trainer import WordPieceTrainer as JaxHost
from complexity_tokenizer_tpu.trainers.wordpiece_trainer import (
    WordPieceTrainerConfig as JaxConfig,
)
from complexity_tokenizer_tpu_torch.ops.wordpiece_device import _W, _pack_words
from complexity_tokenizer_tpu_torch.ops.wordpiece_train_device import (
    match_table_views,
    pair_count,
    pair_count_plain,
    split_pairs,
    train_match,
    train_match_plain,
)
from complexity_tokenizer_tpu_torch.parallel.wordpiece_trainer import (
    DistributedWordPieceTrainer,
    _MatchTables,
    _PairReader,
    select_pair,
)
from complexity_tokenizer_tpu_torch.trainers import WordPieceTrainer, WordPieceTrainerConfig
from complexity_tokenizer_tpu_torch.utils.corpus import (
    MULTI_PIECES,
    TRAIN_MATCH_EDGES,
    train_match_edge_words,
    wordpiece_train_edge_texts,
    zipf_corpus,
)

import torch_train_worker


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many ops on small tensors: with the test
    workers sharing the machine, torch's intra-op threads only wait on each
    other (one thread runs these tests many times faster under load)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_PARALLEL_TEXTS = [
    "hello world this is a test",
    "the quick brown fox jumps over the lazy dog",
    "wordpiece training corpus with unusual words",
    "hello hello world",
    "##literal prefix words here",
    "café über naïve 日本語",
] * 4

# (texts, config): tests/test_models_trainers.py's and tests/test_parallel.py's
# cases, the edge words and a corpus at the defaults' min_frequency
CASES = {
    "models": (["hello world", "hello there", "world peace"],
               dict(vocab_size=100, min_frequency=1)),
    "parallel": (_PARALLEL_TEXTS, dict(vocab_size=120, min_frequency=1)),
    "overwide": (["aa bb aa", "xy" * 80, "xy xy yx"] * 3, dict(vocab_size=30, min_frequency=1)),
    "edges": (wordpiece_train_edge_texts(), dict(vocab_size=80)),
    "corpus": (zipf_corpus(60, seed=4) + list(MULTI_PIECES), dict(vocab_size=170)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_host_trainer_matches_jax(case):
    texts, cfg = CASES[case]
    got = WordPieceTrainer(WordPieceTrainerConfig(**cfg)).train_from_texts(texts)
    want = JaxHost(JaxConfig(**cfg)).train_from_texts(texts)
    assert got.vocab == want.vocab and len(got.vocab) > 20
    assert got.encode("hello world café") == want.encode("hello world café")


@pytest.mark.parametrize("case", sorted(set(CASES) - {"edges"}))  # edges: the K18 test below
def test_distributed_trainer_matches_jax(case):
    texts, cfg = CASES[case]
    dist = DistributedWordPieceTrainer(WordPieceTrainerConfig(**cfg), device="cpu")
    model = dist.train_from_texts(texts)
    want = JaxDistributed(JaxConfig(**cfg))
    want_model = want.train_from_texts(texts)
    host = JaxHost(JaxConfig(**cfg))
    host.train_from_texts(texts)
    assert dist.vocab == want.vocab == host.vocab
    assert dist.last_stats["route"] == "device" and dist.last_stats["rounds"] > 0
    wide = sum(len(w) > _W for w in _word_freqs(texts, cfg))
    assert dist.last_stats["over_wide"] == wide and (wide > 0) == (case == "overwide")
    assert model.encode("hello world café") == want_model.encode("hello world café")


def test_fallback_resets_state():
    """The symbol cap sends the run to the host trainer after the vocabulary
    was begun: it starts again from nothing (no duplicate or skipped id)."""
    texts = ["aa bb ab ba", "bb aa ab"] * 3
    cfg = dict(vocab_size=32760, min_frequency=1)
    dist = DistributedWordPieceTrainer(WordPieceTrainerConfig(**cfg), device="cpu")
    dist.train_from_texts(texts)
    want = JaxDistributed(JaxConfig(**cfg))
    want.train_from_texts(texts)
    assert dist.vocab == want.vocab == JaxHost(JaxConfig(**cfg)).train_from_texts(texts).vocab
    assert dist.last_stats == {"route": "host", "reason": "symbol cap"}
    assert sorted(dist.vocab.values()) == list(range(len(dist.vocab)))


def test_int32_overflow_guard():
    """A weighted pair mass of 2**31 or more goes to the exact host trainer."""
    wf = Counter({"ab": 1 << 31, "ba": 3, "aa": 2})
    cfg = dict(vocab_size=12, min_frequency=1)
    dist = DistributedWordPieceTrainer(WordPieceTrainerConfig(**cfg), device="cpu")
    dist._train_from_word_freqs(Counter(wf))
    want = JaxDistributed(JaxConfig(**cfg))
    want._train_from_word_freqs(Counter(wf))
    host = JaxHost(JaxConfig(**cfg))
    host._train_from_word_freqs(Counter(wf))
    assert dist.vocab == want.vocab == host.vocab
    assert dist.last_stats == {"route": "host", "reason": "int32 pair mass"}
    just_under = Counter({"ab": (1 << 31) - 1, "ba": 0})
    dist._train_from_word_freqs(just_under)
    assert dist.last_stats["route"] == "device"


def test_refused_insert_falls_back(monkeypatch):
    """A refused insert (here: no free slot within the probe budget, forced
    by a probe budget of 0) sends the run to the host trainer."""
    import complexity_tokenizer_tpu_torch.parallel.wordpiece_trainer as wt

    monkeypatch.setattr(wt, "MAXP", 0)
    texts, cfg = CASES["parallel"]
    dist = DistributedWordPieceTrainer(WordPieceTrainerConfig(**cfg), device="cpu")
    dist.train_from_texts(texts)
    assert dist.last_stats == {"route": "host", "reason": "insert refused"}
    assert dist.vocab == JaxHost(JaxConfig(**cfg)).train_from_texts(texts).vocab


def _word_freqs(texts, cfg):
    t = JaxHost(JaxConfig(**cfg))
    wf = Counter(w for text in texts for w in t._pretokenize(text))
    return Counter({w: f for w, f in wf.items() if f >= t.config.min_frequency})


def _both_tables(vocab: dict, word_freqs: Counter, cap: int, prefix: str = "##"):
    """The JAX package's and the port's tables, filled as the trainers fill
    them from ``vocab`` (in id order), with the fallback maps and symbols."""
    sym_of, sym_str = {}, []

    def sym(s):
        if s not in sym_of:
            sym_of[s] = len(sym_str)
            sym_str.append(s)
        return sym_of[s]

    jt, pt = JaxTables(2 * cap), _MatchTables(2 * cap)
    for tok in sorted(vocab, key=vocab.__getitem__):
        s = sym(tok)
        for t in (jt, pt):
            assert t.insert_form([ord(c) for c in tok], False, s)
            if tok.startswith(prefix) and len(tok) > len(prefix):
                assert t.insert_form([ord(c) for c in tok[len(prefix):]], True, s)
    fb = np.full((2, 0x110000), -1, np.int32)
    for c in sorted({c for w in word_freqs for c in w}):
        fb[0, ord(c)] = sym(c)
        fb[1, ord(c)] = sym(prefix + c)
    return jt, pt, fb, sym_str


def _trained_vocab(texts, cfg, size):
    return JaxHost(JaxConfig(**{**cfg, "vocab_size": size})).train_from_texts(texts).vocab


def test_match_tables_match_jax():
    """The host master holds JAX's arrays entry for entry, and the mirror
    (one buffer, the pending inserts applied as one indexed write) holds
    the master's."""
    texts, cfg = CASES["corpus"]
    wf = _word_freqs(texts, cfg)
    vocab = _trained_vocab(texts, cfg, 200)
    jt, pt, _fb, _syms = _both_tables(vocab, wf, 400)
    for name in ("h1", "h2", "slotv", "token_chars", "token_lens", "emit_sym"):
        np.testing.assert_array_equal(getattr(pt, name), getattr(jt, name), err_msg=name)
    assert (pt.n_slots, pt.max_len, pt.t_size, pt.seen_keys) == (
        jt.n_slots, jt.max_len, jt.t_size, jt.seen_keys)
    small = {t: i for t, i in vocab.items() if i < 120}
    _jt, grown, _fb, _syms = _both_tables(small, wf, 400)
    buf = grown.device_buffer("cpu")
    for tok in sorted(vocab, key=vocab.__getitem__)[120:]:  # the later rounds' inserts
        grown.insert_form([ord(c) for c in tok], False, 1000 + vocab[tok])
        if tok.startswith("##") and len(tok) > 2:
            grown.insert_form([ord(c) for c in tok[2:]], True, 1000 + vocab[tok])
    assert grown.device_buffer("cpu") is buf
    table, meta, chars = match_table_views(buf, grown.t_size, grown.s_cap)
    np.testing.assert_array_equal(table.numpy()[:, :3], np.stack([grown.h1, grown.h2, grown.slotv], 1))
    # K18's (length << 16) | symbol in each filled row's fourth word, 0 in an empty row's
    filled = (grown.h1 != 0) | (grown.h2 != 1)
    packed = grown.token_lens[grown.slotv] << 16 | grown.emit_sym[grown.slotv]
    np.testing.assert_array_equal(table.numpy()[:, 3], np.where(filled, packed, 0))
    assert filled.sum() == grown.n_slots and (table.numpy()[filled, 3] >> 16 > 0).all()
    np.testing.assert_array_equal(meta.numpy(), np.stack([grown.token_lens, grown.emit_sym], 1))
    np.testing.assert_array_equal(chars.numpy(), grown.token_chars)


def _jax_round(jt, fb, words, freqs, lt_cap=None):
    """One round of JAX's ``_match_count_program`` on the 8-device CPU mesh
    (at the trainer's ``lt_cap`` unless one is given): the global (key,
    count) pairs, summed over the shards, and the poisoned words."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from complexity_tokenizer_tpu.parallel.mesh import DATA_AXIS, data_mesh
    from complexity_tokenizer_tpu.parallel.wordpiece_trainer import _match_count_program, _pow2

    mesh = data_mesh()
    n_dev = mesh.devices.size
    N = len(words)
    N_pad = max(_pow2(N), n_dev)
    chars = np.full((N_pad, _W), -1, np.int32)
    lens = np.zeros(N_pad, np.int32)
    fr = np.zeros(N_pad, np.int32)
    for i, w in enumerate(words):
        chars[i, : len(w)] = [ord(c) for c in w]
        lens[i] = len(w)
        fr[i] = freqs[i]
    shard = NamedSharding(mesh, P(DATA_AXIS))
    lt_cap = lt_cap or min(_pow2(max(jt.max_len, 8)), _W)
    prog = _match_count_program(mesh, jt.t_size, jt.s_cap, lt_cap, 1 << 12, N_pad // n_dev)
    gk, gc, gu, gp = prog(*jt.device_arrays(lt_cap), jnp.asarray(fb[0]), jnp.asarray(fb[1]),
                          *(jax.device_put(a, shard) for a in (chars, lens, fr)))
    assert int(np.max(np.asarray(gu))) <= 1 << 12
    gk, gc = np.asarray(gk).reshape(-1), np.asarray(gc).reshape(-1)
    live = gc > 0
    keys, inv = np.unique(gk[live], return_inverse=True)
    counts = np.zeros(len(keys), np.int64)
    np.add.at(counts, inv, gc[live])
    return keys.tolist(), counts.tolist(), np.asarray(gp).reshape(-1)[:N].astype(bool), lt_cap


def _port_round(pt, fb, words, freqs, lt_cap):
    wl = np.fromiter(map(len, words), np.int64, len(words))
    chars, offs, order, groups = _pack_words(words, wl, wl)
    on = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32))  # noqa: E731
    table, meta, schars = match_table_views(pt.device_buffer("cpu"), pt.t_size, pt.s_cap)
    args = (on(chars), on(offs), on(wl[order]), groups, table, meta, schars,
            torch.from_numpy(fb), lt_cap)
    out, poison = train_match(*args)
    assert all(torch.equal(a, b) for a, b in zip((out, poison), train_match_plain(*args)))
    f = on(np.asarray(freqs)[order])
    res = pair_count(out, args[1], f, poison)
    assert torch.equal(res, pair_count_plain(out, args[1], f, poison))
    keys, counts, n, n_poison = split_pairs(res.numpy())
    flags = np.zeros(len(words), bool)
    flags[order] = poison.numpy() != 0
    assert n_poison == int(flags.sum())
    return keys.tolist(), counts.tolist(), flags


@pytest.mark.parametrize("size,forge", [(0, False), (150, False), (200, True), (250, False)])
def test_k18_k19_plain_match_jax_program(size, forge):
    """One round of K18 and K19's plain versions against JAX's
    ``_match_count_program`` on the same tables: the (key, count) set (in
    key order, summed over JAX's shards), its size and the poisoned words;
    at the alphabet alone, after 150, 200 and 250 entries (a late round of
    the 260-entry training), and with every form of two characters or more
    forged in both tables' characters, which poisons the words that choose
    one."""
    texts, cfg = CASES["edges"]
    wf = _word_freqs(texts, cfg)
    vocab = _trained_vocab(texts, cfg, 260)
    n = size or 5 + len({c for w in wf for c in w})  # 0: the specials and the alphabet
    jt, pt, fb, _syms = _both_tables({t: i for t, i in vocab.items() if i < n}, wf, 600)
    if forge:
        for t in (jt, pt):
            t.token_chars[t.token_lens >= 2, 0] += 1
    words = [w for w in wf if len(w) <= _W]
    freqs = [wf[w] for w in words]
    jk, jc, jp, lt_cap = _jax_round(jt, fb, words, freqs)
    pk, pc, pp = _port_round(pt, fb, words, freqs, lt_cap)
    assert (pk, pc) == (jk, jc) and len(pk) > 10
    np.testing.assert_array_equal(pp, jp)
    assert bool(pp.any()) == forge


def _with_host_vocab(vocab, words, freqs):
    """``vocab`` with its first 150 entries JAX's host trainer's on the
    words (``train_match_edge_words`` trains the port's)."""
    host = JaxHost(JaxConfig(vocab_size=150, min_frequency=1))
    host._train_from_word_freqs(Counter(dict(zip(words, freqs))))
    return {**host.vocab, **{t: i for t, i in vocab.items() if i >= len(host.vocab)}}


@pytest.mark.parametrize("lt_cap", [8, 16, 32, 128])
def test_k18_plain_matches_jax_program_at_group_edges(lt_cap):
    """K18's plain version, called through ``train_match`` with the lane
    groups, and K19's against JAX's ``_match_count_program`` at ``lt_cap``
    8, 16, 32 and 128, on words at the groups' edges (1, 8, 9, 16, 17, 32,
    33, 127 and 128 characters) and tables holding forms of every length up
    to 128 (``utils/corpus.py:train_match_edge_words``, its vocabulary's
    first entries JAX's host trainer's); the pack's groups put the words of
    up to 8 and 16 characters first."""
    words, freqs, vocab = train_match_edge_words()
    wf = Counter(dict(zip(words, freqs)))
    assert vocab == _with_host_vocab(vocab, words, freqs)
    jt, pt, fb, _syms = _both_tables(vocab, wf, 800)
    assert pt.max_len == 128
    wl = np.fromiter(map(len, words), np.int64, len(words))
    _c, _o, _order, groups = _pack_words(words, wl, wl)
    assert sorted(set(wl.tolist())) == list(TRAIN_MATCH_EDGES)
    assert groups == (int((wl <= 8).sum()), int((wl <= 16).sum()))
    jk, jc, jp, _lt = _jax_round(jt, fb, words, freqs, lt_cap)
    pk, pc, pp = _port_round(pt, fb, words, freqs, lt_cap)
    assert (pk, pc) == (jk, jc) and len(pk) > 10
    np.testing.assert_array_equal(pp, jp)
    assert not pp.any()


def test_k19_plain_matches_jax_program_on_a_hot_pair():
    """A word list where one pair dominates: ``q`` then ``##z`` in every
    word but two, with the largest frequencies; round 0 (the alphabet's
    tables).  The plain K19 against JAX's program, and the hot key's count
    is every such word's frequency."""
    rng = np.random.RandomState(3)
    words = set()
    while len(words) < 300:
        w = "".join(rng.choice(list("abcde"), size=rng.randint(0, 7)))
        pos = rng.randint(0, len(w) + 1)
        words.add(w[:pos] + "qz" + w[pos:])
    words = sorted(words) + ["abc", "de"]
    freqs = [int(f) for f in rng.randint(1, 1 << 16, size=len(words))]
    freqs[-2:] = [1, 2]
    wf = Counter(dict(zip(words, freqs)))
    alphabet = sorted({c for w in words for c in w})
    vocab = {t: i for i, t in enumerate(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + alphabet)}
    jt, pt, fb, syms = _both_tables(vocab, wf, 600)
    jk, jc, jp, lt_cap = _jax_round(jt, fb, words, freqs)
    pk, pc, pp = _port_round(pt, fb, words, freqs, lt_cap)
    assert (pk, pc) == (jk, jc) and not pp.any()
    hot = (syms.index("q") << 16) | syms.index("##z")
    want = sum(f for w, f in zip(words, freqs) if w.startswith("qz"))
    assert pc[pk.index(hot)] == want
    want = sum(f for w, f in zip(words, freqs) if "qz" in w and not w.startswith("qz"))
    hot = (syms.index("##q") << 16) | syms.index("##z")
    assert pc[pk.index(hot)] == want == max(pc)


def test_pair_reader_copies_once_unless_a_round_outgrows_its_guess():
    """The one-process readback: one copy of the head and the round before's
    keys plus a margin, a second copy only for a round with more keys; the
    head and pairs it returns are the result's, whatever lies past them."""
    reader = _PairReader()
    copies = []
    copy = reader._copy
    reader._copy = lambda res, lo, hi: copies.append((lo, hi)) or copy(res, lo, hi)
    T = 1 << 15
    for n in (10, 5000, 5100, 100, 9000, 0):
        res = torch.full((2 + T,), -7, dtype=torch.int32)
        res[0], res[1] = n, 3
        res[2:2 + 2 * n] = torch.arange(2 * n, dtype=torch.int32)
        guess = reader.expect
        copies.clear()
        got = reader.read(res)
        assert got.tolist() == res[:2 + 2 * n].tolist()
        assert copies[0] == (0, 2 + 2 * min(guess, T // 2))
        assert len(copies) == (2 if n > guess else 1)
        assert reader.expect == n + max(1024, n // 16)


def test_select_pair_matches_brute_force():
    """The selection over key arrays against ``min`` over a Counter of the
    string pairs (the JAX rule), with ties, over many random histograms."""
    rng = np.random.RandomState(0)
    syms = ["a", "b", "##b", "ab", "##ab", "ba", "b##", "[UNK]", "é", "##é", "aa"]
    for _ in range(300):
        n = rng.randint(1, 40)
        keys = np.unique(rng.randint(0, len(syms), size=n) * 65536
                         + rng.randint(0, len(syms), size=n))
        counts = rng.randint(1, 4, size=len(keys)).astype(np.int64)
        pf = Counter({(syms[k >> 16], syms[k & 0xFFFF]): int(c) for k, c in zip(keys, counts)})
        want = min(pf.items(), key=lambda kv: (-kv[1], kv[0]))[0]
        assert select_pair(keys.astype(np.int64), counts, syms) == want
    assert select_pair(np.zeros(0, np.int64), np.zeros(0, np.int64), syms) is None


def test_forged_rows_poison_and_the_host_recounts():
    """Rows forged on the card from round 20 poison the words that choose
    them; the host re-tokenizes and counts them, so the vocabulary is the
    host trainer's."""
    runs = torch_train_worker.train_wordpiece()
    assert runs[2]["poisoned"] > 0 and runs[2]["vocab"] == runs[0]["vocab"]
    host = JaxHost(JaxConfig(vocab_size=120, min_frequency=1))
    host.train_from_texts(torch_train_worker.WP_TEXTS)
    assert runs[0]["vocab"] == host.vocab and runs[0]["over_wide"] == 2


def test_world_size_two_equals_world_size_one(tmp_path):
    """Two processes over gloo (a ``file://`` store), each with half the
    words, learn what one process learns, forged rows included."""
    import time

    import torch.multiprocessing as mp

    ctx = mp.start_processes(torch_train_worker.run_world_member,
                             args=(str(tmp_path / "store"), 2, str(tmp_path), "wordpiece"),
                             nprocs=2, join=False, start_method="spawn")
    deadline = time.monotonic() + 240
    while not ctx.join(timeout=5):  # raises if a member failed
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise AssertionError("the two processes did not finish in 240 s")
    want = torch_train_worker.train_wordpiece()
    for rank in range(2):
        with open(tmp_path / f"rank{rank}.json") as f:
            got = json.load(f)
        assert [r["vocab"] for r in got] == [r["vocab"] for r in want], rank
        assert got[2]["poisoned"] > 0

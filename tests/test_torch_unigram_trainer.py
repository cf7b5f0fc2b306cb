"""The port's Unigram trainers against the JAX package's, on the CPU:
``UnigramTrainer`` against JAX's host trainer, and
``DistributedUnigramTrainer(device="cpu")`` (the plain versions of K12 and
K17) against JAX's ``DistributedUnigramTrainer`` on the 8-device CPU mesh
and the host trainer, vocabulary for vocabulary, on the JAX package's cases
(over-wide sentences, a reused trainer, the int32 guard); the expected
counts of one E-step against JAX's for the same vocabularies, with exact
ties that poison sentences to the host; a vocabulary whose tables are
refused; and world size 2 over gloo against world size 1.
"""

import json
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complexity_tokenizer_tpu.parallel.unigram_trainer import (
    DistributedUnigramTrainer as JaxDistributed,
)
from complexity_tokenizer_tpu.trainers.unigram_trainer import UnigramTrainer as JaxHost
from complexity_tokenizer_tpu.trainers.unigram_trainer import (
    UnigramTrainerConfig as JaxConfig,
)
from complexity_tokenizer_tpu_torch.ops.unigram_device import (
    FALLBACK_ID,
    UnigramDevice,
    piece_hist,
    piece_hist_plain,
    viterbi,
)
from complexity_tokenizer_tpu_torch.parallel.unigram_trainer import DistributedUnigramTrainer
from complexity_tokenizer_tpu_torch.trainers import UnigramTrainer, UnigramTrainerConfig
from complexity_tokenizer_tpu_torch.utils.corpus import (
    MULTI_PIECES,
    piece_hist_edge_results,
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
    "unigram training corpus with 日本語 and café text",
    "more text to segment here",
    "hello hello world world",
] * 5
_WORDS = [w for t in zipf_corpus(40, seed=6) + list(MULTI_PIECES) for w in t.split()]

# (texts, config): tests/test_models_trainers.py's and tests/test_parallel.py's
# cases, and the corpus's words each a text (as the 32,000-piece table was
# trained) at the defaults' piece length
CASES = {
    "models": (["hello world", "hello there", "world peace"],
               dict(vocab_size=50, initial_vocab_size=100, n_iterations=2)),
    "parallel": (_PARALLEL_TEXTS,
                 dict(vocab_size=60, n_iterations=5, max_piece_length=6, initial_vocab_size=400)),
    "overwide": (["short words here", "ab" * 100, "ab ab ab"] * 3,
                 dict(vocab_size=20, n_iterations=3, max_piece_length=4, initial_vocab_size=150)),
    "words": (_WORDS, dict(vocab_size=150, initial_vocab_size=3000, n_iterations=6)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_host_trainer_matches_jax(case):
    texts, cfg = CASES[case]
    got = UnigramTrainer(UnigramTrainerConfig(**cfg)).train_from_texts(texts)
    want = JaxHost(JaxConfig(**cfg)).train_from_texts(texts)
    assert got.vocab == want.vocab and len(got.vocab) > 10
    assert got.encode("hello world") == want.encode("hello world")


@pytest.mark.parametrize("case", sorted(CASES))
def test_distributed_trainer_matches_jax(case):
    texts, cfg = CASES[case]
    dist = DistributedUnigramTrainer(UnigramTrainerConfig(**cfg), device="cpu")
    model = dist.train_from_texts(texts)
    want = JaxDistributed(JaxConfig(**cfg))
    want_model = want.train_from_texts(texts)
    host = JaxHost(JaxConfig(**cfg))
    host.train_from_texts(texts)
    assert dist.vocab == want.vocab == host.vocab
    assert dist.rounds and all(r["route"] == "device" for r in dist.rounds)
    wide = 1 if case == "overwide" else 0
    assert all(r["over_wide"] == wide for r in dist.rounds)
    assert model.encode("hello world") == want_model.encode("hello world")


def _seeded(texts, cfg):
    """A host trainer after the substring seed (no EM round) and its
    sentence counts."""
    t = JaxHost(JaxConfig(**{**cfg, "n_iterations": 0}))
    sentences = [s for text in texts for s in t._pretokenize(text)]
    t._train_from_sentences(sentences)
    return t.vocab, Counter(sentences)


def test_expected_counts_match_jax():
    """One E-step, K12 then K17's plain versions with the host's share,
    against JAX's distributed E-step and the host's, for the vocabularies of
    the seed and of a pruned round: the same expected counts as integers.
    K17 alone (the device histogram) equals the counts less the host's
    re-segmented sentences."""
    texts, cfg = CASES["words"]
    vocab, sf = _seeded(texts, cfg)
    pruned = JaxHost(JaxConfig(**{**cfg, "n_iterations": 2}))
    pruned.train_from_texts(texts)
    for v in (vocab, pruned.vocab):
        port = DistributedUnigramTrainer(UnigramTrainerConfig(**cfg), device="cpu")
        jd = JaxDistributed(JaxConfig(**cfg))
        jh = JaxHost(JaxConfig(**cfg))
        kept = []
        port.capture = lambda r, inp: kept.append(inp)
        port.vocab = jd.vocab = jh.vocab = list(v)
        got = port._expected_counts(sf)
        assert got == jd._expected_counts(sf) == jh._expected_counts(sf)
        assert all(isinstance(c, int) for c in got.values())
        res = viterbi(*kept[0]["viterbi"])
        hist = piece_hist(res, *kept[0]["piece_hist"])
        V = len(v)
        sentences = list(sf)
        poisoned = np.nonzero(hist[V:].numpy())[0].tolist()
        host_part = jh._expected_counts(Counter({sentences[i]: sf[sentences[i]] for i in poisoned}))
        device_part = Counter({i: int(c) for i, c in enumerate(hist[:V].tolist()) if c})
        assert device_part + Counter(host_part) == Counter(got)


def test_exact_ties_poison_to_host():
    """Same-multiset segmentations ('aa' or 'a' 'a' at equal totals) are
    exact ties: K12 poisons them, the host segments them, and the counts
    are the host's."""
    vocab = [("<unk>", -10.0), ("a", -2.0), ("aa", -4.0), ("b", -3.0)]
    sf = Counter({"aaaa": 3, "aa": 2, "aaa": 1, "bab": 4, "ab": 5})
    port = DistributedUnigramTrainer(UnigramTrainerConfig(max_piece_length=4), device="cpu")
    host = JaxHost(JaxConfig(max_piece_length=4))
    port.vocab = host.vocab = vocab
    assert port._expected_counts(sf) == host._expected_counts(sf)
    assert port.rounds[-1]["route"] == "device" and port.rounds[-1]["poisoned"] >= 3


def test_k17_plain_on_edge_results():
    """K17's plain version on a crafted K12 result: ids 0 and V - 1 counted
    with each text's frequency, a poisoned text and fallbacks (-2) not,
    each text's poison flag at its place in the corpus; and the pack that
    gives K12 and K17 their texts."""
    on = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32))  # noqa: E731
    out = [0, 2, -1, 2, -1, 1, FALLBACK_ID, 0, -1, 2, FALLBACK_ID]
    res = on(out + [1, 1, 1, 2, 3] + [0, 0, 1, 0, 0])  # text 2 is poisoned
    offs = on([0, 1, 3, 5, 7, 11])
    freqs, gidx = on([5, 7, 11, 13, 17]), on([4, 0, 1, 2, 3])
    got = piece_hist_plain(res, offs, freqs, gidx, 3, 6)
    assert got.tolist() == [5 + 17, 13, 7 + 17] + [0, 1, 0, 0, 0, 0]
    assert torch.equal(piece_hist(res, offs, freqs, gidx, 3, 6), got)
    chars, poffs, lens, order, groups, wide = UnigramDevice.pack(["ab", "ba", "abba", "c", "zz", "q" * 129])
    assert order.tolist() == [5, 3, 0, 1, 4, 2] and groups == (6, 6) and wide == [5]
    assert lens.tolist() == [0, 1, 2, 2, 2, 4] and poffs.tolist() == [0, 0, 1, 3, 5, 7, 11]
    assert len(chars) == 11


_EDGE_RESULTS = piece_hist_edge_results()


def _jax_piece_hist(res, offs, freqs, gidx, V, n_global):
    """JAX's expression (``_counts_program``,
    ``parallel/unigram_trainer.py:66-70``) on the same arrays: the ids laid out dense [B, L]
    (-1 past a text's slots), ``hist.at[where(ok, out, V)].add(where(ok,
    freqs, 0))[:V]`` with ``ok`` the ids >= 0 of the texts not poisoned,
    and the poison flags gathered to their places in the corpus."""
    B = len(offs) - 1
    N = len(res) - 2 * B
    lens = np.diff(offs)
    L = max(int(lens.max()), 1)
    out = np.full((B, L), -1, np.int32)
    rows = np.repeat(np.arange(B), lens)
    cols = np.arange(N) - np.repeat(offs[:-1], lens)
    out[rows, cols] = res[:N]
    poison = res[N + B:] != 0
    ok = (out >= 0) & ~poison[:, None]
    hist = jnp.zeros(V + 1, jnp.int32)
    hist = hist.at[jnp.where(ok, out, V)].add(jnp.where(ok, freqs[:, None], 0))[:V]
    flags = np.zeros(n_global, np.int32)
    flags[gidx] = poison
    return np.concatenate([np.asarray(hist), flags])


@pytest.mark.parametrize("case", range(len(_EDGE_RESULTS)), ids=[c[0] for c in _EDGE_RESULTS])
def test_k17_plain_matches_jax_expression(case):
    """K17's plain version (and the wrapper on CPU tensors) against JAX's
    ``.at[].add`` on the same arrays, bit for bit, on
    ``utils/corpus.py:piece_hist_edge_results``: one id most texts choose,
    texts of no slot, texts over 32 slots, every text poisoned, one text,
    V = 1, ids at and past V, a corpus index over part of ``n_global``."""
    label, res, offs, freqs, gidx, V, n_global = _EDGE_RESULTS[case]
    want = _jax_piece_hist(res, offs, freqs, gidx, V, n_global)
    on = torch.from_numpy
    got = piece_hist_plain(on(res), on(offs), on(freqs), on(gidx), V, n_global)
    np.testing.assert_array_equal(got.numpy(), want, err_msg=label)
    assert torch.equal(piece_hist(on(res), on(offs), on(freqs), on(gidx), V, n_global), got)
    assert want[:V].any() or label == "every text poisoned"


def test_refused_tables_take_the_host_e_step():
    """A piece over 128 characters makes ``build_piece_tables`` refuse the
    vocabulary: that E-step runs on the host, and the vocabulary is the
    host trainer's."""
    texts = ["q" * 140 + " short text here"] * 2 + ["short text"] * 3
    cfg = dict(vocab_size=30, initial_vocab_size=1000, n_iterations=3, max_piece_length=140)
    dist = DistributedUnigramTrainer(UnigramTrainerConfig(**cfg), device="cpu")
    dist.train_from_texts(texts)
    host = JaxHost(JaxConfig(**cfg))
    host.train_from_texts(texts)
    assert dist.vocab == host.vocab
    assert dist.rounds[0] == {**dist.rounds[0], "route": "host", "reason": "tables refused"}


def test_reuse_restages_and_overflow_guard():
    """A reused trainer re-stages its corpus; a piece mass of 2**31 takes the
    host E-step."""
    cfg = dict(vocab_size=20, n_iterations=3, max_piece_length=4, initial_vocab_size=150)
    dist = DistributedUnigramTrainer(UnigramTrainerConfig(**cfg), device="cpu")
    dist.train_from_texts(["first corpus words here"] * 4)
    dist.train_from_texts(["totally different second corpus"] * 4)
    host = JaxHost(JaxConfig(**cfg))
    host.train_from_texts(["totally different second corpus"] * 4)
    assert dist.vocab == host.vocab
    d2 = DistributedUnigramTrainer(UnigramTrainerConfig(**cfg), device="cpu")
    d2._stage_corpus(Counter({"abab": 1 << 29}))
    assert d2._count_overflow  # 2^29 * len("abab") = 2^31 triggers it
    d3 = DistributedUnigramTrainer(UnigramTrainerConfig(**cfg), device="cpu")
    d3._stage_corpus(Counter({"abab": (1 << 29) - 1}))
    assert not d3._count_overflow
    wf = Counter({"▁abab": 1 << 29, "▁ba": 3})
    vocab = [("<unk>", -10.0), ("▁", -1.0), ("a", -2.0), ("b", -2.0), ("ab", -3.0)]
    want = JaxHost(JaxConfig(**cfg))
    d2.vocab, want.vocab = list(vocab), list(vocab)
    d2._corpus = None
    assert d2._expected_counts(wf) == want._expected_counts(wf)
    assert d2.rounds[-1]["route"] == "host" and d2.rounds[-1]["reason"] == "int32 piece mass"


def test_stage_keeps_over_wide_on_the_host_and_maps_places():
    """The staged corpus: sentences over 128 characters stay on the host,
    the others packed by length with their frequencies and places."""
    texts = ["x" * 129, "ab", "abc" * 42, "b", "ab"]
    t = DistributedUnigramTrainer(device="cpu")
    t._stage_corpus(Counter(texts))
    sentences, _chars, _offs, lens, freqs, gidx, groups, host_idx = t._corpus
    assert sentences == ["x" * 129, "ab", "abc" * 42, "b"] and host_idx == [0]
    assert gidx.tolist() == [3, 1, 2] and freqs.tolist() == [1, 2, 1]
    assert lens.tolist() == [1, 2, 126] and groups == (2, 2)


def test_world_size_two_equals_world_size_one(tmp_path):
    """Two processes over gloo (a ``file://`` store), each with half the
    sentences, learn what one process learns."""
    import time

    import torch.multiprocessing as mp

    ctx = mp.start_processes(torch_train_worker.run_world_member,
                             args=(str(tmp_path / "store"), 2, str(tmp_path), "unigram"),
                             nprocs=2, join=False, start_method="spawn")
    deadline = time.monotonic() + 240
    while not ctx.join(timeout=5):  # raises if a member failed
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise AssertionError("the two processes did not finish in 240 s")
    want = torch_train_worker.train_unigram()
    for rank in range(2):
        with open(tmp_path / f"rank{rank}.json") as f:
            assert json.load(f) == json.loads(json.dumps(want)), rank
    host = JaxHost(JaxConfig(vocab_size=60, n_iterations=4, max_piece_length=6,
                             initial_vocab_size=400))
    host.train_from_texts(torch_train_worker.UG_TEXTS)
    assert [list(p) for p in host.vocab] == want[0]["vocab"]

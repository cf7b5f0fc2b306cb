"""The word-level models of the port (``models/``) and their device tiers'
plain versions (K9 ``merge_word_rows``, K10 ``wordpiece_match``, K11
``wordlevel_lookup``) against the JAX package: host methods, tables,
``encode_batch(device="cpu")``, and the tiers' outputs, counts and poison
lists on the same numpy inputs, exactly."""

import numpy as np
import pytest

from helpers import trained_tokenizer_json

jax = pytest.importorskip("jax")

import json  # noqa: E402

import torch  # noqa: E402

from complexity_tokenizer_tpu import models as JM  # noqa: E402
from complexity_tokenizer_tpu.ops import stringbpe_device as JS  # noqa: E402
from complexity_tokenizer_tpu.ops import wordpiece_device as JW  # noqa: E402
from complexity_tokenizer_tpu.ops.merge import merge_word_rows as jax_merge_word_rows  # noqa: E402
from complexity_tokenizer_tpu_torch import models as M  # noqa: E402
from complexity_tokenizer_tpu_torch.ops import stringbpe_device as S  # noqa: E402
from complexity_tokenizer_tpu_torch.ops import wordpiece_device as W  # noqa: E402
from complexity_tokenizer_tpu_torch.ops.merge import merge_word_rows, merge_word_rows_plain  # noqa: E402
from complexity_tokenizer_tpu_torch.utils.bytelevel import bytes_to_unicode  # noqa: E402
from complexity_tokenizer_tpu_torch.utils.corpus import (  # noqa: E402
    RUN_BREAKS,
    bert_scale_wordpiece_vocab,
    run_rows,
    wordlevel_vocab,
    zipf_corpus,
)

# ---------------------------------------------------------------------------
# the models of tests/test_models_trainers.py, built in both packages


def _wordpiece_vocab():
    rng = np.random.RandomState(9)
    vocab = {"[UNK]": 0}
    pieces = set()
    for _ in range(400):
        n = rng.randint(1, 6)
        pieces.add("".join(rng.choice(list("abcdeé日")) for _ in range(n)))
    for p in sorted(pieces):
        vocab.setdefault(p, len(vocab))
        vocab.setdefault("##" + p, len(vocab))
    return vocab


def _wordlevel_vocab():
    rng = np.random.RandomState(4)
    words = sorted({"".join(rng.choice(list("abcé日")) for _ in range(rng.randint(1, 9)))
                    for _ in range(300)})
    vocab = {"<unk>": 0}
    for w in words:
        vocab.setdefault(w, len(vocab))
    return vocab


def _charbpe_args():
    merges = [("l", "o"), ("lo", "w</w>"), ("e", "r</w>"), ("w", "e"),
              ("lo", "w"), ("n", "e"), ("ne", "w</w>"), ("we", "er</w>"),
              ("l", "l"), ("ll", "ll"), ("o", "o</w>")]
    vocab = {"<unk>": 0}
    for sym in "lowernstuv":
        vocab.setdefault(sym, len(vocab))
        vocab.setdefault(sym + "</w>", len(vocab))
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    return vocab, merges


def _bytelevel_args():
    enc = bytes_to_unicode()
    A = [enc[ord(c)] for c in "helowrd"]
    SP = enc[ord(" ")]
    merges = [(A[0], A[1]), (A[0] + A[1], A[2]), (SP, A[0]),
              (A[3], A[4]), (A[5], A[6]), (A[2], A[2]), (A[2] + A[2], A[2] + A[2])]
    vocab = {"<unk>": 0}
    for ch in sorted(set("".join(a + b for a, b in merges)) | set(A) | {SP}):
        vocab.setdefault(ch, len(vocab))
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    return vocab, merges


def _trained_args():
    """The 800-entry byte-level tokenizer of the shared fixtures, as a
    ByteLevel BPE model's vocabulary and merges."""
    model = json.loads(trained_tokenizer_json())["model"]
    merges = [tuple(m.split(" ")) if isinstance(m, str) else tuple(m) for m in model["merges"]]
    return model["vocab"], merges


MODELS = {
    "wordpiece": lambda P: P.WordPieceModel(_wordpiece_vocab()),
    "wordpiece_no_unk": lambda P: P.WordPieceModel({"ab": 0, "##c": 1, "a": 2, "##b": 3}),
    "wordpiece_literal": lambda P: P.WordPieceModel(
        {"[UNK]": 0, "#": 1, "##abc": 2, "a": 3, "b": 4, "c": 5, "##b": 6, "##c": 7, "##a": 8,
         "##1": 9, "1": 10, "##": 11}),
    "wordpiece_short_limit": lambda P: P.WordPieceModel(_wordpiece_vocab(),
                                                        max_input_chars_per_word=9),
    "wordlevel": lambda P: P.WordLevelModel(_wordlevel_vocab()),
    "charbpe": lambda P: P.CharBpeModel(*_charbpe_args()),
    "bytelevel": lambda P: P.ByteLevelBpeModel(*_bytelevel_args()),
    "bytelevel_trained": lambda P: P.ByteLevelBpeModel(*_trained_args()),
    "bytelevel_no_prefix": lambda P: P.ByteLevelBpeModel(*_bytelevel_args(),
                                                         add_prefix_space=False),
}


def _texts(seed: int) -> list[str]:
    """Fuzz texts: short words over the models' alphabets and others, runs
    of equal symbols, whitespace runs, and words over the lanes and over
    WordPiece's limit."""
    rng = np.random.RandomState(seed)
    alphabet = list("abcdeé日lowernstzh '!.1")
    texts = [
        " ".join("".join(rng.choice(alphabet) for _ in range(rng.randint(1, 12)))
                 for _ in range(rng.randint(0, 8)))
        for _ in range(100)
    ]
    runs = ["l" * 9, "lllll lllllll", "o" * 12, "ll" * 7 + "o", "aaaa" * 5, "d" * 33,
            "##abc ##1 a##1 x##abc #", "hello world", "  double  spaces  ", " lead", "trail "]
    return texts + runs + ["", " ", "x" * 150, "a" * 100, "a" * 101, "ab" * 70, "l" * 130]


@pytest.mark.parametrize("name", sorted(MODELS))
def test_host_methods_equal_jax(name):
    ours, theirs = MODELS[name](M), MODELS[name](JM)
    texts = _texts(1)
    assert [ours.encode(t) for t in texts] == [theirs.encode(t) for t in texts]
    if hasattr(theirs, "tokenize_word"):
        words = sorted({w for t in texts for w in t.split()})
        assert [ours.tokenize_word(w) for w in words] == [theirs.tokenize_word(w) for w in words]
    rng = np.random.RandomState(2)
    ids = [rng.randint(-1, ours.vocab_size + 3, size=rng.randint(0, 12)).tolist()
           for _ in range(30)]
    assert [ours.decode(i) for i in ids] == [theirs.decode(i) for i in ids]
    assert ours.vocab_size == theirs.vocab_size
    for tok in list(theirs.vocab)[:20] + ["missing"]:
        assert ours.token_to_id(tok) == theirs.token_to_id(tok)
    for i in range(-1, ours.vocab_size + 2):
        assert ours.id_to_token(i) == theirs.id_to_token(i)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_encode_batch_equals_jax_and_host(name):
    """``encode_batch(device="cpu")`` (the tiers' plain versions) equals
    JAX's ``encode_batch`` and the host ``encode`` of every text."""
    ours, theirs = MODELS[name](M), MODELS[name](JM)
    texts = _texts(7)
    got = ours.encode_batch(texts, device="cpu")
    assert got == [ours.encode(t) for t in texts]
    assert got == theirs.encode_batch(texts)
    assert ours.last_route == "device"
    assert ours.last_stats["words"] > 0
    assert ours.encode_batch([], device="cpu") == []


def test_encode_batch_counts_host_words():
    """Words over 128 lanes take the host (ByteLevel, CharBPE) or UNK
    (WordLevel); WordPiece re-tokenizes those within its limit."""
    cb = MODELS["charbpe"](M)
    cb.encode_batch(["low " + "l" * 130], device="cpu")
    assert cb.last_stats == {"words": 2, "over_width": 1, "poisoned": 0, "host": 1}
    wp = M.WordPieceModel(_wordpiece_vocab(), max_input_chars_per_word=200)
    texts = ["abc " + "a" * 150, "a" * 250]
    assert wp.encode_batch(texts, device="cpu") == [wp.encode(t) for t in texts]
    assert wp.last_stats["over_width"] == 2 and wp.last_stats["host"] == 2
    wl = M.WordLevelModel(_wordlevel_vocab())
    texts = ["the " + "a" * 130, "the"]
    assert wl.encode_batch(texts, device="cpu") == [wl.encode(t) for t in texts]
    assert wl.last_stats == {"words": 2, "over_width": 1, "poisoned": 0, "host": 1}


def test_wordpiece_over_limit_past_the_lanes_is_unk():
    """A word over both the lanes and a limit of 128 or more is one UNK,
    as on the host.  (The JAX tier matches its first 128 characters
    instead: it decides the limit on the truncated length.)"""
    ours = M.WordPieceModel(_wordpiece_vocab(), max_input_chars_per_word=200)
    word = "ab" * 130
    assert ours.encode_batch([word], device="cpu") == [[0]] == [ours.encode(word)]
    theirs = JM.WordPieceModel(_wordpiece_vocab(), max_input_chars_per_word=200)
    assert theirs.encode_batch([word]) != [[0]]


def test_ineligible_tables_stay_on_the_host():
    """A table the tier cannot take (its build returns None, as in JAX)
    runs on the host; ``last_route`` says so."""
    merges = [("x", "ab"), ("a", "b"), ("ab", "c")]  # "ab" used before it is made: ill-formed
    vocab = {"<unk>": 0, "a": 1, "b": 2, "c": 3, "x": 4, "ab": 5, "abc": 6, "xab": 7}
    rank = {(a, b): r for r, (a, b) in enumerate(merges)}
    assert S.build_string_bpe_device(rank, "cpu") is None
    assert JS.build_string_bpe_device(rank) is None
    texts = ["abc xab", "ab x", ""]
    for ours, theirs in (
        (M.CharBpeModel(vocab, merges), JM.CharBpeModel(vocab, merges)),
        (M.WordLevelModel({"": 0, "a": 1}), JM.WordLevelModel({"": 0, "a": 1})),
        (M.WordPieceModel({}), JM.WordPieceModel({})),
    ):
        assert ours.encode_batch(texts, device="cpu") == theirs.encode_batch(texts)
        assert ours.last_route == "host"
    empty = M.CharBpeModel(vocab, [])  # no merges: no table
    assert empty.encode_batch(["ab"], device="cpu") == [[1, 0]] == [empty.encode("ab")]
    assert empty.last_route == "host"


# ---------------------------------------------------------------------------
# K9's plain version and its tables


@pytest.mark.parametrize("name", ["charbpe", "bytelevel", "bytelevel_trained"])
def test_string_tables_equal_jax(name):
    rank = MODELS[name](M).merge_ranks
    ours, theirs = S.build_string_bpe_device(rank, "cpu"), JS.build_string_bpe_device(rank)
    assert ours.sym_id == theirs.sym_id and ours.symbols == theirs.symbols
    assert np.array_equal(ours.chd.disp, theirs.chd.disp)
    assert np.array_equal(ours.chd.rows, theirs.chd.rows)
    assert (ours.chd.size, ours.chd.n_buckets) == (theirs.chd.size, theirs.chd.n_buckets)


def _symbol_rows(dev, rng, n: int) -> np.ndarray:
    """[n, 128] symbol ids: random words over the table's single-character
    symbols, ids past the universe, runs of one symbol, tombstones inside
    rows, empty and full rows."""
    singles = [i for s, i in dev.sym_id.items() if len(s) == 1]
    base = len(dev.symbols)
    tokens = np.full((n, 128), -1, np.int32)
    for r in range(n):
        kind = r % 6
        if kind == 5:
            continue
        k = 128 if kind == 4 else rng.randint(1, 40)
        if kind == 1:
            row = [singles[rng.randint(len(singles))]] * k
        else:
            row = [singles[rng.randint(len(singles))] for _ in range(k)]
        if kind == 2:
            row[rng.randint(k)] = base + rng.randint(3)
        tokens[r, :k] = row
        if kind == 3:
            tokens[r, rng.randint(k)] = -1
    return tokens


@pytest.mark.parametrize("name", ["charbpe", "bytelevel", "bytelevel_trained"])
def test_merge_word_rows_plain_equals_jax(name):
    dev = S.build_string_bpe_device(MODELS[name](M).merge_ranks, "cpu")
    tokens = _symbol_rows(dev, np.random.RandomState(5), 48)
    # the rows that separate the greedy apply from the JAX rule, as words of
    # byte-level symbols
    enc = bytes_to_unicode()
    text = " ".join(zipf_corpus(20, seed=4)).encode()
    for breaks in (False, True):
        # the breakers as symbols no merge names (ids past the universe)
        runs = [[enc[b] + ("\0" if b in RUN_BREAKS else "") for b in r]
                for r in run_rows(text, 8, 128, breaks)]
        tokens = np.concatenate([tokens, dev.pack(runs)[0]])
    exp_t, exp_c = jax_merge_word_rows(tokens, dev.chd.disp, dev.chd.rows, dev.chd.size,
                                       dev.chd.n_buckets)
    args = (torch.from_numpy(dev.chd.disp), torch.from_numpy(dev.chd.rows), dev.chd.size,
            dev.chd.n_buckets)
    got_t, got_c = merge_word_rows_plain(torch.from_numpy(tokens), *args)
    assert np.array_equal(got_t.numpy(), np.asarray(exp_t))
    assert np.array_equal(got_c.numpy(), np.asarray(exp_c))
    assert (got_c.numpy() < (tokens >= 0).sum(1)).any()  # merges happened
    w_t, w_c = merge_word_rows(torch.from_numpy(tokens), *args)  # the wrapper on the CPU
    assert torch.equal(w_t, got_t) and torch.equal(w_c, got_c)


# ---------------------------------------------------------------------------
# K10 and K11: tables and plain versions against the JAX _fn


def _pack_words(words: list[str], lanes: int = 128):
    """The JAX tier's packing: codepoints, -1 padded; lengths cut to the
    lanes."""
    chars = np.full((len(words), lanes), -1, np.int32)
    lens = np.zeros(len(words), np.int32)
    for i, w in enumerate(words):
        cps = [ord(c) for c in w][:lanes]
        chars[i, : len(cps)] = cps
        lens[i] = len(cps)
    return chars, lens


def _tables_equal(ours, theirs):
    assert np.array_equal(ours.chd.disp, theirs.chd.disp)
    assert np.array_equal(ours.chd.rows, theirs.chd.rows)
    for f in ("token_chars", "token_lens", "emit_ids"):
        assert np.array_equal(getattr(ours, f), getattr(theirs, f)), f
    for f in ("max_token_len", "unk_id", "max_input_chars"):
        assert getattr(ours, f) == getattr(theirs, f), f


def _tiers_args(tables):
    t = torch.from_numpy
    return (t(tables.chd.disp), t(tables.chd.rows), tables.chd.size, tables.chd.n_buckets,
            t(tables.token_chars), t(tables.token_lens), t(tables.emit_ids), tables.unk_id)


def _corrupt(tables, n: int):
    """Change one character of the first ``n`` slots' spellings: their hits
    fail the exact check (the same corruption in both packages)."""
    tc = tables.token_chars.copy()
    tc[:n, 0] += 1
    tables.token_chars = tc
    return tables


WP_CASES = ["wordpiece", "wordpiece_no_unk", "wordpiece_literal", "wordpiece_short_limit",
            "poisoned"]


@pytest.mark.parametrize("case", WP_CASES + ["narrow rows"])
def test_wordpiece_match_plain_equals_jax(case):
    name = "wordpiece" if case in ("poisoned", "narrow rows") else case
    ours_t = W.build_wordpiece_tables(MODELS[name](M))
    theirs_t = JW.build_wordpiece_tables(MODELS[name](JM))
    _tables_equal(ours_t, theirs_t)
    if case == "poisoned":
        ours_t, theirs_t = _corrupt(ours_t, 40), _corrupt(theirs_t, 40)
    texts = _texts(3)
    words = sorted({w for t in texts for w in t.split()}) + ["", "a" * 128, "é" * 129]
    chars, lens = _pack_words(words)
    if case == "narrow rows":  # 40 lanes, lengths past them
        chars = np.ascontiguousarray(chars[:, :40])
    exp_out, exp_count, exp_poison = JW.WordPieceDevice(theirs_t)._fn(chars, lens)
    out, count, poison = W.wordpiece_match_plain(
        torch.from_numpy(chars), torch.from_numpy(lens), *_tiers_args(ours_t),
        ours_t.max_input_chars)
    assert np.array_equal(out.numpy(), np.asarray(exp_out))
    assert np.array_equal(count.numpy(), np.asarray(exp_count))
    assert np.array_equal(poison.numpy(), np.asarray(exp_poison))
    assert (case == "poisoned") == bool(poison.any())
    if case == "narrow rows":
        return
    # the tier's word lists and poison lists, against JAX's tokenize_words
    ours_dev, theirs_dev = W.WordPieceDevice(ours_t, "cpu"), JW.WordPieceDevice(theirs_t)
    fit = [w for w in words if len(w) <= 128]
    assert ours_dev.tokenize_words(fit) == theirs_dev.tokenize_words(fit)
    assert ours_dev.last_poisoned == theirs_dev.last_poisoned


@pytest.mark.parametrize("lanes", [128, 40])
def test_wordlevel_lookup_plain_equals_jax(lanes):
    ours_t = W.build_wordlevel_tables(MODELS["wordlevel"](M))
    theirs_t = JW.build_wordlevel_tables(MODELS["wordlevel"](JM))
    _tables_equal(ours_t, theirs_t)
    vocab = _wordlevel_vocab()
    words = list(vocab)[:60] + ["zzz", "missing", "日日日日", "", "a" * 128]
    chars, lens = _pack_words(words)
    # -1 entries inside a row are skipped by the hash (and fail the check),
    # and lengths that disagree with the row
    chars[3, 1] = -1
    lens[4] += 1
    lens[5] = 0
    chars = np.ascontiguousarray(chars[:, :lanes])
    exp = JW.WordLevelDevice(theirs_t)._fn(chars, lens)
    args = _tiers_args(ours_t)
    got = W.wordlevel_lookup_plain(torch.from_numpy(chars), torch.from_numpy(lens), *args)
    assert np.array_equal(got.numpy(), np.asarray(exp))
    same = W.wordlevel_lookup(torch.from_numpy(chars), torch.from_numpy(lens), *args)
    assert torch.equal(same, got)
    assert (got.numpy() == 0).sum() >= 4 and (got.numpy() == -1).sum() == 2
    if lanes < 128:
        return
    assert W.WordLevelDevice(ours_t, "cpu").lookup_words(words) == JW.WordLevelDevice(
        theirs_t).lookup_words(words)


def test_rolling_prefix_hashes_equal_jax():
    chars, _lens = _pack_words(["abc", "é日z" * 10, "", "x" * 128])
    ours = W.rolling_prefix_hashes(torch.from_numpy(chars))
    theirs = JW.rolling_prefix_hashes(jax.numpy.asarray(chars))
    for a, b in zip(ours, theirs):
        assert np.array_equal(a.numpy(), np.asarray(b).astype(np.int64))
    assert W._poly_hash_np([97, 98], W._B1, 0) == int(JW._poly_hash_np([97, 98], JW._B1,
                                                                       np.uint32(0)))


# ---------------------------------------------------------------------------
# the full-width vocabularies


def test_full_width_vocabularies():
    """bert-base-uncased's size and the WordLevel vocabulary; a slice of the
    corpus through both models on the CPU equals the host."""
    bert = bert_scale_wordpiece_vocab()
    assert len(bert) == 30_522 and list(bert)[:5] == ["[PAD]", "[UNK]", "[CLS]", "[SEP]",
                                                      "[MASK]"]
    assert sorted(bert.values()) == list(range(30_522))
    wl = wordlevel_vocab()
    assert len(wl) == 40_001 and wl["<unk>"] == 0
    texts = zipf_corpus(30, seed=17) + ["naïve café 日本語 ##x [UNK]"]
    wp = M.WordPieceModel(bert)
    assert wp.encode_batch(texts, device="cpu") == [wp.encode(t) for t in texts]
    lv = M.WordLevelModel(wl)
    got = lv.encode_batch(texts, device="cpu")
    assert got == [lv.encode(t) for t in texts]
    assert 0 in {i for r in got for i in r}  # the tail words take UNK

"""The Unigram model and its device tier K12 (``models/unigram.py``,
``ops/unigram_device.py``) against the JAX package on the CPU, exactly: the
piece tables field by field, the plain Viterbi (``viterbi_plain``) against
``make_viterbi_fn`` in (out, count, poison), the ragged plain version
against the dense one, ``encode_batch`` against the JAX ``encode_batch`` and
the host ``tokenize``, the host methods, and ``__version__``.  Scores are
compared as float32 bit patterns."""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import torch  # noqa: E402

import complexity_tokenizer_tpu as J  # noqa: E402
import complexity_tokenizer_tpu_torch as P  # noqa: E402
from complexity_tokenizer_tpu.models.unigram import UnigramModel as JaxUnigram  # noqa: E402
from complexity_tokenizer_tpu.ops import unigram_device as JD  # noqa: E402
from complexity_tokenizer_tpu_torch.models import UnigramModel  # noqa: E402
from complexity_tokenizer_tpu_torch.ops import unigram_device as D  # noqa: E402
from complexity_tokenizer_tpu_torch.utils.corpus import (  # noqa: E402
    MULTI_PIECES,
    metaspace_pieces,
    unigram_32k_vocab,
    unigram_edge_texts,
    zipf_corpus,
)

_W = 128
# every dense case is padded to this many rows for JAX, so that one compile
# serves a table and a maxcand
_JAX_ROWS = 512


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many ops on small tensors: with the test
    workers sharing the machine, torch's intra-op threads only wait on each
    other (one thread runs these tests many times faster under load)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fuzz_vocab():
    """The fuzz vocabulary of the JAX package's device test
    (``tests/test_models_trainers.py``): pieces of 1-4 characters of
    ``abxé日``, scores uniform in [-8, -1]."""
    rng = np.random.RandomState(6)
    pieces = sorted({"".join(rng.choice(list("abxé日")) for _ in range(rng.randint(1, 5)))
                     for _ in range(150)})
    return [("<unk>", -10.0)] + [(p, float(-rng.uniform(1, 8))) for p in pieces]


def _fuzz_texts():
    rng = np.random.RandomState(6)
    texts = ["".join(rng.choice(list("abxézq日")) for _ in range(rng.randint(0, 35)))
             for _ in range(250)]
    return texts + ["", "q", "qq", "a" * 120, "ab" * 60]


# equal totals in any precision: 'aa' as [a][a] or [aa]
_TIE_VOCAB = [("<unk>", -10.0), ("a", -2.0), ("aa", -4.0)]


@functools.lru_cache(maxsize=None)
def _vocab(name: str):
    if name == "fuzz":
        return _fuzz_vocab()
    if name == "tie":
        return list(_TIE_VOCAB)
    if name == "32k":
        return unigram_32k_vocab()
    raise KeyError(name)


@functools.lru_cache(maxsize=None)
def _corpus_pieces() -> list[str]:
    """A few hundred distinct ``▁word`` pieces of the benchmark corpus, with
    its multilingual pieces."""
    pieces = sorted(set(metaspace_pieces(zipf_corpus(60, seed=17) + list(MULTI_PIECES))))
    return pieces[:400]


def _texts(case: str) -> list[str]:
    if case == "fuzz":
        return _fuzz_texts()
    if case == "tie":
        return ["aaaa", "aa", "aaa", "a", "", "a" * 127, "a" * 128, "ba", "aab"]
    if case == "edge lengths":
        letters = "abxé日"
        rng = np.random.RandomState(3)
        return ["", "a", "q", "日"] + ["".join(rng.choice(list(letters), n))
                                        for n in (127, 128, 127, 128, 64, 33)]
    if case == "missing characters":
        return ["qqq", "zq", "\x00", "aあb", "日z日", "ééz", "\U0001f600ab"]
    if case == "corpus pieces":
        return _corpus_pieces()
    if case == "lane-group edges":
        # exactly 8, 9, 16, 17 and 128 characters (K12's groups of 8 and 16
        # lanes and the warp's width), and 7 and 15: random letters, one
        # repeated letter (exact ties), a run of the corpus pieces
        rng = np.random.RandomState(8)
        joined = "".join(_corpus_pieces())
        texts = []
        for n in (8, 9, 16, 17, 128, 7, 15):
            start = rng.randint(len(joined) - n)
            texts += ["".join(rng.choice(list("abxé日"), n)), "a" * n, joined[start:start + n]]
        return texts
    raise KeyError(case)


# (text case, vocabulary)
CASES = [("fuzz", "fuzz"), ("tie", "tie"), ("edge lengths", "fuzz"),
         ("missing characters", "fuzz"), ("corpus pieces", "32k"),
         ("lane-group edges", "fuzz"), ("lane-group edges", "32k")]
# maxcand: the longest piece, under it, and the trainer's max_piece_length
MAXCANDS = ["Lt", 3, 16]
# the fallback marker: JAX's -2, or the table's UNK id (a live id)
MARKERS = ["-2", "unk"]


def _marker(name: str, tables) -> int:
    return D.FALLBACK_ID if name == "-2" else int(tables[5])


def _dense(texts: list[str], rows: int = _JAX_ROWS):
    chars = np.full((rows, _W), -1, np.int32)
    lens = np.zeros(rows, np.int32)
    for i, t in enumerate(texts):
        cps = [ord(c) for c in t]
        assert len(cps) <= _W
        chars[i, : len(cps)] = cps
        lens[i] = len(cps)
    return chars, lens


@functools.lru_cache(maxsize=None)
def _jax_tables(name: str):
    return JD.build_unigram_tables(JaxUnigram(_vocab(name)))


@functools.lru_cache(maxsize=None)
def _jax_viterbi(size: int, n_buckets: int, Lt: int, maxcand: int):
    return jax.jit(JD.make_viterbi_fn(size, n_buckets, Lt, maxcand))


@functools.lru_cache(maxsize=None)
def _jax_dense_viterbi(case: str, vocab: str, maxcand: int):
    """JAX's (out, count, poison) on a text case's dense rows, once for
    every fallback marker the tests map it to."""
    chd, pc, pl, ps, Lt, _unk, ms = _jax_tables(vocab)
    chars, lens = _dense(_texts(case))
    return tuple(np.asarray(x) for x in _jax_viterbi(chd.size, chd.n_buckets, Lt, maxcand)(
        chd.disp, chd.rows, pc, pl, ps, np.float32(ms), chars, lens))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _plain_args(tables, maxcand):
    chd, pc, pl, ps, _Lt, _unk, ms = tables
    return (_t(chd.disp), _t(chd.rows), chd.size, chd.n_buckets, _t(pc), _t(pl), _t(ps), ms,
            maxcand)


# ---------------------------------------------------------------------------
# tables


def _assert_tables_equal(got, exp):
    assert (got is None) == (exp is None)
    if got is None:
        return
    gchd, *grest = got
    echd, *erest = exp
    assert (gchd.size, gchd.n_buckets) == (echd.size, echd.n_buckets)
    np.testing.assert_array_equal(gchd.disp, echd.disp)
    np.testing.assert_array_equal(gchd.rows, echd.rows)
    gc, gl, gs, gLt = grest[:4]
    ec, el, es, eLt = erest[:4]
    assert gLt == eLt
    np.testing.assert_array_equal(gc, ec)
    np.testing.assert_array_equal(gl, el)
    assert gs.dtype == es.dtype == np.float32
    np.testing.assert_array_equal(gs.view(np.int32), es.view(np.int32))  # bit patterns
    assert grest[4:] == erest[4:]  # unk_id, min_score


def _pieces_of(name: str):
    if name == "piece over 128 characters":
        return {"a": (0, -1.0), "b" * 129: (1, -2.0)}
    if name == "empty map":
        return {}
    if name == "piece of 128 characters":
        return {"a": (0, -1.0), "b" * 128: (1, -2.0)}
    if name == "empty piece and id gaps":
        return {"": (0, -1.0), "ab": (3, -2.5), "c": (7, -0.125)}
    return JaxUnigram(_vocab(name)).vocab


@pytest.mark.parametrize("name", ["fuzz", "tie", "32k", "piece over 128 characters", "empty map",
                                  "piece of 128 characters", "empty piece and id gaps"])
def test_build_piece_tables_equal_jax(name):
    pieces = _pieces_of(name)
    got = D.build_piece_tables(pieces)
    _assert_tables_equal(got, JD.build_piece_tables(pieces))
    assert (got is None) == (name in ("piece over 128 characters", "empty map"))


@pytest.mark.parametrize("name", ["fuzz", "tie", "32k"])
def test_build_unigram_tables_equal_jax(name):
    _assert_tables_equal(D.build_unigram_tables(UnigramModel(_vocab(name))), _jax_tables(name))


def test_full_width_table_geometry():
    """The committed table: t5-base's 32,000 pieces, the CHD geometry and
    longest piece the device tier runs at."""
    vocab = unigram_32k_vocab()
    assert len(vocab) == 32_000 and len({p for p, _ in vocab}) == 32_000
    assert vocab[-3:] == [("<unk>", -100.0), ("<s>", -100.0), ("</s>", -100.0)]
    chd, _pc, _pl, _ps, Lt, unk, ms = D.build_unigram_tables(UnigramModel(vocab))
    assert (chd.size, chd.n_buckets, Lt, unk, ms) == (65_536, 16_384, 13, 31_997, -110.0)


def test_weights_carried_across_from_the_jax_model():
    """A port model built from the JAX model's ``(piece, score)`` list, with
    numpy float scores, gives the JAX tables and the same segmentation."""
    jm = JaxUnigram(_vocab("32k"))
    carried = [(jm.vocab_r[i], np.float64(jm.vocab[jm.vocab_r[i]][1]))
               for i in range(len(jm.vocab_r))]
    pm = UnigramModel(carried)
    _assert_tables_equal(D.build_unigram_tables(pm), _jax_tables("32k"))
    texts = _corpus_pieces()[:100]
    assert pm.encode_batch(texts, device="cpu") == [jm.tokenize(t) for t in texts]


# ---------------------------------------------------------------------------
# the plain Viterbi against make_viterbi_fn


@pytest.mark.parametrize("marker", MARKERS)
@pytest.mark.parametrize("maxcand", MAXCANDS)
@pytest.mark.parametrize("case,vocab", CASES)
def test_viterbi_plain_equals_jax(case, vocab, maxcand, marker):
    """Against JAX's program, whose fallbacks carry -2: under another
    marker, its -2 entries are that marker (as the JAX model maps them)."""
    tables = _jax_tables(vocab)
    Lt = tables[4]
    mc = Lt if maxcand == "Lt" else maxcand
    fid = _marker(marker, tables)
    chars, lens = _dense(_texts(case))
    exp = _jax_dense_viterbi(case, vocab, mc)
    exp = [np.where(exp[0] == JD.FALLBACK_ID, fid, exp[0])] + list(exp[1:])
    got = D.viterbi_plain(_t(chars), _t(lens), *_plain_args(tables, mc), fallback_id=fid)
    for g, e, what in zip(got, exp, ("out", "count", "poison")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(e), err_msg=what)
    out = got[0].numpy()
    # fallbacks carry the marker; the tie vocabulary's ties are poisoned
    if case == "missing characters":
        assert (out == fid).any()
    if case == "tie":
        assert got[2][0] and got[2][1]


def test_viterbi_plain_other_fallback_marker():
    """The marker is an argument: a marker that is a live id changes only
    the fallbacks' entries, not which ends are checked or how far the
    backtrack steps."""
    tables = _jax_tables("fuzz")
    chars, lens = _dense(_texts("missing characters") + _texts("fuzz")[:40])
    a = D.viterbi_plain(_t(chars), _t(lens), *_plain_args(tables, tables[4]))
    b = D.viterbi_plain(_t(chars), _t(lens), *_plain_args(tables, tables[4]), fallback_id=0)
    fb = a[0] == D.FALLBACK_ID
    assert bool(fb.any())
    assert torch.equal(torch.where(fb, 0, a[0]), b[0])
    assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])


# ---------------------------------------------------------------------------
# the ragged plain version and the tier's packing


@pytest.mark.parametrize("marker", MARKERS)
@pytest.mark.parametrize("maxcand", MAXCANDS)
@pytest.mark.parametrize("case,vocab", CASES)
def test_ragged_plain_equals_dense(case, vocab, maxcand, marker):
    tables = D.build_unigram_tables(UnigramModel(_vocab(vocab)))
    tier = D.UnigramDevice(tables, "cpu")
    mc = tier.Lt if maxcand == "Lt" else maxcand
    fid = _marker(marker, tables)
    texts = _texts(case)
    chars, offs, lens, order, groups, host = tier.pack(texts)
    res = D.viterbi(_t(chars), _t(offs), _t(lens), groups, *tier.args(mc), fallback_id=fid)
    out, count, poison = D.split_viterbi(res, len(texts))
    dchars, dlens = _dense([texts[i] for i in order], rows=len(texts))
    exp = D.viterbi_plain(_t(dchars), _t(dlens), *tier.args(mc), fallback_id=fid)
    assert host == []
    for j in range(len(texts)):
        n = offs[j + 1] - offs[j]
        assert torch.equal(out[offs[j]:offs[j + 1]], exp[0][j, :n])
    assert torch.equal(count, exp[1]) and torch.equal(poison, exp[2])


def test_pack_orders_by_length_and_leaves_wide_texts_to_the_host():
    tier = D.UnigramDevice(D.build_unigram_tables(UnigramModel(_vocab("fuzz"))), "cpu")
    texts = ["abc", "x" * 129, "", "日é", "b" * 128, "a"]
    chars, offs, lens, order, groups, host = tier.pack(texts)
    assert order.tolist() == [1, 2, 5, 3, 0, 4] and host == [1]
    assert lens.tolist() == [0, 0, 1, 2, 3, 128]
    assert offs.tolist() == [0, 0, 0, 1, 3, 6, 134]
    assert chars[1:3].tolist() == [ord("日"), ord("é")]
    assert groups == (5, 5)  # five texts of at most 8 characters, none of 9-16
    # a text longer than its slots is refused by the plain version
    with pytest.raises(ValueError, match="slots"):
        D.viterbi(_t(chars), _t(offs), _t(lens + 1), groups, *tier.args())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pack_groups_against_the_slots(seed):
    """``pack`` on random texts of 0-140 characters, against a brute force:
    a stable order by slots, the offsets, the lengths and characters of
    each packed text, and the lane groups: the texts [0, n8) have at most
    8 characters, [n8, n16) 9 to 16, the rest more (or none, wider than
    128: those go to the host)."""
    tier = D.UnigramDevice(D.build_unigram_tables(UnigramModel(_vocab("fuzz"))), "cpu")
    rng = np.random.RandomState(seed)
    lengths = rng.choice([0, 1, 7, 8, 9, 15, 16, 17, 40, 128, 129, 140], size=300)
    texts = ["".join(rng.choice(list("abxé日😀"), n)) for n in lengths]
    chars, offs, lens, order, (n8, n16), host = tier.pack(texts)
    slots = [len(t) if len(t) <= _W else 0 for t in texts]
    assert order.tolist() == sorted(range(len(texts)), key=lambda i: slots[i])
    assert host == [i for i, t in enumerate(texts) if len(t) > _W]
    assert offs.tolist() == np.concatenate([[0], np.cumsum([slots[i] for i in order])]).tolist()
    for j, i in enumerate(order.tolist()):
        assert lens[j] == slots[i]
        assert chars[offs[j]:offs[j + 1]].tolist() == [ord(c) for c in texts[i]][:slots[i]]
    packed = [slots[i] for i in order]
    assert all(n <= 8 for n in packed[:n8])
    assert all(8 < n <= 16 for n in packed[n8:n16])
    assert all(n > 16 or n == 0 for n in packed[n16:]) and 0 not in packed[n8:]
    assert (n8, n16) == (sum(n <= 8 for n in slots), sum(n <= 16 for n in slots))


def test_edge_texts_of_the_full_width_table():
    """``utils/corpus.py:unigram_edge_texts`` (the card's edge cases) through
    the ragged plain version and the dense JAX program, at the longest
    piece, at maxcand 3 and at 16."""
    tables = _jax_tables("32k")
    chd, pc, pl, ps, Lt, _unk, ms = tables
    tier = D.UnigramDevice(D.build_unigram_tables(UnigramModel(_vocab("32k"))), "cpu")
    edge = [t for _case, texts in unigram_edge_texts(_vocab("32k")) for t in texts]
    assert any(len(t) == 129 for t in edge)
    chars, offs, lens, order, groups, host = tier.pack(edge)
    assert [len(edge[i]) for i in host] == [129]
    for mc in (Lt, 3, 16):
        out, count, poison = D.split_viterbi(
            D.viterbi(_t(chars), _t(offs), _t(lens), groups, *tier.args(mc)), len(edge))
        packed = [edge[i] for i in order]
        dchars, dlens = _dense([t if len(t) <= _W else "" for t in packed])
        exp = [np.asarray(x)[: len(edge)] for x in _jax_viterbi(chd.size, chd.n_buckets, Lt, mc)(
            chd.disp, chd.rows, pc, pl, ps, np.float32(ms), dchars, dlens)]
        for j in range(len(edge)):
            n = offs[j + 1] - offs[j]
            np.testing.assert_array_equal(out[offs[j]:offs[j + 1]].numpy(), exp[0][j, :n])
        np.testing.assert_array_equal(count.numpy(), exp[1])
        np.testing.assert_array_equal(poison.numpy(), exp[2])


# ---------------------------------------------------------------------------
# the model


@pytest.mark.parametrize("case,vocab", CASES + [("corpus pieces, repeated", "32k")])
def test_encode_batch_equals_jax_and_host(case, vocab):
    texts = _texts(case.split(",")[0])
    if case.endswith("repeated"):
        texts = texts[::3] + texts + ["x" * 200, texts[5]] * 3
    jm, pm = JaxUnigram(_vocab(vocab)), UnigramModel(_vocab(vocab))
    got = pm.encode_batch(texts, device="cpu")
    assert pm.last_route == "device"
    assert got == jm.encode_batch(texts) == [jm.tokenize(t) for t in texts]
    stats = pm.last_stats
    assert stats["texts"] == len(texts) and stats["distinct"] == len(set(texts))
    assert stats["host"] == stats["poisoned"] + stats["over_width"]
    assert stats["over_width"] == len({t for t in texts if len(t) > _W})


def test_encode_batch_makes_one_tier_call(monkeypatch):
    """One ``viterbi`` call (on the card: one launch) an ``encode_batch``,
    over the batch's distinct texts."""
    calls = []
    real = D.viterbi

    def counted(chars, offs, lens, *args, **kw):
        calls.append(lens.numel())
        return real(chars, offs, lens, *args, **kw)

    monkeypatch.setattr(D, "viterbi", counted)
    pm = UnigramModel(_vocab("32k"))
    texts = _corpus_pieces()[:50] * 4
    assert pm.encode_batch(texts, device="cpu") == [pm.tokenize(t) for t in texts]
    assert calls == [50]


def test_ineligible_table_takes_the_host_route():
    vocab = [("<unk>", -10.0), ("a", -1.0), ("b" * 129, -2.0)]
    pm, jm = UnigramModel(vocab), JaxUnigram(vocab)
    texts = ["ab", "b" * 130, "", "aab"]
    assert pm.encode_batch(texts, device="cpu") == jm.encode_batch(texts)
    assert pm.last_route == "host"
    assert pm.last_stats == {"texts": 4, "distinct": 4, "host": 4, "poisoned": 0,
                             "over_width": 0}


@pytest.mark.parametrize("vocab", ["fuzz", "tie", "32k"])
def test_host_methods_equal_jax(vocab):
    """``tokenize``/``encode`` (the float64 DP; the port stops a start's scan
    at the longest piece, which changes nothing), ``decode``, the lookups,
    ``unk_id`` and ``min_score``."""
    v = _vocab(vocab)
    jm, pm = JaxUnigram(v), UnigramModel(v)
    rng = np.random.RandomState(len(vocab))
    texts = _texts("fuzz" if vocab != "32k" else "corpus pieces")[:150]
    texts += ["".join(rng.choice(list("abxé日q "), n)) for n in (150, 300)]
    for t in texts:
        assert pm.tokenize(t) == jm.tokenize(t) and pm.encode(t) == jm.encode(t)
    ids = [i for t in texts[:40] for i in jm.tokenize(t)] + [10**6, -1]
    assert pm.decode(ids) == jm.decode(ids)
    assert (pm.vocab_size, pm.unk_id, pm.min_score) == (jm.vocab_size, jm.unk_id, jm.min_score)
    for tok, _s in v[:50] + [("missing", 0.0)]:
        assert pm.token_to_id(tok) == jm.token_to_id(tok)
    for i in (0, 1, len(v) - 1, len(v), -3):
        assert pm.id_to_token(i) == jm.id_to_token(i)
    assert pm.vocab == jm.vocab and pm.vocab_r == jm.vocab_r


def test_unk_absent_defaults_to_id_0():
    v = [("a", -1.0), ("b", -2.0)]
    pm, jm = UnigramModel(v, unk_token="<missing>"), JaxUnigram(v, unk_token="<missing>")
    assert pm.unk_id == jm.unk_id == 0
    texts = ["abz", "zz", ""]
    assert pm.encode_batch(texts, device="cpu") == jm.encode_batch(texts)


def test_version_equals_jax():
    assert P.__version__ == J.__version__ == "0.5.0"
    assert "__version__" in P.__all__ and "UnigramModel" in P.__all__
    assert P.UnigramModel is UnigramModel

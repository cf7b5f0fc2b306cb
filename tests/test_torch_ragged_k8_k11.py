"""The ragged forms of K11 and K8 (``ops/wordpiece_device.py:wordlevel_lookup``,
``ops/normalize_device.py:norm_stable_rows``): their plain versions (the
wrappers on CPU tensors) against the JAX package's ``WordLevelDevice._fn``
and ``DeviceNormChecker._fn`` on the same words and rows laid out densely,
exactly; K11's packing, K8's per-block row index and its one-buffer pack."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import torch  # noqa: E402

from complexity_tokenizer_tpu import models as JM  # noqa: E402
from complexity_tokenizer_tpu.core import normalizers as JN  # noqa: E402
from complexity_tokenizer_tpu.ops import normalize_device as JND  # noqa: E402
from complexity_tokenizer_tpu.ops import wordpiece_device as JW  # noqa: E402
from complexity_tokenizer_tpu.ops.pipeline import pack_texts as jax_pack  # noqa: E402
from complexity_tokenizer_tpu_torch import models as M  # noqa: E402
from complexity_tokenizer_tpu_torch.core import normalizers as N  # noqa: E402
from complexity_tokenizer_tpu_torch.ops import normalize_device as ND  # noqa: E402
from complexity_tokenizer_tpu_torch.ops import wordpiece_device as W  # noqa: E402
from complexity_tokenizer_tpu_torch.utils.corpus import (  # noqa: E402
    MULTI_PIECES,
    norm_trap_bitmap,
    zipf_corpus,
)

# every case is padded to this many rows (and K8's to this width) for JAX,
# so that one compile serves all
_JAX_ROWS = 512
_JAX_WIDTH = 4096

# ---------------------------------------------------------------------------
# K11


def _letters(rng, n: int) -> str:
    return "".join(rng.choice(list("abcé日xyz")) for _ in range(n))


def _k11_vocab() -> dict:
    """A WordLevel vocabulary with entries of every length the cases probe
    (1-17 and 120-128 characters) and multilingual ones."""
    rng = np.random.RandomState(16)
    entries = sorted({_letters(rng, n) for n in list(range(1, 18)) * 12 + list(range(120, 129))})
    entries += ["naïve", "日本語", "Ünïcödé", "\U0001f600x", "ＡＢＣ", "á"]
    vocab = {"<unk>": 0}
    for e in entries:
        vocab.setdefault(e, len(vocab))
    return vocab


def _k11_words(case: str) -> list[str]:
    """The words of one edge case: vocabulary entries and misses around the
    lane groups' widths."""
    vocab = list(_k11_vocab())[1:]
    rng = np.random.RandomState(len(case))
    if case == "1 character":
        return [w for w in vocab if len(w) == 1] + ["q", "日", "\x00"]
    if case in ("8/9 characters", "16/17 characters"):
        a, b = (int(x) for x in case.split()[0].split("/"))
        hits = [w for w in vocab if len(w) in (a, b)]
        return hits + [_letters(rng, n) for n in (a, b) for _ in range(6)]
    if case == "128 characters":
        long = [w for w in vocab if len(w) >= 120]
        return long + ["x" * 128, "x" * 129, long[0] + "y", long[-1][:-1]]
    if case == "misses":
        return [w + "q" for w in vocab[:40]] + [w[:-1] for w in vocab[40:80] if len(w) > 1]
    if case == "empty word":
        return ["", vocab[0], "", "<unk>"]
    if case == "multilingual":
        return ["naïve", "日本語", "Ünïcödé", "\U0001f600x", "ＡＢＣ", "á", "á"] + [
            w for t in MULTI_PIECES for w in t.split()]
    if case == "corpus words":
        return sorted({w for t in zipf_corpus(12, seed=3) for w in t.split()})[:400] + vocab[::20]
    raise KeyError(case)


K11_CASES = ["1 character", "8/9 characters", "16/17 characters", "128 characters", "misses",
             "empty word", "multilingual", "corpus words"]


@pytest.fixture(scope="module")
def k11_tables():
    ours = W.build_wordlevel_tables(M.WordLevelModel(_k11_vocab()))
    theirs = JW.build_wordlevel_tables(JM.WordLevelModel(_k11_vocab()))
    assert ours is not None and theirs is not None
    return ours, JW.WordLevelDevice(theirs)


@pytest.mark.parametrize("case", K11_CASES)
def test_ragged_k11_plain_equals_jax(case, k11_tables):
    ours_t, theirs = k11_tables
    words = _k11_words(case)
    dev = W.WordLevelDevice(ours_t, "cpu")
    chars, offs, lens, order, groups, host = dev.pack(words)
    n = len(words)
    assert n <= _JAX_ROWS
    # JAX on the same words as 128-lane rows in the packed order, padded
    # with empty rows
    pc = np.full((_JAX_ROWS, 128), -1, np.int32)
    pl = np.zeros(_JAX_ROWS, np.int32)
    word = np.repeat(np.arange(n), np.diff(offs))
    pc[word, np.arange(len(chars)) - offs[:-1][word]] = chars
    pl[:n] = lens
    exp = np.asarray(theirs._fn(pc, pl))[:n]
    t = torch.from_numpy
    got = W.wordlevel_lookup(t(chars), t(offs), t(lens), groups, *dev.args())
    assert got.dtype == torch.int32 and got.numpy().tolist() == exp.tolist()
    plain = W.wordlevel_lookup_ragged_plain(t(chars), t(offs), t(lens), *dev.args())
    assert torch.equal(plain, got)
    # the tier against JAX's and the host lookup
    ids = dev.lookup_words(words)
    assert ids == theirs.lookup_words(words)
    model = M.WordLevelModel(_k11_vocab())
    assert ids == [model.vocab.get(w, 0) if w else -1 for w in words]
    assert dev.last_over_width == len(host) == sum(len(w) > 128 for w in words)
    if case not in ("misses",):
        assert (got.numpy() > 0).any()


@pytest.mark.parametrize("seed", range(4))
def test_wordlevel_pack_invariants(seed):
    """``WordLevelDevice.pack``: the words ordered by their slots (stable),
    offsets, one UTF-32 string of the characters, the groups of 8 and 16
    lanes, a word over 128 characters holding no slot and length 0."""
    rng = np.random.RandomState(seed)
    lengths = np.r_[rng.randint(0, 40, size=200), [0, 8, 9, 16, 17, 128, 129, 300]]
    rng.shuffle(lengths)
    words = [_letters(rng, int(n)) for n in lengths]
    dev = W.WordLevelDevice(W.build_wordlevel_tables(M.WordLevelModel(_k11_vocab())), "cpu")
    chars, offs, lens, order, groups, host = dev.pack(words)
    slots = np.where(lengths > 128, 0, lengths)
    assert np.array_equal(order, np.argsort(slots, kind="stable"))
    assert offs.dtype == np.int32 and offs[0] == 0 and np.array_equal(np.diff(offs), slots[order])
    assert np.array_equal(lens, slots[order]) and lens.dtype == np.int32
    assert chars.dtype == np.int32 and len(chars) == offs[-1]
    for j, i in enumerate(order.tolist()):
        w = words[i] if len(words[i]) <= 128 else ""
        assert chars[offs[j]:offs[j + 1]].tolist() == [ord(c) for c in w]
    n8, n16 = groups
    assert (lens[:n8] <= 8).all() and (lens[n8:n16] > 8).all() and (lens[n8:n16] <= 16).all()
    assert (lens[n16:] > 16).all()
    assert host == np.flatnonzero(lengths > 128).tolist()


def test_ragged_k11_refuses_a_word_over_the_lanes(k11_tables):
    dev = W.WordLevelDevice(k11_tables[0], "cpu")
    t = torch.from_numpy
    chars = np.zeros(129, np.int32)
    with pytest.raises(ValueError, match="more than 128"):
        W.wordlevel_lookup_ragged_plain(t(chars), t(np.array([0, 129], np.int32)),
                                        t(np.array([129], np.int32)), *dev.args())


# ---------------------------------------------------------------------------
# K8


def _k8_rows(case: str) -> list[bytes]:
    """The rows of one edge case."""
    rng = np.random.RandomState(len(case))
    cont = bytes([0xA9, 0xBF, 0x80])  # continuation-looking bytes
    text = " ".join(zipf_corpus(30, seed=5) + list(MULTI_PIECES)).encode()
    if case.startswith("truncated"):
        # rows that end in the first 1..n-1 bytes of an n-byte form; the next
        # row starts with continuation-looking bytes
        form = {"truncated 2-byte lead": "é", "truncated 3-byte lead": "中",
                "truncated 4-byte lead": "\U0001f601"}[case].encode()
        rows = []
        for k in range(1, len(form)):
            for lead in (b"", b"ab", b"x" * 15, b"y" * 126):
                rows += [lead + form[:k], cont[: 4 - k] + b"tail", form, lead + form]
        return rows
    if case == "empty rows":
        return [b"", b"", b"caf\xc3\xa9", b"", b"a\xcc\x81", b"", b"", b"plain", b""]
    if case == "rows of 128, 512 and 4,096 bytes":
        rows = []
        for L in (128, 512, 4096):
            body = (text * (L // len(text) + 1))[:L - 3]
            rows += [body + b"abc", body + "é".encode()[:1] + b"xy", body + "́".encode()]
        return rows
    if case == "random bytes":
        return [rng.randint(0, 256, size=rng.randint(0, 40)).astype(np.uint8).tobytes()
                for _ in range(200)]
    if case == "corpus rows":
        return [t.encode() for t in zipf_corpus(120, seed=8, lo=1, hi=600)] + [
            p.encode() for p in MULTI_PIECES]
    raise KeyError(case)


K8_CASES = ["truncated 2-byte lead", "truncated 3-byte lead", "truncated 4-byte lead",
            "empty rows", "rows of 128, 512 and 4,096 bytes", "random bytes", "corpus rows"]


@pytest.fixture(scope="module")
def k8_checkers():
    """JAX's checker and the bitmap of NFC, of ``BertNormalizer()`` and
    ``utils/corpus.py:norm_trap_bitmap`` (what a truncated lead of
    ``_k8_rows`` would decode to with the next row's bytes)."""
    out = {}
    for name, ours, theirs in (("NFC", N.NFC(), JN.NFC()),
                               ("bert", N.BertNormalizer(), JN.BertNormalizer()),
                               ("trap", None, None)):
        plan = JND.plan_for_normalizer(theirs)
        if name == "trap":
            plan.bitmap = norm_trap_bitmap()
        else:
            assert np.array_equal(ND.plan_for_normalizer(ours).bitmap, plan.bitmap)
        out[name] = (JND.DeviceNormChecker(plan), torch.from_numpy(plan.bitmap.copy()))
    return out


@pytest.mark.parametrize("bitmap", ["NFC", "bert", "trap"])
@pytest.mark.parametrize("case", K8_CASES)
def test_ragged_k8_plain_equals_jax(case, bitmap, k8_checkers):
    checker, bm = k8_checkers[bitmap]
    rows = _k8_rows(case)
    assert len(rows) <= _JAX_ROWS
    arr, lens = jax_pack(rows, _JAX_WIDTH, _JAX_ROWS)
    exp = np.asarray(checker._fn(arr, lens))[:len(rows)]
    data, offs, blocks, stable = ND.pack_norm_rows(rows)
    got = ND.norm_stable_rows(data, offs, blocks, bm, stable)
    assert got.dtype == torch.bool and got.numpy().tolist() == exp.tolist()
    plain = ND.norm_stable_rows_ragged_plain(data, offs, bm)
    assert torch.equal(plain, got)
    if case.startswith("truncated") and bitmap == "trap":
        # a truncated lead decodes with zeros past its row's end, not with
        # the next row's bytes: those rows are stable, the whole forms not
        assert exp[0::4].all() and not exp[3::4].any()


def _check_block_rows(offs: np.ndarray, span: int, br: np.ndarray) -> None:
    B, N = len(offs) - 1, int(offs[-1])
    assert br.dtype == np.int32
    if N == 0:
        assert br.tolist() == [0]
        return
    T = len(br) - 1
    assert T == -(-N // span) and (np.diff(br) >= 0).all()
    for k in range(T + 1):
        p = min(k * span, N - 1)
        r = int(br[k])
        assert 0 <= r < B and offs[r] <= p < offs[r + 1]  # the non-empty row that holds p
    # every byte of block k lies in a row of [br[k], br[k + 1]]
    row_of = np.repeat(np.arange(B), np.diff(offs))
    block = np.arange(N) // span
    assert (row_of >= br[block]).all() and (row_of <= br[block + 1]).all()


@pytest.mark.parametrize("span", [16, 100, 4096])
def test_norm_block_rows_invariants(span):
    rng = np.random.RandomState(span)
    for lens in (
        rng.randint(0, 600, size=300),
        np.r_[np.zeros(5, int), rng.randint(1, 5, size=2000), np.zeros(9, int)],
        np.full(40, 4096),
        np.zeros(7, int),
        np.array([], int),
        np.r_[1, np.zeros(3000, int), 1],
        np.full(20, span),
    ):
        offs = np.r_[0, np.cumsum(lens)].astype(np.int64)
        _check_block_rows(offs, span, ND.norm_block_rows(offs, span))


def test_pack_norm_rows_layout():
    """One buffer: the rows end to end, zero padded to 16 bytes, the flags
    (all True), the offsets and the block index as 4-byte aligned views."""
    rows = [b"ab", b"", b"caf\xc3\xa9", b"x" * 5000, b"z"]
    data, offs, blocks, stable = ND.pack_norm_rows(rows)
    base = data.untyped_storage().data_ptr()
    for t in (offs, blocks, stable):
        assert t.untyped_storage().data_ptr() == base  # one tensor
    assert data.dtype == torch.uint8 and data.numel() % 16 == 0
    n = sum(map(len, rows))
    assert bytes(data[:n].tolist()) == b"".join(rows) and not data[n:].any()
    assert offs.tolist() == [0, 2, 2, 7, 5007, 5008]
    assert offs.storage_offset() * 4 % 4 == 0 and blocks.dtype == torch.int32
    assert blocks.tolist() == ND.norm_block_rows(np.asarray(offs.tolist())).tolist()
    assert stable.dtype == torch.bool and stable.all() and stable.numel() == len(rows)
    empty = ND.pack_norm_rows([])
    assert [t.numel() for t in empty] == [0, 1, 1, 0]


def test_check_bytes_one_launch(monkeypatch):
    """``check_bytes`` checks every row up to the largest bucket in one call
    of the wrapper (rows of both buckets together), leaves empty rows
    stable and rows over the largest bucket unstable, as JAX's."""
    raw = [b"caf\xc3\xa9", b"", b"x" * 200, b"a\xcc\x81" * 100, b"plain", b"y" * 600,
           "中文".encode()]
    calls = []
    wrapped = ND.norm_stable_rows

    def counting(*args, **kw):
        calls.append(args[1].numel() - 1)
        return wrapped(*args, **kw)

    monkeypatch.setattr(ND, "norm_stable_rows", counting)
    plan = ND.plan_for_normalizer(N.BertNormalizer())
    got = ND.DeviceNormChecker(plan, "cpu").check_bytes(raw, (128, 512))
    assert calls == [5]
    exp = JND.DeviceNormChecker(JND.plan_for_normalizer(JN.BertNormalizer())).check_bytes(
        raw, (128, 512), jax_pack)
    # café and 中文 hold flagged codepoints, a\u0301 a combining mark; the
    # empty row is stable, the row over the largest bucket unstable
    assert got.tolist() == exp.tolist() == [False, True, True, False, True, False, False]

"""The ragged forms of K9 and K10 (``ops/merge.py:merge_word_rows``,
``ops/wordpiece_device.py:wordpiece_match``): their plain versions (the
wrappers on CPU tensors) against the JAX package's ``merge_word_rows`` and
``WordPieceDevice._fn`` on the same words scattered into 128-lane rows,
exactly; K9's tiling helper and K10's packing."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import torch  # noqa: E402

from test_torch_models import MODELS, dense_rows, _wordpiece_vocab  # noqa: E402

from complexity_tokenizer_tpu import models as JM  # noqa: E402
from complexity_tokenizer_tpu.ops import wordpiece_device as JW  # noqa: E402
from complexity_tokenizer_tpu.ops.merge import merge_word_rows as jax_merge_word_rows  # noqa: E402
from complexity_tokenizer_tpu_torch import models as M  # noqa: E402
from complexity_tokenizer_tpu_torch.ops import stringbpe_device as S  # noqa: E402
from complexity_tokenizer_tpu_torch.ops import wordpiece_device as W  # noqa: E402
from complexity_tokenizer_tpu_torch.ops.merge import (  # noqa: E402
    WORD_LANES,
    merge_word_rows,
    merge_word_rows_ragged_plain,
    word_tiles,
)
from complexity_tokenizer_tpu_torch.utils.bytelevel import bytes_to_unicode  # noqa: E402
from complexity_tokenizer_tpu_torch.utils.corpus import RUN_BREAKS, run_rows, zipf_corpus  # noqa: E402

# every case is padded to this many rows for JAX, so that one compile serves all
_JAX_ROWS = 512


def _offs(lens) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)


# ---------------------------------------------------------------------------
# K9


def _k9_words(case: str, dev, rng) -> list[list[int]]:
    """Symbol-id words of one edge case, over the table's single symbols."""
    singles = [i for s, i in dev.sym_id.items() if len(s) == 1]
    base = len(dev.symbols)

    def word(n):
        return [singles[rng.randint(len(singles))] for _ in range(n)]

    if case == "one-symbol words":
        return [word(1) for _ in range(60)] + [[], word(1), []]
    if case == "128-symbol words":
        return [word(128) for _ in range(5)] + [[singles[3]] * 128, word(2)]
    if case == "tile edges":
        # at S = 16: a word starting at (k + 1) * 16 - 1 for each k, the last
        # symbol of its tile, then long words across the next tiles
        lens = [15, 3, 12, 1, 16, 2, 40, 128, 5, 128, 1]
        return [word(n) for n in lens]
    if case == "runs of one symbol":
        return [[singles[k % 7]] * n for k, n in enumerate(range(2, 48))] + [
            [singles[0], singles[0], singles[1]] * 9]
    if case == "ids past the table":
        out = []
        for k in range(40):
            w = word(rng.randint(1, 30))
            w[rng.randint(len(w))] = base + rng.randint(3)
            out.append(w)
        return out + [[base] * 5, [base + 1]]
    if case == "tombstones inside words":
        out = []
        for k in range(40):
            w = word(rng.randint(2, 40))
            w[rng.randint(len(w))] = -1
            out.append(w)
        return out
    if case == "empty batch":
        return []
    if case == "corpus words":
        enc = bytes_to_unicode()
        words = sorted({w for t in zipf_corpus(8, seed=11) for w in t.split()})
        rows = [[enc[b] for b in (" " + w).encode()] for w in words]
        text = " ".join(zipf_corpus(20, seed=4)).encode()
        rows += [[enc[b] + ("\0" if b in RUN_BREAKS else "") for b in r]
                 for r in run_rows(text, 8, 128, True)]
        syms, offs = dev.pack(rows)[:2]
        return [syms[offs[i]:offs[i + 1]].tolist() for i in range(len(rows))]
    raise KeyError(case)


K9_CASES = ["one-symbol words", "128-symbol words", "tile edges", "runs of one symbol",
            "ids past the table", "tombstones inside words", "empty batch", "corpus words"]


@pytest.mark.parametrize("case", K9_CASES)
def test_ragged_k9_plain_equals_jax(case):
    dev = S.build_string_bpe_device(MODELS["bytelevel_trained"](M).merge_ranks, "cpu")
    words = _k9_words(case, dev, np.random.RandomState(len(case)))
    offs = _offs([len(w) for w in words])
    syms = np.asarray([s for w in words for s in w], np.int32)
    B = len(words)
    assert B <= _JAX_ROWS
    padded = np.full((_JAX_ROWS, WORD_LANES), -1, np.int32)
    padded[:B] = dense_rows(syms, offs)
    exp_t, exp_c = jax_merge_word_rows(padded, dev.chd.disp, dev.chd.rows, dev.chd.size,
                                       dev.chd.n_buckets)
    args = (torch.from_numpy(dev.chd.disp), torch.from_numpy(dev.chd.rows), dev.chd.size,
            dev.chd.n_buckets)
    t = torch.from_numpy
    for tile in (16, 896):
        tiles = word_tiles(offs, tile)
        out, count = merge_word_rows(t(syms), t(offs), t(tiles), *args, tile=tile)
        assert out.dtype == torch.int32 and out.shape == (len(syms),)
        assert np.array_equal(dense_rows(out.numpy(), offs), np.asarray(exp_t)[:B])
        assert np.array_equal(count.numpy(), np.asarray(exp_c)[:B])
    plain = merge_word_rows_ragged_plain(t(syms), t(offs), *args)
    assert torch.equal(plain[0], out) and torch.equal(plain[1], count)
    if B and case not in ("one-symbol words", "ids past the table"):
        assert (count.numpy() < np.diff(offs)).any()  # merges happened


def _check_tiles(offs: np.ndarray, tile: int, first: np.ndarray) -> None:
    B, N = len(offs) - 1, int(offs[-1])
    T = len(first) - 1
    assert first.dtype == np.int32
    if B == 0:
        assert T == 0
        return
    assert T == max(1, -(-N // tile))
    assert first[0] == 0 and first[-1] == B and (np.diff(first) >= 0).all()  # tiles in order
    tile_of = np.repeat(np.arange(T), np.diff(first))  # every word in exactly one tile
    assert len(tile_of) == B
    starts = offs[:-1]
    assert (starts >= tile_of * tile).all()
    last = tile_of == T - 1
    assert (starts[~last] < (tile_of[~last] + 1) * tile).all()
    spans = offs[first[1:]] - offs[first[:-1]]
    assert (spans <= tile + WORD_LANES - 1).all()  # no tile over its lanes


@pytest.mark.parametrize("tile", [1, 7, 128, 384, 896, 1920])
def test_word_tiles_invariants(tile):
    rng = np.random.RandomState(tile)
    for lens in (
        rng.randint(0, 20, size=3000),
        np.r_[rng.randint(1, 129, size=400), np.zeros(5, int)],
        np.full(64, WORD_LANES),
        np.zeros(7, int),
        np.array([], int),
        np.r_[np.full(9, 1), np.zeros(3, int), 128, np.zeros(4, int)],
    ):
        offs = _offs(lens)
        _check_tiles(offs, tile, word_tiles(offs, tile))


def test_word_tiles_refuse_a_word_over_the_lanes():
    with pytest.raises(ValueError, match="more than 128"):
        word_tiles(_offs([3, 129, 2]), 896)


def test_string_pack_is_ragged():
    """``StringBpeDevice.pack``: the rows' symbol ids end to end, a row over
    128 symbols holds none, characters no merge names get ids past the
    table, numbered per batch."""
    dev = S.build_string_bpe_device(MODELS["bytelevel"](M).merge_ranks, "cpu")
    known = next(iter(dev.sym_id))
    rows = [[known, "\x01", "\x02"], ["z"] * 130, [], ["\x01"], [known] * 128]
    syms, offs, skipped, all_syms = dev.pack(rows)
    base = len(dev.symbols)
    assert offs.tolist() == [0, 3, 3, 3, 4, 132] and skipped == {1}
    assert syms[:4].tolist() == [dev.sym_id[known], base, base + 1, base]
    assert all_syms[base:] == ["\x01", "\x02"]
    assert dev.merge_symbol_rows(rows)[1] is None


# ---------------------------------------------------------------------------
# K10


def _letters(rng, n: int) -> str:
    return "".join(rng.choice(list("abcdeé日")) for _ in range(n))


def _k10_case(case: str):
    """(model name, corrupted slots, words) of one edge case."""
    rng = np.random.RandomState(len(case))
    if case in ("8/9 characters", "16/17 characters", "32/33 characters"):
        a, b = (int(x) for x in case.split()[0].split("/"))
        words = [_letters(rng, n) for n in (a, b) for _ in range(12)]
        return "wordpiece", 0, words + ["abcde"[: a % 5 + 1] * (a // (a % 5 + 1))]
    if case == "over the limit, UNK":
        return "wordpiece_short_limit", 0, [_letters(rng, n) for n in range(1, 40)] + ["a" * 150]
    if case == "over the limit, no UNK":
        return "wordpiece_no_unk", 0, ["ab" * 51, "abc" * 40, "a" * 101, "ab", "abc"]
    if case == "C11's word":
        # over the lanes, within a limit of 200: left to the host, no slot
        return "wordpiece_200", 0, ["ab" * 75, "abc", "a" * 129, "b" * 128]
    if case == "poisoned":
        return "wordpiece", 40, [_letters(rng, rng.randint(1, 30)) for _ in range(80)]
    if case == "empty batch":
        return "wordpiece", 0, []
    if case == "corpus words":
        words = sorted({w for t in zipf_corpus(8, seed=6) for w in t.split()})
        return "wordpiece_literal", 0, words + ["", "##abc", "a##1", "#"]
    raise KeyError(case)


K10_CASES = ["8/9 characters", "16/17 characters", "32/33 characters", "over the limit, UNK",
             "over the limit, no UNK", "C11's word", "poisoned", "empty batch", "corpus words"]


def _wp_model(P, name):
    if name == "wordpiece_200":
        return P.WordPieceModel(_wordpiece_vocab(), max_input_chars_per_word=200)
    return MODELS[name](P)


@pytest.mark.parametrize("case", K10_CASES)
def test_ragged_k10_plain_equals_jax(case):
    name, corrupt, words = _k10_case(case)
    ours_t = W.build_wordpiece_tables(_wp_model(M, name))
    theirs_t = JW.build_wordpiece_tables(_wp_model(JM, name))
    for t in (ours_t, theirs_t):
        if corrupt:
            tc = t.token_chars.copy()
            tc[:corrupt, 0] += 1
            t.token_chars = tc
    dev = W.WordPieceDevice(ours_t, "cpu")
    chars, offs, lens, order, groups, host = dev.pack(words)
    B = len(words) - len(host)
    assert len(lens) == len(words) and B <= _JAX_ROWS
    # JAX on the same words as 128-lane rows (each word's slots; the length
    # as packed), padded with empty rows
    pc = np.full((_JAX_ROWS, 128), -1, np.int32)
    pl = np.zeros(_JAX_ROWS, np.int32)
    pc[:len(words)] = dense_rows(chars, offs)
    pl[:len(words)] = lens
    exp_out, exp_count, exp_poison = JW.WordPieceDevice(theirs_t)._fn(pc, pl)
    t = torch.from_numpy
    out, count, poison = W.wordpiece_match(t(chars), t(offs), t(lens), groups, *dev.args(),
                                           ours_t.max_input_chars)
    n = len(words)
    assert np.array_equal(dense_rows(out.numpy(), offs), np.asarray(exp_out)[:n])
    assert np.array_equal(count.numpy(), np.asarray(exp_count)[:n])
    assert np.array_equal(poison.numpy(), np.asarray(exp_poison)[:n])
    assert bool(poison.any()) == bool(corrupt)
    plain = W.wordpiece_match_ragged_plain(t(chars), t(offs), t(lens), *dev.args(),
                                           ours_t.max_input_chars)
    for a, b in zip(plain, (out, count, poison)):
        assert torch.equal(a, b)
    # the tier against the host model on every word
    model = _wp_model(M, name)
    if not corrupt:
        assert model.encode_batch([" ".join(words)], device="cpu") == [
            model.encode(" ".join(words))]
    if case == "C11's word":
        assert host == [0, 2] and dev.tokenize_words(words)[0] == []


def test_wordpiece_pack_orders_by_slots():
    """``WordPieceDevice.pack``: words ordered by their slots (stable), the
    groups of 8 and 16 lanes, one slot (-1) and the length cut to the lanes
    for a word over the limit, no slot for a word left to the host."""
    dev = W.WordPieceDevice(W.build_wordpiece_tables(M.WordPieceModel(_wordpiece_vocab(),
                                                                      max_input_chars_per_word=30)),
                            "cpu")
    words = ["abcdefghijklmnopq", "ab", "x" * 40, "", "abcdefghi", "é日", "a" * 150, "abcdefgh"]
    chars, offs, lens, order, groups, host = dev.pack(words)
    assert order.tolist() == [3, 2, 6, 1, 5, 7, 4, 0]
    assert np.diff(offs).tolist() == [0, 1, 1, 2, 2, 8, 9, 17]
    assert lens.tolist() == [0, 40, 128, 2, 2, 8, 9, 17]
    assert groups == (6, 7) and host == []
    assert chars[offs[1]] == -1 and chars[offs[2]] == -1
    assert chars[offs[4]:offs[5]].tolist() == [ord("é"), ord("日")]
    theirs = JW.WordPieceDevice(JW.build_wordpiece_tables(
        JM.WordPieceModel(_wordpiece_vocab(), max_input_chars_per_word=30)))
    assert dev.tokenize_words(words) == theirs.tokenize_words(words)
    assert dev.last_poisoned == [] and dev.last_over_width == 0


def test_hash_powers_and_emit_rows():
    """The powers table K10 reads, and the emit id in each used row of the
    device's CHD rows (the numpy tables stay the JAX package's)."""
    p = W.hash_powers("cpu").numpy().view(np.uint32)
    assert p.shape == (4, 129)
    for l in (0, 1, 7, 128):
        assert int(p[0, l]) == pow(W._B1, l, 1 << 32)
        assert int(p[1, l]) == pow(W._B2, l, 1 << 32)
        assert int(p[2, l]) == W._SEED_CONT1 * pow(W._B1, l, 1 << 32) % (1 << 32)
        assert int(p[3, l]) == W._SEED_CONT2 * pow(W._B2, l, 1 << 32) % (1 << 32)
    tables = W.build_wordpiece_tables(MODELS["wordpiece"](M))
    dev = W.WordPieceDevice(tables, "cpu")
    rows = dev.rows.numpy()
    used = rows[:, 2] != W.INF_RANK
    assert used.sum() == len(tables.emit_ids)
    assert np.array_equal(rows[used, 3], tables.emit_ids[rows[used, 2]])
    assert (tables.chd.rows[:, 3] == -1).all()

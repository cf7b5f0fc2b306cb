"""The word path's fill (``ops/wordfill.py``: on the CPU the plain versions
of K6 and K4, K3 -> K1 -> K2 or K5 -> K4) against the JAX package's fill body
``DeviceWordEncoder._fn`` / ``_fn_full`` / ``_local_fill_body``: the fused
buffer byte for byte, on packs of words made from a numpy seed, at the
800-entry fixture, the 50K configuration (uint16 ids, the cuckoo table) and
the 100K one (int32 ids, the CHD table).  Also K6's prologue flags
(``fill_row_flags``) against the word ids of K3's plain version."""

import json
import os

import numpy as np
import pytest
import torch

from helpers import trained_tokenizer_json

jax = pytest.importorskip("jax")

from complexity_tokenizer_tpu.ops.merge import merge_words_qc as jax_merge_words_qc  # noqa: E402
from complexity_tokenizer_tpu.tokenizer import Tokenizer as JaxTokenizer  # noqa: E402
from complexity_tokenizer_tpu_torch.ops.merge import merge_fixpoint_qc_plain  # noqa: E402
from complexity_tokenizer_tpu_torch.ops.seed import seed_tokens_plain  # noqa: E402
from complexity_tokenizer_tpu_torch.ops.wordfill import (  # noqa: E402
    fill_compact,
    fill_layout,
    fill_row_flags,
    word_fill,
    word_fill_plain,
    word_ids,
    word_ids_plain,
    word_merge,
    word_merge_plain,
)
from complexity_tokenizer_tpu_torch.tokenizer import Tokenizer  # noqa: E402
from complexity_tokenizer_tpu_torch.utils.bytelevel import bytes_to_unicode  # noqa: E402
from complexity_tokenizer_tpu_torch.utils.corpus import edge_word_pack, zipf_corpus  # noqa: E402

BENCH = {
    name: os.path.join(os.path.dirname(__file__), "..", ".cache", f)
    for name, f in (("50k", "bench_tokenizer_r4_50k.json"), ("100k", "bench_tokenizer_100k.json"))
}


@pytest.fixture(scope="module")
def toks():
    js = trained_tokenizer_json()
    pt, jt = Tokenizer.from_str(js), JaxTokenizer.from_str(js)
    jt.use_device = True
    return pt, jt, pt._get_word_path("cpu"), jt._get_word_path()


def _words(rng, n, alphabet=None):
    out = []
    for _ in range(n):
        k = rng.randint(1, 24)
        if alphabet is None:
            out.append(bytes(rng.randint(1, 256, size=k).astype(np.uint8)))
        else:
            out.append(bytes(rng.choice(alphabet, k).astype(np.uint8)))
    return out


def _pack(wp, words, rows):
    """One pack of ``words`` into ``rows`` rows, as the word path makes it:
    (bytes, start bits, row lengths)."""
    buf = np.frombuffer(b"".join(words), np.uint8)
    offs = np.zeros(len(words) + 1, np.int64)
    np.cumsum([len(w) for w in words], out=offs[1:])
    arr, marks, _starts, n_fit, _used = wp._pack_seg(buf, offs, 0, len(words), rows)
    assert n_fit > 0
    bits = np.packbits(marks == 1, axis=1, bitorder="little")
    row_len = (marks > 0).sum(axis=1).astype(np.int32)
    return arr, bits, row_len


def _port_fill(wp, a, bits, row_len, cap):
    args = [torch.from_numpy(x) for x in (a, bits, row_len)]
    itemsize = np.dtype(wp._out_dtype).itemsize
    return word_fill(*args, cap, tables=wp.pipeline.tables, itemsize=itemsize).numpy()


LETTERS = list(b"abcdefqxZW")


@pytest.mark.parametrize(
    "kind,alphabet",
    [("letters", LETTERS), ("bytes", None)],
    ids=["letters", "random_bytes"],
)
@pytest.mark.parametrize("full", [False, True], ids=["cap_3_8", "cap_full"])
def test_fused_buffer_equals_jax_fill(toks, kind, alphabet, full):
    """The port's fused buffer equals the JAX ``_fn`` (cap 3/8) and
    ``_fn_full`` (cap = all lanes) output byte for byte.  Random bytes
    barely merge, so their packs overflow 3/8 and show the spill total."""
    _pt, _jt, pwp, jwp = toks
    rng = np.random.RandomState(31 if alphabet is None else 30)
    a, bits, row_len = _pack(pwp, _words(rng, 600, alphabet), 64)
    B = a.shape[0]
    cap = B * 128 if full else B * 128 * 3 // 8
    exp = np.asarray((jwp._fn_full if full else jwp._fn)(a, bits, row_len))
    got = _port_fill(pwp, a, bits, row_len, cap)
    assert got.dtype == np.uint8 and got.shape == exp.shape
    assert got.tobytes() == exp.tobytes()
    total = int(got[-4:].view(np.int32)[0])
    if kind == "bytes" and not full:
        assert total > cap  # the spill the host redispatches


def test_row_local_word_ids_give_the_flat_count_fixpoint(toks):
    """K3 counts word starts within each row, the JAX body over the whole
    pack: K2 gives the same output for both, and equals the JAX K2 fed the
    flat count."""
    pt, jt, pwp, _jwp = toks
    rng = np.random.RandomState(8)
    a, bits, row_len = _pack(pwp, _words(rng, 900, LETTERS), 64)
    B, W = a.shape
    local = word_ids(torch.from_numpy(bits), torch.from_numpy(row_len))
    pos = np.arange(W)[None, :]
    valid = pos < row_len[:, None]
    starts = ((np.repeat(bits, 8, axis=1) >> (pos % 8)) & 1).astype(np.int32)
    starts = np.where(valid, starts, 0)
    flat = np.where(valid, np.cumsum(starts.reshape(-1)).reshape(B, W) - 1, -1).astype(np.int32)
    assert not np.array_equal(local.numpy(), flat)  # the counts differ...
    tb = pwp.pipeline.tables
    tokens = seed_tokens_plain(torch.from_numpy(a), torch.from_numpy(row_len), tb.byte_token_table)
    t_local, c_local = merge_fixpoint_qc_plain(tokens, local, tb.qc_t1, tb.qc_t2, tb.qc_size)
    t_flat, c_flat = merge_fixpoint_qc_plain(
        tokens, torch.from_numpy(flat), tb.qc_t1, tb.qc_t2, tb.qc_size
    )
    assert torch.equal(t_local, t_flat) and torch.equal(c_local, c_flat)  # ...the fixpoint not
    qc = jt._get_pipeline().tables.qc
    jt_tokens, jt_count = jax_merge_words_qc(tokens.numpy(), flat, qc.t1, qc.t2, qc.size)
    np.testing.assert_array_equal(t_local.numpy(), np.asarray(jt_tokens))
    np.testing.assert_array_equal(c_local.numpy(), np.asarray(jt_count))


def test_word_ids_edges():
    """Rows of length 0 and of the full width, a start bit past the row's
    length, and a row whose bits are all set."""
    bits = np.zeros((4, 16), np.uint8)
    row_len = np.array([0, 128, 5, 128], np.int32)
    bits[1, 0] = 0b00010001  # starts at 0 and 4
    bits[2, 0] = 0b01000001  # a start at 6 lies past the length 5
    bits[3] = 0xFF
    wid = word_ids(torch.from_numpy(bits), torch.from_numpy(row_len)).numpy()
    assert (wid[0] == -1).all()
    assert wid[1, :4].tolist() == [0] * 4 and (wid[1, 4:] == 1).all()
    assert wid[2].tolist() == [0] * 5 + [-1] * 123
    assert wid[3].tolist() == list(range(128))


@pytest.mark.parametrize("itemsize", [2, 4])
def test_fill_compact_layout(itemsize):
    """K4's plain version writes the layout the host unpacks: ids in flat
    order then -1, little-endian alive bits, the total even past cap."""
    merged = np.full((2, 16), -1, np.int32)
    merged[0, [1, 3]] = [7, 70000 if itemsize == 4 else 65534]
    merged[1, [0, 15]] = [5, 6]
    count = (merged >= 0).sum(axis=1).astype(np.int32)
    dt = np.uint16 if itemsize == 2 else np.int32
    for cap, n in ((6, 4), (3, 3)):
        raw = fill_compact(torch.from_numpy(merged), torch.from_numpy(count), cap, itemsize).numpy()
        at_bits, at_total, size = fill_layout(2, 16, cap, itemsize)
        assert raw.shape == (size,)
        ids = raw[:at_bits].view(dt)
        assert ids[:n].tolist() == merged[merged >= 0].tolist()[:n]
        assert (ids[n:] == dt(-1) if itemsize == 4 else ids[n:] == 0xFFFF).all()
        np.testing.assert_array_equal(
            np.unpackbits(raw[at_bits:at_total], bitorder="little"), (merged >= 0).reshape(-1)
        )
        assert int(raw[at_total:].view(np.int32)[0]) == 4


def test_int32_ids_when_an_id_reaches_65535():
    """A byte token whose id is past u16 (taking part in no merge, so the
    cuckoo table still fits) makes the fill write int32 ids; the word path
    stays exact with them."""
    enc = bytes_to_unicode()
    vocab = {enc[b]: b for b in range(256) if b != ord("c")}
    vocab[enc[ord("c")]] = 70000
    vocab[enc[ord("a")] + enc[ord("b")]] = 300
    js = json.dumps({"model": {"type": "BPE", "vocab": vocab, "merges": ["a b"]}})
    pt, jt = Tokenizer.from_str(js), JaxTokenizer.from_str(js)
    wp = pt._get_word_path("cpu")
    assert wp._out_dtype == np.int32
    texts = ["ab c abc cab", "ccc abab", "xyz"]
    assert pt.encode_batch(texts, backend="device", device="cpu") == [
        jt._encode_host(t) for t in texts
    ]
    assert wp.words_filled > 0


def test_u16_ids_below_65535(toks):
    _pt, _jt, pwp, jwp = toks
    assert pwp._out_dtype == jwp._out_dtype == np.uint16


@pytest.fixture(scope="module", params=["50k", "100k"])
def bench(request):
    """(name, port word path on the CPU, JAX word path) of a benchmark
    configuration; the JAX tokenizer is loaded from the string (its
    ``from_file`` writes a warm-cache file beside the JSON)."""
    with open(BENCH[request.param], encoding="utf-8") as f:
        js = f.read()
    pt, jt = Tokenizer.from_str(js), JaxTokenizer.from_str(js)
    jt.use_device = True
    return request.param, pt, pt._get_word_path("cpu"), jt._get_word_path()


def _word_pool(kind: str, seed: int, tok=None) -> list[bytes]:
    """Corpus words (``text``), or random words of the bytes that have a
    token but take part in no merge of ``tok`` (``unmerged``)."""
    if kind == "text":
        return [w.encode() for t in zipf_corpus(200, seed=seed) for w in t.split()]
    table = tok.device_tables().byte_token_table
    in_merges = {i for pair in tok.bpe.merge_ranks for i in pair}
    lone = [b for b in range(256) if table[b] >= 0 and table[b] not in in_merges]
    assert lone
    rng = np.random.RandomState(seed)
    return [bytes(rng.choice(lone, rng.randint(1, 24)).astype(np.uint8)) for _ in range(400)]


@pytest.mark.parametrize("words", ["text", "unmerged"])
@pytest.mark.parametrize("B", [1, 7])
def test_word_fill_plain_equals_jax_fill_body_on_edge_rows(bench, B, words):
    """The fill's plain version (and ``word_fill`` on the CPU) equal the JAX
    unphased fill body byte for byte at the compact capacity (3/8) and at
    full capacity, on ``edge_word_pack`` rows: a run before row 0's first
    start bit, a row of length 0, a full row, OOV bytes inside words and in
    a run, a one-byte run before a later row's first start bit, a long word
    of one letter.  Words that cannot merge fill their rows with live ids:
    those packs spill at 3/8."""
    name, pt, pwp, jwp = bench
    itemsize = np.dtype(pwp._out_dtype).itemsize
    assert pwp._out_dtype == jwp._out_dtype
    assert itemsize == (2 if name == "50k" else 4)
    assert (pwp.pipeline.tables.qc_t1 is None) == (name == "100k")
    a, bits, row_len = edge_word_pack(_word_pool(words, B, pt), B, seed=B)
    assert row_len[0] > 6 and not np.unpackbits(bits[0], bitorder="little")[:6].any()
    args = [torch.from_numpy(x) for x in (a, bits, row_len)]
    for num, den in ((3, 8), (1, 1)):
        cap = B * 128 * num // den
        exp = np.asarray(jax.jit(jwp._local_fill_body(num, den, 0))(a, bits, row_len))
        got = word_fill_plain(*args, cap, tables=pwp.pipeline.tables, itemsize=itemsize)
        assert got.dtype == torch.uint8 and got.numpy().tobytes() == exp.tobytes()
        via = word_fill(*args, cap, tables=pwp.pipeline.tables, itemsize=itemsize)
        assert torch.equal(via, got)
        total = int(got[-4:].numpy().view(np.int32)[0])
        if words == "unmerged" and num == 3:
            assert total > cap  # the spill the host redispatches


def test_word_merge_on_cpu_is_k3_k1_and_the_fixpoint(bench):
    """K6's plain version (``word_merge`` on CPU tensors) is K3's, K1's and
    the table's fixpoint's plain versions one after the other, and launches
    nothing."""
    _name, _pt, pwp, _jwp = bench
    tables = pwp.pipeline.tables
    a, bits, row_len = (torch.from_numpy(x) for x in edge_word_pack(_word_pool("text", 3), 7, seed=3))
    before = word_merge.launches
    merged, count = word_merge(a, bits, row_len, tables=tables)
    assert word_merge.launches == before
    tokens = seed_tokens_plain(a, row_len, tables.byte_token_table)
    exp_merged, exp_count = tables.merge_fixpoint(tokens, word_ids_plain(bits, row_len))
    assert merged.dtype == count.dtype == torch.int32
    assert torch.equal(merged, exp_merged) and torch.equal(count, exp_count)
    plain = word_merge_plain(a, bits, row_len, tables=tables)
    assert torch.equal(plain[0], merged) and torch.equal(plain[1], count)


def _expected_flags(wid: torch.Tensor):
    """Word starts (where the word id changes, and column 0) and gaps (word
    id -1) of K3's word ids."""
    left = torch.full_like(wid, -2)
    left[:, 1:] = wid[:, :-1]
    return wid != left, wid == -1


@pytest.mark.parametrize("W", [8, 128, 256])
def test_fill_row_flags_mark_where_word_ids_change(W):
    """K6's prologue rule (``fill_row_flags``) marks exactly the positions
    where K3's word ids change, and the gaps where they are -1: rows of
    length 0, 1 and W, rows whose first start bit lies late or past the
    length, a row with no start bit, and the edge rows of the fill."""
    rng = np.random.RandomState(W)
    B = 64
    starts = rng.rand(B, W) < 0.15
    lens = rng.randint(0, W + 1, size=B).astype(np.int32)
    lens[:4] = [0, W, 1, W]
    starts[3, : W // 2] = False  # the first start late in a full row
    starts[4] = False  # no start at all
    starts[5, : lens[5]] = False  # a start only past the length
    starts[5, lens[5]:] = True
    bits = np.packbits(starts, axis=1, bitorder="little")
    cases = [(bits, lens)]
    cases.append(edge_word_pack(_word_pool("text", W), 16, W, seed=W)[1:])
    for k, (b, n) in enumerate(cases):
        b, n = torch.from_numpy(b), torch.from_numpy(n)
        got_starts, got_gaps = fill_row_flags(b, n)
        exp_starts, exp_gaps = _expected_flags(word_ids_plain(b, n))
        assert torch.equal(got_starts, exp_starts)
        assert torch.equal(got_gaps, exp_gaps)
        if k == 0:
            assert got_gaps[0].all() and got_gaps[4].all() and got_gaps[5].all()
            assert got_gaps[3, : W // 2].all() and got_starts[:, 0].all()

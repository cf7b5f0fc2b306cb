"""The word path's fill (``ops/wordfill.py``: K3 -> K1 -> K2 -> K4) on the
CPU against the JAX package's fill body ``DeviceWordEncoder._fn`` /
``_fn_full``: the fused buffer byte for byte, on packs of words made from a
numpy seed."""

import json

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
    word_fill,
    word_ids,
)
from complexity_tokenizer_tpu_torch.tokenizer import Tokenizer  # noqa: E402
from complexity_tokenizer_tpu_torch.utils.bytelevel import bytes_to_unicode  # noqa: E402


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

"""Each CUDA kernel against its plain PyTorch version, on the card.

Marked ``gpu``; every test decides in its own body whether a card is
present and skips there without one.  The module imports no JAX, so it
runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -q -m gpu tests/test_torch_gpu.py
"""

import os

import numpy as np
import pytest
import torch

from complexity_tokenizer_tpu_torch.convert import tables_to_device
from complexity_tokenizer_tpu_torch.ops.decode import (
    DecodePipeline,
    build_decode_tables,
    decode_gather,
    decode_gather_plain,
    decode_launch_shape,
    decode_state,
    live_part,
)
from complexity_tokenizer_tpu_torch.ops.hashtable import build_chd_table
from complexity_tokenizer_tpu_torch.ops.merge import (
    merge_fixpoint_chd_plain,
    merge_fixpoint_qc_plain,
    merge_words,
    merge_words_qc,
)
from complexity_tokenizer_tpu_torch.ops.pipeline import pack_texts
from complexity_tokenizer_tpu_torch.ops.presplit import presplit
from complexity_tokenizer_tpu_torch.ops.seed import seed_tokens, seed_tokens_plain
from complexity_tokenizer_tpu_torch.ops.merge import launch_shape
from complexity_tokenizer_tpu_torch.ops.wordfill import (
    fill_compact,
    fill_compact_plain,
    word_fill,
    word_fill_plain,
    word_ids,
    word_ids_plain,
    word_merge,
    word_merge_chd,
    word_merge_plain,
    word_merge_qc,
)
from complexity_tokenizer_tpu_torch.tokenizer import Tokenizer
from complexity_tokenizer_tpu_torch.utils.corpus import (
    MULTI_PIECES,
    RUN_BREAKS,
    edge_word_pack,
    long_token_vocab,
    run_rows,
    zipf_corpus,
)
from complexity_tokenizer_tpu_torch.utils.unicode_tables import gpt2_class_table

pytestmark = pytest.mark.gpu

BENCH_50K = os.path.join(
    os.path.dirname(__file__), "..", ".cache", "bench_tokenizer_r4_50k.json"
)
BENCH_100K = os.path.join(
    os.path.dirname(__file__), "..", ".cache", "bench_tokenizer_100k.json"
)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.fixture(scope="module")
def tok50k():
    return Tokenizer.from_file(BENCH_50K)


@pytest.fixture(scope="module")
def tok100k():
    return Tokenizer.from_file(BENCH_100K)


@pytest.mark.parametrize(
    "B,W,skip",
    [
        (8192, 128, 0), (8192, 512, 0), (16, 4096, 0), (3, 16, 0),
        # W not a multiple of the kernel's 128-byte segment
        (5, 48, 0), (257, 2064, 0), (8193, 144, 0),
        # one row, 8,193 rows
        (1, 16, 0), (1, 4096, 0), (8193, 16, 0),
        # rows handed in as an offset row slice that is still 16-byte aligned
        (5, 48, 3), (257, 2064, 1), (64, 512, 7),
    ],
)
def test_seed_kernel_matches_plain(B, W, skip):
    """K1 bit for bit against its plain version, with rows of length 0, 1,
    15, 16, 17 and W among random lengths."""
    _need_card()
    rng = np.random.RandomState(B + W + skip)
    table = rng.randint(-1, 50000, size=256).astype(np.int32)
    table[rng.choice(256, 20, replace=False)] = -1
    full = torch.from_numpy(rng.randint(0, 256, size=(B + skip, W)).astype(np.uint8)).cuda()
    lens = rng.randint(0, W + 1, size=B).astype(np.int32)
    edge = [n for n in (0, 1, 15, 16, 17, W) if n <= W][:B]
    lens[: len(edge)] = edge
    arr = full[skip:]
    assert arr.is_contiguous() and arr.data_ptr() % 16 == 0
    lens = torch.from_numpy(lens).cuda()
    table = torch.from_numpy(table).cuda()
    before = seed_tokens.launches
    got = seed_tokens(arr, lens, table)
    torch.cuda.synchronize()
    assert seed_tokens.launches == before + 1
    assert torch.equal(got, seed_tokens_plain(arr, lens, table))


@pytest.mark.parametrize(
    "B,L", [(8192, 128), (2048, 512), (16, 4096), (16, 128), (64, 1024), (64, 2048)]
)
def test_merge_kernel_matches_plain(tok50k, B, L):
    _need_card()
    pipe = tok50k.pipeline("cuda")
    tb = pipe.tables
    texts = zipf_corpus(B, seed=L, lo=max(L // 8, 1), hi=L)
    texts[:4] = ["a" * L, " ".join(MULTI_PIECES)[:L], "", "aaaa aaaa"]
    data = [t.encode("utf-8")[:L] for t in texts]
    arr, lens = pack_texts(data, L, B)
    arr, lens = torch.from_numpy(arr).cuda(), torch.from_numpy(lens).cuda()
    _, wid, _ = presplit(arr, lens, tb.class_table)
    tokens = seed_tokens(arr, lens, tb.byte_token_table)
    before = merge_words_qc.launches
    got_t, got_c = merge_words_qc(tokens, wid, tb.qc_t1, tb.qc_t2, tb.qc_size)
    torch.cuda.synchronize()
    assert merge_words_qc.launches == before + 1
    exp_t, exp_c = merge_fixpoint_qc_plain(tokens, wid, tb.qc_t1, tb.qc_t2, tb.qc_size)
    assert torch.equal(got_t, exp_t)
    assert torch.equal(got_c, exp_c)


@pytest.mark.parametrize("breaks", [False, True])
@pytest.mark.parametrize("B,L", [(16, 1024), (4, 4096), (1, 4096)])
def test_merge_kernel_matches_plain_on_run_rows(tok50k, B, L, breaks):
    """Rows on which the kernel's greedy apply and the plain version's JAX
    rule take very different paths to the same fixpoint: long runs of one
    letter or symbol, ``abab...``, runs mixed with text, with OOV bytes
    (the random table's and the run breakers) as tombstones inside words.
    ``[1, 4096]`` is the single 4,096-byte word of one letter."""
    _need_card()
    tb = tok50k.pipeline("cuda").tables
    text = " ".join(zipf_corpus(400, seed=L)).encode("utf-8")
    rows = [b"a" * L] if B == 1 else run_rows(text, B, L, breaks)
    arr, lens = pack_texts(rows, L, B)
    arr, lens = torch.from_numpy(arr).cuda(), torch.from_numpy(lens).cuda()
    table = tb.byte_token_table.clone()
    if breaks:
        rng = np.random.RandomState(L)
        table[torch.from_numpy(rng.choice(256, 24, replace=False)).cuda()] = -1
        table[list(RUN_BREAKS)] = -1
    _, wid, _ = presplit(arr, lens, tb.class_table)
    tokens = seed_tokens(arr, lens, table)
    got_t, got_c = merge_words_qc(tokens, wid, tb.qc_t1, tb.qc_t2, tb.qc_size)
    torch.cuda.synchronize()
    exp_t, exp_c = merge_fixpoint_qc_plain(tokens, wid, tb.qc_t1, tb.qc_t2, tb.qc_size)
    assert torch.equal(got_t, exp_t)
    assert torch.equal(got_c, exp_c)


def _corpus_rows(B, L, seed):
    texts = zipf_corpus(B, seed=seed, lo=max(L // 8, 1), hi=L)
    texts[: min(B, 4)] = ["a" * L, " ".join(MULTI_PIECES)[:L], "", "aaaa aaaa"][: min(B, 4)]
    arr, lens = pack_texts([t.encode("utf-8")[:L] for t in texts], L, B)
    return torch.from_numpy(arr).cuda(), torch.from_numpy(lens).cuda()


def _chd_args(tb):
    return tb.chd_disp, tb.chd_rows, tb.chd_size, tb.chd_n_buckets


@pytest.mark.parametrize(
    "B,L", [(8192, 128), (2048, 512), (16, 4096), (16, 128), (64, 1024), (64, 2048),
            (1, 16), (3, 8), (5, 200)]
)
def test_chd_merge_kernel_matches_plain(tok100k, B, L):
    """K5 bit for bit against its plain version at 100K (ids and ranks past
    u16), on corpus rows with a row of one letter, a multilingual row and an
    empty row."""
    _need_card()
    tb = tok100k.pipeline("cuda").tables
    assert tb.qc_t1 is None
    arr, lens = _corpus_rows(B, L, seed=L + 1)
    _, wid, _ = presplit(arr, lens, tb.class_table)
    # K1 takes W % 16 == 0 only; K5 any width
    tokens = seed_tokens_plain(arr, lens, tb.byte_token_table)
    before = merge_words.launches
    got_t, got_c = merge_words(tokens, wid, *_chd_args(tb))
    torch.cuda.synchronize()
    assert merge_words.launches == before + 1
    exp_t, exp_c = merge_fixpoint_chd_plain(tokens, wid, *_chd_args(tb))
    assert torch.equal(got_t, exp_t)
    assert torch.equal(got_c, exp_c)


@pytest.mark.parametrize("breaks", [False, True])
@pytest.mark.parametrize("B,L", [(16, 1024), (4, 4096), (1, 4096)])
def test_chd_merge_kernel_matches_plain_on_run_rows(tok100k, B, L, breaks):
    """K5 on the rows that separate the greedy apply from the JAX rule (as
    for K2), ``[1, 4096]`` being one word of one letter."""
    _need_card()
    tb = tok100k.pipeline("cuda").tables
    text = " ".join(zipf_corpus(400, seed=L)).encode("utf-8")
    rows = [b"a" * L] if B == 1 else run_rows(text, B, L, breaks)
    arr, lens = pack_texts(rows, L, B)
    arr, lens = torch.from_numpy(arr).cuda(), torch.from_numpy(lens).cuda()
    table = tb.byte_token_table.clone()
    if breaks:
        rng = np.random.RandomState(L)
        table[torch.from_numpy(rng.choice(256, 24, replace=False)).cuda()] = -1
        table[list(RUN_BREAKS)] = -1
    _, wid, _ = presplit(arr, lens, tb.class_table)
    tokens = seed_tokens(arr, lens, table)
    got_t, got_c = merge_words(tokens, wid, *_chd_args(tb))
    torch.cuda.synchronize()
    exp_t, exp_c = merge_fixpoint_chd_plain(tokens, wid, *_chd_args(tb))
    assert torch.equal(got_t, exp_t)
    assert torch.equal(got_c, exp_c)


@pytest.mark.parametrize("B,L", [(8192, 128), (16, 4096), (64, 1024)])
def test_chd_and_cuckoo_kernels_agree(tok50k, B, L):
    """At 50K, where the pipeline holds the cuckoo table alone, K5 on the
    vocabulary's CHD table (built here) and K2 on the cuckoo table give the
    same ids on the same rows."""
    _need_card()
    tb = tok50k.pipeline("cuda").tables
    assert tb.qc_t1 is not None and tb.chd_rows is None
    chd = build_chd_table(tok50k.bpe.merge_ranks, tok50k.bpe.merge_ops)
    tc = tables_to_device(
        byte_token_table=tok50k.device_tables().byte_token_table,
        class_table=gpt2_class_table(), device="cuda", chd_disp=chd.disp, chd_rows=chd.rows,
    )
    arr, lens = _corpus_rows(B, L, seed=L + 2)
    _, wid, _ = presplit(arr, lens, tb.class_table)
    tokens = seed_tokens(arr, lens, tb.byte_token_table)
    k5_t, k5_c = merge_words(tokens, wid, *_chd_args(tc))
    k2_t, k2_c = merge_words_qc(tokens, wid, tb.qc_t1, tb.qc_t2, tb.qc_size)
    torch.cuda.synchronize()
    assert torch.equal(k5_t, k2_t)
    assert torch.equal(k5_c, k2_c)


@pytest.fixture(scope="module")
def chd50k(tok50k):
    """The 50K tables on the card with the vocabulary's CHD table beside
    the cuckoo table, so that K5 runs on the rows K2 runs on."""
    _need_card()
    dt = tok50k.device_tables()
    chd = build_chd_table(tok50k.bpe.merge_ranks, tok50k.bpe.merge_ops)
    return tables_to_device(
        byte_token_table=dt.byte_token_table, class_table=gpt2_class_table(), device="cuda",
        qc_t1=dt.qc.t1, qc_t2=dt.qc.t2, qc_size=dt.qc.size, chd_disp=chd.disp, chd_rows=chd.rows,
    )


def _letters(n, seed):
    """n lowercase bytes of corpus words run together: text-like pairs."""
    text = "".join(zipf_corpus(max(8, n // 40), seed=seed)).encode("utf-8")
    letters = bytes(c for c in text if 0x61 <= c <= 0x7A)
    while len(letters) < n:
        letters += letters
    return letters[:n]


def _word_rows(words_per_row, L, seed=0):
    """[B, L] bytes and word ids on the card: each row's words side by
    side, each its own word id, -1 past them."""
    B = len(words_per_row)
    arr = np.zeros((B, L), np.uint8)
    wid = np.full((B, L), -1, np.int32)
    for r, words in enumerate(words_per_row):
        pos = 0
        for w, word in enumerate(words):
            assert pos + len(word) <= L
            arr[r, pos : pos + len(word)] = np.frombuffer(word, np.uint8)
            wid[r, pos : pos + len(word)] = w
            pos += len(word)
    return torch.from_numpy(arr).cuda(), torch.from_numpy(wid).cuda()


def _check_k5(tok100k, chd50k, arr, wid, oov=()):
    """K5 bit for bit against its plain version at 100K, and at 50K
    against its plain version and K2, on the rows ``arr`` (bytes) with the
    word ids ``wid``; the bytes ``oov`` are OOV (tombstones from the
    start).  Tokens are the seed of each vocabulary's byte table, -1 where
    the word id is -1."""
    _need_card()
    for tb, k2 in ((tok100k.pipeline("cuda").tables, False), (chd50k, True)):
        table = tb.byte_token_table.clone()
        if oov:
            table[list(oov)] = -1
        tokens = torch.where(wid >= 0, table[arr.long()], -1).to(torch.int32).contiguous()
        args = _chd_args(tb)
        before = merge_words.launches
        got_t, got_c = merge_words(tokens, wid, *args)
        torch.cuda.synchronize()
        assert merge_words.launches == before + 1
        exp_t, exp_c = merge_fixpoint_chd_plain(tokens, wid, *args)
        assert torch.equal(got_t, exp_t)
        assert torch.equal(got_c, exp_c)
        if k2:
            k2_t, k2_c = merge_words_qc(tokens, wid, tb.qc_t1, tb.qc_t2, tb.qc_size)
            torch.cuda.synchronize()
            assert torch.equal(got_t, k2_t)
            assert torch.equal(got_c, k2_c)
    return got_t


def test_k5_row_of_every_word_length(tok100k, chd50k):
    """One row holding words of every length from 1 to 128 (8,256 bytes),
    each on the path its length picks (a lane, or a warp past 32 bytes),
    with the row's first probe round in three groups of the block's
    positions."""
    letters = _letters(8256, seed=31)
    words, off = [], 0
    for n in range(1, 129):
        words.append(letters[off : off + n])
        off += n
    arr, wid = _word_rows([words], 8256)
    _check_k5(tok100k, chd50k, arr, wid)


@pytest.mark.parametrize("L", [64, 256, 257, 512])
def test_k5_words_at_the_thresholds(tok100k, chd50k, L):
    """Words of 31 to 34 bytes (the lane / warp threshold of 32) and of
    one and two bytes, in rows of 256 bytes (64 threads a block) and 257
    (128 threads), and in narrower and wider rows; text words and runs of
    one letter."""
    rng = np.random.RandomState(L)
    rows = []
    for r in range(24):
        letters = _letters(4 * L, seed=r)
        words, n = [], 0
        while True:
            size = int(rng.choice([1, 2, 31, 32, 33, 34, 3, 8]))
            if n + size > L:
                break
            word = letters[n : n + size] if r % 3 else bytes([letters[n]]) * size
            words.append(word)
            n += size
        rows.append(words)
    arr, wid = _word_rows(rows, L)
    _check_k5(tok100k, chd50k, arr, wid)


def test_k5_oov_bytes_and_words_that_never_merge(tok100k, chd50k):
    """OOV bytes inside words (tombstones from the start, also at the
    32-entry chunk edges of warp words, and in runs longer than the first
    round's reach), words made only of bytes whose pairs are all misses,
    and words of one OOV byte between them."""
    rng = np.random.RandomState(7)
    rows = []
    for r in range(32):
        letters = bytearray(_letters(600, seed=40 + r))
        for q in rng.choice(600, 40, replace=False):
            letters[q] = ord("Q")  # made OOV below
        for q in (31, 32, 33, 63, 64):
            letters[q] = ord("Z")
        words = [bytes(letters[:100]), bytes(letters[100:103]), b"Q",
                 bytes(rng.randint(0xF5, 0x100, size=40).astype(np.uint8)),
                 bytes(rng.randint(0xF5, 0x100, size=7).astype(np.uint8)),
                 bytes(letters[103:140]), b"QQQQ", bytes(letters[140:160]),
                 # OOV runs longer than the first round's reach (8), inside a
                 # lane's word and inside a warp's
                 bytes(letters[160:163]) + b"Q" * 20 + bytes(letters[163:167]),
                 b"x" + b"Q" * 120 + bytes(letters[167:180]),
                 bytes(letters[180:182]) + b"Q" * 9 + bytes(letters[182:184])]
        rows.append(words)
    arr, wid = _word_rows(rows, 512)
    _check_k5(tok100k, chd50k, arr, wid, oov=(ord("Q"), ord("Z")))


def test_k5_row_at_the_wrapper_limit(tok100k, chd50k):
    """One word of 12,288 bytes (the wrapper's limit: its shared memory)
    runs; a row of 12,289 raises before any launch."""
    arr, wid = _word_rows([[_letters(12288, seed=5)]], 12288)
    _check_k5(tok100k, chd50k, arr, wid)
    tb = tok100k.pipeline("cuda").tables
    over = torch.zeros((1, 12289), dtype=torch.int32, device="cuda")
    before = merge_words.launches
    with pytest.raises(ValueError):
        merge_words(over, over, *_chd_args(tb))
    assert merge_words.launches == before


@pytest.mark.parametrize("L", [256, 1024, 4096])
def test_k5_long_word_finishes_after_the_short_words(tok100k, chd50k, L):
    """Rows of one long word (a run of one letter, or text) among many
    short words, the long word first or last: the short words are done
    long before it, with no barrier between them."""
    rows = []
    for r in range(16):
        letters = _letters(L, seed=60 + r)
        long = b"a" * (L // 2) if r % 2 else letters[: L // 2]
        shorts = [letters[L // 2 + i : L // 2 + i + 5] for i in range(0, L // 2 - 5, 5)]
        rows.append([long] + shorts if r % 4 < 2 else shorts + [long])
    arr, wid = _word_rows(rows, L)
    _check_k5(tok100k, chd50k, arr, wid)


def test_100k_paths_on_card_match_host(tok100k):
    """At 100K: backend="device", "auto" (drained, then again) and the text
    pipeline on the card equal the host oracle; the word path launched K6
    (K5's walk inside it) and the text pipeline K5."""
    _need_card()
    tok = Tokenizer.from_file(BENCH_100K)
    texts = zipf_corpus(500, seed=15) + list(MULTI_PIECES) + ["a" * 5000, "x </s> y", "", " "]
    host = tok.encode_batch(texts, backend="host")
    before = word_merge.launches
    assert tok.encode_batch(texts, backend="device") == host
    assert word_merge.launches > before
    auto = Tokenizer.from_file(BENCH_100K)
    assert auto.encode_batch(texts, backend="auto") == host
    auto._auto_word_path().drain_async(timeout=300)
    assert auto.encode_batch(texts, backend="auto") == host
    data = tok._prepare_bytes([tok._normalize(t) for t in texts[:500]])
    before = merge_words.launches
    assert tok.pipeline().encode_bytes(data) == host[:500]
    assert merge_words.launches > before


def test_100k_word_fill_on_card_matches_cpu(tok100k):
    """The whole fill at 100K (K3, K1, K5, K4 with int32 ids) on the card
    equals the plain versions on the CPU, byte for byte."""
    _need_card()
    wp = tok100k._get_word_path("cuda")
    assert np.dtype(wp._out_dtype).itemsize == 4
    words = sorted({w.encode() for t in zipf_corpus(3000, seed=19) for w in t.split()})
    buf = np.frombuffer(b"".join(words), np.uint8)
    offs = np.zeros(len(words) + 1, np.int64)
    np.cumsum([len(w) for w in words], out=offs[1:])
    cpu_tables = tok100k.pipeline("cpu").tables
    for B in (64, 256, 1024):
        arr, marks, _starts, _n_fit, _rows = wp._pack_seg(buf, offs, 0, len(words), B)
        bits = np.packbits(marks == 1, axis=1, bitorder="little")
        row_len = (marks > 0).sum(axis=1).astype(np.int32)
        for cap in (B * 128 * 3 // 8, B * 128):
            args = [torch.from_numpy(x) for x in (arr, bits, row_len)]
            exp = word_fill(*args, cap, tables=cpu_tables, itemsize=4)
            got = word_fill(*(x.cuda() for x in args), cap,
                            tables=wp.pipeline.tables, itemsize=4)
            assert torch.equal(got.cpu(), exp), (B, cap)


def test_encode_batch_on_card_matches_host(tok50k):
    _need_card()
    texts = zipf_corpus(500, seed=5) + ["a" * 5000, "x </s> y", "", " "]
    assert tok50k.encode_batch(texts, backend="device") == tok50k.encode_batch(
        texts, backend="host"
    )


def test_text_pipeline_on_card_matches_host(tok50k):
    _need_card()
    texts = zipf_corpus(500, seed=6) + ["a" * 5000, "", " "]
    data = tok50k._prepare_bytes([tok50k._normalize(t) for t in texts])
    assert tok50k.pipeline().encode_bytes(data) == tok50k.encode_batch(texts, backend="host")


def _start_bits(rng, B, W, lens):
    """Random start bitmaps whose rows start a word at column 0 (as
    ctok_pack_seg packs them)."""
    starts = rng.rand(B, W) < 0.2
    starts[:, 0] = lens > 0
    return np.packbits(starts, axis=1, bitorder="little")


# word-path packs, then edge shapes: one row, W not a multiple of 128, B not
# a multiple of the kernel's 8 rows a block
WORD_SHAPES = [(64, 128), (256, 128), (1024, 128), (1, 8), (3, 200), (1025, 128), (9, 32)]


@pytest.mark.parametrize("B,W", WORD_SHAPES)
def test_word_ids_kernel_matches_plain(B, W):
    """K3 bit for bit against its plain version, with rows of length 0 and
    W among random lengths."""
    _need_card()
    rng = np.random.RandomState(B * 7 + W)
    lens = rng.randint(0, W + 1, size=B).astype(np.int32)
    lens[: min(B, 2)] = [0, W][: min(B, 2)]
    bits = torch.from_numpy(_start_bits(rng, B, W, lens)).cuda()
    lens = torch.from_numpy(lens).cuda()
    before = word_ids.launches
    got = word_ids(bits, lens)
    torch.cuda.synchronize()
    assert word_ids.launches == before + 1
    assert torch.equal(got, word_ids_plain(bits, lens))


def _merged_rows(rng, B, W, dead):
    merged = rng.randint(0, 65535, size=(B, W)).astype(np.int32)
    merged[rng.rand(B, W) < dead] = -1
    merged[0] = -1  # a row with no live id
    if B > 1:
        merged[1] = rng.randint(0, 65535, size=W)  # a row of W live ids
    count = (merged >= 0).sum(axis=1).astype(np.int32)
    return torch.from_numpy(merged).cuda(), torch.from_numpy(count).cuda()


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("B,W", WORD_SHAPES)
def test_fill_compact_kernel_matches_plain(B, W, itemsize):
    """K4 bit for bit against its plain version at the compact capacity
    (3/8 of the lanes, with and without overflow), at full capacity and at
    capacity 0."""
    _need_card()
    rng = np.random.RandomState(B * 5 + W + itemsize)
    for dead, cap in ((0.8, B * W * 3 // 8), (0.3, B * W * 3 // 8), (0.3, B * W), (0.5, 0)):
        merged, count = _merged_rows(rng, B, W, dead)
        before = fill_compact.launches
        got = fill_compact(merged, count, cap, itemsize)
        torch.cuda.synchronize()
        assert fill_compact.launches == before + 1
        assert torch.equal(got, fill_compact_plain(merged, count, cap, itemsize)), (dead, cap)


def test_word_fill_on_card_matches_cpu(tok50k):
    """The whole fill (K3, K1, K2, K4) on the card equals the plain
    versions on the CPU, byte for byte, on packs of corpus words."""
    _need_card()
    wp = tok50k._get_word_path("cuda")
    words = sorted({w.encode() for t in zipf_corpus(3000, seed=9) for w in t.split()})
    buf = np.frombuffer(b"".join(words), np.uint8)
    offs = np.zeros(len(words) + 1, np.int64)
    np.cumsum([len(w) for w in words], out=offs[1:])
    for B in (64, 256, 1024):
        arr, marks, _starts, _n_fit, _rows = wp._pack_seg(buf, offs, 0, len(words), B)
        bits = np.packbits(marks == 1, axis=1, bitorder="little")
        row_len = (marks > 0).sum(axis=1).astype(np.int32)
        for cap in (B * 128 * 3 // 8, B * 128):
            args = [torch.from_numpy(x) for x in (arr, bits, row_len)]
            cpu_tables = tok50k.pipeline("cpu").tables
            exp = word_fill(*args, cap, tables=cpu_tables, itemsize=2)
            got = word_fill(*(x.cuda() for x in args), cap,
                            tables=wp.pipeline.tables, itemsize=2)
            assert torch.equal(got.cpu(), exp), (B, cap)


def test_word_path_on_card_matches_host_merge(tok50k):
    """Every distinct word of a corpus through the device on a fresh native
    context: each word covered, its ids those of the host merge."""
    _need_card()
    from complexity_tokenizer_tpu_torch.native import NativeEncoder
    from complexity_tokenizer_tpu_torch.ops.tables import byte_token_table
    from complexity_tokenizer_tpu_torch.ops.wordpath import DeviceWordEncoder

    def fresh():
        return NativeEncoder(tok50k.bpe.packed_merge_arrays(), byte_token_table(tok50k.bpe.vocab))

    texts = zipf_corpus(2000, seed=11) + list(MULTI_PIECES)
    data = tok50k._prepare_bytes([tok50k._normalize(t) for t in texts])
    wp = DeviceWordEncoder(tok50k.pipeline("cuda"), fresh())
    words, lens = wp.native.collect_miss_words(data, 128)
    assert len(lens) > 1000
    ids, counts = wp._encode_words_packed(words, lens)
    exp_ids, exp_counts = fresh().warm_start(words, lens)
    assert (counts >= 0).all()
    assert np.array_equal(counts, exp_counts)
    assert np.array_equal(ids, exp_ids)


def test_auto_on_card_matches_host(tok50k):
    _need_card()
    tok = Tokenizer.from_file(BENCH_50K)
    texts = zipf_corpus(800, seed=12) + list(MULTI_PIECES) + ["x </s> y"]
    host = tok.encode_batch(texts, backend="host")
    assert tok.encode_batch(texts, backend="auto") == host
    wp = tok._auto_word_path()
    wp.drain_async(timeout=300)
    assert wp.words_filled > 0
    assert tok.encode_batch(texts, backend="auto") == host
    flat, offs = tok.encode_batch_ragged(texts, backend="auto")
    assert [flat[offs[i] : offs[i + 1]].tolist() for i in range(len(texts))] == host


def test_wrappers_refuse_bad_inputs_on_card():
    _need_card()
    arr = torch.zeros((2, 20), dtype=torch.uint8, device="cuda")  # W % 16 != 0
    with pytest.raises(ValueError):
        seed_tokens(arr, torch.zeros(2, dtype=torch.int32, device="cuda"),
                    torch.zeros(256, dtype=torch.int32, device="cuda"))
    t = torch.zeros((2, 16), dtype=torch.int32, device="cuda")
    tab = torch.zeros((64, 2), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):  # table on the wrong device
        merge_words_qc(t, t, tab.cpu(), tab, 64)
    disp = torch.zeros(16, dtype=torch.int32, device="cuda")
    rows = torch.zeros((65, 4), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):  # rows of the wrong shape
        merge_words(t, t, disp, rows[:32], 64, 16)
    with pytest.raises(ValueError):  # rows not 16-byte aligned
        merge_words(t, t, disp, rows.view(-1)[2:258].view(64, 4), 64, 16)
    with pytest.raises(ValueError):  # a size that is not a power of two
        merge_words(t, t, disp, rows[:48], 48, 16)
    long = torch.zeros((1, 16384), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):  # rows past K5's shared memory
        merge_words(long, long, disp, rows[:64], 64, 16)
    bits = torch.zeros((2, 16), dtype=torch.uint8, device="cuda")
    with pytest.raises(ValueError):  # row_len of the wrong dtype
        word_ids(bits, torch.zeros(2, dtype=torch.int64, device="cuda"))
    with pytest.raises(ValueError):  # count of the wrong shape
        fill_compact(t, torch.zeros(3, dtype=torch.int32, device="cuda"), 8, 2)
    with pytest.raises(ValueError):  # cap past the lanes
        fill_compact(t, torch.zeros(2, dtype=torch.int32, device="cuda"), 33, 2)


# --- K6: the word path's fill in one launch ---------------------------------


def _fill_tables(name, tok50k, tok100k, chd50k):
    """(probe, tables) of a configuration: the 50K cuckoo table (K2's walk),
    the 50K CHD table (K5's walk on ids that fit u16), the 100K CHD table."""
    if name == "qc50k":
        return "qc", tok50k.pipeline("cuda").tables
    if name == "chd50k":
        return "chd", chd50k
    return "chd", tok100k.pipeline("cuda").tables


def _k6(probe, tb, args):
    """K6 on a pack: (merged, count)."""
    if probe == "qc":
        return word_merge_qc(*args, tb.byte_token_table, tb.qc_t1, tb.qc_t2, tb.qc_size)
    return word_merge_chd(*args, tb.byte_token_table, *_chd_args(tb))


def _fill(probe, tb, args, cap, itemsize):
    """The fill of the word path: K6, then K4."""
    return fill_compact(*_k6(probe, tb, args), cap, itemsize)


def _chain(probe, tb, args, cap, itemsize):
    """The parent's fill, four launches: K3 -> K1 -> K2 or K5 -> K4."""
    a, bits, row_len = args
    wid = word_ids(bits, row_len)
    tokens = seed_tokens(a, row_len, tb.byte_token_table)
    if probe == "qc":
        merged, count = merge_words_qc(tokens, wid, tb.qc_t1, tb.qc_t2, tb.qc_size)
    else:
        merged, count = merge_words(tokens, wid, *_chd_args(tb))
    return fill_compact(merged, count, cap, itemsize)


def _fill_pack(kind, B, seed):
    """Word rows [B, 128] on the card: ``edge_word_pack`` rows of corpus
    words (every edge case of the fill: runs before the first start bit,
    rows of length 0 and 128, OOV bytes and runs, a long one-letter word),
    rows of one 128-byte word of one letter, or ``edge_word_pack`` rows of
    ``.`` runs (a byte in no merge: the compact capacity spills)."""
    if kind == "one_letter":
        a = np.full((B, 128), ord("a"), np.uint8)
        starts = np.zeros((B, 128), bool)
        starts[:, 0] = True
        packed = (a, np.packbits(starts, axis=1, bitorder="little"), np.full(B, 128, np.int32))
    else:
        words = ([w.encode() for t in zipf_corpus(400, seed=seed) for w in t.split()]
                 if kind == "edges" else [b"." * n for n in range(1, 24)])
        packed = edge_word_pack(words, B, seed=seed)
    return tuple(torch.from_numpy(x).cuda() for x in packed)


@pytest.mark.parametrize("kind", ["edges", "one_letter", "dots"])
@pytest.mark.parametrize("B", [1, 7, 64, 256, 1024])
@pytest.mark.parametrize(
    "config,itemsize", [("qc50k", 2), ("qc50k", 4), ("chd50k", 2), ("chd100k", 4)]
)
def test_k6_matches_the_four_launch_chain(tok50k, tok100k, chd50k, config, itemsize, B, kind):
    """K6 then K4 equal K3 -> K1 -> fixpoint -> K4 and the plain composition
    byte for byte, on both probes and both id widths, at the compact and the
    full capacity; K6's merged rows and counts equal the chain's and its
    plain version's; one launch of each a call."""
    _need_card()
    probe, tb = _fill_tables(config, tok50k, tok100k, chd50k)
    args = _fill_pack(kind, B, seed=B)
    a, bits, row_len = args
    merged, count = _k6(probe, tb, args)
    wid = word_ids(bits, row_len)
    tokens = seed_tokens(a, row_len, tb.byte_token_table)
    if probe == "qc":
        exp_merged, exp_count = merge_words_qc(tokens, wid, tb.qc_t1, tb.qc_t2, tb.qc_size)
    else:
        exp_merged, exp_count = merge_words(tokens, wid, *_chd_args(tb))
    assert torch.equal(merged, exp_merged) and torch.equal(count, exp_count)
    if config != "chd50k":
        plain = word_merge_plain(*args, tables=tb)
        assert torch.equal(merged, plain[0]) and torch.equal(count, plain[1])
    for cap in (B * 128 * 3 // 8, B * 128):
        before = (word_merge.launches, fill_compact.launches)
        got = _fill(probe, tb, args, cap, itemsize)
        torch.cuda.synchronize()
        assert (word_merge.launches, fill_compact.launches) == (before[0] + 1, before[1] + 1)
        exp = _chain(probe, tb, args, cap, itemsize)
        assert torch.equal(got, exp), (cap,)
        if config != "chd50k":
            plain = word_fill_plain(*args, cap, tables=tb, itemsize=itemsize)
            assert torch.equal(got, plain), (cap,)
    total = int(got[-4:].cpu().numpy().view(np.int32)[0])
    if kind == "dots" and B > 1:
        assert total > B * 128 * 3 // 8  # the compact capacity spilled


def test_k6_graph_replays_give_the_same_buffer(tok100k):
    """The fill (K6, K4) captured in a CUDA graph and replayed twice gives
    the eager buffer each time."""
    _need_card()
    tb = tok100k.pipeline("cuda").tables
    args = _fill_pack("edges", 256, seed=3)
    cap = 256 * 128 * 3 // 8
    exp = word_fill(*args, cap, tables=tb, itemsize=4).clone()
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        word_fill(*args, cap, tables=tb, itemsize=4)
    s.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=s):
        out = word_fill(*args, cap, tables=tb, itemsize=4)
    for _ in range(2):
        out.zero_()
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, exp)


def test_k6_on_two_streams_at_once(tok50k):
    """Fills of two packs on two streams, issued in turns with no
    synchronisation between them, each give their own right buffer."""
    _need_card()
    tb = tok50k.pipeline("cuda").tables
    packs = [_fill_pack("edges", 1024, seed=5), _fill_pack("dots", 256, seed=6)]
    caps = [1024 * 128 * 3 // 8, 256 * 128]
    exp = [_chain("qc", tb, p, c, 2) for p, c in zip(packs, caps)]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    outs = [[], []]
    for _ in range(20):
        for k, st in enumerate(streams):
            with torch.cuda.stream(st):
                outs[k].append(word_fill(*packs[k], caps[k], tables=tb, itemsize=2))
    torch.cuda.synchronize()
    for k in range(2):
        for got in outs[k]:
            assert torch.equal(got, exp[k])


def test_word_path_fills_in_two_launches_a_pack(tok50k):
    """On backend="device" every pack's fill is one K6 and one K4 launch,
    and K3, K1 and the standalone fixpoint are not launched."""
    _need_card()
    tok = Tokenizer.from_file(BENCH_50K)
    texts = zipf_corpus(1500, seed=21) + list(MULTI_PIECES)
    host = tok.encode_batch(texts, backend="host")
    wp = tok._get_word_path("cuda")
    counted = (word_merge, fill_compact, word_ids, seed_tokens, merge_words_qc, merge_words)
    before = [fn.launches for fn in counted]
    assert tok.encode_batch(texts, backend="device") == host
    launched = [fn.launches - b for fn, b in zip(counted, before)]
    fill = wp.last_fill
    assert wp.words_filled > 0
    assert launched[0] == launched[1] == sum(fill["packs"].values()) + fill["spills"] > 0
    assert launched[2:] == [0] * 4


@pytest.mark.parametrize("chd", [False, True])
def test_k6_launch_shape(chd):
    """K6's launch at the word path's rows: K2's or K5's threads a block
    and shared memory, no more registers than the launch bound allows."""
    _need_card()
    walk = launch_shape(128, chd=chd)
    fill = launch_shape(128, chd=chd, fill=True)
    assert fill["threads"] == walk["threads"]
    assert fill["dynamic_smem"] == walk["dynamic_smem"]
    assert fill["blocks_per_sm"] >= 1


def test_k6_refuses_bad_inputs(tok50k):
    _need_card()
    tb = tok50k.pipeline("cuda").tables
    a, bits, row_len = _fill_pack("edges", 4, seed=7)
    with pytest.raises(ValueError):  # cap past the lanes
        word_fill(a, bits, row_len, 4 * 128 + 1, tables=tb, itemsize=2)
    with pytest.raises(ValueError):  # ids of 3 bytes
        word_fill(a, bits, row_len, 8, tables=tb, itemsize=3)
    with pytest.raises(ValueError):  # row_len of the wrong dtype
        word_fill(a, bits, row_len.long(), 8, tables=tb, itemsize=2)
    with pytest.raises(ValueError):  # start bits of the wrong width
        word_fill(a, bits[:, :8].contiguous(), row_len, 8, tables=tb, itemsize=2)
    with pytest.raises(ValueError):  # W not a multiple of 8
        word_fill(a[:, :20].contiguous(), bits[:, :2].contiguous(), row_len, 8, tables=tb,
                  itemsize=2)


# K7, the decode gather


def _decode_pipe(tok):
    return tok.decode_pipeline("cuda")


def _long_pipe(seed=0):
    """The long-token vocabulary (tokens to 20,000 bytes, past K7's 16 KB
    staging window) on the card, and its special ids."""
    vocab_r, special = long_token_vocab(seed=seed)
    return DecodePipeline(build_decode_tables(vocab_r, special), "cuda"), special


def _ragged(rows):
    offs = np.zeros(len(rows) + 1, np.int64)
    np.cumsum([len(r) for r in rows], out=offs[1:])
    flat = np.concatenate([np.asarray(r, np.int64) for r in rows]) if offs[-1] else np.zeros(0)
    return (torch.from_numpy(flat.astype(np.int32)).cuda(), torch.from_numpy(offs).cuda())


def _decode_edge_rows(V, special, rng):
    """Empty rows first and last, one-id rows, pads, negatives, ids >= V,
    specials, rows across tile edges (1,024 ids) and a 4,096-id row."""
    rows = [[], [], [0], [V - 1], [-1], [V], [special[0]], [-(2**31)], [2**31 - 1]]
    for n in (1023, 1024, 1025, 4096, 3, 2048 + 7):
        r = rng.randint(0, V, size=n)
        kinds = rng.randint(0, 10, size=n)
        r = np.where(kinds == 0, -1, r)
        r = np.where(kinds == 1, V + rng.randint(0, 100, size=n), r)
        r = np.where(kinds == 2, rng.choice(special, size=n), r)
        rows.append(r.tolist())
        rows += [[]] * int(rng.randint(0, 3))
    return rows + [[], []]


def _check_k7(pipe, rows, skip, cpu=True):
    """K7 on ``rows`` bit for bit against its plain version on the card (and
    on the CPU): one launch when there is an id, no byte written past the
    live part of the buffer."""
    ids, offs = _ragged(rows)
    B = len(rows)
    cap = ids.numel() * pipe.max_len
    room = torch.full((8 * (B + 1) + cap + 64,), 0xAB, dtype=torch.uint8, device="cuda")
    before = decode_gather.launches
    got = decode_gather(ids, offs, pipe.entries, pipe.arena, skip, cap, out=room)
    torch.cuda.synchronize()
    assert decode_gather.launches == before + (1 if ids.numel() else 0)
    exp = decode_gather_plain(ids, offs, pipe.entries, pipe.arena, skip)
    assert torch.equal(live_part(got, B), exp)
    assert bool((room[exp.numel():] == 0xAB).all())
    if cpu:
        host = decode_gather_plain(ids.cpu(), offs.cpu(), pipe.entries.cpu(), pipe.arena.cpu(), skip)
        assert torch.equal(exp.cpu(), host)
    return exp


@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("vocab", ["50k", "100k"])
def test_k7_matches_plain_on_edge_rows(tok50k, tok100k, vocab, skip):
    """K7 (one launch) bit for bit against its plain version on the card
    and on the CPU."""
    _need_card()
    tok = tok50k if vocab == "50k" else tok100k
    pipe = _decode_pipe(tok)
    V = pipe.V
    rng = np.random.RandomState(V % 1000 + skip)
    special = sorted(tok.special_tokens.values())
    for rows in (_decode_edge_rows(V, special, rng), [[]] * 5, [[1, 2, 3]], [[]] * 3 + [[5]]):
        _check_k7(pipe, rows, skip)


@pytest.mark.parametrize("skip", [False, True])
def test_k7_long_tokens_and_staging_windows(skip):
    """Tokens past the 12 inline bytes (13 to 300 bytes), one longer than
    the 16 KB staging window, ids missing from the vocabulary, negatives and
    ids >= V: tiles of several windows, bit for bit."""
    _need_card()
    pipe, special = _long_pipe()
    V = pipe.V
    rng = np.random.RandomState(3 + skip)
    rows = [rng.randint(-3, V + 3, size=n).tolist() for n in (0, 1, 700, 3000, 0, 1025, 5)]
    rows += [[9] * 3, [9, 3, 21, 9], _decode_edge_rows(V, special, rng)[12]]
    exp = _check_k7(pipe, rows, skip)
    assert exp.numel() - 8 * (len(rows) + 1) > 3 * 16384


def test_k7_tiles_start_at_every_residue():
    """Tile 1's bytes start at every residue mod 16 of the output address:
    r one-byte ids, then the rest of tile 0 ids without bytes."""
    _need_card()
    pipe, _special = _long_pipe()
    rng = np.random.RandomState(4)
    one, none = 1, 15  # ids of 1 and 0 bytes in long_token_vocab
    for r in range(16):
        row = [one] * r + [none] * (1024 - r) + rng.randint(0, pipe.V, size=900).tolist()
        _check_k7(pipe, [[], row[:1500], row[1500:], []], r % 2 == 0, cpu=False)


@pytest.mark.parametrize("skip", [False, True])
def test_k7_small_batches_and_tile_edges(tok50k, skip):
    """Every id dropped (no byte out), a single id, and 1,024 k and 1,024 k
    + 1 ids."""
    _need_card()
    pipe = _decode_pipe(tok50k)
    V = pipe.V
    rng = np.random.RandomState(5)
    sp = sorted(tok50k.special_tokens.values())
    exp = _check_k7(pipe, [[-1] * 3000, [V] * 5, [], sp * 7], skip)
    assert (exp.numel() == 8 * 5) == skip
    _check_k7(pipe, [[7]], skip)
    for n in (1024, 2048, 2049, 4097):
        _check_k7(pipe, [rng.randint(0, V, size=n).tolist()], skip, cpu=False)


def test_k7_writes_nothing_past_its_capacity(tok50k):
    """With a capacity below the byte total, K7 writes the bytes up to it
    and none past it; the row offsets are whole."""
    _need_card()
    pipe = _decode_pipe(tok50k)
    rows = [tok50k.encode(t) for t in zipf_corpus(40, seed=12)]
    ids, offs = _ragged(rows)
    B = len(rows)
    exp = decode_gather_plain(ids, offs, pipe.entries, pipe.arena, False)
    for cap in (0, 1, 17, exp.numel() - 8 * (B + 1) - 5):
        room = torch.full((8 * (B + 1) + cap + 64,), 0xAB, dtype=torch.uint8, device="cuda")
        decode_gather(ids, offs, pipe.entries, pipe.arena, False, cap, out=room)
        torch.cuda.synchronize()
        assert torch.equal(room[: 8 * (B + 1) + cap], exp[: 8 * (B + 1) + cap])
        assert bool((room[8 * (B + 1) + cap :] == 0xAB).all())


def test_k7_graph_replays_over_the_same_buffers(tok100k):
    """One CUDA graph of K7, captured once, replayed over the same buffers
    with other ids each time: every replay equals the plain version, so K7
    returns its state to zero itself (no memset node in the graph)."""
    _need_card()
    pipe = _decode_pipe(tok100k)
    rng = np.random.RandomState(6)
    V = pipe.V
    ids, offs = _ragged([rng.randint(0, V, size=3000).tolist(), [], [9, 9],
                         rng.randint(-5, V + 5, size=2100).tolist()])
    B = offs.numel() - 1
    cap = ids.numel() * pipe.max_len
    out = torch.empty(8 * (B + 1) + cap, dtype=torch.uint8, device="cuda")
    state = decode_state(ids.numel(), "cuda")
    decode_gather(ids, offs, pipe.entries, pipe.arena, True, cap, out=out, state=state)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        decode_gather(ids, offs, pipe.entries, pipe.arena, True, cap, out=out, state=state)
    for seed in (7, 8, 9):
        ids.copy_(torch.from_numpy(np.random.RandomState(seed).randint(-2, V, size=ids.numel())
                                   .astype(np.int32)))
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(live_part(out, B), decode_gather_plain(ids, offs, pipe.entries, pipe.arena, True))
    assert not state.any()


def test_k7_launch_shape():
    """K7's block: 256 threads, at most 48 registers, 5 resident an SM."""
    _need_card()
    shape = decode_launch_shape()
    assert shape["threads"] == 256 and shape["registers"] <= 48, shape
    assert shape["blocks_per_sm"] == 5, shape


def test_decode_pipeline_on_card_matches_host(tok50k, tok100k):
    """decode_pipeline("cuda") (K7) and its ragged form equal the host
    decode and the native decoder's rows, both skip settings."""
    _need_card()
    texts = zipf_corpus(300, seed=9) + list(MULTI_PIECES) + ["a </s> b <s>", ""]
    for tok in (tok50k, tok100k):
        rows = [tok.encode(t) for t in texts] + [[tok.special_tokens["</s>"], 5, -1, 10**6]]
        ids, offs = _ragged(rows)
        for skip in (False, True):
            host = [tok._decode_impl(r, skip, False) for r in rows]
            pipe = tok.decode_pipeline("cuda")
            assert pipe.decode_batch(rows, skip) == host
            assert pipe.decode_ragged(ids.cpu().numpy(), offs.cpu().numpy(), skip) == host
            native, flagged = tok._get_native_decoder().decode_batch(rows, skip, False)
            assert flagged == [] and native == host


def test_k7_refuses_bad_inputs(tok50k):
    _need_card()
    pipe = _decode_pipe(tok50k)
    entries, arena = pipe.entries, pipe.arena
    ids = torch.zeros(4, dtype=torch.int32, device="cuda")
    offs = torch.tensor([0, 4], dtype=torch.int64, device="cuda")
    with pytest.raises(ValueError):  # ids of the wrong dtype
        decode_gather(ids.long(), offs, entries, arena, False, 64)
    with pytest.raises(ValueError):  # offsets on the CPU
        decode_gather(ids, offs.cpu(), entries, arena, False, 64)
    with pytest.raises(ValueError):  # entries not [V, 4]
        decode_gather(ids, offs, entries[:, :3].contiguous(), arena, False, 64)
    with pytest.raises(ValueError):  # entries of the wrong dtype
        decode_gather(ids, offs, entries.view(torch.uint8), arena, False, 64)
    with pytest.raises(ValueError):  # entries not contiguous
        decode_gather(ids, offs, entries.t(), arena, False, 64)
    with pytest.raises(ValueError):  # entries off a 16-byte boundary
        decode_gather(ids, offs, entries.view(-1)[1:-3].view(-1, 4), arena, False, 64)
    with pytest.raises(ValueError):  # the arena not padded to 16 bytes
        decode_gather(ids, offs, entries, arena[:-1], False, 64)
    with pytest.raises(ValueError):  # an output buffer too small
        decode_gather(ids, offs, entries, arena, False, 64,
                      out=torch.empty(64, dtype=torch.uint8, device="cuda"))
    with pytest.raises(ValueError):  # a state too small
        decode_gather(torch.zeros(5000, dtype=torch.int32, device="cuda"),
                      torch.tensor([0, 5000], dtype=torch.int64, device="cuda"), entries, arena,
                      False, 64, state=torch.zeros(3, dtype=torch.int64, device="cuda"))


@pytest.mark.parametrize("padding", [True, "max_length"])
def test_call_pt_tensors_on_card_equal_cpu(tok50k, padding):
    """``__call__(..., return_tensors="pt")`` on the card: every field an
    int32 tensor on ``cuda``, equal to the ``device="cpu"`` result; the
    ``add_special_tokens=False`` route on the card launches K6 and K4 and
    gives the host oracle's ids."""
    _need_card()
    texts = zipf_corpus(300, seed=9) + ["", "a" * 700, "x </s> y"]
    kw = dict(padding=padding, truncation=True, max_length=128, return_special_tokens_mask=True,
              return_tensors="pt")
    for side in ("right", "left"):
        tok50k.padding_side = side
        card, cpu = tok50k(texts, **kw), tok50k(texts, device="cpu", **kw)
        for k in ("input_ids", "attention_mask", "token_type_ids", "special_tokens_mask"):
            a, b = card[k], cpu[k]
            assert a.device.type == "cuda" and a.dtype == b.dtype == torch.int32, k
            assert torch.equal(a.cpu(), b), k
    tok50k.padding_side = "right"
    fresh = Tokenizer.from_file(BENCH_50K)
    fresh.encode_backend = "device"
    word_merge.launches = fill_compact.launches = 0
    got = fresh(texts, add_special_tokens=False)
    torch.cuda.synchronize()
    assert [e.ids for e in got.encodings()] == fresh.encode_batch(texts, backend="host")
    assert word_merge.launches > 0 and word_merge.launches == fill_compact.launches


# ---------------------------------------------------------------------------
# K8: the normalization check; K9-K11: the word-level models' tiers


def _norm_bitmaps():
    from complexity_tokenizer_tpu_torch.core import normalizers as N
    from complexity_tokenizer_tpu_torch.ops.normalize_device import plan_for_normalizer

    return {name: torch.from_numpy(plan_for_normalizer(n).bitmap).cuda()
            for name, n in (("nfc", N.NFC()), ("bert", N.BertNormalizer()),
                            ("lowercase", N.Lowercase()))}


def _norm_rows(B, L, seed):
    """[B, L] rows: corpus text with multilingual pieces, random bytes
    (past each row's length too) and all-continuation bytes; lengths from
    -1 to past L."""
    rng = np.random.RandomState(seed)
    texts = zipf_corpus(B, seed=seed, lo=1, hi=L) + list(MULTI_PIECES)
    rows = [" ".join(texts[i: i + 3]).encode()[:L] for i in range(B)]
    arr, lens = pack_texts(rows, L, B)
    arr[B // 4: B // 2] = rng.randint(0, 256, size=(B // 2 - B // 4, L))
    arr[B // 2: B // 2 + 4] = 0x80
    lens[B // 4: B // 2] = rng.randint(-1, L + 3, size=B // 2 - B // 4)
    lens[B // 2: B // 2 + 4] = L
    return torch.from_numpy(arr).cuda(), torch.from_numpy(lens).cuda()


@pytest.mark.parametrize("B,L", [(1, 128), (64, 48), (513, 128), (2048, 512), (16, 4096),
                                 (9, 7)])
def test_k8_matches_plain(B, L):
    from complexity_tokenizer_tpu_torch.ops.normalize_device import (
        norm_stable_rows,
        norm_stable_rows_plain,
    )

    _need_card()
    arr, lens = _norm_rows(B, L, seed=B + L)
    for name, bm in _norm_bitmaps().items():
        got = norm_stable_rows(arr, lens, bm)
        torch.cuda.synchronize()
        exp = norm_stable_rows_plain(arr, lens, bm)
        assert got.dtype == torch.bool and torch.equal(got, exp), name
    # an unaligned view of the rows takes the byte loads
    wide = torch.zeros((B, L + 1), dtype=torch.uint8, device="cuda")
    wide[:, 1:] = arr
    view = wide[:, 1:].contiguous()
    assert torch.equal(norm_stable_rows(view, lens, bm), norm_stable_rows_plain(view, lens, bm))


def test_k8_in_the_pipeline_matches_cpu(tok50k):
    """``EncodePipeline.encode_batch`` on the card launches K8 and equals
    the CPU pipeline and the host oracle."""
    from complexity_tokenizer_tpu_torch.core import normalizers as N
    from complexity_tokenizer_tpu_torch.ops.normalize_device import norm_stable_rows

    _need_card()
    tok = Tokenizer.from_file(BENCH_50K)
    tok.set_normalizer(N.NFC())
    texts = zipf_corpus(300, seed=4) + list(MULTI_PIECES) + ["café " * 900, ""]
    norm_stable_rows.launches = 0
    got = tok.pipeline("cuda").encode_batch(texts)
    torch.cuda.synchronize()
    assert norm_stable_rows.launches > 0
    assert got == tok.pipeline("cpu").encode_batch(texts) == tok.encode_batch(texts, backend="host")


def _string_tier(path):
    import json

    from complexity_tokenizer_tpu_torch.models import ByteLevelBpeModel

    with open(path, encoding="utf-8") as fh:
        m = json.load(fh)["model"]
    merges = [tuple(x.split(" ")) if isinstance(x, str) else tuple(x) for x in m["merges"]]
    return ByteLevelBpeModel(m["vocab"], merges)


@pytest.mark.parametrize("path", [BENCH_50K, BENCH_100K])
def test_k9_matches_plain(path):
    from complexity_tokenizer_tpu_torch.ops.merge import merge_word_rows, merge_word_rows_plain

    _need_card()
    model = _string_tier(path)
    dev = model._tiers.get("cuda")
    words = sorted({w for t in zipf_corpus(400, seed=3) for w in model._split_words(t)})
    words += [" " + "a" * 127, "=" * 128, " " + "ab" * 63, "é" * 60, " x中y"]
    enc = model._byte_encoder
    base = len(dev.symbols)
    tokens = np.full((len(words), 128), -1, np.int32)
    for r, w in enumerate(words):
        syms = [dev.sym_id.get(enc[b], base) for b in w.encode()][:128]
        tokens[r, : len(syms)] = syms
    tokens[5, 3] = -1  # a tombstone inside a word
    # the rows that separate the greedy apply from the JAX rule
    text = " ".join(zipf_corpus(50, seed=2)).encode()
    for breaks in (False, True):
        # the breakers as symbols no merge names (ids past the universe)
        runs = [[enc[b] + ("\0" if b in RUN_BREAKS else "") for b in r]
                for r in run_rows(text, 16, 128, breaks)]
        tokens = np.concatenate([tokens, dev.pack(runs)[0]])
    t = torch.from_numpy(tokens).cuda()
    args = (dev.disp, dev.rows, dev.chd.size, dev.chd.n_buckets)
    got_t, got_c = merge_word_rows(t, *args)
    torch.cuda.synchronize()
    exp_t, exp_c = merge_word_rows_plain(t, *args)
    assert torch.equal(got_t, exp_t) and torch.equal(got_c, exp_c)
    for width in (40, 7):  # narrower rows: another launch width, thread-walked words
        tw = t[:, :width].contiguous()
        got_t, got_c = merge_word_rows(tw, *args)
        exp_t, exp_c = merge_word_rows_plain(tw, *args)
        assert torch.equal(got_t, exp_t) and torch.equal(got_c, exp_c)
    empty = merge_word_rows(t[:0], *args)
    assert empty[0].shape == (0, 128) and empty[1].shape == (0,)


def _wp_models():
    from complexity_tokenizer_tpu_torch.models import WordPieceModel
    from complexity_tokenizer_tpu_torch.utils.corpus import bert_scale_wordpiece_vocab

    bert = bert_scale_wordpiece_vocab()
    return {
        "bert": WordPieceModel(bert),
        "bert_short_limit": WordPieceModel(bert, max_input_chars_per_word=6),
        "no_unk": WordPieceModel({"ab": 0, "##c": 1, "a": 2, "##b": 3}),
        "literal": WordPieceModel({"[UNK]": 0, "#": 1, "##abc": 2, "a": 3, "b": 4, "c": 5,
                                   "##b": 6, "##c": 7, "##": 11}),
    }


@pytest.mark.parametrize("name", ["bert", "bert_short_limit", "no_unk", "literal", "poisoned"])
def test_k10_matches_plain(name):
    from complexity_tokenizer_tpu_torch.ops.wordpiece_device import (
        build_wordpiece_tables,
        wordpiece_match,
        wordpiece_match_plain,
        WordPieceDevice,
    )

    _need_card()
    model = _wp_models()["bert" if name == "poisoned" else name]
    tables = build_wordpiece_tables(model)
    if name == "poisoned":
        tc = tables.token_chars.copy()
        tc[::7, 0] += 1  # every seventh slot's spelling: its hits fail the check
        tables.token_chars = tc
    dev = WordPieceDevice(tables, "cuda")
    words = sorted({w for t in zipf_corpus(300, seed=8) + list(MULTI_PIECES) for w in t.split()})
    words += ["", "##abc", "a##1", "#", "##", "x" * 128, "ab" * 50, "é" * 101, "<s>"]
    chars = np.full((len(words), 128), -1, np.int32)
    lens = np.zeros(len(words), np.int32)
    for i, w in enumerate(words):
        cps = [ord(c) for c in w][:128]
        chars[i, : len(cps)] = cps
        lens[i] = len(cps)
    c, n = torch.from_numpy(chars).cuda(), torch.from_numpy(lens).cuda()
    got = wordpiece_match(c, n, *dev.args(), tables.max_input_chars)
    torch.cuda.synchronize()
    exp = wordpiece_match_plain(c, n, *dev.args(), tables.max_input_chars)
    for a, b in zip(got, exp):
        assert torch.equal(a, b)
    assert (name == "poisoned") == bool(got[2].any())
    # 40 lanes, lengths past them (the plain version clips as JAX does)
    c40 = c[:, :40].contiguous()
    got = wordpiece_match(c40, n, *dev.args(), tables.max_input_chars)
    exp = wordpiece_match_plain(c40, n, *dev.args(), tables.max_input_chars)
    for a, b in zip(got, exp):
        assert torch.equal(a, b)


def test_k11_matches_plain():
    from complexity_tokenizer_tpu_torch.models import WordLevelModel
    from complexity_tokenizer_tpu_torch.ops.wordpiece_device import (
        wordlevel_lookup,
        wordlevel_lookup_plain,
    )
    from complexity_tokenizer_tpu_torch.utils.corpus import wordlevel_vocab

    _need_card()
    dev = WordLevelModel(wordlevel_vocab())._tiers.get("cuda")
    words = sorted({w for t in zipf_corpus(300, seed=12) + list(MULTI_PIECES) for w in t.split()})
    words += ["", "<unk>", "x" * 128]
    chars = np.full((len(words), 128), -1, np.int32)
    lens = np.zeros(len(words), np.int32)
    for i, w in enumerate(words):
        chars[i, : len(w)] = [ord(ch) for ch in w]
        lens[i] = len(w)
    chars[0, 1] = -1
    lens[1] += 1
    c, n = torch.from_numpy(chars).cuda(), torch.from_numpy(lens).cuda()
    got = wordlevel_lookup(c, n, *dev.args())
    torch.cuda.synchronize()
    assert torch.equal(got, wordlevel_lookup_plain(c, n, *dev.args()))
    c40 = c[:, :40].contiguous()  # lengths past the lanes
    assert torch.equal(wordlevel_lookup(c40, n, *dev.args()),
                       wordlevel_lookup_plain(c40, n, *dev.args()))


def test_models_on_card_match_host():
    """Each model's ``encode_batch`` on the card launches its kernel and
    equals the host ``encode``."""
    from complexity_tokenizer_tpu_torch.models import CharBpeModel, WordLevelModel
    from complexity_tokenizer_tpu_torch.ops.merge import merge_word_rows
    from complexity_tokenizer_tpu_torch.ops.wordpiece_device import (
        wordlevel_lookup,
        wordpiece_match,
    )
    from complexity_tokenizer_tpu_torch.utils.corpus import wordlevel_vocab

    _need_card()
    merges = [("l", "o"), ("lo", "w</w>"), ("e", "r</w>"), ("w", "e"), ("l", "l"),
              ("ll", "ll")]
    vocab = {"<unk>": 0}
    for s in "lowernst":
        vocab.setdefault(s, len(vocab))
        vocab.setdefault(s + "</w>", len(vocab))
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    texts = zipf_corpus(200, seed=21) + list(MULTI_PIECES) + ["low lower llllll " + "l" * 140]
    for model, fn in ((_string_tier(BENCH_50K), merge_word_rows),
                      (CharBpeModel(vocab, merges), merge_word_rows),
                      (_wp_models()["bert"], wordpiece_match),
                      (WordLevelModel(wordlevel_vocab()), wordlevel_lookup)):
        fn.launches = 0
        got = model.encode_batch(texts)
        torch.cuda.synchronize()
        assert fn.launches == 1 and model.last_route == "device"
        assert got == [model.encode(t) for t in texts]


def test_new_wrappers_refuse_bad_inputs():
    from complexity_tokenizer_tpu_torch.ops.merge import merge_word_rows
    from complexity_tokenizer_tpu_torch.ops.normalize_device import norm_stable_rows
    from complexity_tokenizer_tpu_torch.ops.wordpiece_device import wordlevel_lookup

    _need_card()
    arr = torch.zeros((4, 128), dtype=torch.uint8, device="cuda")
    lens = torch.zeros(4, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="bitmap"):
        norm_stable_rows(arr, lens, torch.zeros(100, dtype=torch.uint8, device="cuda"))
    with pytest.raises(ValueError, match="lengths"):
        norm_stable_rows(arr, lens.long(), torch.zeros(0x110000, dtype=torch.uint8, device="cuda"))
    disp = torch.zeros(4, dtype=torch.int32, device="cuda")
    rows = torch.full((16, 4), -1, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="power of two"):
        merge_word_rows(arr.int(), disp, rows, 15, 4)
    with pytest.raises(ValueError, match="lanes"):
        chars = torch.zeros((4, 256), dtype=torch.int32, device="cuda")
        tc = torch.zeros((1, 1), dtype=torch.int32, device="cuda")
        one = torch.zeros(1, dtype=torch.int32, device="cuda")
        wordlevel_lookup(chars, lens, disp, rows, 16, 4, tc, one, one, 0)

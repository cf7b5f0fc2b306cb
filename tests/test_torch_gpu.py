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
    norm_edge_rows,
    norm_trap_bitmap,
    piece_hist_edge_results,
    run_rows,
    zipf_corpus,
    zipf_pair_rows,
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


def test_fill_replays_from_a_cuda_graph(tok50k, tok100k):
    """The fill (K6, then K4 as its programmatic dependent) captured in a
    CUDA graph and replayed into buffers filled with junk equals the fill
    launched from the host, on both tables; K4 launched alone after a copy
    (no kernel before it to wait for) also equals its plain version."""
    _need_card()
    for tb, itemsize in ((tok50k.pipeline("cuda").tables, 2),
                         (tok100k.pipeline("cuda").tables, 4)):
        for B, seed in ((1024, 3), (256, 4)):
            pack = _fill_pack("edges", B, seed=seed)
            cap = B * 128 * 3 // 8
            exp = word_fill(*pack, cap, tables=tb, itemsize=itemsize)
            torch.cuda.synchronize()
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                got = word_fill(*pack, cap, tables=tb, itemsize=itemsize)
            for _ in range(3):
                got.fill_(0xA5)
                g.replay()
                torch.cuda.synchronize()
                assert torch.equal(got, exp), (B, itemsize)
            merged, count = word_merge(*pack, tables=tb)
            merged_copy, count_copy = merged.clone(), count.clone()
            assert torch.equal(fill_compact(merged_copy, count_copy, cap, itemsize),
                               fill_compact_plain(merged, count, cap, itemsize))


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
    """The bitmaps of NFC, ``BertNormalizer()`` and ``Lowercase()``, and
    ``utils/corpus.py:norm_trap_bitmap``."""
    from complexity_tokenizer_tpu_torch.core import normalizers as N
    from complexity_tokenizer_tpu_torch.ops.normalize_device import plan_for_normalizer

    out = {name: torch.from_numpy(plan_for_normalizer(n).bitmap).cuda()
           for name, n in (("nfc", N.NFC()), ("bert", N.BertNormalizer()),
                           ("lowercase", N.Lowercase()))}
    out["trap"] = torch.from_numpy(norm_trap_bitmap()).cuda()
    return out


def _norm_rows(B, L, seed):
    """B rows of up to L bytes: corpus text with multilingual pieces cut
    anywhere (inside a character too), random bytes, all-continuation
    bytes, empty rows."""
    rng = np.random.RandomState(seed)
    texts = zipf_corpus(B, seed=seed, lo=1, hi=L) + list(MULTI_PIECES)
    rows = [" ".join(texts[i: i + 3]).encode()[:rng.randint(0, L + 1)] for i in range(B)]
    for i in range(B // 4, B // 2):
        rows[i] = rng.randint(0, 256, size=rng.randint(0, L + 1)).astype(np.uint8).tobytes()
    for i in range(B // 2, min(B, B // 2 + 4)):
        rows[i] = b"\x80" * L
    return rows


def _check_k8(rows):
    """K8 on ``rows`` (byte strings) under every bitmap, bit for bit its
    plain version on the card; the stable flags."""
    from complexity_tokenizer_tpu_torch.ops.normalize_device import (
        norm_stable_rows,
        norm_stable_rows_ragged_plain,
        pack_norm_rows,
    )

    flags = {}
    for name, bm in _norm_bitmaps().items():
        data, offs, blocks, stable = pack_norm_rows(rows, "cuda")
        got = norm_stable_rows(data, offs, blocks, bm, stable)
        torch.cuda.synchronize()
        exp = norm_stable_rows_ragged_plain(data, offs, bm)
        assert got.dtype == torch.bool and torch.equal(got, exp), name
        flags[name] = exp.cpu().numpy()
    return flags


@pytest.mark.parametrize("B,L", [(1, 128), (64, 48), (513, 128), (2048, 512), (16, 4096),
                                 (9, 7)])
def test_k8_matches_plain(B, L):
    _need_card()
    _check_k8(_norm_rows(B, L, seed=B + L))


def test_k8_edge_rows():
    """K8 at a row's and a block's edge (``utils/corpus.py:norm_edge_rows``):
    truncated leads before rows of continuation-looking bytes (the trap
    bitmap flags what they would decode to with the next row's bytes),
    rows of exactly 128, 512 and 4,096 bytes, rows across a block's span,
    runs of empty rows past the staged offsets, one-byte rows."""
    from complexity_tokenizer_tpu_torch.ops.normalize_device import NORM_SPAN

    _need_card()
    text = " ".join(zipf_corpus(60, seed=5) + list(MULTI_PIECES)).encode()
    for label, rows in norm_edge_rows(text, NORM_SPAN):
        flags = _check_k8(rows)
        if label == "truncated leads":
            assert flags["trap"][0::4].all() and not flags["trap"][3::4].any()
        if label == "empty rows":
            assert flags["nfc"].all()


def test_k8_in_the_pipeline_matches_cpu(tok50k):
    """``EncodePipeline.encode_batch`` on the card launches K8 once and
    equals the CPU pipeline and the host oracle."""
    from complexity_tokenizer_tpu_torch.core import normalizers as N
    from complexity_tokenizer_tpu_torch.ops.normalize_device import norm_stable_rows

    _need_card()
    tok = Tokenizer.from_file(BENCH_50K)
    tok.set_normalizer(N.NFC())
    texts = zipf_corpus(300, seed=4) + list(MULTI_PIECES) + ["café " * 900, ""]
    norm_stable_rows.launches = 0
    got = tok.pipeline("cuda").encode_batch(texts)
    torch.cuda.synchronize()
    assert norm_stable_rows.launches == 1  # every row of both length buckets
    assert got == tok.pipeline("cpu").encode_batch(texts) == tok.encode_batch(texts, backend="host")


def _string_tier(path):
    import json

    from complexity_tokenizer_tpu_torch.models import ByteLevelBpeModel

    with open(path, encoding="utf-8") as fh:
        m = json.load(fh)["model"]
    merges = [tuple(x.split(" ")) if isinstance(x, str) else tuple(x) for x in m["merges"]]
    return ByteLevelBpeModel(m["vocab"], merges)


def _ragged_words(rows):
    """Lists of ids as ragged words: (flat [N] int32, offs [B + 1] int32)."""
    offs = np.concatenate([[0], np.cumsum([len(r) for r in rows])]).astype(np.int32)
    return np.asarray([x for r in rows for x in r], np.int32), offs


def _check_k9(dev, rows, tiles_of=(1, 16, 384, 896, 1920)):
    """K9 on the ragged words ``rows`` (lists of symbol ids) at every tile
    size, bit for bit its plain version on the card."""
    from complexity_tokenizer_tpu_torch.ops.merge import (
        merge_word_rows,
        merge_word_rows_ragged_plain,
        word_tiles,
    )

    syms, offs = _ragged_words(rows)
    s, o = torch.from_numpy(syms).cuda(), torch.from_numpy(offs).cuda()
    args = (dev.disp, dev.rows, dev.chd.size, dev.chd.n_buckets)
    exp_t, exp_c = merge_word_rows_ragged_plain(s, o, *args)
    for tile in tiles_of:
        tiles = torch.from_numpy(word_tiles(offs, tile)).cuda()
        got_t, got_c = merge_word_rows(s, o, tiles, *args, tile=tile)
        torch.cuda.synchronize()
        assert torch.equal(got_t, exp_t) and torch.equal(got_c, exp_c), tile
    return exp_t, exp_c


@pytest.mark.parametrize("path", [BENCH_50K, BENCH_100K])
def test_k9_matches_plain(path):
    from complexity_tokenizer_tpu_torch.ops.merge import merge_word_rows, word_tiles

    _need_card()
    model = _string_tier(path)
    dev = model._tiers.get("cuda")
    words = sorted({w for t in zipf_corpus(400, seed=3) for w in model._split_words(t)})
    words += [" " + "a" * 127, "=" * 128, " " + "ab" * 63, "é" * 60, " x中y"]
    enc = model._byte_encoder
    base = len(dev.symbols)
    rows = [[dev.sym_id.get(enc[b], base) for b in w.encode()][:128] for w in words]
    rows[5][3:4] = [-1]  # a tombstone inside a word
    # the rows that separate the greedy apply from the JAX rule
    text = " ".join(zipf_corpus(50, seed=2)).encode()
    for breaks in (False, True):
        # the breakers as symbols no merge names (ids past the universe)
        runs = [[enc[b] + ("\0" if b in RUN_BREAKS else "") for b in r]
                for r in run_rows(text, 16, 128, breaks)]
        syms, offs = dev.pack(runs)[:2]
        rows += [syms[offs[i]:offs[i + 1]].tolist() for i in range(len(runs))]
    rng = np.random.RandomState(len(rows))
    singles = [i for sym, i in dev.sym_id.items() if len(sym) == 1]
    edge = [[singles[rng.randint(len(singles))]] for _ in range(50)] + [[], []]  # one symbol
    edge += [[singles[k]] * 128 for k in range(3)]  # 128 symbols, runs of one
    edge += [rng.choice(singles, n).tolist() for n in (15, 3, 12, 1, 16, 40, 128, 5)]  # S = 16
    _, count = _check_k9(dev, rows + edge)
    assert (count.cpu().numpy() < np.diff(_ragged_words(rows + edge)[1])).any()  # merges happened
    # tiles whose words are all walked by a warp (over 32 symbols)
    _check_k9(dev, [rng.choice(singles, rng.randint(33, 129)).tolist() for _ in range(60)],
              (384, 896))
    # no words; empty words only
    args = (dev.disp, dev.rows, dev.chd.size, dev.chd.n_buckets)
    none = torch.zeros(0, dtype=torch.int32, device="cuda")
    got = merge_word_rows(none, torch.zeros(1, dtype=torch.int32, device="cuda"),
                          torch.from_numpy(word_tiles(np.zeros(1, np.int32))).cuda(), *args)
    assert got[0].shape == (0,) and got[1].shape == (0,)
    _check_k9(dev, [[], [], []])


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


def _unsorted(chars, offs, lens, order):
    """K10's packed words back in their own order."""
    inv = np.argsort(order, kind="stable")
    rows = [chars[offs[j]:offs[j + 1]] for j in inv]
    new_offs = np.concatenate([[0], np.cumsum([len(r) for r in rows])]).astype(np.int32)
    flat = np.concatenate(rows).astype(np.int32) if rows else np.zeros(0, np.int32)
    return flat, new_offs, lens[inv]


@pytest.mark.parametrize("name", ["bert", "bert_short_limit", "no_unk", "literal", "poisoned"])
def test_k10_matches_plain(name):
    from complexity_tokenizer_tpu_torch.ops.wordpiece_device import (
        build_wordpiece_tables,
        wordpiece_match,
        wordpiece_match_ragged_plain,
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
    rng = np.random.RandomState(len(name))
    words = sorted({w for t in zipf_corpus(300, seed=8) + list(MULTI_PIECES) for w in t.split()})
    words += ["", "##abc", "a##1", "#", "##", "x" * 128, "ab" * 50, "é" * 101, "<s>"]
    words += ["".join(rng.choice(list("abcdeflnorst"), n)) for n in (8, 9, 16, 17, 32, 33) * 5]
    mi = tables.max_input_chars
    on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()  # noqa: E731

    def check(chars, offs, lens, groups):
        c, o, n = on(chars), on(offs), on(lens)
        got = wordpiece_match(c, o, n, groups, *dev.args(), mi)
        torch.cuda.synchronize()
        exp = wordpiece_match_ragged_plain(c, o, n, *dev.args(), mi)
        for a, b in zip(got, exp):
            assert torch.equal(a, b), groups
        return got

    chars, offs, lens, order, groups, host = dev.pack(words)
    got = check(chars, offs, lens, groups)
    assert (name == "poisoned") == bool(got[2].any())
    B = len(lens)
    # word counts that are no multiple of the lane groups: the first m words
    for m in (1, 3, 5, 7, groups[0] + 1, groups[1] + 3):
        m = min(m, B)
        check(chars[:offs[m]], offs[:m + 1], lens[:m], (min(groups[0], m), min(groups[1], m)))
    # in their own order, and with every word in groups of 8 or 16, or a
    # warp each: longer words than the group take more chunks
    flat, uoffs, ulens = _unsorted(chars, offs, lens, order)
    for g in ((B, B), (0, B), (0, 0), (B // 3, 2 * B // 3)):
        check(flat, uoffs, ulens, g)


def test_k11_matches_plain():
    from complexity_tokenizer_tpu_torch.models import WordLevelModel
    from complexity_tokenizer_tpu_torch.ops.wordpiece_device import (
        wordlevel_lookup,
        wordlevel_lookup_ragged_plain,
    )
    from complexity_tokenizer_tpu_torch.utils.corpus import wordlevel_vocab

    _need_card()
    vocab = wordlevel_vocab()
    dev = WordLevelModel(vocab)._tiers.get("cuda")
    rng = np.random.RandomState(11)
    words = sorted({w for t in zipf_corpus(300, seed=12) + list(MULTI_PIECES) for w in t.split()})
    words += ["", "<unk>", "x" * 128, "x" * 129, "日本語", "\U0001f601"]
    long = [w for w in vocab if len(w) > 8][:40]
    words += long + [w + "s" for w in long] + [w[:-1] for w in long]
    words += ["".join(rng.choice(list("abcdeflnorst"), n)) for n in (8, 9, 16, 17, 32, 33) * 5]
    on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()  # noqa: E731

    def check(chars, offs, lens, groups):
        c, o, n = on(chars), on(offs), on(lens)
        got = wordlevel_lookup(c, o, n, groups, *dev.args())
        torch.cuda.synchronize()
        exp = wordlevel_lookup_ragged_plain(c, o, n, *dev.args())
        assert torch.equal(got, exp), groups
        return got

    chars, offs, lens, order, groups, host = dev.pack(words)
    got = check(chars, offs, lens, groups)
    assert (got.cpu().numpy() > 0).sum() > len(long) and host == [words.index("x" * 129)]
    B = len(lens)
    # word counts that are no multiple of the lane groups: the first m words
    for m in (1, 3, 5, 7, groups[0] + 1, groups[1] + 3):
        m = min(m, B)
        check(chars[:offs[m]], offs[:m + 1], lens[:m], (min(groups[0], m), min(groups[1], m)))
    # in their own order, and with every word in groups of 8 or 16, or a
    # warp each: longer words than the group take more chunks
    flat, uoffs, ulens = _unsorted(chars, offs, lens, order)
    for g in ((B, B), (0, B), (0, 0), (B // 3, 2 * B // 3)):
        check(flat, uoffs, ulens, g)
    # lengths that disagree with the slots, and -1 characters inside words
    # (skipped by the hash, compared by the check)
    odd = ulens.copy()
    odd[::5] += 1
    odd[1::7] = 0
    odd[2::11] = -1
    flat2 = flat.copy()
    flat2[uoffs[3:-1:13]] = -1
    for g in ((B, B), (0, 0), (B // 3, 2 * B // 3)):
        check(flat, uoffs, odd, g)
        check(flat2, uoffs, ulens, g)


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
    from complexity_tokenizer_tpu_torch.ops.normalize_device import (
        norm_stable_rows,
        pack_norm_rows,
    )
    from complexity_tokenizer_tpu_torch.ops.wordpiece_device import wordlevel_lookup

    _need_card()
    data, offs, blocks, stable = pack_norm_rows([b"ab", b"c" * 40], "cuda")
    bm = torch.zeros(0x110000, dtype=torch.uint8, device="cuda")
    with pytest.raises(ValueError, match="bitmap"):
        norm_stable_rows(data, offs, blocks, bm[:100], stable)
    with pytest.raises(ValueError, match="offs"):
        norm_stable_rows(data, offs.long(), blocks, bm, stable)
    with pytest.raises(ValueError, match="16-byte"):
        norm_stable_rows(data[1:33].clone()[:-1], offs, blocks, bm, stable)
    arr = torch.zeros((4, 128), dtype=torch.uint8, device="cuda")
    lens = torch.zeros(4, dtype=torch.int32, device="cuda")
    disp = torch.zeros(4, dtype=torch.int32, device="cuda")
    rows = torch.full((16, 4), -1, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="power of two"):
        merge_word_rows(arr.int().view(-1), lens[:2], lens[:2], disp, rows, 15, 4)
    chars = torch.zeros(8, dtype=torch.int32, device="cuda")
    woffs = torch.tensor([0, 2, 4, 6, 8], dtype=torch.int32, device="cuda")
    tc = torch.zeros((1, 1), dtype=torch.int32, device="cuda")
    one = torch.zeros(1, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="groups"):
        wordlevel_lookup(chars, woffs, lens, (3, 2), disp, rows, 16, 4, tc, one, one, 0)
    with pytest.raises(ValueError, match="offs"):
        wordlevel_lookup(chars, woffs[:4], lens, (0, 0), disp, rows, 16, 4, tc, one, one, 0)


def test_k9_k10_launch_shapes():
    """K9's tiles and K10's warps launch without spilling registers."""
    from complexity_tokenizer_tpu_torch.ops.merge import TILE_SYMBOLS, WORD_LANES
    from complexity_tokenizer_tpu_torch.ops.wordpiece_device import wordpiece_launch_shape

    _need_card()
    k9 = launch_shape(TILE_SYMBOLS + WORD_LANES - 1, ragged=True)
    k10 = wordpiece_launch_shape()
    for shape in (k9, k10):
        assert shape["blocks_per_sm"] > 0 and shape["local_bytes"] == 0, shape


def test_k8_k11_launch_shapes():
    """K8's blocks and K11's warps launch without spilling registers."""
    from complexity_tokenizer_tpu_torch.ops.normalize_device import norm_launch_shape
    from complexity_tokenizer_tpu_torch.ops.wordpiece_device import wordlevel_launch_shape

    _need_card()
    for shape in (norm_launch_shape(), wordlevel_launch_shape()):
        assert shape["blocks_per_sm"] > 0 and shape["local_bytes"] == 0, shape


def _unigram_tier():
    from complexity_tokenizer_tpu_torch.models import UnigramModel
    from complexity_tokenizer_tpu_torch.utils.corpus import unigram_32k_vocab

    vocab = unigram_32k_vocab()
    return vocab, UnigramModel(vocab)._tiers.get("cuda")


def _unigram_texts(vocab, seed):
    """Random texts of 0-128 characters joined from pieces, with characters
    outside the table, then the corpus's pieces."""
    from complexity_tokenizer_tpu_torch.utils.corpus import metaspace_pieces

    rng = np.random.RandomState(seed)
    pieces = [p for p, _ in vocab[:-3]]
    texts = []
    for n in rng.randint(0, 129, size=600):
        t = ""
        while len(t) < n:
            t += pieces[rng.randint(len(pieces))] if rng.rand() < 0.9 else chr(0x4E00 + rng.randint(50))
        texts.append(t[:n])
    return texts + sorted(set(metaspace_pieces(zipf_corpus(200, seed=seed))))


def test_k12_matches_plain():
    """K12 against its plain version, bit for bit in out, count and poison:
    random texts and the edge texts, at the longest piece, at maxcand 3, 16
    and 40, under the -2 marker and a live id as marker, in the tier's
    length order with its lane groups, with every text a warp and every
    text in a group of 8 (the longer ones then taken by the whole warp),
    in the texts' own order, and with lengths under the slots."""
    from complexity_tokenizer_tpu_torch.ops.unigram_device import (
        FALLBACK_ID,
        split_viterbi,
        viterbi,
        viterbi_ragged_plain,
    )
    from complexity_tokenizer_tpu_torch.utils.corpus import unigram_edge_texts

    _need_card()
    vocab, tier = _unigram_tier()
    on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()  # noqa: E731

    def check(chars, offs, lens, groups, maxcand, fid=FALLBACK_ID):
        c, o, n = on(chars), on(offs), on(lens)
        got = viterbi(c, o, n, groups, *tier.args(maxcand), fallback_id=fid)
        torch.cuda.synchronize()
        exp = viterbi_ragged_plain(c, o, n, *tier.args(maxcand), fallback_id=fid)
        assert torch.equal(got, exp), (maxcand, fid, groups)
        return split_viterbi(got, len(lens))

    sets = [_unigram_texts(vocab, 5)] + [t for _c, t in unigram_edge_texts(vocab)]
    poisoned = 0
    for texts in sets:
        chars, offs, lens, order, groups, host = tier.pack(texts)
        B = len(lens)
        for maxcand in (tier.Lt, 3, 16, 40):
            res = check(chars, offs, lens, groups, maxcand)
            poisoned += int(res[2].sum())
        check(chars, offs, lens, groups, tier.Lt, fid=tier.unk_id)
        for other in ((0, 0), (B, B), (0, B)):
            check(chars, offs, lens, other, tier.Lt)
        flat, uoffs, ulens = _unsorted(chars, offs, lens, order)
        check(flat, uoffs, ulens, (0, 0), tier.Lt)
        check(flat, uoffs, ulens, (B // 2, B), tier.Lt)
        short = ulens.copy()
        short[::3] = np.maximum(short[::3] - 2, 0)
        check(flat, uoffs, short, (B // 3, B // 2), tier.Lt)
    assert poisoned > 0


@pytest.mark.parametrize("maxcand", [None, 3, 16])
def test_k12_every_lane_group_in_one_launch(maxcand):
    """One launch over texts of every width, packed by the tier: exactly 8,
    9, 16 and 17 characters (the groups' edges), 1-7 and 10-15 (inside
    them), 18-128 (a warp each), and texts of one repeated character (exact
    ties) at the edges; maxcand the longest piece (13), 3, and 16 over the
    13-character table (the trainer's bound); bit for bit, and each group
    holds the widths it should."""
    from complexity_tokenizer_tpu_torch.ops.unigram_device import (
        viterbi,
        viterbi_launch_shape,
        viterbi_ragged_plain,
    )

    _need_card()
    vocab, tier = _unigram_tier()
    rng = np.random.RandomState(41)
    pieces = [p for p, _ in vocab[:-3]]
    texts = []
    for n in [8, 9, 16, 17] * 25 + list(range(1, 129)) * 3:
        t = ""
        while len(t) < n:
            t += pieces[rng.randint(len(pieces))]
        texts.append(t[:n])
    texts += [c * n for c in "ae▁" for n in (8, 9, 16, 17)]
    chars, offs, lens, order, groups, host = tier.pack(texts)
    n8, n16 = groups
    assert host == [] and lens[:n8].max() == 8 and lens[n8:n16].min() == 9
    assert lens[n8:n16].max() == 16 and lens[n16:].min() == 17
    on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()  # noqa: E731
    c, o, n = on(chars), on(offs), on(lens)
    before = viterbi.launches
    got = viterbi(c, o, n, groups, *tier.args(maxcand))
    torch.cuda.synchronize()
    assert viterbi.launches == before + 1
    assert torch.equal(got, viterbi_ragged_plain(c, o, n, *tier.args(maxcand)))
    assert viterbi_launch_shape()["local_bytes"] == 0


def test_unigram_on_card_matches_host():
    """``UnigramModel.encode_batch`` on the card launches K12 once and
    equals the host ``encode`` on every piece."""
    from complexity_tokenizer_tpu_torch.models import UnigramModel
    from complexity_tokenizer_tpu_torch.ops.unigram_device import viterbi
    from complexity_tokenizer_tpu_torch.utils.corpus import metaspace_pieces, unigram_32k_vocab

    _need_card()
    model = UnigramModel(unigram_32k_vocab())
    pieces = metaspace_pieces(zipf_corpus(300, seed=31) + list(MULTI_PIECES)) + ["x" * 140, ""]
    viterbi.launches = 0
    got = model.encode_batch(pieces)
    torch.cuda.synchronize()
    assert viterbi.launches == 1 and model.last_route == "device"
    assert model.last_stats["over_width"] == 1
    host = {p: model.encode(p) for p in set(pieces)}
    assert got == [host[p] for p in pieces]


def test_k12_refuses_bad_inputs_and_launches_without_spilling():
    from complexity_tokenizer_tpu_torch.ops.unigram_device import viterbi, viterbi_launch_shape

    _need_card()
    _vocab, tier = _unigram_tier()
    chars = torch.zeros(8, dtype=torch.int32, device="cuda")
    offs = torch.tensor([0, 2, 4, 6, 8], dtype=torch.int32, device="cuda")
    lens = torch.full((4,), 2, dtype=torch.int32, device="cuda")
    args = list(tier.args())
    with pytest.raises(ValueError, match="offs"):
        viterbi(chars, offs[:4], lens, (0, 0), *args)
    with pytest.raises(ValueError, match="maxcand"):
        viterbi(chars, offs, lens, (0, 0), *args[:-1], 0)
    with pytest.raises(ValueError, match="groups"):
        viterbi(chars, offs, lens, (3, 2), *args)
    with pytest.raises(ValueError, match="groups"):
        viterbi(chars, offs, lens, (0, 5), *args)
    bad = list(args)
    bad[6] = tier.piece_scores.double()
    with pytest.raises(ValueError, match="piece_scores"):
        viterbi(chars, offs, lens, (0, 0), *bad)
    shape = viterbi_launch_shape()
    assert shape["blocks_per_sm"] > 0 and shape["local_bytes"] == 0, shape


# ---------------------------------------------------------------------------
# K13-K16: the device trainer's kernels


def _k14_case(words, freqs, a, b, new, dev, log_step=None):
    """K14 (on ``dev``) on the rows: (words, delta, minted) as numpy."""
    from complexity_tokenizer_tpu_torch.ops.trainer_device import merge_step

    w = torch.from_numpy(words.copy()).to(dev)
    delta = torch.zeros(new + 1, 4, dtype=torch.int32, device=dev)
    minted = torch.zeros(1, dtype=torch.int32, device=dev)
    if log_step is None:
        merge_step(w, torch.from_numpy(freqs).to(dev), new, delta, minted, a=a, b=b)
    else:
        ma = torch.full((4,), -1, dtype=torch.int32, device=dev)
        mb = torch.full((4,), -1, dtype=torch.int32, device=dev)
        ma[log_step], mb[log_step] = a, b
        merge_step(w, torch.from_numpy(freqs).to(dev), new, delta, minted, log=(ma, mb),
                   step=log_step)
    return w.cpu().numpy(), delta.cpu().numpy(), int(minted)


@pytest.mark.parametrize("case", range(10))
def test_k13_k14_match_plain_on_edge_rows(case):
    """K13 and K14 against their plain versions on the card, bit for bit, on
    ``utils/corpus.py:merge_edge_rows`` (the pair as scalars and from the
    merge log; a logged step of -1 changes nothing)."""
    _need_card()
    from complexity_tokenizer_tpu_torch.ops.trainer_device import (
        merge_step,
        merge_step_plain,
        pair_hist,
        pair_hist_plain,
    )
    from complexity_tokenizer_tpu_torch.utils.corpus import merge_edge_rows

    label, words, freqs, a, b, new = merge_edge_rows()[case]
    dev = torch.device("cuda")
    w, f = torch.from_numpy(words).to(dev), torch.from_numpy(freqs).to(dev)
    n0 = pair_hist.launches
    assert torch.equal(pair_hist(w, f, new + 1), pair_hist_plain(w, f, new + 1)), label
    assert pair_hist.launches == n0 + 1
    want_w = torch.from_numpy(words.copy()).to(dev)
    want_d = torch.zeros(new + 1, 4, dtype=torch.int32, device=dev)
    want_m = torch.zeros(1, dtype=torch.int32, device=dev)
    merge_step_plain(want_w, f, new, want_d, want_m, a=a, b=b)
    n0 = merge_step.launches
    for step in (None, 2):
        got = _k14_case(words, freqs, a, b, new, dev, step)
        assert (got[0] == want_w.cpu().numpy()).all(), label
        assert (got[1] == want_d.cpu().numpy()).all(), label
        assert got[2] == int(want_m), label
    assert merge_step.launches == n0 + 2
    # a step that does nothing leaves every buffer as it was
    ma = torch.full((2,), -1, dtype=torch.int32, device=dev)
    w2 = w.clone()
    delta = torch.zeros(new + 1, 4, dtype=torch.int32, device=dev)
    minted = torch.zeros(1, dtype=torch.int32, device=dev)
    merge_step(w2, f, new, delta, minted, log=(ma, ma.clone()), step=1)
    assert torch.equal(w2, w) and not delta.any() and not minted.any()
    # the per-merge route's turns: K14 adds into a buffer the merge before
    # zeroed and zeroes the other, which held other values; a step that
    # does nothing zeroes it too
    w3 = w.clone()
    bufs = torch.zeros((2, 1 + 4 * (new + 1)), dtype=torch.int32, device=dev)
    bufs[1] = torch.randint(-50, 50, (1 + 4 * (new + 1),), dtype=torch.int32, device=dev)
    n0 = merge_step.launches
    merge_step(w3, f, new, bufs[0, 1:].view(new + 1, 4), bufs[0, :1], a=a, b=b, zero=bufs[1])
    assert torch.equal(w3, want_w) and torch.equal(bufs[0, 1:].view(new + 1, 4), want_d), label
    assert torch.equal(bufs[0, :1], want_m) and not bufs[1].any(), label
    bufs[0].fill_(7)
    merge_step(w3, f, new, bufs[1, 1:].view(new + 1, 4), bufs[1, :1], log=(ma, ma.clone()),
               step=1, zero=bufs[0])
    assert torch.equal(w3, want_w) and not bufs.any(), label
    assert merge_step.launches == n0 + 2


def test_k14_refuses_a_zero_buffer_that_overlaps():
    """K14 zeroes ``zero`` while it adds into ``delta`` and ``minted``, so a
    ``zero`` that shares storage with another argument is refused."""
    _need_card()
    from complexity_tokenizer_tpu_torch.ops.trainer_device import merge_step

    dev = torch.device("cuda")
    w = torch.zeros(4, 3, dtype=torch.int32, device=dev)
    f = torch.ones(4, dtype=torch.int32, device=dev)
    buf = torch.zeros(1 + 4 * 8, dtype=torch.int32, device=dev)
    for zero in (buf, buf[:5], w.view(-1)):
        with pytest.raises(ValueError, match="overlap"):
            merge_step(w, f, 7, buf[1:].view(8, 4), buf[:1], a=0, b=1, zero=zero)


def _block(dev, words, freqs, V, n_steps, window=None):
    """``n_steps`` K15 -> K14 -> K16 steps from the rows' seed histogram on
    ``dev``: (words, hist, log, deltas, state) as numpy."""
    from complexity_tokenizer_tpu_torch.ops.trainer_device import (
        SelectScratch,
        hist_update,
        merge_step,
        pair_hist,
        select_pair,
    )

    w = torch.from_numpy(words.copy()).to(dev)
    f = torch.from_numpy(freqs).to(dev)
    v0 = int(words.max()) + 1
    seed = pair_hist(w, f, v0).view(v0, v0)
    hist = torch.zeros(V, V, dtype=torch.int32, device=dev)
    hist[:v0, :v0] = seed
    log = torch.zeros(3, n_steps, dtype=torch.int32, device=dev)
    deltas = torch.zeros(n_steps, V, 4, dtype=torch.int32, device=dev)
    scratch = SelectScratch(dev) if dev.type == "cuda" else None
    cand = state = None
    if window is not None:
        ca, cb, n_cand = window
        state = torch.tensor([-1, 0], dtype=torch.int32, device=dev)
        cand = (torch.from_numpy(ca).to(dev), torch.from_numpy(cb).to(dev), n_cand, state)
    for i in range(n_steps):
        select_pair(hist, i, log[0], log[1], cand=cand, scratch=scratch)
        merge_step(w, f, v0 + i, deltas[i], log[2][i : i + 1], log=(log[0], log[1]), step=i)
        hist_update(hist, i, log[0], log[1], v0 + i, deltas[i])
    out = [t.cpu().numpy() for t in (w, hist, log, deltas)]
    return out + [None if state is None else state.cpu().numpy()]


@pytest.mark.parametrize("rows", [2, 4, 8, 9])
@pytest.mark.parametrize("mode", ["classic", "window", "window, T overflows"])
def test_k15_k16_blocks_match_plain(mode, rows):
    """A block of K15 -> K14 -> K16 steps on the card (K16 the programmatic
    dependent of K14) against the plain
    versions on the card, bit for bit: words, histogram, merge log, deltas,
    the window's cursor; on the runs of ``a == b``, the random edge rows,
    rows of 70 slots and the late state of ``merge_edge_rows``, on the runs
    until the histogram is exhausted (classic) and until the candidates run
    out (window)."""
    _need_card()
    from complexity_tokenizer_tpu_torch.utils.corpus import merge_edge_rows

    _, words, freqs, *_ = merge_edge_rows()[rows]
    V, steps = 64, 40
    window = None
    if mode != "classic":
        rng = np.random.RandomState(1)
        T = 4 if "overflows" in mode else 64
        ca = rng.randint(0, 3, size=T).astype(np.int32)
        cb = rng.randint(0, 3, size=T).astype(np.int32)
        window = (ca, cb, T - 1)
    from complexity_tokenizer_tpu_torch.ops import trainer_device as td

    got = _block(torch.device("cuda"), words, freqs, V, steps, window)
    saved = {f: getattr(td, f) for f in ("pair_hist", "merge_step", "select_pair", "hist_update")}
    try:  # the plain versions, on the card, through the same loop
        for name in saved:
            setattr(td, name, getattr(td, name + "_plain"))
        td.select_pair = lambda *args, scratch=None, **kw: td.select_pair_plain(*args, **kw)
        want = _block(torch.device("cuda"), words, freqs, V, steps, window)
    finally:
        for name, fn in saved.items():
            setattr(td, name, fn)
    for g, w in zip(got, want):
        assert (g is None and w is None) or (g == w).all()
    assert (got[2][0] >= 0).any()
    if mode != "classic" or rows == 2:
        assert (got[2][0] < 0).any()  # exhausted


@pytest.mark.parametrize("mode", ["classic", "window"])
def test_k15_k14_k16_block_replays_from_a_cuda_graph(mode):
    """A 32-step block of ``run_steps`` (K15, K14, then K16 as K14's
    programmatic dependent), run eagerly and captured in a CUDA graph and
    replayed on restored inputs, against the plain versions' 32 steps on
    the same inputs, bit for bit, in classic and in window mode."""
    _need_card()
    from complexity_tokenizer_tpu_torch.ops.trainer_device import (
        SelectScratch,
        hist_update_plain,
        merge_step_plain,
        pair_hist,
        select_pair_plain,
    )
    from complexity_tokenizer_tpu_torch.parallel.trainer import run_steps
    from complexity_tokenizer_tpu_torch.utils.corpus import merge_edge_rows

    _, words, freqs, *_ = merge_edge_rows()[9]
    dev = torch.device("cuda")
    w0, f = torch.from_numpy(words).to(dev), torch.from_numpy(freqs).to(dev)
    V, k = 64, 32
    h0 = torch.zeros(V, V, dtype=torch.int32, device=dev)
    h0[:3, :3] = pair_hist(w0, f, 3).view(3, 3)
    w, h = w0.clone(), h0.clone()
    log = torch.zeros(3, k, dtype=torch.int32, device=dev)
    deltas = torch.zeros(k, V, 4, dtype=torch.int32, device=dev)
    scratch = SelectScratch(dev)
    ca = torch.tensor([0, 1, 2, 0, 1, 2, 1, 0] * 8, dtype=torch.int32, device=dev)
    cb = torch.tensor([1, 2, 0, 0, 1, 2, 0, 2] * 8, dtype=torch.int32, device=dev)
    st0 = torch.tensor([-1, 0], dtype=torch.int32, device=dev)
    st = st0.clone()
    cand = None if mode == "classic" else (ca, cb, 60, st)

    def reset():
        w.copy_(w0)
        h.copy_(h0)
        st.copy_(st0)
        log.zero_()
        deltas.zero_()

    def block():
        run_steps(k, 3, w, f, h, log, deltas, cand=cand, scratch=scratch)

    reset()
    for i in range(k):  # the plain versions' steps
        select_pair_plain(h, i, log[0], log[1], cand=cand)
        merge_step_plain(w, f, 3 + i, deltas[i], log[2][i:i + 1], log=(log[0], log[1]), step=i)
        hist_update_plain(h, i, log[0], log[1], 3 + i, deltas[i])
    want = [t.clone() for t in (w, h, log, deltas, st)]
    assert (log[0] >= 0).sum() > 3
    reset()
    block()
    torch.cuda.synchronize()
    for got, exp in zip((w, h, log, deltas, st), want):
        assert torch.equal(got, exp), mode
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        block()
    for _ in range(3):
        reset()
        g.replay()
        torch.cuda.synchronize()
        for got, exp in zip((w, h, log, deltas, st), want):
            assert torch.equal(got, exp), mode


@pytest.mark.parametrize("v0,N", [(58, 48_968), (58, 3), (241, 20_000), (260, 48_968),
                                  (700, 20_000)])
def test_k13_each_branch_matches_plain(v0, N):
    """Each branch of K13's plan against the plain version, bit for bit, one
    launch a call: a block's histogram (v0 58, the bench corpus's alphabet,
    on the classic rows' shape and on three rows; 241, the last side that
    fits one block), the slices on blockIdx.y (260, a byte-level alphabet)
    and global atomics (700, past the slices' reach), on rows with
    Zipf-skewed ids and rows whose right id is at or past v0 (JAX's key
    aliases it into the next line).  The card's plan is the Python mirror's."""
    _need_card()
    from complexity_tokenizer_tpu_torch.ops.trainer_device import (
        pair_hist,
        pair_hist_launch_shape,
        pair_hist_plain,
        pair_hist_plan,
    )

    rng = np.random.RandomState(v0 + N)
    words = rng.randint(0, 2, size=(N, 13)).astype(np.int32)
    words[rng.rand(N, 13) < 0.25] = -1
    words = zipf_pair_rows(words, v0, seed=v0)
    words[0, :3] = (3, v0 + 5, v0 - 1)
    words[-1, -2:] = (v0 - 1, v0 + 2)
    freqs = rng.randint(1, 1000, size=N).astype(np.int32)
    w, f = torch.from_numpy(words).cuda(), torch.from_numpy(freqs).cuda()
    exp = pair_hist_plain(w, f, v0)
    for _ in range(2):  # the second call finds a buffer of the first's in the cache
        before = pair_hist.launches
        got = pair_hist(w, f, v0)
        torch.cuda.synchronize()
        assert pair_hist.launches == before + 1
        assert torch.equal(got, exp), (v0, N)
    shape = pair_hist_launch_shape(N, 13, v0)
    plan = pair_hist_plan(N, 13, v0, torch.cuda.get_device_properties(0).multi_processor_count)
    assert {k: shape[k] for k in plan} == plan, shape
    assert shape["local_bytes"] == 0 and shape["blocks_per_sm"] > 0, shape


def test_k13_replays_from_a_cuda_graph():
    """K13 (its clear, then the histogram as the clear's programmatic
    dependent) captured in a CUDA graph and replayed: the same histogram
    every replay, at v0 58 and 260."""
    _need_card()
    from complexity_tokenizer_tpu_torch.ops.trainer_device import pair_hist, pair_hist_plain

    rng = np.random.RandomState(1)
    for v0 in (58, 260):
        words = zipf_pair_rows(rng.randint(0, 2, size=(5000, 13)).astype(np.int32), v0, seed=2)
        w = torch.from_numpy(words).cuda()
        f = torch.from_numpy(rng.randint(1, 100, size=5000).astype(np.int32)).cuda()
        exp = pair_hist_plain(w, f, v0)
        pair_hist(w, f, v0)
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            got = pair_hist(w, f, v0)
        for _ in range(3):
            got.fill_(-1)
            g.replay()
            torch.cuda.synchronize()
            assert torch.equal(got, exp), v0


def test_trainer_on_card_matches_cpu():
    """``DistributedInlTrainer`` on the card equals it on the CPU (the plain
    versions), classic and INL, on both routes."""
    _need_card()
    import contextlib
    import io

    from complexity_tokenizer_tpu_torch.parallel.trainer import DistributedInlTrainer
    from complexity_tokenizer_tpu_torch.trainers.inl_trainer import TrainerConfig

    texts = zipf_corpus(200, seed=3)
    for gate in (0.0, 0.5):
        for max_v in ("4096", "1"):
            os.environ["CTOK_TRAINER_DEVICE_SELECT_MAX_V"] = max_v
            try:
                runs = []
                for dev in ("cuda", "cpu"):
                    t = DistributedInlTrainer(TrainerConfig(vocab_size=700, min_frequency=1,
                                                            inl_gate=gate), device=dev)
                    with contextlib.redirect_stdout(io.StringIO()):
                        t.train_from_texts(texts)
                    runs.append(t)
            finally:
                del os.environ["CTOK_TRAINER_DEVICE_SELECT_MAX_V"]
            assert runs[0].merges == runs[1].merges and len(runs[0].merges) > 300
            assert dict(runs[0].pair_freqs) == dict(runs[1].pair_freqs)
            assert dict(runs[0].token_freqs) == dict(runs[1].token_freqs)


# ---------------------------------------------------------------------------
# K17-K19: the WordPiece and Unigram trainers' kernels


def _unigram_capture(texts, cfg, device="cuda"):
    """Every device E-step's inputs of ``DistributedUnigramTrainer`` on
    ``texts``, the tables copied (the trainer frees them)."""
    import contextlib
    import io

    from complexity_tokenizer_tpu_torch.parallel.unigram_trainer import DistributedUnigramTrainer
    from complexity_tokenizer_tpu_torch.trainers.unigram_trainer import UnigramTrainerConfig

    kept = []
    t = DistributedUnigramTrainer(UnigramTrainerConfig(**cfg), device=device)
    t.capture = lambda r, inp: kept.append(inp)
    with contextlib.redirect_stdout(io.StringIO()):
        t.train_from_texts(texts)
    return t, kept


def test_k17_matches_plain():
    """K17 against its plain version, bit for bit: on K12's results of every
    E-step of a small training run, and on synthetic results holding ids 0
    and V - 1, fallbacks, -1, ids at and past V and poisoned texts."""
    from complexity_tokenizer_tpu_torch.ops.unigram_device import (
        piece_hist,
        piece_hist_launch_shape,
        piece_hist_plain,
        viterbi,
    )

    _need_card()
    texts = [w for t in zipf_corpus(200, seed=7) + list(MULTI_PIECES) for w in t.split()]
    _t, kept = _unigram_capture(texts, dict(vocab_size=300, initial_vocab_size=4000,
                                            n_iterations=4))
    assert len(kept) >= 2
    for inp in kept:
        res = viterbi(*inp["viterbi"])
        args = inp["piece_hist"]
        before = piece_hist.launches
        got = piece_hist(res, *args)
        torch.cuda.synchronize()
        assert piece_hist.launches == before + 1
        assert torch.equal(got, piece_hist_plain(res, *args))
    rng = np.random.RandomState(3)
    V, B = 1000, 3000
    lens = rng.randint(0, 129, size=B)
    offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    out = rng.randint(-2, V + 2, size=offs[-1]).astype(np.int32)
    out[:: 7] = 0
    out[3:: 11] = V - 1
    poison = (rng.rand(B) < 0.1).astype(np.int32)
    res = torch.from_numpy(np.concatenate([out, lens.astype(np.int32), poison])).cuda()
    freqs = torch.from_numpy(rng.randint(1, 1000, size=B).astype(np.int32)).cuda()
    gidx = torch.from_numpy(rng.permutation(B + 50)[:B].astype(np.int32)).cuda()
    o = torch.from_numpy(offs).cuda()
    got = piece_hist(res, o, freqs, gidx, V, B + 50)
    exp = piece_hist_plain(res, o, freqs, gidx, V, B + 50)
    assert torch.equal(got, exp) and int(exp[0]) > 0 and int(exp[V - 1]) > 0
    assert int(exp[V:].sum()) == int(poison.sum()) > 0
    with pytest.raises(ValueError, match="freqs"):
        piece_hist(res, o, freqs[:-1], gidx, V, B + 50)
    shape = piece_hist_launch_shape()
    assert shape["blocks_per_sm"] > 0 and shape["local_bytes"] == 0, shape


@pytest.mark.parametrize("case", range(7))
def test_k17_matches_plain_on_edge_results(case):
    """K17 against its plain version, bit for bit, one launch a call, on
    ``utils/corpus.py:piece_hist_edge_results``: a hot id that most texts
    choose, runs of texts of no slot, texts of 100 slots and more, every
    text poisoned, one text, V = 1, ids at and past V; and from a CUDA
    graph (the clear, then K17 as its programmatic dependent)."""
    _need_card()
    from complexity_tokenizer_tpu_torch.ops.unigram_device import piece_hist, piece_hist_plain

    label, *arrays, V, n_global = piece_hist_edge_results()[case]
    res, offs, freqs, gidx = (torch.from_numpy(a).cuda() for a in arrays)
    exp = piece_hist_plain(res, offs, freqs, gidx, V, n_global)
    before = piece_hist.launches
    got = piece_hist(res, offs, freqs, gidx, V, n_global)
    torch.cuda.synchronize()
    assert piece_hist.launches == before + 1
    assert torch.equal(got, exp), label
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        got = piece_hist(res, offs, freqs, gidx, V, n_global)
    got.fill_(-1)
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(got, exp), label


def _wordpiece_capture(texts, vocab_size, rounds, device="cuda"):
    """The inputs of K18 at the given rounds of ``DistributedWordPieceTrainer``
    on ``texts``, the tables cloned (they grow in place)."""
    from complexity_tokenizer_tpu_torch.parallel.wordpiece_trainer import (
        DistributedWordPieceTrainer,
    )
    from complexity_tokenizer_tpu_torch.trainers.wordpiece_trainer import WordPieceTrainerConfig

    kept = []

    def keep(r, inp):
        if r in rounds:
            kept.append({k: v.clone() if isinstance(v, torch.Tensor) else v
                         for k, v in inp.items()})

    t = DistributedWordPieceTrainer(WordPieceTrainerConfig(vocab_size=vocab_size), device=device)
    t.capture = keep
    t.train_from_texts(texts)
    return t, kept


def _sorted_pairs(res):
    from complexity_tokenizer_tpu_torch.ops.wordpiece_train_device import split_pairs

    keys, counts, n, n_poison = split_pairs(res.cpu().numpy())
    order = np.argsort(keys)
    return keys[order].tolist(), counts[order].tolist(), n, n_poison


def _check_k18_k19(inp):
    from complexity_tokenizer_tpu_torch.ops.wordpiece_train_device import (
        PairCountScratch,
        pair_count,
        pair_count_plain,
        train_match,
        train_match_plain,
    )

    args = (inp["chars"], inp["offs"], inp["lens"], inp["groups"], inp["table"],
            inp["slot_meta"], inp["slot_chars"], inp["fb_map"], inp["lt_cap"])
    before = train_match.launches, pair_count.launches
    out, poison = train_match(*args)
    out_p, poison_p = train_match_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(out, out_p) and torch.equal(poison, poison_p)
    scratch = PairCountScratch(inp["chars"].numel(), "cuda")
    got = _sorted_pairs(pair_count(out, inp["offs"], inp["freqs"], poison, scratch))
    exp = _sorted_pairs(pair_count_plain(out, inp["offs"], inp["freqs"], poison, scratch.t_size))
    assert got == exp
    assert (train_match.launches, pair_count.launches) == (before[0] + 1, before[1] + 1)
    return exp, int(poison.sum())


def test_k18_k19_match_plain():
    """K18 and K19 against their plain versions, bit for bit (K19 as a set of
    (key, count), its number and the poisoned words): the trainer's inputs
    at rounds 0, 40 and 300 on texts with words of 1, 13, 127 and 128
    characters (and 129, which the host takes), then with every form of two
    characters or more forged (its first character changed), which poisons
    the words whose chosen form it is."""
    from complexity_tokenizer_tpu_torch.utils.corpus import wordpiece_train_edge_texts

    _need_card()
    _t, kept = _wordpiece_capture(wordpiece_train_edge_texts(), 400, {0, 40, 300})
    assert len(kept) == 3
    for inp in kept:
        lens = inp["lens"].cpu().numpy()
        assert {1, 13, 127, 128} <= set(lens.tolist()) and lens.max() == 128
        (_keys, _counts, n, _np), poisoned = _check_k18_k19(inp)
        assert n > 0 and poisoned == 0
    forged = dict(kept[-1])
    forged["slot_chars"] = forged["slot_chars"].clone()
    long_forms = forged["slot_meta"][:, 0] >= 2
    forged["slot_chars"][long_forms, 0] += 1
    _pairs, poisoned = _check_k18_k19(forged)
    assert poisoned > 0


def _k18_edge_tables(device="cuda"):
    """``utils/corpus.py:train_match_edge_words`` and the trainer's tables of
    its vocabulary on ``device`` (the mirror's one buffer, forms of every
    length up to 128), with the fallback symbols of its characters:
    (words, table, slot_meta, slot_chars, fb_map)."""
    from complexity_tokenizer_tpu_torch.ops.wordpiece_train_device import (
        MAX_CP,
        match_table_views,
    )
    from complexity_tokenizer_tpu_torch.parallel.wordpiece_trainer import _MatchTables
    from complexity_tokenizer_tpu_torch.utils.corpus import train_match_edge_words

    words, _freqs, vocab = train_match_edge_words()
    sym_of: dict = {}

    def sym(s):
        return sym_of.setdefault(s, len(sym_of))

    tables = _MatchTables(1600)
    for tok in sorted(vocab, key=vocab.__getitem__):
        s = sym(tok)
        assert tables.insert_form([ord(c) for c in tok], False, s)
        if tok.startswith("##") and len(tok) > 2:
            assert tables.insert_form([ord(c) for c in tok[2:]], True, s)
    assert tables.max_len == 128
    fb = np.full((2, MAX_CP), -1, np.int32)
    for c in sorted({c for w in words for c in w}):
        fb[0, ord(c)] = sym(c)
        fb[1, ord(c)] = sym("##" + c)
    views = match_table_views(tables.device_buffer(device), tables.t_size, tables.s_cap)
    return (words, *views, torch.from_numpy(fb).to(device))


def _k18_words(words, sort=True, device="cuda"):
    """(chars, offs, lens) on ``device`` and the pack's groups (n8, n16): the
    words ordered by length (``_pack_words``), or as given with the groups
    the sorted pack would have, so that a group holds longer words."""
    from complexity_tokenizer_tpu_torch.ops.wordpiece_device import _pack_words

    wl = np.fromiter(map(len, words), np.int64, len(words))
    chars, offs, order, groups = _pack_words(words, wl, wl)
    if not sort:
        text = "".join(words)
        chars = np.frombuffer(text.encode("utf-32-le"), np.uint32).astype(np.int32)
        offs = np.concatenate([[0], np.cumsum(wl)]).astype(np.int32)
        order = np.arange(len(words))
    on = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)  # noqa: E731
    return on(chars), on(offs), on(wl[order]), groups


def test_k18_edge_cases_match_plain():
    """K18 against its plain version, bit for bit (out and poison), one
    launch a case (none for no word): words at the lane groups' edges (1,
    8, 9, 16, 17, 32, 33, 127 and 128 characters) ordered by length at
    ``lt_cap`` 8, 16, 32 and 128 over forms of every length up to 128;
    the words unsorted with the sorted pack's groups (a group of 8 holds a
    word of 128); every word in groups of 8 (``lt_cap`` wider than every
    group), of 16, or a warp each; one word of 128 characters alone; no
    word; every character without a fallback symbol; the tables with every
    form of two characters or more forged."""
    from complexity_tokenizer_tpu_torch.ops.wordpiece_train_device import (
        train_match,
        train_match_plain,
    )

    _need_card()
    words, table, meta, schars, fb = _k18_edge_tables()
    rng = np.random.RandomState(18)
    shuffled = [words[i] for i in rng.permutation(len(words))]
    chars, offs, lens, groups = _k18_words(words)
    B = len(words)
    long_word = max(words, key=len)
    forged = schars.clone()
    forged[meta[:, 0] >= 2, 0] += 1
    cases = [(f"by length, lt_cap {lt}", (chars, offs, lens, groups), schars, fb, lt)
             for lt in (8, 16, 32, 128)]
    cases += [
        ("unsorted, the sorted pack's groups", _k18_words(shuffled, sort=False), schars, fb, 128),
        ("every word in groups of 8", (chars, offs, lens, (B, B)), schars, fb, 128),
        ("every word in groups of 16", (chars, offs, lens, (0, B)), schars, fb, 32),
        ("every word a warp", (chars, offs, lens, (0, 0)), schars, fb, 16),
        ("one word of 128 characters", _k18_words([long_word]), schars, fb, 128),
        ("no word", _k18_words([]), schars, fb, 32),
        ("no fallback symbol", (chars, offs, lens, groups), schars, torch.full_like(fb, -1), 32),
        ("forms of 2+ characters forged", (chars, offs, lens, groups), forged, fb, 128),
    ]
    assert len(long_word) == 128 and groups[0] < groups[1] < B
    for label, (c, o, ln, g), sc, f, lt in cases:
        args = (c, o, ln, g, table, meta, sc, f, lt)
        before = train_match.launches
        out, poison = train_match(*args)
        out_p, poison_p = train_match_plain(*args)
        torch.cuda.synchronize()
        assert torch.equal(out, out_p) and torch.equal(poison, poison_p), label
        assert train_match.launches == before + (ln.numel() > 0), label
        if label in ("no fallback symbol", "forms of 2+ characters forged"):
            assert bool(poison.any()), label
        elif ln.numel():
            assert not bool(poison.any()) and int((out >= 0).sum()) > 0, label


def _k19_input(rng, lens, n_syms, gap=0.3, poison=0.0, dead_start=0.0, sym=None):
    """K19's inputs for words of ``lens`` slots: symbols below ``n_syms`` (or
    ``sym(rng, n)``), -1 in a share ``gap`` of the slots past a word's first,
    that slot -1 in a share ``dead_start`` of the words, a share ``poison``
    of the words poisoned, frequencies up to 1,000."""
    lens = np.asarray(lens, np.int64)
    offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    N = int(offs[-1])
    syms = (rng.randint(0, n_syms, size=N) if sym is None else sym(rng, N)).astype(np.int32)
    out = np.where(rng.rand(N) < gap, -1, syms).astype(np.int32)
    starts = offs[:-1][lens > 0]
    out[starts] = syms[starts]
    out[starts[rng.rand(starts.size) < dead_start]] = -1
    freqs = rng.randint(1, 1001, size=len(lens)).astype(np.int32)
    flags = (rng.rand(len(lens)) < poison).astype(np.int32)
    return [torch.from_numpy(a).cuda() for a in (out, offs, freqs, flags)]


def test_k19_edge_cases_match_plain():
    """K19 against its plain version as a set of (key, count), with its
    number and the poisoned words: a round with many keys (empty words,
    runs of 40 of them, words whose first slot is -1, poisoned words) then
    rounds with few keys on the same scratch (no stale row survives), no
    word, every word poisoned, one hot key in every pair, words of 128
    slots; one launch a call."""
    from complexity_tokenizer_tpu_torch.ops.wordpiece_train_device import (
        PairCountScratch,
        pair_count,
        pair_count_plain,
    )

    _need_card()
    rng = np.random.RandomState(19)
    many_lens = rng.randint(0, 21, size=6000)
    many_lens[1000:1040] = 0
    many_lens[3000:3045] = 0
    cases = [
        ("many keys", _k19_input(rng, many_lens, 3000, poison=0.05, dead_start=0.05)),
        ("few keys", _k19_input(rng, rng.randint(1, 9, size=3000), 4)),
        ("one word of one slot", _k19_input(rng, [1], 4)),
        ("few keys again", _k19_input(rng, rng.randint(1, 30, size=4000), 3, poison=0.1)),
        ("no word", _k19_input(rng, np.zeros(0, np.int64), 4)),
        ("every word poisoned", _k19_input(rng, rng.randint(1, 20, size=2000), 50, poison=1.0)),
        ("one hot key", _k19_input(rng, rng.randint(2, 40, size=20000), 1, gap=0.2,
                                   sym=lambda r, n: np.full(n, 5))),
        ("words of 128 slots", _k19_input(rng, np.full(700, 128), 900, gap=0.6, poison=0.05)),
    ]
    scratch = PairCountScratch(max(c[1][0].numel() for c in cases), "cuda")
    for label, (out, offs, freqs, poison) in cases:
        before = pair_count.launches
        got = _sorted_pairs(pair_count(out, offs, freqs, poison, scratch))
        exp = _sorted_pairs(pair_count_plain(out, offs, freqs, poison, scratch.t_size))
        assert got == exp, label
        assert pair_count.launches == before + 1
        assert exp[3] == int((poison != 0).sum()), label
        if label == "one hot key":
            assert exp[:3] == ([(5 << 16) | 5], exp[1], 1) and exp[1][0] > 1 << 20, label
        if label in ("no word", "every word poisoned"):
            assert exp[2] == 0, label
        if label == "many keys":
            assert exp[2] > 10_000, exp[2]
    assert not scratch.head.any() and bool((scratch.table[:, 0] == -1).all())
    assert not scratch.table[:, 1].any()


def test_trainers_on_card_match_cpu():
    """``DistributedWordPieceTrainer`` and ``DistributedUnigramTrainer`` on
    the card equal the host trainers and, on a smaller case, themselves on
    the CPU (the plain versions), launching K18 and K19 once a round and K12 and K17 once a
    device E-step, and nothing else of the trainers' kernels."""
    from complexity_tokenizer_tpu_torch.ops.unigram_device import piece_hist
    from complexity_tokenizer_tpu_torch.ops.wordpiece_train_device import pair_count, train_match
    from complexity_tokenizer_tpu_torch.ops.unigram_device import viterbi
    from complexity_tokenizer_tpu_torch.trainers import (
        UnigramTrainer,
        UnigramTrainerConfig,
        WordPieceTrainer,
        WordPieceTrainerConfig,
    )
    from complexity_tokenizer_tpu_torch.utils.corpus import wordpiece_train_edge_texts

    _need_card()
    texts = wordpiece_train_edge_texts(1)
    counts = {}
    for k in (train_match, pair_count, viterbi, piece_hist):
        counts[k] = k.launches
    card, _kept = _wordpiece_capture(texts, 300, set())
    cpu, _kept = _wordpiece_capture(texts[:2], 100, set(), device="cpu")
    small, _kept = _wordpiece_capture(texts[:2], 100, set())
    host = WordPieceTrainer(WordPieceTrainerConfig(vocab_size=300))
    host.train_from_texts(texts)
    rounds = card.last_stats["rounds"] + small.last_stats["rounds"]
    assert card.vocab == host.vocab and len(card.vocab) == 300 and small.vocab == cpu.vocab
    assert train_match.launches - counts[train_match] == rounds
    assert pair_count.launches - counts[pair_count] == rounds
    assert card.last_stats["over_wide"] > 0
    words = [w for t in zipf_corpus(150, seed=9) for w in t.split()] + ["x" * 140]
    cfg = dict(vocab_size=200, initial_vocab_size=3000, n_iterations=5)
    ug, _kept = _unigram_capture(words, cfg)
    ug_cpu, _kept = _unigram_capture(words, cfg, device="cpu")
    ug_host = UnigramTrainer(UnigramTrainerConfig(**cfg))
    ug_host.train_from_texts(words)
    assert ug.vocab == ug_cpu.vocab == ug_host.vocab
    device_rounds = sum(r["route"] == "device" for r in ug.rounds)
    assert device_rounds == len(ug.rounds) > 0
    assert viterbi.launches - counts[viterbi] == device_rounds
    assert piece_hist.launches - counts[piece_hist] == device_rounds


def test_k18_k19_refuse_bad_inputs_and_launch_without_spilling():
    from complexity_tokenizer_tpu_torch.ops.wordpiece_train_device import (
        PairCountScratch,
        match_table_views,
        pair_count,
        pair_count_launch_shape,
        train_match,
        train_match_launch_shape,
    )

    _need_card()
    chars = torch.zeros(8, dtype=torch.int32, device="cuda")
    offs = torch.tensor([0, 2, 4, 6, 8], dtype=torch.int32, device="cuda")
    lens = torch.full((4,), 2, dtype=torch.int32, device="cuda")
    buf = torch.zeros(4 * 64 + 130 * 16, dtype=torch.int32, device="cuda")
    table, meta, schars = match_table_views(buf, 64, 16)
    fb = torch.full((2, 0x110000), -1, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="lt_cap"):
        train_match(chars, offs, lens, (4, 4), table, meta, schars, fb, 0)
    with pytest.raises(ValueError, match="power of two"):
        train_match(chars, offs, lens, (4, 4), table[:48], meta, schars, fb, 8)
    with pytest.raises(ValueError, match="offs"):
        train_match(chars, offs[:4], lens, (4, 4), table, meta, schars, fb, 8)
    for groups in ((3, 2), (-1, 2), (0, 5), (5, 5)):
        with pytest.raises(ValueError, match="groups"):
            train_match(chars, offs, lens, groups, table, meta, schars, fb, 8)
    out, poison = train_match(chars, offs, lens, (4, 4), table, meta, schars, fb, 8)
    assert poison.tolist() == [1, 1, 1, 1]  # no fallback symbol for any character
    small = PairCountScratch(8, "cuda")
    small.t_size = 32
    with pytest.raises(ValueError, match="table"):
        pair_count(out, offs, lens, poison, small)
    with pytest.raises(ValueError, match="poison"):
        pair_count(out, offs, lens, poison.bool(), PairCountScratch(8, "cuda"))
    for shape in (train_match_launch_shape(), pair_count_launch_shape()):
        assert shape["blocks_per_sm"] > 0 and shape["local_bytes"] == 0, shape


# --- K20 and K4's phased mode: the phased fill; the sharded fill ------------


@pytest.mark.parametrize("n1", [1, 6])
@pytest.mark.parametrize("kind", ["edges", "dots"])
@pytest.mark.parametrize("B", [2, 64, 1024])
@pytest.mark.parametrize("config", ["qc50k", "chd50k", "chd100k"])
def test_k20_matches_plain(tok50k, tok100k, chd50k, config, B, kind, n1):
    """K20 (block-flat word ids, the seed, n1 JAX steps, the half-row
    compaction) equals its plain version on the card bit for bit, on both
    probes, on edge rows (runs before the first start bit, rows of length 0
    and 128, OOV bytes) and on rows of ``.`` runs; one launch a call."""
    from complexity_tokenizer_tpu_torch.ops.wordfill import phase_compact, phase_compact_plain

    _need_card()
    _probe, tb = _fill_tables(config, tok50k, tok100k, chd50k)
    pack = _fill_pack(kind, B, seed=B + n1)
    before = phase_compact.launches
    got = phase_compact(*pack, n1, tables=tb)
    torch.cuda.synchronize()
    assert phase_compact.launches == before + 1
    exp = phase_compact_plain(*pack, n1, tables=tb)
    for g, e in zip(got, exp):
        assert torch.equal(g, e)


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("config", ["qc50k", "chd100k"])
def test_phased_fill_matches_plain(tok50k, tok100k, chd50k, config, itemsize):
    """The phased fill (K20, K2 or K5, K4's phased mode: one launch each)
    equals its plain version on the card and on the CPU byte for byte, and
    K4's phased mode alone its plain version, on corpus packs and edge
    rows, at n1 = 4 and 6."""
    from complexity_tokenizer_tpu_torch.ops.wordfill import (
        fill_compact_phased,
        fill_compact_phased_plain,
        phase_compact,
        word_fill_phased,
        word_fill_phased_plain,
    )

    _need_card()
    probe, tb = _fill_tables(config, tok50k, tok100k, chd50k)
    tok = tok50k if config == "qc50k" else tok100k
    cpu_tb = tok.pipeline("cpu").tables
    fixpoint = merge_words_qc if probe == "qc" else merge_words
    for kind, B in (("edges", 256), ("edges", 1024), ("dots", 64)):
        pack = _fill_pack(kind, B, seed=B)
        cap = B * 128 * 3 // 8
        for n1 in (4, 6):
            counted = (phase_compact, fixpoint, fill_compact_phased)
            before = [fn.launches for fn in counted]
            got = word_fill_phased(*pack, cap, n1, tables=tb, itemsize=itemsize)
            torch.cuda.synchronize()
            assert [fn.launches - b for fn, b in zip(counted, before)] == [1, 1, 1]
            exp = word_fill_phased_plain(*pack, cap, n1, tables=tb, itemsize=itemsize)
            assert torch.equal(got, exp), (kind, B, n1)
            cpu = word_fill_phased(*(x.cpu() for x in pack), cap, n1, tables=cpu_tb,
                                   itemsize=itemsize)
            assert torch.equal(got.cpu(), cpu), (kind, B, n1)
            t2, w2, kept = phase_compact(*pack, n1, tables=tb)
            merged, count = tb.merge_fixpoint(t2, w2)
            assert torch.equal(fill_compact_phased(merged, count, w2, kept, cap, itemsize),
                               fill_compact_phased_plain(merged, count, w2, kept, cap, itemsize))


def test_phased_and_sharded_word_paths_on_card_match_unsharded(tok50k, monkeypatch):
    """Every distinct word of a corpus through the word path with
    ``CTOK_PHASE_N1=6`` (K20, K2, K4's phased mode; a spilled pack again
    through K6 and K4), and sharded over ``[cuda:0]`` and ``[cuda:0,
    cuda:0]`` (two blocks on two streams), phased and not: ids and counts
    equal the unsharded unphased fill's bit for bit."""
    from complexity_tokenizer_tpu_torch.native import NativeEncoder
    from complexity_tokenizer_tpu_torch.ops.tables import byte_token_table
    from complexity_tokenizer_tpu_torch.ops.wordfill import fill_compact_phased, phase_compact
    from complexity_tokenizer_tpu_torch.ops.wordpath import DeviceWordEncoder
    from complexity_tokenizer_tpu_torch.parallel import data_mesh, shard_word_encoder

    _need_card()
    texts = zipf_corpus(2000, seed=13) + list(MULTI_PIECES)
    data = tok50k._prepare_bytes([tok50k._normalize(t) for t in texts])

    def encoder(n1, mesh=None):
        monkeypatch.setenv("CTOK_PHASE_N1", str(n1))
        native = NativeEncoder(tok50k.bpe.packed_merge_arrays(), byte_token_table(tok50k.bpe.vocab))
        wp = DeviceWordEncoder(tok50k.pipeline("cuda"), native)
        if mesh is not None:
            shard_word_encoder(wp, data_mesh(devices=mesh))
        return wp

    wp = encoder(0)
    words, lens = wp.native.collect_miss_words(data, 128)
    exp_ids, exp_counts = wp._encode_words_packed(words, lens)
    assert (exp_counts >= 0).all()
    for n1 in (0, 6):
        for mesh in (None, ["cuda:0"], ["cuda:0", "cuda:0"]):
            w = encoder(n1, mesh)
            before = (phase_compact.launches, fill_compact_phased.launches)
            ids, counts = w._encode_words_packed(words, lens)
            launched = (phase_compact.launches - before[0], fill_compact_phased.launches - before[1])
            assert np.array_equal(counts, exp_counts), (n1, mesh)
            assert np.array_equal(ids, exp_ids), (n1, mesh)
            assert w.last_fill["blocks"] == (1 if mesh is None else len(mesh))
            if n1:
                assert launched[0] == launched[1] > 0
            else:
                assert launched == (0, 0)


def test_sharded_text_pipeline_on_card_matches_host(tok50k):
    """The text pipeline split over ``[cuda:0, cuda:0]`` (two blocks, two
    streams, every block launched before any is read back) equals the host
    oracle."""
    from complexity_tokenizer_tpu_torch.parallel import data_mesh, shard_encode_pipeline

    _need_card()
    tok = Tokenizer.from_file(BENCH_50K)
    pipe = tok.pipeline("cuda")
    shard_encode_pipeline(pipe, data_mesh(devices=["cuda:0", "cuda:0"]))
    texts = zipf_corpus(500, seed=4) + list(MULTI_PIECES)
    data = tok._prepare_bytes([tok._normalize(t) for t in texts])
    assert pipe.encode_bytes(data) == tok.encode_batch(texts, backend="host")


# ---------------------------------------------------------------------------
# K21 (the GPT-2 pre-split) and K22 (K9's fixpoint on the cuckoo table)


def _check_k21(arr_np, lens_np):
    """K21 bit for bit against its plain version on the card, one launch."""
    from complexity_tokenizer_tpu_torch.ops.presplit import presplit, presplit_plain

    arr, lens = torch.from_numpy(arr_np).cuda(), torch.from_numpy(lens_np).cuda()
    table = torch.from_numpy(gpt2_class_table()).cuda()
    before = presplit.launches
    got = presplit(arr, lens, table)
    exp = presplit_plain(arr, lens, table)
    torch.cuda.synchronize()
    assert presplit.launches == before + 1
    for g, e, name in zip(got, exp, ("start", "word_id", "valid")):
        assert g.dtype == e.dtype and torch.equal(g, e), name
    return got


@pytest.mark.parametrize("L", [128, 512, 2048, 4096])
def test_k21_matches_plain_on_edge_rows(L):
    """The traps of utils/corpus.py:presplit_edge_rows at a row's start,
    across the kernel's 128-column steps and at its end, lengths cutting
    into them, any int32 length, non-zero bytes past every length."""
    from complexity_tokenizer_tpu_torch.utils.corpus import presplit_edge_rows

    _need_card()
    _check_k21(*presplit_edge_rows(L))


@pytest.mark.parametrize("B,L", [(8192, 128), (8192, 512), (16, 4096), (2048, 2048),
                                 (5, 48), (3, 200), (1, 7), (9, 129), (7, 384), (5, 1152),
                                 (3, 1920), (3, 2049), (2, 8192), (1, 5000), (6400, 1000),
                                 (20000, 384)])
def test_k21_matches_plain_on_corpus_and_random_rows(B, L):
    """Corpus rows (as the text pipeline packs them) and random bytes, with
    random lengths, some past L and some negative."""
    _need_card()
    rng = np.random.RandomState(B + L)
    texts = zipf_corpus(B, seed=L, lo=max(L // 8, 1), hi=L)
    texts[: min(B, 4)] = ["it's we'll  'd", " ".join(MULTI_PIECES), "", "a" * L][: min(B, 4)]
    arr, lens = pack_texts([t.encode("utf-8")[:L] for t in texts], L, B)
    _check_k21(arr, lens)
    arr = rng.randint(0, 256, size=(B, L)).astype(np.uint8)
    lens = rng.randint(-2, L + 3, size=B).astype(np.int32)
    _check_k21(arr, lens)


def test_k21_refuses_bad_inputs_and_launches_without_spilling():
    from complexity_tokenizer_tpu_torch.ops.presplit import presplit, presplit_launch_shape

    _need_card()
    arr = torch.zeros((4, 128), dtype=torch.uint8, device="cuda")
    lens = torch.zeros(4, dtype=torch.int32, device="cuda")
    table = torch.from_numpy(gpt2_class_table()).cuda()
    with pytest.raises(ValueError, match="lengths"):
        presplit(arr, lens.long(), table)
    with pytest.raises(ValueError, match="class_table"):
        presplit(arr, lens, table[:1000])
    with pytest.raises(ValueError, match="byte_arr"):
        presplit(arr.int(), lens, table)
    with pytest.raises(ValueError, match="contiguous"):
        presplit(torch.zeros((4, 256), dtype=torch.uint8, device="cuda")[:, ::2], lens, table)
    with pytest.raises(ValueError, match="lengths"):
        presplit(arr, lens.cpu(), table)
    start, wid, valid = presplit(arr[:0], lens[:0], table)
    assert start.shape == (0, 128) and wid.dtype == torch.int32
    for L in (128, 512, 2048, 4096):
        shape = presplit_launch_shape(L)
        assert shape["blocks_per_sm"] > 0 and shape["local_bytes"] == 0, (L, shape)
    # a warp a row at 128 columns, a warp a 128-column step up to 32 a row
    assert [presplit_launch_shape(L)["row_warps"] for L in (128, 512, 1920, 4096, 8192)] == \
        [1, 4, 8, 32, 32]
    assert presplit_launch_shape(4096)["threads"] == 1024


def test_text_pipeline_launches_k21_k1_k2_once_a_batch(tok50k):
    from complexity_tokenizer_tpu_torch.ops.presplit import presplit

    _need_card()
    texts = zipf_corpus(300, seed=8) + ["x" * 3000]
    data = tok50k._prepare_bytes([tok50k._normalize(t) for t in texts])
    pipe = tok50k.pipeline("cuda")
    counts = (presplit.launches, seed_tokens.launches, merge_words_qc.launches)
    assert pipe.encode_bytes(data) == tok50k.encode_batch(texts, backend="host")
    got = (presplit.launches - counts[0], seed_tokens.launches - counts[1],
           merge_words_qc.launches - counts[2])
    from complexity_tokenizer_tpu_torch.ops.pipeline import _LENGTH_BUCKETS, _bucket

    batches = len({_bucket(max(len(d), 1), _LENGTH_BUCKETS) for d in data})
    assert batches >= 2 and got == (batches,) * 3, got  # a batch a length bucket


def _k22_case():
    """The 50K ByteLevel BPE model's tier (K9's CHD table) and the cuckoo
    table over the same symbol ids, on the card."""
    from complexity_tokenizer_tpu_torch.ops.stringbpe_device import string_qc_table

    model = _string_tier(BENCH_50K)
    dev = model._tiers.get("cuda")
    qc = string_qc_table(model.merge_ranks)
    t1 = torch.from_numpy(qc.t1.view(np.int32)).cuda()
    t2 = torch.from_numpy(qc.t2.view(np.int32)).cuda()
    return model, dev, (t1, t2, qc.size)


def test_k22_matches_plain_and_k9():
    """K22 bit for bit against its plain version at every tile size, and
    against K9 on the same words (the model's words, 128-symbol runs, a
    tombstone inside a word, ids past the table's universe), and on words
    holding symbol ids past 65,535."""
    from complexity_tokenizer_tpu_torch.ops.merge import (
        merge_word_rows,
        merge_word_rows_qc,
        merge_word_rows_qc_ragged_plain,
        word_tiles,
    )

    _need_card()
    model, dev, qc = _k22_case()
    words = sorted({w for t in zipf_corpus(400, seed=3) for w in model._split_words(t)})
    words += [" " + "a" * 127, "=" * 128, " " + "ab" * 63, "é" * 60, " x中y"]
    enc = model._byte_encoder
    base = len(dev.symbols)
    rows = [[dev.sym_id.get(enc[b], base) for b in w.encode()][:128] for w in words]
    rows[5][3:4] = [-1]  # a tombstone inside a word
    text = " ".join(zipf_corpus(50, seed=2)).encode()
    runs = [[enc[b] for b in r] for r in run_rows(text, 16, 128)]
    syms, offs = dev.pack(runs)[:2]
    rows += [syms[offs[i]:offs[i + 1]].tolist() for i in range(len(runs))]
    rows += [[], [], [base, base + 1]]
    syms, offs = _ragged_words(rows)
    s, o = torch.from_numpy(syms).cuda(), torch.from_numpy(offs).cuda()
    exp_t, exp_c = merge_word_rows_qc_ragged_plain(s, o, *qc)
    for tile in (1, 16, 384, 896, 1920):
        tiles = torch.from_numpy(word_tiles(offs, tile)).cuda()
        before = merge_word_rows_qc.launches
        got_t, got_c = merge_word_rows_qc(s, o, tiles, *qc, tile=tile)
        torch.cuda.synchronize()
        assert merge_word_rows_qc.launches == before + 1
        assert torch.equal(got_t, exp_t) and torch.equal(got_c, exp_c), tile
    tiles = torch.from_numpy(word_tiles(offs)).cuda()
    k9 = merge_word_rows(s, o, tiles, dev.disp, dev.rows, dev.chd.size, dev.chd.n_buckets)
    assert torch.equal(k9[0], exp_t) and torch.equal(k9[1], exp_c)
    assert (exp_c.cpu().numpy() < np.diff(offs)).any()  # merges happened
    # ids past u16 (a left id aliases its low 16 bits in the key), and the
    # pairs that pack to the empty-slot key
    rng = np.random.RandomState(0)
    big = [list(r) for r in rows[:300] if len(r) > 1]
    for r in big:
        r[rng.randint(len(r))] = int(rng.choice([65535, 65536, 131071, 2**31 - 1]))
    big += [[65535, 65535], [131071, 65535]]
    big += [[r[0] + 65536, r[1]] for r in rows[:100] if len(r) > 1]
    syms, offs = _ragged_words(big)
    s, o = torch.from_numpy(syms).cuda(), torch.from_numpy(offs).cuda()
    exp = merge_word_rows_qc_ragged_plain(s, o, *qc)
    got = merge_word_rows_qc(s, o, torch.from_numpy(word_tiles(offs)).cuda(), *qc)
    torch.cuda.synchronize()
    assert torch.equal(got[0], exp[0]) and torch.equal(got[1], exp[1])


def test_k22_refuses_bad_inputs_and_launches_without_spilling():
    from complexity_tokenizer_tpu_torch.ops.merge import (
        TILE_SYMBOLS,
        WORD_LANES,
        merge_word_rows_qc,
    )

    _need_card()
    _model, _dev, (t1, t2, size) = _k22_case()
    syms = torch.zeros(8, dtype=torch.int32, device="cuda")
    offs = torch.tensor([0, 4, 8], dtype=torch.int32, device="cuda")
    tiles = torch.tensor([0, 2], dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="power of two"):
        merge_word_rows_qc(syms, offs, tiles, t1, t2, size - 1)
    with pytest.raises(ValueError, match="t1"):
        merge_word_rows_qc(syms, offs, tiles, t1[:8], t2, size)
    with pytest.raises(ValueError, match="offs"):
        merge_word_rows_qc(syms, offs.long(), tiles, t1, t2, size)
    with pytest.raises(ValueError, match="shared memory"):
        merge_word_rows_qc(syms, offs, tiles, t1, t2, size, tile=20000)
    shape = launch_shape(TILE_SYMBOLS + WORD_LANES - 1, chd=False, ragged=True)
    assert shape["blocks_per_sm"] > 0 and shape["local_bytes"] == 0, shape

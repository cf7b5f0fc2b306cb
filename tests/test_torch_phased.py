"""The phased fill (``CTOK_PHASE_N1``; ``ops/merge.py:phased_merge_words_plain``,
``ops/wordfill.py:word_fill_phased``, the phased harvest of
``ops/wordpath.py``) on the CPU: the plain B12 against the JAX
``phased_merge_words`` in (t_final, wid2, spill) at n1 = 4, 6, 8 on the
cuckoo and the CHD table; the fused buffer against the JAX phased fill body
byte for byte; the word path with ``CTOK_PHASE_N1=6`` against the unphased
fill and the JAX phased fill; the spill redispatch; the seam between fused
half-rows; and the phased fill sharded.  Ids exactly."""

import functools

import numpy as np
import pytest
import torch

from helpers import trained_tokenizer_json

jax = pytest.importorskip("jax")

from complexity_tokenizer_tpu.ops.hashtable import (  # noqa: E402
    chd_lookup_rows_jnp,
    qc_lookup_jnp,
)
from complexity_tokenizer_tpu.ops.merge import phased_merge_words  # noqa: E402
from complexity_tokenizer_tpu.parallel import data_mesh as jax_data_mesh  # noqa: E402
from complexity_tokenizer_tpu.parallel.encode import (  # noqa: E402
    shard_word_encoder as jax_shard_word_encoder,
)
from complexity_tokenizer_tpu.tokenizer import Tokenizer as JaxTokenizer  # noqa: E402
from complexity_tokenizer_tpu_torch.convert import tables_to_device  # noqa: E402
from complexity_tokenizer_tpu_torch.ops.merge import phased_merge_words_plain  # noqa: E402
from complexity_tokenizer_tpu_torch.ops.seed import seed_tokens_plain  # noqa: E402
from complexity_tokenizer_tpu_torch.ops.wordfill import (  # noqa: E402
    block_word_ids_plain,
    fill_compact_phased,
    fill_layout_phased,
    phase_compact,
    phase_compact_plain,
    word_fill_phased,
    word_fill_phased_plain,
    word_ids_plain,
)
from complexity_tokenizer_tpu_torch.parallel import data_mesh, shard_word_encoder  # noqa: E402
from complexity_tokenizer_tpu_torch.tokenizer import Tokenizer  # noqa: E402
from complexity_tokenizer_tpu_torch.utils.bytelevel import bytes_to_unicode  # noqa: E402
from complexity_tokenizer_tpu_torch.utils.unicode_tables import gpt2_class_table  # noqa: E402

W = 128


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small plain-version ops: one torch thread runs them fastest
    when the test workers share the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _seed11_words():
    """The JAX package's ``test_phased_fill_matches_unphased`` words: "a",
    "zz" and 700 words of 1-23 letters of ``abcdefghiqxZW``, seed 11."""
    rng = np.random.RandomState(11)
    words = [b"a", b"zz"]
    for _ in range(700):
        n = rng.randint(1, 24)
        words.append(bytes(rng.choice(list(b"abcdefghiqxZW"), n).astype(np.uint8)))
    return words


@functools.lru_cache(maxsize=None)
def _vocab_words():
    """The fixture's vocabulary tokens of 3-5 bytes, as words: each merges
    into few ids, so after 4 steps every half-row fits and the phased layout
    is used."""
    dec = {c: b for b, c in bytes_to_unicode().items()}
    vocab = Tokenizer.from_str(trained_tokenizer_json()).bpe.vocab
    return sorted(bytes(dec[c] for c in tok) for tok in vocab
                  if 3 <= len(tok) <= 5 and all(c in dec for c in tok))


def _words(kind: str):
    return _vocab_words() if kind == "vocab" else _seed11_words()


def _flat(words):
    return (np.frombuffer(b"".join(words), np.uint8),
            np.array([len(w) for w in words], np.int32))


def _pack(wp, words, rows=64):
    buf, lens = _flat(words)
    offs = np.zeros(len(words) + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    arr, marks, _starts, n_fit, _used = wp._pack_seg(buf, offs, 0, len(words), rows)
    assert n_fit > 0
    bits = np.packbits(marks == 1, axis=1, bitorder="little")
    row_len = (marks > 0).sum(axis=1).astype(np.int32)
    return arr, bits, row_len


@functools.lru_cache(maxsize=None)
def _pair(table: str):
    """(port tables on the CPU, JAX lookup) of the fixture tokenizer's
    cuckoo or CHD pair table, from the same numpy arrays."""
    jp = JaxTokenizer.from_str(trained_tokenizer_json())._get_pipeline()
    btt = np.asarray(jp.byte_token_table)
    if table == "qc":
        t1, t2, size = np.asarray(jp.qc_t1), np.asarray(jp.qc_t2), int(jp.qc_size)
        tb = tables_to_device(byte_token_table=btt, class_table=gpt2_class_table(), device="cpu",
                              qc_t1=t1, qc_t2=t2, qc_size=size)
        return tb, lambda a, b, v: qc_lookup_jnp(jp.qc_t1, jp.qc_t2, size, a, b, v)
    disp, rows = np.asarray(jp.disp), np.asarray(jp.rows)
    tb = tables_to_device(byte_token_table=btt, class_table=gpt2_class_table(), device="cpu",
                          chd_disp=disp, chd_rows=rows)
    ts, nb = int(jp.table_size), int(jp.n_buckets)
    return tb, lambda a, b, v: chd_lookup_rows_jnp(jp.disp, jp.rows, ts, nb, a, b, v)


@functools.lru_cache(maxsize=None)
def _jax_phased(table: str):
    """The JAX ``phased_merge_words`` jitted once per table, n1 traced."""
    lookup = _pair(table)[1]
    return jax.jit(lambda t, w, n1: phased_merge_words(t, w, lookup, n1))


@pytest.fixture(scope="module")
def wp():
    return Tokenizer.from_str(trained_tokenizer_json())._get_word_path("cpu")


@pytest.mark.parametrize("table", ["qc", "chd"])
@pytest.mark.parametrize("words", ["vocab", "seed11"])
@pytest.mark.parametrize("n1", [4, 6, 8])
def test_phased_merge_plain_equals_jax(wp, table, words, n1):
    """B12's plain version gives the JAX ``phased_merge_words``'s (t_final,
    wid2, spill) bit for bit on a pack's seeded tokens and block-flat word
    ids; the seed-11 words spill, the vocabulary words do not."""
    tb, lookup = _pair(table)
    a, bits, row_len = (torch.from_numpy(x) for x in
                        _pack(wp, _words(words)))
    tokens = seed_tokens_plain(a, row_len, tb.byte_token_table)
    wid = block_word_ids_plain(bits, row_len)
    t_f, w2, spill = phased_merge_words_plain(tokens, wid, tb.pair_lookup, n1)
    et, ew, es = _jax_phased(table)(tokens.numpy(), wid.numpy(), np.int32(n1))
    assert bool(spill) == bool(es) == (words == "seed11")
    assert np.array_equal(t_f.numpy(), np.asarray(et))
    assert np.array_equal(w2.numpy(), np.asarray(ew))


@pytest.mark.parametrize("words", ["vocab", "seed11"])
def test_phased_fused_buffer_equals_jax_fill_body(wp, words):
    """The phased fill (and its plain version) equal the JAX phased fill
    body byte for byte, the spill sentinel (B*W + 1) included; K20's plain
    version gives the rows B12 compacts."""
    jwp = JaxTokenizer.from_str(trained_tokenizer_json())._get_word_path()
    a, bits, row_len = _pack(wp, _words(words))
    B = a.shape[0]
    cap = B * W * 3 // 8
    itemsize = np.dtype(wp._out_dtype).itemsize
    args = [torch.from_numpy(x) for x in (a, bits, row_len)]
    tables = wp.pipeline.tables
    exp = np.asarray(jax.jit(jwp._local_fill_body(3, 8, 6))(a, bits, row_len))
    got = word_fill_phased(*args, cap, 6, tables=tables, itemsize=itemsize)
    assert got.numel() == fill_layout_phased(B, W, cap, itemsize)[3]
    assert got.numpy().tobytes() == exp.tobytes()
    plain = word_fill_phased_plain(*args, cap, 6, tables=tables, itemsize=itemsize)
    assert torch.equal(plain, got)
    total = int(exp[-4:].view(np.int32)[0])
    assert (total == B * W + 1) == (words == "seed11")
    t2, w2, kept = phase_compact(*args, 6, tables=tables)
    assert torch.equal(kept, phase_compact_plain(*args, 6, tables=tables)[2])
    assert bool((kept > W // 2).any()) == (words == "seed11")
    assert t2.shape == w2.shape == (B // 2, W)
    with pytest.raises(ValueError):
        phase_compact(*(x[:7] for x in args), 6, tables=tables)  # odd rows do not pair
    merged, count = tables.merge_fixpoint(t2, w2)
    assert torch.equal(fill_compact_phased(merged, count, w2, kept, cap, itemsize), got)


def _host_merge(w, word: bytes) -> list[int]:
    """The host merge of one word's bytes (the byte-level string)."""
    enc = bytes_to_unicode()
    return w.pipeline._host_bpe.encode("".join(enc[b] for b in word))


def _fill(words, n1, sharded=0):
    """(ids, counts, last_fill) of the port's word path on ``words`` with
    ``CTOK_PHASE_N1=n1``, on ``sharded`` CPU blocks when not 0."""
    w = Tokenizer.from_str(trained_tokenizer_json())._get_word_path("cpu")
    w._phase_n1_cached = None
    if sharded:
        shard_word_encoder(w, data_mesh(devices=["cpu"] * sharded))
    ids, counts = w._encode_words_packed(*_flat(words))
    assert w._phase_n1 == n1
    return ids, counts, w.last_fill, w


@pytest.mark.parametrize("words", ["vocab", "seed11"])
def test_phased_word_path_equals_unphased_and_jax(monkeypatch, words):
    """With ``CTOK_PHASE_N1=6`` the word path's ids and counts equal the
    unphased fill's, the JAX phased fill's and the native merge of each
    word; unset, the fill is unphased.  The vocabulary words take the
    phased layout (no spill), the seed-11 words spill and are sent again."""
    ws = _words(words)
    monkeypatch.delenv("CTOK_PHASE_N1", raising=False)
    ids_u, cnt_u, stats_u, _ = _fill(ws, 0)
    assert stats_u["phase_n1"] == 0
    monkeypatch.setenv("CTOK_PHASE_N1", "6")
    ids_p, cnt_p, stats_p, w = _fill(ws, 6)
    assert stats_p["phase_n1"] == 6
    assert (stats_p["spills"] == 0) == (words == "vocab")
    jwp = JaxTokenizer.from_str(trained_tokenizer_json())._get_word_path()
    assert jwp._phase_n1 == 6
    ids_j, cnt_j = jwp._encode_words_packed(*_flat(ws))
    assert cnt_p.tolist() == cnt_u.tolist() == cnt_j.tolist()
    assert ids_p.tolist() == ids_u.tolist() == ids_j.tolist()
    bounds = np.zeros(len(cnt_p) + 1, np.int64)
    np.cumsum(cnt_p, out=bounds[1:])
    for k in range(0, len(ws), 7):
        assert ids_p[bounds[k] : bounds[k + 1]].tolist() == _host_merge(w, ws[k])


def test_phased_spill_redispatch(monkeypatch):
    """320 one-byte words cannot halve (every lane stays kept): the phase's
    sentinel sends the pack again unphased at full capacity, and every word
    stays exact."""
    monkeypatch.setenv("CTOK_PHASE_N1", "6")
    words = [bytes([c]) for c in b"abcdefgh" * 40]
    ids, counts, stats, w = _fill(words, 6)
    assert stats["spills"] == 1
    assert counts.tolist() == [1] * len(words)
    assert [[i] for i in ids.tolist()] == [_host_merge(w, x) for x in words]


def test_half_row_seam_keeps_words_apart(monkeypatch, wp):
    """A row that holds one word whose kept lanes fill W/2 exactly, then a
    row whose first word starts with a byte that merges with the first
    word's last: fused into one row, the two words meet at the seam.  With
    block-flat word ids they keep apart (one start each, no spill, every id
    the native merge's); with row-local ids (K3's) both words would carry
    id 0 and merge across the seam."""
    tab = wp.pipeline.tables.byte_token_table
    bpe = Tokenizer.from_str(trained_tokenizer_json()).bpe
    in_merge = {i for pair in bpe.merge_ranks for i in pair}
    lone = next(b for b in range(256) if tab[b] >= 0 and int(tab[b]) not in in_merge)
    # 'l' + 'i' is a merge of two one-byte tokens in the fixture's table
    assert (int(tab[ord("l")]), int(tab[ord("i")])) in bpe.merge_ranks
    first = bytes([lone]) * 63 + b"l"  # 64 lanes that cannot merge
    # 66 bytes (does not fit beside the first); its 'i' stays a lane of its
    # own, the rest merges into 33 lanes or fewer
    second = b"i" + bytes([lone]) + b"li" * 32
    words = [first, second]
    a, bits, row_len = (torch.from_numpy(x) for x in _pack(wp, words))
    assert row_len[:2].tolist() == [64, 66]
    tables = wp.pipeline.tables
    t2, w2, kept = phase_compact_plain(a, bits, row_len, 6, tables=tables)
    assert kept[0] == W // 2 and kept[1] <= W // 2
    assert w2[0, W // 2 - 1] != w2[0, W // 2]  # the seam: two words
    # the same compaction with row-local ids joins them into one word
    tokens = seed_tokens_plain(a, row_len, tables.byte_token_table)
    local = word_ids_plain(bits, row_len)
    t_loc, w_loc, spill = phased_merge_words_plain(tokens, local, tables.pair_lookup, 6)
    assert w_loc[0, W // 2 - 1] == w_loc[0, W // 2] == 0
    t_flat, _w, _s = phased_merge_words_plain(tokens, block_word_ids_plain(bits, row_len),
                                              tables.pair_lookup, 6)
    assert not torch.equal(t_loc, t_flat)
    monkeypatch.setenv("CTOK_PHASE_N1", "6")
    ids, counts, stats, w = _fill(words, 6)
    assert stats["spills"] == 0
    assert ids[: counts[0]].tolist() == _host_merge(w, first)
    assert ids[counts[0] :].tolist() == _host_merge(w, second)


@pytest.mark.parametrize("ndev", [2, 8])
def test_sharded_phased_fill(monkeypatch, ndev):
    """The phased rule applies per block (B/n rows pair up): sharded over
    ndev CPU blocks the phased fill equals the unsharded unphased fill, and
    at 8 blocks the JAX sharded phased fill on its 8-device mesh."""
    ws = _vocab_words() + _seed11_words()[:60]
    monkeypatch.delenv("CTOK_PHASE_N1", raising=False)
    ids_u, cnt_u, _stats, _ = _fill(ws, 0)
    monkeypatch.setenv("CTOK_PHASE_N1", "6")
    ids_s, cnt_s, stats, _ = _fill(ws, 6, sharded=ndev)
    assert stats["blocks"] == ndev
    assert cnt_s.tolist() == cnt_u.tolist()
    assert ids_s.tolist() == ids_u.tolist()
    if ndev == 8:
        jwp = JaxTokenizer.from_str(trained_tokenizer_json())._get_word_path()
        jax_shard_word_encoder(jwp, jax_data_mesh())
        ids_j, cnt_j = jwp._encode_words_packed(*_flat(ws))
        assert cnt_s.tolist() == cnt_j.tolist()
        assert ids_s.tolist() == ids_j.tolist()

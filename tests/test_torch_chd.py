"""The CHD merge fixpoint (K5's plain version, ``ops/merge.py:merge_words``)
and the paths past u16 on the CPU against the JAX package, ids exactly.

Three tables: the 800-vocab fixture (its CHD table built although the
cuckoo table fits it), the fixture with every id shifted past 65,535 (ids
past u16, ranks not), and the committed 100,000-entry tokenizer
(``scripts/make_bench_tokenizer_100k.py``: ids and ranks past u16).  Inputs
are made with numpy from a seed; every comparison is exact."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from helpers import SAMPLE_TEXT, conformance_corpus, trained_tokenizer_json

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from complexity_tokenizer_tpu.ops import merge as JM  # noqa: E402
from complexity_tokenizer_tpu.ops.hashtable import chd_lookup_rows_jnp  # noqa: E402
from complexity_tokenizer_tpu.ops.tables import build_device_tables as jax_build  # noqa: E402
from complexity_tokenizer_tpu.tokenizer import Tokenizer as JaxTokenizer  # noqa: E402
from complexity_tokenizer_tpu_torch import convert  # noqa: E402
from complexity_tokenizer_tpu_torch.native import NativeEncoder  # noqa: E402
from complexity_tokenizer_tpu_torch.ops import merge as M  # noqa: E402
from complexity_tokenizer_tpu_torch.ops.hashtable import (  # noqa: E402
    INF_RANK,
    build_chd_table,
    chd_lookup_rows,
)
from complexity_tokenizer_tpu_torch.ops.presplit import presplit  # noqa: E402
from complexity_tokenizer_tpu_torch.ops.seed import seed_tokens_plain  # noqa: E402
from complexity_tokenizer_tpu_torch.ops.tables import (  # noqa: E402
    build_device_tables,
    byte_token_table,
)
from complexity_tokenizer_tpu_torch.ops.wordpath import DeviceWordEncoder  # noqa: E402
from complexity_tokenizer_tpu_torch.tokenizer import Tokenizer  # noqa: E402
from complexity_tokenizer_tpu_torch.utils.corpus import (  # noqa: E402
    MULTI_PIECES,
    run_rows,
    zipf_corpus,
)
from complexity_tokenizer_tpu_torch.utils.unicode_tables import gpt2_class_table  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many ops on small tensors: with the test
    workers sharing the machine, torch's intra-op threads only wait on each
    other (one thread runs these tests many times faster under load)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

BENCH_100K = os.path.join(
    os.path.dirname(__file__), "..", ".cache", "bench_tokenizer_100k.json"
)
SHIFT = 70_000  # every id of the shifted fixture lies past u16


def _shifted_json() -> str:
    """The 800-vocab fixture with every id moved up by ``SHIFT``."""
    j = json.loads(trained_tokenizer_json())
    j["model"]["vocab"] = {t: i + SHIFT for t, i in j["model"]["vocab"].items()}
    for t in j["added_tokens"]:
        t["id"] += SHIFT
    return json.dumps(j, ensure_ascii=False)


def _json(name: str) -> str:
    if name == "fixture800":
        return trained_tokenizer_json()
    if name == "shifted":
        return _shifted_json()
    with open(BENCH_100K, encoding="utf-8") as f:
        return f.read()


@pytest.fixture(scope="module", params=["fixture800", "shifted", "bench100k"])
def both(request):
    """(port tokenizer, port tables, JAX tokenizer, JAX tables), built once.
    The port's ``build_device_tables`` builds a CHD table only where the
    cuckoo table does not fit; the fixture's is built here with
    ``build_chd_table``."""
    js = _json(request.param)
    pt = Tokenizer.from_str(js)
    jt = JaxTokenizer.from_str(js)
    tp = build_device_tables(pt.bpe)
    assert (tp.chd is None) == (tp.qc is not None)
    if tp.chd is None:
        tp = dataclasses.replace(tp, chd=build_chd_table(pt.bpe.merge_ranks, pt.bpe.merge_ops))
    return request.param, pt, tp, jt, jax_build(jt.bpe)


@pytest.fixture(scope="module")
def bench100k():
    """(port tokenizer, JAX tokenizer) of the 100K configuration.  The JAX
    one is loaded from the string: its ``from_file`` writes a warm-cache
    file beside the JSON."""
    return Tokenizer.from_file(BENCH_100K), JaxTokenizer.from_str(_json("bench100k"))


def test_100k_configuration_is_past_u16(bench100k):
    pt, _ = bench100k
    tb = pt.device_tables()
    assert len(pt.bpe.vocab) == 100_000
    assert len(pt.bpe.merge_ranks) == 99_942
    assert max(pt.bpe.merge_ranks.values()) >= 65_536
    assert tb.max_id == 99_999
    assert tb.qc is None and tb.chd is not None and tb.well_formed
    assert (tb.chd.size, tb.chd.n_buckets) == (262_144, 65_536)


def test_chd_table_matches_jax(both):
    name, _, tp, _, tj = both
    assert (tp.qc is None) == (tj.qc is None) == (name != "fixture800")
    assert tp.well_formed == tj.well_formed
    assert (tp.chd.size, tp.chd.n_buckets) == (tj.chd.size, tj.chd.n_buckets)
    np.testing.assert_array_equal(tp.chd.disp, tj.chd.disp)
    np.testing.assert_array_equal(tp.chd.rows, tj.chd.rows)


def _torch_chd(chd):
    return torch.from_numpy(chd.disp), torch.from_numpy(chd.rows)


def _jax_lookup(chd, a, b, valid):
    r, n = chd_lookup_rows_jnp(
        jnp.asarray(chd.disp), jnp.asarray(chd.rows), chd.size, chd.n_buckets,
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(valid),
    )
    return np.asarray(r), np.asarray(n)


def test_chd_lookup_rows_matches_jax(both):
    """Every key of the table, 500 random misses, and every key again under
    ``valid=False``: rank and minted id exactly as ``chd_lookup_rows_jnp``
    (the minted word included where the rank is INF_RANK)."""
    _, pt, tp, _, _ = both
    chd = tp.chd
    keys = np.array(list(pt.bpe.merge_ranks), np.int32).reshape(-1, 2)
    ranks = np.array(list(pt.bpe.merge_ranks.values()), np.int32)
    rng = np.random.RandomState(5)
    hi = max(int(keys.max()) + 2, 1 << 17)
    miss = rng.randint(0, hi, size=(2000, 2)).astype(np.int32)
    miss = np.array([m for m in miss if tuple(m) not in pt.bpe.merge_ranks][:500], np.int32)
    assert len(miss) == 500
    disp, rows = _torch_chd(chd)
    for a, b, valid in (
        (keys[:, 0], keys[:, 1], np.ones(len(keys), bool)),
        (miss[:, 0], miss[:, 1], np.ones(len(miss), bool)),
        (keys[:, 0], keys[:, 1], np.zeros(len(keys), bool)),
    ):
        got_r, got_n = chd_lookup_rows(
            disp, rows, chd.size, chd.n_buckets,
            torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(valid),
        )
        exp_r, exp_n = _jax_lookup(chd, a, b, valid)
        assert got_r.dtype == got_n.dtype == torch.int32
        np.testing.assert_array_equal(got_r.numpy(), exp_r)
        np.testing.assert_array_equal(got_n.numpy(), exp_n)
    got_r, got_n = chd_lookup_rows(
        disp, rows, chd.size, chd.n_buckets, torch.from_numpy(keys[:, 0]),
        torch.from_numpy(keys[:, 1]), torch.ones(len(keys), dtype=torch.bool),
    )
    np.testing.assert_array_equal(got_r.numpy(), ranks)
    minted = np.array([pt.bpe.merge_ops[int(r)][1] for r in ranks], np.int32)
    np.testing.assert_array_equal(got_n.numpy(), minted)
    miss_r, _ = chd_lookup_rows(
        disp, rows, chd.size, chd.n_buckets, torch.from_numpy(miss[:, 0]),
        torch.from_numpy(miss[:, 1]), torch.ones(len(miss), dtype=torch.bool),
    )
    assert (miss_r == INF_RANK).all()


def _seeded_rows(texts, L, byte_table):
    """Pack, pre-split and seed byte strings: the fixpoint's real inputs."""
    B = len(texts)
    arr = np.zeros((B, L), np.uint8)
    lens = np.zeros(B, np.int32)
    for i, d in enumerate(texts):
        d = d[:L]
        arr[i, : len(d)] = np.frombuffer(d, np.uint8)
        lens[i] = len(d)
    arr_t, lens_t = torch.from_numpy(arr), torch.from_numpy(lens)
    _, wid, _ = presplit(arr_t, lens_t, torch.from_numpy(gpt2_class_table()))
    tokens = seed_tokens_plain(arr_t, lens_t, torch.from_numpy(byte_table))
    return tokens, wid


def _compare_fixpoint(tokens, wid, chd):
    disp, rows = _torch_chd(chd)
    got_t, got_c = M.merge_fixpoint_chd_plain(tokens, wid, disp, rows, chd.size, chd.n_buckets)
    exp_t, exp_c = JM.merge_words(
        jnp.asarray(tokens.numpy()), jnp.asarray(wid.numpy()),
        jnp.asarray(chd.disp), jnp.asarray(chd.rows), chd.size, chd.n_buckets,
    )
    assert got_t.dtype == got_c.dtype == torch.int32
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(exp_t))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(exp_c))
    # the wrapper on CPU tensors is the plain version
    w_t, w_c = M.merge_words(tokens, wid, disp, rows, chd.size, chd.n_buckets)
    assert torch.equal(w_t, got_t) and torch.equal(w_c, got_c)
    return got_t


@pytest.mark.parametrize("L", [128, 512])
def test_chd_fixpoint_matches_jax_on_text(both, L):
    """Text rows, and rows of long runs and ``abab...`` (the rows on which
    the greedy apply and the JAX rule differ most), seeded with the table's
    own bytes."""
    _, pt, tp, _, _ = both
    rng = np.random.RandomState(L)
    texts = [t.encode("utf-8") for t in conformance_corpus() + [SAMPLE_TEXT.replace("\n", " ")]]
    texts += [t.encode("utf-8") for t in zipf_corpus(8, seed=L, lo=L // 2, hi=L)]
    texts += run_rows(" ".join(zipf_corpus(40, seed=L)).encode("utf-8"), 8, L, False)
    rng.shuffle(texts)
    tokens, wid = _seeded_rows(texts[:24], L, tp.byte_token_table)
    out = _compare_fixpoint(tokens, wid, tp.chd)
    assert int((out >= 0).sum()) < int((tokens >= 0).sum())  # merges happened


def test_chd_fixpoint_ids_past_u16(both):
    """Corpus rows: the shifted and the 100K tables mint ids past 65,535,
    the fixture's stay below."""
    name, pt, tp, _, _ = both
    texts = [t.encode("utf-8") for t in zipf_corpus(16, seed=3, lo=100, hi=128)]
    tokens, wid = _seeded_rows(texts, 128, tp.byte_token_table)
    out = _compare_fixpoint(tokens, wid, tp.chd)
    assert (int(out.max()) >= 65_536) == (name != "fixture800")


def test_merge_fixpoint_routes_by_table(both, monkeypatch):
    """``TorchTables.merge_fixpoint`` takes K2 when the cuckoo table is
    eligible and K5 otherwise; both give the JAX ``merge_words`` ids."""
    name, _, tp, _, _ = both
    calls = []
    for fn in ("merge_words", "merge_words_qc"):
        real = getattr(convert, fn)
        monkeypatch.setattr(
            convert, fn, lambda *a, _fn=fn, _real=real: calls.append(_fn) or _real(*a)
        )
    qc = {} if tp.qc is None else dict(qc_t1=tp.qc.t1, qc_t2=tp.qc.t2, qc_size=tp.qc.size)
    tt = convert.tables_to_device(
        byte_token_table=tp.byte_token_table, class_table=gpt2_class_table(), device="cpu",
        chd_disp=tp.chd.disp, chd_rows=tp.chd.rows, **qc,
    )
    assert (tt.chd_size, tt.chd_n_buckets) == (tp.chd.size, tp.chd.n_buckets)
    texts = [t.encode("utf-8") for t in zipf_corpus(8, seed=2, lo=60, hi=128)]
    tokens, wid = _seeded_rows(texts, 128, tp.byte_token_table)
    got_t, _ = tt.merge_fixpoint(tokens, wid)
    assert calls == (["merge_words_qc"] if name == "fixture800" else ["merge_words"])
    np.testing.assert_array_equal(got_t.numpy(), _compare_fixpoint(tokens, wid, tp.chd).numpy())


def test_convert_takes_chd_arrays_alone(bench100k):
    """The JAX package's CHD-only tables (no cuckoo table past u16) carried
    onto the CPU bit for bit; a table with neither raises."""
    _, jt = bench100k
    tj = jax_build(jt.bpe)
    tt = convert.tables_to_device(
        byte_token_table=tj.byte_token_table, class_table=gpt2_class_table(), device="cpu",
        chd_disp=tj.chd.disp, chd_rows=tj.chd.rows,
    )
    assert tt.qc_t1 is None and tt.chd_rows.dtype == torch.int32
    np.testing.assert_array_equal(tt.chd_disp.numpy(), tj.chd.disp)
    np.testing.assert_array_equal(tt.chd_rows.numpy(), tj.chd.rows)
    with pytest.raises(ValueError, match="power of two"):
        convert.tables_to_device(
            byte_token_table=tj.byte_token_table, class_table=gpt2_class_table(),
            device="cpu", chd_disp=tj.chd.disp[:-1], chd_rows=tj.chd.rows,
        )
    with pytest.raises(ValueError, match="cuckoo or the CHD"):
        convert.tables_to_device(
            byte_token_table=tj.byte_token_table, class_table=gpt2_class_table(), device="cpu"
        )


def _corpus_100k():
    return zipf_corpus(300, seed=21) + list(MULTI_PIECES) + [
        "a" * 300, "x </s> y", "", " ", "z" * 5000,
    ]


@pytest.mark.parametrize("route", ["auto", "device", "native", "text pipeline"])
def test_100k_end_to_end_matches_jax_device_and_oracle(bench100k, route):
    """At 100K: the port's ``encode_batch`` with ``backend="auto"`` (drained
    and run again), ``"device"`` and ``"native"``, and the text pipeline,
    each equal the JAX ``encode_batch(backend="device")`` and the host
    oracle."""
    _, jt = bench100k
    pt = Tokenizer.from_file(BENCH_100K)  # fresh caches for each route
    texts = _corpus_100k()
    host = jt.encode_batch(texts, backend="host")
    assert jt.encode_batch(texts, backend="device") == host
    assert max(i for h in host for i in h) >= 65_536
    if route == "text pipeline":
        data = pt._prepare_bytes([pt._normalize(t) for t in texts])
        flags = pt._added_route_flags(data)
        fast = [i for i in range(len(texts)) if not flags[i]]
        got = pt.pipeline("cpu").encode_bytes([data[i] for i in fast])
        assert got == [host[i] for i in fast]
        return
    dev = "cpu" if route in ("auto", "device") else None
    assert pt.encode_batch(texts, backend=route, device=dev) == host
    if route == "auto":
        wp = pt._auto_word_path("cpu")
        wp.drain_async(timeout=300)
        assert wp.words_filled > 0
        assert pt.encode_batch(texts, backend="auto", device="cpu") == host
    if route == "device":
        assert pt._get_word_path("cpu").words_filled > 0
    flat, offs = pt.encode_batch_ragged(texts, backend=route, device=dev)
    assert [flat[offs[i] : offs[i + 1]].tolist() for i in range(len(texts))] == host


def test_100k_word_path_per_word_matches_host_merge(bench100k):
    """Every distinct word of the corpus through the word path on a fresh
    native context (int32 ids in the fused buffer): each word covered, its
    ids those of the host merge (the native runtime's and the oracle's)."""
    pt, jt = bench100k

    def fresh():
        return NativeEncoder(pt.bpe.packed_merge_arrays(), byte_token_table(pt.bpe.vocab))

    data = pt._prepare_bytes([pt._normalize(t) for t in _corpus_100k()])
    wp = DeviceWordEncoder(pt.pipeline("cpu"), fresh())
    assert wp._out_dtype == np.int32
    words, lens = wp.native.collect_miss_words(data, 128)
    assert len(lens) > 1000
    ids, counts = wp._encode_words_packed(words, lens)
    assert (counts >= 0).all()
    exp_ids, exp_counts = fresh().warm_start(words, lens)
    np.testing.assert_array_equal(counts, exp_counts)
    np.testing.assert_array_equal(ids, exp_ids)
    assert int(ids.max()) >= 65_536
    # the oracle on a sample of the words
    from complexity_tokenizer_tpu_torch.utils.bytelevel import bytes_to_unicode

    enc = bytes_to_unicode()
    offs = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    bounds = np.zeros(len(counts) + 1, np.int64)
    np.cumsum(counts, out=bounds[1:])
    for w in np.random.RandomState(4).choice(len(lens), 300, replace=False):
        word = bytes(words[offs[w] : offs[w + 1]])
        exp = jt.bpe.encode("".join(enc[b] for b in word))
        assert ids[bounds[w] : bounds[w + 1]].tolist() == exp, word

"""Decode in the port against the JAX package, strings and bytes exactly:
K7's plain version against ``DecodePipeline._decode_fn``, K7's table of
16-byte entries against the arena it is built from, the device pipeline on
the CPU, the native decoder, every decode entry point on every route and
option, the decode tables carried across (``convert.py``), and twins of
``tests/test_device_decode.py``."""

import json
import os

import numpy as np
import pytest
import torch

from helpers import SAMPLE_TEXT, conformance_corpus, trained_tokenizer_json

jax = pytest.importorskip("jax")

from complexity_tokenizer_tpu.ops.decode import (  # noqa: E402
    DecodePipeline as JaxDecodePipeline,
    build_decode_tables as jax_build_decode_tables,
)
from complexity_tokenizer_tpu.tokenizer import Tokenizer as JaxTokenizer  # noqa: E402
from complexity_tokenizer_tpu_torch.convert import decode_tables_from_padded  # noqa: E402
from complexity_tokenizer_tpu_torch.ops.decode import (  # noqa: E402
    DecodePipeline,
    DecodeTables,
    build_decode_tables,
    decode_entries,
    decode_gather,
    decode_gather_plain,
    special_mask,
    split_rows,
)
from complexity_tokenizer_tpu_torch.tokenizer import Tokenizer  # noqa: E402
from complexity_tokenizer_tpu_torch.utils.bytelevel import bytes_to_unicode  # noqa: E402
from complexity_tokenizer_tpu_torch.utils.corpus import (  # noqa: E402
    LONG_TOKEN_LENGTHS,
    long_token_vocab,
)

TEXTS = [t for t in conformance_corpus() if t] + [SAMPLE_TEXT, "a </s> b <s>", "<pad><unk>"]


@pytest.fixture(scope="module")
def pair():
    js = trained_tokenizer_json()
    return Tokenizer.from_str(js), JaxTokenizer.from_str(js)


def _ids_rows(jt, texts=TEXTS):
    return [jt._encode_host(t) for t in texts]


def _edge_batch(V: int, special_ids, seed: int = 11):
    """Rows of random ids with pads (-1), negatives, ids >= V and specials,
    empty rows, one-id rows and a 4,096-id row."""
    rng = np.random.RandomState(seed)
    rows = [[], [int(rng.randint(V))], [-1], [V], [special_ids[0]], []]
    for n in (3, 17, 64, 250, 4096):
        r = rng.randint(0, V, size=n)
        kinds = rng.randint(0, 10, size=n)
        r = np.where(kinds == 0, -1, r)
        r = np.where(kinds == 1, -rng.randint(2, 50, size=n), r)
        r = np.where(kinds == 2, V + rng.randint(0, 1000, size=n), r)
        r = np.where(kinds == 3, rng.choice(special_ids, size=n), r)
        rows.append(r.tolist())
    return rows


def _padded(rows):
    T = max((len(r) for r in rows), default=1) or 1
    ids = np.full((len(rows), T), -1, np.int32)
    for i, r in enumerate(rows):
        ids[i, : len(r)] = r
    return ids


def _port_gather(tables, flat, offsets, skip):
    out = decode_gather_plain(
        torch.from_numpy(np.asarray(flat, np.int32)), torch.from_numpy(np.asarray(offsets, np.int64)),
        torch.from_numpy(decode_entries(tables)), torch.from_numpy(tables.arena), skip,
    )
    return split_rows(out.numpy(), len(offsets) - 1)


@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("layout", ["padded rows", "ragged rows"])
def test_k7_plain_equals_jax_decode_fn(pair, skip, layout):
    """The live prefix and the total of every row of JAX's ``_decode_fn``
    equal K7's plain version's row bytes: on the padded matrix itself (pads
    are ids like any other) and on the ragged rows."""
    _pt, jt = pair
    special_ids = sorted(jt.special_tokens.values())
    jp = JaxDecodePipeline(jt.bpe.vocab_r, set(special_ids))
    rows = _edge_batch(jp.vocab_size, special_ids)
    ids = _padded(rows)
    packed, total = (np.asarray(a) for a in jp._decode_fn(ids, skip))
    tables = build_decode_tables(jt.bpe.vocab_r, special_ids)
    if layout == "padded rows":
        flat, offsets = ids.ravel(), np.arange(len(rows) + 1, dtype=np.int64) * ids.shape[1]
    else:
        offsets = np.zeros(len(rows) + 1, np.int64)
        np.cumsum([len(r) for r in rows], out=offsets[1:])
        flat = np.concatenate([np.asarray(r, np.int32) for r in rows])
    got = _port_gather(tables, flat, offsets, skip)
    assert [len(g) for g in got] == total.tolist()
    assert got == [packed[i, : total[i]].tobytes() for i in range(len(rows))]
    assert sum(total) > 0 and any(t == 0 for t in total)


@pytest.mark.parametrize("skip", [False, True])
def test_decode_pipeline_cpu_equals_jax_pipeline(pair, skip):
    pt, jt = pair
    rows = _ids_rows(jt) + [[0, 1, 2, 3]] * 3 + [[]]
    assert pt.decode_pipeline("cpu").decode_batch(rows, skip) == \
        jt._get_decode_pipeline().decode_batch(rows, skip)
    flat = np.concatenate([np.asarray(r, np.int32) for r in rows])
    offs = np.zeros(len(rows) + 1, np.int64)
    np.cumsum([len(r) for r in rows], out=offs[1:])
    assert pt.decode_pipeline("cpu").decode_ragged(flat, offs, skip) == \
        jt._get_decode_pipeline().decode_batch(rows, skip)


def _route_pair(route: str):
    """(port, JAX) tokenizers whose decode takes ``route``: "native" (the
    trained ByteLevel tokenizer), "device" (one id past 2,000,000 makes the
    native decoder ineligible), "host" (a Sequence decoder)."""
    j = json.loads(trained_tokenizer_json())
    if route == "device":
        j["model"]["vocab"]["Ġzzzzq"] = 2_000_001
    elif route == "host":
        j["decoder"] = {"type": "Sequence", "decoders": [
            {"type": "Replace", "pattern": {"String": "Ġ"}, "content": " "},
            {"type": "Fuse"}, {"type": "Strip", "content": " ", "start": 1, "stop": 0}]}
    js = json.dumps(j)
    return Tokenizer.from_str(js), JaxTokenizer.from_str(js)


@pytest.fixture(scope="module")
def routes():
    return {r: _route_pair(r) for r in ("native", "device", "host")}


@pytest.mark.parametrize("cleanup", [False, True])
@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("route", ["native", "device", "host"])
def test_decode_entry_points_equal_jax(routes, route, skip, cleanup):
    pt, jt = routes[route]
    assert (pt._get_native_decoder() is None) == (route != "native")
    rows = _ids_rows(jt) + [[0, 5, -1, 10**6, 3], []]
    flat = np.concatenate([np.asarray(r, np.int32) for r in rows])
    offs = np.zeros(len(rows) + 1, np.int64)
    np.cumsum([len(r) for r in rows], out=offs[1:])
    exp = jt.decode_batch_with_options(rows, skip, cleanup)
    assert pt.decode_batch_with_options(rows, skip, cleanup, device="cpu") == exp
    assert pt.batch_decode(rows, skip, cleanup, device="cpu") == jt.batch_decode(rows, skip, cleanup)
    assert pt.decode_batch_ragged(flat, offs, skip, cleanup, device="cpu") == \
        jt.decode_batch_ragged(flat, offs, skip, cleanup)
    assert [pt.decode_with_options(r, skip, cleanup) for r in rows] == \
        [jt.decode_with_options(r, skip, cleanup) for r in rows]
    assert pt.decode_batch(rows, device="cpu") == jt.decode_batch(rows)
    assert [pt.decode(r) for r in rows] == [jt.decode(r) for r in rows]
    # fewer than 8 rows never take the device route, in either package
    assert pt.decode_batch_with_options(rows[:5], skip, cleanup, device="cpu") == exp[:5]


def test_device_route_runs_the_pipeline(routes, monkeypatch):
    """The device route goes through the decode pipeline (K7's plain version
    on the CPU), only for batches of 8 rows or more."""
    pt, _jt = routes["device"]
    calls = []
    pipe = pt.decode_pipeline("cpu")
    orig = pipe.decode_batch
    monkeypatch.setattr(pipe, "decode_batch", lambda *a: calls.append(1) or orig(*a))
    pt.decode_batch([[1, 2]] * 8, device="cpu")
    pt.decode_batch([[1, 2]] * 7, device="cpu")
    assert calls == [1]


def test_decode_pipeline_refuses_other_decoders(routes):
    pt, _jt = routes["host"]
    with pytest.raises(NotImplementedError, match="ByteLevel"):
        pt.decode_pipeline("cpu")


def _invalid_utf8_rows(pt):
    """Rows whose bytes are not valid UTF-8: a lone lead byte, a lone
    continuation byte, and a truncated sequence, among valid ids."""
    enc = bytes_to_unicode()
    v = pt.bpe.vocab
    lone = [v[enc[b]] for b in (0xC3, 0x80, 0xE6) if enc[b] in v]
    assert len(lone) == 3
    hello = pt.encode("hello world")
    return [hello + [lone[0]], [lone[1]] + hello, hello, [lone[2], lone[1]], [], hello * 3]


@pytest.mark.parametrize("skip", [False, True])
def test_native_decoder_flags_invalid_utf8_like_jax(pair, skip):
    pt, jt = pair
    rows = _invalid_utf8_rows(pt) + _ids_rows(jt)
    texts, flagged = pt._get_native_decoder().decode_batch(rows, skip, True)
    jtexts, jflagged = jt._get_native_decoder().decode_batch(rows, skip, True)
    assert (texts, flagged) == (jtexts, jflagged)
    assert flagged == [0, 1, 3]
    assert pt.decode_batch_with_options(rows, skip, True) == jt.decode_batch_with_options(rows, skip, True)
    assert "�" in pt.decode_batch(rows)[0]


def test_native_decoder_bytes_route_without_extension(pair, monkeypatch):
    """Without the extension the native decoder takes ``ctok_decode_batch``
    and gives the same strings and flags."""
    from complexity_tokenizer_tpu_torch import native

    pt, jt = pair
    rows = _invalid_utf8_rows(pt) + _ids_rows(jt)
    nd = pt._get_native_decoder()
    with_ext = nd.decode_batch(rows, False, True)
    monkeypatch.setattr(native, "load_ext", lambda: None)
    assert nd.decode_batch(rows, False, True) == with_ext


def test_decode_tables_carried_across(pair):
    """The JAX package's padded tables, carried across by ``convert.py``,
    equal the port's own build and decode the same bytes."""
    pt, jt = pair
    special_ids = set(jt.special_tokens.values())
    mat, lens, special = jax_build_decode_tables(jt.bpe.vocab_r, special_ids)
    carried = decode_tables_from_padded(mat, lens, special)
    own = build_decode_tables(pt.id_to_token_map, special_ids)
    for a, b in ((carried.arena, own.arena), (carried.offsets, own.offsets), (carried.special, own.special)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    rows = _ids_rows(jt)
    assert DecodePipeline(carried, "cpu").decode_batch(rows, True) == \
        pt.decode_pipeline("cpu").decode_batch(rows, True)


def test_decode_gather_without_ids_launches_nothing():
    tables = build_decode_tables({0: "a"})
    empty = torch.zeros(0, dtype=torch.int32)
    out = decode_gather(empty, torch.zeros(4, dtype=torch.int64),
                        torch.from_numpy(decode_entries(tables)), torch.from_numpy(tables.arena),
                        False, 0)
    assert out.numpy().view(np.int64).tolist() == [0, 0, 0, 0]


# K7's table: one 16-byte entry per id

BENCH = {
    "50k": os.path.join(os.path.dirname(__file__), "..", ".cache", "bench_tokenizer_r4_50k.json"),
    "100k": os.path.join(os.path.dirname(__file__), "..", ".cache", "bench_tokenizer_100k.json"),
}


def _tables(name: str) -> DecodeTables:
    """The decode tables of a vocabulary: the benchmark tokenizers' (as
    ``Tokenizer.decode_pipeline`` builds them), the long-token vocabulary,
    or the empty one (V = 1, no bytes)."""
    if name in BENCH:
        tok = Tokenizer.from_file(BENCH[name])
        arena, offsets = tok._decode_arena()
        return DecodeTables(arena, offsets, special_mask(len(offsets) - 1, tok.special_tokens.values()))
    if name == "long tokens":
        return build_decode_tables(*long_token_vocab(seed=5))
    return build_decode_tables({})


@pytest.mark.parametrize("name", ["50k", "100k", "long tokens", "empty"])
def test_decode_entries_hold_every_token(name):
    """Each id's entry gives its length, its special flag and its bytes
    (inline up to 12 bytes, else from the arena at the start it holds),
    equal to ``arena[offsets[i]:offsets[i + 1]]``."""
    t = _tables(name)
    ent = decode_entries(t)
    assert ent.dtype == np.int32 and ent.shape == (t.V, 4) and ent.flags.c_contiguous
    raw = ent.view(np.uint8).reshape(t.V, 16)
    word0 = ent[:, 0].view(np.uint32)
    lens = np.diff(t.offsets)
    np.testing.assert_array_equal(word0 & 0x7FFFFFFF, lens)
    np.testing.assert_array_equal(word0 >> 31, t.special)
    for i in range(t.V):
        want = t.arena[t.offsets[i] : t.offsets[i + 1]].tobytes()
        if lens[i] <= 12:
            got = raw[i, 4 : 4 + lens[i]].tobytes()
            assert not raw[i, 4 + lens[i] :].any()
        else:
            start = int(ent[i, 1:3].view(np.int64)[0])
            got = t.arena[start : start + lens[i]].tobytes()
            assert ent[i, 3] == 0
        assert got == want, i
    if name == "long tokens":
        assert set(LONG_TOKEN_LENGTHS) <= set(lens.tolist()) and lens.max() > 16384
        assert (lens == 0).sum() > LONG_TOKEN_LENGTHS.count(0) * t.V // 16  # missing ids too
    if name == "empty":
        assert t.V == 1 and not ent.any()


def test_decode_entries_refuse_a_token_past_the_limit():
    with pytest.raises(ValueError, match="token"):
        decode_entries(build_decode_tables({0: "a" * (1 << 20)}))


@pytest.mark.parametrize("skip", [False, True])
def test_k7_plain_equals_jax_decode_fn_on_long_tokens(skip):
    """The plain K7 on the long-token vocabulary (tokens of 0 to 300 bytes,
    one past the kernel's 16 KB staging window, ids missing from the
    vocabulary) equals JAX's ``_decode_fn`` row by row."""
    vocab_r, special_ids = long_token_vocab(V=200, seed=6, window_token=17_000)
    jp = JaxDecodePipeline(vocab_r, set(special_ids))
    rng = np.random.RandomState(7 + skip)
    rows = [rng.randint(-2, 203, size=n).tolist() for n in (0, 1, 9, 40, 3)] + [[9, 9, 3, 21, 200]]
    ids = _padded(rows)
    packed, total = (np.asarray(a) for a in jp._decode_fn(ids, skip))
    offsets = np.zeros(len(rows) + 1, np.int64)
    np.cumsum([len(r) for r in rows], out=offsets[1:])
    flat = np.concatenate([np.asarray(r, np.int32) for r in rows])
    got = _port_gather(build_decode_tables(vocab_r, special_ids), flat, offsets, skip)
    assert got == [packed[i, : total[i]].tobytes() for i in range(len(rows))]
    assert max(total) > 17_000


# twins of tests/test_device_decode.py


def test_device_decode_roundtrip(pair):
    pt, jt = pair
    id_batches = _ids_rows(jt)
    host = [jt._decode_impl(ids, False, False) for ids in id_batches]
    assert pt.decode_pipeline("cpu").decode_batch(id_batches, skip_special=False) == host
    assert pt.decode_batch_with_options(id_batches, False, False, device="cpu") == host


def test_device_decode_skip_special(pair):
    pt, jt = pair
    bos, eos = jt.bos_token_id, jt.eos_token_id
    batch = [[bos] + pt.encode("hello world") + [eos]] * 8
    host = [jt._decode_impl(ids, True, False) for ids in batch]
    dev = pt.decode_pipeline("cpu").decode_batch(batch, skip_special=True)
    assert dev == host
    assert "<s>" not in dev[0]


def test_device_decode_empty_rows(pair):
    pt, _jt = pair
    assert pt.decode_pipeline("cpu").decode_batch([[], [], []]) == ["", "", ""]


def test_device_decode_invalid_ids(pair):
    pt, jt = pair
    big = jt.vocab_size + 1000
    host = jt._decode_impl([big, *pt.encode("hi")], False, False)
    assert pt.decode_pipeline("cpu").decode_batch([[big, *pt.encode("hi")]])[0] == host

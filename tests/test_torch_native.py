"""The port's copy of the native host runtime against the JAX package's and
the host oracle, ids exactly: twins of ``tests/test_native.py``, the
packed merge arrays carried across, the added-token scan, and the copy of
``ctok_host.cpp`` itself."""

import difflib
import os
import threading

import numpy as np
import pytest

from helpers import SAMPLE_TEXT, conformance_corpus, trained_tokenizer_json

jax = pytest.importorskip("jax")

from complexity_tokenizer_tpu import native as jax_native  # noqa: E402
from complexity_tokenizer_tpu.tokenizer import Tokenizer as JaxTokenizer  # noqa: E402
from complexity_tokenizer_tpu_torch import native  # noqa: E402
from complexity_tokenizer_tpu_torch.convert import native_from_arrays  # noqa: E402
from complexity_tokenizer_tpu_torch.ops.tables import byte_token_table  # noqa: E402
from complexity_tokenizer_tpu_torch.tokenizer import Tokenizer  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def toks():
    js = trained_tokenizer_json()
    return Tokenizer.from_str(js), JaxTokenizer.from_str(js)


def _normalized(jt, texts):
    return [jt.normalizer.normalize(t) for t in texts]


def test_cpp_copy_is_the_jax_file_with_whole_functions_deleted():
    """Every line of the port's ctok_host.cpp is a line of the JAX file, in
    order: the diff holds deletions only."""
    with open(os.path.join(REPO, "complexity_tokenizer_tpu", "native", "ctok_host.cpp")) as f:
        jax_lines = f.read().splitlines()
    with open(os.path.join(REPO, "complexity_tokenizer_tpu_torch", "native", "ctok_host.cpp")) as f:
        port_lines = f.read().splitlines()
    diff = list(difflib.unified_diff(jax_lines, port_lines, lineterm="", n=0))
    added = [ln for ln in diff[2:] if ln.startswith("+")]
    assert added == []
    assert len(port_lines) < len(jax_lines)
    # the frame and mask helpers of the __call__ surface, and the trainers'
    # word count, are restored whole
    for kept in ("frame_rows", "frame_matrix", "mask_rows", "mask_matrix", "split_words",
                 "count_words"):
        assert any(f"ctok_py_{kept}(PyObject" in ln for ln in port_lines), kept
    assert any(ln.startswith("void ctok_pack(") for ln in port_lines)


def test_packed_merge_arrays_equal_jax(toks):
    pt, jt = toks
    for a, b in zip(pt.bpe.packed_merge_arrays(), jt.bpe.packed_merge_arrays()):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)


def test_native_from_jax_arrays_encodes_like_jax_native(toks):
    """The JAX package's merge arrays and byte table, carried across as
    numpy, build a port native context whose ids equal the JAX native
    encoder's and the oracle's."""
    _pt, jt = toks
    pa, pb, pr, rank_new = jt.bpe.packed_merge_arrays()
    jne = jt._get_native_encoder()
    ne = native_from_arrays(
        pa=pa, pb=pb, pr=pr, rank_new=rank_new,
        byte_token_table=byte_token_table(jt.bpe.vocab),
    )
    data = [t.encode() for t in _normalized(jt, conformance_corpus() + [SAMPLE_TEXT])]
    assert ne.encode_batch(data) == jne.encode_batch(data)


def test_native_encode_matches_oracle(toks):
    pt, jt = toks
    ne = pt._get_native_encoder()
    for text in conformance_corpus() + [SAMPLE_TEXT]:
        normalized = jt.normalizer.normalize(text)
        expected = jt._encode_host(normalized, already_normalized=True)
        assert ne.encode(normalized.encode("utf-8")) == expected, repr(text)


def test_native_encode_batch_matches_host(toks):
    pt, jt = toks
    ne = pt._get_native_encoder()
    normalized = _normalized(jt, conformance_corpus())
    expected = [jt._encode_host(t, already_normalized=True) for t in normalized]
    data = [t.encode("utf-8") for t in normalized]
    assert ne.encode_batch(data) == expected
    assert ne.encode_batch(data) == expected  # the caches warm


@pytest.mark.parametrize("backend", ["native", "auto", "device", "host"])
def test_encode_batch_backends_agree(toks, backend):
    pt, jt = toks
    texts = conformance_corpus()[:12] + ["with <s> token inside"]
    host = [jt._encode_host(t) for t in texts]
    assert pt.encode_batch(texts, backend=backend, device="cpu") == host


@pytest.mark.parametrize("backend", ["auto", "native", "device", "host"])
def test_encode_batch_ragged(toks, backend):
    pt, jt = toks
    texts = conformance_corpus() + ["a </s> b", ""]
    flat, offsets = pt.encode_batch_ragged(texts, backend=backend, device="cpu")
    assert flat.dtype == np.int32 and offsets.dtype == np.int64
    assert offsets[0] == 0 and offsets[-1] == len(flat)
    rows = [jt._encode_host(t) for t in texts]
    for i, r in enumerate(rows):
        np.testing.assert_array_equal(flat[offsets[i] : offsets[i + 1]], r)


def test_fused_extension_matches_bytes_path(toks):
    """The fused extension entry (str in) agrees with the ctypes bytes path
    and the oracle, added-token flagging included."""
    pt, jt = toks
    assert native.load_ext() is not None  # Python.h is present here
    ne = pt._get_native_encoder()
    texts = conformance_corpus() + ["has <s> inside", "", "plain"]
    normalized = _normalized(jt, texts)
    pats = pt._added_patterns
    flat, offs, flagged, nonascii = ne.encode_ragged_fused(normalized, False, pats)
    assert nonascii is None
    raw, b_offs, counts = ne._encode_batch_raw([t.encode() for t in normalized], None, pats)
    flagged = set(flagged or [])
    assert flagged == {i for i, c in enumerate(counts) if c < 0}
    for i, t in enumerate(normalized):
        if i in flagged:
            assert offs[i] == offs[i + 1]
        else:
            exp = jt._encode_host(t, already_normalized=True)
            assert flat[offs[i] : offs[i + 1]].tolist() == exp, repr(texts[i])
            assert raw[b_offs[i] : b_offs[i] + counts[i]].tolist() == exp
    assert flagged, "the gate should flag <s>"


def test_both_extensions_load_side_by_side(toks):
    """The JAX package's ``_ctok_ext`` and the port's load in one process as
    two modules, each bound to its own library."""
    pt, jt = toks
    jax_ext, port_ext = jax_native.load_ext(), native.load_ext()
    assert jax_ext is not None and port_ext is not None and jax_ext is not port_ext
    assert jax_ext.__file__ != port_ext.__file__
    texts = ["hello world", "café au lait"]
    normalized = _normalized(jt, texts)
    jflat, joffs, _, _ = jt._get_native_encoder().encode_ragged_fused(normalized, False, None)
    flat, offs, _, _ = pt._get_native_encoder().encode_ragged_fused(normalized, False, None)
    np.testing.assert_array_equal(flat, jflat)
    np.testing.assert_array_equal(offs, joffs)


@pytest.mark.parametrize("backend", ["auto", "native"])
def test_bytes_route_without_extension(toks, monkeypatch, backend):
    """Without Python.h there is no extension: the native tier takes the
    bytes route and still equals the oracle."""
    pt, jt = toks
    monkeypatch.setattr(native, "load_ext", lambda: None)
    texts = conformance_corpus() + ["x </s> y", "café", ""]
    host = [jt._encode_host(t) for t in texts]
    assert pt.encode_batch(texts, backend=backend, device="cpu") == host
    flat, offs = pt.encode_batch_ragged(texts, backend=backend, device="cpu")
    assert [flat[offs[i] : offs[i + 1]].tolist() for i in range(len(texts))] == host


def test_match_any_equals_jax(toks):
    pt, _jt = toks
    rng = np.random.RandomState(4)
    pats = pt._added_patterns + [b"\xc3\xa9", b"ab"]
    pieces = [b"</s>", b"<s", b"s>", b"ab", b"a", b"\xc3\xa9", b" ", b"xyz", b"<pad>"]
    data = [b"".join(pieces[k] for k in rng.randint(0, len(pieces), size=rng.randint(0, 6)))
            for _ in range(300)]
    got = native.match_any(data, pats)
    np.testing.assert_array_equal(got, jax_native.match_any(data, pats))
    np.testing.assert_array_equal(got, [any(p in d for p in pats) for d in data])
    assert native.match_any([], pats).shape == (0,)


def test_added_route_flags_use_the_native_scan(toks):
    pt, _jt = toks
    data = pt._prepare_bytes(["a </s> b", "plain", "<unk>"])
    assert pt._added_route_flags(data).tolist() == [True, False, True]


def test_concurrent_encode_and_cache_insert_threads(toks):
    """Serving threads batch-encode while inserts land in the shared caches:
    every result stays exact."""
    pt, jt = toks
    ne = pt._get_native_encoder()
    normalized = _normalized(jt, conformance_corpus() * 4)
    data = pt._prepare_bytes(normalized)
    host = [jt._encode_host(t, already_normalized=True) for t in normalized]
    rng = np.random.RandomState(5)
    errors: list = []

    def encoder():
        try:
            for _ in range(30):
                assert ne.encode_batch(data) == host
        except Exception as e:  # pragma: no cover
            errors.append(e)

    def inserter():
        try:
            for _ in range(60):
                lens = rng.randint(1, 17, size=64).astype(np.int32)
                buf = (rng.randint(0, 26, size=int(lens.sum())) + 97).astype(np.uint8)
                rows, off = [], 0
                for ln in lens:
                    rows.append(ne.encode(buf[off : off + ln].tobytes()))
                    off += ln
                ne.cache_insert(buf, lens, rows)
        except Exception as e:  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=encoder) for _ in range(2)]
    threads.append(threading.Thread(target=inserter))
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert ne.encode_batch(data) == host


def test_warm_start_returns_the_host_merge(toks):
    pt, jt = toks
    words = [b"hello", b"world", b"\xc3\xa9t\xc3\xa9", b"a" * 40, b"x"]
    buf = np.frombuffer(b"".join(words), np.uint8)
    lens = np.array([len(w) for w in words], np.int64)
    ids, counts = pt._get_native_encoder().warm_start(buf, lens)
    jids, jcounts = jt._get_native_encoder().warm_start(buf, lens)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(counts, jcounts)
    assert pt.warm_start() > 0  # forced at any vocabulary size


def test_native_build_raises_without_compiler(monkeypatch, tmp_path):
    """No g++: the loader raises; there is no pure-Python fallback."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.load_library()

"""The device word path (``ops/wordpath.py``) on the CPU against the JAX
package: twins of the word-path tests of ``tests/test_device_encode.py``,
the routing of ``backend="device"`` / ``"auto"``, and the refusals the
word path keeps.  Ids exactly."""

import json

import numpy as np
import pytest

from helpers import SAMPLE_TEXT, conformance_corpus, trained_tokenizer_json

jax = pytest.importorskip("jax")

from complexity_tokenizer_tpu.tokenizer import Tokenizer as JaxTokenizer  # noqa: E402
from complexity_tokenizer_tpu_torch.tokenizer import Tokenizer  # noqa: E402
from complexity_tokenizer_tpu_torch.utils.bytelevel import bytes_to_unicode  # noqa: E402


@pytest.fixture(scope="module")
def jt():
    return JaxTokenizer.from_str(trained_tokenizer_json())


def _fresh():
    return Tokenizer.from_str(trained_tokenizer_json())


def test_word_path_matches_host(jt):
    """Collect misses -> device merge -> cache insert -> native assembly:
    ids equal the JAX oracle's; a second pass finds no miss."""
    pt = _fresh()
    wp = pt._get_word_path("cpu")
    texts = conformance_corpus()
    data = pt._prepare_bytes([pt._normalize(t) for t in texts])
    host = [jt._encode_host(t) for t in texts]
    assert wp.encode_batch(data) == host
    assert wp.words_filled > 0
    assert wp.fill_caches(data) == 0
    assert wp.encode_batch(data) == host
    assert pt.encode_batch(texts, backend="device", device="cpu") == host


@pytest.mark.parametrize("backend", ["device", "native", "auto"])
def test_backends_equal_jax_oracle_on_conformance_corpus(jt, backend):
    pt = _fresh()
    texts = conformance_corpus() + [SAMPLE_TEXT, "a </s> b", "</s>", "", " "]
    host = [jt._encode_host(t) for t in texts]
    assert pt.encode_batch(texts, backend=backend, device="cpu") == host
    flat, offs = pt.encode_batch_ragged(texts, backend=backend, device="cpu")
    assert [flat[offs[i] : offs[i + 1]].tolist() for i in range(len(texts))] == host
    assert pt.encode_batch(texts, backend=backend, device="cpu") == host  # warm


def test_word_path_adaptive_fill_stays_exact(jt):
    """Once warm the word path skips the miss scan; novel words arriving then
    are merged by the native runtime, and the next sweep fills them."""
    pt = _fresh()
    wp = pt._get_word_path("cpu")
    warm = ["hello world the fox", "quick brown dog"] * 8
    data = pt._prepare_bytes(warm)
    for _ in range(3):
        wp.encode_batch(data)
    assert wp._steady
    novel = ["zyx wvu tsr qpo", "never seen words appear 987"] * 4
    ndata = pt._prepare_bytes(novel)
    host = [jt._encode_host(t) for t in novel]
    assert wp.encode_batch(ndata) == host
    wp._batches_since_sweep = wp.sweep_interval
    filled = wp.words_filled
    assert wp.encode_batch(ndata) == host
    assert wp.words_filled > filled


def test_pack_seg_layout():
    """ctok_pack_seg lays words back to back (never spanning rows) with
    1/2/0 marks and their flat start positions."""
    wp = _fresh()._get_word_path("cpu")
    words = [b"alpha", b"bb", b"c" * 128, b"dd", b"e" * 127]
    buf = np.frombuffer(b"".join(words), np.uint8)
    lens = np.array([len(w) for w in words], np.int32)
    offs = np.zeros(len(words) + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    arr, marks, starts, n_fit, rows_used = wp._pack_seg(buf, offs, 0, len(words), 8)
    assert n_fit == len(words)
    flat_b, flat_m = arr.reshape(-1), marks.reshape(-1)
    pos = 0
    used = np.zeros(8 * 128, bool)
    for w, word in enumerate(words):
        s = int(starts[w])
        assert s >= pos
        assert s // 128 == (s + len(word) - 1) // 128
        assert flat_b[s : s + len(word)].tobytes() == word
        assert flat_m[s] == 1 and (flat_m[s + 1 : s + len(word)] == 2).all()
        used[s : s + len(word)] = True
        pos = s + len(word)
    assert (flat_m[~used] == 0).all()
    assert rows_used == (int(starts[-1]) + len(words[-1]) + 127) // 128


def _check_packed(wp, words, oracle):
    buf = np.frombuffer(b"".join(words), np.uint8)
    lens = np.array([len(w) for w in words], np.int32)
    ids, counts = wp._encode_words_packed(buf, lens)
    assert len(counts) == len(words) and (counts >= 0).all()
    bounds = np.zeros(len(counts) + 1, np.int64)
    np.cumsum(counts, out=bounds[1:])
    for w, word in enumerate(words):
        assert ids[bounds[w] : bounds[w + 1]].tolist() == oracle(word), word


def test_packed_device_merge_exact(jt):
    """Every packed word's ids equal the JAX native per-word merge, over
    several packs (the fill is split at 1,024 rows only past ~16K words,
    so this covers the length sort and its inverse)."""
    wp = _fresh()._get_word_path("cpu")
    rng = np.random.RandomState(3)
    words = [
        bytes(rng.choice(list(b"abcdefqxZW"), rng.randint(1, 20)).astype(np.uint8))
        for _ in range(500)
    ]
    _check_packed(wp, words, jt._get_native_encoder().encode)


def test_packed_device_merge_full_byte_range(jt):
    """Multi-byte UTF-8, high bytes and OOV bytes: what multilingual corpora
    send to the device, against the JAX merge loop on raw bytes."""
    wp = _fresh()._get_word_path("cpu")
    rng = np.random.RandomState(9)
    words = [s.encode() for s in ["日本語", "Ελληνικά", "straße", "héllo", "中文字", "é́"]]
    words += [bytes(rng.randint(1, 256, size=rng.randint(1, 24)).astype(np.uint8))
              for _ in range(200)]
    enc = bytes_to_unicode()
    _check_packed(wp, words, lambda w: jt.bpe.encode("".join(enc[b] for b in w)))


def test_spilled_pack_is_dispatched_again_with_full_capacity(jt):
    """Words that barely merge overflow the 3/8 capacity: the pack goes out
    once more with a slot for every lane, and every word stays covered."""
    pt = _fresh()
    wp = pt._get_word_path("cpu")
    rng = np.random.RandomState(12)
    in_vocab = np.flatnonzero(pt.device_tables().byte_token_table >= 0).astype(np.uint8)
    # 500 words of 14 bytes: 9 a row, 56 rows, one pack of 64 rows
    words = [bytes(rng.choice(in_vocab, 14)) for _ in range(500)]
    enc = bytes_to_unicode()
    _check_packed(wp, words, lambda w: jt.bpe.encode("".join(enc[b] for b in w)))
    assert wp.last_fill["packs"] == {64: 1}
    assert wp.last_fill["spills"] == 1


def test_async_auto_fill_exact(jt):
    """backend="auto": batches stay exact while a fill is in flight, the
    drained fill lands in the caches, and the steady state skips scans."""
    pt = _fresh()
    texts = conformance_corpus()
    host = [jt._encode_host(t) for t in texts]
    assert pt.encode_batch(texts, backend="auto", device="cpu") == host  # a fill may be in flight
    wp = pt._auto_word_path("cpu")
    assert wp is pt._get_word_path("cpu")  # one encoder for both backends
    wp.drain_async(timeout=120)
    assert wp.words_filled > 0
    assert pt.encode_batch(texts, backend="auto", device="cpu") == host
    flat, offs = pt.encode_batch_ragged(texts, backend="auto", device="cpu")
    assert [flat[offs[i] : offs[i + 1]].tolist() for i in range(len(texts))] == host
    data = pt._prepare_bytes([pt._normalize(t) for t in texts])
    _, lens = wp.native.collect_miss_words(data, 128)
    assert len(lens) == 0
    for _ in range(3):
        pt.encode_batch(texts, backend="auto", device="cpu")
        wp.drain_async(timeout=120)
    assert wp._steady
    novel = ["qqqzz wwxx yyvv 998877"]
    assert pt.encode_batch(novel, backend="auto", device="cpu") == [jt._encode_host(t) for t in novel]


def test_async_fill_error_is_raised_in_the_serving_thread(monkeypatch):
    """A background fill that fails is raised again at the next harvest:
    no counter, no quiet switch to the host."""
    pt = _fresh()
    wp = pt._get_word_path("cpu")

    def broken(words_buf, lens):
        raise ValueError("kernel launch failed")

    monkeypatch.setattr(wp, "_encode_words_packed", broken)
    texts = conformance_corpus()
    pt.encode_batch(texts, backend="auto", device="cpu")  # starts the fill
    with pytest.raises(RuntimeError, match="background device word fill failed"):
        wp.drain_async(timeout=120)
    pt.encode_batch(texts, backend="auto", device="cpu")  # starts another
    wp._pending.done.wait(120)
    with pytest.raises(RuntimeError, match="background device word fill failed"):
        pt.encode_batch(texts, backend="auto", device="cpu")  # harvested here


def test_word_path_refuses_tables_the_device_does_not_run(jt):
    """Not well-formed: "device" and "auto" raise before any encode.  Past
    u16 they run the CHD fixpoint and give the JAX package's ids.  "native"
    and "host" serve both tables exactly."""
    past_u16 = {"model": {"type": "BPE", "vocab": {"a": 0, "b": 1, "ab": 70000},
                          "merges": ["a b"]}}
    bad = {"model": {"type": "BPE",
                     "vocab": {"a": 0, "b": 1, "c": 2, "ab": 3, "abc": 4, "ca": 5},
                     "merges": ["ab c", "a b", "c a"]}}
    for j, match in ((past_u16, None), (bad, "well-formed")):
        js = json.dumps(j)
        pt, jt2 = Tokenizer.from_str(js), JaxTokenizer.from_str(js)
        texts = ["ab abc cab", "b a c"]
        exp = [jt2._encode_host(t) for t in texts]
        for backend in ("device", "auto"):
            if match is None:
                assert pt.encode_batch(texts, backend=backend, device="cpu") == exp
                flat, offs = pt.encode_batch_ragged(texts, backend=backend, device="cpu")
                assert [flat[offs[i] : offs[i + 1]].tolist() for i in range(len(texts))] == exp
                continue
            with pytest.raises(NotImplementedError, match=match):
                pt.encode_batch(texts, backend=backend, device="cpu")
            with pytest.raises(NotImplementedError, match=match):
                pt.encode_batch_ragged(texts, backend=backend, device="cpu")
        for backend in ("native", "host"):
            assert pt.encode_batch(texts, backend=backend) == exp


def test_concurrent_auto_batches_stay_exact(jt):
    """Several serving threads encode with backend="auto" while fills start,
    land and are harvested between them, with a short switch interval:
    every batch stays exact, and the last fill drains into the caches."""
    import sys
    import threading

    from complexity_tokenizer_tpu_torch.utils.corpus import zipf_corpus

    pt = _fresh()
    # Zipf words are mostly new to the small vocabulary: every chunk has
    # far more than min_async_fill misses, so fills start and land
    texts = zipf_corpus(240, seed=3) + [SAMPLE_TEXT, "x </s> y"]
    host = [jt._encode_host(t) for t in texts]
    chunks = [texts[i::3] for i in range(3)]
    errors: list = []

    def serve(k):
        try:
            for r in range(4):
                chunk = chunks[(k + r) % 3]
                assert pt.encode_batch(chunk, backend="auto", device="cpu") == [host[texts.index(t)] for t in chunk]
        except Exception as e:  # pragma: no cover
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=serve, args=(k,)) for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    wp = pt._auto_word_path("cpu")
    wp.drain_async(timeout=120)
    assert wp.words_filled > 0
    assert pt.encode_batch(texts, backend="auto", device="cpu") == host


def test_fill_thread_ending_at_exit_does_not_abort(tmp_path):
    """A background fill still running when the interpreter exits, whose
    tokenizer nothing else references: the exit hook joins the thread to its
    end, so freeing the native context never overlaps the teardown (waiting
    only for the result let the process abort in some of the runs)."""
    import os
    import subprocess
    import sys

    path = tmp_path / "tokenizer.json"
    path.write_text(trained_tokenizer_json())
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys\n"
        f"sys.path.insert(0, {repo!r})\n"
        "import jax.numpy as jnp\n"
        "jnp.zeros(4).block_until_ready()  # the JAX runtime's threads live too\n"
        "from complexity_tokenizer_tpu_torch.tokenizer import Tokenizer\n"
        "from complexity_tokenizer_tpu_torch.utils.corpus import zipf_corpus\n"
        "texts = zipf_corpus(240, seed=3)\n"
        "def serve():\n"
        f"    tok = Tokenizer.from_file({str(path)!r})\n"
        "    tok.encode_batch(texts, backend='auto', device='cpu')\n"
        "    tok._auto_word_path('cpu').drain_async(120)\n"
        "    tok.encode_batch(texts, backend='auto', device='cpu')  # starts one more scan\n"
        "serve()\n"
    )
    for _ in range(3):
        proc = subprocess.run(
            [sys.executable, "-c", code], capture_output=True, text=True, timeout=300
        )
        assert proc.returncode == 0, proc.stderr[-2000:]

"""The entry layer against the JAX package, ids exactly: the tokenizer.json
layouts of today's BPE files on every backend, the routing of layouts the
device does not run, the added-token flags (with the first-occurrence rule,
C8), mutating a tokenizer after a first encode, and the single-text
``encode``.

No Llama 3 or Qwen2 file is in the repository: their layouts are built
here around the trained tokenizer of ``tests/helpers.py``, with the
published split patterns."""

import json

import numpy as np
import pytest

from helpers import SAMPLE_TEXT, conformance_corpus, trained_tokenizer_json

jax = pytest.importorskip("jax")

from complexity_tokenizer_tpu.tokenizer import Tokenizer as JaxTokenizer  # noqa: E402
from complexity_tokenizer_tpu_torch.tokenizer import Tokenizer  # noqa: E402

LLAMA3_PATTERN = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*"
    r"|\s*[\r\n]+|\s+(?!\S)|\s+"
)
QWEN2_PATTERN = LLAMA3_PATTERN.replace(r"\p{N}{1,3}", r"\p{N}")

TEXTS = conformance_corpus() + [
    SAMPLE_TEXT, "a </s> b", "</s>", "It's 2024: DON'T stop!!\r\n\r\nNext   line",
    "ASCII ONLY UPPER lower MiXeD 12345678", "Ünïcödé ÀÉÎ", "hello world " * 30,
]


def _split_bytelevel(pattern: str) -> dict:
    return {"type": "Sequence", "pretokenizers": [
        {"type": "Split", "pattern": {"Regex": pattern}, "behavior": "Isolated", "invert": False},
        {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True, "use_regex": False},
    ]}


# layout name -> (tokenizer.json keys replaced, whether the device runs it)
LAYOUTS = {
    # Llama 3: "normalizer": null (NFC by the reference's default)
    "llama3": ({"normalizer": None, "pre_tokenizer": _split_bytelevel(LLAMA3_PATTERN)}, False),
    "qwen2": ({"normalizer": {"type": "NFC"}, "pre_tokenizer": _split_bytelevel(QWEN2_PATTERN)}, False),
    "lowercase": ({"normalizer": {"type": "Lowercase"}}, True),
    "sequence normalizer": ({"normalizer": {"type": "Sequence", "normalizers": [
        {"type": "NFD"}, {"type": "StripAccents"}, {"type": "Lowercase"},
        {"type": "Replace", "pattern": {"String": "  "}, "content": " "}]}}, True),
    "metaspace": ({"pre_tokenizer": {"type": "Metaspace", "replacement": "▁", "add_prefix_space": True},
                   "decoder": {"type": "Metaspace", "replacement": "▁", "add_prefix_space": True}}, False),
}


def _json(**replace) -> str:
    j = json.loads(trained_tokenizer_json())
    j.update(replace)
    return json.dumps(j)


@pytest.fixture(scope="module")
def jax_layouts():
    return {name: JaxTokenizer.from_str(_json(**keys)) for name, (keys, _dev) in LAYOUTS.items()}


@pytest.mark.parametrize("backend", ["auto", "device", "native", "host"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_layout_equals_jax(jax_layouts, layout, backend):
    keys, device_runs = LAYOUTS[layout]
    pt, jt = Tokenizer.from_str(_json(**keys)), jax_layouts[layout]
    expected = jt.encode_batch(TEXTS, backend=backend)
    assert expected == [jt._encode_host(t) for t in TEXTS]
    if backend == "device" and not device_runs:
        with pytest.raises(NotImplementedError, match="ByteLevel"):
            pt.encode_batch(TEXTS, backend=backend, device="cpu")
        with pytest.raises(NotImplementedError, match="ByteLevel"):
            pt.encode_batch_ragged(TEXTS, backend=backend, device="cpu")
        return
    assert pt.encode_batch(TEXTS, backend=backend, device="cpu") == expected
    flat, offs = pt.encode_batch_ragged(TEXTS, backend=backend, device="cpu")
    assert [flat[offs[i] : offs[i + 1]].tolist() for i in range(len(TEXTS))] == expected
    assert [pt.encode(t) for t in TEXTS] == [jt.encode(t) for t in TEXTS]


def test_byte_level_after_split_splits_again_as_in_jax(jax_layouts):
    """C10: the JAX parser ignores ``use_regex``, so ByteLevel runs the GPT-2
    split again on every piece of the Split ("!hello" is one Llama 3 piece
    and two GPT-2 words).  The port does the same; whether the reference
    does is open until a published file is in the repository."""
    pt = Tokenizer.from_str(_json(**LAYOUTS["llama3"][0]))
    jt = jax_layouts["llama3"]
    for text in ("!hello", " world's 12345", "a\n\n  b"):
        assert pt.pre_tokenizer.pre_tokenize(text) == jt.pre_tokenizer.pre_tokenize(text)
    assert pt.pre_tokenizer.pre_tokenize("!hello") == ["!", "hello"]


@pytest.mark.parametrize("layout", ["llama3", "metaspace"])
def test_host_layouts_build_nothing_for_the_device(layout):
    """"auto" and "native" send a layout the device does not run to the
    oracle, decided from the configuration: no device table, pipeline, word
    path or native context is built."""
    pt = Tokenizer.from_str(_json(**LAYOUTS[layout][0]))
    host = pt.encode_batch(TEXTS, backend="host")
    assert pt.encode_batch(TEXTS, backend="auto", device="cpu") == host
    assert pt.encode_batch(TEXTS, backend="native") == host
    assert pt.encode_batch_ragged(TEXTS, backend="auto", device="cpu")[0].tolist() == [i for r in host for i in r]
    assert pt._tables is None and pt._pipelines == {} and pt._word_paths == {}
    assert pt._native is None and pt._get_native_encoder() is None
    with pytest.raises(NotImplementedError, match="ByteLevel"):
        pt.pipeline("cpu")


def _flagged_pair(pre_tokenizer=None):
    keys = {} if pre_tokenizer is None else {"pre_tokenizer": pre_tokenizer}
    j = json.loads(_json(**keys))
    j["added_tokens"] += [
        {"id": 900, "content": "foo", "special": False, "lstrip": True},
        {"id": 901, "content": "bar", "special": False, "rstrip": True},
        {"id": 902, "content": "cafe", "special": False, "single_word": True},
        {"id": 903, "content": "qux", "special": True, "lstrip": True, "rstrip": True},
    ]
    js = json.dumps(j)
    return Tokenizer.from_str(js), JaxTokenizer.from_str(js)


FLAG_TEXTS = [
    "foo", " foo", "xfoo", "a foo b", "xfoo foo", "bar", "bar ", "barx", "bar barx", "barx bar",
    "cafe", "xcafe", "cafex", "a cafe b", "xcafe cafe", "qux", " qux ", "aqux qux", "qux!",
    "foo|bar|cafe|qux", "x foo|barbar |cafe cafe|aqux", "", "no tokens here",
] + TEXTS[:12]


@pytest.mark.parametrize("backend", ["host", "native", "auto", "device"])
def test_added_token_flags_equal_jax_byte_level(backend):
    pt, jt = _flagged_pair()
    assert [pt._encode_host(t) for t in FLAG_TEXTS] == [jt._encode_host(t) for t in FLAG_TEXTS]
    assert pt.encode_batch(FLAG_TEXTS, backend=backend, device="cpu") == \
        jt.encode_batch(FLAG_TEXTS, backend=backend)


def test_added_token_flags_equal_jax_inside_words():
    """A pre-tokenizer that keeps spaces inside its words, so that lstrip and
    rstrip meet whitespace neighbours."""
    pt, jt = _flagged_pair({"type": "CharDelimiterSplit", "delimiter": "|"})
    got = [pt._encode_host(t) for t in FLAG_TEXTS]
    assert got == [jt._encode_host(t) for t in FLAG_TEXTS]
    assert pt.encode_batch(FLAG_TEXTS, backend="auto", device="cpu") == got
    assert [pt.encode(t) for t in FLAG_TEXTS] == [jt.encode(t) for t in FLAG_TEXTS]
    assert 900 in pt.encode("a foo b") and 901 in pt.encode("a bar b") and 902 in pt.encode("a cafe b")


@pytest.mark.parametrize(
    "text,token_id",
    [("xfoo foo", 900), ("barx bar", 901), ("xcafe cafe", 902), ("aqux qux", 903)],
)
def test_added_token_flags_test_the_first_occurrence_only(text, token_id):
    """C8: the first occurrence fails its flag, a later one would pass, and
    the token is not matched in that word, as in the JAX package."""
    pt, jt = _flagged_pair({"type": "CharDelimiterSplit", "delimiter": "|"})
    ids = pt.encode_batch([text], backend="host")[0]
    assert ids == jt._encode_host(text)
    assert token_id not in ids
    later = text.split(" ")[1]
    assert token_id in pt.encode(later)


def test_from_buffer_equals_from_str():
    js = trained_tokenizer_json()
    a, b = Tokenizer.from_buffer(js.encode("utf-8")), Tokenizer.from_str(js)
    assert a.encode_batch(TEXTS, backend="native") == b.encode_batch(TEXTS, backend="native")
    assert a.decode_batch([a.encode(t) for t in TEXTS]) == b.decode_batch([b.encode(t) for t in TEXTS])


def _mutate(tok):
    tok.add_token("zqy", 950, False)
    tok.add_token_with_config("<ml>", 951, True, lstrip=True, rstrip=True)
    tok.add_token_with_config("word", 952, False, single_word=True)
    tok.add_tokens([("<sep>", 953, True), ("hello", 954, False)])


@pytest.mark.parametrize("backend", ["auto", "device", "native", "host"])
def test_add_tokens_after_a_first_encode(backend):
    """After a first encode (which builds the tables, the word path and the
    native context), adding tokens drops all of them; the next encode
    rebuilds them and gives JAX's ids."""
    js = trained_tokenizer_json()
    pt, jt = Tokenizer.from_str(js), JaxTokenizer.from_str(js)
    texts = TEXTS + ["zqy <ml> word hello", "a<ml>b", "wordy word", "say hello<sep>"]
    assert pt.encode_batch(texts, backend=backend, device="cpu") == jt.encode_batch(texts, backend=backend)
    before = (pt._tables, dict(pt._word_paths), pt._native, pt._added_patterns)
    if backend in ("auto", "device"):
        assert before[0] is not None and before[1]
    _mutate(pt)
    _mutate(jt)
    assert pt._tables is None and pt._word_paths == {} and pt._native is None
    assert pt.encode_batch(texts, backend=backend, device="cpu") == jt.encode_batch(texts, backend=backend)
    assert [pt.encode(t) for t in texts] == [jt.encode(t) for t in texts]
    if backend in ("auto", "device"):
        assert pt._tables is not None and pt._tables is not before[0]
        assert all(wp is not before[1].get(d) for d, wp in pt._word_paths.items())
    assert pt._added_patterns != before[3]
    assert pt.special_tokens == dict(jt.special_tokens)
    rows = [pt.encode(t) for t in texts]
    assert pt.decode_batch_with_options(rows, True, True) == jt.decode_batch_with_options(rows, True, True)


@pytest.mark.parametrize("vocab_size", [800, 400])
def test_single_text_encode_equals_jax(vocab_size):
    js = trained_tokenizer_json(vocab_size)
    pt, jt = Tokenizer.from_str(js), JaxTokenizer.from_str(js)
    assert [pt.encode(t) for t in TEXTS] == [jt.encode(t) for t in TEXTS]


def test_single_text_encode_takes_the_native_call(monkeypatch):
    """``encode`` runs one native call where no added token can match, and
    the oracle for the texts it flags."""
    pt = Tokenizer.from_str(trained_tokenizer_json())
    calls = []
    native = pt._get_native_encoder()
    orig = native.encode_one_fused
    monkeypatch.setattr(native, "encode_one_fused", lambda *a: calls.append(a[0]) or orig(*a))
    host = []
    monkeypatch.setattr(pt, "_encode_host", lambda t, already_normalized=False: host.append(t) or [])
    pt.encode("plain text")
    pt.encode("a </s> b")
    assert calls == ["plain text", "a </s> b"] and host == ["a </s> b"]


def test_single_text_encode_without_extension(monkeypatch):
    from complexity_tokenizer_tpu_torch import native

    js = trained_tokenizer_json()
    pt, jt = Tokenizer.from_str(js), JaxTokenizer.from_str(js)
    monkeypatch.setattr(native, "load_ext", lambda: None)
    assert [pt.encode(t) for t in TEXTS] == [jt.encode(t) for t in TEXTS]
    assert np.array_equal(pt.encode_batch_ragged(TEXTS, backend="native")[1],
                          jt.encode_batch_ragged(TEXTS)[1])

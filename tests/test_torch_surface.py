"""The rest of the port's entry layer against the JAX package's: the
tokenizer surface of ``tests/test_tokenizer.py`` (but
``test_train_new_from_iterator``) and ``tests/test_api_longtail.py``, the
hub paths, chat formats, counters and ``from_pretrained`` of
``tests/test_aux.py``, save and load in both directions, the warm-cache
file in both directions, the ``CTOK_*`` switches and BPE dropout.  Ids
exact; every file a test writes lies in ``tmp_path``."""

import hashlib
import json
import shutil
import threading

import numpy as np
import pytest

from helpers import conformance_corpus, trained_tokenizer_json

jax = pytest.importorskip("jax")

from complexity_tokenizer_tpu.core import postprocessors as JP  # noqa: E402
from complexity_tokenizer_tpu.core.pretokenizers import Whitespace as JaxWhitespace  # noqa: E402
from complexity_tokenizer_tpu.hf import chat as jax_chat  # noqa: E402
from complexity_tokenizer_tpu.hf import hub as jax_hub  # noqa: E402
from complexity_tokenizer_tpu.tokenizer import Tokenizer as JaxTokenizer  # noqa: E402
from complexity_tokenizer_tpu.utils import metrics as jax_metrics  # noqa: E402
from complexity_tokenizer_tpu_torch import components as C  # noqa: E402
from complexity_tokenizer_tpu_torch.core import postprocessors as PP  # noqa: E402
from complexity_tokenizer_tpu_torch.core.pretokenizers import Whitespace  # noqa: E402
from complexity_tokenizer_tpu_torch.hf import chat, hub  # noqa: E402
from complexity_tokenizer_tpu_torch.ops import wordpath  # noqa: E402
from complexity_tokenizer_tpu_torch.tokenizer import Tokenizer  # noqa: E402
from complexity_tokenizer_tpu_torch.utils import metrics  # noqa: E402

from test_torch_call import assert_same  # noqa: E402

MINIMAL_JSON = json.dumps({
    "version": "1.0",
    "model": {"type": "BPE", "vocab": {"h": 0, "e": 1, "l": 2, "o": 3, " ": 4, "w": 5, "r": 6, "d": 7},
              "merges": []},
    "added_tokens": [],
})


def pair():
    js = trained_tokenizer_json()
    return JaxTokenizer.from_str(js), Tokenizer.from_str(js)


# ---------------------------------------------------------------------------
# twins of tests/test_tokenizer.py and tests/test_api_longtail.py; each
# returns the port's results and the JAX package's, which must be equal


def _load_minimal(jt, pt, tmp_path):
    p = tmp_path / "tokenizer.json"
    p.write_text(MINIMAL_JSON)
    j = json.loads(MINIMAL_JSON)
    j["model"]["vocab"]["he"] = 8
    j["model"]["merges"] = [["h", "e"]]
    out = []
    for T in (Tokenizer, JaxTokenizer):
        a, b = T.from_str(MINIMAL_JSON), T.from_file(p)
        assert a.vocab_size == b.vocab_size == 8
        out.append((a.vocab_size, T.from_str(json.dumps(j)).bpe.merge_ranks, a.encode("hello world")))
    assert out[0][1] == {(0, 1): 0}
    return out


def _roundtrip_encode_decode(jt, pt, tmp_path):
    out = [], []
    for text in conformance_corpus():
        ids = pt.encode(text)
        decoded = pt.decode_with_options(ids, False, False)
        assert decoded == pt.normalizer.normalize(text), (text, ids, decoded)
        out[0].append((ids, decoded))
        out[1].append((jt.encode(text), jt.decode_with_options(jt.encode(text), False, False)))
    return out


def _special_token_inference(jt, pt, tmp_path):
    assert (pt.bos_token, pt.eos_token, pt.pad_token, pt.unk_token) == ("<s>", "</s>", "<pad>", "<unk>")
    assert pt.bos_token_id == pt.token_to_id("<s>")
    names = ("bos", "eos", "pad", "unk", "sep", "cls", "mask")

    def props(t):
        return ([getattr(t, f"{n}_token") for n in names] + [getattr(t, f"{n}_token_id") for n in names]
                + [t.all_special_tokens, t.all_special_ids, dict(t.special_tokens)])

    # inference by substring, over a file with every kind of special token
    j = json.loads(trained_tokenizer_json())
    extra = ["<|endoftext|>", "[UNK]", "<bos>", "[PAD]", "[SEP]", "[CLS]", "[MASK]", "<eos_x>"]
    j["added_tokens"] += [{"id": 900 + i, "content": c, "special": True} for i, c in enumerate(extra)]
    j["model"]["vocab"].update({c: 900 + i for i, c in enumerate(extra)})
    js = json.dumps(j)
    return [props(pt), props(Tokenizer.from_str(js))], [props(jt), props(JaxTokenizer.from_str(js))]


def _added_token_matching(jt, pt, tmp_path):
    out = []
    for t, W in ((pt, Whitespace), (jt, JaxWhitespace)):
        eos = t.token_to_id("</s>")
        a = t.encode("hello</s>world")
        assert eos not in a
        t.pre_tokenizer = W()
        t._invalidate_pipeline()
        b = t.encode("abc</s>def")
        assert eos in b and b[: b.index(eos)] and b[b.index(eos) + 1:]
        t.add_token_with_config("cafe", 9999, special=False, single_word=True)
        c, d = t.encode("xcafex"), t.encode("cafe")
        assert 9999 not in c and 9999 in d
        out.append((a, b, c, d))
    return out


def _tokenize_and_convert(jt, pt, tmp_path):
    out = []
    for t in (pt, jt):
        tokens = t.tokenize("hello world")
        ids = t.convert_tokens_to_ids(tokens)
        assert tokens and all(i is not None for i in ids)
        assert t.convert_ids_to_tokens(ids) == tokens
        assert t.convert_tokens_to_string(tokens) == "hello world"
        sp = sorted(t.special_tokens.values())
        out.append((tokens, ids, t.convert_ids_to_tokens(ids + sp, skip_special_tokens=True),
                    t.convert_token_to_id("<s>"), t.get_vocab() == dict(t.bpe.vocab), t.is_fast))
    return out


def _save_load_stability(jt, pt, tmp_path):
    p = tmp_path / "tokenizer.json"
    pt.save(p)
    pt2 = Tokenizer.from_file(p)
    for text in conformance_corpus()[:10]:
        assert pt.encode(text) == pt2.encode(text)
    return [pt2._to_tokenizer_json()], [jt._to_tokenizer_json()]


def _save_pretrained(jt, pt, tmp_path):
    out = []
    for t, d in ((pt, tmp_path / "port"), (jt, tmp_path / "jax")):
        t.save_pretrained(d)
        files = {f: json.loads((d / f).read_text())
                 for f in ("tokenizer.json", "tokenizer_config.json", "special_tokens_map.json")}
        assert files["tokenizer_config.json"]["bos_token"] == "<s>"
        out.append(files)
    return out


def _decode_skip_special(jt, pt, tmp_path):
    out = []
    for t in (pt, jt):
        ids = [t.bos_token_id] + t.encode("hello") + [t.eos_token_id]
        full, stripped = t.decode_with_options(ids, False, False), t.decode_with_options(ids, True, False)
        assert "<s>" in full and "<s>" not in stripped and "hello" in stripped
        out.append((full, stripped, t.clean_up_tokenization_spaces("hello , world !")))
    assert out[0][2] == "hello, world!"
    return out


def _num_special_tokens_to_add(jt, pt, tmp_path):
    out = []
    for t, P in ((pt, PP), (jt, JP)):
        r = []
        for pp in (None, P.BertProcessing(cls=("[CLS]", 1), sep=("[SEP]", 2)),
                   P.RobertaProcessing(bos=("<s>", 1), eos=("</s>", 2)),
                   P.TemplateProcessing(single="<s> $A </s>", pair="<s> $A </s> $B </s>",
                                        special_tokens=[("<s>", 1), ("</s>", 2)])):
            t.set_post_processor(pp)
            r.append((t.num_special_tokens_to_add(False), t.num_special_tokens_to_add(True)))
        assert r == [(0, 0), (2, 3), (2, 4), (2, 3)]
        out.append(r)
    return out


def _chat_template(jt, pt, tmp_path):
    msgs = [{"role": "system", "content": "be helpful"}, {"role": "user", "content": "hi"}]
    out = []
    for t in (pt, jt):
        with pytest.raises(ValueError, match="No chat template"):
            t.apply_chat_template(msgs)
        t.chat_template = "{% some template with <|im_start|> %}"
        text = t.apply_chat_template(msgs, add_generation_prompt=True, tokenize=False)
        assert "<|im_start|>system" in text and text.endswith("<|im_start|>assistant\n")
        ids = t.apply_chat_template(msgs, tokenize=True)
        assert isinstance(ids, list) and ids
        out.append((text, ids))
    return out


def _add_special_tokens_dict(jt, pt, tmp_path):
    out = []
    for t in (pt, jt):
        n = t.add_special_tokens({"additional": "<NEW>", "other": "<NEW2>", "known": "<s>"})
        m = t.add_special_tokens_list(["<L1>", "<L2>", "<s>"])
        assert n == 2 and "<NEW>" in t.special_tokens
        out.append((n, m, dict(t.special_tokens), dict(t.added_tokens), t.encode("a <L1> b"),
                    t._to_tokenizer_json()["added_tokens"]))
    return out


def _enable_padding_truncation_config(jt, pt, tmp_path):
    out = []
    for t in (pt, jt):
        t.enable_padding(direction="left", length=64, pad_id=777, pad_token="<P>")
        assert t.padding().strategy == "max_length" and t.padding_side == "left"
        a = vars(t.padding()).copy()
        t.no_padding()
        assert t.padding() is None
        t.enable_truncation(128, stride=16, strategy="only_first", direction="left")
        assert t.truncation().max_length == 128 and t.truncation().stride == 16
        b = vars(t.truncation()).copy()
        t.no_truncation()
        assert t.truncation() is None
        out.append((a, b, t.truncation_side, t.added_tokens.get("<P>")))
    return out


def _explicit_setters_and_callable_special_tokens(jt, pt, tmp_path):
    out = []
    for t in (pt, jt):
        t.set_model_max_length(1024)
        t.set_padding_side("left")
        t.set_truncation_side("left")
        t.set_chat_template("{{messages}}")
        r = (t.model_max_length, t.padding_side, t.truncation_side, t.chat_template)
        t.set_chat_template(None)
        assert t.chat_template is None and isinstance(t.special_tokens, dict)
        assert t.special_tokens() == dict(t.special_tokens)
        out.append(r)
    assert out[0] == (1024, "left", "left", "{{messages}}")
    return out


def _get_special_tokens_mask(jt, pt, tmp_path):
    out = []
    for t in (pt, jt):
        spec = sorted(t.special_tokens.values())
        ids = t.encode("hello world") + spec + [999999]
        mask = t.get_special_tokens_mask(ids, already_has_special_tokens=True)
        assert mask[-1] == 0 and mask[-1 - len(spec):-1] == [1] * len(spec)
        out.append((mask, t.get_special_tokens_mask(ids, already_has_special_tokens=False)))
    return out


def _backend_host_honored_everywhere(jt, pt, tmp_path):
    texts = ["hello world", "it's 42!"]
    expected = [jt._encode_host(t) for t in texts]
    out = []
    for t in (pt, jt):
        t.encode_backend = "host"
        assert t.encode(texts[0]) == expected[0]
        flat, offs = t.encode_batch_ragged(texts)
        out.append([flat[offs[i]:offs[i + 1]].tolist() for i in range(len(texts))])
        assert out[-1] == expected
    return out


def _bpe_dropout_deterministic_and_coarser(jt, pt, tmp_path):
    base = pt.bpe.encode("hello")
    out = []
    for T in (Tokenizer, JaxTokenizer):
        b1, b2 = T.from_str(trained_tokenizer_json()).bpe, T.from_str(trained_tokenizer_json()).bpe
        seq_a = [b1.encode_with_dropout(w, 0.5) for w in ("hello", "world") * 3]
        seq_b = [b2.encode_with_dropout(w, 0.5) for w in ("hello", "world") * 3]
        assert seq_a == seq_b
        assert b1.encode_with_dropout("hello", 0.0) == base
        all_drop = b1.encode_with_dropout("hello", 1.0)
        assert len(all_drop) >= len(base)
        out.append((seq_a, all_drop, [b1.encode_with_dropout(w, 0.1) for w in conformance_corpus()]))
    return out


SURFACE_TWINS = {
    "test_tokenizer.py::test_load_minimal, test_load_from_file, test_merges_array_format": _load_minimal,
    "test_tokenizer.py::test_roundtrip_encode_decode": _roundtrip_encode_decode,
    "test_tokenizer.py::test_special_token_inference": _special_token_inference,
    "test_tokenizer.py::test_added_token_* (three)": _added_token_matching,
    "test_tokenizer.py::test_tokenize_and_convert": _tokenize_and_convert,
    "test_tokenizer.py::test_save_load_stability": _save_load_stability,
    "test_tokenizer.py::test_save_pretrained": _save_pretrained,
    "test_tokenizer.py::test_decode_skip_special, test_clean_up_tokenization_spaces": _decode_skip_special,
    "test_tokenizer.py::test_num_special_tokens_to_add": _num_special_tokens_to_add,
    "test_tokenizer.py::test_chat_template": _chat_template,
    "test_tokenizer.py::test_add_special_tokens_dict": _add_special_tokens_dict,
    "test_tokenizer.py::test_enable_padding_truncation_config": _enable_padding_truncation_config,
    "test_tokenizer.py::test_explicit_setters_and_callable_special_tokens": _explicit_setters_and_callable_special_tokens,
    "test_api_longtail.py::test_get_special_tokens_mask": _get_special_tokens_mask,
    "test_api_longtail.py::test_backend_host_honored_everywhere": _backend_host_honored_everywhere,
    "test_api_longtail.py::test_bpe_dropout_deterministic_and_coarser": _bpe_dropout_deterministic_and_coarser,
}


@pytest.mark.parametrize("name", list(SURFACE_TWINS))
def test_surface_twin(name, tmp_path):
    jt, pt = pair()
    port_out, jax_out = SURFACE_TWINS[name](jt, pt, tmp_path)
    assert port_out == jax_out


def test_backend_host_honored_under_the_switch(monkeypatch):
    """The twin of ``test_backend_host_honored_everywhere`` under
    ``CTOK_ENCODE_BACKEND=host``: a tokenizer made then encodes through the
    oracle on every entry point, with no device."""
    monkeypatch.setenv("CTOK_ENCODE_BACKEND", "host")
    jt, pt = pair()
    assert pt.encode_backend == jt.encode_backend == "host"
    texts = conformance_corpus()
    expected = [jt._encode_host(t) for t in texts]
    assert [pt.encode(t) for t in texts] == expected
    assert pt.encode_batch(texts) == jt.encode_batch(texts) == expected
    flat, offs = pt.encode_batch_ragged(texts)
    assert [flat[offs[i]:offs[i + 1]].tolist() for i in range(len(texts))] == expected
    assert pt._native is None  # the native runtime was never built
    be = pt(texts, add_special_tokens=False)
    assert_same(jt(texts, add_special_tokens=False), be)


def test_disable_device_switch(monkeypatch):
    """``CTOK_DISABLE_DEVICE=1``: ``"auto"`` runs the native runtime alone
    (no card needed, no word path), decode skips the device pipeline, and
    an explicit ``backend="device"`` raises, naming the switch (where the
    JAX package ends on the host)."""
    monkeypatch.setenv("CTOK_DISABLE_DEVICE", "1")
    jt, pt = pair()
    assert not pt.use_device and not jt.use_device
    texts = conformance_corpus()
    expected = [jt._encode_host(t) for t in texts]
    assert pt.encode_batch(texts) == pt.encode_batch(texts, backend="auto") == expected
    assert pt.encode_batch_ragged(texts)[0].tolist() == [i for r in expected for i in r]
    assert pt._word_paths == {}
    with pytest.raises(RuntimeError, match="CTOK_DISABLE_DEVICE"):
        pt.encode_batch(texts, backend="device", device="cpu")
    with pytest.raises(RuntimeError, match="CTOK_DISABLE_DEVICE"):
        pt.encode_batch_ragged(texts, backend="device")
    assert jt.encode_batch(texts, backend="device") == expected  # JAX: the host
    pt.set_decoder(C.Decoder.byte_level())  # no native decoder: the host route
    pt._get_native_decoder = lambda: None
    rows = [pt.encode(t) for t in texts]
    assert pt.decode_batch(rows) == jt.decode_batch(rows)
    assert pt._decode_pipelines == {}


def test_auto_device_switch_off(monkeypatch):
    """``CTOK_AUTO_DEVICE=0``: ``"auto"`` runs without the background fill
    (no card needed); ``"device"`` still runs on the device asked for."""
    monkeypatch.setenv("CTOK_AUTO_DEVICE", "0")
    jt, pt = pair()
    texts = conformance_corpus()
    expected = [jt._encode_host(t) for t in texts]
    assert pt.encode_batch(texts) == expected
    assert pt._auto_word_path("cpu") is None and pt._word_paths == {}
    assert pt.encode_batch(texts, backend="device", device="cpu") == expected


def test_exit_hook_joins_fills_under_the_jax_exit_switch(monkeypatch):
    """The port does not read the JAX package's ``CTOK_FILL_EXIT_WAIT``:
    with it set to 0 the exit hook still joins a fill thread that is still
    running (a fill torn down at exit can abort the process)."""
    release = threading.Event()
    thread = threading.Thread(target=release.wait, daemon=True)
    thread.start()
    monkeypatch.setattr(wordpath, "_live_fills", {thread})
    monkeypatch.setenv("CTOK_FILL_EXIT_WAIT", "0")
    threading.Timer(0.2, release.set).start()
    wordpath._wait_live_fills()
    assert not thread.is_alive()


# ---------------------------------------------------------------------------
# components and setters


def test_setters_take_components_and_drop_built_state():
    """``set_*`` with a ``components`` wrapper or a bare component; each
    drops the built tables, word paths and native context, as ``add_token``
    does; ids then follow the new configuration, as in JAX."""
    from complexity_tokenizer_tpu import components as JC

    jt, pt = pair()
    texts = conformance_corpus()
    pt.encode_batch(texts, backend="device", device="cpu")
    assert pt._word_paths and pt._native is not None
    steps = [
        ("set_normalizer", lambda M: M.Normalizer.lowercase()),
        ("set_pre_tokenizer", lambda M: M.PreTokenizer.byte_level(add_prefix_space=True)),
        ("set_post_processor", lambda M: M.PostProcessor.template(
            "<s> $A </s>", None, [("<s>", 2), ("</s>", 0)])),
        ("set_decoder", lambda M: M.Decoder.byte_level()),
        ("set_normalizer", lambda M: M.Normalizer.sequence([M.Normalizer.nfkc(), M.Normalizer.strip()])),
        ("set_pre_tokenizer", lambda M: M.PreTokenizer.whitespace()),
    ]
    for name, make in steps:
        getattr(pt, name)(make(C))
        getattr(jt, name)(make(JC))
        assert pt._word_paths == {} and pt._native is None and pt._tables is None
        assert pt._to_tokenizer_json() == jt._to_tokenizer_json()
        assert pt.encode_batch(texts, backend="host") == jt.encode_batch(texts, backend="host")
        assert_same(jt(texts, padding="longest"), pt(texts, padding="longest"))
    # bare components are taken as they are
    pt.set_post_processor(PP.BertProcessing())
    assert isinstance(pt.post_processor, PP.BertProcessing)


def test_components_equal_jax():
    from complexity_tokenizer_tpu import components as JC

    text = "Héllo  World, 123 ÀB-c d_e!"
    for name, args in [("nfc", ()), ("nfd", ()), ("nfkc", ()), ("nfkd", ()), ("lowercase", ()),
                       ("strip", ()), ("strip_accents", ()), ("replace", ("l", "L")),
                       ("bert", ()), ("precompiled", ([("W", "w")],))]:
        assert getattr(C.Normalizer, name)(*args).normalize(text) == getattr(JC.Normalizer, name)(*args).normalize(text)
    for name, args in [("whitespace", ()), ("byte_level", (True,)), ("metaspace", ()), ("punctuation", ()),
                       ("digits", (True,)), ("gpt2", ()), ("bert", ()), ("char_delimiter_split", (",",)),
                       ("unicode_scripts", ()), ("split", (r"\s", "Isolated"))]:
        a = getattr(C.PreTokenizer, name)(*args).pre_tokenize(text)
        assert a == getattr(JC.PreTokenizer, name)(*args).pre_tokenize(text), name
    toks = ["▁Hello", "Ġworld", "##x", "a</w>", "<pad>", "_y_"]
    for name, args in [("byte_level", ()), ("metaspace", ()), ("wordpiece", ()), ("bpe", ()),
                       ("ctc", ()), ("fuse", ()), ("strip", ("_", 1, 1))]:
        assert getattr(C.Decoder, name)(*args).decode(toks) == getattr(JC.Decoder, name)(*args).decode(toks)
    for pp, jpp in [(C.PostProcessor.bert("[CLS]", 1, "[SEP]", 2), JC.PostProcessor.bert("[CLS]", 1, "[SEP]", 2)),
                    (C.PostProcessor.roberta("<s>", 0, "</s>", 2), JC.PostProcessor.roberta("<s>", 0, "</s>", 2)),
                    (C.PostProcessor.template("[A] $A [B]", "$A $B", [("[A]", 7), ("[B]", 8)]),
                     JC.PostProcessor.template("[A] $A [B]", "$A $B", [("[A]", 7), ("[B]", 8)]))]:
        assert pp.process([5, 6], [9]) == jpp.process([5, 6], [9])
        assert (pp.added_tokens_single(), pp.added_tokens_pair()) == (jpp.added_tokens_single(), jpp.added_tokens_pair())


# ---------------------------------------------------------------------------
# save and load across the two packages


def _with_everything() -> str:
    """The trained tokenizer with a post-processor, a prefix space and
    added tokens of every flag."""
    j = json.loads(trained_tokenizer_json())
    j["pre_tokenizer"] = {"type": "ByteLevel", "add_prefix_space": True}
    j["post_processor"] = {
        "type": "TemplateProcessing",
        "single": [{"SpecialToken": {"id": "<s>", "type_id": 0}}, {"Sequence": {"id": "A", "type_id": 0}},
                   {"SpecialToken": {"id": "</s>", "type_id": 0}}],
        "pair": [{"Sequence": {"id": "A", "type_id": 0}}, {"Sequence": {"id": "B", "type_id": 1}}],
        "special_tokens": {},
    }
    j["added_tokens"] += [
        {"id": 990, "content": "zqx", "special": False, "lstrip": True, "normalized": True},
        {"id": 991, "content": "<sep>", "special": True, "single_word": True},
    ]
    return json.dumps(j)


@pytest.mark.parametrize("layout", ["trained", "post-processor and added tokens", "roberta", "bert"])
def test_save_in_one_package_load_in_the_other(layout, tmp_path):
    j = json.loads(_with_everything() if layout != "trained" else trained_tokenizer_json())
    if layout in ("roberta", "bert"):
        j["post_processor"] = {"type": f"{layout.capitalize()}Processing"}
    js = json.dumps(j)
    texts = conformance_corpus() + ["a zqx b <sep> c"]
    pt, jt = Tokenizer.from_str(js), JaxTokenizer.from_str(js)
    assert pt._to_tokenizer_json() == jt._to_tokenizer_json()
    pt.save(tmp_path / "port.json")
    jt.save(tmp_path / "jax.json")
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    jt2, pt2 = JaxTokenizer.from_file(tmp_path / "port.json"), Tokenizer.from_file(tmp_path / "jax.json")
    assert jt2._to_tokenizer_json() == pt2._to_tokenizer_json() == jt._to_tokenizer_json()
    expected = jt.encode_batch(texts, backend="host")
    assert jt2.encode_batch(texts, backend="host") == expected
    assert pt2.encode_batch(texts, backend="native") == expected
    assert pt2.encode_batch(texts, backend="host") == expected
    assert_same(jt2(texts, padding="longest"), pt2(texts, padding="longest"))


# ---------------------------------------------------------------------------
# the warm-cache file


@pytest.fixture
def warm_src(tmp_path, monkeypatch):
    """The trained tokenizer written to ``tmp_path``, warm-started at any
    vocabulary size (``CTOK_WARM_START=1``)."""
    monkeypatch.setenv("CTOK_WARM_START", "1")
    p = tmp_path / "tok.json"
    p.write_text(trained_tokenizer_json())
    return p


def _blob_arrays(path):
    with np.load(path) as z:
        return {k: z[k].copy() for k in z.files}


def _sha1(path) -> str:
    return hashlib.sha1(path.read_bytes()).hexdigest()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_warm_cache_written_by_one_package_loads_in_the_other(writer, warm_src):
    """A warm-cache file written by either package (``export_warm_cache``,
    with extra corpus words) loads in the other unchanged (the file is not
    rewritten) and gives the oracle's ids; the two packages write the same
    key and arrays."""
    texts = conformance_corpus()
    words = [w.encode() for t in texts for w in t.split()]
    W, R = (JaxTokenizer, Tokenizer) if writer == "jax" else (Tokenizer, JaxTokenizer)
    n = W.from_file(warm_src).export_warm_cache(extra_words=words)
    blob = warm_src.with_name("tok.warmcache.npz")
    assert n > 0 and blob.exists()
    before = _sha1(blob)
    reader = R.from_file(warm_src)
    reader.warm_start()
    assert reader._warm_start_from_blob and reader._warm_start_words == n
    assert _sha1(blob) == before
    expected = [reader._encode_host(t) for t in texts]
    assert reader.encode_batch(texts, backend="native") == expected
    # the same file from the other package, array for array
    arrays = _blob_arrays(blob)
    blob.unlink()
    R.from_file(warm_src).export_warm_cache(extra_words=words)
    other = _blob_arrays(blob)
    assert sorted(arrays) == sorted(other) == ["counts", "ids_flat", "key", "lens", "words_buf"]
    for k in arrays:
        assert arrays[k].dtype == other[k].dtype and np.array_equal(arrays[k], other[k]), k
    assert str(arrays["key"]) == hashlib.sha1(warm_src.read_bytes()).hexdigest()


def test_warm_cache_written_at_first_load_then_read(warm_src):
    pt = Tokenizer.from_file(warm_src)
    pt.warm_start()
    blob = warm_src.with_name("tok.warmcache.npz")
    assert blob.exists() and not pt._warm_start_from_blob
    before = _sha1(blob)
    again = Tokenizer.from_file(warm_src)
    again.warm_start()
    assert again._warm_start_from_blob and _sha1(blob) == before
    jt = JaxTokenizer.from_file(warm_src)
    jt.warm_start()
    assert jt._warm_start_from_blob and _sha1(blob) == before
    texts = conformance_corpus()
    assert again.encode_batch(texts, backend="native") == [jt._encode_host(t) for t in texts]


@pytest.mark.parametrize(
    "damage", ["stale key", "not a zip", "missing array", "inconsistent lengths", "empty word"]
)
def test_warm_cache_stale_or_broken_is_recomputed(damage, warm_src):
    """A stale or broken file is not used: the warm start is recomputed.  A
    file whose key does not match, or cannot be read, is written anew; one
    whose key matches but whose arrays are broken keeps its bytes, and the
    warm start stays in memory (a file whose key matches is never
    written)."""
    Tokenizer.from_file(warm_src).warm_start()
    blob = warm_src.with_name("tok.warmcache.npz")
    good = _blob_arrays(blob)
    if damage == "stale key":
        np.savez(blob, **{**good, "key": "0" * 40})
    elif damage == "not a zip":
        blob.write_bytes(b"not a zip file")
    elif damage == "missing array":
        np.savez(blob, **{k: v for k, v in good.items() if k != "counts"})
    elif damage == "inconsistent lengths":
        np.savez(blob, **{**good, "lens": good["lens"][:-1]})
    else:
        lens = good["lens"].copy()
        lens[0], lens[1] = 0, lens[0] + lens[1]
        np.savez(blob, **{**good, "lens": lens})
    before = _sha1(blob)
    pt = Tokenizer.from_file(warm_src)
    pt.warm_start()
    assert not pt._warm_start_from_blob and pt._warm_start_words == len(good["lens"])
    if damage in ("stale key", "not a zip"):
        fixed = _blob_arrays(blob)
        for k in good:
            assert np.array_equal(fixed[k], good[k]), k
    else:
        assert _sha1(blob) == before
    texts = conformance_corpus()
    jt = JaxTokenizer.from_str(trained_tokenizer_json())
    assert pt.encode_batch(texts, backend="native") == [jt._encode_host(t) for t in texts]


def test_warm_start_switch_off_skips_the_file(warm_src, monkeypatch):
    monkeypatch.setenv("CTOK_WARM_START", "0")
    pt = Tokenizer.from_file(warm_src)
    assert pt.warm_start() == 0 and pt._warm_start_words == 0
    assert not warm_src.with_name("tok.warmcache.npz").exists()


def test_warm_start_counters_and_read_only_dir(warm_src):
    metrics.counters.reset()
    pt = Tokenizer.from_file(warm_src)
    pt.warm_start()
    snap = metrics.counters.snapshot()
    assert snap["warm_start_words"] == pt._warm_start_words > 0 and snap["warm_start_seconds"] > 0
    metrics.counters.reset()
    # a tokenizer not loaded from a file keeps its warm start in memory
    mem = Tokenizer.from_str(trained_tokenizer_json())
    mem.warm_start()
    assert mem._warm_start_words > 0 and mem._warm_cache_path() is None
    assert mem._warm_key() == JaxTokenizer.from_str(trained_tokenizer_json())._vocab_digest()
    with pytest.raises(ValueError, match="pass path="):
        mem.export_warm_cache()
    assert mem.export_warm_cache(path=warm_src.with_name("x.npz")) > 0


def test_tracked_warm_cache_blob_is_read_and_not_written(tmp_path):
    """The tracked 50K tokenizer and its warm-cache file, copied into
    ``tmp_path``: the port loads the JAX-written file (its key is the
    tokenizer.json's sha1) and leaves it byte for byte."""
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    src = os.path.join(repo, ".cache", "bench_tokenizer_r4_50k.json")
    if not os.path.exists(src):
        pytest.skip("the 50K tokenizer is not in this checkout")
    shutil.copy(src, tmp_path / "bench_tokenizer_r4_50k.json")
    shutil.copy(src.replace(".json", ".warmcache.npz"), tmp_path / "bench_tokenizer_r4_50k.warmcache.npz")
    blob = tmp_path / "bench_tokenizer_r4_50k.warmcache.npz"
    before = _sha1(blob)
    pt = Tokenizer.from_file(tmp_path / "bench_tokenizer_r4_50k.json")
    assert pt._warm_start_from_blob and pt._warm_start_words > 40000
    assert _sha1(blob) == before
    texts = conformance_corpus()[:12]
    assert pt.encode_batch(texts, backend="native") == pt.encode_batch(texts, backend="host")


# ---------------------------------------------------------------------------
# tests/test_aux.py: hub paths, chat formats, counters, from_pretrained


def test_hub_config_and_paths(tmp_path):
    cfg, jcfg = hub.HubConfig(), jax_hub.HubConfig()
    assert cfg.cache_dir == jcfg.cache_dir
    for rid in ("gpt2", "a/b", "org/sub/model"):
        assert hub.get_cache_path(rid, cfg) == jax_hub.get_cache_path(rid, jcfg)
        # the port reads only cache_dir, so the JAX package's config works too
        assert hub.get_cache_path(rid, jcfg) == jax_hub.get_cache_path(rid, jcfg)
    assert "a--b" in str(hub.get_cache_path("a/b", cfg))
    f = tmp_path / "test_tokenizer.json"
    f.write_text("{}")
    d = tmp_path / "model"
    d.mkdir()
    (d / "tokenizer.json").write_text("{}")
    for p, want in ((f, f), (d, d / "tokenizer.json")):
        assert hub.resolve_model_path(str(p)) == jax_hub.resolve_model_path(str(p)) == want
    with pytest.raises(NotImplementedError, match="network"):
        hub.resolve_model_path(str(tmp_path / "nowhere" / "org-model"))


def test_hub_is_cached_and_clear(tmp_path):
    cfg = hub.HubConfig(cache_dir=tmp_path)
    assert not hub.is_cached("org/model", "tokenizer.json", cfg)
    repo = tmp_path / "org--model"
    repo.mkdir()
    (repo / "tokenizer.json").write_text("{}")
    assert hub.is_cached("org/model", "tokenizer.json", cfg)
    assert jax_hub.is_cached("org/model", "tokenizer.json", jax_hub.HubConfig(cache_dir=tmp_path))
    hub.clear_cache("org/model", cfg)
    assert not hub.is_cached("org/model", "tokenizer.json", cfg)
    (tmp_path / "x--y").mkdir()
    hub.clear_all_cache(cfg)
    assert not tmp_path.exists()


def test_chat_formats_equal_jax():
    msgs = [{"role": "system", "content": "sys"}, {"role": "user", "content": "hi"},
            {"role": "assistant", "content": "yo"}, {"content": "no role"}]
    for template in ("x<|im_start|>y", "[INST]", "### ", "other"):
        for gen in (False, True):
            got = chat.apply_chat_template(template, msgs, gen, "<s>", "</s>")
            assert got == jax_chat.apply_chat_template(template, msgs, gen, "<s>", "</s>")
    assert "<|im_start|>user\nhi<|im_end|>" in chat.apply_chat_template("<|im_start|>", msgs, True, "<s>", "</s>")
    assert "[INST] hi [/INST]" in chat.apply_chat_template("[INST]", msgs, False, "<s>", "</s>")


def test_metrics_counters_equal_jax():
    out = []
    for M in (metrics, jax_metrics):
        c = M.Counters()
        with M.Timer("encode", count=100, registry=c):
            pass
        c.add("words", 5)
        c.add_time("words", 0.5)
        snap = c.snapshot()
        assert snap["encode"] == 100 and "encode_seconds" in snap and "encode_per_s" in snap
        out.append((sorted(snap), snap["words_per_s"], c.rate("words"), c.rate("none")))
    assert out[0] == out[1]
    with metrics.profile_trace(None):
        pass


def test_from_pretrained_local_cache(tmp_path, monkeypatch):
    jt, pt = pair()
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    repo = tmp_path / "huggingface" / "hub" / "me--model"
    repo.mkdir(parents=True)
    pt.save(repo / "tokenizer.json")
    loaded = Tokenizer.from_pretrained("me/model", local_files_only=True)
    jloaded = JaxTokenizer.from_pretrained("me/model", local_files_only=True)
    assert loaded.vocab_size == jloaded.vocab_size == pt.vocab_size
    assert loaded._to_tokenizer_json() == jloaded._to_tokenizer_json()
    with pytest.raises(IOError, match="not found in cache"):
        Tokenizer.from_pretrained("me/other", local_files_only=True)
    with pytest.raises(NotImplementedError, match="network"):
        Tokenizer.from_pretrained("me/model")


def test_counters_wired_into_batch_paths():
    jt, pt = pair()
    texts = ["hello world", "the fox"] * 4
    for M, t in ((metrics, pt), (jax_metrics, jt)):
        M.counters.reset()
        flat, offs = t.encode_batch_ragged(texts, backend="native") if t is pt else t.encode_batch_ragged(texts)
        t.decode_batch_ragged(flat, offs)
        snap = M.counters.snapshot()
        assert snap.get("encode_texts", 0) == len(texts) and snap.get("decode_texts", 0) == len(texts)
        assert snap.get("encode_texts_per_s", 0) > 0
        M.counters.reset()

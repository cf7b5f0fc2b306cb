"""The device paths as a whole: the port's ``encode_batch(backend="device",
device="cpu")`` (the word path) and its text pipeline
(``Tokenizer.pipeline("cpu").encode_bytes``) vs the JAX
``build_encode_pipeline(tok).encode_batch`` and the JAX host oracle
``tok._encode_host``, ids exactly."""

import os

import pytest

from helpers import SAMPLE_TEXT, conformance_corpus, trained_tokenizer_json

jax = pytest.importorskip("jax")

from complexity_tokenizer_tpu.ops.pipeline import build_encode_pipeline  # noqa: E402
from complexity_tokenizer_tpu.tokenizer import Tokenizer as JaxTokenizer  # noqa: E402
from complexity_tokenizer_tpu_torch.ops import pipeline as P  # noqa: E402
from complexity_tokenizer_tpu_torch.tokenizer import Tokenizer  # noqa: E402
from complexity_tokenizer_tpu_torch.utils.corpus import MULTI_PIECES, zipf_corpus  # noqa: E402

BENCH_50K = os.path.join(
    os.path.dirname(__file__), "..", ".cache", "bench_tokenizer_r4_50k.json"
)


@pytest.fixture(scope="module")
def fixture800():
    js = trained_tokenizer_json()
    jt = JaxTokenizer.from_str(js)
    return Tokenizer.from_str(js), jt, build_encode_pipeline(jt)


@pytest.fixture(scope="module")
def bench50k():
    with open(BENCH_50K, encoding="utf-8") as f:
        js = f.read()
    jt = JaxTokenizer.from_str(js)
    return Tokenizer.from_str(js), jt, build_encode_pipeline(jt)


def _text_pipeline(pt, texts):
    """The text pipeline's ids of the texts no added token can match (the
    others are the oracle's), as ``encode_batch`` routed them before the
    word path."""
    data = pt._prepare_bytes([pt._normalize(t) for t in texts])
    flags = pt._added_route_flags(data)
    fast = [i for i in range(len(texts)) if flags is None or not flags[i]]
    out = [pt._encode_host(t) for t in texts]
    for i, ids in zip(fast, pt.pipeline("cpu").encode_bytes([data[i] for i in fast])):
        out[i] = ids
    return out


def _check(tokenizers, texts, with_jax_pipeline=True):
    pt, jt, jp = tokenizers
    got = pt.encode_batch(texts, backend="device", device="cpu")
    host = [jt._encode_host(t) for t in texts]
    for t, g, h in zip(texts, got, host):
        assert g == h, (repr(t[:80]), g[:20], h[:20])
    assert _text_pipeline(pt, texts) == host
    if with_jax_pipeline:
        assert got == jp.encode_batch(texts)
    assert pt.encode_batch(texts, backend="host") == host
    return got


LONG_TEXT = (SAMPLE_TEXT.replace("\n", " ") + " ") * 40


def test_conformance_corpus(fixture800):
    _check(fixture800, conformance_corpus())


def test_text_over_widest_bucket(fixture800):
    assert len(LONG_TEXT.encode()) > 4096
    _check(fixture800, [LONG_TEXT, "short one"])


@pytest.mark.parametrize(
    "text",
    [
        "a" * 5000,  # one word longer than the widest bucket
        "x " + "é" * 2100 + " y",  # a multibyte word of 4200 bytes
        "lead " + "b" * 4500 + " mid " + "c" * 4097 + " tail",
    ],
    ids=["ascii_5000", "multibyte_4200", "two_long_words"],
)
def test_word_over_widest_bucket(fixture800, text):
    _check(fixture800, [text])


def test_empty_and_whitespace(fixture800):
    _check(fixture800, ["", " ", "\n\n\n", "   \t  ", "　"])


def test_added_token_texts_route_to_host(fixture800):
    texts = ["hello </s> world", "</s>", "a<s>b<pad>c", "plain text", "<unk></s>"]
    got = _check(fixture800, texts, with_jax_pipeline=False)
    assert got[3] == fixture800[1]._encode_host("plain text")


def test_nfc_fixture(fixture800):
    """The fixture tokenizer normalizes with NFC: decomposed and composed
    forms must encode alike, on both packages."""
    pt = fixture800[0]
    assert pt.normalizer is not None and pt.normalizer.form == "NFC"
    texts = ["café résumé", "café résumé", "ḍ̇ ḍ̇"]
    got = _check(fixture800, texts)
    assert got[0] == got[1]


def test_bucket_boundaries(fixture800):
    texts = ["w" * n for n in (127, 128, 129, 511, 512, 513, 2048, 2049, 4096)]
    texts += [" ".join(["ab"] * k) for k in (42, 43, 170, 171)]
    _check(fixture800, texts)


def test_zipf_texts_at_50k(bench50k):
    texts = zipf_corpus(300, seed=17)
    texts += [" ".join(MULTI_PIECES[i : i + 4]) for i in range(0, len(MULTI_PIECES), 4)]
    _check(bench50k, texts)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many ops on small tensors: with the test
    workers sharing the machine, torch's intra-op threads only wait on each
    other."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("L", [128, 512, 2048, 4096])
def test_encode_rows_equal_jax_encode_fn_on_edge_rows(bench50k, L):
    """The text pipeline's device pass (``EncodePipeline.encode_rows``:
    K21's, K1's and K2's plain versions on the CPU) on the pre-split's edge
    rows equals the JAX pipeline's jitted pass (``_encode_fn``: presplit,
    seed, the cuckoo fixpoint) id for id, tombstones and counts included."""
    import numpy as np

    from complexity_tokenizer_tpu_torch.utils.corpus import presplit_edge_rows

    pt, _jt, jp = bench50k
    arr, lens = presplit_edge_rows(L)
    got = pt.pipeline("cpu").encode_rows(arr, lens)
    exp_t, exp_c = (np.asarray(x) for x in jp._encode_fn(arr, lens))
    np.testing.assert_array_equal(got, exp_t)
    np.testing.assert_array_equal((got >= 0).sum(1), exp_c)


def test_pack_texts_layout():
    arr, lens = P.pack_texts([b"ab", b"", b"xyz"], 8, 4)
    assert arr.shape == (4, 8) and arr.dtype.name == "uint8"
    assert lens.tolist() == [2, 0, 3, 0]
    assert bytes(arr[0, :2]) == b"ab" and bytes(arr[2, :3]) == b"xyz"
    assert not arr[0, 2:].any() and not arr[3].any()


@pytest.mark.parametrize(
    "patch",
    [
        {"normalizer": {"type": "NFD"}},
        {"normalizer": {"type": "NFKC"}},
        {"normalizer": {"type": "NFKD"}},
        {"normalizer": None},
        {"pre_tokenizer": {"type": "ByteLevel", "add_prefix_space": True}},
    ],
    ids=["nfd", "nfkc", "nfkd", "null_normalizer", "prefix_space"],
)
def test_loaded_variants_match_jax_oracle(patch):
    """Each normalizer form and the prefix space, loaded by both packages
    from the same tokenizer.json: the port's device pipeline (on the CPU)
    equals the JAX host oracle."""
    import json

    j = json.loads(trained_tokenizer_json())
    j.update(patch)
    js = json.dumps(j)
    pt, jt = Tokenizer.from_str(js), JaxTokenizer.from_str(js)
    texts = conformance_corpus()[:12] + ["ﬁ café ①②", "café x", "Hello", ""]
    got = pt.encode_batch(texts, backend="auto", device="cpu")
    assert got == [jt._encode_host(t) for t in texts]


@pytest.mark.parametrize("backend", ["device", "host"])
def test_added_token_normalized_flag_matches_jax_oracle(backend):
    """``added_tokens[].normalized=true`` loads, and is ignored when matching
    as the JAX matcher ``_find_added_token`` ignores it: the port's ids
    equal the JAX host oracle's, on texts with and without the tokens and
    on non-ASCII texts that NFC changes."""
    import json
    import unicodedata

    j = json.loads(trained_tokenizer_json())
    j["added_tokens"][0]["normalized"] = True  # </s>
    mask_id = len(j["model"]["vocab"])
    j["added_tokens"].append(
        {"id": mask_id, "content": "mask", "special": False, "normalized": True}
    )
    js = json.dumps(j)
    pt, jt = Tokenizer.from_str(js), JaxTokenizer.from_str(js)
    texts = [
        "hello mask world", "mask", "unmasked</s>c", "x </s> y mask",
        "cafe\u0301 mask re\u0301sume\u0301",  # NFC composes the accents
        "plain text", "cafe\u0301 au lait", "ḍ̇ and ﬁ", "", " [MASK] ",
    ]
    assert unicodedata.normalize("NFC", texts[4]) != texts[4]
    got = pt.encode_batch(texts, backend=backend, device="cpu")
    exp = [jt._encode_host(t) for t in texts]
    assert got == exp
    assert exp[1] == [mask_id]
    assert all(mask_id in exp[i] for i in (0, 2, 3, 4))
    assert all(mask_id not in exp[i] for i in (5, 6, 7, 8, 9))


def test_device_path_refuses_table_not_well_formed():
    """A merge table where a pair holding merge r's product ranks before r
    (here "ab c" before "a b") is not well-formed: the device fixpoint would
    differ from the one-merge-per-step oracle, so backend="device" raises,
    while backend="host" still equals the JAX host oracle."""
    import json

    from complexity_tokenizer_tpu_torch.core.bpe import merges_well_formed

    vocab = {"a": 0, "b": 1, "c": 2, "ab": 3, "abc": 4, "ca": 5}
    js = json.dumps(
        {"model": {"type": "BPE", "vocab": vocab, "merges": ["ab c", "a b", "c a"]}}
    )
    pt, jt = Tokenizer.from_str(js), JaxTokenizer.from_str(js)
    assert not merges_well_formed(pt.bpe.merge_ranks, pt.bpe.merge_ops)
    texts = ["abc", "ab abc cab", "cabcab", "", "b a c"]
    with pytest.raises(NotImplementedError, match="well-formed"):
        pt.encode_batch(texts, backend="device", device="cpu")
    exp = [jt._encode_host(t) for t in texts]
    assert pt.encode_batch(texts, backend="host") == exp
    assert exp[0] == [4]

"""The device normalization check (K8's plain version, ``ops/normalize_device.py``)
and ``EncodePipeline.encode_batch`` of the port against the JAX package:
stability bitmaps byte for byte, plans, per-row flags and ids, exactly."""

import numpy as np
import pytest

from helpers import conformance_corpus, trained_tokenizer_json

jax = pytest.importorskip("jax")

from complexity_tokenizer_tpu.core import normalizers as JN  # noqa: E402
from complexity_tokenizer_tpu.ops import normalize_device as JND  # noqa: E402
from complexity_tokenizer_tpu.ops.pipeline import build_encode_pipeline  # noqa: E402
from complexity_tokenizer_tpu.ops.pipeline import pack_texts as jax_pack  # noqa: E402
from complexity_tokenizer_tpu.tokenizer import Tokenizer as JaxTokenizer  # noqa: E402
from complexity_tokenizer_tpu_torch.core import normalizers as N  # noqa: E402
from complexity_tokenizer_tpu_torch.ops import normalize_device as ND  # noqa: E402
from complexity_tokenizer_tpu_torch.ops.pipeline import _LENGTH_BUCKETS, pack_texts  # noqa: E402
from complexity_tokenizer_tpu_torch.tokenizer import Tokenizer  # noqa: E402
from complexity_tokenizer_tpu_torch.utils.corpus import MULTI_PIECES, zipf_corpus  # noqa: E402

import torch  # noqa: E402

KINDS = ("NFC", "NFD", "NFKC", "NFKD", "lowercase", "strip_accents", "bert_clean_text",
         "bert_cjk")


@pytest.mark.parametrize("kind", KINDS)
def test_stability_bitmap_equals_jax(kind):
    got = ND.stability_bitmap(kind)
    exp = JND.stability_bitmap(kind)
    assert got.dtype == np.uint8 and got.shape == (0x110000,)
    assert np.array_equal(got, exp)
    assert not got.flags.writeable


def test_composition_second_elements_equal_jax():
    assert ND._composition_second_elements() == JND._composition_second_elements()


def _pairs():
    """(port normalizer, JAX normalizer) pairs for the plans."""
    return [
        (None, None),
        (N.NFC(), JN.NFC()),
        (N.NFKD(), JN.NFKD()),
        (N.Lowercase(), JN.Lowercase()),
        (N.StripAccents(), JN.StripAccents()),
        (N.Strip(), JN.Strip()),
        (N.Replace("x", "y"), JN.Replace("x", "y")),
        (N.Replace("ab", ""), JN.Replace("ab", "")),
        (N.Precompiled([("ﬁ", "fi"), ("é", "e")]), JN.Precompiled([("ﬁ", "fi"), ("é", "e")])),
        (N.BertNormalizer(), JN.BertNormalizer()),
        (N.BertNormalizer(False, False, None, False), JN.BertNormalizer(False, False, None, False)),
        (N.BertNormalizer(True, True, True, False), JN.BertNormalizer(True, True, True, False)),
        (N.Sequence([N.NFC(), N.Lowercase(), N.Strip()]),
         JN.Sequence([JN.NFC(), JN.Lowercase(), JN.Strip()])),
        (N.Sequence([N.NFD(), N.Replace("a", "b")]), JN.Sequence([JN.NFD(), JN.Replace("a", "b")])),
    ]


PRED_TEXTS = ["", " lead", "trail ", "mid dle", "\tx", "x　", "plain"]


@pytest.mark.parametrize("i", range(len(_pairs())))
def test_plan_equals_jax(i):
    ours, theirs = _pairs()[i]
    got = ND.plan_for_normalizer(ours)
    exp = JND.plan_for_normalizer(theirs)
    assert got is not None and exp is not None
    assert np.array_equal(got.bitmap, exp.bitmap)
    assert (got.host_pred is None) == (exp.host_pred is None)
    if got.host_pred is not None:
        assert [got.host_pred(t) for t in PRED_TEXTS] == [exp.host_pred(t) for t in PRED_TEXTS]


@pytest.mark.parametrize("ours,theirs", [
    (N.Prepend("_"), JN.Prepend("_")),
    (N.Replace("", "y"), JN.Replace("", "y")),
    (N.Sequence([N.NFC(), N.Prepend("_")]), JN.Sequence([JN.NFC(), JN.Prepend("_")])),
])
def test_no_plan_as_in_jax(ours, theirs):
    assert ND.plan_for_normalizer(ours) is None
    assert JND.plan_for_normalizer(theirs) is None


def _multilingual_rows(n: int, seed: int) -> list[str]:
    """Seeded rows: corpus words, multilingual pieces, decomposed forms,
    uppercase, controls, CJK and edge cases."""
    rng = np.random.RandomState(seed)
    words = zipf_corpus(40, seed=seed) + list(MULTI_PIECES) + [
        "café", "ḍ̇", "가", "Upper", "\x07bell", "中文", "ﬁ",
        "\U0001f600", "x", "\t", " ", "é́", "ＡＢＣ",
    ]
    rows = []
    for _ in range(n):
        k = rng.randint(0, 12)
        rows.append(" ".join(words[rng.randint(0, len(words))] for _ in range(k)))
    return rows + ["", " ", "a" * 600, "é" * 300, "plain ascii only"]


@pytest.mark.parametrize("i", [1, 3, 5, 6, 9, 12])
def test_check_bytes_equals_jax(i):
    """``DeviceNormChecker.check_bytes`` flags equal JAX's on seeded rows
    (the port launches at the exact batch, JAX pads to its buckets)."""
    ours, theirs = _pairs()[i]
    raw = [t.encode("utf-8") for t in _multilingual_rows(150, seed=i)]
    got = ND.DeviceNormChecker(ND.plan_for_normalizer(ours), "cpu").check_bytes(
        raw, (128, 512), pack_texts)
    exp = JND.DeviceNormChecker(JND.plan_for_normalizer(theirs)).check_bytes(
        raw, (128, 512), jax_pack)
    assert got.dtype == bool
    assert got.tolist() == exp.tolist()
    assert 0 < got.sum() < len(raw)


def test_plain_flags_equal_jax_fn_on_random_bytes():
    """K8's plain version against the JAX ``_fn`` on the same numpy
    inputs: random bytes everywhere (past each row's length too), lengths
    past the width and negative ones."""
    rng = np.random.RandomState(3)
    plan = JND.plan_for_normalizer(JN.NFC())
    bitmap = plan.bitmap.copy()
    bitmap[rng.randint(0, 0x110000, size=5000)] = 1
    bitmap[ord("q")] = 1
    arr = rng.randint(0, 256, size=(64, 48)).astype(np.uint8)
    arr[:16] = rng.choice(np.frombuffer(b"abcq \xc3\xa9\xe4\xb8\xad\xf0\x9f\x98\x80", np.uint8),
                          size=(16, 48))
    lens = rng.randint(-2, 52, size=64).astype(np.int32)
    plan.bitmap = bitmap
    exp = np.asarray(JND.DeviceNormChecker(plan)._fn(arr, lens))
    got = ND.norm_stable_rows_plain(torch.from_numpy(arr), torch.from_numpy(lens),
                                    torch.from_numpy(bitmap))
    assert got.dtype == torch.bool
    assert got.numpy().tolist() == exp.tolist()
    assert 0 < exp.sum() < 64
    # the wrapper takes the plain version for CPU tensors
    same = ND.norm_stable_rows(torch.from_numpy(arr), torch.from_numpy(lens),
                               torch.from_numpy(bitmap))
    assert torch.equal(same, got)


@pytest.fixture(scope="module")
def nfc_pipelines():
    js = trained_tokenizer_json()
    jt = JaxTokenizer.from_str(js)
    jt.set_normalizer(JN.NFC())
    tok = Tokenizer.from_str(js)
    tok.set_normalizer(N.NFC())
    return tok.pipeline("cpu"), build_encode_pipeline(jt), jt


# rows of one length bucket (at most 128 bytes, at most 16 rows): one shape
# of the JAX device pipeline, whose compile dominates these tests
SHORT_TEXTS = [
    "hello world", "cafe\u0301 au lait", "caf\u00e9 au lait", "mixed d\u0323\u0307 orderings",
    "\ud55c\uad6d\uc5b4 \u1100\u1161 jamo", "\uff21\uff22\uff23 \ufb01", "", " ",
    "UPPER lower", "emoji \U0001f600 x", "tabs\tand\nnewlines", "Ą̊ring ṩḍ̇",
]


def test_encode_batch_nfc_equals_jax(nfc_pipelines):
    """``EncodePipeline.encode_batch(texts)`` with NFC: the port's ids equal
    JAX's ``pipeline.encode_batch(texts)`` and the JAX host oracle's."""
    pipe, jpipe, jt = nfc_pipelines
    got = pipe.encode_batch(SHORT_TEXTS)
    assert got == jpipe.encode_batch(SHORT_TEXTS)
    assert got == [jt._encode_host(t) for t in SHORT_TEXTS]
    assert pipe.encode_batch(SHORT_TEXTS, already_normalized=True) == jpipe.encode_batch(
        SHORT_TEXTS, already_normalized=True)


def test_encode_batch_nfc_on_every_bucket(nfc_pipelines):
    """Every length bucket and a text over the widest: the bytes after the
    check equal JAX's ``_prepare``, the ids the JAX host oracle's."""
    pipe, jpipe, jt = nfc_pipelines
    texts = conformance_corpus() + _multilingual_rows(60, seed=11) + ["cafe\u0301 " * 900]
    assert pipe._prepare(texts) == jpipe._prepare(texts)
    assert pipe.encode_batch(texts) == [jt._encode_host(t) for t in texts]


def test_stable_rows_skip_the_host_rewrite(nfc_pipelines):
    """Only the rows K8 flags are normalized on the host."""
    pipe, _jpipe, _jt = nfc_pipelines
    texts = ["hello world", "cafe\u0301 au lait", "caf\u00e9", "d\u0323\u0307 x", "ascii"]
    calls = []
    norm = pipe.normalizer

    class Counting(N.NFC):
        def normalize(self, text):
            calls.append(text)
            return norm.normalize(text)

    pipe.normalizer = Counting()
    aps = pipe.add_prefix_space
    try:
        out = pipe._prepare(texts)
        pipe.add_prefix_space = True
        prefixed = pipe._prepare(texts)
    finally:
        pipe.normalizer = norm
        pipe.add_prefix_space = aps
    assert calls == [texts[1], texts[3]] * 2
    assert out == [N.NFC().normalize(t).encode() for t in texts]
    assert prefixed == [b" " + d for d in out]


@pytest.mark.parametrize("ours,theirs", [
    (N.Prepend("▁"), JN.Prepend("▁")),
    (N.BertNormalizer(), JN.BertNormalizer()),
    (N.Sequence([N.NFKC(), N.Strip()]), JN.Sequence([JN.NFKC(), JN.Strip()])),
])
def test_encode_batch_other_normalizers_equal_jax(ours, theirs):
    """A normalizer with no plan normalizes every row on the host; others
    check on the device; the bytes equal JAX's ``_prepare``, the ids the
    JAX host oracle's."""
    js = trained_tokenizer_json()
    jt = JaxTokenizer.from_str(js)
    jt.set_normalizer(theirs)
    tok = Tokenizer.from_str(js)
    tok.set_normalizer(ours)
    texts = _multilingual_rows(40, seed=5) + [" padded ", "Ünïcödé ＦＵＬＬ"]
    pipe = tok.pipeline("cpu")
    assert (pipe._norm_checker is None) == isinstance(ours, N.Prepend)
    assert pipe._prepare(texts) == build_encode_pipeline(jt)._prepare(texts)
    assert pipe.encode_batch(texts) == [jt._encode_host(t) for t in texts]


def test_length_buckets_as_in_jax():
    from complexity_tokenizer_tpu.ops import pipeline as JP

    assert _LENGTH_BUCKETS == JP._LENGTH_BUCKETS

"""The port's transformers ``__call__`` against the JAX package's, every
field exact: the columnar route (``ColumnarBatchEncoding``) and the per-row
route, the static frames of the post-processors, the numpy and ``"pt"``
exports, the native frame and mask entry points restored in the port's
``ctok_host.cpp``, and a grid over the conformance corpus.

The twins of ``tests/test_columnar_call.py`` run the JAX test's inputs
through both packages; ``return_tensors="pt"`` with ``device="cpu"`` takes
the place of JAX's ``"jax"``.  Every field is an integer (or a token
string, or an offset pair): no tolerance applies."""

import itertools
import re

import numpy as np
import pytest
import torch

from helpers import conformance_corpus, trained_tokenizer_json

jax = pytest.importorskip("jax")

from complexity_tokenizer_tpu.core import postprocessors as JP  # noqa: E402
from complexity_tokenizer_tpu.native import load_ext as jax_load_ext  # noqa: E402
from complexity_tokenizer_tpu.tokenizer import Tokenizer as JaxTokenizer  # noqa: E402
from complexity_tokenizer_tpu_torch.batch_encoding import ColumnarBatchEncoding  # noqa: E402
from complexity_tokenizer_tpu_torch.core import postprocessors as PP  # noqa: E402
from complexity_tokenizer_tpu_torch.native import load_ext  # noqa: E402
from complexity_tokenizer_tpu_torch.tokenizer import Tokenizer  # noqa: E402


def pair():
    """A fresh (JAX, port) pair of the trained tokenizer of ``helpers``."""
    js = trained_tokenizer_json()
    return JaxTokenizer.from_str(js), Tokenizer.from_str(js)


def texts():
    return conformance_corpus() + ["", " ", "a"]


def plain(v):
    """A field as nested lists: tensors and arrays converted."""
    if isinstance(v, torch.Tensor):
        v = v.cpu().numpy()
    if isinstance(v, np.ndarray):
        v = v.tolist()
    return v


def enc_fields(e):
    return (e.ids, e.type_ids, e.tokens, e.attention_mask, e.special_tokens_mask, e.offsets,
            e.word_ids, e.sequence_ids, [enc_fields(o) for o in e.overflowing])


def assert_same(a, b):
    """Every field of two BatchEncodings (the JAX package's, the port's)
    equal, and their Encodings (offsets, overflow windows) too."""
    assert type(a).__name__ == type(b).__name__
    assert len(a) == len(b) and a.keys() == b.keys()
    for k in a.keys():
        assert plain(a[k]) == plain(b[k]), k
    assert [enc_fields(e) for e in a.encodings()] == [enc_fields(e) for e in b.encodings()]


def per_row(tok, *args, **kwargs):
    """``tok(...)`` with the columnar route turned off."""
    orig = tok._call_batch_columnar
    tok._call_batch_columnar = lambda *a, **k: None
    try:
        return tok(*args, **kwargs)
    finally:
        tok._call_batch_columnar = orig


FIELDS = ("input_ids", "attention_mask", "token_type_ids", "special_tokens_mask")

COLUMNAR_CONFIGS = [
    (p, t, m, s, side)
    for p, t, m, s, side in itertools.product(
        [None, "longest", "max_length", "left"], [False, True], [12, 48, None], [0, 3],
        ["right", "left"],
    )
    if not (s and not t)
]


@pytest.mark.parametrize("padding,truncation,max_length,stride,side", COLUMNAR_CONFIGS)
def test_columnar_call_matches_per_row(padding, truncation, max_length, stride, side):
    jt, pt = pair()
    kwargs = dict(padding=padding, truncation=truncation, max_length=max_length, stride=stride,
                  return_special_tokens_mask=True)
    for t in (jt, pt):
        t.set_padding_side(side)
    got = pt(texts(), **kwargs)
    ref = per_row(pt, texts(), **kwargs)
    assert isinstance(got, ColumnarBatchEncoding)
    for f in FIELDS:
        assert getattr(got, f) == getattr(ref, f), f
    for i in (0, 5, len(texts()) - 1):
        assert enc_fields(got[i]) == enc_fields(ref[i])
    assert_same(jt(texts(), **kwargs), got)
    assert_same(per_row(jt, texts(), **kwargs), ref)


def _frames(P):
    return [
        None,
        P.TemplateProcessing(single="<s> $A </s>", special_tokens=[("<s>", 5), ("</s>", 6)]),
        P.TemplateProcessing(single="$A </s>", special_tokens=[("</s>", 6)]),
        P.TemplateProcessing(single="<s> <s> $A", special_tokens=[("<s>", 5)]),
        P.BertProcessing(cls=("[CLS]", 3), sep=("[SEP]", 4)),
        P.RobertaProcessing(bos=("<s>", 5), eos=("</s>", 6)),
        # $A twice: not a static frame, the per-row route
        P.TemplateProcessing(single="$A </s> $A", special_tokens=[("</s>", 6)]),
    ]


@pytest.mark.parametrize("k", range(7))
def test_columnar_call_frames(k):
    jt, pt = pair()
    jt.set_post_processor(_frames(JP)[k])
    pt.set_post_processor(_frames(PP)[k])
    kwargs = dict(padding="longest", truncation=True, max_length=24,
                  return_special_tokens_mask=True)
    got = pt(texts(), **kwargs)
    ref = per_row(pt, texts(), **kwargs)
    assert isinstance(got, ColumnarBatchEncoding) == (k != 6)
    for f in FIELDS:
        assert getattr(got, f) == getattr(ref, f), f
    assert enc_fields(got[2]) == enc_fields(ref[2])
    assert_same(jt(texts(), **kwargs), got)


def _numpy_exports_and_dict():
    jt, pt = pair()
    kw = dict(padding="longest", truncation=True, max_length=24)
    got, ref, jax_got = pt(texts(), **kw), per_row(pt, texts(), **kw), jt(texts(), **kw)
    for a, b, c in zip(got.input_ids_as_numpy(), ref.input_ids_as_numpy(), jax_got.input_ids_as_numpy()):
        assert a.tolist() == b.tolist() == c.tolist() and a.dtype == c.dtype
    for a, b in zip(got.attention_mask_as_numpy(), jax_got.attention_mask_as_numpy()):
        assert a.tolist() == b.tolist()
    assert got.to_dict() == ref.to_dict() == jax_got.to_dict()
    assert got.keys() == ref.keys() and len(got) == len(ref) == len(texts())
    assert got["input_ids"] == ref["input_ids"]
    assert len(got.encodings()) == len(texts())


def _offsets_requested_falls_back():
    jt, pt = pair()
    got = pt(texts()[:8], return_offsets_mapping=True)
    assert not isinstance(got, ColumnarBatchEncoding)
    assert got.offset_mapping == per_row(pt, texts()[:8], return_offsets_mapping=True).offset_mapping
    assert_same(jt(texts()[:8], return_offsets_mapping=True), got)


def _return_tensors_np_and_pt():
    jt, pt = pair()
    kw = dict(padding="longest", truncation=True, max_length=24, return_special_tokens_mask=True)
    ref = per_row(pt, texts(), **kw)
    got = pt(texts(), return_tensors="np", **kw)
    assert isinstance(got.input_ids, np.ndarray) and got.input_ids.dtype == np.int32
    for f in FIELDS:
        assert getattr(got, f).tolist() == getattr(ref, f), f
    ref_t = per_row(pt, texts(), return_tensors="np", **kw)
    assert ref_t.input_ids.tolist() == got.input_ids.tolist()
    got_pt = pt(texts(), return_tensors="pt", device="cpu", **kw)
    jax_np = jt(texts(), return_tensors="np", **kw)
    for f in FIELDS:
        v = getattr(got_pt, f)
        assert isinstance(v, torch.Tensor) and v.dtype == torch.int32 and v.device.type == "cpu"
        assert v.tolist() == getattr(jax_np, f).tolist(), f
    got_pt = pt(texts(), padding="max_length", truncation=True, max_length=16,
                return_tensors="pt", device="cpu")
    assert tuple(got_pt.input_ids.shape) == (len(texts()), 16)
    # "jax" is the JAX package's kind; the port takes "pt" instead
    with pytest.raises(ValueError, match="'pt'"):
        pt(texts(), return_tensors="jax")


def _return_tensors_requires_padding():
    jt, pt = pair()
    two = ["one two three", "a much longer sentence here"]
    for kind in ("np", "pt"):
        with pytest.raises(ValueError, match="requires padding"):
            pt(two, return_tensors=kind, device="cpu").input_ids
        with pytest.raises(ValueError, match="requires padding"):
            per_row(pt, two, return_tensors=kind, device="cpu").input_ids
    with pytest.raises(ValueError, match="requires padding"):
        jt(two, return_tensors="np").input_ids


def _frame_matrix_matches_frame_rows():
    ext, jext = load_ext(), jax_load_ext()
    rng = np.random.RandomState(7)
    for trial in range(60):
        n = int(rng.randint(1, 9))
        lens = rng.randint(0, 12, size=n)
        offs = np.zeros(n + 1, np.int64)
        offs[1:] = np.cumsum(lens)
        flat = rng.randint(0, 1000, size=int(offs[-1])).astype(np.int32)
        prefix = [int(x) for x in rng.randint(0, 50, size=rng.randint(0, 3))]
        suffix = [int(x) for x in rng.randint(0, 50, size=rng.randint(0, 3))]
        args = (prefix, suffix, int(rng.choice([-1, 1, 2, 5, 9])),
                int(rng.choice([-1, 0, 4, 10, 16])), 7777, int(rng.randint(0, 2)))
        rows = ext.frame_rows(flat, offs, *args)
        assert rows == jext.frame_rows(flat, offs, *args), trial
        L = max((len(r) for r in rows), default=0)
        mat, jmat = np.empty((n, L), np.int32), np.empty((n, L), np.int32)
        ext.frame_matrix(flat, offs, *args, mat)
        jext.frame_matrix(flat, offs, *args, jmat)
        assert (mat == jmat).all(), trial
        for i, r in enumerate(rows):
            assert mat[i, : len(r)].tolist() == r, (trial, i)
            assert (mat[i, len(r):] == 7777).all(), (trial, i)


def _frame_entry_points_reject_bad_offsets():
    ext = load_ext()
    flat = np.arange(6, dtype=np.int32)
    for offs in ([-100, 0], [0, 4, 2, 6], [0, 99], [2, 1]):
        offs = np.array(offs, np.int64)
        with pytest.raises(ValueError):
            ext.frame_rows(flat, offs, [], [], -1, -1, 0, 0)
        with pytest.raises(ValueError):
            ext.frame_matrix(flat, offs, [], [], -1, -1, 0, 0, np.empty((len(offs) - 1, 8), np.int32))


def _mask_matrix_matches_numpy_reference():
    ext, jext = load_ext(), jax_load_ext()
    rng = np.random.RandomState(11)
    for trial in range(40):
        n, L = int(rng.randint(1, 12)), int(rng.randint(1, 20))
        t = rng.randint(0, L + 1, size=n).astype(np.int64)
        f = np.full(n, L, np.int64)
        for pad_left in (0, 1):
            out, jout = np.empty((n, L), np.int32), np.empty((n, L), np.int32)
            ext.mask_matrix(t, f, pad_left, L, out)
            jext.mask_matrix(t, f, pad_left, L, jout)
            pos = np.arange(L, dtype=np.int64)[None, :]
            want = (pos >= (f[:, None] - t[:, None]) if pad_left else pos < t[:, None])
            assert (out == want.astype(np.int32)).all() and (out == jout).all(), (trial, pad_left)
            assert ext.mask_rows(t, f, pad_left) == jext.mask_rows(t, f, pad_left) == out.tolist()


def _mask_matrix_rejects_bad_lengths():
    ext = load_ext()
    out = np.empty((2, 4), np.int32)
    for t, f, L in (([5, 1], [4, 4], 4), ([1, 1], [9, 9], 4), ([1, 1], [2, 2], 2)):
        with pytest.raises(ValueError):
            ext.mask_matrix(np.array(t, np.int64), np.array(f, np.int64), 0, L, out)


def _frame_rows_non_interned_pad_id():
    ext = load_ext()
    flat = np.arange(5, dtype=np.int32)
    offs = np.array([0, 2, 5], np.int64)
    for pad_id in (-9, 1 << 22):
        rows = ext.frame_rows(flat, offs, [], [], -1, 6, pad_id, 0)
        assert rows == [[0, 1] + [pad_id] * 4, [2, 3, 4] + [pad_id] * 3]


TWINS = {
    "test_columnar_numpy_exports_and_dict": _numpy_exports_and_dict,
    "test_columnar_offsets_requested_falls_back": _offsets_requested_falls_back,
    "test_return_tensors_np_and_jax": _return_tensors_np_and_pt,
    "test_return_tensors_requires_padding": _return_tensors_requires_padding,
    "test_frame_matrix_matches_frame_rows": _frame_matrix_matches_frame_rows,
    "test_frame_entry_points_reject_bad_offsets": _frame_entry_points_reject_bad_offsets,
    "test_mask_matrix_matches_numpy_reference": _mask_matrix_matches_numpy_reference,
    "test_mask_matrix_rejects_bad_lengths": _mask_matrix_rejects_bad_lengths,
    "test_frame_rows_non_interned_pad_id": _frame_rows_non_interned_pad_id,
}


@pytest.mark.parametrize("name", list(TWINS))
def test_columnar_twin(name):
    """The twin of the JAX test ``name`` of ``tests/test_columnar_call.py``."""
    TWINS[name]()


# ---------------------------------------------------------------------------
# the grid: padding x side x truncation x add_special_tokens x return flags,
# port against JAX on the conformance corpus

GRID = list(itertools.product(
    [None, "longest", "max_length"], ["right", "left"], [None, 0, 2], [True, False], [True, False],
))


@pytest.mark.parametrize("padding,side,stride,add_special,flags", GRID)
def test_call_grid_equals_jax(padding, side, stride, add_special, flags):
    jt, pt = pair()
    for t in (jt, pt):
        t.set_padding_side(side)
        t.add_special_tokens_list(["<|bos|>", "<|eos|>"])
        bos, eos = t.special_tokens["<|bos|>"], t.special_tokens["<|eos|>"]
    jt.set_post_processor(JP.TemplateProcessing("<|bos|> $A <|eos|>", None, [("<|bos|>", bos), ("<|eos|>", eos)]))
    pt.set_post_processor(PP.TemplateProcessing("<|bos|> $A <|eos|>", None, [("<|bos|>", bos), ("<|eos|>", eos)]))
    kw = dict(
        add_special_tokens=add_special, padding=padding, truncation=stride is not None,
        max_length=20, stride=stride or 0, return_attention_mask=flags,
        return_token_type_ids=flags, return_offsets_mapping=not flags,
        return_special_tokens_mask=flags,
    )
    corpus = conformance_corpus() + ["x <|bos|> y", "<|eos|>"]
    got = pt(corpus, device="cpu", **kw)
    assert_same(jt(corpus, **kw), got)
    pt_t = pt(corpus, device="cpu", return_tensors="pt", **kw)
    np_t = jt(corpus, return_tensors="np", **kw)
    for k in FIELDS:
        if k in np_t.keys():
            try:
                want = plain(np_t[k])
            except ValueError as e:  # rows of unequal length
                with pytest.raises(ValueError, match=re.escape(str(e))):
                    pt_t[k]
                continue
            assert plain(pt_t[k]) == want, k
    one = corpus[1]
    assert_same(jt(one, **kw), pt(one, device="cpu", **kw))


# ---------------------------------------------------------------------------
# twins of the __call__ tests of tests/test_tokenizer.py and
# tests/test_api_longtail.py: each runs the JAX test's calls on both
# packages, every result equal, and the JAX test's own checks on the port


def _call_single_and_batch():
    jt, pt = pair()
    be = pt("Hello, world!")
    assert_same(jt("Hello, world!"), be)
    assert len(be) == 1 and be.input_ids[0]
    assert be.attention_mask[0] == [1] * len(be.input_ids[0])
    two = ["Hello", "a longer text right here"]
    be2 = pt(two, padding="longest")
    assert_same(jt(two, padding="longest"), be2)
    lens = [len(x) for x in be2.input_ids]
    assert lens[0] == lens[1] and be2.attention_mask[0].count(1) < lens[0]


def _call_truncation_stride():
    jt, pt = pair()
    text = "word " * 50
    be = pt(text, truncation=True, max_length=10, stride=2)
    assert_same(jt(text, truncation=True, max_length=10, stride=2), be)
    assert len(be[0]) == 10 and be[0].n_overflowing() > 0


def _call_max_length_padding():
    jt, pt = pair()
    be = pt("hi", padding="max_length", max_length=16)
    assert_same(jt("hi", padding="max_length", max_length=16), be)
    assert len(be.input_ids[0]) == 16


def _post_processor_applied_in_call():
    jt, pt = pair()
    bos, eos = pt.bos_token_id, pt.eos_token_id
    assert (bos, eos) == (jt.bos_token_id, jt.eos_token_id)
    jt.post_processor = JP.TemplateProcessing(single="<s> $A </s>", special_tokens=[("<s>", bos), ("</s>", eos)])
    pt.post_processor = PP.TemplateProcessing(single="<s> $A </s>", special_tokens=[("<s>", bos), ("</s>", eos)])
    be = pt("hello")
    assert_same(jt("hello"), be)
    ids = be.input_ids[0]
    assert ids[0] == bos and ids[-1] == eos
    assert be[0].special_tokens_mask[0] == 1 and be[0].special_tokens_mask[-1] == 1


def _call_fast_path_full_field_parity():
    jt, pt = pair()
    batch = ["hello world, it's fine", "the quick brown fox jumps over the lazy dog again and again",
             "short", "numbers 123 456 and punct !?"] * 3
    kw = dict(truncation=True, max_length=8, stride=3, return_offsets_mapping=True)
    fast = pt(batch, **kw)
    assert_same(jt(batch, **kw), fast)
    slow = [pt._call_one(t, None, True) for t in batch]
    for e in slow:
        if len(e) > 8:
            e.truncate_with_stride(8, 3)
    assert [enc_fields(e) for e in fast.encodings()] == [enc_fields(e) for e in slow]


def _call_no_special_tokens_branch_parity():
    jt, pt = pair()
    batch = ["hello world", "it's a <s> test"]
    be = pt(batch, add_special_tokens=False, device="cpu")
    assert_same(jt(batch, add_special_tokens=False), be)
    for enc, t in zip(be.encodings(), batch):
        assert enc.ids == pt.encode(t) and enc.offsets == []


def _call_pair_validation():
    _jt, pt = pair()
    with pytest.raises(ValueError):
        pt(["a", "b", "c"], text_pair=["x"])
    with pytest.raises(TypeError):
        pt(["a", "b"], text_pair="cd")


def _return_tensors_unpadded_error_message():
    _jt, pt = pair()
    with pytest.raises(ValueError, match="requires padding"):
        pt(["hi", "a much longer sentence"], return_tensors="np").input_ids
    with pytest.raises(ValueError, match="requires padding"):
        pt(["hi", "a much longer sentence"], return_tensors="pt", device="cpu").input_ids


def _getitem_unknown_key_raises():
    jt, pt = pair()
    enc = pt(["hello world"])
    assert_same(jt(["hello world"]), enc)
    with pytest.raises(KeyError):
        enc["nonsense"]
    assert enc["input_ids"] == enc.input_ids
    assert enc["attention_mask"] == enc.attention_mask


def _call_pairs_both_ways():
    jt, pt = pair()
    a, b = ["hello world", "x", ""], ["the fox", "it's 42", "y"]
    for ast in (True, False):
        kw = dict(add_special_tokens=ast, padding="longest", return_offsets_mapping=ast)
        assert_same(jt(a, text_pair=b, **kw), pt(a, text_pair=b, device="cpu", **kw))
        assert_same(jt(a[0], text_pair=b[0], **kw), pt(a[0], text_pair=b[0], device="cpu", **kw))


CALL_TWINS = {
    "test_tokenizer.py::test_call_single_and_batch": _call_single_and_batch,
    "test_tokenizer.py::test_call_truncation_stride": _call_truncation_stride,
    "test_tokenizer.py::test_call_max_length_padding": _call_max_length_padding,
    "test_tokenizer.py::test_post_processor_applied_in_call": _post_processor_applied_in_call,
    "test_tokenizer.py::test_call_fast_path_full_field_parity": _call_fast_path_full_field_parity,
    "test_tokenizer.py::test_call_no_special_tokens_branch_parity": _call_no_special_tokens_branch_parity,
    "test_api_longtail.py::test_call_pair_validation": _call_pair_validation,
    "test_api_longtail.py::test_return_tensors_unpadded_error_message": _return_tensors_unpadded_error_message,
    "test_api_longtail.py::test_getitem_unknown_key_raises": _getitem_unknown_key_raises,
    "pairs, add_special_tokens both ways": _call_pairs_both_ways,
}


@pytest.mark.parametrize("name", list(CALL_TWINS))
def test_call_twin(name):
    CALL_TWINS[name]()

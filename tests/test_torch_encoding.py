"""The port's ``Encoding``, post-processors, truncation and padding helpers,
``BatchEncoding`` and the ``Encoding`` routes of the tokenizer, against the
JAX package's, every field exact: twins of the post-processor, truncation,
padding and ``Encoding`` tests of ``tests/test_core_components.py``, of the
``Encoding`` tests of ``tests/test_tokenizer.py`` and
``tests/test_api_longtail.py``, and of ``tests/test_aux.py``'s
``BatchEncoding`` test, plus random cases made from a seed with numpy."""

import numpy as np
import pytest

from helpers import conformance_corpus, trained_tokenizer_json

jax = pytest.importorskip("jax")

from complexity_tokenizer_tpu.batch_encoding import BatchEncoding as JaxBatchEncoding  # noqa: E402
from complexity_tokenizer_tpu.core import encoding as JE  # noqa: E402
from complexity_tokenizer_tpu.core import postprocessors as JP  # noqa: E402
from complexity_tokenizer_tpu.tokenizer import Tokenizer as JaxTokenizer  # noqa: E402
from complexity_tokenizer_tpu_torch.batch_encoding import BatchEncoding  # noqa: E402
from complexity_tokenizer_tpu_torch.core import encoding as PE  # noqa: E402
from complexity_tokenizer_tpu_torch.core import postprocessors as PP  # noqa: E402
from complexity_tokenizer_tpu_torch.tokenizer import Tokenizer  # noqa: E402

from test_torch_call import enc_fields  # noqa: E402


def pair():
    js = trained_tokenizer_json()
    return JaxTokenizer.from_str(js), Tokenizer.from_str(js)


def both(fn):
    """``fn`` applied to the JAX package's module set and the port's."""
    return fn(JP, JE), fn(PP, PE)


# ---------------------------------------------------------------------------
# tests/test_core_components.py: post-processors, truncation, padding, Encoding


def _bert_processing(P, E):
    p = P.BertProcessing(cls=("[CLS]", 101), sep=("[SEP]", 102))
    assert p.process([1, 2, 3]) == [101, 1, 2, 3, 102]
    return p.process([1, 2, 3]), p.process([1], [2, 3]), p.added_tokens_single(), p.added_tokens_pair()


def _roberta_processing(P, E):
    p = P.RobertaProcessing(bos=("<s>", 0), eos=("</s>", 2))
    assert p.process([1, 2, 3]) == [0, 1, 2, 3, 2]
    return p.process([1, 2, 3]), p.process([1], [2, 3]), p.added_tokens_single(), p.added_tokens_pair()


def _template_processing(P, E):
    p = P.TemplateProcessing(
        single="<s> $A </s>", pair="<s> $A </s> $B </s>", special_tokens=[("<s>", 0), ("</s>", 2)]
    )
    assert p.process([5, 6]) == [0, 5, 6, 2]
    assert p.process([5, 6], [7]) == [0, 5, 6, 2, 7, 2]
    assert p.compile_single() == ([0], [2])
    seq = P.Sequence([p, P.BertProcessing()])
    return (p.process([5, 6], [7]), p.added_tokens_single(), p.added_tokens_pair(),
            seq.process([1], [2]), seq.added_tokens_single(), P.default_postprocessor().process([9]))


def _truncation_strategies(P, E):
    S = P.TruncationStrategy
    ids, pair_ids = P.truncate_ids([1, 2, 3, 4, 5], None, 3, S.ONLY_FIRST)
    assert ids == [1, 2, 3]
    ids2, pair2 = P.truncate_ids([1, 2, 3], [4, 5, 6, 7, 8], 5, S.ONLY_SECOND)
    assert ids2 == [1, 2, 3] and pair2 == [4, 5]
    ids3, pair3 = P.truncate_ids([1, 2, 3], [4, 5, 6, 7, 8], 5, S.LONGEST_FIRST)
    assert len(ids3) + len(pair3) == 5
    return ids, pair_ids, ids2, pair2, ids3, pair3


def _pad_ids(P, E):
    assert P.pad_ids([1, 2, 3], 5, 0) == [1, 2, 3, 0, 0]
    assert P.pad_ids([1, 2, 3], 5, 0, pad_left=True) == [0, 0, 1, 2, 3]
    return P.pad_ids([1, 2, 3], 5, 0), P.pad_ids([1, 2, 3], 2, 0, True)


def _encoding_from_ids(P, E):
    enc = E.Encoding.from_ids([1, 2, 3], ["a", "b", "c"])
    assert len(enc) == 3 and enc.attention_mask == [1, 1, 1]
    assert enc.type_ids == [0, 0, 0] and enc.sequence_ids == [0, 0, 0]
    return enc_fields(enc)


def _encoding_padding(P, E):
    enc = E.Encoding.from_ids([1, 2], ["a", "b"])
    enc.pad(5, 0, "<pad>", False)
    assert len(enc) == 5 and enc.attention_mask == [1, 1, 0, 0, 0]
    assert enc.sequence_ids == [0, 0, None, None, None]
    left = E.Encoding.from_ids([1, 2], ["a", "b"])
    left.pad(4, 9, "<pad>", True)
    return enc_fields(enc), enc_fields(left)


def _encoding_truncation(P, E):
    enc = E.Encoding.from_ids([1, 2, 3, 4, 5], list("abcde"))
    enc.truncate(3)
    assert len(enc) == 3 and len(enc.overflowing) == 1 and len(enc.overflowing[0]) == 2
    return enc_fields(enc)


def _truncate_with_stride(P, E):
    enc = E.Encoding.from_ids(list(range(10)), [str(i) for i in range(10)])
    enc.truncate_with_stride(4, 2)
    assert len(enc) == 4
    assert [o.ids for o in enc.overflowing] == [[2, 3, 4, 5], [4, 5, 6, 7], [6, 7, 8, 9]]
    return enc_fields(enc)


def _alignment(P, E):
    enc = E.Encoding.from_ids([1, 2, 3], ["hello", " ", "world"])
    enc.offsets = [(0, 5), (5, 6), (6, 11)]
    enc.word_ids = [0, None, 1]
    other = E.Encoding.from_ids([4], ["x"])
    other.offsets, other.word_ids = [(0, 1)], [0]
    enc.merge(other, 1)
    return ([enc.char_to_token(c) for c in range(12)], enc.char_to_token_with_sequence(0, 1),
            [enc.token_to_chars(i) for i in range(5)], [enc.token_to_word(i) for i in range(5)],
            [enc.token_to_sequence(i) for i in range(5)], enc.word_to_tokens(1),
            enc.word_to_tokens_with_sequence(0, 1), enc.word_to_chars(0), enc.word_token_indices(0),
            enc.n_words(), enc.ids_as_numpy().tolist(), enc.type_ids_as_numpy().tolist(),
            enc.special_tokens_mask_as_numpy().dtype.name, enc_fields(enc))


CORE_TWINS = {
    "test_core_components.py::test_bert_processing": _bert_processing,
    "test_core_components.py::test_roberta_processing": _roberta_processing,
    "test_core_components.py::test_template_processing": _template_processing,
    "test_core_components.py::test_truncation_strategies": _truncation_strategies,
    "test_core_components.py::test_pad_ids": _pad_ids,
    "test_core_components.py::test_encoding_from_ids": _encoding_from_ids,
    "test_core_components.py::test_encoding_padding": _encoding_padding,
    "test_core_components.py::test_encoding_truncation": _encoding_truncation,
    "test_core_components.py::test_truncate_with_stride": _truncate_with_stride,
    "alignment maps and numpy exports": _alignment,
}


@pytest.mark.parametrize("name", list(CORE_TWINS))
def test_core_twin(name):
    jax_out, port_out = both(CORE_TWINS[name])
    assert port_out == jax_out


@pytest.mark.parametrize("seed", range(6))
def test_random_encodings_equal_jax(seed):
    """Random Encodings (made from a seed with numpy), padded, truncated
    with and without a stride, merged with a pair, deferred offsets read
    after the cut: every field of both packages equal."""

    def run(P, E):
        r = np.random.RandomState(seed)
        out = []
        for _ in range(20):
            n = int(r.randint(0, 30))
            ids = r.randint(0, 1000, size=n).tolist()
            enc = E.Encoding.from_ids(ids, [str(i) for i in ids])
            offs = [(int(a), int(a) + 2) for a in r.randint(0, 100, size=n)]
            wids = r.randint(0, 5, size=n).tolist()
            if r.rand() < 0.5:
                enc._defer_aux(lambda o=offs, w=wids: (o, w))
            else:
                enc.offsets, enc.word_ids = list(offs), list(wids)
            if r.rand() < 0.5:
                enc.merge(E.Encoding.from_ids([7, 8], ["7", "8"]), 1)
            m = int(r.randint(1, 12))
            stride = int(r.randint(0, m))  # a stride of m or more never advances
            if r.rand() < 0.5:
                enc.truncate_with_stride(m, stride)
            else:
                enc.truncate(m)
            enc.pad(int(r.randint(0, 16)), 3, "<pad>", bool(r.rand() < 0.5))
            out.append(enc_fields(enc))
        return out

    jax_out, port_out = both(run)
    assert port_out == jax_out


# ---------------------------------------------------------------------------
# the Encoding routes of the tokenizer


def _encoding_offsets_path(jt, pt):
    enc = pt.encode_to_encoding("hello world")
    assert len(enc.offsets) == len(enc.ids) and enc.word_ids[0] == 0
    return [enc_fields(enc)], [enc_fields(jt.encode_to_encoding("hello world"))]


def _encode_batch_to_encoding_matches_single(jt, pt):
    texts = conformance_corpus()
    batch = pt.encode_batch_to_encoding(texts)
    for t, b in zip(texts, batch):
        assert enc_fields(pt.encode_to_encoding(t)) == enc_fields(b), repr(t)
    return [enc_fields(e) for e in batch], [enc_fields(e) for e in jt.encode_batch_to_encoding(texts)]


def _encode_with_truncation_and_stride(jt, pt):
    long_text = " ".join(conformance_corpus()[:6]) * 3
    full = pt.encode_to_encoding(long_text)
    enc = pt.encode_with_truncation(long_text, max_length=16)
    assert len(enc) == 16 and enc.ids == full.ids[:16] and enc.n_overflowing() >= 1
    enc_s = pt.encode_with_truncation(long_text, max_length=16, stride=4)
    assert len(enc_s) == 16 and enc_s.overflowing[0].ids[:4] == enc_s.ids[-4:]
    enc_p = pt.encode_with_truncation("hello world", "the fox", max_length=8)
    assert len(enc_p) <= 8
    calls = [
        lambda t: t.encode_with_truncation(long_text, max_length=16),
        lambda t: t.encode_with_truncation(long_text, max_length=16, stride=4),
        lambda t: t.encode_with_truncation("hello world", "the fox", max_length=8),
        lambda t: t.encode_to_encoding_with_truncation(long_text, "x y", 10, 3),
    ]
    return [enc_fields(c(pt)) for c in calls], [enc_fields(c(jt)) for c in calls]


def _encode_batch_pairs(jt, pt):
    pairs = [("hello world", "the fox"), ("a", "b"), ("", "x")]
    encs = pt.encode_batch_pairs_to_encoding(pairs)
    for (a, b), e in zip(pairs, encs):
        ref = pt.encode_pair_to_encoding(a, b)
        assert e.ids == ref.ids and e.type_ids == ref.type_ids
    padded = pt.encode_batch_pairs_with_padding(pairs)
    assert all(len(e) == max(len(e) for e in encs) for e in padded)
    calls = [
        lambda t: t.encode_batch_pairs_to_encoding(pairs),
        lambda t: t.encode_batch_pairs_with_padding(pairs),
        lambda t: t.encode_batch_pairs_with_padding(pairs, max_length=16, pad_left=True),
        lambda t: t.encode_batch_with_padding(["a", "hello world"], max_length=9),
    ]
    return ([[enc_fields(e) for e in c(pt)] for c in calls],
            [[enc_fields(e) for e in c(jt)] for c in calls])


def _from_buffer_and_batch_encode_plus(jt, pt):
    pt = Tokenizer.from_buffer(trained_tokenizer_json().encode("utf-8"))
    texts = ["hello world", "the fox"]
    encs = pt.batch_encode_plus(texts)
    assert [e.ids for e in encs] == [pt.encode_to_encoding(t).ids for t in texts]
    assert pt.encode_plus(texts[0]).ids == encs[0].ids
    return ([enc_fields(e) for e in encs] + [enc_fields(pt.encode_plus(texts[0]))],
            [enc_fields(e) for e in jt.batch_encode_plus(texts)] + [enc_fields(jt.encode_plus(texts[0]))])


def _post_process_and_prepare_for_model(jt, pt):
    out = []
    for t in (jt, pt):
        P = JP if t is jt else PP
        bos, eos = t.bos_token_id, t.eos_token_id
        t.set_post_processor(P.RobertaProcessing(bos=("<s>", bos), eos=("</s>", eos)))
        ids = t.encode("hello world")
        a = t.post_process(t._call_one("hello", None, False), t._call_one("world", None, False))
        b = t.prepare_for_model(ids, ids[:2], padding="max_length", max_length=12)
        c = t.prepare_for_model(ids * 5, truncation=True, max_length=6, stride=2)
        d = t.prepare_for_model(ids, add_special_tokens=False, padding="left", max_length=9)
        out.append([enc_fields(e) for e in (a, b, c, d)])
    assert len(out[1][1][0]) == 12
    return out[1], out[0]


ROUTE_TWINS = {
    "test_tokenizer.py::test_encoding_offsets_path": _encoding_offsets_path,
    "test_tokenizer.py::test_encode_batch_to_encoding_matches_single": _encode_batch_to_encoding_matches_single,
    "test_api_longtail.py::test_encode_with_truncation_and_stride": _encode_with_truncation_and_stride,
    "test_api_longtail.py::test_encode_batch_pairs": _encode_batch_pairs,
    "test_api_longtail.py::test_from_buffer_and_batch_encode_plus": _from_buffer_and_batch_encode_plus,
    "test_tokenizer.py::test_prepare_for_model, post_process": _post_process_and_prepare_for_model,
}


@pytest.mark.parametrize("name", list(ROUTE_TWINS))
def test_encoding_route_twin(name):
    jt, pt = pair()
    port_out, jax_out = ROUTE_TWINS[name](jt, pt)
    assert port_out == jax_out


def test_offsets_of_every_layout_equal_jax():
    """The offsets route through the native word boundaries
    (``split_words``) and through the Python pre-tokenizer: both packages
    equal on every text, with and without a prefix space."""
    import json

    for aps in (False, True):
        j = json.loads(trained_tokenizer_json())
        j["pre_tokenizer"] = {"type": "ByteLevel", "add_prefix_space": aps}
        jt, pt = JaxTokenizer.from_str(json.dumps(j)), Tokenizer.from_str(json.dumps(j))
        for t in conformance_corpus():
            assert enc_fields(pt.encode_to_encoding(t)) == enc_fields(jt.encode_to_encoding(t)), t
            assert pt._pre_tokenize_fast(t) == pt.pre_tokenizer.pre_tokenize(t), t


# ---------------------------------------------------------------------------
# tests/test_aux.py::test_batch_encoding_dict_api


def test_batch_encoding_dict_api():
    def run(cls, E):
        encs = [E.Encoding.from_ids([1, 2], ["a", "b"]), E.Encoding.from_ids([3], ["c"])]
        be = cls(encs, True, True, False, True)
        assert be.keys() == ["input_ids", "attention_mask", "token_type_ids", "special_tokens_mask"]
        assert be.to_dict()["input_ids"] == [[1, 2], [3]] == be["input_ids"]
        assert len(be) == 2 and be[0].ids == [1, 2]
        assert be.input_ids_as_numpy()[0].dtype.name == "uint32"
        with pytest.raises(IndexError):
            be[2]
        return be.to_dict(), [a.tolist() for a in be.attention_mask_as_numpy()]

    assert run(BatchEncoding, PE) == run(JaxBatchEncoding, JE)

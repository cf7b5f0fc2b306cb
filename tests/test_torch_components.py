"""Every normalizer, pre-tokenizer and decoder of the port against the JAX
package's on the same strings, exactly: built by each package's parser from
the same tokenizer.json fragment, or constructed alike where the parser
cannot express the case.  The inputs are those of
``tests/test_core_components.py`` and the conformance corpus."""

import json

import pytest

from helpers import SAMPLE_TEXT, conformance_corpus

jax = pytest.importorskip("jax")

from complexity_tokenizer_tpu.core import decoders as JD  # noqa: E402
from complexity_tokenizer_tpu.core import normalizers as JN  # noqa: E402
from complexity_tokenizer_tpu.core import pretokenizers as JPT  # noqa: E402
from complexity_tokenizer_tpu.hf import parsing  # noqa: E402
from complexity_tokenizer_tpu_torch.core import decoders as D  # noqa: E402
from complexity_tokenizer_tpu_torch.core import normalizers as N  # noqa: E402
from complexity_tokenizer_tpu_torch.core import pretokenizers as PT  # noqa: E402
from complexity_tokenizer_tpu_torch.hf import loading  # noqa: E402

STRINGS = conformance_corpus() + [
    SAMPLE_TEXT, "é", "HELLO World", "café", "naïve", "  CAFÉ  ", "Café", "Hello世界",
    "ﬁle ﬂow", "hello world", "hello, world!", "hello123world", "Hello, world!",
    "hello_world_test", "Helloこんにちは", "hello world test", "hello! world!",
    "price $100 and $50", "abc123def456", "that's it", "I'll you've we're he'd I'm isn't",
    "a  b", "a b", " a", "a ", "a!'s", "x'ref", "1'2", "a 's", "a\n's",
    "ctrl\x00\x07chars\x7f\x9f here", "tab\tnew\nline\rret", "▁pre▁split", "[CLS] x [SEP]",
    "Ａｂｃ　全角", "ǅ ǈ ǋ title case", "İstanbul ΣΊΣΥΦΟΣ", "x" * 300,
]

def json_id(cfg) -> str:
    return json.dumps(cfg)[:60]


LLAMA3_PATTERN = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*"
    r"|\s*[\r\n]+|\s+(?!\S)|\s+"
)

NORMALIZERS = [
    {"type": "NFC"}, {"type": "NFD"}, {"type": "NFKC"}, {"type": "NFKD"},
    {"type": "Lowercase"}, {"type": "Strip"}, {"type": "StripAccents"},
    {"type": "Replace", "pattern": {"String": " "}, "content": "▁"},
    {"type": "Prepend", "prepend": "▁"},
    {"type": "BertNormalizer"},
    {"type": "BertNormalizer", "clean_text": False, "handle_chinese_chars": False,
     "strip_accents": False, "lowercase": True},
    {"type": "BertNormalizer", "strip_accents": True, "lowercase": False},
    {"type": "Precompiled", "precompiled_charsmap": "AAAA"},
    {"type": "Sequence", "normalizers": [{"type": "NFD"}, {"type": "Lowercase"},
                                         {"type": "StripAccents"}, {"type": "Strip"}]},
    {"type": "Sequence", "normalizers": [{"type": "Prepend", "prepend": "▁"},
                                         {"type": "Replace", "pattern": {"String": " "},
                                          "content": "▁"}]},
    None, {"type": "NoSuchNormalizer"}, {"type": "Sequence", "normalizers": []},
]


@pytest.mark.parametrize("cfg", NORMALIZERS, ids=json_id)
def test_normalizer_equals_jax(cfg):
    port, ref = loading.parse_normalizer(cfg), parsing.parse_normalizer(cfg)
    assert (port is None) == (ref is None)
    if port is not None:
        assert type(port).__name__ == type(ref).__name__
        assert [port.normalize(s) for s in STRINGS] == [ref.normalize(s) for s in STRINGS]


@pytest.mark.parametrize(
    "port,ref",
    [
        (N.Precompiled(charsmap=[("ﬁ", "fi"), ("ﬂ", "fl")]),
         JN.Precompiled(charsmap=[("ﬁ", "fi"), ("ﬂ", "fl")])),
        (N.Append("</w>"), JN.Append("</w>")),
        (N.BertNormalizer(strip_accents=None, lowercase=True),
         JN.BertNormalizer(strip_accents=None, lowercase=True)),
    ],
    ids=["precompiled charsmap", "append", "bert, accents follow lowercase"],
)
def test_constructed_normalizer_equals_jax(port, ref):
    assert [port.normalize(s) for s in STRINGS] == [ref.normalize(s) for s in STRINGS]


PRE_TOKENIZERS = [
    {"type": "ByteLevel", "add_prefix_space": False},
    {"type": "ByteLevel", "add_prefix_space": True, "use_regex": False},
    {"type": "Whitespace"}, {"type": "WhitespaceSplit"},
    {"type": "Metaspace", "replacement": "▁", "add_prefix_space": True},
    {"type": "Metaspace", "replacement": "_", "add_prefix_space": False},
    {"type": "Punctuation"}, {"type": "BertPreTokenizer"}, {"type": "UnicodeScripts"},
    {"type": "CharDelimiterSplit", "delimiter": "_"},
    {"type": "Digits", "individual_digits": True}, {"type": "Digits"},
    {"type": "Split", "pattern": {"Regex": r"\s"}, "behavior": "Isolated"},
    {"type": "Split", "pattern": {"Regex": "!"}, "behavior": "MergedWithPrevious"},
    {"type": "Split", "pattern": {"Regex": r"\$"}, "behavior": "MergedWithNext"},
    {"type": "Split", "pattern": {"Regex": r"\d"}, "behavior": "Contiguous"},
    {"type": "Split", "pattern": {"Regex": r"\s+"}, "behavior": "Removed"},
    {"type": "Split", "pattern": {"Regex": r"\s+"}, "behavior": "Removed", "invert": True},
    {"type": "Split", "pattern": {"Regex": "(unclosed"}, "behavior": "Isolated"},
    {"type": "Split", "pattern": {"Regex": LLAMA3_PATTERN}, "behavior": "Isolated"},
    {"type": "Sequence", "pretokenizers": [
        {"type": "Split", "pattern": {"Regex": LLAMA3_PATTERN}, "behavior": "Isolated"},
        {"type": "ByteLevel", "add_prefix_space": False, "use_regex": False}]},
    {"type": "Sequence", "pretokenizers": [{"type": "WhitespaceSplit"}, {"type": "Digits"}]},
    None, {"type": "NoSuchPreTokenizer"},
]


@pytest.mark.parametrize("cfg", PRE_TOKENIZERS, ids=json_id)
def test_pre_tokenizer_equals_jax(cfg):
    port, ref = loading.parse_pre_tokenizer(cfg), parsing.parse_pre_tokenizer(cfg)
    assert (port is None) == (ref is None)
    if port is not None:
        assert type(port).__name__ == type(ref).__name__
        assert [port.pre_tokenize(s) for s in STRINGS] == [ref.pre_tokenize(s) for s in STRINGS]


TOKEN_LISTS = [
    ["▁Hello", "▁world"], ["Hello", "##world"], ["ĠHello", "Ġworld"], ["hi</w>", "there</w>"],
    ["H", "H", "E", "<pad>", "L", "L", "O", "|", "W"], ["Hello", " ", "World"], ["_Hello_"],
    ["Hello", " ,", "world", " !", "' s"], [], ["Ã©", "Ġcaf", "Ã", "©"], ["Ā", "ĉ", "日本"],
] + [[w] for w in STRINGS[:20]]

DECODERS = [
    {"type": "ByteLevel"},
    {"type": "Metaspace", "replacement": "▁", "add_prefix_space": True},
    {"type": "Metaspace", "replacement": "_", "add_prefix_space": False},
    {"type": "WordPiece", "prefix": "##", "cleanup": True},
    {"type": "WordPiece", "cleanup": False},
    {"type": "BPE", "suffix": "</w>"},
    {"type": "CTC", "pad_token": "<pad>", "word_delimiter_token": "|"},
    {"type": "CTC"},
    {"type": "Fuse"},
    {"type": "Strip", "content": "_", "start": 1, "stop": 1},
    {"type": "Sequence", "decoders": [{"type": "Replace", "pattern": {"String": "▁"}, "content": " "},
                                      {"type": "Fuse"}, {"type": "Strip", "content": " ", "start": 1}]},
    None, {"type": "NoSuchDecoder"},
]


@pytest.mark.parametrize("cfg", DECODERS, ids=json_id)
def test_decoder_equals_jax(cfg):
    port, ref = loading.parse_decoder(cfg), parsing.parse_decoder(cfg)
    assert (port is None) == (ref is None)
    if port is not None:
        assert type(port).__name__ == type(ref).__name__
        assert [port.decode(t) for t in TOKEN_LISTS] == [ref.decode(t) for t in TOKEN_LISTS]


def test_replace_decoder_equals_jax():
    """Neither parser builds a Replace decoder (an unknown type there, also
    inside a Sequence): constructed alike."""
    port, ref = D.Replace("▁", " "), JD.Replace("▁", " ")
    assert [port.decode(t) for t in TOKEN_LISTS] == [ref.decode(t) for t in TOKEN_LISTS]


def test_split_behaviour_enum_matches_jax():
    assert [b.value for b in PT.SplitBehavior] == [b.value for b in JPT.SplitBehavior]

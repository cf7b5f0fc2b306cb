"""Components -> tokenizer.json values: the inverse of ``hf/loading``.

The forms are the reference's: a GPT2 pre-tokenizer is written as
ByteLevel, a template in tokenizer.json's array form.
"""

from __future__ import annotations

from ..core import decoders as D
from ..core import normalizers as N
from ..core import postprocessors as P
from ..core import pretokenizers as PT

__all__ = [
    "serialize_normalizer",
    "serialize_pre_tokenizer",
    "serialize_post_processor",
    "serialize_decoder",
]


def serialize_normalizer(n: N.Normalizer):
    if isinstance(n, N.NFC):
        return {"type": "NFC"}
    if isinstance(n, N.NFD):
        return {"type": "NFD"}
    if isinstance(n, N.NFKC):
        return {"type": "NFKC"}
    if isinstance(n, N.NFKD):
        return {"type": "NFKD"}
    if isinstance(n, N.Lowercase):
        return {"type": "Lowercase"}
    if isinstance(n, N.Strip):
        return {"type": "Strip"}
    if isinstance(n, N.StripAccents):
        return {"type": "StripAccents"}
    if isinstance(n, N.Replace):
        return {
            "type": "Replace",
            "pattern": {"String": n.pattern},
            "content": n.replacement,
        }
    if isinstance(n, N.Prepend):
        return {"type": "Prepend", "prepend": n.prepend}
    if isinstance(n, N.Append):
        return {"type": "Append", "append": n.append}
    if isinstance(n, N.BertNormalizer):
        return {
            "type": "BertNormalizer",
            "clean_text": n.clean_text,
            "handle_chinese_chars": n.handle_chinese_chars,
            "strip_accents": n.strip_accents,
            "lowercase": n.lowercase,
        }
    if isinstance(n, N.Precompiled):
        return {
            "type": "Precompiled",
            "precompiled_charsmap": ",".join(f"{a}:{b}" for a, b in n.charsmap),
        }
    if isinstance(n, N.Sequence):
        return {
            "type": "Sequence",
            "normalizers": [serialize_normalizer(x) for x in n.normalizers],
        }
    raise TypeError(f"unknown normalizer {n!r}")


def serialize_pre_tokenizer(pt: PT.PreTokenizer):
    if isinstance(pt, PT.ByteLevel):
        return {
            "type": "ByteLevel",
            "add_prefix_space": pt.add_prefix_space,
            "trim_offsets": True,
            "use_regex": True,
        }
    if isinstance(pt, PT.Metaspace):
        return {
            "type": "Metaspace",
            "replacement": pt.replacement,
            "add_prefix_space": pt.add_prefix_space,
        }
    if isinstance(pt, PT.Whitespace):
        return {"type": "Whitespace"}
    if isinstance(pt, PT.WhitespaceSplit):
        return {"type": "WhitespaceSplit"}
    if isinstance(pt, PT.Punctuation):
        return {"type": "Punctuation"}
    if isinstance(pt, PT.Digits):
        return {"type": "Digits", "individual_digits": pt.individual_digits}
    if isinstance(pt, PT.Split):
        return {
            "type": "Split",
            "pattern": {"Regex": pt.pattern},
            "behavior": pt.behavior.value,
            "invert": pt.invert,
        }
    if isinstance(pt, PT.GPT2):
        # written as ByteLevel, as the reference does
        return {
            "type": "ByteLevel",
            "add_prefix_space": False,
            "trim_offsets": True,
            "use_regex": True,
        }
    if isinstance(pt, PT.BertPreTokenizer):
        return {"type": "BertPreTokenizer"}
    if isinstance(pt, PT.CharDelimiterSplit):
        return {"type": "CharDelimiterSplit", "delimiter": pt.delimiter}
    if isinstance(pt, PT.UnicodeScripts):
        return {"type": "UnicodeScripts"}
    if isinstance(pt, PT.Sequence):
        return {
            "type": "Sequence",
            "pretokenizers": [serialize_pre_tokenizer(x) for x in pt.pretokenizers],
        }
    raise TypeError(f"unknown pre-tokenizer {pt!r}")


def _template_to_json(template: str):
    out = []
    for part in template.split():
        if part.startswith("$"):
            out.append({"Sequence": {"id": part[1:], "type_id": 0}})
        else:
            out.append({"SpecialToken": {"id": part, "type_id": 0}})
    return out


def serialize_post_processor(pp: P.PostProcessor, special_tokens=None):
    if isinstance(pp, P.TemplateProcessing):
        return {
            "type": "TemplateProcessing",
            "single": _template_to_json(pp.single),
            "pair": _template_to_json(pp.pair) if pp.pair is not None else None,
            "special_tokens": [
                {"id": tok, "ids": [tid], "tokens": [tok]}
                for tok, tid in pp.special_tokens
            ],
        }
    if isinstance(pp, P.RobertaProcessing):
        return {
            "type": "RobertaProcessing",
            "sep": [pp.eos[0], pp.eos[1]],
            "cls": [pp.bos[0], pp.bos[1]],
            "trim_offsets": True,
            "add_prefix_space": pp.add_prefix_space,
        }
    if isinstance(pp, P.BertProcessing):
        return {
            "type": "BertProcessing",
            "sep": [pp.sep[0], pp.sep[1]],
            "cls": [pp.cls[0], pp.cls[1]],
        }
    return None


def serialize_decoder(d: D.Decoder):
    if isinstance(d, D.ByteLevel):
        return {"type": "ByteLevel"}
    if isinstance(d, D.Metaspace):
        return {
            "type": "Metaspace",
            "replacement": d.replacement,
            "add_prefix_space": d.add_prefix_space,
        }
    if isinstance(d, D.WordPiece):
        return {"type": "WordPiece", "prefix": d.prefix, "cleanup": d.cleanup}
    if isinstance(d, D.BPEDecoder):
        return {"type": "BPE", "suffix": d.suffix}
    if isinstance(d, D.Replace):
        return {"type": "Replace", "pattern": d.pattern, "content": d.replacement}
    if isinstance(d, D.CTC):
        return {
            "type": "CTC",
            "pad_token": d.pad_token,
            "word_delimiter_token": d.word_delimiter_token,
        }
    if isinstance(d, D.Fuse):
        return {"type": "Fuse"}
    if isinstance(d, D.Strip):
        return {
            "type": "Strip",
            "content": d.content,
            "start": d.start,
            "stop": d.stop,
        }
    if isinstance(d, D.Sequence):
        return {
            "type": "Sequence",
            "decoders": [serialize_decoder(x) for x in d.decoders],
        }
    raise TypeError(f"unknown decoder {d!r}")

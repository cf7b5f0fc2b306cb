"""Codepoint classes: the GPT-2 pre-split's, and the predicates of the
other normalizers and pre-tokenizers.

One dense ``[0x110000]`` uint8 table indexed by codepoint drives both the
host scanner (``core/pretokenizers.py``) and the device pre-split
(``ops/presplit.py``), which gathers from it on the card.

LETTER / NUMBER are the Unicode general categories L* / N* (regex
``\\p{L}`` / ``\\p{N}``); WS is the Unicode ``White_Space`` property
(regex ``\\s``); everything else is OTHER.

The predicates follow the reference exactly: punctuation is its custom
ranges plus ASCII punctuation; the CJK ranges come in two variants (the
BERT pre-tokenizer's and the BERT normalizer's, which differ in the last
extension ranges); combining marks are its explicit ranges, not general
category M; control characters exclude tab, newline and carriage return;
scripts are its simplified buckets, first match wins.
"""

from __future__ import annotations

import functools
import unicodedata

import numpy as np

__all__ = [
    "MAX_CP",
    "CL_OTHER",
    "CL_WS",
    "CL_LETTER",
    "CL_NUMBER",
    "gpt2_class_table",
    "whitespace_set",
    "is_whitespace",
    "is_punctuation",
    "is_cjk_pretok",
    "is_cjk_bert",
    "is_combining_mark",
    "is_control_char",
    "get_unicode_script",
    "SCRIPT_COMMON",
]

MAX_CP = 0x110000

CL_OTHER = 0
CL_WS = 1
CL_LETTER = 2
CL_NUMBER = 3

_WHITESPACE_CPS = (
    list(range(0x09, 0x0E))
    + [0x20, 0x85, 0xA0, 0x1680]
    + list(range(0x2000, 0x200B))
    + [0x2028, 0x2029, 0x202F, 0x205F, 0x3000]
)


@functools.lru_cache(maxsize=None)
def gpt2_class_table() -> np.ndarray:
    """[MAX_CP] uint8 with CL_* values for the GPT-2 pre-split regex.

    Built in memory from ``unicodedata`` (about a second, once per
    process); nothing is cached on disk."""
    cat = unicodedata.category
    majors = {"L": CL_LETTER, "N": CL_NUMBER}
    tab = np.fromiter(
        (majors.get(cat(chr(cp))[0], CL_OTHER) for cp in range(MAX_CP)),
        dtype=np.uint8,
        count=MAX_CP,
    )
    tab[np.array(_WHITESPACE_CPS)] = CL_WS
    return tab


@functools.lru_cache(maxsize=None)
def whitespace_set() -> frozenset[str]:
    """Unicode White_Space chars (rust ``char::is_whitespace`` / regex ``\\s``)."""
    return frozenset(chr(c) for c in _WHITESPACE_CPS)


def is_whitespace(ch: str) -> bool:
    return ch in whitespace_set()


def _in_ranges(cp: int, ranges: list[tuple[int, int]]) -> bool:
    return any(lo <= cp <= hi for lo, hi in ranges)


_PUNCT_RANGES = [
    (0x0021, 0x002F),
    (0x003A, 0x0040),
    (0x005B, 0x0060),
    (0x007B, 0x007E),
    (0x00A1, 0x00BF),
    (0x2000, 0x206F),
    (0x2E00, 0x2E7F),
    (0x3000, 0x303F),
]

# the BERT pre-tokenizer's CJK ranges
_CJK_RANGES_PRETOK = [
    (0x4E00, 0x9FFF),
    (0x3400, 0x4DBF),
    (0x20000, 0x2A6DF),
    (0x2A700, 0x2B73F),
    (0x2B740, 0x2B81F),
    (0x2B820, 0x2CEAF),
    (0x2CEB0, 0x2EBEF),
    (0x30000, 0x3134F),
    (0xF900, 0xFAFF),
    (0x2F800, 0x2FA1F),
]

# the BERT normalizer's CJK ranges
_CJK_RANGES_BERT = [
    (0x4E00, 0x9FFF),
    (0x3400, 0x4DBF),
    (0x20000, 0x2A6DF),
    (0x2A700, 0x2B73F),
    (0x2B740, 0x2B81F),
    (0x2B820, 0x2CEAF),
    (0xF900, 0xFAFF),
    (0x2F800, 0x2FA1F),
]

_COMBINING_RANGES = [
    (0x0300, 0x036F),
    (0x1AB0, 0x1AFF),
    (0x1DC0, 0x1DFF),
    (0x20D0, 0x20FF),
    (0xFE20, 0xFE2F),
]


def is_unicode_punctuation(ch: str) -> bool:
    return _in_ranges(ord(ch), _PUNCT_RANGES)


def is_ascii_punctuation(ch: str) -> bool:
    cp = ord(ch)
    return 0x21 <= cp <= 0x2F or 0x3A <= cp <= 0x40 or 0x5B <= cp <= 0x60 or 0x7B <= cp <= 0x7E


def is_punctuation(ch: str) -> bool:
    return is_ascii_punctuation(ch) or is_unicode_punctuation(ch)


def is_cjk_pretok(ch: str) -> bool:
    return _in_ranges(ord(ch), _CJK_RANGES_PRETOK)


def is_cjk_bert(ch: str) -> bool:
    return _in_ranges(ord(ch), _CJK_RANGES_BERT)


def is_combining_mark(ch: str) -> bool:
    return _in_ranges(ord(ch), _COMBINING_RANGES)


def is_control_char(ch: str) -> bool:
    """Control chars excluding tab, newline and carriage return."""
    if ch in ("\t", "\n", "\r"):
        return False
    cp = ord(ch)
    return cp <= 0x001F or 0x007F <= cp <= 0x009F


# simplified script buckets
SCRIPT_UNKNOWN = 0
SCRIPT_LATIN = 1
SCRIPT_GREEK = 2
SCRIPT_CYRILLIC = 3
SCRIPT_ARABIC = 4
SCRIPT_HEBREW = 5
SCRIPT_HAN = 6
SCRIPT_HIRAGANA = 7
SCRIPT_KATAKANA = 8
SCRIPT_HANGUL = 9
SCRIPT_THAI = 10
SCRIPT_COMMON = 11

_SCRIPT_RANGES = [
    ((0x0041, 0x007A), SCRIPT_LATIN),
    ((0x00C0, 0x024F), SCRIPT_LATIN),
    ((0x1E00, 0x1EFF), SCRIPT_LATIN),
    ((0x0370, 0x03FF), SCRIPT_GREEK),
    ((0x1F00, 0x1FFF), SCRIPT_GREEK),
    ((0x0400, 0x04FF), SCRIPT_CYRILLIC),
    ((0x0500, 0x052F), SCRIPT_CYRILLIC),
    ((0x0600, 0x06FF), SCRIPT_ARABIC),
    ((0x0750, 0x077F), SCRIPT_ARABIC),
    ((0x08A0, 0x08FF), SCRIPT_ARABIC),
    ((0x0590, 0x05FF), SCRIPT_HEBREW),
    ((0x4E00, 0x9FFF), SCRIPT_HAN),
    ((0x3400, 0x4DBF), SCRIPT_HAN),
    ((0x20000, 0x2A6DF), SCRIPT_HAN),
    ((0x3040, 0x309F), SCRIPT_HIRAGANA),
    ((0x30A0, 0x30FF), SCRIPT_KATAKANA),
    ((0x31F0, 0x31FF), SCRIPT_KATAKANA),
    ((0xAC00, 0xD7AF), SCRIPT_HANGUL),
    ((0x1100, 0x11FF), SCRIPT_HANGUL),
    ((0x3130, 0x318F), SCRIPT_HANGUL),
    ((0x0E00, 0x0E7F), SCRIPT_THAI),
    ((0x0000, 0x0040), SCRIPT_COMMON),
    ((0x005B, 0x0060), SCRIPT_COMMON),
    ((0x007B, 0x00BF), SCRIPT_COMMON),
    ((0x2000, 0x206F), SCRIPT_COMMON),
    ((0x3000, 0x303F), SCRIPT_COMMON),
]


def get_unicode_script(ch: str) -> int:
    """The first bucket of ``_SCRIPT_RANGES`` that holds ``ch`` (the order
    matters where ranges overlap), else ``SCRIPT_UNKNOWN``."""
    cp = ord(ch)
    for (lo, hi), script in _SCRIPT_RANGES:
        if lo <= cp <= hi:
            return script
    return SCRIPT_UNKNOWN

"""Pre-tokenizers (host tier): the GPT-2 split with ByteLevel, and every
other variant the loader builds.

The GPT-2 split is a hand-written leftmost-first scanner implementing the
simplified (no-lookahead) pattern literally::

    's|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+

It is the oracle of the device pre-split (``ops/presplit.py``) and cuts
over-long texts at word boundaries in ``ops/pipeline.py``.  Only
``ByteLevel`` runs on the native and device tiers; the others run on the
host oracle.  ``Split`` compiles its pattern with the ``regex`` module,
imported where a pattern is compiled.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from enum import Enum

from ..utils.bytelevel import encode_bytes
from ..utils.unicode_tables import (
    CL_WS,
    SCRIPT_COMMON,
    get_unicode_script,
    gpt2_class_table,
    is_cjk_pretok,
    is_punctuation,
    whitespace_set,
)

__all__ = [
    "PreTokenizer",
    "SplitBehavior",
    "ByteLevel",
    "Whitespace",
    "WhitespaceSplit",
    "Metaspace",
    "Punctuation",
    "Digits",
    "Split",
    "GPT2",
    "BertPreTokenizer",
    "CharDelimiterSplit",
    "UnicodeScripts",
    "Sequence",
    "gpt2_split_spans",
]

_CONTR2_NEXT = frozenset("stmd")


def gpt2_split_spans(text: str) -> list[tuple[int, int]]:
    """Leftmost-first matches of the simplified GPT-2 pattern, as char spans.

    The alternation order is literal: contractions first, then
    `` ?\\p{L}+``, `` ?\\p{N}+``, `` ?[^\\s\\p{L}\\p{N}]+``, ``\\s+``.  The
    four classes partition Unicode, so the matches tile the string.
    """
    cls = gpt2_class_table()
    n = len(text)
    c = [cls[ord(ch)] for ch in text]
    spans = []
    i = 0
    while i < n:
        ch = text[i]
        # contractions (lowercase ASCII literals)
        if ch == "'" and i + 1 < n:
            if text[i + 1] in _CONTR2_NEXT:
                spans.append((i, i + 2))
                i += 2
                continue
            if i + 2 < n and text[i + 1 : i + 3] in ("re", "ve", "ll"):
                spans.append((i, i + 3))
                i += 3
                continue
        # optional leading space + greedy class run
        j = i
        if ch == " " and j + 1 < n and c[j + 1] != CL_WS:
            j += 1
        k = c[j]
        if k != CL_WS:
            e = j
            while e < n and c[e] == k:
                e += 1
            spans.append((i, e))
            i = e
            continue
        # \s+ (greedy)
        e = i
        while e < n and c[e] == CL_WS:
            e += 1
        spans.append((i, e))
        i = e
    return spans


class PreTokenizer:
    def pre_tokenize(self, text: str) -> list[str]:
        raise NotImplementedError

    def __eq__(self, other):
        return type(self) is type(other) and self.__dict__ == other.__dict__

    def __repr__(self):
        args = ", ".join(f"{k}={v!r}" for k, v in self.__dict__.items())
        return f"{type(self).__name__}({args})"


class SplitBehavior(str, Enum):
    REMOVED = "Removed"
    ISOLATED = "Isolated"
    MERGED_WITH_PREVIOUS = "MergedWithPrevious"
    MERGED_WITH_NEXT = "MergedWithNext"
    CONTIGUOUS = "Contiguous"


def _split_on(text: str, is_sep) -> list[str]:
    """Runs of chars between separators (``is_sep(ch)``), empties dropped."""
    words, cur = [], []
    for ch in text:
        if is_sep(ch):
            if cur:
                words.append("".join(cur))
                cur = []
        else:
            cur.append(ch)
    if cur:
        words.append("".join(cur))
    return words


@dataclass(eq=False)
class ByteLevel(PreTokenizer):
    """GPT-2 split + byte->unicode alphabet encoding: optional prefix
    space, regex matches, each match's UTF-8 bytes mapped through the
    byte-level alphabet; empty results dropped.  The split always runs, as
    in the JAX package, whose loader ignores ``use_regex``."""

    add_prefix_space: bool = False

    def pre_tokenize(self, text: str) -> list[str]:
        if self.add_prefix_space and text and not text.startswith(" "):
            text = " " + text
        words = []
        for a, b in gpt2_split_spans(text):
            encoded = encode_bytes(text[a:b].encode("utf-8"))
            if encoded:
                words.append(encoded)
        return words


class Whitespace(PreTokenizer):
    """Split on White_Space runs, empties dropped."""

    def pre_tokenize(self, text: str) -> list[str]:
        return _split_on(text, whitespace_set().__contains__)


class WhitespaceSplit(Whitespace):
    """The same observable behaviour as :class:`Whitespace`."""


@dataclass(eq=False)
class Metaspace(PreTokenizer):
    replacement: str = "\u2581"
    add_prefix_space: bool = True

    def pre_tokenize(self, text: str) -> list[str]:
        if self.add_prefix_space:
            text = self.replacement + text
        text = text.replace(" ", self.replacement)
        ws = whitespace_set()
        return _split_on(text, lambda ch: ch in ws and ch != self.replacement)


class Punctuation(PreTokenizer):
    """Each punctuation char a word of its own, between the runs of the
    others."""

    def pre_tokenize(self, text: str) -> list[str]:
        words, cur = [], []
        for ch in text:
            if is_punctuation(ch):
                if cur:
                    words.append("".join(cur))
                    cur = []
                words.append(ch)
            else:
                cur.append(ch)
        if cur:
            words.append("".join(cur))
        return words


@dataclass(eq=False)
class Digits(PreTokenizer):
    individual_digits: bool = False

    def pre_tokenize(self, text: str) -> list[str]:
        words, cur = [], []
        in_digits = False
        for ch in text:
            is_digit = ch.isascii() and ch.isdigit()
            if is_digit != in_digits:
                if cur:
                    words.append("".join(cur))
                    cur = []
                in_digits = is_digit
            if is_digit and self.individual_digits:
                if cur:
                    words.append("".join(cur))
                    cur = []
                words.append(ch)
            else:
                cur.append(ch)
        if cur:
            words.append("".join(cur))
        return words


@functools.lru_cache(maxsize=256)
def _compile_pattern(pattern: str):
    """A user pattern compiled with the ``regex`` module (rust-regex
    syntax such as ``\\p{L}`` and ``(?i:...)``), or None when it does not
    compile."""
    import regex

    for flags in (regex.VERSION1, 0):
        try:
            return regex.compile(pattern, flags)
        except regex.error:
            pass
    return None


@dataclass(eq=False)
class Split(PreTokenizer):
    """Regex split with five behaviours; ``invert`` applies to ``REMOVED``
    (it keeps the text between matches instead of the matches)."""

    pattern: str = ""
    behavior: SplitBehavior = SplitBehavior.REMOVED
    invert: bool = False

    def pre_tokenize(self, text: str) -> list[str]:
        rx = _compile_pattern(self.pattern)
        if rx is None:
            return [text]
        matches = [(m.start(), m.end()) for m in rx.finditer(text)]
        if not matches:
            return [text]
        result: list[str] = []
        last_end = 0
        b = self.behavior
        if b == SplitBehavior.REMOVED:
            for s, e in matches:
                if self.invert:
                    if s > last_end:
                        result.append(text[last_end:s])
                else:
                    result.append(text[s:e])
                last_end = e
            if self.invert and last_end < len(text):
                result.append(text[last_end:])
        elif b == SplitBehavior.ISOLATED:
            for s, e in matches:
                if s > last_end:
                    result.append(text[last_end:s])
                result.append(text[s:e])
                last_end = e
            if last_end < len(text):
                result.append(text[last_end:])
        elif b == SplitBehavior.MERGED_WITH_PREVIOUS:
            for s, e in matches:
                if s > last_end:
                    result.append(text[last_end:s] + text[s:e])
                elif result:
                    result[-1] = result[-1] + text[s:e]
                else:
                    result.append(text[s:e])
                last_end = e
            if last_end < len(text):
                result.append(text[last_end:])
        elif b == SplitBehavior.MERGED_WITH_NEXT:
            pending = None
            for s, e in matches:
                if s > last_end:
                    before = text[last_end:s]
                    result.append(pending + before if pending is not None else before)
                elif pending is not None:
                    result.append(pending)
                pending = text[s:e]
                last_end = e
            if last_end < len(text):
                remaining = text[last_end:]
                result.append(pending + remaining if pending is not None else remaining)
            elif pending is not None:
                result.append(pending)
        elif b == SplitBehavior.CONTIGUOUS:
            current = ""
            for s, e in matches:
                if s > last_end:
                    if current:
                        result.append(current)
                        current = ""
                    result.append(text[last_end:s])
                current += text[s:e]
                last_end = e
            if current:
                result.append(current)
            if last_end < len(text):
                result.append(text[last_end:])
        return [w for w in result if w]


class GPT2(PreTokenizer):
    """The GPT-2 split's matches as they are (no byte-level alphabet)."""

    def pre_tokenize(self, text: str) -> list[str]:
        return [text[a:b] for a, b in gpt2_split_spans(text)]


class BertPreTokenizer(PreTokenizer):
    """Whitespace split, with punctuation and CJK chars isolated."""

    def pre_tokenize(self, text: str) -> list[str]:
        ws = whitespace_set()
        words, cur = [], []
        for ch in text:
            if ch in ws:
                if cur:
                    words.append("".join(cur))
                    cur = []
            elif is_cjk_pretok(ch) or is_punctuation(ch):
                if cur:
                    words.append("".join(cur))
                    cur = []
                words.append(ch)
            else:
                cur.append(ch)
        if cur:
            words.append("".join(cur))
        return words


@dataclass(eq=False)
class CharDelimiterSplit(PreTokenizer):
    delimiter: str = " "

    def pre_tokenize(self, text: str) -> list[str]:
        return [s for s in text.split(self.delimiter) if s]


class UnicodeScripts(PreTokenizer):
    """Runs of one (simplified) script; common chars join the run they are
    in, whitespace ends a run."""

    def pre_tokenize(self, text: str) -> list[str]:
        ws = whitespace_set()
        words, cur = [], []
        current = None
        for ch in text:
            if ch in ws:
                if cur:
                    words.append("".join(cur))
                    cur = []
                    current = None
                continue
            script = get_unicode_script(ch)
            if current is None or current == script or script == SCRIPT_COMMON:
                cur.append(ch)
                if current is None and script != SCRIPT_COMMON:
                    current = script
            else:
                if cur:
                    words.append("".join(cur))
                cur = [ch]
                current = script
        if cur:
            words.append("".join(cur))
        return words


@dataclass(eq=False)
class Sequence(PreTokenizer):
    """Each pre-tokenizer in turn over every word of the one before."""

    pretokenizers: list = field(default_factory=list)

    def pre_tokenize(self, text: str) -> list[str]:
        words = [text]
        for pt in self.pretokenizers:
            words = [w for word in words for w in pt.pre_tokenize(word)]
        return words

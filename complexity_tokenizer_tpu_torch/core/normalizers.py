"""Text normalizers (host tier), each a pure function of its settings.

Unicode normalization is delegated to CPython's ``unicodedata`` (the same
Unicode algorithm as the reference's ``unicode-normalization`` crate).  The
four Unicode forms are the identity on pure-ASCII text, which
``tokenizer.py`` uses to skip ASCII rows (``UNICODE_FORMS``); no other
normalizer is (Lowercase, Replace, Prepend and Strip change ASCII text).
"""

from __future__ import annotations

import unicodedata
from dataclasses import dataclass, field

from ..utils.unicode_tables import (
    is_cjk_bert,
    is_combining_mark,
    is_control_char,
    whitespace_set,
)

__all__ = [
    "Normalizer",
    "NFC",
    "NFD",
    "NFKC",
    "NFKD",
    "UNICODE_FORMS",
    "Lowercase",
    "Strip",
    "StripAccents",
    "Replace",
    "Prepend",
    "Append",
    "BertNormalizer",
    "Precompiled",
    "Sequence",
]


class Normalizer:
    """Base class; subclasses implement :meth:`normalize`."""

    def normalize(self, text: str) -> str:
        raise NotImplementedError

    def __eq__(self, other):
        return type(self) is type(other) and self.__dict__ == other.__dict__

    def __repr__(self):
        args = ", ".join(f"{k}={v!r}" for k, v in self.__dict__.items())
        return f"{type(self).__name__}({args})"


class _UnicodeForm(Normalizer):
    form = ""

    def normalize(self, text: str) -> str:
        return unicodedata.normalize(self.form, text)


class NFC(_UnicodeForm):
    form = "NFC"


class NFD(_UnicodeForm):
    form = "NFD"


class NFKC(_UnicodeForm):
    form = "NFKC"


class NFKD(_UnicodeForm):
    form = "NFKD"


UNICODE_FORMS = (NFC, NFD, NFKC, NFKD)


class Lowercase(Normalizer):
    def normalize(self, text: str) -> str:
        return text.lower()


class Strip(Normalizer):
    """Trim leading and trailing White_Space (rust ``str::trim``)."""

    def normalize(self, text: str) -> str:
        ws = whitespace_set()
        start, end = 0, len(text)
        while start < end and text[start] in ws:
            start += 1
        while end > start and text[end - 1] in ws:
            end -= 1
        return text[start:end]


def _strip_accents(text: str) -> str:
    """NFD, then drop the reference's combining-mark ranges."""
    return "".join(c for c in unicodedata.normalize("NFD", text) if not is_combining_mark(c))


class StripAccents(Normalizer):
    def normalize(self, text: str) -> str:
        return _strip_accents(text)


@dataclass(eq=False)
class Replace(Normalizer):
    pattern: str
    replacement: str

    def normalize(self, text: str) -> str:
        # literal substring replacement (rust str::replace), not a regex
        return text.replace(self.pattern, self.replacement)


@dataclass(eq=False)
class Prepend(Normalizer):
    prepend: str

    def normalize(self, text: str) -> str:
        return self.prepend + text


@dataclass(eq=False)
class Append(Normalizer):
    append: str

    def normalize(self, text: str) -> str:
        return text + self.append


@dataclass(eq=False)
class BertNormalizer(Normalizer):
    """clean_text, CJK spacing, NFC, accents (by default when lowercasing),
    lowercase: in the reference's order."""

    clean_text: bool = True
    handle_chinese_chars: bool = True
    strip_accents: bool | None = None
    lowercase: bool = True

    def normalize(self, text: str) -> str:
        result = text
        if self.clean_text:
            ws = whitespace_set()
            result = "".join(
                " " if c in ws else c for c in result if not is_control_char(c)
            )
        if self.handle_chinese_chars:
            result = "".join(f" {c} " if is_cjk_bert(c) else c for c in result)
        result = unicodedata.normalize("NFC", result)
        should_strip = self.strip_accents if self.strip_accents is not None else self.lowercase
        if should_strip:
            result = _strip_accents(result)
        if self.lowercase:
            result = result.lower()
        return result


@dataclass(eq=False)
class Precompiled(Normalizer):
    """Sequential literal replacements from a charsmap."""

    charsmap: list = field(default_factory=list)

    def normalize(self, text: str) -> str:
        result = text
        for frm, to in self.charsmap:
            result = result.replace(frm, to)
        return result


@dataclass(eq=False)
class Sequence(Normalizer):
    normalizers: list = field(default_factory=list)

    def normalize(self, text: str) -> str:
        result = text
        for n in self.normalizers:
            result = n.normalize(result)
        return result

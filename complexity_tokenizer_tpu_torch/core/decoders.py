"""Decoders: token strings -> text (host tier).

``ByteLevel`` reverses the byte-level alphabet; its batch form also runs
in the native runtime (``native.NativeDecoder``) and on the device
(``ops/decode.py``, kernel K7), which these host versions are the oracle
of.  The others run on the host only.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..utils.bytelevel import unicode_to_bytes

__all__ = [
    "Decoder",
    "ByteLevel",
    "Metaspace",
    "WordPiece",
    "BPEDecoder",
    "Replace",
    "CTC",
    "Fuse",
    "Strip",
    "Sequence",
    "token_bytes",
]

# the cleanup of the WordPiece decoder
_WORDPIECE_CLEANUP = (
    (" .", "."), (" ,", ","), (" !", "!"), (" ?", "?"), (" :", ":"), (" ;", ";"),
    (" '", "'"), ("' ", "'"),
)


def token_bytes(token: str) -> bytes:
    """The raw bytes of one token string: each byte-level alphabet char
    gives its byte, any other ASCII char itself, and other chars
    nothing."""
    dec = unicode_to_bytes()
    out = bytearray()
    for c in token:
        b = dec.get(c)
        if b is not None:
            out.append(b)
        elif c.isascii():
            out.append(ord(c))
    return bytes(out)


class Decoder:
    def decode(self, tokens: list[str]) -> str:
        raise NotImplementedError

    def __eq__(self, other):
        return type(self) is type(other) and self.__dict__ == other.__dict__


class ByteLevel(Decoder):
    """The byte-level alphabet reversed, then a lossy UTF-8 decode."""

    def decode(self, tokens: list[str]) -> str:
        return token_bytes("".join(tokens)).decode("utf-8", errors="replace")


@dataclass(eq=False)
class Metaspace(Decoder):
    replacement: str = "▁"
    add_prefix_space: bool = True

    def decode(self, tokens: list[str]) -> str:
        result = "".join(tokens).replace(self.replacement, " ")
        if self.add_prefix_space and result.startswith(" "):
            result = result[1:]
        return result


@dataclass(eq=False)
class WordPiece(Decoder):
    prefix: str = "##"
    cleanup: bool = True

    def decode(self, tokens: list[str]) -> str:
        result = ""
        for token in tokens:
            if token.startswith(self.prefix):
                result += token[len(self.prefix) :]
            else:
                if result:
                    result += " "
                result += token
        if self.cleanup:
            for a, b in _WORDPIECE_CLEANUP:
                result = result.replace(a, b)
        return result


@dataclass(eq=False)
class BPEDecoder(Decoder):
    """End-of-word-suffix BPE: the suffix becomes a space, trailing
    White_Space is trimmed."""

    suffix: str = "</w>"

    def decode(self, tokens: list[str]) -> str:
        result = ""
        for token in tokens:
            if token.endswith(self.suffix):
                result += token[: len(token) - len(self.suffix)] + " "
            else:
                result += token
        return result.rstrip()


@dataclass(eq=False)
class Replace(Decoder):
    pattern: str = ""
    replacement: str = ""

    def decode(self, tokens: list[str]) -> str:
        return "".join(tokens).replace(self.pattern, self.replacement)


@dataclass(eq=False)
class CTC(Decoder):
    pad_token: str = "<pad>"
    word_delimiter_token: str | None = None

    def decode(self, tokens: list[str]) -> str:
        result = []
        prev = None
        for token in tokens:
            if token == self.pad_token:
                prev = None
                continue
            if self.word_delimiter_token is not None and token == self.word_delimiter_token:
                result.append(" ")
                prev = None
                continue
            if prev != token:
                result.append(token)
            prev = token
        return "".join(result)


class Fuse(Decoder):
    def decode(self, tokens: list[str]) -> str:
        return "".join(tokens)


@dataclass(eq=False)
class Strip(Decoder):
    content: str = " "
    start: int = 0
    stop: int = 0

    def decode(self, tokens: list[str]) -> str:
        result = "".join(tokens)
        for _ in range(self.start):
            if not result.startswith(self.content):
                break
            result = result[len(self.content) :]
        for _ in range(self.stop):
            if not result.endswith(self.content):
                break
            result = result[: len(result) - len(self.content)]
        return result


@dataclass(eq=False)
class Sequence(Decoder):
    decoders: list = field(default_factory=list)

    def decode(self, tokens: list[str]) -> str:
        result = list(tokens)
        for d in self.decoders:
            result = [d.decode(result)]
        return "".join(result)

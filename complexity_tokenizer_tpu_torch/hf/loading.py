"""tokenizer.json -> the parts of a byte-level BPE tokenizer this port runs.

Reads a BPE model (vocab and merges), a ByteLevel pre-tokenizer, the
normalizer and the added tokens.  Defaults follow the reference: a missing
normalizer means NFC, a missing pre-tokenizer means ``ByteLevel`` without
prefix space.  An added token's ``normalized`` flag is kept and, as in the
reference's matcher, never read when matching.  Every other setting of
those fields raises ``NotImplementedError`` naming the field; the decoder
and post-processor are not read (encode uses neither).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..core import normalizers as N
from ..core.pretokenizers import ByteLevel

__all__ = ["AddedToken", "TokenizerSpec", "parse_merges", "load_spec"]


@dataclass(frozen=True)
class AddedToken:
    content: str
    id: int
    special: bool
    normalized: bool = False


@dataclass
class TokenizerSpec:
    vocab: dict[str, int]
    merges: list[tuple[str, str]]
    normalizer: N.UnicodeNormalizer | None
    pre_tokenizer: ByteLevel
    added_tokens: list[AddedToken] = field(default_factory=list)


def parse_merges(raw_merges) -> list[tuple[str, str]]:
    """Dual-format merges: "a b" strings or ["a", "b"] arrays; entries that
    do not split on one space into two parts are dropped."""
    merges: list[tuple[str, str]] = []
    for item in raw_merges or []:
        if isinstance(item, (list, tuple)) and len(item) == 2:
            if not all(isinstance(x, str) for x in item):
                continue
            item = f"{item[0]} {item[1]}"
        if isinstance(item, str):
            parts = item.split(" ")
            if len(parts) == 2:
                merges.append((parts[0], parts[1]))
    return merges


def _normalizer(value) -> N.UnicodeNormalizer | None:
    if not isinstance(value, dict) or "type" not in value:
        return N.UnicodeNormalizer("NFC")  # the reference's default
    t = value.get("type") or ""
    if t in N.FORMS:
        return N.UnicodeNormalizer(t)
    raise NotImplementedError(f"normalizer.type={t!r}")


def _pre_tokenizer(value) -> ByteLevel:
    if not isinstance(value, dict) or "type" not in value:
        return ByteLevel(add_prefix_space=False)
    t = value.get("type") or ""
    if t != "ByteLevel":
        raise NotImplementedError(f"pre_tokenizer.type={t!r}")
    if value.get("use_regex", True) is False:
        raise NotImplementedError("pre_tokenizer.use_regex=False")
    aps = value.get("add_prefix_space", False)
    return ByteLevel(add_prefix_space=aps if isinstance(aps, bool) else False)


def _added_tokens(items) -> list[AddedToken]:
    out = []
    for tok in items or []:
        for flag in ("lstrip", "rstrip", "single_word"):
            if tok.get(flag):
                raise NotImplementedError(f"added_tokens[].{flag}=True")
        if not tok.get("content"):
            raise ValueError("added_tokens[].content is empty")
        out.append(
            AddedToken(
                str(tok["content"]),
                int(tok["id"]),
                bool(tok.get("special", False)),
                bool(tok.get("normalized", False)),
            )
        )
    return out


def load_spec(j: dict) -> TokenizerSpec:
    """Parsed tokenizer.json dict -> :class:`TokenizerSpec`."""
    model = j.get("model") or {}
    mtype = model.get("type", "BPE")
    if mtype != "BPE":
        raise NotImplementedError(f"model.type={mtype!r}")
    vocab = {str(k): int(v) for k, v in (model.get("vocab") or {}).items()}
    return TokenizerSpec(
        vocab=vocab,
        merges=parse_merges(model.get("merges")),
        normalizer=_normalizer(j.get("normalizer")),
        pre_tokenizer=_pre_tokenizer(j.get("pre_tokenizer")),
        added_tokens=_added_tokens(j.get("added_tokens")),
    )

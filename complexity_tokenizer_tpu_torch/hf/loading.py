"""tokenizer.json -> the parts of a BPE tokenizer this port runs.

Reads a BPE model (vocab and merges), the normalizer, the pre-tokenizer,
the post-processor, the decoder and the added tokens with their flags,
and infers the named special tokens (unk, bos, eos, pad, sep, cls, mask)
from the special added tokens' contents.  Defaults and fallbacks follow
the reference: a missing normalizer means NFC, a missing pre-tokenizer
``ByteLevel`` without prefix space, a missing decoder ``ByteLevel``, a
missing post-processor none; an unknown ``type`` string loads as None (no
normalizer, no pre-tokenizer, no post-processor or no decoder).
``ByteLevel``'s ``use_regex`` is not read: the GPT-2 split always runs,
as in the JAX package.  A model other than BPE raises
``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..core import decoders as D
from ..core import normalizers as N
from ..core import postprocessors as P
from ..core import pretokenizers as PT
from ..core.vocab import SpecialTokens

__all__ = [
    "AddedToken",
    "TokenizerSpec",
    "load_spec",
    "parse_decoder",
    "parse_merges",
    "parse_normalizer",
    "parse_post_processor",
    "parse_pre_tokenizer",
    "infer_special_tokens",
]


@dataclass(frozen=True)
class AddedToken:
    content: str
    id: int
    special: bool
    single_word: bool = False
    lstrip: bool = False
    rstrip: bool = False
    normalized: bool = False


@dataclass
class TokenizerSpec:
    vocab: dict[str, int]
    merges: list[tuple[str, str]]
    normalizer: N.Normalizer | None
    pre_tokenizer: PT.PreTokenizer | None
    decoder: D.Decoder | None = None
    added_tokens: list[AddedToken] = field(default_factory=list)
    post_processor: P.PostProcessor | None = None
    named_specials: SpecialTokens = field(default_factory=SpecialTokens)


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


def _get_bool(obj: dict, key: str, default: bool) -> bool:
    v = obj.get(key)
    return v if isinstance(v, bool) else default


def _first_char(value, default: str) -> str:
    return value[0] if isinstance(value, str) and value else default


def parse_normalizer(value) -> N.Normalizer | None:
    if not isinstance(value, dict) or "type" not in value:
        return N.NFC()  # the reference's default
    t = value.get("type") or ""
    simple = {
        "NFC": N.NFC, "NFD": N.NFD, "NFKC": N.NFKC, "NFKD": N.NFKD,
        "Lowercase": N.Lowercase, "Strip": N.Strip, "StripAccents": N.StripAccents,
    }
    if t in simple:
        return simple[t]()
    if t == "Replace":
        pat = value.get("pattern")
        pattern = (pat.get("String") or "") if isinstance(pat, dict) else ""
        return N.Replace(pattern=pattern, replacement=value.get("content") or "")
    if t == "Prepend":
        return N.Prepend(value.get("prepend") or "")
    if t == "Sequence":
        items = value.get("normalizers")
        parsed = [p for p in map(parse_normalizer, items) if p is not None] if isinstance(items, list) else []
        return N.Sequence(parsed) if parsed else None
    if t == "BertNormalizer":
        sa = value.get("strip_accents")
        return N.BertNormalizer(
            clean_text=_get_bool(value, "clean_text", True),
            handle_chinese_chars=_get_bool(value, "handle_chinese_chars", True),
            strip_accents=sa if isinstance(sa, bool) else None,
            lowercase=_get_bool(value, "lowercase", True),
        )
    if t == "Precompiled":
        s = value.get("precompiled_charsmap")
        return N.Precompiled(charsmap=[(s, s)] if isinstance(s, str) else [])
    return None


_SPLIT_BEHAVIORS = {
    "Isolated": PT.SplitBehavior.ISOLATED,
    "MergedWithPrevious": PT.SplitBehavior.MERGED_WITH_PREVIOUS,
    "MergedWithNext": PT.SplitBehavior.MERGED_WITH_NEXT,
    "Contiguous": PT.SplitBehavior.CONTIGUOUS,
}


def parse_pre_tokenizer(value) -> PT.PreTokenizer | None:
    if not isinstance(value, dict) or "type" not in value:
        return PT.ByteLevel(add_prefix_space=False)
    t = value.get("type") or ""
    if t == "ByteLevel":
        return PT.ByteLevel(add_prefix_space=_get_bool(value, "add_prefix_space", False))
    if t == "Metaspace":
        return PT.Metaspace(
            replacement=_first_char(value.get("replacement"), "▁"),
            add_prefix_space=_get_bool(value, "add_prefix_space", True),
        )
    simple = {
        "Whitespace": PT.Whitespace, "WhitespaceSplit": PT.WhitespaceSplit,
        "Punctuation": PT.Punctuation, "BertPreTokenizer": PT.BertPreTokenizer,
        "UnicodeScripts": PT.UnicodeScripts,
    }
    if t in simple:
        return simple[t]()
    if t == "CharDelimiterSplit":
        return PT.CharDelimiterSplit(delimiter=_first_char(value.get("delimiter"), " "))
    if t == "Digits":
        return PT.Digits(individual_digits=_get_bool(value, "individual_digits", False))
    if t == "Split":
        pat = value.get("pattern")
        return PT.Split(
            pattern=(pat.get("Regex") or "") if isinstance(pat, dict) else "",
            behavior=_SPLIT_BEHAVIORS.get(value.get("behavior") or "Removed", PT.SplitBehavior.REMOVED),
            invert=_get_bool(value, "invert", False),
        )
    if t == "Sequence":
        items = value.get("pretokenizers")
        parsed = [p for p in map(parse_pre_tokenizer, items) if p is not None] if isinstance(items, list) else []
        return PT.Sequence(parsed) if parsed else None
    return None


def parse_decoder(value) -> D.Decoder | None:
    if not isinstance(value, dict) or "type" not in value:
        return D.ByteLevel()
    t = value.get("type") or ""
    if t == "ByteLevel":
        return D.ByteLevel()
    if t == "Metaspace":
        return D.Metaspace(
            replacement=_first_char(value.get("replacement"), "▁"),
            add_prefix_space=_get_bool(value, "add_prefix_space", True),
        )
    if t == "WordPiece":
        return D.WordPiece(prefix=value.get("prefix") or "##", cleanup=_get_bool(value, "cleanup", True))
    if t == "BPE":
        return D.BPEDecoder(suffix=value.get("suffix") or "</w>")
    if t == "CTC":
        wdt = value.get("word_delimiter_token")
        return D.CTC(
            pad_token=value.get("pad_token") or "<pad>",
            word_delimiter_token=wdt if isinstance(wdt, str) else None,
        )
    if t == "Fuse":
        return D.Fuse()
    if t == "Strip":
        return D.Strip(
            content=_first_char(value.get("content"), " "),
            start=int(value.get("start") or 0),
            stop=int(value.get("stop") or 0),
        )
    if t == "Sequence":
        items = value.get("decoders")
        parsed = [p for p in map(parse_decoder, items) if p is not None] if isinstance(items, list) else []
        return D.Sequence(parsed) if parsed else None
    return None


def _template_from_array(arr) -> str:
    """A template in tokenizer.json's array form -> the template string."""
    parts = []
    for item in arr:
        if isinstance(item, dict):
            if "SpecialToken" in item:
                tid = item["SpecialToken"].get("id")
                if isinstance(tid, str):
                    parts.append(tid)
            elif "Sequence" in item:
                sid = item["Sequence"].get("id")
                if isinstance(sid, str):
                    parts.append(f"${sid}")
    return " ".join(parts)


def parse_post_processor(value, special_tokens: dict[str, int]) -> P.PostProcessor | None:
    """The post-processor; its special tokens resolve against the
    tokenizer's special added tokens (``special_tokens``: content -> id),
    not against the ids the tokenizer.json lists beside the template."""
    if not isinstance(value, dict) or "type" not in value:
        return None
    t = value.get("type") or ""
    if t == "TemplateProcessing":
        single_arr = value.get("single")
        single = _template_from_array(single_arr) if isinstance(single_arr, list) else "<s> $A </s>"
        pair_arr = value.get("pair")
        pair = _template_from_array(pair_arr) if isinstance(pair_arr, list) else None
        return P.TemplateProcessing(single=single, pair=pair, special_tokens=list(special_tokens.items()))
    if t == "RobertaProcessing":
        return P.RobertaProcessing(
            bos=("<s>", special_tokens.get("<s>", 0)),
            eos=("</s>", special_tokens.get("</s>", 2)),
            add_prefix_space=False,
        )
    if t == "BertProcessing":
        return P.BertProcessing(
            cls=("[CLS]", special_tokens.get("[CLS]", 101)),
            sep=("[SEP]", special_tokens.get("[SEP]", 102)),
        )
    return None


def infer_special_tokens(added: list[AddedToken]) -> SpecialTokens:
    """The named special tokens, by substring of each special added
    token's content, in the reference's order of tests."""
    st = SpecialTokens()
    for tok in added:
        if not tok.special:
            continue
        low = tok.content.lower()
        if "unk" in low:
            st.unk_token = tok.content
        elif low == "<s>" or "bos" in low:
            st.bos_token = tok.content
        elif low == "</s>" or "eos" in low:
            st.eos_token = tok.content
        elif "pad" in low:
            st.pad_token = tok.content
        elif "sep" in low:
            st.sep_token = tok.content
        elif "cls" in low:
            st.cls_token = tok.content
        elif "mask" in low:
            st.mask_token = tok.content
    return st


def _added_tokens(items) -> list[AddedToken]:
    out = []
    for tok in items or []:
        if not tok.get("content"):
            raise ValueError("added_tokens[].content is empty")
        out.append(
            AddedToken(
                str(tok["content"]),
                int(tok["id"]),
                bool(tok.get("special", False)),
                single_word=bool(tok.get("single_word", False)),
                lstrip=bool(tok.get("lstrip", False)),
                rstrip=bool(tok.get("rstrip", False)),
                normalized=bool(tok.get("normalized", False)),
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
    added = _added_tokens(j.get("added_tokens"))
    specials = {t.content: t.id for t in added if t.special}
    return TokenizerSpec(
        vocab=vocab,
        merges=parse_merges(model.get("merges")),
        normalizer=parse_normalizer(j.get("normalizer")),
        pre_tokenizer=parse_pre_tokenizer(j.get("pre_tokenizer")),
        decoder=parse_decoder(j.get("decoder")),
        added_tokens=added,
        post_processor=parse_post_processor(j.get("post_processor"), specials),
        named_specials=infer_special_tokens(added),
    )

"""Component wrappers with factory methods.

Each wraps one of the port's ``core`` components in ``.inner``; the
tokenizer's ``set_normalizer``, ``set_pre_tokenizer``,
``set_post_processor`` and ``set_decoder`` take a wrapper or a bare
component.
"""

from __future__ import annotations

from .core import decoders as D
from .core import normalizers as N
from .core import postprocessors as P
from .core import pretokenizers as PT

__all__ = ["Normalizer", "PreTokenizer", "PostProcessor", "Decoder"]


class Normalizer:
    def __init__(self, inner: N.Normalizer):
        self.inner = inner

    @staticmethod
    def nfc():
        return Normalizer(N.NFC())

    @staticmethod
    def nfd():
        return Normalizer(N.NFD())

    @staticmethod
    def nfkc():
        return Normalizer(N.NFKC())

    @staticmethod
    def nfkd():
        return Normalizer(N.NFKD())

    @staticmethod
    def lowercase():
        return Normalizer(N.Lowercase())

    @staticmethod
    def strip():
        return Normalizer(N.Strip())

    @staticmethod
    def strip_accents():
        return Normalizer(N.StripAccents())

    @staticmethod
    def replace(pattern: str, replacement: str):
        return Normalizer(N.Replace(pattern=pattern, replacement=replacement))

    @staticmethod
    def bert(clean_text=True, handle_chinese_chars=True, strip_accents=None, lowercase=True):
        return Normalizer(
            N.BertNormalizer(
                clean_text=clean_text,
                handle_chinese_chars=handle_chinese_chars,
                strip_accents=strip_accents,
                lowercase=lowercase,
            )
        )

    @staticmethod
    def precompiled(charsmap):
        return Normalizer(N.Precompiled(charsmap=list(charsmap)))

    @staticmethod
    def sequence(normalizers):
        return Normalizer(N.Sequence([n.inner for n in normalizers]))

    def normalize(self, text: str) -> str:
        return self.inner.normalize(text)


class PreTokenizer:
    def __init__(self, inner: PT.PreTokenizer):
        self.inner = inner

    @staticmethod
    def whitespace():
        return PreTokenizer(PT.Whitespace())

    @staticmethod
    def byte_level(add_prefix_space: bool = False):
        return PreTokenizer(PT.ByteLevel(add_prefix_space=add_prefix_space))

    @staticmethod
    def metaspace(replacement: str = "▁", add_prefix_space: bool = True):
        return PreTokenizer(
            PT.Metaspace(replacement=replacement, add_prefix_space=add_prefix_space)
        )

    @staticmethod
    def punctuation():
        return PreTokenizer(PT.Punctuation())

    @staticmethod
    def digits(individual_digits: bool = False):
        return PreTokenizer(PT.Digits(individual_digits=individual_digits))

    @staticmethod
    def gpt2():
        return PreTokenizer(PT.GPT2())

    @staticmethod
    def bert():
        return PreTokenizer(PT.BertPreTokenizer())

    @staticmethod
    def char_delimiter_split(delimiter: str):
        return PreTokenizer(PT.CharDelimiterSplit(delimiter=delimiter))

    @staticmethod
    def unicode_scripts():
        return PreTokenizer(PT.UnicodeScripts())

    @staticmethod
    def split(pattern: str, behavior: str = "Removed", invert: bool = False):
        b = {
            "Isolated": PT.SplitBehavior.ISOLATED,
            "MergedWithPrevious": PT.SplitBehavior.MERGED_WITH_PREVIOUS,
            "MergedWithNext": PT.SplitBehavior.MERGED_WITH_NEXT,
            "Contiguous": PT.SplitBehavior.CONTIGUOUS,
        }.get(behavior, PT.SplitBehavior.REMOVED)
        return PreTokenizer(PT.Split(pattern=pattern, behavior=b, invert=invert))

    @staticmethod
    def sequence(pretokenizers):
        return PreTokenizer(PT.Sequence([p.inner for p in pretokenizers]))

    def pre_tokenize(self, text: str) -> list[str]:
        return self.inner.pre_tokenize(text)


class PostProcessor:
    def __init__(self, inner: P.PostProcessor):
        self.inner = inner

    @staticmethod
    def bert(cls_token: str, cls_id: int, sep_token: str, sep_id: int):
        return PostProcessor(
            P.BertProcessing(cls=(cls_token, cls_id), sep=(sep_token, sep_id))
        )

    @staticmethod
    def roberta(bos_token, bos_id, eos_token, eos_id, add_prefix_space=False):
        return PostProcessor(
            P.RobertaProcessing(
                bos=(bos_token, bos_id),
                eos=(eos_token, eos_id),
                add_prefix_space=add_prefix_space,
            )
        )

    @staticmethod
    def template(single: str, pair: str | None = None, special_tokens=()):
        return PostProcessor(
            P.TemplateProcessing(
                single=single, pair=pair, special_tokens=list(special_tokens)
            )
        )

    def process(self, ids, pair_ids=None):
        return self.inner.process(list(ids), list(pair_ids) if pair_ids else None)

    def added_tokens_single(self) -> int:
        return self.inner.added_tokens_single()

    def added_tokens_pair(self) -> int:
        return self.inner.added_tokens_pair()


class Decoder:
    def __init__(self, inner: D.Decoder):
        self.inner = inner

    @staticmethod
    def byte_level():
        return Decoder(D.ByteLevel())

    @staticmethod
    def metaspace(replacement: str = "▁", add_prefix_space: bool = True):
        return Decoder(
            D.Metaspace(replacement=replacement, add_prefix_space=add_prefix_space)
        )

    @staticmethod
    def wordpiece(prefix: str = "##", cleanup: bool = True):
        return Decoder(D.WordPiece(prefix=prefix, cleanup=cleanup))

    @staticmethod
    def bpe(suffix: str = "</w>"):
        return Decoder(D.BPEDecoder(suffix=suffix))

    @staticmethod
    def ctc(pad_token: str = "<pad>", word_delimiter_token: str | None = None):
        return Decoder(
            D.CTC(pad_token=pad_token, word_delimiter_token=word_delimiter_token)
        )

    @staticmethod
    def fuse():
        return Decoder(D.Fuse())

    @staticmethod
    def strip(content: str = " ", start: int = 0, stop: int = 0):
        return Decoder(D.Strip(content=content, start=start, stop=stop))

    def decode(self, tokens) -> str:
        return self.inner.decode(list(tokens))

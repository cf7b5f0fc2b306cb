"""Byte-level BPE model with space-attachment word splitting, as the
reference's (models.rs:400-589) and the JAX package's
(``models/bytelevel_bpe.py``).  Unlike the Tokenizer's pipeline, this
model splits words itself: a space attaches to the FOLLOWING word, no
regex.  Its device tier is kernel K9 (``ops/stringbpe_device.py``)."""

from __future__ import annotations

from ..ops.stringbpe_device import build_string_bpe_device
from ..utils.bytelevel import bytes_to_unicode, unicode_to_bytes
from ._device import DeviceTiers
from .charbpe import string_bpe_merge, word_table

__all__ = ["ByteLevelBpeModel"]


class ByteLevelBpeModel:
    def __init__(
        self,
        vocab: dict[str, int],
        merges: list[tuple[str, str]],
        unk_token: str = "<unk>",
        add_prefix_space: bool = True,
    ):
        self.vocab = dict(vocab)
        self.vocab_r = {v: k for k, v in vocab.items()}
        self.merge_ranks = {(a, b): r for r, (a, b) in enumerate(merges)}
        self.unk_token = unk_token
        self.add_prefix_space = add_prefix_space
        self._byte_encoder = bytes_to_unicode()
        self._byte_decoder = unicode_to_bytes()
        self._tiers = DeviceTiers(lambda dev: build_string_bpe_device(self.merge_ranks, dev))
        self.last_route: str | None = None
        self.last_stats: dict = {}

    def _text_to_byte_tokens(self, text: str) -> str:
        enc = self._byte_encoder
        return "".join(enc[b] for b in text.encode("utf-8"))

    def _byte_tokens_to_text(self, tokens: str) -> str:
        dec = self._byte_decoder
        data = bytes(dec[c] for c in tokens if c in dec)
        return data.decode("utf-8", errors="replace")

    def tokenize_word(self, word: str) -> list[str]:
        if not word:
            return []
        return string_bpe_merge(list(self._text_to_byte_tokens(word)), self.merge_ranks)

    def encode(self, text: str) -> list[int]:
        unk_id = self.vocab.get(self.unk_token, 0)
        result: list[int] = []
        for word in self._split_words(text):
            for t in self.tokenize_word(word):
                result.append(self.vocab.get(t, unk_id))
        return result

    def _split_words(self, text: str) -> list[str]:
        """Space-attachment splitting (models.rs:530-556): a space attaches
        to the FOLLOWING word."""
        if self.add_prefix_space and not text.startswith(" "):
            text = " " + text
        words: list[str] = []
        current = ""
        for c in text:
            if c == " " and current:
                words.append(current)
                current = ""
            current += c
        if current:
            words.append(current)
        return words

    def encode_batch(self, texts: list[str], device=None) -> list[list[int]]:
        """Batch encode: the distinct byte-level words merged by K9 on
        ``device`` (``cuda`` unless the caller passes ``"cpu"``), then
        assembled per text; on the host where the merge table is not
        eligible or a word is over 128 bytes."""
        rows = [self._split_words(t) for t in texts]
        uniq = sorted({w for r in rows for w in r})
        sym_rows = [list(self._text_to_byte_tokens(w)) for w in uniq]
        table = word_table(self, uniq, sym_rows, device)
        return [[i for w in r for i in table[w]] for r in rows]

    def decode(self, ids) -> str:
        tokens = "".join(self.vocab_r[int(i)] for i in ids if int(i) in self.vocab_r)
        return self._byte_tokens_to_text(tokens)

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def token_to_id(self, token: str):
        return self.vocab.get(token)

    def id_to_token(self, idx: int):
        return self.vocab_r.get(idx)

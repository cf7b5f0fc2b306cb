"""WordPiece model (BERT's greedy longest match), as the reference's
(models.rs:30-142) and the JAX package's (``models/wordpiece.py``): per
word, the longest vocabulary entry at each position with the ``##``
continuation prefix; a word longer than ``max_input_chars_per_word`` is
UNK; an unmatched character emits UNK and advances one.  Its device tier is
kernel K10 (``ops/wordpiece_device.py``)."""

from __future__ import annotations

from ..ops.wordpiece_device import WordPieceDevice, build_wordpiece_tables
from ._device import DeviceTiers

__all__ = ["WordPieceModel"]


class WordPieceModel:
    def __init__(
        self,
        vocab: dict[str, int],
        continuing_subword_prefix: str = "##",
        unk_token: str = "[UNK]",
        max_input_chars_per_word: int = 100,
    ):
        self.vocab = dict(vocab)
        self.vocab_r = {v: k for k, v in vocab.items()}
        self.continuing_subword_prefix = continuing_subword_prefix
        self.unk_token = unk_token
        self.max_input_chars_per_word = max_input_chars_per_word
        self._tiers = DeviceTiers(self._build_tier)
        self.last_route: str | None = None
        self.last_stats: dict = {}

    def _build_tier(self, dev):
        tables = build_wordpiece_tables(self)
        return None if tables is None else WordPieceDevice(tables, dev)

    def tokenize_word(self, word: str) -> list[int]:
        chars = list(word)
        if len(chars) > self.max_input_chars_per_word:
            unk = self.vocab.get(self.unk_token)
            return [unk] if unk is not None else []
        tokens: list[int] = []
        start = 0
        n = len(chars)
        prefix = self.continuing_subword_prefix
        while start < n:
            end = n
            found = False
            while start < end:
                sub = "".join(chars[start:end])
                token = prefix + sub if start > 0 else sub
                tid = self.vocab.get(token)
                if tid is not None:
                    tokens.append(tid)
                    found = True
                    break
                end -= 1
            if not found:
                unk = self.vocab.get(self.unk_token)
                if unk is not None:
                    tokens.append(unk)
                start += 1
            else:
                start = end
        return tokens

    def encode(self, text: str) -> list[int]:
        out: list[int] = []
        for word in text.split():
            out.extend(self.tokenize_word(word))
        return out

    def encode_batch(self, texts: list[str], device=None) -> list[list[int]]:
        """Batch encode: the distinct words matched by K10 on ``device``
        (``cuda`` unless the caller passes ``"cpu"``), then assembled per
        text.  Poisoned words (a failed exact check) and words over 128
        characters but within the limit are tokenized on the host, as is
        every word when the vocabulary is not eligible (``last_route``)."""
        dev = self._tiers.get(device)
        rows = [t.split() for t in texts]
        uniq = sorted({w for r in rows for w in r})
        if dev is None:
            self.last_route = "host"
            table = {w: self.tokenize_word(w) for w in uniq}
            self.last_stats = {"words": len(uniq), "host": len(uniq), "poisoned": 0,
                               "over_width": 0}
        else:
            self.last_route = "device"
            table = dict(zip(uniq, dev.tokenize_words(uniq)))
            redo = dev.last_poisoned
            for i in redo:
                table[uniq[i]] = self.tokenize_word(uniq[i])
            self.last_stats = {"words": len(uniq), "host": len(redo),
                               "poisoned": len(redo) - dev.last_over_width,
                               "over_width": dev.last_over_width}
        return [[i for w in r for i in table[w]] for r in rows]

    def decode(self, ids) -> str:
        result = ""
        prefix = self.continuing_subword_prefix
        for i in ids:
            token = self.vocab_r.get(int(i))
            if token is None:
                continue
            if token.startswith(prefix):
                result += token[len(prefix) :]
            else:
                if result:
                    result += " "
                result += token
        return result

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def token_to_id(self, token: str):
        return self.vocab.get(token)

    def id_to_token(self, idx: int):
        return self.vocab_r.get(idx)

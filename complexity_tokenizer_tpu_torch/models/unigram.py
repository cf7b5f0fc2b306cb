"""Unigram model (SentencePiece's Viterbi segmentation), as the reference's
(models.rs:199-299) and the JAX package's (``models/unigram.py``): the
highest-scoring split of a text into pieces, with a single-character UNK
fallback scored ``min_score - 10``.  Its device tier is kernel K12
(``ops/unigram_device.py``)."""

from __future__ import annotations

from ..ops.unigram_device import UnigramDevice, build_unigram_tables
from ._device import DeviceTiers

__all__ = ["UnigramModel"]


class UnigramModel:
    def __init__(self, vocab: list[tuple[str, float]], unk_token: str = "<unk>"):
        self.vocab: dict[str, tuple[int, float]] = {}
        self.vocab_r: dict[int, str] = {}
        min_score = 0.0
        for idx, (token, score) in enumerate(vocab):
            self.vocab[token] = (idx, score)
            self.vocab_r[idx] = token
            min_score = min(min_score, score)
        self.unk_token = unk_token
        self.unk_id = self.vocab.get(unk_token, (0, 0.0))[0]
        self.min_score = min_score - 10.0
        # no piece is longer: the DP's candidates stop there (a longer
        # substring is in no entry, and only a single character falls back)
        self._max_len = max([len(t) for t in self.vocab] + [1])
        self._tiers = DeviceTiers(self._build_tier)
        self.last_route: str | None = None
        self.last_stats: dict = {}

    def _build_tier(self, dev):
        tables = build_unigram_tables(self)
        return None if tables is None else UnigramDevice(tables, dev)

    def tokenize(self, text: str) -> list[int]:
        """The f64 Viterbi DP of the reference: for each end, every start in
        ascending order, updated on strict improvement."""
        if not text:
            return []
        chars = list(text)
        n = len(chars)
        NEG = float("-inf")
        # best[end] = (score, prev_pos, token_id)
        best: list[tuple[float, int, int]] = [(NEG, -1, 0)] * (n + 1)
        best[0] = (0.0, -1, 0)
        for end in range(1, n + 1):
            for start in range(max(0, end - self._max_len), end):
                sub = "".join(chars[start:end])
                entry = self.vocab.get(sub)
                if entry is not None:
                    tid, score = entry
                elif end - start == 1:
                    tid, score = self.unk_id, self.min_score
                else:
                    continue
                ns = best[start][0] + score
                if ns > best[end][0]:
                    best[end] = (ns, start, tid)
        tokens = []
        pos = n
        while pos > 0:
            _, prev, tid = best[pos]
            tokens.append(tid)
            pos = prev
        tokens.reverse()
        return tokens

    def encode(self, text: str) -> list[int]:
        return self.tokenize(text)

    def encode_batch(self, texts: list[str], device=None) -> list[list[int]]:
        """Batch Viterbi: the batch's distinct texts segmented by K12 on
        ``device`` (``cuda`` unless the caller passes ``"cpu"``), each whole,
        then the rows assembled.  Poisoned texts (a decision inside the
        float32 margin of the reference's float64 DP, or a failed exact check)
        and texts over 128 characters are segmented on the host, as is every
        text when the table is not eligible (``last_route``), so the result
        is the host's, bit for bit."""
        dev = self._tiers.get(device)
        uniq = list(dict.fromkeys(texts))
        if dev is None:
            self.last_route = "host"
            segs = [self.tokenize(t) for t in uniq]
            host, poisoned, over_width = len(uniq), 0, 0
        else:
            self.last_route = "device"
            segs = dev.tokenize_texts(uniq)
            for i in dev.last_poisoned:
                segs[i] = self.tokenize(uniq[i])
            host, over_width = len(dev.last_poisoned), dev.last_over_width
            poisoned = host - over_width
        self.last_stats = {"texts": len(texts), "distinct": len(uniq), "host": host,
                           "poisoned": poisoned, "over_width": over_width}
        table = dict(zip(uniq, segs))
        return [list(table[t]) for t in texts]

    def decode(self, ids) -> str:
        return "".join(self.vocab_r[int(i)] for i in ids if int(i) in self.vocab_r)

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def token_to_id(self, token: str):
        entry = self.vocab.get(token)
        return entry[0] if entry is not None else None

    def id_to_token(self, idx: int):
        return self.vocab_r.get(idx)

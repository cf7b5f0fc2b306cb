"""Unigram trainer (SentencePiece style), the JAX package's
``trainers/unigram_trainer.py`` line for line.

Semantics match the reference's (src/trainers.rs:286-546): substring
enumeration up to max_piece_length, log-prob init from frequencies, then EM
rounds of Viterbi segmentation (E) + prune-to-shrinking-factor by expected
count (M).  ``parallel.DistributedUnigramTrainer`` runs the E-step on the
card (kernels K12 and K17).
"""

from __future__ import annotations

import math
from collections import Counter
from dataclasses import dataclass, field

from ..core import normalizers as N
from ..core import pretokenizers as PT
from ..models.unigram import UnigramModel

__all__ = ["UnigramTrainerConfig", "UnigramTrainer"]


@dataclass
class UnigramTrainerConfig:
    vocab_size: int = 8000
    special_tokens: list = field(default_factory=lambda: ["<unk>", "<s>", "</s>"])
    initial_vocab_size: int = 1_000_000
    shrinking_factor: float = 0.75
    n_iterations: int = 16
    max_piece_length: int = 16
    normalizer: object | None = field(default_factory=N.NFC)
    pre_tokenizer: object | None = field(
        default_factory=lambda: PT.Metaspace(replacement="▁", add_prefix_space=True)
    )


class UnigramTrainer:
    def __init__(self, config: UnigramTrainerConfig | None = None):
        self.config = config or UnigramTrainerConfig()
        self.vocab: list[tuple[str, float]] = []

    def _pretokenize(self, text: str) -> list[str]:
        if self.config.normalizer is not None:
            text = self.config.normalizer.normalize(text)
        if self.config.pre_tokenizer is not None:
            return self.config.pre_tokenizer.pre_tokenize(text)
        return text.split()

    def train(self, files) -> UnigramModel:
        sentences: list[str] = []
        for path in files:
            with open(path, "r", encoding="utf-8") as f:
                for line in f:
                    sentences.extend(self._pretokenize(line.rstrip("\n")))
        return self._train_from_sentences(sentences)

    def train_from_texts(self, texts) -> UnigramModel:
        sentences: list[str] = []
        for text in texts:
            sentences.extend(self._pretokenize(text))
        return self._train_from_sentences(sentences)

    train_from_iterator = train_from_texts

    def _train_from_sentences(self, sentences: list[str]) -> UnigramModel:
        cfg = self.config
        # Step 1: seed vocab = frequent substrings up to max_piece_length
        substr_freqs: Counter = Counter()
        for sentence in sentences:
            chars = list(sentence)
            L = len(chars)
            n = min(L, cfg.max_piece_length)
            for start in range(L):
                for end in range(start + 1, min(start + n, L) + 1):
                    substr_freqs["".join(chars[start:end])] += 1
        for tok in cfg.special_tokens:
            substr_freqs[tok] = 1
        items = sorted(substr_freqs.items(), key=lambda kv: -kv[1])[
            : cfg.initial_vocab_size
        ]
        total = float(sum(f for _, f in items))
        self.vocab = [(t, math.log(f / total)) for t, f in items]

        # Step 2: EM prune loop
        sentence_freqs = Counter(sentences)  # dedup: segment unique sentences once
        for _ in range(cfg.n_iterations):
            if len(self.vocab) <= cfg.vocab_size:
                break
            expected = self._expected_counts(sentence_freqs)
            target_size = max(
                int(len(self.vocab) * cfg.shrinking_factor), cfg.vocab_size
            )
            scored = sorted(
                ((t, expected.get(i, 0.0)) for i, (t, _) in enumerate(self.vocab)),
                key=lambda kv: -kv[1],
            )[:target_size]
            total_count = float(sum(c for _, c in scored))
            self.vocab = [
                (t, math.log(c / total_count) if total_count > 0 and c > 0 else -100.0)
                for t, c in scored
            ]
        for tok in cfg.special_tokens:
            if not any(t == tok for t, _ in self.vocab):
                self.vocab.append((tok, -100.0))
        return UnigramModel(list(self.vocab), "<unk>")

    def _expected_counts(self, sentence_freqs: Counter) -> dict[int, float]:
        """E-step: expected piece counts from Viterbi segmentations, keyed
        by the piece's index in ``self.vocab`` (trainers.rs:440-450).
        Single-char UNK fallbacks never contribute — their substring is by
        construction not a live piece.  Overridden by the distributed
        trainer (parallel/unigram_trainer.py) with a device pass.
        """
        vocab_map = dict(self.vocab)
        index = {t: i for i, (t, _) in enumerate(self.vocab)}
        expected: Counter = Counter()
        for sentence, sfreq in sentence_freqs.items():
            for tok in self._viterbi_segment(sentence, vocab_map):
                i = index.get(tok)
                if i is not None:
                    expected[i] += sfreq
        return expected

    def _viterbi_segment(self, sentence: str, vocab_map: dict[str, float]) -> list[str]:
        """Viterbi DP (trainers.rs:485-540)."""
        if not sentence:
            return []
        chars = list(sentence)
        n = len(chars)
        NEG = float("-inf")
        best: list[tuple[float, int]] = [(NEG, -1)] * (n + 1)
        best[0] = (0.0, -1)
        best_token = [""] * (n + 1)
        unk_score = vocab_map.get("<unk>", -100.0)
        maxlen = self.config.max_piece_length
        for end in range(1, n + 1):
            for start in range(max(end - maxlen, 0), end):
                sub = "".join(chars[start:end])
                score = vocab_map.get(sub)
                if score is not None:
                    ns = best[start][0] + score
                    if ns > best[end][0]:
                        best[end] = (ns, start)
                        best_token[end] = sub
                elif end - start == 1:
                    ns = best[start][0] + unk_score
                    if ns > best[end][0]:
                        best[end] = (ns, start)
                        best_token[end] = sub
        tokens = []
        pos = n
        while pos > 0:
            tokens.append(best_token[pos])
            pos = best[pos][1]
        tokens.reverse()
        return tokens

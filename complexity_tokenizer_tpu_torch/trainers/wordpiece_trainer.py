"""WordPiece trainer (BERT style).

The JAX package's ``trainers/wordpiece_trainer.py`` line for line.
Semantics match the reference's (src/trainers.rs:19-279): word-frequency
count through the configured normalizer/pre-tokenizer, char-level init
vocab, then greedy merging of the most frequent adjacent-subword pair with
``##``-aware joining; words are re-tokenized per round with greedy longest
match.  The reference re-tokenizes every word every round — here each
word's tokenization is cached and only refreshed when the new vocab entry
can change it.  ``parallel.DistributedWordPieceTrainer`` runs the
re-tokenization and the pair count on the card (kernels K18 and K19).
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field

from ..core import normalizers as N
from ..core import pretokenizers as PT
from ..models.wordpiece import WordPieceModel

__all__ = ["WordPieceTrainerConfig", "WordPieceTrainer"]


@dataclass
class WordPieceTrainerConfig:
    vocab_size: int = 30000
    min_frequency: int = 2
    special_tokens: list = field(
        default_factory=lambda: ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    )
    continuing_subword_prefix: str = "##"
    end_of_word_suffix: str | None = None
    max_input_chars_per_word: int = 100
    normalizer: object | None = field(
        default_factory=lambda: N.Sequence([N.NFC(), N.Lowercase()])
    )
    pre_tokenizer: object | None = field(default_factory=PT.Whitespace)


class WordPieceTrainer:
    def __init__(self, config: WordPieceTrainerConfig | None = None):
        self.config = config or WordPieceTrainerConfig()
        self.vocab: dict[str, int] = {}

    def _pretokenize(self, text: str) -> list[str]:
        if self.config.normalizer is not None:
            text = self.config.normalizer.normalize(text)
        if self.config.pre_tokenizer is not None:
            return self.config.pre_tokenizer.pre_tokenize(text)
        return text.split()

    def train(self, files) -> WordPieceModel:
        word_freqs: Counter = Counter()
        for path in files:
            with open(path, "r", encoding="utf-8") as f:
                for line in f:
                    for w in self._pretokenize(line.rstrip("\n")):
                        word_freqs[w] += 1
        return self._train_from_word_freqs(word_freqs)

    def train_from_texts(self, texts) -> WordPieceModel:
        word_freqs: Counter = Counter()
        for text in texts:
            for w in self._pretokenize(text):
                word_freqs[w] += 1
        return self._train_from_word_freqs(word_freqs)

    train_from_iterator = train_from_texts

    def _train_from_word_freqs(self, word_freqs: Counter) -> WordPieceModel:
        cfg = self.config
        word_freqs = Counter(
            {w: f for w, f in word_freqs.items() if f >= cfg.min_frequency}
        )
        next_id = 0
        for tok in cfg.special_tokens:
            self.vocab[tok] = next_id
            next_id += 1
        for c in sorted({c for w in word_freqs for c in w}):
            if c not in self.vocab:
                self.vocab[c] = next_id
                next_id += 1

        prefix = cfg.continuing_subword_prefix
        tokenizations = {w: self._tokenize_for_training(w) for w in word_freqs}

        while len(self.vocab) < cfg.vocab_size:
            pair_freqs: Counter = Counter()
            for w, freq in word_freqs.items():
                toks = tokenizations[w]
                for i in range(len(toks) - 1):
                    pair_freqs[(toks[i], toks[i + 1])] += freq
            if not pair_freqs:
                break
            # highest count; ties -> lexicographically smallest pair.  The
            # reference's tie order is HashMap-iteration nondeterministic
            # (trainers.rs:180-217), so any fixed rule is within its
            # variance; this one is shared with the distributed trainer so
            # both produce identical vocabs.
            (a, b), _ = min(pair_freqs.items(), key=lambda kv: (-kv[1], kv[0]))
            if b.startswith(prefix):
                merged = a + b[len(prefix) :]
            else:
                merged = a + b
            if merged not in self.vocab:
                self.vocab[merged] = next_id
                next_id += 1
                # refresh tokenizations that may be affected by the new entry
                core = merged[len(prefix) :] if merged.startswith(prefix) else merged
                for w in word_freqs:
                    if core in w:
                        tokenizations[w] = self._tokenize_for_training(w)
            else:
                # vocab unchanged -> pair counts won't change; avoid spinning
                break

        return WordPieceModel(
            dict(self.vocab),
            cfg.continuing_subword_prefix,
            "[UNK]",
            cfg.max_input_chars_per_word,
        )

    def _tokenize_for_training(self, word: str) -> list[str]:
        """Greedy longest-match with single-char fallback (trainers.rs:228-273)."""
        chars = list(word)
        if not chars:
            return []
        prefix = self.config.continuing_subword_prefix
        tokens = []
        start = 0
        n = len(chars)
        while start < n:
            end = n
            found = False
            while start < end:
                sub = "".join(chars[start:end])
                token = prefix + sub if start > 0 else sub
                if token in self.vocab:
                    tokens.append(token)
                    found = True
                    break
                end -= 1
            if not found:
                token = prefix + chars[start] if start > 0 else chars[start]
                tokens.append(token)
                start += 1
            else:
                start = end
        return tokens

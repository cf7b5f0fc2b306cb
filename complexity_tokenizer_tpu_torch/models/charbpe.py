"""CharBPE model: character BPE with an end-of-word suffix marker, as the
reference's (models.rs:597-741) and the JAX package's
(``models/charbpe.py``).  Its device tier is kernel K9
(``ops/stringbpe_device.py``)."""

from __future__ import annotations

from ..ops.stringbpe_device import build_string_bpe_device
from ._device import DeviceTiers

__all__ = ["CharBpeModel", "string_bpe_merge"]


def string_bpe_merge(tokens: list[str], merge_ranks: dict[tuple[str, str], int]) -> list[str]:
    """Greedy lowest-rank-first merge loop over string symbols: one merge
    per iteration, the leftmost of the lowest rank (models.rs:487-515)."""
    tokens = list(tokens)
    while True:
        best_idx = -1
        best_rank = -1
        for i in range(len(tokens) - 1):
            rank = merge_ranks.get((tokens[i], tokens[i + 1]))
            if rank is not None and (best_idx < 0 or rank < best_rank):
                best_idx = i
                best_rank = rank
        if best_idx < 0:
            break
        tokens[best_idx] = tokens[best_idx] + tokens[best_idx + 1]
        del tokens[best_idx + 1]
    return tokens


def word_table(model, words: list[str], sym_rows: list[list[str]], device) -> dict:
    """``{word: ids}`` for distinct words whose seed symbols are
    ``sym_rows``: merged by the model's device tier on ``device``, or on
    the host where its table is not eligible (``model.last_route``) or a
    word is wider than the tier's lanes.  ``model.last_stats`` counts the
    words and those the host merged."""
    dev = model._tiers.get(device)
    unk_id = model.vocab.get(model.unk_token, 0)
    if dev is None:
        merged = [None] * len(words)
        model.last_route = "host"
    else:
        merged = dev.merge_symbol_rows(sym_rows)
        model.last_route = "device"
    table: dict[str, list[int]] = {}
    over = 0
    for w, m in zip(words, merged):
        if m is None:
            over += dev is not None
            m = model.tokenize_word(w)
        table[w] = [model.vocab.get(t, unk_id) for t in m]
    model.last_stats = {"words": len(words), "over_width": over, "poisoned": 0,
                        "host": over if dev is not None else len(words)}
    return table


class CharBpeModel:
    def __init__(
        self,
        vocab: dict[str, int],
        merges: list[tuple[str, str]],
        end_of_word_suffix: str = "</w>",
        unk_token: str = "<unk>",
    ):
        self.vocab = dict(vocab)
        self.vocab_r = {v: k for k, v in vocab.items()}
        self.merge_ranks = {(a, b): r for r, (a, b) in enumerate(merges)}
        self.end_of_word_suffix = end_of_word_suffix
        self.unk_token = unk_token
        self._tiers = DeviceTiers(lambda dev: build_string_bpe_device(self.merge_ranks, dev))
        self.last_route: str | None = None
        self.last_stats: dict = {}

    def tokenize_word(self, word: str) -> list[str]:
        if not word:
            return []
        chars = list(word)
        tokens = chars[:-1] + [chars[-1] + self.end_of_word_suffix]
        return string_bpe_merge(tokens, self.merge_ranks)

    def encode(self, text: str) -> list[int]:
        unk_id = self.vocab.get(self.unk_token, 0)
        out = []
        for word in text.split():
            for t in self.tokenize_word(word):
                out.append(self.vocab.get(t, unk_id))
        return out

    def encode_batch(self, texts: list[str], device=None) -> list[list[int]]:
        """Batch encode: the distinct words merged by K9 on ``device``
        (``cuda`` unless the caller passes ``"cpu"``) with the suffix on
        each word's last character, then assembled per text; on the host
        where the merge table is not eligible or a word is over 128
        symbols."""
        rows = [t.split() for t in texts]
        uniq = sorted({w for r in rows for w in r})
        suffix = self.end_of_word_suffix
        sym_rows = [list(w)[:-1] + [w[-1] + suffix] for w in uniq]
        table = word_table(self, uniq, sym_rows, device)
        return [[i for w in r for i in table[w]] for r in rows]

    def decode(self, ids) -> str:
        result = ""
        suffix = self.end_of_word_suffix
        for i in ids:
            token = self.vocab_r.get(int(i))
            if token is None:
                continue
            if token.endswith(suffix):
                result += token[: len(token) - len(suffix)] + " "
            else:
                result += token
        return result.rstrip()

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def token_to_id(self, token: str):
        return self.vocab.get(token)

    def id_to_token(self, idx: int):
        return self.vocab_r.get(idx)

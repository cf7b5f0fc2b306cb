"""Encoding: one encoded sequence with its aligned fields.

ids, type ids, tokens, attention and special-token masks, offsets, word
ids, sequence ids and the overflowing windows; pad left or right,
truncate with the tail kept as overflow, windows with a stride, the merge
of a pair, the char / word / token maps and numpy exports.  Offsets and
word ids may be deferred (``_defer_aux``): the batch ``__call__`` route
computes them on first read only.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

__all__ = ["Encoding"]


class _AuxThunk:
    """Memoized (offsets, word_ids) producer shared between an Encoding
    and its lazy slices (overflow windows), so that the base computation
    runs at most once however many views exist."""

    __slots__ = ("fn", "val")

    def __init__(self, fn):
        self.fn = fn
        self.val = None

    def __call__(self):
        if self.val is None:
            self.val = self.fn()
        return self.val

    def sliced(self, start, end):
        base = self
        return lambda: (base()[0][start:end], base()[1][start:end])


@dataclass
class Encoding:
    ids: list = field(default_factory=list)
    type_ids: list = field(default_factory=list)
    tokens: list = field(default_factory=list)
    attention_mask: list = field(default_factory=list)
    special_tokens_mask: list = field(default_factory=list)
    offsets: list = field(default_factory=list)
    word_ids: list = field(default_factory=list)
    sequence_ids: list = field(default_factory=list)
    overflowing: list = field(default_factory=list)

    def __getattr__(self, name):
        # deferred offsets / word ids: computed on the first read; truncate
        # and _slice compose onto the pending thunk instead
        if name in ("offsets", "word_ids"):
            thunk = self.__dict__.pop("_aux_thunk", None)
            if thunk is not None:
                offsets, word_ids = thunk()
                self.offsets = list(offsets)
                self.word_ids = list(word_ids)
                return getattr(self, name)
        raise AttributeError(name)

    def _defer_aux(self, thunk) -> None:
        """Replace offsets and word ids with a thunk returning (offsets,
        word_ids) on first access."""
        self.__dict__.pop("offsets", None)
        self.__dict__.pop("word_ids", None)
        self._aux_thunk = _AuxThunk(thunk)

    @staticmethod
    def from_ids(ids: list[int], tokens: list[str]) -> "Encoding":
        n = len(ids)
        return Encoding(
            ids=list(ids),
            type_ids=[0] * n,
            tokens=list(tokens),
            attention_mask=[1] * n,
            special_tokens_mask=[0] * n,
            offsets=[],
            word_ids=[],
            sequence_ids=[0] * n,
            overflowing=[],
        )

    def __len__(self) -> int:
        return len(self.ids)

    def is_empty(self) -> bool:
        return not self.ids

    def set_type_ids(self, type_id: int, start: int, end: int) -> None:
        for i in range(start, min(end, len(self.type_ids))):
            self.type_ids[i] = type_id

    def mark_special_tokens(self, special_ids) -> None:
        special = set(special_ids)
        for i, tid in enumerate(self.ids):
            if tid in special:
                self.special_tokens_mask[i] = 1

    def pad(
        self, target_length: int, pad_id: int, pad_token: str, pad_left: bool = False
    ) -> None:
        if len(self) >= target_length:
            return
        pad_count = target_length - len(self)
        if pad_left:
            self.ids = [pad_id] * pad_count + self.ids
            self.type_ids = [0] * pad_count + self.type_ids
            self.tokens = [pad_token] * pad_count + self.tokens
            self.attention_mask = [0] * pad_count + self.attention_mask
            self.special_tokens_mask = [1] * pad_count + self.special_tokens_mask
            self.sequence_ids = [None] * pad_count + self.sequence_ids
            # offsets and word ids are not padded, on either side
        else:
            self.ids += [pad_id] * pad_count
            self.type_ids += [0] * pad_count
            self.tokens += [pad_token] * pad_count
            self.attention_mask += [0] * pad_count
            self.special_tokens_mask += [1] * pad_count
            self.sequence_ids += [None] * pad_count

    def _slice(self, start: int, end: int) -> "Encoding":
        pending = self.__dict__.get("_aux_thunk")
        enc = Encoding(
            ids=self.ids[start:end],
            type_ids=self.type_ids[start:end],
            tokens=self.tokens[start:end],
            attention_mask=self.attention_mask[start:end],
            special_tokens_mask=self.special_tokens_mask[start:end],
            offsets=(
                []
                if pending is not None
                else self.offsets[start:end] if len(self.offsets) > start else []
            ),
            word_ids=(
                []
                if pending is not None
                else self.word_ids[start:end] if len(self.word_ids) > start else []
            ),
            sequence_ids=(
                self.sequence_ids[start:end] if len(self.sequence_ids) > start else []
            ),
            overflowing=[],
        )
        if pending is not None:
            enc._defer_aux(pending.sliced(start, end))
        return enc

    def _truncate_in_place(self, max_length: int) -> None:
        self.ids = self.ids[:max_length]
        self.type_ids = self.type_ids[:max_length]
        self.tokens = self.tokens[:max_length]
        self.attention_mask = self.attention_mask[:max_length]
        self.special_tokens_mask = self.special_tokens_mask[:max_length]
        pending = self.__dict__.get("_aux_thunk")
        if pending is not None:
            self._defer_aux(pending.sliced(0, max_length))
        else:
            self.offsets = self.offsets[:max_length]
            self.word_ids = self.word_ids[:max_length]
        self.sequence_ids = self.sequence_ids[:max_length]

    def truncate(self, max_length: int) -> None:
        """Truncate, keeping the tail as one overflow."""
        if len(self) <= max_length:
            return
        self.overflowing.append(self._slice(max_length, len(self)))
        self._truncate_in_place(max_length)

    def truncate_with_stride(self, max_length: int, stride: int) -> None:
        """Truncate, keeping the tail as windows of ``max_length`` that
        overlap their predecessor by ``stride``."""
        if len(self) <= max_length:
            return
        pos = max_length
        n = len(self.ids)
        while pos < n:
            start = max(pos - stride, 0)
            end = min(start + max_length, n)
            self.overflowing.append(self._slice(start, end))
            pos = end
        self._truncate_in_place(max_length)

    def n_overflowing(self) -> int:
        return len(self.overflowing)

    def merge(self, other: "Encoding", type_id: int) -> None:
        other_len = len(other.ids)
        self.ids += other.ids
        self.tokens += other.tokens
        self.attention_mask += other.attention_mask
        self.special_tokens_mask += other.special_tokens_mask
        self.offsets += other.offsets
        self.word_ids += other.word_ids
        self.type_ids += [type_id] * other_len
        self.sequence_ids += [type_id] * other_len

    # ------------------------------------------------------------------
    # alignment

    def char_to_token(self, char_pos: int) -> int | None:
        for i, (start, end) in enumerate(self.offsets):
            if start <= char_pos < end:
                return i
        return None

    def char_to_token_with_sequence(self, char_pos: int, sequence_id: int):
        for i, (start, end) in enumerate(self.offsets):
            sid = self.sequence_ids[i] if i < len(self.sequence_ids) else None
            if sid == sequence_id and start <= char_pos < end:
                return i
        return None

    def token_to_chars(self, token_idx: int):
        if 0 <= token_idx < len(self.offsets):
            return self.offsets[token_idx]
        return None

    def token_to_word(self, token_idx: int):
        if 0 <= token_idx < len(self.word_ids):
            return self.word_ids[token_idx]
        return None

    def token_to_sequence(self, token_idx: int):
        if 0 <= token_idx < len(self.sequence_ids):
            return self.sequence_ids[token_idx]
        return None

    def word_to_tokens(self, word_idx: int):
        return self.word_to_tokens_with_sequence(word_idx, 0)

    def word_to_tokens_with_sequence(self, word_idx: int, sequence_id: int):
        start = end = None
        for i, wid in enumerate(self.word_ids):
            if wid is None:
                continue
            sid = self.sequence_ids[i] if i < len(self.sequence_ids) else None
            if wid == word_idx and sid == sequence_id:
                if start is None:
                    start = i
                end = i + 1
        if start is not None and end is not None:
            return (start, end)
        return None

    def word_to_chars(self, word_idx: int):
        return self.word_to_chars_with_sequence(word_idx, 0)

    def word_to_chars_with_sequence(self, word_idx: int, sequence_id: int):
        rng = self.word_to_tokens_with_sequence(word_idx, sequence_id)
        if rng is None:
            return None
        char_start = char_end = None
        for i in range(rng[0], rng[1]):
            if i < len(self.offsets):
                s, e = self.offsets[i]
                if char_start is None or s < char_start:
                    char_start = s
                if char_end is None or e > char_end:
                    char_end = e
        if char_start is not None and char_end is not None:
            return (char_start, char_end)
        return None

    def word_token_indices(self, word_idx: int) -> list[int]:
        return [i for i, wid in enumerate(self.word_ids) if wid == word_idx]

    def n_words(self) -> int:
        wids = [w for w in self.word_ids if w is not None]
        return max(wids) + 1 if wids else 0

    # ------------------------------------------------------------------
    # numpy exports

    def ids_as_numpy(self) -> np.ndarray:
        return np.asarray(self.ids, dtype=np.uint32)

    def attention_mask_as_numpy(self) -> np.ndarray:
        return np.asarray(self.attention_mask, dtype=np.uint32)

    def type_ids_as_numpy(self) -> np.ndarray:
        return np.asarray(self.type_ids, dtype=np.uint32)

    def special_tokens_mask_as_numpy(self) -> np.ndarray:
        return np.asarray(self.special_tokens_mask, dtype=np.uint32)

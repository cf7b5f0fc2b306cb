"""Post-processors: the special tokens framed around encoded sequences.

``TemplateProcessing`` also compiles its single-sequence template into a
static (prefix ids, suffix ids) frame (``compile_single``), which the
columnar ``__call__`` route lays around every row in one native pass.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum

__all__ = [
    "PostProcessor",
    "TemplateProcessing",
    "BertProcessing",
    "RobertaProcessing",
    "Sequence",
    "TruncationStrategy",
    "truncate_ids",
    "pad_ids",
    "default_postprocessor",
]


class PostProcessor:
    def process(self, ids: list[int], pair_ids: list[int] | None = None) -> list[int]:
        raise NotImplementedError

    def added_tokens_single(self) -> int:
        raise NotImplementedError

    def added_tokens_pair(self) -> int:
        raise NotImplementedError

    def __eq__(self, other):
        return type(self) is type(other) and self.__dict__ == other.__dict__


def _parse_template(
    template: str, ids: list[int], pair_ids: list[int] | None, special_tokens
) -> list[int]:
    """Walk the template char by char: ``$A`` / ``$B`` splice the
    sequences, ``<tok>`` / ``[tok]`` resolve against ``special_tokens``
    ((token, id) pairs; an unknown token adds nothing)."""
    result: list[int] = []
    chars = template
    i = 0
    n = len(chars)
    while i < n:
        c = chars[i]
        if c == "$" and i + 1 < n:
            nxt = chars[i + 1]
            if nxt == "A":
                result.extend(ids)
                i += 2
            elif nxt == "B":
                if pair_ids is not None:
                    result.extend(pair_ids)
                i += 2
            else:
                i += 1
        elif c in "<[":
            end_char = ">" if c == "<" else "]"
            start = i
            while i < n and chars[i] != end_char:
                i += 1
            if i < n:
                i += 1
            token = chars[start:i].strip()
            for t, tid in special_tokens:
                if t == token:
                    result.append(tid)
                    break
        else:
            i += 1
    return result


@dataclass(eq=False)
class TemplateProcessing(PostProcessor):
    single: str = "<s> $A </s>"
    pair: str | None = None
    special_tokens: list = field(default_factory=list)

    def process(self, ids, pair_ids=None):
        template = (
            (self.pair if self.pair is not None else self.single)
            if pair_ids is not None
            else self.single
        )
        return _parse_template(template, ids, pair_ids, self.special_tokens)

    def added_tokens_single(self) -> int:
        # the special tokens whose literal appears in the template
        return sum(1 for t, _ in self.special_tokens if t in self.single)

    def added_tokens_pair(self) -> int:
        if self.pair is None:
            return 0
        return sum(1 for t, _ in self.special_tokens if t in self.pair)

    def compile_single(self) -> tuple[list[int], list[int]]:
        """(prefix ids, suffix ids) around $A."""
        pre = _parse_template(self.single.split("$A")[0], [], None, self.special_tokens)
        post_part = self.single.split("$A", 1)
        post = (
            _parse_template(post_part[1], [], None, self.special_tokens)
            if len(post_part) > 1
            else []
        )
        return pre, post


@dataclass(eq=False)
class BertProcessing(PostProcessor):
    cls: tuple = ("[CLS]", 101)
    sep: tuple = ("[SEP]", 102)

    def process(self, ids, pair_ids=None):
        result = [self.cls[1], *ids, self.sep[1]]
        if pair_ids is not None:
            result.extend(pair_ids)
            result.append(self.sep[1])
        return result

    def added_tokens_single(self) -> int:
        return 2

    def added_tokens_pair(self) -> int:
        return 3


@dataclass(eq=False)
class RobertaProcessing(PostProcessor):
    bos: tuple = ("<s>", 0)
    eos: tuple = ("</s>", 2)
    add_prefix_space: bool = False

    def process(self, ids, pair_ids=None):
        result = [self.bos[1], *ids, self.eos[1]]
        if pair_ids is not None:
            result.append(self.eos[1])
            result.extend(pair_ids)
            result.append(self.eos[1])
        return result

    def added_tokens_single(self) -> int:
        return 2

    def added_tokens_pair(self) -> int:
        return 4


@dataclass(eq=False)
class Sequence(PostProcessor):
    processors: list = field(default_factory=list)

    def process(self, ids, pair_ids=None):
        result = ids
        pair = pair_ids
        for p in self.processors:
            result = p.process(result, pair)
            pair = None  # only the first processor sees the pair
        return result

    def added_tokens_single(self) -> int:
        return sum(p.added_tokens_single() for p in self.processors)

    def added_tokens_pair(self) -> int:
        return sum(p.added_tokens_pair() for p in self.processors)


class TruncationStrategy(str, Enum):
    ONLY_FIRST = "only_first"
    ONLY_SECOND = "only_second"
    LONGEST_FIRST = "longest_first"


def truncate_ids(
    ids: list[int],
    pair_ids: list[int] | None,
    max_length: int,
    strategy: TruncationStrategy,
) -> tuple[list[int], list[int] | None]:
    """Cut a sequence (or a pair) to ``max_length`` ids in all."""
    total = len(ids) + (len(pair_ids) if pair_ids is not None else 0)
    if total <= max_length:
        return ids, pair_ids
    to_remove = total - max_length
    ids = list(ids)
    pair_ids = list(pair_ids) if pair_ids is not None else None
    if strategy == TruncationStrategy.ONLY_FIRST:
        remove = min(to_remove, len(ids))
        ids = ids[: len(ids) - remove]
    elif strategy == TruncationStrategy.ONLY_SECOND:
        if pair_ids is not None:
            remove = min(to_remove, len(pair_ids))
            pair_ids = pair_ids[: len(pair_ids) - remove]
    else:
        remaining = to_remove
        while remaining > 0:
            ids_len = len(ids)
            pair_len = len(pair_ids) if pair_ids is not None else 0
            if ids_len >= pair_len and ids_len > 0:
                ids.pop()
                remaining -= 1
            elif pair_ids is not None and pair_ids:
                pair_ids.pop()
                remaining -= 1
            else:
                break
    return ids, pair_ids


def pad_ids(
    ids: list[int], target_length: int, pad_token_id: int, pad_left: bool = False
) -> list[int]:
    """``ids`` padded to ``target_length`` on either side."""
    if len(ids) >= target_length:
        return list(ids)
    pad_count = target_length - len(ids)
    if pad_left:
        return [pad_token_id] * pad_count + list(ids)
    return list(ids) + [pad_token_id] * pad_count


def default_postprocessor() -> PostProcessor:
    """The default frame of an LLM: bos and eos."""
    return TemplateProcessing(
        single="<s> $A </s>",
        pair="<s> $A </s> $B </s>",
        special_tokens=[("<s>", 2), ("</s>", 0)],
    )

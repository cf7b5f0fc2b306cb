"""BPE core: rank-table construction and the oracle merge loop.

Observable semantics of the reference BPE:

- the rank table keeps a merge only when ``a``, ``b`` and ``a+b`` are all
  in the vocab, with ranks following the original merge enumeration (so
  kept ranks are sparse);
- encode seeds from per-char vocab lookups, silently dropping OOV chars;
- the merge loop applies ONE merge per iteration: the leftmost occurrence
  of the lowest-rank pair;
- BPE dropout skips each candidate pair with the given probability, drawn
  from the reference's xorshift64 generator seeded 12345, which advances
  across calls.

The device fixpoint (``ops/merge.py``) applies every non-overlapping
occurrence of each word's best pair per step instead, which is equivalent
iff the table is well-formed (:func:`merges_well_formed`).  The loop in
:class:`BpeTokenizer` is the port's oracle.
"""

from __future__ import annotations

__all__ = ["Xorshift64", "BpeTokenizer", "build_merge_tables", "merges_well_formed"]


class Xorshift64:
    """The reference's dropout generator: xorshift64 (13, 7, 17)."""

    MASK = (1 << 64) - 1

    def __init__(self, seed: int = 12345):
        self.state = seed & self.MASK

    def next_f32(self) -> float:
        s = self.state
        s = (s ^ (s << 13)) & self.MASK
        s = s ^ (s >> 7)
        s = (s ^ (s << 17)) & self.MASK
        self.state = s
        return s / float(self.MASK)


def build_merge_tables(vocab: dict[str, int], merges: list[tuple[str, str]]):
    """-> (merge_ranks {(id_a, id_b): rank}, merge_ops {rank: (pair, new_id)})."""
    merge_ranks: dict[tuple[int, int], int] = {}
    merge_ops: dict[int, tuple[tuple[int, int], int]] = {}
    for rank, (a, b) in enumerate(merges):
        id_a = vocab.get(a)
        id_b = vocab.get(b)
        if id_a is None or id_b is None:
            continue
        new_id = vocab.get(a + b)
        if new_id is None:
            continue
        merge_ranks[(id_a, id_b)] = rank
        merge_ops[rank] = ((id_a, id_b), new_id)
    return merge_ranks, merge_ops


def merges_well_formed(
    merge_ranks: dict[tuple[int, int], int],
    merge_ops: dict[int, tuple[tuple[int, int], int]],
) -> bool:
    """True iff every pair containing merge r's product has rank > r: the
    precondition for the device fixpoint's batch apply to equal the
    one-merge-per-iteration loop."""
    first_use: dict[int, int] = {}  # token id -> earliest rank using it
    for (a, b), rank in merge_ranks.items():
        for tok in (a, b):
            if tok not in first_use or rank < first_use[tok]:
                first_use[tok] = rank
    for rank, (_, new_id) in merge_ops.items():
        if first_use.get(new_id, 1 << 60) <= rank:
            return False
    return True


class BpeTokenizer:
    """Host BPE tokenizer (the oracle tier)."""

    def __init__(self, vocab: dict[str, int], merges: list[tuple[str, str]]):
        self.vocab = dict(vocab)
        self.merge_ranks, self.merge_ops = build_merge_tables(vocab, merges)
        self._char_ids = {k: v for k, v in self.vocab.items() if len(k) == 1}
        self._rng = Xorshift64(12345)

    @property
    def merges(self):
        """The kept merges in rank order, as ((id_a, id_b), new_id)."""
        return [self.merge_ops[r] for r in sorted(self.merge_ops)]

    def packed_merge_arrays(self):
        """(pa, pb, pr, rank_new) int32 arrays for the native runtime: the
        kept pairs and their ranks in ``merge_ranks`` order, and each rank's
        minted id (-1 for ranks that were not kept).  Cached: the merge
        tables do not change after construction."""
        arrs = getattr(self, "_packed_merge_arrays", None)
        if arrs is None:
            import numpy as np

            n = len(self.merge_ranks)
            flat = np.fromiter(
                (v for (a, b), r in self.merge_ranks.items() for v in (a, b, r)),
                np.int32,
                count=3 * n,
            )
            pa = np.ascontiguousarray(flat[0::3])
            pb = np.ascontiguousarray(flat[1::3])
            pr = np.ascontiguousarray(flat[2::3])
            max_rank = max(self.merge_ops) if self.merge_ops else 0
            rank_new = np.full(max_rank + 1, -1, np.int32)
            if self.merge_ops:
                rk = np.fromiter(self.merge_ops.keys(), np.int64, len(self.merge_ops))
                nv = np.fromiter(
                    (v[1] for v in self.merge_ops.values()), np.int64, len(self.merge_ops)
                )
                rank_new[rk] = nv
            arrs = (pa, pb, pr, rank_new)
            self._packed_merge_arrays = arrs
        return arrs

    def encode(self, text: str) -> list[int]:
        char_ids = self._char_ids
        tokens = [char_ids[c] for c in text if c in char_ids]
        ranks = self.merge_ranks
        ops = self.merge_ops
        while len(tokens) > 1:
            best_idx = -1
            best_rank = -1
            for i in range(len(tokens) - 1):
                rank = ranks.get((tokens[i], tokens[i + 1]))
                if rank is not None and (best_idx < 0 or rank < best_rank):
                    best_idx = i
                    best_rank = rank
            if best_idx < 0:
                break
            tokens[best_idx] = ops[best_rank][1]
            del tokens[best_idx + 1]
        return tokens

    def encode_with_dropout(self, text: str, dropout: float) -> list[int]:
        """:meth:`encode` where each candidate pair of a step is skipped
        with probability ``dropout`` (one draw per kept pair per step)."""
        if dropout <= 0.0:
            return self.encode(text)
        char_ids = self._char_ids
        tokens = [char_ids[c] for c in text if c in char_ids]
        ranks = self.merge_ranks
        ops = self.merge_ops
        rng = self._rng
        while True:
            best_idx = -1
            best_rank = -1
            for i in range(len(tokens) - 1):
                rank = ranks.get((tokens[i], tokens[i + 1]))
                if rank is None or rng.next_f32() < dropout:
                    continue
                if best_idx < 0 or rank < best_rank:
                    best_idx = i
                    best_rank = rank
            if best_idx < 0:
                break
            tokens[best_idx] = ops[best_rank][1]
            del tokens[best_idx + 1]
        return tokens

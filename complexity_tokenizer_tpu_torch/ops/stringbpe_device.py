"""Device string-symbol BPE: the device tier of CharBPE and the ByteLevel
BPE model, kernel K9 (``ops/merge.py:merge_word_rows``).

These two models run the reference's merge loop over STRING symbols
rather than vocabulary ids: a merged symbol that is not in the vocabulary
still takes part in later merges and becomes UNK only at output.  The
device mapping, as in the JAX package (``ops/stringbpe_device.py``):

- every string of the merge table (left, right, product) gets a dense
  symbol id; a batch's characters outside that universe get ids past its
  end, which never match a pair, so they pass through the fixpoint as
  they pass through the host loop;
- the merge table becomes a CHD pair table, and the fixpoint runs one word
  a row (K9 on the card, its plain version on the CPU);
- applying every best pair at once equals the host's one merge per step
  only for well-formed tables (``core/bpe.py:merges_well_formed``): the
  build returns None otherwise, and the model stays on the host;
- the merged symbol ids map back to strings on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.bpe import merges_well_formed
from ..utils.device import resolve_device
from .hashtable import build_chd_table
from .merge import merge_word_rows

__all__ = ["StringBpeDevice", "build_string_bpe_device"]

_W = 128  # symbol lanes a word row


def build_string_bpe_device(
    merge_ranks: dict[tuple[str, str], int], device=None
) -> "StringBpeDevice | None":
    """The device runner of a string-pair merge table on ``device``
    (``cuda`` unless the caller passes ``"cpu"``); None when the table is
    empty or not well-formed for batch application, or the CHD build
    fails."""
    if not merge_ranks:
        return None
    sym_id: dict[str, int] = {}

    def sid(s: str) -> int:
        i = sym_id.get(s)
        if i is None:
            i = len(sym_id)
            sym_id[s] = i
        return i

    id_ranks: dict[tuple[int, int], int] = {}
    id_ops: dict[int, tuple[tuple[int, int], int]] = {}
    for (a, b), r in sorted(merge_ranks.items(), key=lambda kv: kv[1]):
        ia, ib, io = sid(a), sid(b), sid(a + b)
        id_ranks[(ia, ib)] = r
        id_ops[r] = ((ia, ib), io)
    if not merges_well_formed(id_ranks, id_ops):
        return None
    chd = build_chd_table(id_ranks, id_ops)
    if chd is None:
        return None
    symbols = [None] * len(sym_id)
    for s, i in sym_id.items():
        symbols[i] = s
    return StringBpeDevice(chd, sym_id, symbols, device)


class StringBpeDevice:
    """The CHD table on one device and the batch merge over it."""

    def __init__(self, chd, sym_id: dict[str, int], symbols: list[str], device=None):
        self.chd = chd
        self.sym_id = sym_id
        self.symbols = symbols
        self.device = resolve_device(device)
        self.disp = torch.from_numpy(chd.disp).to(self.device)
        self.rows = torch.from_numpy(chd.rows).to(self.device)

    def pack(self, rows_syms: list[list[str]]):
        """The fixpoint's input for a batch of symbol rows: (tokens [n, 128]
        int32 symbol ids, -1 padded; the rows over the lanes, left empty;
        every symbol by id, the batch's own after the table's)."""
        base = len(self.symbols)
        extra: dict[str, int] = {}
        extra_syms: list[str] = []

        def to_id(s: str) -> int:
            i = self.sym_id.get(s)
            if i is not None:
                return i
            i = extra.get(s)
            if i is None:
                i = base + len(extra_syms)
                extra[s] = i
                extra_syms.append(s)
            return i

        tokens = np.full((len(rows_syms), _W), -1, np.int32)
        skipped = set()
        for r, syms in enumerate(rows_syms):
            if len(syms) > _W:
                skipped.add(r)
                continue
            tokens[r, : len(syms)] = [to_id(s) for s in syms]
        return tokens, skipped, self.symbols + extra_syms

    def merge_symbol_rows(self, rows_syms: list[list[str]]) -> list[list[str] | None]:
        """The merge loop for a batch of symbol rows, one launch at the exact
        batch size; a row over the lane width gives None (the caller merges
        it on the host)."""
        if not rows_syms:
            return []
        tokens, skipped, all_syms = self.pack(rows_syms)
        out, _count = merge_word_rows(
            torch.from_numpy(tokens).to(self.device), self.disp, self.rows,
            self.chd.size, self.chd.n_buckets,
        )
        out = out.cpu().numpy()
        return [
            None if r in skipped else [all_syms[i] for i in out[r][out[r] >= 0].tolist()]
            for r in range(len(rows_syms))
        ]

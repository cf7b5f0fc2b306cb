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
- the merge table becomes a CHD pair table, and the fixpoint runs over the
  words' symbols end to end with their offsets, a tile of whole words a
  block (K9 on the card, its plain version on the CPU);
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
from .hashtable import build_chd_table, build_qc_table
from .merge import TILE_SYMBOLS, WORD_LANES, merge_word_rows, word_tiles

__all__ = ["StringBpeDevice", "build_string_bpe_device", "string_pair_ids", "string_qc_table"]


def string_pair_ids(merge_ranks: dict[tuple[str, str], int]):
    """The dense symbol ids of a string-pair merge table: (sym_id, the
    merge ranks and ops over ids, as ``hashtable.build_chd_table`` and
    ``build_qc_table`` take them).  Every string of the table (left, right,
    product) gets an id, in rank order."""
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
    return sym_id, id_ranks, id_ops


def string_qc_table(merge_ranks: dict[tuple[str, str], int]):
    """The u16 cuckoo table (``hashtable.QcTable``) of a string-pair merge
    table, over the symbol ids of :func:`string_pair_ids` (those of
    :class:`StringBpeDevice`); None where ids or ranks pass u16.  K22's
    table (``ops/merge.py:merge_word_rows_qc``); no model builds it."""
    _sym_id, id_ranks, id_ops = string_pair_ids(merge_ranks)
    return build_qc_table(id_ranks, id_ops) if id_ranks else None


def build_string_bpe_device(
    merge_ranks: dict[tuple[str, str], int], device=None
) -> "StringBpeDevice | None":
    """The device runner of a string-pair merge table on ``device``
    (``cuda`` unless the caller passes ``"cpu"``); None when the table is
    empty or not well-formed for batch application, or the CHD build
    fails."""
    if not merge_ranks:
        return None
    sym_id, id_ranks, id_ops = string_pair_ids(merge_ranks)
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
        """The fixpoint's input for a batch of symbol rows: (syms [N] int32,
        the symbol ids of all rows end to end; offs [B + 1] int32; the rows
        over ``WORD_LANES`` symbols, which hold none; every symbol by id,
        the batch's own after the table's)."""
        base = len(self.symbols)
        sym_id = self.sym_id
        extra: dict[str, int] = {}
        extra_syms: list[str] = []

        def to_id(s: str) -> int:
            i = sym_id.get(s)
            if i is not None:
                return i
            i = extra.get(s)
            if i is None:
                i = base + len(extra_syms)
                extra[s] = i
                extra_syms.append(s)
            return i

        flat: list[int] = []
        offs = np.zeros(len(rows_syms) + 1, np.int32)
        skipped = set()
        for r, syms in enumerate(rows_syms):
            if len(syms) > WORD_LANES:
                skipped.add(r)
            else:
                flat.extend(map(to_id, syms))
            offs[r + 1] = len(flat)
        return np.asarray(flat, np.int32), offs, skipped, self.symbols + extra_syms

    def merge_symbol_rows(self, rows_syms: list[list[str]]) -> list[list[str] | None]:
        """The merge loop for a batch of symbol rows, one launch over the
        ragged words; a row over ``WORD_LANES`` symbols gives None (the
        caller merges it on the host)."""
        if not rows_syms:
            return []
        syms, offs, skipped, all_syms = self.pack(rows_syms)
        tiles = word_tiles(offs, TILE_SYMBOLS)
        # one copy to the device: the symbols, the offsets and the tiles
        N, B = len(syms), len(offs) - 1
        buf = torch.from_numpy(np.concatenate([syms, offs, tiles])).to(self.device)
        out, _count = merge_word_rows(
            buf[:N], buf[N:N + B + 1], buf[N + B + 1:], self.disp, self.rows,
            self.chd.size, self.chd.n_buckets, TILE_SYMBOLS,
        )
        out = out.cpu().numpy()
        live = out >= 0
        # each row's live ids, by the offsets of the live ones
        bounds = np.concatenate([[0], np.cumsum(live)])[offs]
        names = np.asarray(all_syms, dtype=object)[out[live]]
        return [
            None if r in skipped else names[bounds[r]:bounds[r + 1]].tolist()
            for r in range(B)
        ]

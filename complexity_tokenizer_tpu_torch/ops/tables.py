"""Host-side construction of the encode pipeline's tables.

Built once per tokenizer with numpy, bit-identical to the JAX package's
``ops/tables.py``: the byte table, the u16 cuckoo table when it fits, and
the CHD pair table when it does not (no path reads a CHD table beside a
cuckoo table, so none is built there).  ``convert.tables_to_device`` puts
them on a device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.bpe import BpeTokenizer, merges_well_formed
from ..utils.bytelevel import bytes_to_unicode
from .hashtable import ChdTable, QcTable, build_chd_table, build_qc_table

__all__ = ["DeviceTables", "build_device_tables", "byte_token_table"]


@dataclass
class DeviceTables:
    byte_token_table: np.ndarray  # [256] int32; -1 = OOV byte (dropped)
    well_formed: bool
    chd: ChdTable | None = None  # built only when qc is None; None if that build fails
    qc: QcTable | None = None  # None when ids/ranks exceed u16
    max_id: int = -1  # the largest id a seed or a merge can produce


def byte_token_table(vocab: dict[str, int]) -> np.ndarray:
    """[256] int32 byte -> token id of its byte-level character, -1 when
    the vocabulary lacks it."""
    enc = bytes_to_unicode()
    byte_token = np.full(256, -1, dtype=np.int32)
    for b in range(256):
        tid = vocab.get(enc[b])
        if tid is not None:
            byte_token[b] = tid
    return byte_token


def build_device_tables(bpe: BpeTokenizer) -> DeviceTables:
    byte_token = byte_token_table(bpe.vocab)
    wf = merges_well_formed(bpe.merge_ranks, bpe.merge_ops)
    qc = build_qc_table(bpe.merge_ranks, bpe.merge_ops)
    chd = build_chd_table(bpe.merge_ranks, bpe.merge_ops) if qc is None else None
    minted = max((new_id for _pair, new_id in bpe.merge_ops.values()), default=-1)
    return DeviceTables(byte_token, wf, chd, qc, max(int(byte_token.max()), minted))

"""Carrying the tables across: numpy arrays -> tensors on a device, merge
arrays -> a native context, and padded decode tables -> the decode arena.

:func:`tables_to_device` takes the table fields as numpy arrays, whichever
package built them (this port's ``ops/tables.py`` or the JAX package's
``DeviceTables``), and returns the :class:`TorchTables` that the port's
pipeline and kernels read.  :func:`native_from_arrays` does the same for
the native runtime's merge arrays, and :func:`decode_tables_from_padded`
for the JAX package's padded decode tables.  The pipeline and the
tokenizer use them for their own tables; the tests use them to feed both
packages the same arrays.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .ops.hashtable import chd_lookup_rows, qc_lookup
from .ops.merge import merge_words, merge_words_qc
from .ops.wordfill import word_merge_chd, word_merge_qc

__all__ = ["TorchTables", "tables_to_device", "native_from_arrays", "decode_tables_from_padded"]


@dataclass
class TorchTables:
    byte_token_table: torch.Tensor  # [256] int32; -1 = OOV byte
    class_table: torch.Tensor  # [0x110000] uint8 GPT-2 codepoint classes
    qc_t1: torch.Tensor | None = None  # [m, 2] int32 bit view of the u32 cuckoo rows
    qc_t2: torch.Tensor | None = None  # [m, 2] int32
    qc_size: int = 0  # m (power of two)
    chd_disp: torch.Tensor | None = None  # [n_buckets] int32 displacements
    chd_rows: torch.Tensor | None = None  # [size, 4] int32 rows
    chd_size: int = 0  # size (power of two)
    chd_n_buckets: int = 0  # n_buckets (power of two)

    def merge_fixpoint(self, tokens: torch.Tensor, wid: torch.Tensor):
        """The segmented merge fixpoint over these tables: K2 on the
        cuckoo table when it is eligible, K5 on the CHD table otherwise
        (as the JAX package's ``EncodePipeline.merge_fixpoint``).  Returns
        (tokens, count)."""
        if self.qc_t1 is not None:
            return merge_words_qc(tokens, wid, self.qc_t1, self.qc_t2, self.qc_size)
        return merge_words(
            tokens, wid, self.chd_disp, self.chd_rows, self.chd_size, self.chd_n_buckets
        )

    def pair_lookup(self, a: torch.Tensor, b: torch.Tensor, valid: torch.Tensor):
        """(rank, minted) of each pair ``(a, b)`` in the table that
        ``merge_fixpoint`` picks, ``INF_RANK`` on a miss or where
        ``~valid``: the plain probe (the JAX package's
        ``EncodePipeline.pair_lookup``)."""
        if self.qc_t1 is not None:
            return qc_lookup(self.qc_t1, self.qc_t2, self.qc_size, a, b, valid)
        return chd_lookup_rows(self.chd_disp, self.chd_rows, self.chd_size, self.chd_n_buckets,
                               a, b, valid)

    def word_merge(self, bytes_bw, start_bits, row_len):
        """The merge of one pack of word rows over these tables (K6, or its
        plain version on CPU tensors), on the table ``merge_fixpoint``
        picks.  Returns (merged, count) (``ops/wordfill.py:word_merge``)."""
        if self.qc_t1 is not None:
            return word_merge_qc(bytes_bw, start_bits, row_len, self.byte_token_table,
                                 self.qc_t1, self.qc_t2, self.qc_size)
        return word_merge_chd(bytes_bw, start_bits, row_len, self.byte_token_table,
                              self.chd_disp, self.chd_rows, self.chd_size, self.chd_n_buckets)


def _tensor(a: np.ndarray, dtype, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)  # torch keeps the u32 bits in int32
    return torch.from_numpy(a).to(device=device, dtype=dtype)


def _power_of_two(name: str, n: int) -> None:
    if n <= 0 or n & (n - 1):
        raise ValueError(f"{name} {n} is not a power of two")


def tables_to_device(
    *,
    byte_token_table: np.ndarray,
    class_table: np.ndarray,
    device,
    qc_t1: np.ndarray | None = None,
    qc_t2: np.ndarray | None = None,
    qc_size: int | None = None,
    chd_disp: np.ndarray | None = None,
    chd_rows: np.ndarray | None = None,
) -> TorchTables:
    """Numpy table fields -> :class:`TorchTables` on ``device``.

    Takes the cuckoo arrays, the CHD arrays or both; at least one.
    ``qc_t1``/``qc_t2`` are ``[m, 2]`` uint32 (as built) and are held as
    their int32 bit view; ``chd_disp`` is ``[n_buckets]`` and ``chd_rows``
    ``[size, 4]``, both int32, with ``size`` and ``n_buckets`` powers of
    two."""
    has_qc = qc_t1 is not None or qc_t2 is not None or qc_size is not None
    has_chd = chd_disp is not None or chd_rows is not None
    if not (has_qc or has_chd):
        raise ValueError("tables_to_device needs the cuckoo or the CHD arrays")
    out = TorchTables(
        byte_token_table=_tensor(byte_token_table, torch.int32, device),
        class_table=_tensor(class_table, torch.uint8, device),
    )
    if has_qc:
        if qc_t1 is None or qc_t2 is None or qc_size is None:
            raise ValueError("the cuckoo table needs qc_t1, qc_t2 and qc_size")
        _power_of_two("qc_size", qc_size)
        for name, t in (("qc_t1", qc_t1), ("qc_t2", qc_t2)):
            if t.shape != (qc_size, 2):
                raise ValueError(f"{name} has shape {t.shape}, want {(qc_size, 2)}")
        out.qc_t1 = _tensor(qc_t1, torch.int32, device)
        out.qc_t2 = _tensor(qc_t2, torch.int32, device)
        out.qc_size = int(qc_size)
    if has_chd:
        if chd_disp is None or chd_rows is None:
            raise ValueError("the CHD table needs chd_disp and chd_rows")
        if chd_disp.ndim != 1 or chd_rows.ndim != 2 or chd_rows.shape[1] != 4:
            raise ValueError(
                f"chd_disp {chd_disp.shape} / chd_rows {chd_rows.shape}: want [n_buckets] / [size, 4]"
            )
        _power_of_two("CHD n_buckets", chd_disp.shape[0])
        _power_of_two("CHD size", chd_rows.shape[0])
        out.chd_disp = _tensor(chd_disp, torch.int32, device)
        out.chd_rows = _tensor(chd_rows, torch.int32, device)
        out.chd_size = int(chd_rows.shape[0])
        out.chd_n_buckets = int(chd_disp.shape[0])
    return out


def native_from_arrays(
    *,
    pa: np.ndarray,
    pb: np.ndarray,
    pr: np.ndarray,
    rank_new: np.ndarray,
    byte_token_table: np.ndarray,
):
    """Numpy merge arrays -> a native context (``native.NativeEncoder``).

    ``(pa, pb, pr, rank_new)`` are the packed merge arrays
    (``core.bpe.BpeTokenizer.packed_merge_arrays``, or the JAX package's
    method of that name): each kept pair, its rank, and each rank's minted
    id.  ``byte_token_table`` is the [256] int32 byte -> id table.  The
    tokenizer builds its own context from them; the tests use this to feed
    both packages the same arrays."""
    from .native import NativeEncoder

    return NativeEncoder((pa, pb, pr, rank_new), byte_token_table)


def decode_tables_from_padded(mat: np.ndarray, lens: np.ndarray, special: np.ndarray):
    """The JAX package's decode tables (``ops/decode.py:build_decode_tables``:
    ``mat`` [V, W] uint8 with id i's bytes in ``mat[i, :lens[i]]``, ``lens``
    [V] int32, ``special`` [V] bool) -> the port's
    :class:`~.ops.decode.DecodeTables` (the byte arena, its [V + 1]
    offsets and the uint8 special mask)."""
    from .ops.decode import DecodeTables

    mat = np.asarray(mat, np.uint8)
    lens = np.asarray(lens, np.int64)
    V = mat.shape[0]
    if mat.ndim != 2 or lens.shape != (V,) or np.shape(special) != (V,):
        raise ValueError(f"mat {mat.shape}, lens {lens.shape}, special {np.shape(special)}: want [V, W], [V], [V]")
    if lens.min(initial=0) < 0 or lens.max(initial=0) > mat.shape[1]:
        raise ValueError("lens must lie in [0, W]")
    offsets = np.zeros(V + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    arena = mat[np.arange(mat.shape[1])[None, :] < lens[:, None]]  # row-major: id order
    return DecodeTables(arena, offsets, np.asarray(special, bool).astype(np.uint8))

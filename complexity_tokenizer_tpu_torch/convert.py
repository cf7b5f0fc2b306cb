"""Carrying the encode tables across: numpy arrays -> tensors on a device,
and merge arrays -> a native context.

:func:`tables_to_device` takes the table fields as numpy arrays, whichever
package built them (this port's ``ops/tables.py`` or the JAX package's
``DeviceTables``), and returns the :class:`TorchTables` that the port's
pipeline and kernels read.  :func:`native_from_arrays` does the same for
the native runtime's merge arrays.  The pipeline and the tokenizer use them
for their own tables; the tests use them to feed both packages the same
arrays.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["TorchTables", "tables_to_device", "native_from_arrays"]


@dataclass
class TorchTables:
    byte_token_table: torch.Tensor  # [256] int32; -1 = OOV byte
    qc_t1: torch.Tensor  # [m, 2] int32 bit view of the u32 cuckoo rows
    qc_t2: torch.Tensor  # [m, 2] int32
    qc_size: int  # m (power of two)
    class_table: torch.Tensor  # [0x110000] uint8 GPT-2 codepoint classes
    chd_disp: torch.Tensor | None = None  # [n_buckets] int32, when given
    chd_rows: torch.Tensor | None = None  # [size, 4] int32, when given


def _tensor(a: np.ndarray, dtype, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)  # torch keeps the u32 bits in int32
    return torch.from_numpy(a).to(device=device, dtype=dtype)


def tables_to_device(
    *,
    byte_token_table: np.ndarray,
    qc_t1: np.ndarray,
    qc_t2: np.ndarray,
    qc_size: int,
    class_table: np.ndarray,
    device,
    chd_disp: np.ndarray | None = None,
    chd_rows: np.ndarray | None = None,
) -> TorchTables:
    """Numpy table fields -> :class:`TorchTables` on ``device``.

    ``qc_t1``/``qc_t2`` are ``[m, 2]`` uint32 (as built) and are held as
    their int32 bit view.  The CHD arrays are carried only when given: no
    kernel of this slice reads them."""
    for name, t in (("qc_t1", qc_t1), ("qc_t2", qc_t2)):
        if t.shape != (qc_size, 2):
            raise ValueError(f"{name} has shape {t.shape}, want {(qc_size, 2)}")
    if qc_size & (qc_size - 1):
        raise ValueError(f"qc_size {qc_size} is not a power of two")
    return TorchTables(
        byte_token_table=_tensor(byte_token_table, torch.int32, device),
        qc_t1=_tensor(qc_t1, torch.int32, device),
        qc_t2=_tensor(qc_t2, torch.int32, device),
        qc_size=int(qc_size),
        class_table=_tensor(class_table, torch.uint8, device),
        chd_disp=None if chd_disp is None else _tensor(chd_disp, torch.int32, device),
        chd_rows=None if chd_rows is None else _tensor(chd_rows, torch.int32, device),
    )


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

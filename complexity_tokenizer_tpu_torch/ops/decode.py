"""Device batch decode: kernel K7 (id -> bytes gather and compaction) and
its plain version, and the decode pipeline around them.

The twin of the JAX package's ``ops/decode.py``.  The host builds, once per
tokenizer, a byte arena of every id's RAW output bytes (the byte-level
alphabet reversed, other ASCII chars kept, other chars dropped): bytes plus
int64 offsets ``[V + 1]``, the layout the native decoder takes too, and a
``[V]`` special mask.  A batch goes to the device ragged (flat int32 ids,
int64 row offsets) in one copy; K7 keeps the ids with ``0 <= id < V`` that
are not skipped specials and writes the kept ids' bytes back to back with
each row's byte offset; the result comes back in one copy into pinned
memory, and the host decodes each row's UTF-8 with ``"replace"``, as JAX
does.  Nothing is padded to ``[B, T]`` or ``[B, T, W]``.

Output layout of :func:`decode_gather` (and of its plain version): one
uint8 tensor, the ``B + 1`` int64 row byte offsets, then the bytes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.decoders import token_bytes
from ..utils.cuda_build import check, kernel_library

__all__ = [
    "DecodeTables",
    "DecodePipeline",
    "build_decode_tables",
    "decode_arena",
    "decode_gather",
    "decode_gather_plain",
    "decode_gather_sized",
    "special_mask",
    "split_rows",
]

# ids a block of K7 takes (csrc/decode.cu: kTile)
_TILE = 1024


@dataclass
class DecodeTables:
    arena: np.ndarray  # uint8: every id's raw bytes, back to back
    offsets: np.ndarray  # int64 [V + 1]: id i's bytes are arena[offsets[i]:offsets[i + 1]]
    special: np.ndarray  # uint8 [V]: 1 where skip_special drops the id

    @property
    def V(self) -> int:
        return len(self.special)


def decode_arena(vocab_r: dict[int, str]) -> tuple[np.ndarray, np.ndarray]:
    """(arena uint8, offsets int64 [V + 1]) with V = the largest id + 1;
    ids missing from ``vocab_r`` have no bytes.  An empty vocabulary gives
    V = 1 and no bytes, as the JAX table build does."""
    V = max(vocab_r) + 1 if vocab_r else 1
    parts = [token_bytes(vocab_r[i]) if i in vocab_r else b"" for i in range(V)]
    offsets = np.zeros(V + 1, np.int64)
    np.cumsum([len(b) for b in parts], out=offsets[1:])
    return np.frombuffer(b"".join(parts), np.uint8).copy(), offsets


def special_mask(V: int, special_ids) -> np.ndarray:
    """uint8 [V]: 1 at the special ids; ids outside ``[0, V)`` ignored."""
    special = np.zeros(V, np.uint8)
    for i in special_ids:
        if 0 <= i < V:
            special[i] = 1
    return special


def build_decode_tables(vocab_r: dict[int, str], special_ids=()) -> DecodeTables:
    """The decode tables of a vocabulary (id -> token string), specials by id."""
    arena, offsets = decode_arena(vocab_r)
    return DecodeTables(arena, offsets, special_mask(len(offsets) - 1, special_ids))


def decode_gather_plain(ids, row_offsets, arena, offsets, special, skip_special: bool):
    """Plain PyTorch version of K7, on any device: gather each id's bytes,
    mask the dropped ids, compact the kept bytes stably (flat, in id
    order).  Returns the uint8 buffer of :func:`decode_gather`."""
    dev = ids.device
    V = special.shape[0]
    ids = ids.long()
    ok = (ids >= 0) & (ids < V)
    safe = torch.where(ok, ids, 0)
    keep = ok & ~((special[safe] != 0) & bool(skip_special))
    start = offsets[safe]
    tok_len = torch.where(keep, offsets[safe + 1] - start, 0)
    ends = torch.zeros(ids.numel() + 1, dtype=torch.int64, device=dev)
    torch.cumsum(tok_len, 0, out=ends[1:])
    tok_of_byte = torch.repeat_interleave(torch.arange(ids.numel(), device=dev), tok_len)
    within = torch.arange(tok_of_byte.numel(), device=dev) - ends[tok_of_byte]
    out_bytes = arena[start[tok_of_byte] + within]
    out_offsets = ends[row_offsets.long()]
    return torch.cat([out_offsets.view(torch.uint8), out_bytes])


def _check(name: str, t: torch.Tensor, dtype, ndim: int, device) -> None:
    if t.device != device or t.dtype != dtype or t.dim() != ndim:
        raise ValueError(
            f"decode_gather: {name} must be {dtype} with {ndim} dims on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"decode_gather: {name} must be contiguous")


def _checked(ids, row_offsets, arena, offsets, special) -> tuple[int, int, int]:
    """(V, n, B) of K7's CUDA inputs, after checking their types and shapes."""
    dev = ids.device
    _check("ids", ids, torch.int32, 1, dev)
    _check("row_offsets", row_offsets, torch.int64, 1, dev)
    _check("arena", arena, torch.uint8, 1, dev)
    _check("offsets", offsets, torch.int64, 1, dev)
    _check("special", special, torch.uint8, 1, dev)
    V = special.shape[0]
    if offsets.shape[0] != V + 1 or V < 1 or V >= 2**31:
        raise ValueError(f"decode_gather: offsets [{offsets.shape[0]}] must be [V + 1] for V = {V}")
    B = row_offsets.shape[0] - 1
    if B < 0 or B >= 2**31:
        raise ValueError("decode_gather: row_offsets must hold B + 1 entries")
    return V, ids.shape[0], B


def _launch_totals(ids, arena, offsets, special, V: int, skip_special: bool):
    """K7's first launch: (scratch, tiles); scratch[tiles] is the byte total."""
    n = ids.shape[0]
    tiles = -(-n // _TILE)
    scratch = torch.empty(tiles + 2, dtype=torch.int64, device=ids.device)
    check(
        kernel_library().lib.ctok_decode_totals(
            ids.data_ptr(), n, arena.data_ptr(), offsets.data_ptr(), special.data_ptr(),
            V, int(bool(skip_special)), scratch.data_ptr(),
            torch.cuda.current_stream(ids.device).cuda_stream,
        ),
        "decode_gather (totals)",
    )
    decode_gather.launches += 1
    return scratch, tiles


def _launch_scatter(ids, row_offsets, arena, offsets, special, V: int, skip_special: bool,
                    scratch, total: int):
    """K7's second launch into a new buffer of ``total`` bytes."""
    B = row_offsets.shape[0] - 1
    out = torch.empty(8 * (B + 1) + total, dtype=torch.uint8, device=ids.device)
    check(
        kernel_library().lib.ctok_decode_scatter(
            ids.data_ptr(), ids.shape[0], row_offsets.data_ptr(), B, arena.data_ptr(),
            offsets.data_ptr(), special.data_ptr(), V, int(bool(skip_special)),
            scratch.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(ids.device).cuda_stream,
        ),
        "decode_gather (scatter)",
    )
    decode_gather.launches += 1
    return out


def decode_gather(ids, row_offsets, arena, offsets, special, skip_special: bool):
    """K7 on CUDA tensors (two launches), the plain version on CPU tensors.

    Args:
      ids: [N] int32 flat ids; any value (ids outside ``[0, V)`` are dropped).
      row_offsets: [B + 1] int64, non-decreasing, from 0 to N: row r's ids are
        ``ids[row_offsets[r]:row_offsets[r + 1]]``.
      arena, offsets, special: the :class:`DecodeTables` on the device.
      skip_special: drop the ids that ``special`` marks.
    Returns:
      uint8 [8 (B + 1) + total]: the int64 row byte offsets, then the bytes.
    """
    if ids.device.type == "cpu":
        return decode_gather_plain(ids, row_offsets, arena, offsets, special, skip_special)
    if ids.device.type != "cuda":
        raise ValueError(f"decode_gather: unsupported device {ids.device}")
    V, n, B = _checked(ids, row_offsets, arena, offsets, special)
    if n == 0:  # no id: every row is empty, no launch
        return torch.zeros(8 * (B + 1), dtype=torch.uint8, device=ids.device)
    scratch, tiles = _launch_totals(ids, arena, offsets, special, V, skip_special)
    total = int(scratch[tiles])  # the one read back between the launches
    return _launch_scatter(ids, row_offsets, arena, offsets, special, V, skip_special,
                           scratch, total)


def decode_gather_sized(ids, row_offsets, arena, offsets, special, skip_special: bool,
                        total: int):
    """K7's two launches on CUDA tensors with the output's byte count given,
    so that both can be captured in one CUDA graph (which cannot read the
    total back between them).  ``total`` must be the byte count that
    :func:`decode_gather` finds for the same inputs: the kernel writes every
    kept byte."""
    if ids.device.type != "cuda":
        raise ValueError(f"decode_gather_sized: unsupported device {ids.device}")
    V, n, _B = _checked(ids, row_offsets, arena, offsets, special)
    if n == 0:
        raise ValueError("decode_gather_sized: no id to launch on")
    scratch, _tiles = _launch_totals(ids, arena, offsets, special, V, skip_special)
    return _launch_scatter(ids, row_offsets, arena, offsets, special, V, skip_special,
                           scratch, total)


decode_gather.launches = 0  # launches of K7's two kernels (not of the plain version)


def split_rows(buf: np.ndarray, B: int) -> list[bytes]:
    """The host view of :func:`decode_gather`'s buffer: each row's bytes."""
    offs = buf[: 8 * (B + 1)].view(np.int64)
    data = buf[8 * (B + 1) :].tobytes()
    return [data[offs[i] : offs[i + 1]] for i in range(B)]


class DecodePipeline:
    """The decode tables on one device, and the batch decode there."""

    def __init__(self, tables: DecodeTables, device):
        self.device = torch.device(device)
        self.tables = tables
        self.V = tables.V
        to = dict(device=self.device)
        arena = tables.arena if tables.arena.size else np.zeros(1, np.uint8)
        self.arena = torch.from_numpy(arena).to(**to)
        self.offsets = torch.from_numpy(tables.offsets).to(**to)
        self.special = torch.from_numpy(tables.special).to(**to)

    def decode_ragged_bytes(self, flat_ids, row_offsets, skip_special: bool = False) -> list[bytes]:
        """Each row's raw bytes from ragged rows (flat ids, int64 row offsets
        ``[B + 1]``, non-decreasing)."""
        row_offsets = np.asarray(row_offsets, np.int64)
        B = len(row_offsets) - 1
        if B < 0:
            raise ValueError("row_offsets must hold B + 1 entries")
        flat_ids = np.asarray(flat_ids)
        o0, oB = int(row_offsets[0]), int(row_offsets[-1])
        if o0 < 0 or oB > flat_ids.size or np.any(np.diff(row_offsets) < 0):
            raise ValueError("inconsistent ragged decode input")
        ids = flat_ids[o0:oB]
        if ids.dtype != np.int32:  # ids past int32 are dropped like any id >= V
            ids = np.where((ids < -(2**31)) | (ids >= 2**31), -1, ids).astype(np.int32)
        n = oB - o0
        cuda = self.device.type == "cuda"
        # one staging buffer: the row offsets (from 0), then the ids
        stage = torch.empty(8 * (B + 1) + 4 * n, dtype=torch.uint8, pin_memory=cuda)
        st = stage.numpy()
        np.subtract(row_offsets, o0, out=st[: 8 * (B + 1)].view(np.int64))
        st[8 * (B + 1) :].view(np.int32)[:] = ids
        dev = stage.to(self.device, non_blocking=cuda)
        offs_t = dev[: 8 * (B + 1)].view(torch.int64)
        ids_t = dev[8 * (B + 1) :].view(torch.int32)
        out = decode_gather(ids_t, offs_t, self.arena, self.offsets, self.special, skip_special)
        if cuda:
            host = torch.empty(out.shape, dtype=torch.uint8, pin_memory=True)
            host.copy_(out, non_blocking=True)
            torch.cuda.current_stream(self.device).synchronize()
            out = host
        return split_rows(out.numpy(), B)

    def decode_ragged(self, flat_ids, row_offsets, skip_special: bool = False) -> list[str]:
        return [
            b.decode("utf-8", "replace")
            for b in self.decode_ragged_bytes(flat_ids, row_offsets, skip_special)
        ]

    def decode_batch(self, batch, skip_special: bool = False) -> list[str]:
        """Rows of ids -> strings (the JAX ``DecodePipeline.decode_batch``)."""
        from itertools import chain

        row_offsets = np.zeros(len(batch) + 1, np.int64)
        np.cumsum([len(r) for r in batch], out=row_offsets[1:])
        flat = np.fromiter(chain.from_iterable(batch), np.int64, count=int(row_offsets[-1]))
        return self.decode_ragged(flat, row_offsets, skip_special)

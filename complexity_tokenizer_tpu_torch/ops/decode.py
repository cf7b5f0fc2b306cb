"""Device batch decode: kernel K7 (id -> bytes gather and compaction) and
its plain version, and the decode pipeline around them.

The twin of the JAX package's ``ops/decode.py``.  The host builds, once per
tokenizer, a byte arena of every id's RAW output bytes (the byte-level
alphabet reversed, other ASCII chars kept, other chars dropped): bytes plus
int64 offsets ``[V + 1]``, the layout the native decoder takes too, and a
``[V]`` special mask; from them, K7's table of one 16-byte entry per id
(:func:`decode_entries`: length, special flag, and the bytes inline up to
12, else the start in the arena).  A batch goes to the device ragged (flat
int32 ids, int64 row offsets) in one copy; K7 keeps the ids with
``0 <= id < V`` that are not skipped specials and writes the kept ids'
bytes back to back with each row's byte offset; the host reads the byte
total, then the live part comes back in one copy into pinned memory, and
the host decodes each row's UTF-8 with ``"replace"``, as JAX does.  Nothing
is padded to ``[B, T]`` or ``[B, T, W]``.

Output layout of :func:`decode_gather` (and of its plain version): one
uint8 tensor, the ``B + 1`` int64 row byte offsets (the last is the byte
total), then the bytes.  On the card the buffer is sized before the total
is known, by the caller's capacity; only its live part
(:func:`live_part`) holds the result.
"""

from __future__ import annotations

import ctypes
import threading
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
    "decode_entries",
    "decode_gather",
    "decode_gather_plain",
    "decode_launch_shape",
    "decode_state",
    "live_part",
    "special_mask",
    "split_rows",
]

# ids a block of K7 takes (csrc/decode.cu: kTile)
_TILE = 1024
# bytes of a token that its K7 table entry holds inline (csrc/decode.cu: kInline)
_INLINE = 12
# K7 takes tokens shorter than this, so that a tile's bytes fit an int32
_MAX_TOKEN = 1 << 20


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


def decode_entries(tables: DecodeTables) -> np.ndarray:
    """K7's table: one 16-byte entry per id, int32 ``[V, 4]``, built from
    ``arena``, ``offsets`` and ``special`` (which stay as they are).

    Word 0 holds the id's byte length (bits 0-30) and its special flag (bit
    31).  A token of at most 12 bytes has its bytes in entry bytes 4-15
    (byte b of the token at entry byte 4 + b, the rest 0); a longer one has
    its start in ``arena`` there instead, as an int64 in words 1-2 (low word
    first), and word 3 is 0."""
    offsets = tables.offsets
    V = tables.V
    lens = np.diff(offsets)
    if lens.size and int(lens.max()) >= _MAX_TOKEN:
        raise ValueError(f"decode_entries: a token of {int(lens.max())} bytes (limit {_MAX_TOKEN - 1})")
    ent = np.zeros((V, 4), np.uint32)
    ent[:, 0] = lens.astype(np.uint32) | (tables.special.astype(np.uint32) << 31)
    short = lens <= _INLINE
    col = np.arange(_INLINE)
    take = short[:, None] & (col < lens[:, None])
    ent.view(np.uint8).reshape(V, 16)[:, 4:][take] = tables.arena[(offsets[:-1, None] + col)[take]]
    start = offsets[:-1][~short]
    ent[~short, 1] = (start & 0xFFFFFFFF).astype(np.uint32)
    ent[~short, 2] = (start >> 32).astype(np.uint32)
    return ent.view(np.int32)


def decode_gather_plain(ids, row_offsets, entries, arena, skip_special: bool):
    """Plain PyTorch version of K7, on any device: each id's entry, the
    dropped ids masked, the kept bytes compacted stably (flat, in id order),
    each read inline from its entry or from ``arena``.  Returns the uint8
    buffer of :func:`decode_gather`, exactly as long as its live part."""
    dev = ids.device
    V = entries.shape[0]
    ids = ids.long()
    ok = (ids >= 0) & (ids < V)
    ent = entries[torch.where(ok, ids, 0)]
    word0 = ent[:, 0].long() & 0xFFFFFFFF
    length = word0 & 0x7FFFFFFF
    keep = ok & ~((word0 >> 31 != 0) & bool(skip_special))
    tok_len = torch.where(keep, length, 0)
    ends = torch.zeros(ids.numel() + 1, dtype=torch.int64, device=dev)
    torch.cumsum(tok_len, 0, out=ends[1:])
    tok_of_byte = torch.repeat_interleave(torch.arange(ids.numel(), device=dev), tok_len)
    within = torch.arange(tok_of_byte.numel(), device=dev) - ends[tok_of_byte]
    inline = ent[:, 1:].contiguous().view(torch.uint8)  # [N, 12]
    long_tok = length[tok_of_byte] > _INLINE
    out_bytes = inline[tok_of_byte, torch.where(long_tok, 0, within)]
    start = (ent[:, 1].long() & 0xFFFFFFFF) | (ent[:, 2].long() << 32)
    out_bytes[long_tok] = arena[(start[tok_of_byte] + within)[long_tok]]
    out_offsets = ends[row_offsets.long()]
    return torch.cat([out_offsets.view(torch.uint8), out_bytes])


def _check(name: str, t: torch.Tensor, dtype, ndim: int, device, align: int = 1) -> None:
    if t.device != device or t.dtype != dtype or t.dim() != ndim:
        raise ValueError(
            f"decode_gather: {name} must be {dtype} with {ndim} dims on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"decode_gather: {name} must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"decode_gather: {name} must start on a {align}-byte boundary")


def decode_state(n: int, device) -> torch.Tensor:
    """K7's state for up to ``n`` ids: int64 ``[tiles + 2]`` zeros (a tile
    ticket, a count of finished tiles, a status word per tile).  K7 leaves
    it zero, so one state serves every later call of as many ids or fewer,
    one call at a time."""
    return torch.zeros(-(-max(n, 1) // _TILE) + 2, dtype=torch.int64, device=device)


def decode_gather(ids, row_offsets, entries, arena, skip_special: bool, capacity: int,
                  out=None, state=None):
    """K7 on CUDA tensors (one launch), the plain version on CPU tensors.

    Args:
      ids: [N] int32 flat ids; any value (ids outside ``[0, V)`` are dropped).
      row_offsets: [B + 1] int64, non-decreasing, from 0 to N: row r's ids are
        ``ids[row_offsets[r]:row_offsets[r + 1]]``.
      entries: [V, 4] int32, :func:`decode_entries` on the device.
      arena: uint8, the decode tables' arena on the device, padded with zeros
        to a multiple of 16 bytes (K7 reads it 16 aligned bytes at a time).
      skip_special: drop the ids that the entries mark special.
      capacity: (CUDA) the bytes the output may hold after its row offsets:
        N times the longest token always suffices; K7 writes none past it.
      out: (CUDA) a uint8 buffer of at least ``8 (B + 1) + capacity`` bytes
        to write into; a new one when None.
      state: (CUDA) :func:`decode_state` for at least N ids; a new one (a
        memset) when None.  Calls that share a state must not overlap.
    Returns:
      CUDA: uint8 ``[8 (B + 1) + capacity]``, the int64 row byte offsets
      (the last the byte total) then the bytes; :func:`live_part` is the
      result.  CPU: exactly the live part.
    """
    if ids.device.type == "cpu":
        return decode_gather_plain(ids, row_offsets, entries, arena, skip_special)
    if ids.device.type != "cuda":
        raise ValueError(f"decode_gather: unsupported device {ids.device}")
    dev = ids.device
    _check("ids", ids, torch.int32, 1, dev)
    _check("row_offsets", row_offsets, torch.int64, 1, dev)
    _check("entries", entries, torch.int32, 2, dev, 16)  # read 16 bytes at a time
    _check("arena", arena, torch.uint8, 1, dev, 16)
    V, n, B = entries.shape[0], ids.shape[0], row_offsets.shape[0] - 1
    if entries.shape[1] != 4 or V < 1 or V >= 2**31:
        raise ValueError(f"decode_gather: entries {tuple(entries.shape)} must be [V, 4]")
    if arena.numel() % 16:
        raise ValueError("decode_gather: the arena must be padded to a multiple of 16 bytes")
    if B < 0 or B >= 2**31:
        raise ValueError("decode_gather: row_offsets must hold B + 1 entries")
    if capacity < 0:
        raise ValueError("decode_gather: capacity must be >= 0")
    need = 8 * (B + 1) + capacity
    if out is None:
        out = torch.empty(need, dtype=torch.uint8, device=dev)
    else:
        _check("out", out, torch.uint8, 1, dev, 8)  # the row offsets are int64
        if out.numel() < need:
            raise ValueError(f"decode_gather: out holds {out.numel()} bytes, {need} needed")
        out = out[:need]
    if n == 0:  # no id: every row is empty, no launch
        out[: 8 * (B + 1)].zero_()
        return out
    tiles = -(-n // _TILE)
    if state is None:
        state = decode_state(n, dev)
    _check("state", state, torch.int64, 1, dev)
    if state.numel() < tiles + 2:
        raise ValueError(f"decode_gather: the state holds {state.numel()} words, {tiles + 2} needed")
    check(
        kernel_library().lib.ctok_decode_gather(
            ids.data_ptr(), n, row_offsets.data_ptr(), B, entries.data_ptr(), arena.data_ptr(), V,
            int(bool(skip_special)), state.data_ptr(), out.data_ptr(), capacity,
            torch.cuda.current_stream(dev).cuda_stream,
        ),
        "decode_gather",
    )
    decode_gather.launches += 1
    return out


decode_gather.launches = 0  # launches of K7 (not of the plain version)


def decode_launch_shape() -> dict:
    """How the card launches K7: threads a block, registers a thread,
    static shared bytes a block, local (stack) bytes a thread, resident
    blocks per SM.  Needs a card; launches nothing."""
    info = (ctypes.c_int * 5)()
    check(kernel_library().lib.ctok_decode_info(ctypes.addressof(info)), "decode_launch_shape")
    return dict(zip(("threads", "registers", "static_smem", "local_bytes", "blocks_per_sm"), info))


def live_part(buf: torch.Tensor, B: int) -> torch.Tensor:
    """The result in a :func:`decode_gather` buffer: its row offsets and
    its byte total's bytes (reads the total: on the card, a sync)."""
    total = int(buf[8 * B : 8 * (B + 1)].view(torch.int64)[0])
    return buf[: 8 * (B + 1) + total]


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
        lens = np.diff(tables.offsets)
        self.max_len = int(lens.max()) if lens.size else 0  # the longest token's bytes
        arena = np.zeros(-(-max(tables.arena.size, 1) // 16) * 16, np.uint8)  # K7 reads 16 at a time
        arena[: tables.arena.size] = tables.arena
        self.entries = torch.from_numpy(decode_entries(tables)).to(self.device)
        self.arena = torch.from_numpy(arena).to(self.device)
        # K7's output buffer and state on the card, grown as calls need;
        # one call at a time uses them
        self._lock = threading.Lock()
        self._out: torch.Tensor | None = None
        self._state: torch.Tensor | None = None

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
        if not cuda:
            out = decode_gather(ids_t, offs_t, self.entries, self.arena, skip_special, 0)
            return split_rows(out.numpy(), B)
        stream = torch.cuda.current_stream(self.device)
        with self._lock:
            capacity = n * self.max_len
            if self._out is None or self._out.numel() < 8 * (B + 1) + capacity:
                self._out = torch.empty(8 * (B + 1) + capacity, dtype=torch.uint8, device=self.device)
            if self._state is None or self._state.numel() < -(-n // _TILE) + 2:
                self._state = decode_state(n, self.device)
            out = decode_gather(ids_t, offs_t, self.entries, self.arena, skip_special, capacity,
                                out=self._out, state=self._state)
            # the byte total, then the row offsets and the live bytes
            total = torch.empty(1, dtype=torch.int64, pin_memory=True)
            total.copy_(out[8 * B : 8 * (B + 1)].view(torch.int64), non_blocking=True)
            stream.synchronize()
            host = torch.empty(8 * (B + 1) + int(total[0]), dtype=torch.uint8, pin_memory=True)
            host.copy_(out[: host.numel()], non_blocking=True)
            stream.synchronize()
        return split_rows(host.numpy(), B)

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

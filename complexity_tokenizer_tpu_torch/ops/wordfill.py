"""The word path's device fill: kernels K6 and K4, and K3 beside them.

``word_fill(bytes_bw, start_bits, row_len, cap, ...)`` is the twin of the
JAX package's unphased fill body (``ops/wordpath.py``,
``DeviceWordEncoder._local_fill_body``): packed word rows ``[B, W]`` -> one
fused uint8 buffer, ``[cap ids (uint16 or int32) | B*W/8 alive bits | int32
total]``, byte for byte the JAX body's layout.  On the card it is two
launches:

- K6 (:func:`word_merge`, ``csrc/kernels.cu``: the merge fixpoint with the
  row policy ``FillRows``), through ``TorchTables.word_merge``, which picks
  the cuckoo or the CHD table as ``merge_fixpoint`` does: the packed bytes
  and start bits -> the merged rows ``[B, W]`` int32 and their live counts.
  It folds three steps into one launch:
  - K3 (:func:`word_ids`): start bits -> word ids, -1 at and past
    ``row_len``;
  - K1 (``ops/seed.py``): bytes -> token ids, -1 at and past ``row_len``;
  - K2 or K5 (``ops/merge.py``): the merge fixpoint, and each row's live
    count.
- K4 (:func:`fill_compact`): the fused buffer, launched as the
  programmatic dependent of the kernel before it on the stream, so that
  after K6 its launch overlaps K6's rows (``csrc/wordfill.cu``).

K3 stays a kernel of its own, with its plain version: no path launches
it, but :func:`word_fill_chain` (K3 -> K1 -> fixpoint -> K4, four
launches) is K6's yardstick on the card.  :func:`fill_row_flags` is the
plain model of K6's prologue: the word starts and gaps it derives from the
start bits without word ids.

K3 counts word starts within each row where the JAX body counts over the
flattened pack: equal for K2 on rows packed by ``ctok_pack_seg`` (the
kernel's note in ``csrc/wordfill.cu`` gives the reason).

``word_fill_phased(..., n1)`` is the twin of the JAX phased fill body
(``CTOK_PHASE_N1 = n1``; ``ops/merge.py:phased_merge_words``): the fused
buffer ``[cap ids | B*W/16 alive bits | B*W/16 word-start bits | int32
total]`` of the [B/2, W] rows, byte for byte, with the spill sentinel
``B*W + 1`` as the total when a row keeps more than W/2 lanes.  On the card
it is three launches:

- K20 (:func:`phase_compact`, ``csrc/kernels.cu``): the packed bytes ->
  block-flat word ids (:func:`block_word_ids_plain`, the JAX count over the
  flattened pack, not K3's), the seed, ``n1`` steps of the JAX fixpoint
  step and the compaction of each row's kept lanes into half-rows: tokens
  and word ids [B/2, W] and each row's kept lanes;
- K2 or K5 (``TorchTables.merge_fixpoint``) finishing the fixpoint on the
  [B/2, W] rows, with K20's word ids;
- K4's phased mode (:func:`fill_compact_phased`): the fused buffer.

Each wrapper runs its plain version for a CPU tensor and, for a CUDA
tensor, launches its kernel or raises.
"""

from __future__ import annotations

import torch

from ..utils.cuda_build import check, kernel_library
from .merge import (
    compact_half_rows_plain,
    merge_fixpoint_chd_plain,
    merge_fixpoint_qc_plain,
    segmented_fixpoint_bounded_plain,
)
from .seed import seed_tokens, seed_tokens_plain

__all__ = [
    "word_ids",
    "word_ids_plain",
    "fill_row_flags",
    "fill_compact",
    "fill_compact_plain",
    "fill_layout",
    "word_merge",
    "word_merge_plain",
    "word_merge_qc",
    "word_merge_chd",
    "word_fill",
    "word_fill_plain",
    "word_fill_chain",
    "block_word_ids_plain",
    "phase_compact",
    "phase_compact_plain",
    "fill_layout_phased",
    "fill_compact_phased",
    "fill_compact_phased_plain",
    "word_fill_phased",
    "word_fill_phased_plain",
]


def word_ids_plain(start_bits: torch.Tensor, row_len: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K3, on any device: row-local running count
    of the start bits, minus one, and -1 at and past ``row_len``."""
    B, nb = start_bits.shape
    W = nb * 8
    pos = torch.arange(W, device=start_bits.device)
    bits = start_bits.repeat_interleave(8, dim=1).to(torch.int32)
    starts = (bits >> (pos % 8).to(torch.int32)) & 1
    valid = pos[None, :] < row_len[:, None]
    starts = torch.where(valid, starts, 0)
    wid = torch.cumsum(starts, dim=1, dtype=torch.int32) - 1
    return torch.where(valid, wid, -1).to(torch.int32)


def _check_args(fn: str, ref: torch.Tensor, specs) -> None:
    for name, t, dtype, shape in specs:
        if t.device != ref.device or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"{fn}: {name} must be {dtype} {shape} on {ref.device}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")


def word_ids(start_bits: torch.Tensor, row_len: torch.Tensor) -> torch.Tensor:
    """K3 on a CUDA tensor, the plain version on a CPU tensor.

    Args:
      start_bits: [B, W/8] uint8, bit c % 8 of byte c / 8 marks a word
        start at column c (``packbits(..., bitorder="little")``).
      row_len: [B] int32 content length of each row.
    Returns:
      [B, W] int32 word ids.
    """
    if start_bits.device.type == "cpu":
        return word_ids_plain(start_bits, row_len)
    if start_bits.device.type != "cuda":
        raise ValueError(f"word_ids: unsupported device {start_bits.device}")
    B, nb = start_bits.shape
    _check_args("word_ids", start_bits, (
        ("start_bits", start_bits, torch.uint8, (B, nb)),
        ("row_len", row_len, torch.int32, (B,)),
    ))
    W = nb * 8
    out = torch.empty((B, W), dtype=torch.int32, device=start_bits.device)
    if out.numel() == 0:
        return out
    lib = kernel_library().lib
    stream = torch.cuda.current_stream(start_bits.device).cuda_stream
    check(
        lib.ctok_word_ids(start_bits.data_ptr(), row_len.data_ptr(), out.data_ptr(), B, W, stream),
        "word_ids",
    )
    word_ids.launches += 1
    return out


word_ids.launches = 0  # launches of K3 (not of the plain version)


def fill_layout(B: int, W: int, cap: int, itemsize: int) -> tuple[int, int, int]:
    """Byte offsets of the fused buffer: (alive bits, total, size)."""
    bits = cap * itemsize
    total = bits + B * W // 8
    return bits, total, total + 4


def _le_bytes(v: torch.Tensor, itemsize: int) -> torch.Tensor:
    """Little-endian bytes of the integers ``v``, ``itemsize`` each."""
    v = v.to(torch.int64)
    parts = [(v >> (8 * k)) & 0xFF for k in range(itemsize)]
    return torch.stack(parts, dim=-1).reshape(-1).to(torch.uint8)


def _pack_bits(x: torch.Tensor) -> torch.Tensor:
    """[R, W] bool -> [R * W / 8] uint8, little endian within each byte."""
    R, W = x.shape
    weights = 1 << torch.arange(8, device=x.device)
    return (x.reshape(R, W // 8, 8).to(torch.int64) * weights).sum(dim=2).reshape(-1).to(torch.uint8)


def fill_compact_plain(
    merged: torch.Tensor, count: torch.Tensor, cap: int, itemsize: int
) -> torch.Tensor:
    """Plain PyTorch version of K4, on any device (see :func:`fill_compact`)."""
    alive = merged >= 0
    live = merged.reshape(-1)[alive.reshape(-1)]
    total = count.sum(dtype=torch.int64)
    ids = torch.full((cap,), -1, dtype=torch.int64, device=merged.device)
    n = min(live.numel(), cap)
    ids[:n] = live[:n]
    return torch.cat([_le_bytes(ids, itemsize), _pack_bits(alive), _le_bytes(total.reshape(1), 4)])


def fill_compact(
    merged: torch.Tensor, count: torch.Tensor, cap: int, itemsize: int
) -> torch.Tensor:
    """K4 on a CUDA tensor, the plain version on a CPU tensor.  On the card
    it is launched as the programmatic dependent of the work before it on
    the stream: right after any work, early after K6 (:func:`word_fill`).

    Args:
      merged: [B, W] int32 K2 output, -1 at dead lanes; W % 8 == 0.
      count: [B] int32 live ids of each row (K2's count).
      cap: id slots of the buffer.
      itemsize: 2 (uint16 ids) or 4 (int32 ids).
    Returns:
      [cap*itemsize + B*W/8 + 4] uint8: the first ``cap`` live ids in flat
      order, then -1 up to ``cap``; the alive bitmap, little endian within
      each byte; the int32 total of live ids (it may exceed ``cap``).
    """
    if itemsize not in (2, 4):
        raise ValueError(f"fill_compact: itemsize must be 2 or 4, got {itemsize}")
    B, W = merged.shape
    if W % 8:
        raise ValueError(f"fill_compact: W={W} is not a multiple of 8")
    if cap < 0 or cap > B * W:
        raise ValueError(f"fill_compact: cap={cap} outside [0, {B * W}]")
    if merged.device.type == "cpu":
        return fill_compact_plain(merged, count, cap, itemsize)
    if merged.device.type != "cuda":
        raise ValueError(f"fill_compact: unsupported device {merged.device}")
    _check_args("fill_compact", merged, (
        ("merged", merged, torch.int32, (B, W)),
        ("count", count, torch.int32, (B,)),
    ))
    out = torch.empty(fill_layout(B, W, cap, itemsize)[2], dtype=torch.uint8, device=merged.device)
    lib = kernel_library().lib
    stream = torch.cuda.current_stream(merged.device).cuda_stream
    check(
        lib.ctok_fill_compact(
            merged.data_ptr(), count.data_ptr(), out.data_ptr(), B, W, cap, itemsize, stream
        ),
        "fill_compact",
    )
    fill_compact.launches += 1
    return out


fill_compact.launches = 0  # launches of K4 (not of the plain version)


def fill_row_flags(start_bits: torch.Tensor, row_len: torch.Tensor):
    """Plain model of K6's prologue, on any device: the word starts and
    gaps of each row, from the start bits and ``row_len`` alone.

    A position is a gap (word id -1 in :func:`word_ids_plain`) at or past
    ``row_len`` and before the row's first start bit; a start (where the
    word id changes) at column 0, at a set bit before ``row_len``, and at
    ``row_len`` when a word ends there.  Returns (starts, gaps), [B, W]
    bool."""
    B, nb = start_bits.shape
    W = nb * 8
    pos = torch.arange(W, device=start_bits.device)[None, :]
    bits = start_bits.repeat_interleave(8, dim=1).to(torch.int32)
    n = row_len.clamp(0, W)[:, None]
    valid = pos < n
    set_bit = valid & (((bits >> (pos % 8).to(torch.int32)) & 1) == 1)
    first = torch.where(set_bit, pos, W).amin(dim=1, keepdim=True)  # W: no start
    gaps = ~valid | (pos < first)
    starts = (pos == 0) | set_bit | ((pos == n) & (first < n))
    return starts, gaps


def _merge_plain(bytes_bw, start_bits, row_len, byte_table, fixpoint):
    wid = word_ids_plain(start_bits, row_len)
    tokens = seed_tokens_plain(bytes_bw, row_len, byte_table)
    return fixpoint(tokens, wid)


def _fixpoint_plain_of(tables):
    """The plain fixpoint of the table ``merge_fixpoint`` picks."""
    if tables.qc_t1 is not None:
        def fixpoint(t, w):
            return merge_fixpoint_qc_plain(t, w, tables.qc_t1, tables.qc_t2, tables.qc_size)
    else:
        def fixpoint(t, w):
            return merge_fixpoint_chd_plain(
                t, w, tables.chd_disp, tables.chd_rows, tables.chd_size, tables.chd_n_buckets
            )
    return fixpoint


def word_merge_plain(bytes_bw, start_bits, row_len, *, tables):
    """Plain PyTorch version of K6, on any device: the plain versions of K3,
    K1 and the fixpoint of ``tables`` (as ``TorchTables.merge_fixpoint``
    picks it), one after the other.  Returns (merged [B, W] int32, count
    [B] int32)."""
    return _merge_plain(bytes_bw, start_bits, row_len, tables.byte_token_table,
                        _fixpoint_plain_of(tables))


def word_merge(bytes_bw, start_bits, row_len, *, tables):
    """K6 on CUDA tensors (one launch), :func:`word_merge_plain` on CPU
    tensors: packed word rows -> (merged [B, W] int32, -1 at dead lanes;
    count [B] int32, the live ids of each row), on the table of ``tables``
    that ``merge_fixpoint`` picks.  Arguments as :func:`word_fill`."""
    return tables.word_merge(bytes_bw, start_bits, row_len)


word_merge.launches = 0  # launches of K6 (not of the plain version)


def _launch_merge(fn: str, entry: str, max_W: int, bytes_bw, start_bits, row_len, byte_table,
                  tables, table_args):
    """Checks the arguments of K6 on CUDA tensors and launches it on the
    bytes' current stream; ``tables`` are (name, tensor, shape) of the pair
    table, ``table_args`` its C arguments.  Returns (merged, count)."""
    if bytes_bw.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {bytes_bw.device}")
    B, W = bytes_bw.shape
    if W % 8 or W > max_W:
        raise ValueError(f"{fn}: W={W} must be a multiple of 8 and at most {max_W}")
    _check_args(fn, bytes_bw, (
        ("bytes_bw", bytes_bw, torch.uint8, (B, W)),
        ("start_bits", start_bits, torch.uint8, (B, W // 8)),
        ("row_len", row_len, torch.int32, (B,)),
        ("byte_table", byte_table, torch.int32, (256,)),
        *((name, t, torch.int32, shape) for name, t, shape in tables),
    ))
    merged = torch.empty((B, W), dtype=torch.int32, device=bytes_bw.device)
    count = torch.empty(B, dtype=torch.int32, device=bytes_bw.device)
    if merged.numel() == 0:
        return merged, count.zero_()
    stream = torch.cuda.current_stream(bytes_bw.device).cuda_stream
    check(
        getattr(kernel_library().lib, entry)(
            bytes_bw.data_ptr(), start_bits.data_ptr(), row_len.data_ptr(), byte_table.data_ptr(),
            *table_args, merged.data_ptr(), count.data_ptr(), B, W, stream,
        ),
        fn,
    )
    word_merge.launches += 1
    return merged, count


def word_merge_qc(bytes_bw, start_bits, row_len, byte_table, t1, t2, size: int):
    """K6 on the u16 cuckoo table (K2's walk) for CUDA tensors, the plain
    composition for CPU tensors; arguments as :func:`word_fill`, with the
    byte table and the cuckoo table of ``TorchTables``."""
    if bytes_bw.device.type == "cpu":
        return _merge_plain(bytes_bw, start_bits, row_len, byte_table,
                            lambda t, w: merge_fixpoint_qc_plain(t, w, t1, t2, size))
    if size <= 0 or size & (size - 1):
        raise ValueError(f"word_merge_qc: table size {size} is not a power of two")
    return _launch_merge(
        "word_merge_qc", "ctok_word_merge_qc", 16384, bytes_bw, start_bits, row_len, byte_table,
        (("t1", t1, (size, 2)), ("t2", t2, (size, 2))), (t1.data_ptr(), t2.data_ptr(), size - 1),
    )


def word_merge_chd(bytes_bw, start_bits, row_len, byte_table, disp, rows, size: int,
                   n_buckets: int):
    """K6 on the CHD table (K5's walk) for CUDA tensors, the plain
    composition for CPU tensors; arguments as :func:`word_merge_qc`, with
    the CHD table."""
    if bytes_bw.device.type == "cpu":
        return _merge_plain(
            bytes_bw, start_bits, row_len, byte_table,
            lambda t, w: merge_fixpoint_chd_plain(t, w, disp, rows, size, n_buckets),
        )
    for name, n in (("table size", size), ("bucket count", n_buckets)):
        if n <= 0 or n & (n - 1):
            raise ValueError(f"word_merge_chd: {name} {n} is not a power of two")
    if rows.data_ptr() % 16:
        raise ValueError("word_merge_chd: rows must be 16-byte aligned (one int4 load a probe)")
    return _launch_merge(
        "word_merge_chd", "ctok_word_merge_chd", 12288, bytes_bw, start_bits, row_len, byte_table,
        (("disp", disp, (n_buckets,)), ("rows", rows, (size, 4))),
        (disp.data_ptr(), rows.data_ptr(), size - 1, n_buckets - 1),
    )


def word_fill_plain(bytes_bw, start_bits, row_len, cap: int, *, tables, itemsize: int):
    """Plain PyTorch version of the fill, on any device: the plain versions
    of K3, K1, the fixpoint of ``tables`` and K4, one after the other."""
    merged, count = word_merge_plain(bytes_bw, start_bits, row_len, tables=tables)
    return fill_compact_plain(merged, count, cap, itemsize)


def word_fill_chain(bytes_bw, start_bits, row_len, cap: int, *, tables, itemsize: int):
    """The fill as four launches, K3 -> K1 -> K2 or K5 -> K4 (on CPU
    tensors their plain versions): the yardstick of K6, which no path
    runs."""
    wid = word_ids(start_bits, row_len)
    tokens = seed_tokens(bytes_bw, row_len, tables.byte_token_table)
    merged, count = tables.merge_fixpoint(tokens, wid)
    return fill_compact(merged, count, cap, itemsize)


def word_fill(bytes_bw, start_bits, row_len, cap: int, *, tables, itemsize: int):
    """The fill of one pack of word rows: K6 then K4 on CUDA tensors (two
    launches), their plain versions on CPU tensors.

    Args:
      bytes_bw: [B, W] uint8 packed words (``ctok_pack_seg``); W % 8 == 0.
      start_bits: [B, W/8] uint8 word-start bitmap, little endian.
      row_len: [B] int32 content length of each row.
      cap: id slots of the fused buffer (``B*W*3/8``, or ``B*W`` when a
        pack is dispatched again after a spill).
      tables: the pipeline's ``TorchTables`` on the same device.
      itemsize: 2 when every producible id is below 65,535, else 4.
    Returns:
      the fused uint8 buffer of :func:`fill_compact`.
    """
    merged, count = word_merge(bytes_bw, start_bits, row_len, tables=tables)
    return fill_compact(merged, count, cap, itemsize)


# ---------------------------------------------------------------------------
# the phased fill: K20, then K2 or K5, then K4's phased mode


def block_word_ids_plain(start_bits: torch.Tensor, row_len: torch.Tensor) -> torch.Tensor:
    """The JAX fill body's word ids, on any device: the running count of the
    start bits over the flattened pack (block-flat, where K3 counts within
    each row), minus one, and -1 at and past ``row_len``."""
    B, nb = start_bits.shape
    W = nb * 8
    pos = torch.arange(W, device=start_bits.device)
    bits = start_bits.repeat_interleave(8, dim=1).to(torch.int32)
    valid = pos[None, :] < row_len[:, None]
    starts = torch.where(valid, (bits >> (pos % 8).to(torch.int32)) & 1, 0)
    wid = torch.cumsum(starts.reshape(-1), dim=0, dtype=torch.int64).reshape(B, W) - 1
    return torch.where(valid, wid, -1).to(torch.int32)


def phase_compact_plain(bytes_bw, start_bits, row_len, n1: int, *, tables):
    """Plain PyTorch version of K20, on any device: block-flat word ids,
    K1's seed, ``n1`` steps of the JAX fixpoint step and the half-row
    compaction (``ops/merge.py:compact_half_rows_plain``).  Returns
    (tokens [B/2, W] int32, wid2 [B/2, W] int32, kept [B] int32)."""
    wid = block_word_ids_plain(start_bits, row_len)
    tokens = seed_tokens_plain(bytes_bw, row_len, tables.byte_token_table)
    t = segmented_fixpoint_bounded_plain(tokens, wid, tables.pair_lookup, n1)
    return compact_half_rows_plain(t, wid)


def phase_compact(bytes_bw, start_bits, row_len, n1: int, *, tables):
    """K20 on CUDA tensors (one launch), :func:`phase_compact_plain` on CPU
    tensors, on the table ``merge_fixpoint`` picks.

    Args:
      bytes_bw: [B, W] uint8 packed words; B even, W % 32 == 0, W <= 1024.
      start_bits: [B, W/8] uint8 word-start bitmap, little endian.
      row_len: [B] int32 content length of each row.
      n1: the steps of the first phase (``CTOK_PHASE_N1``).
      tables: ``TorchTables`` on the same device.
    Returns:
      (tokens [B/2, W] int32, wid2 [B/2, W] int32: half-rows 2k and 2k + 1
      of the compacted rows make row k; kept [B] int32: each row's kept
      lanes, over W/2 when the row spills).
    """
    if n1 < 0:
        raise ValueError(f"phase_compact: n1={n1} is negative")
    B, W = bytes_bw.shape
    if B % 2:
        raise ValueError(f"phase_compact: B={B} is odd (half-rows are fused in pairs)")
    if bytes_bw.device.type == "cpu":
        return phase_compact_plain(bytes_bw, start_bits, row_len, n1, tables=tables)
    if bytes_bw.device.type != "cuda":
        raise ValueError(f"phase_compact: unsupported device {bytes_bw.device}")
    if W % 32 or W > 1024:
        raise ValueError(f"phase_compact: W={W} must be a multiple of 32 and at most 1024")
    bt = tables.byte_token_table
    _check_args("phase_compact", bytes_bw, (
        ("bytes_bw", bytes_bw, torch.uint8, (B, W)),
        ("start_bits", start_bits, torch.uint8, (B, W // 8)),
        ("row_len", row_len, torch.int32, (B,)),
        ("byte_table", bt, torch.int32, (256,)),
    ))
    if start_bits.data_ptr() % 4:
        raise ValueError("phase_compact: start_bits must be 4-byte aligned (a word a load)")
    out_t = torch.empty((B // 2, W), dtype=torch.int32, device=bytes_bw.device)
    out_w = torch.empty_like(out_t)
    kept = torch.empty(B, dtype=torch.int32, device=bytes_bw.device)
    if B == 0:
        return out_t, out_w, kept
    lib = kernel_library().lib
    head = (bytes_bw.data_ptr(), start_bits.data_ptr(), row_len.data_ptr(), bt.data_ptr())
    tail = (n1, out_t.data_ptr(), out_w.data_ptr(), kept.data_ptr(), B, W,
            torch.cuda.current_stream(bytes_bw.device).cuda_stream)
    if tables.qc_t1 is not None:
        code = lib.ctok_phase_compact_qc(*head, tables.qc_t1.data_ptr(), tables.qc_t2.data_ptr(),
                                         tables.qc_size - 1, *tail)
    else:
        if tables.chd_rows.data_ptr() % 16:
            raise ValueError("phase_compact: rows must be 16-byte aligned (one int4 load a probe)")
        code = lib.ctok_phase_compact_chd(*head, tables.chd_disp.data_ptr(),
                                          tables.chd_rows.data_ptr(), tables.chd_size - 1,
                                          tables.chd_n_buckets - 1, *tail)
    check(code, "phase_compact")
    phase_compact.launches += 1
    return out_t, out_w, kept


phase_compact.launches = 0  # launches of K20 (not of the plain version)


def fill_layout_phased(B: int, W: int, cap: int, itemsize: int) -> tuple[int, int, int, int]:
    """Byte offsets of the phased fused buffer of a pack of B rows: (alive
    bits, start bits, total, size)."""
    alive = cap * itemsize
    starts = alive + B * W // 16
    total = starts + B * W // 16
    return alive, starts, total, total + 4


def fill_compact_phased_plain(merged, count, wid2, kept, cap: int, itemsize: int):
    """Plain PyTorch version of K4's phased mode, on any device (see
    :func:`fill_compact_phased`)."""
    B2, W = merged.shape
    alive = merged >= 0
    live = merged.reshape(-1)[alive.reshape(-1)]
    total = count.sum(dtype=torch.int64)
    shown = torch.where((kept > W // 2).any(), 2 * B2 * W + 1, total)
    ids = torch.full((cap,), -1, dtype=torch.int64, device=merged.device)
    n = min(live.numel(), cap)
    ids[:n] = live[:n]
    left = torch.full_like(wid2, -2)
    left[:, 1:] = wid2[:, :-1]
    wstart = (wid2 >= 0) & (wid2 != left)
    return torch.cat([
        _le_bytes(ids, itemsize), _pack_bits(alive), _pack_bits(wstart),
        _le_bytes(shown.reshape(1), 4),
    ])


def fill_compact_phased(merged, count, wid2, kept, cap: int, itemsize: int):
    """K4's phased mode on a CUDA tensor, the plain version on a CPU tensor.

    Args:
      merged: [B/2, W] int32, the fixpoint finished on K20's rows.
      count: [B/2] int32 live ids of each row.
      wid2: [B/2, W] int32, K20's word ids.
      kept: [B] int32, K20's kept lanes of each row of the pack.
      cap: id slots of the buffer (3/8 of the pack's B*W lanes).
      itemsize: 2 (uint16 ids) or 4 (int32 ids).
    Returns:
      [cap*itemsize + B*W/16 + B*W/16 + 4] uint8: the first ``cap`` live
      ids in flat order, then -1; the alive bitmap and the word-start
      bitmap (``wid2 >= 0`` where it differs from its left neighbour) of
      the [B/2, W] rows; the int32 total of live ids, or ``B*W + 1`` when a
      row of the pack kept more than W/2 lanes.
    """
    if itemsize not in (2, 4):
        raise ValueError(f"fill_compact_phased: itemsize must be 2 or 4, got {itemsize}")
    B2, W = merged.shape
    if W % 8:
        raise ValueError(f"fill_compact_phased: W={W} is not a multiple of 8")
    if cap < 0 or cap > B2 * W:
        raise ValueError(f"fill_compact_phased: cap={cap} outside [0, {B2 * W}]")
    if merged.device.type == "cpu":
        return fill_compact_phased_plain(merged, count, wid2, kept, cap, itemsize)
    if merged.device.type != "cuda":
        raise ValueError(f"fill_compact_phased: unsupported device {merged.device}")
    _check_args("fill_compact_phased", merged, (
        ("merged", merged, torch.int32, (B2, W)),
        ("count", count, torch.int32, (B2,)),
        ("wid2", wid2, torch.int32, (B2, W)),
        ("kept", kept, torch.int32, (2 * B2,)),
    ))
    size = fill_layout_phased(2 * B2, W, cap, itemsize)[3]
    out = torch.empty(size, dtype=torch.uint8, device=merged.device)
    check(
        kernel_library().lib.ctok_fill_compact_phased(
            merged.data_ptr(), count.data_ptr(), wid2.data_ptr(), kept.data_ptr(),
            out.data_ptr(), B2, W, cap, itemsize,
            torch.cuda.current_stream(merged.device).cuda_stream,
        ),
        "fill_compact_phased",
    )
    fill_compact_phased.launches += 1
    return out


fill_compact_phased.launches = 0  # launches of K4's phased mode (not of the plain version)


def word_fill_phased_plain(bytes_bw, start_bits, row_len, cap: int, n1: int, *, tables,
                           itemsize: int):
    """Plain PyTorch version of the phased fill, on any device: K20's, the
    JAX fixpoint's and K4's phased mode's plain versions, one after the
    other."""
    t2, w2, kept = phase_compact_plain(bytes_bw, start_bits, row_len, n1, tables=tables)
    merged, count = _fixpoint_plain_of(tables)(t2, w2)
    return fill_compact_phased_plain(merged, count, w2, kept, cap, itemsize)


def word_fill_phased(bytes_bw, start_bits, row_len, cap: int, n1: int, *, tables,
                     itemsize: int):
    """The phased fill of one pack: K20, then K2 or K5, then K4's phased
    mode on CUDA tensors (three launches), their plain versions on CPU
    tensors.  Arguments as :func:`word_fill` (B even), with ``n1`` the
    steps before the compaction.  Returns the phased fused buffer of
    :func:`fill_compact_phased`."""
    t2, w2, kept = phase_compact(bytes_bw, start_bits, row_len, n1, tables=tables)
    merged, count = tables.merge_fixpoint(t2, w2)
    return fill_compact_phased(merged, count, w2, kept, cap, itemsize)

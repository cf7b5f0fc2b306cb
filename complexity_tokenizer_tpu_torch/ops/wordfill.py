"""The word path's device fill: kernels K3 and K4 and the fill they frame.

``word_fill(bytes_bw, start_bits, row_len, cap, ...)`` is the twin of the
JAX package's unphased fill body (``ops/wordpath.py``,
``DeviceWordEncoder._local_fill_body``): packed word rows ``[B, W]`` ->

- K3 (:func:`word_ids`): start bits -> word ids, -1 at and past
  ``row_len``;
- K1 (``ops/seed.py``): bytes -> token ids, -1 at and past ``row_len``;
- K2 or K5 (``ops/merge.py``, through ``TorchTables.merge_fixpoint``): the
  merge fixpoint, and each row's live count;
- K4 (:func:`fill_compact`): one fused uint8 buffer,
  ``[cap ids (uint16 or int32) | B*W/8 alive bits | int32 total]``, byte
  for byte the JAX body's layout.

K3 counts word starts within each row where the JAX body counts over the
flattened pack: equal for K2 on rows packed by ``ctok_pack_seg`` (the
kernel's note in ``csrc/wordfill.cu`` gives the reason).  Each kernel has a
plain PyTorch version beside it; the wrapper runs it for a CPU tensor and,
for a CUDA tensor, launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ..utils.cuda_build import check, kernel_library
from .seed import seed_tokens

__all__ = [
    "word_ids",
    "word_ids_plain",
    "fill_compact",
    "fill_compact_plain",
    "fill_layout",
    "word_fill",
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


def fill_compact_plain(
    merged: torch.Tensor, count: torch.Tensor, cap: int, itemsize: int
) -> torch.Tensor:
    """Plain PyTorch version of K4, on any device (see :func:`fill_compact`)."""
    B, W = merged.shape
    alive = merged >= 0
    live = merged.reshape(-1)[alive.reshape(-1)]
    total = count.sum(dtype=torch.int64)
    ids = torch.full((cap,), -1, dtype=torch.int64, device=merged.device)
    n = min(live.numel(), cap)
    ids[:n] = live[:n]
    weights = 1 << torch.arange(8, device=merged.device)
    bits = (alive.reshape(B, W // 8, 8).to(torch.int64) * weights).sum(dim=2)
    return torch.cat([
        _le_bytes(ids, itemsize),
        bits.reshape(-1).to(torch.uint8),
        _le_bytes(total.reshape(1), 4),
    ])


def fill_compact(
    merged: torch.Tensor, count: torch.Tensor, cap: int, itemsize: int
) -> torch.Tensor:
    """K4 on a CUDA tensor, the plain version on a CPU tensor.

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


def word_fill(bytes_bw, start_bits, row_len, cap: int, *, tables, itemsize: int):
    """The fill of one pack of word rows: K3 -> K1 -> K2 (or K5) -> K4.

    Args:
      bytes_bw: [B, W] uint8 packed words (``ctok_pack_seg``).
      start_bits: [B, W/8] uint8 word-start bitmap, little endian.
      row_len: [B] int32 content length of each row.
      cap: id slots of the fused buffer (``B*W*3/8``, or ``B*W`` when a
        pack is dispatched again after a spill).
      tables: the pipeline's ``TorchTables`` on the same device.
      itemsize: 2 when every producible id is below 65,535, else 4.
    Returns:
      the fused uint8 buffer of :func:`fill_compact`.
    """
    wid = word_ids(start_bits, row_len)
    tokens = seed_tokens(bytes_bw, row_len, tables.byte_token_table)
    merged, count = tables.merge_fixpoint(tokens, wid)
    return fill_compact(merged, count, cap, itemsize)

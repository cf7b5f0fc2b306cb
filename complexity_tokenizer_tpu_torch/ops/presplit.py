"""GPT-2 pre-split over ``[B, L]`` byte tensors: kernel K21 and its plain version.

The same local boundary rules as the JAX package's ``ops/presplit.py``,
derived from the leftmost-first semantics of the no-lookahead pattern::

    's|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+

- a match starts at byte p iff p is a codepoint lead byte and either
  (a) p is an absorbed single space followed by a letter/number/other run,
  (b) a contraction ended at p-1, or (c) the class changes at p and p-1
  was not an absorbed space; never inside a contraction;
- a single space is absorbed forward iff its left neighbour is not
  whitespace and its right neighbour is a non-whitespace char;
- an apostrophe starts a contraction iff its left char is a letter/number,
  a non-absorbed whitespace, or nothing; contractions then consume 1-2
  ASCII lowercase letters.

UTF-8 is decoded arithmetically at lead bytes, the class gathered from the
``[0x110000]`` table on the device and propagated over continuation bytes.

:func:`presplit` launches kernel K21 (``csrc/presplit.cu``, one launch a
batch: a warp a 128-column step, each step's window of bytes in shared
memory, a row's steps on several warps of a block) on CUDA
tensors and runs :func:`presplit_plain`, the same rules as torch ops, on
CPU tensors.  Both are diff-tested against the host scanner
(``core/pretokenizers.py``) and the JAX pass.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.cuda_build import check, kernel_library
from ..utils.unicode_tables import CL_LETTER, CL_NUMBER, CL_OTHER, CL_WS

__all__ = ["presplit", "presplit_plain", "presplit_launch_shape", "CL_NONE", "N_CODEPOINTS"]

N_CODEPOINTS = 0x110000  # entries of the class table

CL_NONE = 4  # out-of-text sentinel


def _shift_right(x: torch.Tensor, k: int, fill) -> torch.Tensor:
    """out[:, i] = x[:, i-k], ``fill`` in the first k lanes."""
    out = torch.full_like(x, fill)
    out[:, k:] = x[:, :-k]
    return out


def _shift_left(x: torch.Tensor, k: int, fill) -> torch.Tensor:
    """out[:, i] = x[:, i+k], ``fill`` in the last k lanes."""
    out = torch.full_like(x, fill)
    out[:, :-k] = x[:, k:]
    return out


def presplit_plain(byte_arr: torch.Tensor, lengths: torch.Tensor, class_table: torch.Tensor):
    """Plain PyTorch version of K21, on any device: the JAX ``presplit``
    step for step.

    Args:
      byte_arr: [B, L] uint8 (zero-padded past ``lengths``).
      lengths: [B] int32 byte lengths.
      class_table: [0x110000] uint8 GPT-2 classes, on the same device.
    Returns:
      (start, word_id, valid): start [B, L] bool, a match begins here;
      word_id [B, L] int32, 0-based match index per byte (-1 past end);
      valid [B, L] bool.
    """
    b0 = byte_arr.to(torch.int32)
    L = byte_arr.shape[1]
    pos = torch.arange(L, dtype=torch.int32, device=byte_arr.device)[None, :]
    valid = pos < lengths[:, None]

    b1 = _shift_left(b0, 1, 0)
    b2 = _shift_left(b0, 2, 0)
    b3 = _shift_left(b0, 3, 0)

    is_cont = (b0 & 0xC0) == 0x80
    # codepoint at lead bytes (garbage at continuation bytes, masked later)
    cp2 = ((b0 & 0x1F) << 6) | (b1 & 0x3F)
    cp3 = ((b0 & 0x0F) << 12) | ((b1 & 0x3F) << 6) | (b2 & 0x3F)
    cp4 = (
        ((b0 & 0x07) << 18) | ((b1 & 0x3F) << 12) | ((b2 & 0x3F) << 6) | (b3 & 0x3F)
    )
    cp = torch.where(
        b0 < 0x80, b0, torch.where(b0 < 0xE0, cp2, torch.where(b0 < 0xF0, cp3, cp4))
    )
    cp = cp.clamp(0, 0x10FFFF)
    cls = class_table[cp.long()].to(torch.int32)
    # propagate the lead byte's class onto continuation bytes (max 3 steps)
    for _ in range(3):
        cls = torch.where(is_cont, _shift_right(cls, 1, CL_NONE), cls)
    cls = torch.where(valid, cls, CL_NONE)

    cls_prev = _shift_right(cls, 1, CL_NONE)
    cls_next = _shift_left(cls, 1, CL_NONE)

    is_space = valid & (b0 == 0x20)
    run_next = (cls_next == CL_LETTER) | (cls_next == CL_NUMBER) | (cls_next == CL_OTHER)
    absorbed = is_space & (cls_prev != CL_WS) & run_next
    absorbed_prev = _shift_right(absorbed, 1, False)

    is_quote = valid & (b0 == 0x27)
    qsm = is_quote & (
        (cls_prev == CL_LETTER)
        | (cls_prev == CL_NUMBER)
        | ((cls_prev == CL_WS) & ~absorbed_prev)
        | (cls_prev == CL_NONE)
    )

    valid1 = _shift_left(valid, 1, False)
    valid2 = _shift_left(valid, 2, False)
    contr2 = (
        qsm
        & valid1
        & ((b1 == ord("s")) | (b1 == ord("t")) | (b1 == ord("m")) | (b1 == ord("d")))
    )
    contr3 = (
        qsm
        & valid2
        & (
            ((b1 == ord("r")) & (b2 == ord("e")))
            | ((b1 == ord("v")) & (b2 == ord("e")))
            | ((b1 == ord("l")) & (b2 == ord("l")))
        )
    )

    interior = (
        _shift_right(contr2, 1, False)
        | _shift_right(contr3, 1, False)
        | _shift_right(contr3, 2, False)
    )
    cend_prev = _shift_right(contr2, 2, False) | _shift_right(contr3, 3, False)

    class_change = (cls != cls_prev) & ~absorbed_prev
    start = valid & ~is_cont & ~interior & (absorbed | cend_prev | class_change)

    word_id = torch.cumsum(start.to(torch.int32), dim=1, dtype=torch.int32) - 1
    word_id = torch.where(valid, word_id, -1)
    return start, word_id, valid


def presplit(byte_arr: torch.Tensor, lengths: torch.Tensor, class_table: torch.Tensor):
    """K21 on CUDA tensors, the plain version on CPU tensors.

    Same arguments and result as :func:`presplit_plain`; the kernel takes
    ``byte_arr`` [B, L] uint8, ``lengths`` [B] int32 and ``class_table``
    [0x110000] uint8, contiguous, on one card.
    """
    if byte_arr.device.type == "cpu":
        return presplit_plain(byte_arr, lengths, class_table)
    if byte_arr.device.type != "cuda":
        raise ValueError(f"presplit: unsupported device {byte_arr.device}")
    if byte_arr.dim() != 2:
        raise ValueError(f"presplit: byte_arr must be [B, L], got {tuple(byte_arr.shape)}")
    B, L = byte_arr.shape
    for name, t, dtype, shape in (
        ("byte_arr", byte_arr, torch.uint8, (B, L)),
        ("lengths", lengths, torch.int32, (B,)),
        ("class_table", class_table, torch.uint8, (N_CODEPOINTS,)),
    ):
        if t.device != byte_arr.device or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"presplit: {name} must be {dtype} {shape} on {byte_arr.device}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"presplit: {name} must be contiguous")
    start = torch.empty((B, L), dtype=torch.bool, device=byte_arr.device)
    word_id = torch.empty((B, L), dtype=torch.int32, device=byte_arr.device)
    valid = torch.empty((B, L), dtype=torch.bool, device=byte_arr.device)
    if start.numel() == 0:
        return start, word_id, valid
    stream = torch.cuda.current_stream(byte_arr.device).cuda_stream
    check(
        kernel_library().lib.ctok_presplit(
            byte_arr.data_ptr(), lengths.data_ptr(), class_table.data_ptr(), start.data_ptr(),
            word_id.data_ptr(), valid.data_ptr(), B, L, stream,
        ),
        "presplit",
    )
    presplit.launches += 1
    return start, word_id, valid


presplit.launches = 0  # launches of K21 (not of the plain version)


def presplit_launch_shape(L: int) -> dict:
    """How the card launches K21 on rows of ``L`` columns: threads a block,
    registers a thread, static shared bytes a block, local (spill) bytes a
    thread, resident blocks per SM, and the warps that take a row's 128-column
    steps together (``row_warps``).  Needs a card; launches nothing."""
    keys = ("threads", "registers", "static_smem", "local_bytes", "blocks_per_sm", "row_warps")
    info = (ctypes.c_int * len(keys))()
    check(kernel_library().lib.ctok_presplit_info(L, ctypes.addressof(info)),
          "presplit_launch_shape")
    return dict(zip(keys, info))

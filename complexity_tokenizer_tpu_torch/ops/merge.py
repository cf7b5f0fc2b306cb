"""Segmented BPE merge fixpoint: kernels K2, K5, K9 and K22 and their plain versions.

K9 (:func:`merge_word_rows`) is the same fixpoint over ragged words (the
symbols of all words end to end, and their offsets), on the CHD table: the
device tier of CharBPE and the ByteLevel BPE model
(``ops/stringbpe_device.py``).  A block takes a tile of whole words
(:func:`word_tiles`).  K22 (:func:`merge_word_rows_qc`) is K9 on the u16
cuckoo table, the counterpart of the JAX ``merge_word_rows_qc``; as there,
no path calls it.

K2 (:func:`merge_words_qc`) probes the u16 two-choice cuckoo table, K5
(:func:`merge_words`) the CHD table of the vocabularies past u16; both run
the same walk (``csrc/kernels.cu``) and compute the same fixpoint.

Tombstone layout: tokens stay at their byte positions and merged-away
slots become -1.  Each step merges, in every word at once, occurrences of
that word's lowest-rank pair, until no pair is left.  With a well-formed
merge table this equals the reference's one-merge-per-step loop
(``core/bpe.py``).

The plain version repeats the JAX package's ``_segmented_fixpoint``
(``ops/merge.py``) step for step in torch ops: the leading occurrence of
an equal-pair run wins, the carries are ``cummax``/``cummin`` over
position indices, the per-word minimum a ``scatter_reduce(..., "amin")``
and the loop a Python ``while``.  The same step, capped at ``n1`` steps,
is the first phase of the phased fixpoint (:func:`phased_merge_words_plain`,
the JAX ``phased_merge_words``): the rows' kept lanes are then compacted to
the left, half-rows 2k and 2k + 1 fused into one row, and the fixpoint
finished there; kernel K20 (``ops/wordfill.py:phase_compact``) runs that
first phase and the compaction.  The kernel (``csrc/kernels.cu``) runs
each row in one block, probes each pair once and then only the pairs a
merge makes, and applies every non-overlapping occurrence of a word's best
pair per step, greedily from the left: on a well-formed table the same
fixpoint, bit for bit, in far fewer steps.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils.cuda_build import check, kernel_library
from .hashtable import INF_RANK, chd_lookup_rows, qc_lookup

__all__ = [
    "merge_words_qc",
    "merge_fixpoint_qc_plain",
    "merge_words",
    "merge_fixpoint_chd_plain",
    "merge_word_rows",
    "merge_word_rows_plain",
    "merge_word_rows_ragged_plain",
    "merge_word_rows_qc",
    "merge_word_rows_qc_plain",
    "merge_word_rows_qc_ragged_plain",
    "segmented_fixpoint_bounded_plain",
    "compact_half_rows_plain",
    "phased_merge_words_plain",
    "word_tiles",
    "TILE_SYMBOLS",
    "WORD_LANES",
    "launch_shape",
]

# K9: the symbols a word may hold, and the symbols a tile's words start in
# (S; chosen by the sweep of chip_smoke.py, PERF.md section 6)
WORD_LANES = 128
TILE_SYMBOLS = 896


def _shift_left(x: torch.Tensor, fill) -> torch.Tensor:
    out = torch.full_like(x, fill)
    out[:, :-1] = x[:, 1:]
    return out


def _shift_right(x: torch.Tensor, fill) -> torch.Tensor:
    out = torch.full_like(x, fill)
    out[:, 1:] = x[:, :-1]
    return out


def _positions(x: torch.Tensor) -> torch.Tensor:
    return torch.arange(x.shape[1], device=x.device).expand(x.shape)


def _last_index(valid: torch.Tensor) -> torch.Tensor:
    """Index of the last valid position <= i; 0 where there is none (the
    JAX carry then yields the value at position 0)."""
    return torch.where(valid, _positions(valid), 0).cummax(dim=1).values


def _first_index(valid: torch.Tensor) -> torch.Tensor:
    """Index of the first valid position >= i; L-1 where there is none."""
    L = valid.shape[1]
    idx = torch.where(valid, _positions(valid), L - 1)
    return idx.flip(1).cummin(dim=1).values.flip(1)


def _carry_last(v: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Inclusive forward carry: value at the last valid position <= i."""
    return v.gather(1, _last_index(valid))


def _carry_first(v: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Inclusive reverse carry: value at the first valid position >= i."""
    return v.gather(1, _first_index(valid))


def _carry_first2(v1: torch.Tensor, v2: torch.Tensor, valid: torch.Tensor):
    idx = _first_index(valid)
    return v1.gather(1, idx), v2.gather(1, idx)


def _segment_min(r: torch.Tensor, seg_start: torch.Tensor) -> torch.Tensor:
    """Minimum of ``r`` over each segment (a run that starts at a
    ``seg_start`` flag), broadcast back to the segment's positions."""
    B, L = r.shape
    seg = torch.cumsum(seg_start.to(torch.int64), dim=1) - 1
    seg = seg + torch.arange(B, device=r.device)[:, None] * L
    mins = torch.full((B * L,), INF_RANK, dtype=r.dtype, device=r.device)
    mins = mins.scatter_reduce(0, seg.reshape(-1), r.reshape(-1), "amin")
    return mins[seg]


def _fixpoint_plain(tokens, wid, lookup, max_steps: int | None = None):
    """The JAX ``_segmented_fixpoint`` step for step; ``lookup(a, b,
    valid) -> (rank, minted)`` probes the pair table.  With ``max_steps``,
    at most that many steps (``_segmented_fixpoint_bounded``)."""
    seg_start = wid != _shift_right(wid, -2)
    t = tokens
    steps = 0
    while max_steps is None or steps < max_steps:
        steps += 1
        alive = t >= 0
        tn_incl, wn_incl = _carry_first2(t, wid, alive)
        t_next = _shift_left(tn_incl, -1)
        w_next = _shift_left(wn_incl, -3)
        pair_valid = alive & (t_next >= 0) & (w_next == wid) & (wid >= 0)
        r, minted = lookup(t, t_next, pair_valid)
        segmin = _segment_min(r, seg_start)
        is_best = (r == segmin) & (segmin < INF_RANK) & pair_valid
        # equal-pair runs: a match whose previous alive pair also matches
        # is suppressed, so the leading occurrence wins
        prev_best = _shift_right(_carry_last(is_best, alive), False)
        selected = is_best & ~prev_best
        t_new = torch.where(selected, minted, t)
        killed = alive & _shift_right(_carry_last(selected, alive), False)
        t = torch.where(killed, -1, t_new)
        if not bool(selected.any()):
            break
    count = (t >= 0).sum(dim=1, dtype=torch.int32)
    return t, count


def segmented_fixpoint_bounded_plain(tokens, wid, lookup, max_steps: int) -> torch.Tensor:
    """The JAX ``_segmented_fixpoint_bounded``: the first ``max_steps``
    steps of the JAX fixpoint (fewer when a step selects nothing), on any
    device.  Returns the tokens, the words possibly unfinished."""
    return _fixpoint_plain(tokens, wid, lookup, max_steps)[0]


def compact_half_rows_plain(t: torch.Tensor, wid: torch.Tensor):
    """The compaction of ``phased_merge_words`` (JAX ``ops/merge.py``), on
    any device: each row's kept lanes (alive, or a word's first lane, so
    that a word with no live id keeps a slot) move left in order, each row
    is cut to its first W/2 lanes with (-1, -1) after its kept ones, and
    half-rows 2k and 2k + 1 make row k.

    Args:
      t: [B, W] int32 tokens after the first phase; B even, W even.
      wid: [B, W] int32 word ids of the uncompacted rows.
    Returns:
      (tokens [B/2, W], word ids [B/2, W] with -1 on the lanes that keep
      nothing, kept lanes of each input row [B] int32).  A row with more
      than W/2 kept lanes spills: its half keeps only the first W/2.
    """
    B, W = t.shape
    keep = (t >= 0) | ((wid >= 0) & (wid != _shift_right(wid, -2)))
    rowcum = torch.cumsum(keep.to(torch.int32), dim=1)
    # kept lanes first, in order; the rest are (-1, -1), in any order
    order = torch.argsort(torch.where(keep, rowcum - 1, W), dim=1, stable=True)
    ts = torch.where(keep, t, -1).gather(1, order)[:, : W // 2]
    ws = torch.where(keep, wid, -1).gather(1, order)[:, : W // 2]
    return ts.reshape(B // 2, W), ws.reshape(B // 2, W), rowcum[:, -1].to(torch.int32)


def phased_merge_words_plain(tokens, wid, lookup, n1: int):
    """The JAX ``phased_merge_words`` step for step, on any device:
    ``n1`` steps of the JAX fixpoint on [B, W], the half-row compaction
    (:func:`compact_half_rows_plain`), and the JAX fixpoint to its end on
    the [B/2, W] rows.

    Returns (t_final [B/2, W] int32, wid2 [B/2, W] int32, spill bool
    tensor: some row kept more than W/2 lanes)."""
    W = tokens.shape[1]
    t = segmented_fixpoint_bounded_plain(tokens, wid, lookup, n1)
    ts, ws, kept = compact_half_rows_plain(t, wid)
    t_final, _count = _fixpoint_plain(ts, ws, lookup)
    return t_final, ws, (kept > W // 2).any()


def merge_fixpoint_qc_plain(tokens, wid, t1, t2, size: int):
    """Plain PyTorch version of K2, on any device.

    Args:
      tokens: [B, L] int32, -1 = tombstone/pad.
      wid: [B, L] int32 word ids (-1 past the end).
      t1, t2: [m, 2] int32 bit views of the cuckoo tables; ``size`` = m.
    Returns:
      (tokens, count): ids at their original positions with -1
      tombstones, and the per-row count of live ids.
    """
    return _fixpoint_plain(
        tokens, wid, lambda a, b, valid: qc_lookup(t1, t2, size, a, b, valid)
    )


def merge_fixpoint_chd_plain(tokens, wid, disp, rows, size: int, n_buckets: int):
    """Plain PyTorch version of K5, on any device: the JAX ``merge_words``.

    Args as :func:`merge_fixpoint_qc_plain`, with the CHD table:
    ``disp`` [n_buckets] int32, ``rows`` [size, 4] int32.
    """
    return _fixpoint_plain(
        tokens, wid,
        lambda a, b, valid: chd_lookup_rows(disp, rows, size, n_buckets, a, b, valid),
    )


def _word_rows_fixpoint_plain(tokens, lookup):
    """The JAX ``_word_rows_fixpoint`` step for step: one word a row, the
    per-word minimum a row minimum; ``lookup(a, b, valid) -> (rank,
    minted)`` probes the pair table."""
    t = tokens
    while True:
        alive = t >= 0
        t_next = _shift_left(_carry_first(t, alive), -1)
        pair_valid = alive & (t_next >= 0)
        r, minted = lookup(t, t_next, pair_valid)
        rowmin = r.min(dim=1, keepdim=True).values
        is_best = (r == rowmin) & (rowmin < INF_RANK) & pair_valid
        # equal-pair runs: the leading occurrence wins
        prev_best = _shift_right(_carry_last(is_best, alive), False)
        selected = is_best & ~prev_best
        t_new = torch.where(selected, minted, t)
        killed = alive & _shift_right(_carry_last(selected, alive), False)
        t = torch.where(killed, -1, t_new)
        if not bool(selected.any()):
            break
    count = (t >= 0).sum(dim=1, dtype=torch.int32)
    return t, count


def merge_word_rows_plain(tokens, disp, rows, size: int, n_buckets: int):
    """Plain PyTorch version of K9, on any device: the JAX
    ``_word_rows_fixpoint`` under ``merge_word_rows``, step for step.

    Args:
      tokens: [B, W] int32, one word a row, -1 = tombstone/pad.
      disp, rows, size, n_buckets: the CHD table, as for
        :func:`merge_fixpoint_chd_plain`.
    Returns:
      (tokens, count) as :func:`merge_fixpoint_chd_plain`.
    """
    return _word_rows_fixpoint_plain(
        tokens, lambda a, b, valid: chd_lookup_rows(disp, rows, size, n_buckets, a, b, valid)
    )


def merge_word_rows_qc_plain(tokens, t1, t2, size: int):
    """Plain PyTorch version of K22, on any device: the JAX
    ``merge_word_rows_qc`` (``_word_rows_fixpoint`` over ``qc_lookup_jnp``),
    step for step.  Ids past 65,535 alias in the u32 key as they do there.

    Args:
      tokens: [B, W] int32, one word a row, -1 = tombstone/pad.
      t1, t2, size: the cuckoo table, as for :func:`merge_fixpoint_qc_plain`.
    Returns:
      (tokens, count) as :func:`merge_fixpoint_qc_plain`.
    """
    return _word_rows_fixpoint_plain(
        tokens, lambda a, b, valid: qc_lookup(t1, t2, size, a, b, valid)
    )


def _ragged_index(offs: torch.Tensor):
    """(word, column) of each flat position of the ragged words ``offs``."""
    lens = (offs[1:] - offs[:-1]).long()
    word = torch.repeat_interleave(torch.arange(lens.numel(), device=offs.device), lens)
    return word, torch.arange(word.numel(), device=offs.device) - offs.long()[word]


def merge_word_rows_ragged_plain(syms, offs, disp, rows, size: int, n_buckets: int):
    """Plain PyTorch version of K9, on any device: the words scattered into
    rows, :func:`merge_word_rows_plain`, and gathered back.

    Args:
      syms: [N] int32, the symbols of all words end to end (-1 = tombstone).
      offs: [B + 1] int32, word i is ``syms[offs[i]:offs[i + 1]]``.
      disp, rows, size, n_buckets: the CHD table, as for
        :func:`merge_fixpoint_chd_plain`.
    Returns:
      (out [N] int32: the merged ids at their words' first symbol, -1
      elsewhere; count [B] int32: live ids a word).
    """
    return _ragged_plain(syms, offs, lambda dense: merge_word_rows_plain(
        dense, disp, rows, size, n_buckets))


def merge_word_rows_qc_ragged_plain(syms, offs, t1, t2, size: int):
    """Plain PyTorch version of K22, on any device: the words scattered into
    rows, :func:`merge_word_rows_qc_plain`, and gathered back.  Arguments
    and result as :func:`merge_word_rows_ragged_plain`, with the cuckoo
    table."""
    return _ragged_plain(syms, offs, lambda dense: merge_word_rows_qc_plain(dense, t1, t2, size))


def _ragged_plain(syms, offs, dense_fixpoint):
    """The ragged words ``syms``/``offs`` scattered into [B, W] rows (W the
    longest word), ``dense_fixpoint(rows) -> (tokens, count)``, and the
    tokens gathered back to their flat offsets."""
    B = offs.numel() - 1
    word, col = _ragged_index(offs)
    W = max(1, int(col.max()) + 1) if col.numel() else 1
    dense = torch.full((B, W), -1, dtype=torch.int32, device=syms.device)
    dense[word, col] = syms
    t, count = dense_fixpoint(dense)
    return t[word, col], count


def word_tiles(offs, tile: int = TILE_SYMBOLS) -> np.ndarray:
    """K9's tiles of whole words: tile k takes the words whose first symbol
    lies in ``[k * tile, (k + 1) * tile)``, the last tile also the empty
    words at the end.  Returns the first word of each tile, then B: [T + 1]
    int32, with T = ceil(N / tile) (at least 1 when there are words).  A
    tile's symbols then span at most ``tile + WORD_LANES - 1`` lanes;
    raises if a word holds more than ``WORD_LANES`` symbols."""
    offs = np.asarray(offs, dtype=np.int64)
    B = len(offs) - 1
    if B <= 0:
        return np.zeros(1, np.int32)
    if int((offs[1:] - offs[:-1]).max()) > WORD_LANES:
        raise ValueError(f"word_tiles: a word holds more than {WORD_LANES} symbols")
    T = max(1, -(-int(offs[-1]) // tile))
    first = np.searchsorted(offs[:B], np.arange(T, dtype=np.int64) * tile, side="left")
    return np.append(first, B).astype(np.int32)


def _check_rows(fn: str, tokens, wid, tables, max_L: int) -> None:
    """The argument checks K2 and K5 share: int32, contiguous, on the
    tokens' device, of the given shapes; rows that fit shared memory."""
    B, L = tokens.shape
    for name, t, shape in (("tokens", tokens, (B, L)), ("wid", wid, (B, L)), *tables):
        if t.device != tokens.device or t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError(
                f"{fn}: {name} must be int32 {shape} on {tokens.device}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
    if L > max_L:
        raise ValueError(f"{fn}: rows of {L} exceed the kernel's shared memory")


def _launch(fn: str, entry: str, tokens, wid, *table_args):
    """Allocate the outputs and launch the C entry ``entry`` of K2 or K5 on
    the tokens' current stream.  Returns (tokens, count, launched)."""
    B, L = tokens.shape
    out = torch.empty_like(tokens)
    count = torch.empty(B, dtype=torch.int32, device=tokens.device)
    if out.numel() == 0:
        count.zero_()
        return out, count, False
    stream = torch.cuda.current_stream(tokens.device).cuda_stream
    launch = getattr(kernel_library().lib, entry)
    check(
        launch(tokens.data_ptr(), wid.data_ptr(), *table_args, out.data_ptr(),
               count.data_ptr(), B, L, stream),
        fn,
    )
    return out, count, True


def merge_words_qc(tokens, wid, t1, t2, size: int):
    """K2 on CUDA tensors, the plain version on CPU tensors.

    Same arguments and result as :func:`merge_fixpoint_qc_plain` when the
    table is well-formed (``core/bpe.py:merges_well_formed``), which the
    device pipeline requires.  The kernel takes word ids as
    ``ops/presplit.py`` makes them: each word one contiguous run, -1 past
    the end.
    """
    if tokens.device.type == "cpu":
        return merge_fixpoint_qc_plain(tokens, wid, t1, t2, size)
    if tokens.device.type != "cuda":
        raise ValueError(f"merge_words_qc: unsupported device {tokens.device}")
    if size & (size - 1):
        raise ValueError(f"merge_words_qc: table size {size} is not a power of two")
    _check_rows("merge_words_qc", tokens, wid,
                (("t1", t1, (size, 2)), ("t2", t2, (size, 2))), 16384)
    out, count, launched = _launch(
        "merge_words_qc", "ctok_merge_fixpoint_qc", tokens, wid,
        t1.data_ptr(), t2.data_ptr(), size - 1,
    )
    merge_words_qc.launches += launched
    return out, count


merge_words_qc.launches = 0  # launches of K2 (not of the plain version)


def merge_words(tokens, wid, disp, rows, size: int, n_buckets: int):
    """K5 on CUDA tensors, the plain version on CPU tensors.

    Same arguments and result as :func:`merge_fixpoint_chd_plain` when the
    table is well-formed, which the device pipeline requires; word ids as
    for :func:`merge_words_qc`.
    """
    if tokens.device.type == "cpu":
        return merge_fixpoint_chd_plain(tokens, wid, disp, rows, size, n_buckets)
    if tokens.device.type != "cuda":
        raise ValueError(f"merge_words: unsupported device {tokens.device}")
    for name, n in (("table size", size), ("bucket count", n_buckets)):
        if n <= 0 or n & (n - 1):
            raise ValueError(f"merge_words: {name} {n} is not a power of two")
    # 18 B of shared memory a position (the cached probes take 8 B)
    _check_rows("merge_words", tokens, wid,
                (("disp", disp, (n_buckets,)), ("rows", rows, (size, 4))), 12288)
    if rows.data_ptr() % 16:
        raise ValueError("merge_words: rows must be 16-byte aligned (one int4 load a probe)")
    out, count, launched = _launch(
        "merge_words", "ctok_merge_fixpoint_chd", tokens, wid,
        disp.data_ptr(), rows.data_ptr(), size - 1, n_buckets - 1,
    )
    merge_words.launches += launched
    return out, count


merge_words.launches = 0  # launches of K5 (not of the plain version)


def _launch_ragged(fn: str, entry: str, syms, offs, tiles, tables, table_args,
                   tile: int, max_lanes: int):
    """The checks K9 and K22 share (int32, contiguous, on the symbols'
    device, of the given shapes; tiles of whole words whose lanes fit
    ``max_lanes``), then the launch of the C entry ``entry`` on the
    symbols' current stream.  Returns (out, count, launched)."""
    N, B, T = syms.numel(), offs.numel() - 1, tiles.numel() - 1
    for name, t, shape in (("syms", syms, (N,)), ("offs", offs, (B + 1,)),
                           ("tiles", tiles, (T + 1,)), *tables):
        if t.device != syms.device or t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError(
                f"{fn}: {name} must be int32 {shape} on {syms.device}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
    lanes = tile + WORD_LANES - 1
    if tile <= 0 or lanes > max_lanes:
        raise ValueError(f"{fn}: tiles of {tile} symbols exceed the shared memory")
    out = torch.empty_like(syms)
    count = torch.empty(max(B, 0), dtype=torch.int32, device=syms.device)
    if B <= 0:
        return out, count, False
    if T <= 0:
        raise ValueError(f"{fn}: no tiles for the words (word_tiles)")
    stream = torch.cuda.current_stream(syms.device).cuda_stream
    check(
        getattr(kernel_library().lib, entry)(
            syms.data_ptr(), offs.data_ptr(), tiles.data_ptr(), T, lanes, *table_args,
            out.data_ptr(), count.data_ptr(), stream,
        ),
        fn,
    )
    return out, count, True


def merge_word_rows(syms, offs, tiles, disp, rows, size: int, n_buckets: int,
                    tile: int = TILE_SYMBOLS):
    """K9 on CUDA tensors, the plain version on CPU tensors.

    Same arguments and result as :func:`merge_word_rows_ragged_plain` when
    the table is well-formed, which ``ops/stringbpe_device.py`` requires;
    ``tiles`` [T + 1] int32 are ``word_tiles(offs, tile)`` (the plain
    version does not read them).
    """
    if syms.device.type == "cpu":
        return merge_word_rows_ragged_plain(syms, offs, disp, rows, size, n_buckets)
    if syms.device.type != "cuda":
        raise ValueError(f"merge_word_rows: unsupported device {syms.device}")
    for name, n in (("table size", size), ("bucket count", n_buckets)):
        if n <= 0 or n & (n - 1):
            raise ValueError(f"merge_word_rows: {name} {n} is not a power of two")
    if rows.data_ptr() % 16:
        raise ValueError("merge_word_rows: rows must be 16-byte aligned (one int4 load a probe)")
    # 18 B of shared memory a lane
    out, count, launched = _launch_ragged(
        "merge_word_rows", "ctok_merge_word_rows", syms, offs, tiles,
        (("disp", disp, (n_buckets,)), ("rows", rows, (size, 4))),
        (disp.data_ptr(), rows.data_ptr(), size - 1, n_buckets - 1), tile, 12288,
    )
    merge_word_rows.launches += launched
    return out, count


merge_word_rows.launches = 0  # launches of K9 (not of the plain version)


def merge_word_rows_qc(syms, offs, tiles, t1, t2, size: int, tile: int = TILE_SYMBOLS):
    """K22 on CUDA tensors, the plain version on CPU tensors.

    Same arguments and result as :func:`merge_word_rows_qc_ragged_plain`
    when the table is well-formed; ``tiles`` as for
    :func:`merge_word_rows` (the plain version does not read them).  No
    path of the package calls it, as no path of the JAX package calls its
    ``merge_word_rows_qc``.
    """
    if syms.device.type == "cpu":
        return merge_word_rows_qc_ragged_plain(syms, offs, t1, t2, size)
    if syms.device.type != "cuda":
        raise ValueError(f"merge_word_rows_qc: unsupported device {syms.device}")
    if size <= 0 or size & (size - 1):
        raise ValueError(f"merge_word_rows_qc: table size {size} is not a power of two")
    # 14 B of shared memory a lane, as K2
    out, count, launched = _launch_ragged(
        "merge_word_rows_qc", "ctok_merge_word_rows_qc", syms, offs, tiles,
        (("t1", t1, (size, 2)), ("t2", t2, (size, 2))),
        (t1.data_ptr(), t2.data_ptr(), size - 1), tile, 16384,
    )
    merge_word_rows_qc.launches += launched
    return out, count


merge_word_rows_qc.launches = 0  # launches of K22 (not of the plain version)


_SHAPE_KEYS = ("threads", "registers", "static_smem", "dynamic_smem", "local_bytes",
               "blocks_per_sm")


def launch_shape(L: int, chd: bool = True, fill: bool = False, ragged: bool = False) -> dict:
    """How the card launches K5 (``chd``) or K2 on rows of ``L`` or, with
    ``fill``, K6 (the word path's merge from the packed bytes,
    ``ops/wordfill.py``) on the same table, or with ``ragged`` K9 (``chd``)
    or K22 on tiles of ``L`` lanes: threads a block, registers a thread,
    static and dynamic shared bytes a block, local (spill) bytes a thread,
    and resident blocks per SM.  Needs a card; launches nothing."""
    info = (ctypes.c_int * len(_SHAPE_KEYS))()
    policy = 2 if ragged else int(fill)
    check(kernel_library().lib.ctok_merge_fixpoint_info(
        int(chd), policy, L, ctypes.addressof(info)), "launch_shape")
    return dict(zip(_SHAPE_KEYS, info))

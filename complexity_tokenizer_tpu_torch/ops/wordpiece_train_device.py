"""The device WordPiece trainer's kernels K18 and K19
(``csrc/wordpiece_train.cu``) and their plain versions.

The JAX package's ``parallel/wordpiece_trainer.py`` runs one XLA program a
round (``_match_count_program``, none calls ``pl.pallas_call``); here it is
two hand-written CUDA kernels:

- K18 :func:`train_match` (``match_rows``, ``:197-272``): the greedy longest
  match of each word over an open-address table of the trainer's forms (a
  form: an entry's whole spelling, looked up at a word's start, or the body
  of a ``##`` entry, looked up past it, its hashes seeded).  At each start
  every length up to ``lt_cap`` is hashed (the two rolling hashes of
  ``ops/wordpiece_device.py``, seeded past the start) and probed, up to 16
  slots from the mixed hash's base; a hit counts only when the slot's form
  has that length; the longest hit is checked exactly against the word's
  characters, and a failed check poisons the word (it never falls back to
  a shorter hit).  A miss emits the character's fallback symbol (the bare
  character at the start, ``##`` + character past it), whether or not it
  is in the vocabulary; a character with none poisons the word.  Out: the
  emitted symbol at each piece's start, -1 elsewhere, and a poison flag a
  word.  On the card a group of 8, 16 or 32 lanes takes a word (K10's lane
  groups, from the words' order by length), every candidate length of a
  start probed at once, a lane each; the table row's fourth word holds the
  form's length and symbol.
- K19 :func:`pair_count` (the pair count of ``fn``, ``:274-317``): each
  word's symbols in order, every adjacent pair keyed ``(a << 16) | b`` and
  weighted by the word's frequency, 0 when the word is poisoned; summed by
  key.  Out: the keys whose count is above 0, their counts, their number
  (and the poisoned words' number).  On the card an open-address table of
  at least twice the slots (:class:`PairCountScratch`, cleared once when
  made and left cleared by every call) takes the sums by atomics, a warp
  reading 32 slots at a time; the insert lists the rows it claims, and a
  second launch writes out and empties only those.  Its order differs from
  JAX's sorted one; the trainer's selection does not depend on it.

The trainer's tables on the card lie in one int32 buffer
(:func:`match_table_views`): the open-address table ``[T, 4]`` (h1, h2,
slot, ``(length << 16) | symbol`` of the slot's form; an empty slot is (0,
1, 0, 0)), each slot's ``[S, 2]`` (length, symbol) and its characters
``[S, 128]`` (-1 padded); the fallback symbols are ``fb_map [2, 0x110000]``
(bare, continuation).  The plain version reads the lengths and symbols from
``[S, 2]``, K18 from the rows.

All int32: each kernel equals its plain version bit for bit (K19 as a set
of (key, count)).  Each wrapper runs the plain version for a CPU tensor and,
for a CUDA tensor, launches its kernel or raises, and counts its launches
in ``<wrapper>.launches``.
"""

from __future__ import annotations

import torch

from ..utils.cuda_build import check, kernel_library, launch_info
from .hashtable import _mul32, mix_hash
from .merge import _ragged_index
from .wordpiece_device import (
    _M32,
    _SEED_CONT1,
    _SEED_CONT2,
    _W,
    _check_args,
    _dense_words,
    _mul32_t,
    _to_i32,
    rolling_prefix_hashes,
)

__all__ = [
    "MAXP",
    "MAX_CP",
    "match_table_views",
    "train_match",
    "train_match_plain",
    "train_match_launch_shape",
    "pair_table_size",
    "PairCountScratch",
    "pair_count",
    "pair_count_plain",
    "pair_count_launch_shape",
    "split_pairs",
]

MAXP = 16  # open-address probe budget
MAX_CP = 0x110000  # codepoints the fallback maps cover


def match_table_views(buf: torch.Tensor, t_size: int, s_cap: int):
    """(table [T, 4], slot_meta [S, 2], slot_chars [S, 128]) views of the
    trainer's one int32 buffer of ``4 T + 130 S`` entries."""
    t_end = 4 * t_size
    m_end = t_end + 2 * s_cap
    return (buf[:t_end].view(t_size, 4), buf[t_end:m_end].view(s_cap, 2),
            buf[m_end:m_end + _W * s_cap].view(s_cap, _W))


# ---------------------------------------------------------------------------
# K18: the greedy longest match over the open-address table


def train_match_plain(chars, offs, lens, groups, table, slot_meta, slot_chars, fb_map,
                      lt_cap: int):
    """Plain PyTorch version of K18, on any device: JAX's ``match_rows``
    step for step, on the words scattered into -1-padded 128-lane rows.

    Args:
      chars: [N] int32, the codepoints of all words end to end.
      offs: [B + 1] int32, word i is ``chars[offs[i]:offs[i + 1]]`` (at most
        128 slots); lens: [B] int32, each word's length (its slots).
      groups: K18's lane groups ``(n8, n16)``, not read here.
      table: [T, 4] int32 open-address rows (h1, h2, slot, and the slot's
        ``(length << 16) | symbol``, not read here), T a power of two;
        slot_meta: [S, 2] int32 (length, symbol); slot_chars: [S, 128]
        int32; fb_map: [2, 0x110000] int32 fallback symbols (bare,
        continuation; -1: none).
      lt_cap: the longest candidate (1..128).
    Returns:
      (out [N] int32: the symbol at each piece's start, -1 elsewhere;
      poison [B] int32: 1 when a chosen form failed the exact check or a
      character had no fallback symbol).
    """
    B = lens.numel()
    dev = chars.device
    if not 1 <= lt_cap <= _W:
        raise ValueError(f"train_match: lt_cap {lt_cap} outside 1..{_W}")
    dense, word, col = _dense_words(chars, offs, "train_match")
    W = _W
    tmask = table.shape[0] - 1
    P1, P2, pow1, pow2 = rolling_prefix_hashes(dense)
    h1t, h2t, slotv = table[:, 0], table[:, 1], table[:, 2]
    tlens, emit = slot_meta[:, 0], slot_meta[:, 1]
    lens_i = lens.to(torch.int64)
    start = torch.zeros(B, dtype=torch.int64, device=dev)
    out = torch.full((B, W), -1, dtype=torch.int32, device=dev)
    poison = torch.zeros(B, dtype=torch.bool, device=dev)
    while True:
        # the rows still matching (JAX steps every row and leaves the others
        # as they are), and the candidate lengths any of them can take
        rows = torch.nonzero(start < lens_i)[:, 0]
        if rows.numel() == 0:
            break
        st, ln = start[rows], lens_i[rows]
        L = min(lt_cap, int((ln - st).max()))
        ls = torch.arange(1, L + 1, device=dev)
        e = st[:, None] + ls[None, :]
        cand_ok = e <= ln[:, None]
        e_c = e.clamp(0, W)
        s_c = st[:, None]
        p1, p2 = P1[rows], P2[rows]
        h1 = (p1.gather(1, e_c) - _mul32_t(p1.gather(1, s_c), pow1[ls][None, :])) & _M32
        h2 = (p2.gather(1, e_c) - _mul32_t(p2.gather(1, s_c), pow2[ls][None, :])) & _M32
        is_cont = (st > 0)[:, None]
        h1 = _to_i32(torch.where(is_cont, (h1 + _mul32(pow1[ls], _SEED_CONT1)) & _M32, h1))
        h2 = _to_i32(torch.where(is_cont, (h2 + _mul32(pow2[ls], _SEED_CONT2)) & _M32, h2))
        # the first of 16 probes whose key matches (an empty slot is a key
        # no form has: JAX's rule, kept for the (0, 1) hash)
        base = mix_hash(h1, h2, tmask).long()
        slot = torch.full(h1.shape, -1, dtype=torch.int32, device=dev)
        for j in range(MAXP):
            idx = (base + j) & tmask
            hit_j = (h1t[idx] == h1) & (h2t[idx] == h2)
            slot = torch.where(hit_j & (slot < 0), slotv[idx], slot)
        safe = slot.clamp(min=0).long()
        hit = (slot >= 0) & cand_ok & (tlens[safe] == ls[None, :])  # the length guard
        best_l = torch.where(hit, ls[None, :], 0).max(dim=1).values
        matched = best_l > 0
        cand = torch.where(hit, slot, 0).gather(1, (best_l - 1).clamp(min=0)[:, None])[:, 0]
        cand = cand.clamp(min=0).long()
        # the exact check of the chosen form only
        kk = torch.arange(L, device=dev)[None, :]
        wchars = dense[rows].gather(1, (st[:, None] + kk).clamp(0, W - 1))
        within = kk < best_l[:, None]
        verified = torch.where(within, slot_chars[cand][:, :L] == wchars, True).all(dim=1)
        cp = dense[rows, st].long().clamp(0, MAX_CP - 1)
        fb = torch.where(st > 0, fb_map[1][cp], fb_map[0][cp])
        poison[rows] |= (matched & ~verified) | (~matched & (fb < 0))
        good = matched & verified
        out[rows, st] = torch.where(good, emit[cand], fb)
        start[rows] = st + torch.where(good, best_l, 1)
    return out[word, col], poison.to(torch.int32)


def _check_match(chars, offs, lens, groups, table, slot_meta, slot_chars, fb_map, lt_cap):
    """K18's argument checks; returns the groups (n8, n16)."""
    N, B = chars.numel(), lens.numel()
    T, S = table.shape[0], slot_meta.shape[0]
    n8, n16 = (int(g) for g in groups)
    if not 0 <= n8 <= n16 <= B:
        raise ValueError(f"train_match: groups {tuple(groups)} outside 0 <= n8 <= n16 <= {B}")
    if T < 1 or T & (T - 1):
        raise ValueError(f"train_match: table size {T} is not a power of two")
    if not 1 <= lt_cap <= _W:
        raise ValueError(f"train_match: lt_cap {lt_cap} outside 1..{_W}")
    i32 = torch.int32
    _check_args("train_match", (
        ("chars", chars, i32, (N,)), ("offs", offs, i32, (B + 1,)), ("lens", lens, i32, (B,)),
        ("table", table, i32, (T, 4)), ("slot_meta", slot_meta, i32, (S, 2)),
        ("slot_chars", slot_chars, i32, (S, _W)), ("fb_map", fb_map, i32, (2, MAX_CP)),
    ))
    if table.data_ptr() % 16 or slot_meta.data_ptr() % 8:
        raise ValueError("train_match: table must be 16-byte aligned and slot_meta 8-byte aligned")
    return n8, n16


def train_match(chars, offs, lens, groups, table, slot_meta, slot_chars, fb_map, lt_cap: int):
    """K18 on CUDA tensors, the plain version on CPU tensors; same arguments
    and result as :func:`train_match_plain`.  ``groups`` = (n8, n16): the
    words [0, n8) are matched by groups of 8 lanes, [n8, n16) by groups of
    16, the rest by a warp each (right for any order, fastest when each word
    fits its group, as ``ops/wordpiece_device.py:_pack_words`` orders and
    counts them); the table's rows must hold each slot's ``(length << 16) |
    symbol`` in their fourth word, as the trainer's mirror writes it.  A
    word's length is cut to its slots.  Nothing is read back to check the
    arguments (so a CUDA graph can capture it): a word of more than 128
    slots, which the plain version refuses, is matched whole."""
    if chars.device.type == "cpu":
        return train_match_plain(chars, offs, lens, groups, table, slot_meta, slot_chars, fb_map,
                                 lt_cap)
    if chars.device.type != "cuda":
        raise ValueError(f"train_match: unsupported device {chars.device}")
    n8, n16 = _check_match(chars, offs, lens, groups, table, slot_meta, slot_chars, fb_map,
                           lt_cap)
    N, B = chars.numel(), lens.numel()
    out = torch.empty(N, dtype=torch.int32, device=chars.device)
    poison = torch.empty(B, dtype=torch.int32, device=chars.device)
    if B == 0:
        return out, poison
    check(
        kernel_library().lib.ctok_train_match(
            chars.data_ptr(), offs.data_ptr(), lens.data_ptr(), n8, n16, B, table.data_ptr(),
            table.shape[0] - 1, slot_meta.data_ptr(), slot_chars.data_ptr(), fb_map.data_ptr(),
            int(lt_cap), out.data_ptr(), poison.data_ptr(),
            torch.cuda.current_stream(chars.device).cuda_stream,
        ),
        "train_match",
    )
    train_match.launches += 1
    return out, poison


train_match.launches = 0  # launches of K18 (not of the plain version)


def train_match_launch_shape() -> dict:
    """How the card launches K18: threads a block, registers a thread,
    static shared bytes a block, local (spill) bytes a thread, resident
    blocks per SM.  Needs a card; launches nothing."""
    return launch_info("ctok_train_match_info", "train_match_launch_shape")


# ---------------------------------------------------------------------------
# K19: the pair count


def pair_table_size(n_slots: int) -> int:
    """K19's hash table for words of ``n_slots`` slots in all: a power of two
    at least twice the slots (each holds at most one pair), so it cannot
    fill."""
    t = 64
    while t < 2 * n_slots:
        t <<= 1
    return t


def split_pairs(res):
    """K19's result ``[2 + 2 cap]`` int32 (a tensor or a numpy array) ->
    (keys [n], counts [n], n, poisoned words)."""
    n = int(res[0])
    kv = res[2:2 + 2 * n]
    return kv[0::2], kv[1::2], n, int(res[1])


def pair_count_plain(out, offs, freqs, poison, t_size: int | None = None):
    """Plain PyTorch version of K19, on any device: JAX's pair count, the
    symbols of each word compacted, adjacent pairs keyed ``(a << 16) | b``,
    weighted by the word's frequency (0 when poisoned), summed by key.

    Args:
      out: [N] int32, K18's symbols (-1 between a word's pieces).
      offs: [B + 1] int32; freqs: [B] int32; poison: [B] int32.
      t_size: K19's table size (:func:`pair_table_size` of N when None).
    Returns:
      [2 + t_size] int32: the number n of keys with a count above 0, the
      number of poisoned words, then n (key, count) pairs in key order.
    """
    B = offs.numel() - 1
    T = pair_table_size(out.numel()) if t_size is None else t_size
    res = torch.zeros(2 + T, dtype=torch.int32, device=out.device)
    word, _col = _ragged_index(offs)
    live = torch.nonzero(out >= 0)[:, 0]
    w = word[live]
    same = w[:-1] == w[1:]
    a = out[live[:-1]][same].long()
    b = out[live[1:]][same].long()
    pw = w[:-1][same]
    weight = torch.where(poison[pw] != 0, 0, freqs[pw])
    keys, inv = torch.unique((a << 16) | b, return_inverse=True)
    counts = torch.zeros(keys.numel(), dtype=torch.int32, device=out.device)
    counts.index_add_(0, inv, weight)
    keep = counts > 0
    n = int(keep.sum())
    if 2 * n > T:
        raise ValueError(f"pair_count: {n} keys over the table's {T // 2}")
    res[0] = n
    res[1] = int((poison[:B] != 0).sum())
    res[2:2 + 2 * n] = torch.stack([keys[keep].to(torch.int32), counts[keep]], 1).view(-1)
    return res


class PairCountScratch:
    """K19's state on the card, for every call on its stream over words of at
    most ``n_slots`` slots in all: the open-address table ``table [T, 2]``
    int32 of (key, count) rows (key -1: empty), ``rows [T // 2]`` (the rows
    a call claims), ``head [4]`` (their number, the poisoned words, the
    compaction's blocks done) and the result ``res [2 + T]``.  Cleared once,
    here; each call empties the rows it claimed and zeroes the head as it
    ends, so the next call finds it cleared."""

    def __init__(self, n_slots: int, device):
        self.t_size = T = pair_table_size(n_slots)
        # one buffer: table, head, rows, res (res + 2 stays 8-byte aligned)
        buf = torch.zeros(2 * T + 4 + T // 2 + 2 + T, dtype=torch.int32, device=device)
        self.table = buf[:2 * T].view(T, 2)
        self.table[:, 0] = -1
        self.head = buf[2 * T:2 * T + 4]
        self.rows = buf[2 * T + 4:2 * T + 4 + T // 2]
        self.res = buf[2 * T + 4 + T // 2:]


def pair_count(out, offs, freqs, poison, scratch: PairCountScratch | None = None):
    """K19 on CUDA tensors, the plain version on CPU tensors: same arguments
    and result as :func:`pair_count_plain` (the scratch's ``t_size``), the
    pairs in the order their rows were claimed.  The result is the scratch's
    buffer, which the next call overwrites.  Two launches (the insert, then
    the compaction as its programmatic dependent), nothing read back, so a
    CUDA graph can capture it."""
    if out.device.type == "cpu":
        return pair_count_plain(out, offs, freqs, poison,
                                None if scratch is None else scratch.t_size)
    if out.device.type != "cuda":
        raise ValueError(f"pair_count: unsupported device {out.device}")
    N, B = out.numel(), offs.numel() - 1
    if scratch is None:
        scratch = PairCountScratch(N, out.device)
    T = scratch.t_size
    i32 = torch.int32
    _check_args("pair_count", (
        ("out", out, i32, (N,)), ("offs", offs, i32, (B + 1,)), ("freqs", freqs, i32, (B,)),
        ("poison", poison, i32, (B,)),
        ("scratch.table", scratch.table, i32, (T, 2)), ("scratch.rows", scratch.rows, i32, (T // 2,)),
        ("scratch.head", scratch.head, i32, (4,)), ("scratch.res", scratch.res, i32, (2 + T,)),
    ))
    if 2 * N > T:
        raise ValueError(f"pair_count: {N} slots need a table of {pair_table_size(N)}, not {T}")
    if scratch.table.data_ptr() % 8 or scratch.res.data_ptr() % 8:
        raise ValueError("pair_count: scratch.table and scratch.res must be 8-byte aligned")
    check(
        kernel_library().lib.ctok_pair_count(
            out.data_ptr(), N, offs.data_ptr(), freqs.data_ptr(), poison.data_ptr(), B,
            scratch.table.data_ptr(), T, scratch.rows.data_ptr(), scratch.head.data_ptr(),
            scratch.res.data_ptr(), torch.cuda.current_stream(out.device).cuda_stream,
        ),
        "pair_count",
    )
    pair_count.launches += 1
    return scratch.res


pair_count.launches = 0  # calls of K19 (its insert and compaction; not the plain version)


def pair_count_launch_shape() -> dict:
    """How the card launches K19's insert pass, as
    :func:`train_match_launch_shape`."""
    return launch_info("ctok_pair_count_info", "pair_count_launch_shape")

"""Pair -> (rank, minted id) tables: numpy construction and torch probes.

Two table forms are built on the host with numpy:

- :class:`QcTable`, a two-choice cuckoo table of packed u32 rows
  ``(a << 16 | b, rank << 16 | minted)``.  A probe is two independent row
  reads.  Eligible when every id, rank and minted id fits in 16 bits; the
  device fixpoint (``ops/merge.py``) runs on it.
- :class:`ChdTable`, a compress-hash-displace perfect hash of ``[T, 4]``
  int32 rows ``(key_a, key_b, rank, minted)``.  A probe is two dependent
  reads (the bucket's displacement, then the row).  Built (by
  ``ops/tables.py``) when the cuckoo table is not eligible (vocabularies
  past u16); the device fixpoint then runs on it.

The torch probes (:func:`mix_hash`, :func:`mix_hash2`, :func:`qc_lookup`,
:func:`chd_lookup_rows`) are bit-identical to the numpy hashes and to the
CUDA probes in ``csrc/kernels.cu``.  torch has no ``>>`` on ``uint32`` on the CPU, so they
compute in ``int64`` and keep the low 32 bits with ``& 0xFFFFFFFF``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = [
    "INF_RANK",
    "QcTable",
    "ChdTable",
    "build_qc_table",
    "build_chd_table",
    "mix_hash",
    "mix_hash2",
    "qc_lookup",
    "chd_lookup_rows",
]

INF_RANK = 0x3FFFFFFF

_M32 = 0xFFFFFFFF
_MUL_A = 0x85EBCA6B
_MUL_B = 0xC2B2AE35
_MIX = 0x27D4EB2F
_MUL2_A = 0x9E3779B1
_MUL2_B = 0x7FEB352D
_MIX2 = 0x45D9F3B


def _mix_hash_np(a: np.ndarray, b: np.ndarray, mask: int) -> np.ndarray:
    with np.errstate(over="ignore"):  # uint32 wraparound is the point
        a = np.asarray(a, np.uint64) & np.uint64(_M32)
        b = np.asarray(b, np.uint64) & np.uint64(_M32)
        M = np.uint64(_M32)
        h = ((a * np.uint64(_MUL_A)) & M) ^ ((b * np.uint64(_MUL_B)) & M)
        h = h ^ (h >> np.uint64(15))
        h = (h * np.uint64(_MIX)) & M
        h = h ^ (h >> np.uint64(13))
        return (h & np.uint64(mask)).astype(np.int32)


def _mix_hash2_np(a: np.ndarray, b: np.ndarray, mask: int) -> np.ndarray:
    with np.errstate(over="ignore"):
        M = np.uint64(_M32)
        g = ((a.astype(np.uint64) * np.uint64(_MUL2_A)) & M) ^ (
            (b.astype(np.uint64) * np.uint64(_MUL2_B)) & M
        )
        g = g ^ (g >> np.uint64(16))
        g = (g * np.uint64(_MIX2)) & M
        return (g & np.uint64(mask)).astype(np.int64)


# ---------------------------------------------------------------------------
# host-side construction (numpy)


@dataclass
class ChdTable:
    """Perfect-hash pair table: ``slot = (mix2(a,b) + disp[mix1(a,b) &
    (B-1)]) & (T-1)``; rows pack ``(key_a, key_b, rank, minted)``."""

    disp: np.ndarray  # [B] int32 displacements
    rows: np.ndarray  # [T, 4] int32: key_a, key_b, rank, minted (-1 keys empty)
    size: int  # T (power of two)
    n_buckets: int  # B (power of two)


def build_chd_table(
    merge_ranks: dict[tuple[int, int], int],
    merge_ops: dict | None = None,
    load: float = 0.7,
) -> ChdTable | None:
    """Construct a CHD perfect hash; None if construction fails."""
    n = max(len(merge_ranks), 1)
    size = 1
    while size * load < n:
        size <<= 1
    for _ in range(7):  # grow on failure
        t = _try_build_chd(merge_ranks, merge_ops or {}, size)
        if t is not None:
            return t
        size <<= 1
    return None


def _try_build_chd(merge_ranks, merge_ops, size: int) -> ChdTable | None:
    mask = size - 1
    n_buckets = max(size // 4, 1)
    bmask = n_buckets - 1
    if not merge_ranks:
        rows = np.full((size, 4), -1, dtype=np.int32)
        rows[:, 2] = INF_RANK
        return ChdTable(np.zeros(n_buckets, np.int32), rows, size, n_buckets)

    keys = np.array(list(merge_ranks.keys()), dtype=np.int64)  # [n, 2]
    ranks = np.array(list(merge_ranks.values()), dtype=np.int32)
    new_ids = np.array(
        [merge_ops.get(int(r), ((0, 0), -1))[1] for r in ranks], dtype=np.int32
    )
    a = keys[:, 0].astype(np.uint32)
    b = keys[:, 1].astype(np.uint32)
    h1 = _mix_hash_np(a, b, bmask)  # bucket
    h2 = _mix_hash2_np(a, b, mask)  # base slot

    order = np.argsort(h1, kind="stable")
    h1s = h1[order]
    boundaries = np.flatnonzero(np.diff(h1s)) + 1
    groups = np.split(order, boundaries)
    groups.sort(key=len, reverse=True)

    # largest buckets first, each at the smallest displacement whose slots
    # are all free; the walk is in plain Python (a bucket holds a few keys)
    taken = bytearray(size)
    disp = np.zeros(n_buckets, np.int32)
    slot = np.empty(len(keys), np.int64)
    h2l = h2.tolist()
    for grp in groups:
        idx = grp.tolist()
        base = [h2l[i] for i in idx]
        if len(set(base)) != len(base):
            return None  # no displacement separates equal base slots
        for d in range(size):
            if not any(taken[(h + d) & mask] for h in base):
                break
        else:
            return None
        for i, h in zip(idx, base):
            p = (h + d) & mask
            taken[p] = 1
            slot[i] = p
        disp[h1[idx[0]]] = d
    rows = np.full((size, 4), -1, dtype=np.int32)
    rows[:, 2] = INF_RANK
    rows[slot, 0] = a.astype(np.int32)
    rows[slot, 1] = b.astype(np.int32)
    rows[slot, 2] = ranks
    rows[slot, 3] = new_ids
    return ChdTable(disp, rows, size, n_buckets)


@dataclass
class QcTable:
    """Two-choice cuckoo pair table with packed u32 rows.

    Row = (key ``a << 16 | b``, value ``rank << 16 | minted``); empty
    slots hold ``0xFFFFFFFF`` in both words.  Eligibility: pair ids and
    minted ids < 0xFFFF and ranks < 0x10000.
    """

    t1: np.ndarray  # [m, 2] u32
    t2: np.ndarray  # [m, 2] u32
    size: int  # m (power of two)


def build_qc_table(
    merge_ranks: dict[tuple[int, int], int], merge_ops: dict
) -> QcTable | None:
    """Cuckoo build (random-walk insertion); None if ineligible."""
    n = len(merge_ranks)
    if n == 0:
        return None
    keys = list(merge_ranks.keys())
    a_arr = np.array([k[0] for k in keys], np.int64)
    b_arr = np.array([k[1] for k in keys], np.int64)
    # the MAX rank must fit u16 (kept ranks are sparse), and every id stays
    # below 0xFFFF: the pair (65535, 65535) would pack to 0xFFFFFFFF, the
    # empty-slot sentinel
    max_rank = max(merge_ranks.values())
    minted = [merge_ops[r][1] for r in merge_ranks.values()]
    if (
        a_arr.min() < 0
        or b_arr.min() < 0
        or a_arr.max() >= 0xFFFF
        or b_arr.max() >= 0xFFFF
        or max_rank >= 0x10000
        or max(minted) >= 0xFFFF
        or min(minted) < 0
    ):
        return None
    m = 64
    while m * 2 * 0.45 < n:
        m <<= 1
    k32 = ((a_arr << 16) | b_arr).astype(np.uint32)
    vals = [
        (merge_ranks[k] << 16) | merge_ops[merge_ranks[k]][1] for k in keys
    ]
    for _ in range(4):
        mask = m - 1
        h1 = _mix_hash_np(
            a_arr.astype(np.uint32), b_arr.astype(np.uint32), mask
        ).tolist()
        h2 = _mix_hash2_np(a_arr, b_arr, mask).tolist()
        slots_of = {int(k32[i]): (h1[i], h2[i]) for i in range(n)}
        val_of = {int(k32[i]): vals[i] for i in range(n)}
        occ0: list = [None] * m
        occ1: list = [None] * m
        ok = True
        for k in slots_of:
            cur, side = k, 0
            for _ in range(500):
                p1, p2 = slots_of[cur]
                pos = p1 if side == 0 else p2
                occ = occ0 if side == 0 else occ1
                cur, occ[pos] = occ[pos], cur
                if cur is None:
                    break
                side = 1 - side
            if cur is not None:
                ok = False
                break
        if ok:
            t = np.full((2, m, 2), _M32, dtype=np.uint32)
            for side, occ in ((0, occ0), (1, occ1)):
                for pos, k in enumerate(occ):
                    if k is not None:
                        t[side, pos, 0] = k
                        t[side, pos, 1] = val_of[k]
            return QcTable(t[0], t[1], m)
        m <<= 1
    return None  # walk failed repeatedly (vanishingly rare)


# ---------------------------------------------------------------------------
# torch probes (int64 lanes holding u32 values)


def _u32(x: torch.Tensor) -> torch.Tensor:
    """Any integer tensor -> int64 holding its u32 bit pattern."""
    return x.to(torch.int64) & _M32


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2**32`` for u32 values in int64, with no int64
    overflow: split x into 16-bit halves."""
    lo = (x & 0xFFFF) * c
    hi = (((x >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & _M32


def mix_hash(a: torch.Tensor, b: torch.Tensor, mask: int) -> torch.Tensor:
    """Cuckoo slot 1 / CHD bucket hash; bit-identical to ``_mix_hash_np``."""
    h = _mul32(_u32(a), _MUL_A) ^ _mul32(_u32(b), _MUL_B)
    h = h ^ (h >> 15)
    h = _mul32(h, _MIX)
    h = h ^ (h >> 13)
    return (h & mask).to(torch.int32)


def mix_hash2(a: torch.Tensor, b: torch.Tensor, mask: int) -> torch.Tensor:
    """Cuckoo slot 2 / CHD base-slot hash; bit-identical to ``_mix_hash2_np``."""
    g = _mul32(_u32(a), _MUL2_A) ^ _mul32(_u32(b), _MUL2_B)
    g = g ^ (g >> 16)
    g = _mul32(g, _MIX2)
    return (g & mask).to(torch.int32)


def qc_lookup(t1, t2, size: int, a, b, valid):
    """(rank, minted) int32 for each pair ``(a, b)`` via the cuckoo table.

    ``t1``/``t2`` are the ``[m, 2]`` u32 tables held as int32 bit views.
    A miss, or ``~valid``, gives ``INF_RANK``; ``minted`` is meaningful
    only on a hit.
    """
    ua, ub = _u32(a), _u32(b)
    k = ((ua << 16) | ub) & _M32
    # the pair (65535, 65535) packs to the empty-slot sentinel: never a hit
    valid = valid & (k != _M32)
    p1 = mix_hash(a, b, size - 1).long()
    p2 = mix_hash2(a, b, size - 1).long()
    r1 = _u32(t1[p1])  # [..., 2]; independent of r2
    r2 = _u32(t2[p2])
    hit1 = (r1[..., 0] == k) & valid
    hit2 = (r2[..., 0] == k) & valid
    rm = torch.where(hit1, r1[..., 1], r2[..., 1])
    rank = torch.where(hit1 | hit2, rm >> 16, INF_RANK).to(torch.int32)
    minted = (rm & 0xFFFF).to(torch.int32)
    return rank, minted


def chd_lookup_rows(disp, rows, size: int, n_buckets: int, a, b, valid):
    """(rank, minted) int32 for each pair ``(a, b)`` via the CHD table.

    ``disp`` is the ``[n_buckets]`` int32 displacement array, ``rows`` the
    ``[size, 4]`` int32 rows.  A pair hits only when both keys of its row
    match; a miss, or ``~valid``, gives ``INF_RANK``.  ``minted`` is the
    row's fourth word whatever the outcome, as in the JAX package's
    ``chd_lookup_rows_jnp``; it is meaningful only on a hit.
    """
    bucket = mix_hash(a, b, n_buckets - 1).long()
    d = disp[bucket].long()
    pos = (mix_hash2(a, b, size - 1).long() + d) & (size - 1)
    row = rows[pos]  # [..., 4]; depends on d
    hit = (row[..., 0] == a) & (row[..., 1] == b) & valid
    rank = torch.where(hit, row[..., 2], INF_RANK).to(torch.int32)
    return rank, row[..., 3].to(torch.int32)

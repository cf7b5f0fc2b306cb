"""Device Unigram: the Viterbi segmentation, kernel K12 (``csrc/unigram.cu``),
and its plain versions.

The reference's Viterbi is a per-text scalar DP over every substring split
with a single-character UNK fallback scored ``min_score - 10``
(``models/unigram.py``).  The device form, as in the JAX package
(``ops/unigram_device.py``):

- texts are codepoint rows ``[B, W]`` (W = 128), -1 padded, in the plain
  version (:func:`viterbi_plain`); K12 takes them ragged and ordered by
  length with K10's lane groups, as K10 takes its words (:func:`viterbi`,
  :meth:`UnigramDevice.pack`);
- a substring's pieces come from the prefix polynomial hashes and the CHD
  table of ``ops/wordpiece_device.py``, keyed on the two hashes, whose rank
  column holds the piece's id; its score from a dense ``[V]`` float32 table;
  candidate lengths are bounded by the longest piece (``maxcand``);
- the forward DP runs over end positions in float32: each end takes the best
  ``prev + score`` over its candidates (ties to the smallest start, as the
  reference's strict-improvement loop), and records the runner-up;
- every end's chosen piece is checked exactly against the text's characters
  (a hash collision poisons the text), and every decision whose margin over
  the runner-up is inside ``1e-4 * (1 + |total|)`` poisons it too: the
  reference accumulates in float64, so the caller re-segments poisoned texts
  on the host and the result is bit-exact;
- the backtrack writes ids at their start positions, -1 elsewhere (the
  tombstone layout); single-character fallbacks carry ``fallback_id`` (-2,
  :data:`FALLBACK_ID`), which the model maps to its UNK id.

The Unigram trainer's E-step (``parallel/unigram_trainer.py``) runs K12 over
the distinct sentences, then K17 (:func:`piece_hist`, ``csrc/unigram_train.cu``):
the expected count of each piece, the frequency of every text that chose it
summed into a ``[V]`` histogram, the histogram inside the JAX package's
``_counts_program`` (``parallel/unigram_trainer.py:64-76``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils.cuda_build import check, kernel_library, launch_info
from ..utils.device import resolve_device
from .hashtable import INF_RANK, build_chd_table, chd_lookup
from .merge import _ragged_index
from .wordpiece_device import (
    _B1,
    _B2,
    _M32,
    _W,
    _check_args,
    _dense_words,
    _mul32_t,
    _pack_words,
    _poly_hash_np,
    _to_i32,
    hash_powers,
    rolling_prefix_hashes,
)

__all__ = [
    "FALLBACK_ID",
    "build_piece_tables",
    "build_unigram_tables",
    "viterbi_plain",
    "viterbi_ragged_plain",
    "viterbi",
    "split_viterbi",
    "viterbi_launch_shape",
    "piece_hist",
    "piece_hist_plain",
    "piece_hist_launch_shape",
    "UnigramDevice",
]

_NEG = float(np.float32(-1e30))
_EPS = 1e-4  # the decision margin's relative bound (float32)
FALLBACK_ID = -2  # the single-character fallback's marker in the output


def build_piece_tables(pieces: dict[str, tuple[int, float]]):
    """(chd, piece_chars, piece_lens, piece_scores, Lt) for a piece -> (id,
    score) map, as the JAX package's: the CHD table keyed on each piece's two
    unseeded hashes (int32 bit patterns) with its id in the rank column,
    ``piece_chars [V, Lt]`` int32 (-1 padded), ``piece_lens [V]`` int32,
    ``piece_scores [V]`` float32 (-1e30 for ids of no piece) and ``Lt`` the
    longest piece; None when ineligible (an empty map, an id over 2,000,000,
    a piece over 128 characters, a hash collision, a failed CHD build)."""
    if not pieces:
        return None
    max_id = max(i for i, _ in pieces.values())
    if max_id > 2_000_000:
        return None
    keys: dict[tuple[int, int], int] = {}
    Lt = 1
    rows_by_id: dict[int, tuple[list[int], float]] = {}
    for tok, (tid, score) in pieces.items():
        chars = [ord(c) for c in tok]
        if not chars:
            continue
        if len(chars) > _W:
            return None
        Lt = max(Lt, len(chars))
        h1 = _poly_hash_np(chars, _B1, 0)
        h2 = _poly_hash_np(chars, _B2, 0)
        key = (h1 if h1 < 1 << 31 else h1 - (1 << 32), h2 if h2 < 1 << 31 else h2 - (1 << 32))
        if key in keys:
            return None
        keys[key] = tid
        rows_by_id[tid] = (chars, float(score))
    chd = build_chd_table(keys)
    if chd is None:
        return None
    piece_chars = np.full((max_id + 1, Lt), -1, np.int32)
    piece_lens = np.zeros(max_id + 1, np.int32)
    piece_scores = np.full(max_id + 1, _NEG, np.float32)
    for tid, (chars, score) in rows_by_id.items():
        piece_chars[tid, : len(chars)] = chars
        piece_lens[tid] = len(chars)
        piece_scores[tid] = score
    return chd, piece_chars, piece_lens, piece_scores, Lt


def build_unigram_tables(model):
    """(chd, piece_chars, piece_lens, piece_scores, Lt, unk_id, min_score)
    of a ``models.unigram.UnigramModel``; None when ineligible."""
    built = build_piece_tables(model.vocab)
    if built is None:
        return None
    chd, piece_chars, piece_lens, piece_scores, Lt = built
    return (chd, piece_chars, piece_lens, piece_scores, Lt, int(model.unk_id),
            float(model.min_score))


# ---------------------------------------------------------------------------
# K12's plain versions


def viterbi_plain(chars, lens, disp, rows, size: int, n_buckets: int, piece_chars, piece_lens,
                  piece_scores, fallback_score: float, maxcand: int,
                  fallback_id: int = FALLBACK_ID):
    """Plain PyTorch version of K12, on any device: the JAX package's
    ``make_viterbi_fn(size, n_buckets, Lt, maxcand)`` step for step.

    Args:
      chars: [B, W] int32 codepoints, -1 padded; lens: [B] int32.
      disp, rows, size, n_buckets: the CHD table keyed on the pieces' hashes.
      piece_chars [V, Lt] int32, piece_lens [V] int32, piece_scores [V]
        float32: the pieces by id.
      fallback_score: the single-character fallback's score (float32).
      maxcand: the longest candidate (at least 1; the model uses ``Lt``).
      fallback_id: the fallback's marker in ``out``.
    Returns:
      (out [B, W] int32: piece ids at their start positions, ``fallback_id``
      for a fallback, -1 elsewhere; count [B] int32: the entries of ``out``
      that are not -1; poison [B] bool: a chosen piece failed the exact check
      or a decision fell inside the float32 margin).
    """
    B, W = chars.shape
    dev = chars.device
    maxlen = min(maxcand, W)
    if maxlen < 1:
        raise ValueError(f"viterbi: maxcand {maxcand} < 1")
    P1, P2, pow1, pow2 = rolling_prefix_hashes(chars)
    lens_i = lens.to(torch.int64)
    ls = torch.arange(1, maxlen + 1, device=dev)
    p1l, p2l = pow1[ls][None, :], pow2[ls][None, :]
    f32 = torch.float32
    neg = torch.tensor(_NEG, dtype=f32, device=dev)
    fb = torch.tensor(fallback_score, dtype=f32, device=dev)
    eps = torch.tensor(_EPS, dtype=f32, device=dev)
    best = torch.full((B, W + 1), _NEG, dtype=f32, device=dev)
    best[:, 0] = 0.0
    tids = torch.full((B, W), -1, dtype=torch.int32, device=dev)
    lsel = torch.zeros((B, W), dtype=torch.int32, device=dev)
    amb = torch.zeros(B, dtype=torch.bool, device=dev)
    lane = (ls - 1)[None, :]
    # ends past every text's length choose nothing: their columns stay (-1, 0)
    last = min(W, int(lens_i.max())) if B else 0
    for end in range(1, last + 1):
        starts = end - ls  # ascending length = descending start
        ok = (starts >= 0)[None, :] & (end <= lens_i)[:, None]
        s_c = starts.clamp(0, W)
        h1 = (P1[:, end:end + 1] - _mul32_t(P1[:, s_c], p1l)) & _M32
        h2 = (P2[:, end:end + 1] - _mul32_t(P2[:, s_c], p2l)) & _M32
        tid = chd_lookup(disp, rows, size, n_buckets, _to_i32(h1), _to_i32(h2), ok)
        hit = tid != INF_RANK
        safe = torch.where(hit, tid, 0).long()
        # a hash hit of another length scores nothing and is no fallback
        sc = torch.where(hit & (piece_lens[safe] == ls[None, :]), piece_scores[safe], neg)
        is_fb = (ls == 1)[None, :] & ~hit & ok
        sc = torch.where(is_fb, fb, sc)
        tid = torch.where(is_fb, fallback_id, tid)
        total = torch.where(ok & (sc > _NEG / 2), best[:, s_c] + sc, neg)
        # the last maximum in lane order: ties go to the smallest start
        mx = total.max(dim=1).values
        k = torch.where(total == mx[:, None], lane, -1).max(dim=1).values
        valid = mx > _NEG / 2
        best[:, end] = torch.where(valid, mx, neg)
        kc = k[:, None]
        tids[:, end - 1] = torch.where(valid, tid.gather(1, kc)[:, 0], -1)
        chosen_len = torch.where(is_fb.gather(1, kc)[:, 0], -1, (k + 1).to(torch.int32))
        lsel[:, end - 1] = torch.where(valid, chosen_len, 0)
        runner = torch.where(lane == kc, neg, total).max(dim=1).values
        margin = mx - runner
        amb |= valid & (runner > _NEG / 2) & (margin < (1.0 + mx.abs()) * eps)

    # the exact check of every end's chosen piece (hash collisions)
    Lt = piece_chars.shape[1]
    ends_b = torch.arange(1, W + 1, device=dev)[None, :]
    starts_b = ends_b - lsel.clamp(min=1)
    safe_t = tids.clamp(min=0).long()
    is_piece = (tids >= 0) & (lsel > 0)
    poison = amb.clone()
    for j in range(Lt):
        cchar = chars.gather(1, (starts_b + j).clamp(0, W - 1))
        need = is_piece & (j < lsel)
        poison |= (need & (piece_chars[safe_t, j] != cchar)).any(dim=1)

    # the backtrack: ids at their start positions
    out = torch.full((B, W), -1, dtype=torch.int32, device=dev)
    pos = lens_i.clamp(max=W)
    rows_b = torch.arange(B, device=dev)
    while True:
        active = pos > 0
        if not bool(active.any()):
            break
        idx = (pos - 1).clamp(0, W - 1)[:, None]
        t_here = tids.gather(1, idx)[:, 0]
        l_here = lsel.gather(1, idx)[:, 0].long()
        start = pos - torch.where(l_here < 0, 1, l_here.clamp(min=1))
        out[rows_b[active], start[active]] = t_here[active]
        pos = torch.where(active, start, pos)
    count = (out != -1).sum(dim=1, dtype=torch.int32)
    return out, count, poison


def split_viterbi(res, B: int):
    """K12's one result buffer ``[N + 2B]`` int32 (a tensor or a numpy array)
    -> views (out [N] int32, count [B] int32) and poison [B] bool."""
    N = len(res) - 2 * B
    return res[:N], res[N:N + B], res[N + B:] != 0


def viterbi_ragged_plain(chars, offs, lens, disp, rows, size: int, n_buckets: int, piece_chars,
                         piece_lens, piece_scores, fallback_score: float, maxcand: int,
                         fallback_id: int = FALLBACK_ID):
    """Plain PyTorch version of K12, on any device: the texts scattered into
    -1-padded 128-lane rows, :func:`viterbi_plain`, and gathered back.

    Args:
      chars: [N] int32, the codepoints of all texts end to end.
      offs: [B + 1] int32, text i is ``chars[offs[i]:offs[i + 1]]`` (at most
        128 slots).
      lens: [B] int32, each text's length, at most its slots.
      The tables, ``fallback_score``, ``maxcand`` and ``fallback_id`` as for
      :func:`viterbi_plain`.
    Returns:
      [N + 2B] int32, one buffer (:func:`split_viterbi`): out [N] (each
      piece's id at its start character, ``fallback_id`` for a fallback, -1
      elsewhere), count [B], poison [B] (0 or 1).
    """
    B = lens.numel()
    slots = offs[1:] - offs[:-1]
    if bool(((lens < 0) | (lens > slots)).any()):
        raise ValueError("viterbi: a text's length is outside 0..its slots")
    dense, word, col = _dense_words(chars, offs, "viterbi")
    if B == 0:
        return torch.full((chars.numel(),), -1, dtype=torch.int32, device=chars.device)
    out, count, poison = viterbi_plain(dense, lens, disp, rows, size, n_buckets, piece_chars,
                                       piece_lens, piece_scores, fallback_score, maxcand,
                                       fallback_id)
    return torch.cat([out[word, col], count, poison.to(torch.int32)])


# ---------------------------------------------------------------------------
# K12


def _check_viterbi(chars, offs, lens, groups, disp, rows, size, n_buckets, piece_chars,
                   piece_lens, piece_scores, maxcand) -> tuple[int, int]:
    N, B = chars.numel(), lens.numel()
    V, Lt = piece_chars.shape
    n8, n16 = (int(g) for g in groups)
    if not 0 <= n8 <= n16 <= B:
        raise ValueError(f"viterbi: groups {groups} outside 0 <= n8 <= n16 <= {B}")
    if Lt > _W:
        raise ValueError(f"viterbi: pieces of {Lt} characters exceed the kernel's {_W}")
    if maxcand < 1:
        raise ValueError(f"viterbi: maxcand {maxcand} < 1")
    for name, n in (("table size", size), ("bucket count", n_buckets)):
        if n <= 0 or n & (n - 1):
            raise ValueError(f"viterbi: {name} {n} is not a power of two")
    i32 = torch.int32
    _check_args("viterbi", (
        ("chars", chars, i32, (N,)), ("offs", offs, i32, (B + 1,)), ("lens", lens, i32, (B,)),
        ("disp", disp, i32, (n_buckets,)), ("rows", rows, i32, (size, 4)),
        ("piece_chars", piece_chars, i32, (V, Lt)), ("piece_lens", piece_lens, i32, (V,)),
        ("piece_scores", piece_scores, torch.float32, (V,)),
    ))
    if rows.data_ptr() % 16:
        raise ValueError("viterbi: rows must be 16-byte aligned (one int4 load a probe)")
    return n8, n16


def viterbi(chars, offs, lens, groups, disp, rows, size: int, n_buckets: int, piece_chars,
            piece_lens, piece_scores, fallback_score: float, maxcand: int,
            fallback_id: int = FALLBACK_ID):
    """K12 on CUDA tensors, the plain version on CPU tensors; same arguments
    and result as :func:`viterbi_ragged_plain` (one ``[N + 2B]`` int32
    buffer, so that one copy brings it back), with ``groups`` = (n8, n16):
    the texts [0, n8) and [n8, n16) (those of at most 8 and of 9 to 16
    characters) are segmented 4 lanes a text, 8 a warp, each class in
    warps of its own, the rest a warp each.  Right for any order and any
    groups (a text over 16 characters in the first two is taken by the
    whole warp afterwards), fastest when they hold the texts of their
    widths, as :meth:`UnigramDevice.pack` orders them; the plain version
    does not read them.  A text's length is cut to its slots and to 128
    (the plain version raises on a length over its slots)."""
    if chars.device.type == "cpu":
        return viterbi_ragged_plain(chars, offs, lens, disp, rows, size, n_buckets, piece_chars,
                                    piece_lens, piece_scores, fallback_score, maxcand, fallback_id)
    if chars.device.type != "cuda":
        raise ValueError(f"viterbi: unsupported device {chars.device}")
    n8, n16 = _check_viterbi(chars, offs, lens, groups, disp, rows, size, n_buckets, piece_chars,
                             piece_lens, piece_scores, maxcand)
    N, B = chars.numel(), lens.numel()
    res = torch.empty(N + 2 * B, dtype=torch.int32, device=chars.device)
    if B == 0:
        return res
    pows = hash_powers(chars.device)
    stream = torch.cuda.current_stream(chars.device).cuda_stream
    check(
        kernel_library().lib.ctok_viterbi(
            chars.data_ptr(), offs.data_ptr(), lens.data_ptr(), n8, n16, B, disp.data_ptr(),
            rows.data_ptr(), size - 1, n_buckets - 1, piece_chars.data_ptr(),
            piece_lens.data_ptr(), piece_scores.data_ptr(), piece_chars.shape[1],
            ctypes.c_float(fallback_score), int(min(maxcand, _W)), int(fallback_id),
            pows.data_ptr(), res.data_ptr(), N, stream,
        ),
        "viterbi",
    )
    viterbi.launches += 1
    return res


viterbi.launches = 0  # launches of K12 (not of the plain version)


def viterbi_launch_shape() -> dict:
    """How the card launches K12: threads a block, registers a thread,
    static shared bytes a block, local (spill) bytes a thread, resident
    blocks per SM.  Needs a card; launches nothing."""
    return launch_info("ctok_viterbi_info", "viterbi_launch_shape")


# ---------------------------------------------------------------------------
# K17: the expected counts of the pieces


def piece_hist_plain(res, offs, freqs, gidx, V: int, n_global: int):
    """Plain PyTorch version of K17, on any device: the histogram of
    ``_counts_program``, ``hist[id] += freqs[text]`` over the ids >= 0 (and
    below V) that K12 wrote for each text that is not poisoned (fallbacks,
    -2, and -1 add nothing), and each text's poison flag at its place in the
    corpus.

    Args:
      res: [N + 2B] int32, K12's result buffer over the texts ``offs``.
      offs: [B + 1] int32, text j's slots are ``offs[j]:offs[j + 1]``.
      freqs: [B] int32, each text's frequency.
      gidx: [B] int32, each text's index in the corpus (below ``n_global``).
      V: the histogram's size; n_global: the corpus's texts.
    Returns:
      [V + n_global] int32: the histogram, then 1 at ``V + gidx[j]`` for a
      poisoned text j and 0 elsewhere (texts of other processes, the host's).
    """
    B = offs.numel() - 1
    N = res.numel() - 2 * B
    out = res[:N]
    poison = res[N + B:] != 0
    word, _col = _ragged_index(offs)
    ok = (out >= 0) & (out < V) & ~poison[word]
    buf = torch.zeros(V + n_global, dtype=torch.int32, device=res.device)
    buf.index_add_(0, out[ok].long(), freqs[word[ok]])
    buf[V + gidx.long()] = poison.to(torch.int32)
    return buf


def piece_hist(res, offs, freqs, gidx, V: int, n_global: int):
    """K17 on CUDA tensors, the plain version on CPU tensors; same arguments
    and result as :func:`piece_hist_plain`.  int32 atomics give the same
    sums in any order, so K17 equals its plain version bit for bit.  One
    call is one launch of K17, after its buffer's clear (``csrc/
    unigram_train.cu``: a thread a text, as the clear's programmatic
    dependent)."""
    if res.device.type == "cpu":
        return piece_hist_plain(res, offs, freqs, gidx, V, n_global)
    if res.device.type != "cuda":
        raise ValueError(f"piece_hist: unsupported device {res.device}")
    B = offs.numel() - 1
    N = res.numel() - 2 * B
    if B < 0 or N < 0 or V < 1 or n_global < 0:
        raise ValueError(f"piece_hist: res [{res.numel()}] for {B} texts, V {V}, {n_global} texts")
    i32 = torch.int32
    _check_args("piece_hist", (
        ("res", res, i32, (N + 2 * B,)), ("offs", offs, i32, (B + 1,)),
        ("freqs", freqs, i32, (B,)), ("gidx", gidx, i32, (B,)),
    ))
    if B == 0:
        return torch.zeros(V + n_global, dtype=i32, device=res.device)
    buf = torch.empty(V + n_global, dtype=i32, device=res.device)  # K17 clears it
    check(
        kernel_library().lib.ctok_piece_hist(
            res.data_ptr(), offs.data_ptr(), freqs.data_ptr(), gidx.data_ptr(), B, N, V,
            n_global, buf.data_ptr(), torch.cuda.current_stream(res.device).cuda_stream,
        ),
        "piece_hist",
    )
    piece_hist.launches += 1
    return buf


piece_hist.launches = 0  # launches of K17 (not of the plain version)


def piece_hist_launch_shape() -> dict:
    """How the card launches K17, as :func:`viterbi_launch_shape`."""
    return launch_info("ctok_piece_hist_info", "piece_hist_launch_shape")


class UnigramDevice:
    """The Viterbi segmentation over ragged texts on one device (``cuda``
    unless the caller passes ``"cpu"``)."""

    last_poisoned: list[int] = []
    last_over_width = 0

    def __init__(self, tables, device=None):
        (chd, piece_chars, piece_lens, piece_scores, Lt, unk_id, min_score) = tables
        self.chd = chd
        self.Lt = Lt
        self.unk_id = unk_id
        self.min_score = min_score
        self.device = resolve_device(device)
        on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(self.device)  # noqa: E731
        self.disp = on(chd.disp)
        self.rows = on(chd.rows)
        self.piece_chars = on(piece_chars)
        self.piece_lens = on(piece_lens)
        self.piece_scores = on(piece_scores)

    def args(self, maxcand: int | None = None) -> tuple:
        """The table arguments of :func:`viterbi`, from ``disp`` to
        ``maxcand`` (the longest piece unless given)."""
        return (self.disp, self.rows, self.chd.size, self.chd.n_buckets, self.piece_chars,
                self.piece_lens, self.piece_scores, self.min_score,
                self.Lt if maxcand is None else maxcand)

    @staticmethod
    def pack(texts: list[str]):
        """K12's input for a batch of texts, ordered by length (stable), as
        K10's words (``ops/wordpiece_device.py:_pack_words``): (chars [N]
        int32, offs [B + 1] int32, lens [B] int32, order [B] (packed text j
        is ``texts[order[j]]``), groups (n8, n16): the texts of at most 8
        and 16 characters, the texts over 128 characters, which hold no slot
        and length 0 and go to the host)."""
        wl = np.fromiter(map(len, texts), np.int64, len(texts))
        slots = np.where(wl > _W, 0, wl)
        chars, offs, order, groups = _pack_words(texts, wl, slots)
        return chars, offs, slots[order].astype(np.int32), order, groups, np.flatnonzero(
            wl > _W).tolist()

    def tokenize_texts(self, texts: list[str]) -> list[list[int]]:
        """The Viterbi segmentation of each text: one copy to the device, one
        launch, one copy back; fallbacks become the UNK id.  ``last_poisoned``
        then lists the texts the caller must re-segment on the host: the
        poisoned ones, then those over 128 characters (``last_over_width``
        of them)."""
        n = len(texts)
        if n == 0:
            self.last_poisoned, self.last_over_width = [], 0
            return []
        chars, offs, lens, order, groups, skipped = self.pack(texts)
        N = len(chars)
        buf = torch.from_numpy(np.concatenate([chars, offs, lens])).to(self.device)
        res = viterbi(buf[:N], buf[N:N + n + 1], buf[N + n + 1:], groups,
                      *self.args()).cpu().numpy()
        out, _count, poison = split_viterbi(res, n)
        out[out == FALLBACK_ID] = self.unk_id
        live = out >= 0
        bounds = np.concatenate([[0], np.cumsum(live)])[offs].tolist()
        ids = out[live].tolist()
        rows: list[list[int]] = [[]] * n
        for j, i in enumerate(order.tolist()):
            rows[i] = ids[bounds[j]:bounds[j + 1]]
        self.last_poisoned = sorted(order[poison].tolist()) + skipped
        self.last_over_width = len(skipped)
        return rows

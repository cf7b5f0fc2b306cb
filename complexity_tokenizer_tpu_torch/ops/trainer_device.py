"""The device trainer's kernels K13-K16 and their plain versions.

The JAX package's ``parallel/trainer.py`` runs four XLA programs (none
calls ``pl.pallas_call``); here each is a hand-written CUDA kernel
(``csrc/train.cu``):

- K13 :func:`pair_hist` (``make_initial_hist``, ``:48``): the dense pair
  histogram of the word rows, ``hist[l * v0 + r] += freq`` over adjacent
  slots that both hold a token; a block's histogram in shared memory, in
  slices on ``blockIdx.y`` past 241 ids, global atomics past 681
  (:func:`pair_hist_plan`).
- K14 :func:`merge_step` (``make_merge_step``, ``:64``): one merge
  ``(a, b) -> new_id`` over every row, along its alive chain (``-1`` slots
  are tombstones): occurrences 1st, 3rd, ... of a run of matches are
  selected, each start becomes ``new_id`` and its partner ``-1``; the net
  pair-count deltas go to four histograms indexed by the other token
  (kind 0: destroyed (x, a); 1: destroyed (b, y); 2: created (x', new);
  3: created (new, y')), and the selected occurrences' frequencies to
  ``minted``.
- K15 :func:`select_pair` (the selection inside ``make_k_merge_steps``,
  ``:179``, and ``make_inl_window_steps``, ``:248``): the next pair on the
  card, the histogram's first maximum (classic), or the first candidate
  past the window's cursor whose count is positive (INL).
- K16 :func:`hist_update` (the histogram update inside both, ``:220-228``
  and ``:298-306``): pop ``hist[a, b]``, subtract and add the four deltas
  along column a, row b, column new and row new, clamp at 0.

On the device-resident routes K15 writes the step's pair to the merge log
(``ma[step]``, ``mb[step]``, -1 when the step does nothing), and K14 and
K16 read it there, so the host enqueues a block's launches and reads the
log once.  K14 adds into ``delta`` and ``minted``, which the caller zeroes
(a block's once; on the per-merge route K14 itself, a merge ahead: see
``zero``).  K16 is launched as the programmatic dependent of K14, so its
launch overlaps K14's run.

All four work on int32: integer atomics give the same sums in any order, so
every kernel equals its plain version bit for bit.  Each wrapper runs the
plain version for a CPU tensor and, for a CUDA tensor, launches its kernel
or raises, and counts its launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.cuda_build import check, kernel_library

__all__ = [
    "pair_hist",
    "pair_hist_plain",
    "pair_hist_plan",
    "pair_hist_launch_shape",
    "merge_step",
    "merge_step_plain",
    "select_pair",
    "select_pair_plain",
    "hist_update",
    "hist_update_plain",
    "SelectScratch",
]


def _check(what: str, dev, **tensors) -> None:
    for name, (t, shape) in tensors.items():
        if t.device != dev or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(
                f"{what}: {name} must be contiguous int32 on {dev}, "
                f"got {t.dtype} on {t.device}"
            )
        if shape is not None and tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what}: {name} must have shape {tuple(shape)}, got {tuple(t.shape)}")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


# ---------------------------------------------------------------------------
# K13: the initial pair histogram


def pair_hist_plain(words: torch.Tensor, freqs: torch.Tensor, v0: int) -> torch.Tensor:
    """Plain version of K13, on any device: ``make_initial_hist``."""
    left = words[:, :-1].long()
    right = words[:, 1:].long()
    key = left * v0 + right
    valid = (left >= 0) & (right >= 0) & (key < v0 * v0)
    f = freqs.int()[:, None].expand_as(left)
    hist = torch.zeros(v0 * v0, dtype=torch.int32, device=words.device)
    hist.index_add_(0, key[valid], f[valid])
    return hist


# csrc/train.cu's constants: threads a block, slots a warp reads a step, a
# block's shared memory on the H100 (int32 bins), the most slices
_HIST_THREADS = 1024
_HIST_STEP = 128
_HIST_SLICE_BINS = 232_448 // 4
_HIST_MAX_SLICES = 8


def pair_hist_plan(N: int, W: int, v0: int, sms: int = 132) -> dict:
    """K13's branch and grid for rows ``[N, W]`` at ``v0`` on a card of
    ``sms`` SMs, as ``csrc/train.cu:pair_hist_plan`` computes them.

    ``branch`` 0: a block's histogram in shared memory (``v0 * v0`` int32
    bins fit its 232,448 bytes: v0 <= 241); 1: the histogram in ``slices``
    of ``slice_bins`` bins, a block a slice on ``blockIdx.y`` (up to 8
    slices: v0 <= 681); 2: global atomics (the first design).  ``groups``:
    the blocks (branch 0) or the blocks along x of each slice (branch 1),
    an SM's worth of the card unless the rows give fewer than a step a
    warp."""
    bins = v0 * v0
    if bins > _HIST_MAX_SLICES * _HIST_SLICE_BINS:
        return dict(branch=2, slices=0, slice_bins=0, groups=0)
    slices = -(-bins // _HIST_SLICE_BINS)
    steps = -(-(N * W) // _HIST_STEP)
    warps = _HIST_THREADS // 32
    groups = max(1, min(-(-steps // (warps * slices)), max(sms // slices, 1)))
    return dict(branch=1 if slices > 1 else 0, slices=slices, slice_bins=-(-bins // slices),
                groups=groups)


def pair_hist(words: torch.Tensor, freqs: torch.Tensor, v0: int) -> torch.Tensor:
    """K13 on CUDA tensors, the plain version on CPU tensors.

    Args:
      words: [N, W] int32 token ids, -1 empty.
      freqs: [N] int32 row frequencies.
      v0: the histogram's side (ids below it).
    Returns:
      [v0 * v0] int32, ``hist[l * v0 + r]`` the summed frequency of the
      adjacent slot pairs ``(l, r)`` (JAX's key: a right id at or past v0
      adds into line l + 1; a key at or past ``v0 * v0`` is dropped).
    """
    if words.device.type == "cpu":
        return pair_hist_plain(words, freqs, v0)
    if words.device.type != "cuda":
        raise ValueError(f"pair_hist: unsupported device {words.device}")
    N, W = words.shape
    _check("pair_hist", words.device, words=(words, None), freqs=(freqs, (N,)))
    if N == 0 or W < 2:
        return torch.zeros(v0 * v0, dtype=torch.int32, device=words.device)
    hist = torch.empty(v0 * v0, dtype=torch.int32, device=words.device)  # K13 clears it
    check(
        kernel_library().lib.ctok_pair_hist(
            words.data_ptr(), freqs.data_ptr(), N, W, v0, hist.data_ptr(), _stream(words.device)
        ),
        "pair_hist",
    )
    pair_hist.launches += 1
    return hist


pair_hist.launches = 0  # launches of K13 (not of the plain version)


def pair_hist_launch_shape(N: int, W: int, v0: int) -> dict:
    """K13's plan and launch shape on the card for rows ``[N, W]`` at
    ``v0``, from ``ctok_pair_hist_info``: the plan's keys (see
    :func:`pair_hist_plan`), ``sms``, and the kernel's threads, registers,
    static and dynamic shared bytes, local (spill) bytes and resident blocks
    per SM.  Needs a card; launches nothing."""
    keys = ("branch", "slices", "slice_bins", "groups", "sms", "threads",
            "registers", "static_smem", "dynamic_smem", "local_bytes", "blocks_per_sm")
    info = (ctypes.c_int * len(keys))()
    check(kernel_library().lib.ctok_pair_hist_info(N, W, v0, ctypes.addressof(info)),
          "pair_hist_launch_shape")
    return dict(zip(keys, info))


# ---------------------------------------------------------------------------
# K14: one merge step


def _step_pair(a, b, log, step):
    """(a, b) of a step, or None when the logged step does nothing."""
    if log is None:
        return int(a), int(b)
    ma, mb = log
    a = int(ma[step])
    return None if a < 0 else (a, int(mb[step]))


def merge_step_plain(words, freqs, new_id: int, delta, minted, a: int = 0, b: int = 0,
                     log=None, step: int = 0, zero=None) -> None:
    """Plain version of K14, on any device, in place: ``make_merge_step``
    over the compacted alive chain of each row (``zero``, when given, is
    zeroed first, as K14 zeroes it).

    Selection is the JAX rule: ``cnt[j]``, the length of the run of matches
    ending at chain position j, odd.  Attribution as JAX's: kinds 1 and 3
    skip a y that starts the next selected match; kind 2 takes ``new_id``
    for x when the previous selected match is chain-adjacent; x and y are
    the neighbours' values before the merge."""
    if zero is not None:
        zero.zero_()
    pair = _step_pair(a, b, log, step)
    if pair is None:
        return
    a, b = pair
    N, W = words.shape
    dev = words.device
    if N == 0:
        return
    alive = words >= 0
    rows, cols = torch.nonzero(alive, as_tuple=True)
    rank = (alive.cumsum(1) - 1)[rows, cols]
    n_alive = alive.sum(1)
    c = torch.full((N, W + 3), -1, dtype=torch.int64, device=dev)
    pos = torch.zeros((N, W + 3), dtype=torch.int64, device=dev)
    c[rows, rank] = words[rows, cols].long()
    pos[rows, rank] = cols
    j = torch.arange(W, device=dev)[None, :]
    na = n_alive[:, None]
    m = (j + 1 < na) & (c[:, :W] == a) & (c[:, 1 : W + 1] == b)
    # run length of matches ending at j: j minus the last non-match at or before it
    last_non = torch.where(m, -1, j.expand(N, W)).cummax(1).values
    sel = m & ((j - last_non) % 2 == 1)
    if not bool(sel.any()):
        return
    sel_prev2 = torch.zeros_like(sel)
    sel_prev2[:, 2:] = sel[:, :-2]
    sel_next2 = torch.zeros_like(sel)
    sel_next2[:, :-2] = sel[:, 2:]
    f = freqs.long()[:, None].expand(N, W)
    left = sel & (j >= 1)
    x = torch.cat([torch.full((N, 1), -1, dtype=torch.int64, device=dev), c[:, : W - 1]], 1)
    right = sel & (j + 2 < na) & ~sel_next2
    y = c[:, 2 : W + 2]
    xp = torch.where(sel_prev2, torch.full_like(x, new_id), x)
    flat = delta.view(-1)
    V = delta.shape[0]
    for kind, mask, idx in ((0, left, x), (1, right, y), (2, left, xp), (3, right, y)):
        mask = mask & (idx < V)  # JAX's scatter drops an index past the histogram
        flat.index_add_(0, idx[mask] * 4 + kind, f[mask].int())
    minted.add_(f[sel].sum().int().view(1))
    r_sel, j_sel = torch.nonzero(sel, as_tuple=True)
    words[r_sel, pos[r_sel, j_sel]] = new_id
    words[r_sel, pos[r_sel, j_sel + 1]] = -1


def _overlap(x, y) -> bool:
    """Whether two tensors' storage ranges share a byte."""
    if x.numel() == 0 or y.numel() == 0:
        return False
    x0, y0 = x.data_ptr(), y.data_ptr()
    return x0 < y0 + y.numel() * y.element_size() and y0 < x0 + x.numel() * x.element_size()


def merge_step(words, freqs, new_id: int, delta, minted, a: int = 0, b: int = 0,
               log=None, step: int = 0, zero=None) -> None:
    """K14 on CUDA tensors, the plain version on CPU tensors, in place.

    Args:
      words: [N, W] int32 rows, -1 tombstones; merged in place.
      freqs: [N] int32.
      new_id: the merged token's id (below ``delta``'s V).
      delta: [V, 4] int32; the step's four histograms are ADDED into it
        (an id at or past V is dropped, as in JAX).
      minted: [1] int32; the selected occurrences' frequencies are added.
      a, b: the pair, when ``log`` is None.
      log: ``(ma, mb)``, [k] int32 each on the words' device: the pair is
        ``(ma[step], mb[step])``, read on the card; ``ma[step] < 0`` leaves
        the rows, ``delta`` and ``minted`` unchanged (``zero`` is zeroed).
      zero: an int32 tensor that K14 zeroes as it runs, overlapping none of
        the others.  The per-merge route keeps two ``[minted | delta]``
        buffers that take turns: each merge adds into the one the merge
        before zeroed and zeroes the other, read back by then, so no
        launch of its own clears one.
    """
    if words.device.type == "cpu":
        return merge_step_plain(words, freqs, new_id, delta, minted, a, b, log, step, zero)
    if words.device.type != "cuda":
        raise ValueError(f"merge_step: unsupported device {words.device}")
    N, W = words.shape
    dev = words.device
    _check("merge_step", dev, words=(words, None), freqs=(freqs, (N,)),
           delta=(delta, None), minted=(minted, (1,)))
    if delta.dim() != 2 or delta.shape[1] != 4 or not 0 <= new_id < delta.shape[0]:
        raise ValueError(f"merge_step: delta must be [V, 4] with new_id < V, got {tuple(delta.shape)}")
    ma_p = mb_p = 0
    if log is not None:
        ma, mb = log
        _check("merge_step", dev, ma=(ma, None), mb=(mb, ma.shape))
        if not 0 <= step < ma.shape[0]:
            raise ValueError(f"merge_step: step {step} outside the log's {ma.shape[0]}")
        ma_p, mb_p = ma.data_ptr(), mb.data_ptr()
    zero_p = zero_n = 0
    if zero is not None:
        _check("merge_step", dev, zero=(zero, None))
        if any(_overlap(zero, t) for t in (words, freqs, delta, minted)):
            raise ValueError("merge_step: zero must overlap none of the other tensors")
        zero_p, zero_n = zero.data_ptr(), zero.numel()
    if (N == 0 or W == 0) and not zero_n:
        return
    check(
        kernel_library().lib.ctok_merge_step(
            words.data_ptr(), freqs.data_ptr(), N, W, ma_p, mb_p, step, int(a), int(b), new_id,
            delta.data_ptr(), delta.shape[0], minted.data_ptr(), zero_p, zero_n, _stream(dev),
        ),
        "merge_step",
    )
    merge_step.launches += 1


merge_step.launches = 0  # launches of K14 (not of the plain version)


# ---------------------------------------------------------------------------
# K15: the next pair, on the card


class SelectScratch:
    """K15's classic-mode scratch on the card (the running maximum and the
    blocks' ticket); the last block returns it to zero, so one serves every
    launch on its stream."""

    def __init__(self, device):
        self.buf = torch.zeros(2, dtype=torch.int64, device=device)


def select_pair_plain(hist, step: int, ma, mb, cand=None) -> None:
    """Plain version of K15, on any device: writes ``ma[step]``,
    ``mb[step]`` (-1 where the step does nothing).

    Classic (``cand`` None): ``hist`` [V, V]'s first maximum in flat order;
    nothing when it is 0.  INL window (``cand = (ca, cb, n_cand, state)``,
    ``state = [last_pos, stopped]``): the first position t past
    ``last_pos``, below ``n_cand``, with ``hist[ca[t], cb[t]] > 0``; nothing
    when ``stopped`` or when there is none, which sets ``stopped``."""
    V = hist.shape[0]
    if cand is None:
        flat = int(torch.argmax(hist.view(-1)))
        do = int(hist.view(-1)[flat]) > 0
        ma[step] = flat // V if do else -1
        mb[step] = flat % V if do else -1
        return
    ca, cb, n_cand, state = cand
    T = ca.shape[0]
    tpos = torch.arange(T, device=hist.device)
    last_pos, stopped = int(state[0]), int(state[1])
    elig = (tpos > last_pos) & (tpos < n_cand) & (hist[ca.long(), cb.long()] > 0)
    has = bool(elig.any())
    if has and not stopped:
        pos = int(torch.argmax(elig.int()))
        ma[step], mb[step] = ca[pos], cb[pos]
        state[0] = pos
    else:
        ma[step] = mb[step] = -1
    if not has:
        state[1] = 1


def select_pair(hist, step: int, ma, mb, cand=None, scratch: SelectScratch | None = None) -> None:
    """K15 on CUDA tensors, the plain version on CPU tensors (see
    :func:`select_pair_plain`).  Classic mode on the card needs the
    ``scratch`` of its stream and V * V < 2**32."""
    if hist.device.type == "cpu":
        return select_pair_plain(hist, step, ma, mb, cand)
    if hist.device.type != "cuda":
        raise ValueError(f"select_pair: unsupported device {hist.device}")
    V = hist.shape[0]
    dev = hist.device
    _check("select_pair", dev, hist=(hist, (V, V)), ma=(ma, None), mb=(mb, ma.shape))
    if not 0 <= step < ma.shape[0]:
        raise ValueError(f"select_pair: step {step} outside the log's {ma.shape[0]}")
    lib = kernel_library().lib
    if cand is None:
        if V * V >= 2**32:
            raise ValueError("select_pair: the classic selection needs V * V < 2**32")
        if scratch is None or scratch.buf.device != dev:
            raise ValueError("select_pair: the classic selection needs a SelectScratch on the card")
        check(lib.ctok_select_argmax(hist.data_ptr(), V, scratch.buf.data_ptr(), step,
                                     ma.data_ptr(), mb.data_ptr(), _stream(dev)), "select_pair")
    else:
        ca, cb, n_cand, state = cand
        _check("select_pair", dev, ca=(ca, None), cb=(cb, ca.shape), state=(state, (2,)))
        T = ca.shape[0]
        if not 0 <= n_cand <= T or T > 4096:
            raise ValueError(f"select_pair: n_cand {n_cand} of T {T} (T <= 4096)")
        check(lib.ctok_select_window(hist.data_ptr(), V, ca.data_ptr(), cb.data_ptr(), T, n_cand,
                                     state.data_ptr(), step, ma.data_ptr(), mb.data_ptr(),
                                     _stream(dev)), "select_pair")
    select_pair.launches += 1


select_pair.launches = 0  # launches of K15 (not of the plain version)


# ---------------------------------------------------------------------------
# K16: the histogram update


def hist_update_plain(hist, step: int, ma, mb, new_id: int, delta) -> None:
    """Plain version of K16, on any device, in place: JAX's update of the
    step's pair ``(ma[step], mb[step])`` (nothing when ``ma[step] < 0``).
    Only the four lines and the popped cell change, so clamping them equals
    JAX's clamp of the whole array."""
    a = int(ma[step])
    if a < 0:
        return
    b = int(mb[step])
    hist[a, b] = 0
    hist[:, a] -= delta[:, 0]
    hist[b, :] -= delta[:, 1]
    hist[:, new_id] += delta[:, 2]
    hist[new_id, :] += delta[:, 3]
    for line in (hist[:, a], hist[b, :], hist[:, new_id], hist[new_id, :]):
        line.clamp_(min=0)


def hist_update(hist, step: int, ma, mb, new_id: int, delta) -> None:
    """K16 on CUDA tensors, the plain version on CPU tensors, in place.

    Args:
      hist: [V, V] int32 pair counts.
      ma, mb: the merge log ([k] int32); the step's pair is read there.
      new_id: the merged token's id.
      delta: [V, 4] int32, K14's histograms of the step (reduced over the
        processes).
    """
    if hist.device.type == "cpu":
        return hist_update_plain(hist, step, ma, mb, new_id, delta)
    if hist.device.type != "cuda":
        raise ValueError(f"hist_update: unsupported device {hist.device}")
    V = hist.shape[0]
    dev = hist.device
    _check("hist_update", dev, hist=(hist, (V, V)), ma=(ma, None), mb=(mb, ma.shape),
           delta=(delta, (V, 4)))
    if not 0 <= step < ma.shape[0] or not 0 <= new_id < V:
        raise ValueError(f"hist_update: step {step} or new_id {new_id} out of range")
    check(kernel_library().lib.ctok_hist_update(hist.data_ptr(), V, step, ma.data_ptr(),
                                                mb.data_ptr(), new_id, delta.data_ptr(),
                                                _stream(dev)), "hist_update")
    hist_update.launches += 1


hist_update.launches = 0  # launches of K16 (not of the plain version)

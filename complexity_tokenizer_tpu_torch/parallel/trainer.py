"""Device INL-BPE trainer: the word rows on the card, pair counts and merge
steps in kernels K13-K16, selection on the host or on the card.

The JAX package's ``parallel/trainer.py`` with ``torch.distributed`` in
place of the mesh:

- the distinct words live as an ``[N, W]`` int32 tensor (``-1`` empty, and
  tombstones once merged) with ``[N]`` frequencies; each process of the
  group holds the rows ``rank::world_size`` on its card;
- the initial pair histogram is K13 (``ops/trainer_device.py:pair_hist``),
  summed over the processes (``parallel/mesh.py:reduce_sum``);
- above ``CTOK_TRAINER_DEVICE_SELECT_MAX_V`` (4,096) ids, or with a
  checkpoint schedule, each merge is one K14 launch (which also zeroes the
  merge before's buffer) whose four delta histograms come back to the
  host, which keeps the pair counts and selects the next pair (the classic
  exact heap, or the INL rebuild walk: ``InlBpeTrainer._selection_loop``);
- up to it, the pair histogram stays on the card as ``[V, V]`` and each
  step is K15 (selection) -> K14 (the merge) -> K16 (the histogram's
  update), 32 steps a block in classic mode and a rebuild window of 100 in
  INL mode, with one read of the merge log a block.

Every process makes the same decisions from the same reduced counts, so
no broadcast is needed; rank 0 writes the checkpoints.  The result equals
the host trainer's: vocab, merges, pair and token counts.
"""

from __future__ import annotations

import os
import sys
import time
from collections import Counter, defaultdict

import numpy as np
import torch

from ..ops.trainer_device import SelectScratch, hist_update, merge_step, pair_hist, select_pair
from ..trainers.inl_trainer import REBUILD_INTERVAL, InlBpeTrainer, TrainerConfig
from ..utils.device import resolve_device
from ..utils.metrics import counters
from .mesh import rank_and_world, reduce_sum

__all__ = ["DistributedInlTrainer", "pack_word_rows", "run_steps"]


def pack_word_rows(words_list, freqs_list) -> tuple[np.ndarray, np.ndarray]:
    """The distinct words' token ids as ``[N, W]`` int32 rows (-1 after a
    word's end, W the longest word and at least 2) and their ``[N]`` int32
    frequencies."""
    W = max(2, max((len(t) for t in words_list), default=1))
    words = np.full((len(words_list), W), -1, dtype=np.int32)
    for i, toks in enumerate(words_list):
        words[i, : len(toks)] = toks
    return words, np.asarray(freqs_list, dtype=np.int32).reshape(-1)


def run_steps(n_do: int, v0b: int, words, freqs, hist, log, deltas, cand=None,
              scratch=None) -> None:
    """Enqueue ``n_do`` device-resident steps K15 -> K14 -> K16 (the step's
    deltas and minted count summed over the processes between K14 and K16;
    K16 is launched as the programmatic dependent of K14):
    ``make_k_merge_steps`` (``cand`` None) or ``make_inl_window_steps``
    (``cand = (ca, cb, n_cand, state)``).  ``log`` is [3, k] int32 (a, b,
    minted of each step; minted zeroed by the caller), ``deltas`` [k, V, 4]
    int32 zeroed by the caller; step i mints id ``v0b + i``."""
    ma, mb, mf = log[0], log[1], log[2]
    for i in range(n_do):
        select_pair(hist, i, ma, mb, cand=cand, scratch=scratch)
        merge_step(words, freqs, v0b + i, deltas[i], mf[i : i + 1], log=(ma, mb), step=i)
        reduce_sum(deltas[i])
        reduce_sum(mf[i : i + 1])
        hist_update(hist, i, ma, mb, v0b + i, deltas[i])


class DistributedInlTrainer(InlBpeTrainer):
    """INL-BPE trainer whose counting and merge application run on the card
    (``cuda`` unless ``device="cpu"``, where the kernels' plain versions
    run).  The API of :class:`InlBpeTrainer` (``train``,
    ``train_from_texts``, ``count_batch``, ``finish_training``,
    checkpoints, ``save``); only the training core differs."""

    # merges a block in the classic device-resident loop
    _SELECT_BLOCK_K = 32
    # candidates shipped to the card a rebuild window; the walk spends one
    # position a merge plus one a dead candidate, and the host continues
    # the window itself when they run out
    _INL_WINDOW_T = 2048

    def __init__(self, config: TrainerConfig | None = None, device=None, **kwargs):
        super().__init__(config, **kwargs)
        self.device = resolve_device(device)

    # the training core; ingestion, scoring and save are inherited
    def _train_from_word_freqs(self, word_freqs: Counter) -> None:
        self._raw_word_freqs = word_freqs
        print("Step 2: Initializing vocabulary (ByteLevel alphabet)...")
        words_list, freqs_list = self._init_vocab(word_freqs)
        print(f"  Initial vocab size: {len(self.vocab)}")
        self._device_merge_loop(words_list, freqs_list, seed_hist=True)

    def _resume_merge_loop(self, words, freqs, pair_words) -> None:
        # pair_freqs comes from the checkpoint (checked by the caller); only
        # the word rows go to the card again
        print("Resuming device merge loop from checkpoint...")
        self._device_merge_loop(words, freqs, seed_hist=False)

    def _is_checkpoint_writer(self) -> bool:
        # every process runs the same selection; rank 0 owns the file
        return rank_and_world()[0] == 0

    def _device_merge_loop(self, words_list, freqs_list, seed_hist: bool) -> None:
        cfg = self.config
        rank, world = rank_and_world()
        dev = self.device
        v0 = len(self.vocab)
        words_np, freqs_np = pack_word_rows(words_list, freqs_list)
        words = torch.from_numpy(np.ascontiguousarray(words_np[rank::world])).to(dev)
        freqs = torch.from_numpy(np.ascontiguousarray(freqs_np[rank::world])).to(dev)

        if seed_hist:
            print("Step 3: Computing initial pair frequencies (on the device)...")
            hist = reduce_sum(pair_hist(words, freqs, v0)).cpu().numpy().reshape(v0, v0)
            ys, xs = np.nonzero(hist)
            for a, b in zip(ys.tolist(), xs.tolist()):
                self.pair_freqs[(a, b)] = int(hist[a, b])
            print(f"  Found {len(self.pair_freqs)} unique pairs")

        V = max(cfg.vocab_size, v0 + 1)
        # the device-resident loops keep a dense [V, V] histogram on the
        # card; a checkpoint schedule needs the host's counts mid-run
        max_v = int(os.environ.get("CTOK_TRAINER_DEVICE_SELECT_MAX_V", "4096"))
        if V <= max_v and not (cfg.checkpoint_interval and cfg.checkpoint_path):
            if cfg.inl_gate == 0.0:
                self._batched_selection_loop(words, freqs, V)
            else:
                self._inl_window_loop(words, freqs, V)
        else:
            print("Step 4: Learning merges with INL dynamics (device steps)...")
            self._selection_loop(self._per_merge_step(words, freqs, V))
        print(f"  Final vocab size: {len(self.vocab)}")
        print(f"  Total merges: {len(self.merges)}")

    def _per_merge_step(self, words, freqs, V: int):
        """``apply_merge(pair, new_id)`` for the host selection: one K14
        launch, its deltas and minted count summed over the processes and
        read back (only the rows up to ``new_id`` can be nonzero), folded
        into the host's counts."""
        dev = self.device
        # two [minted | delta [V, 4]] buffers take turns: K14 adds into the
        # one the merge before zeroed and zeroes the other (read back by
        # then); one copy back a merge
        bufs = torch.zeros((2, 1 + 4 * V), dtype=torch.int32, device=dev)
        host = torch.empty(1 + 4 * V, dtype=torch.int32, pin_memory=dev.type == "cuda")
        turn = [0]

        def apply_merge(pair, new_id):
            a, b = pair
            n = 1 + 4 * (new_id + 1)
            buf, other = bufs[turn[0]], bufs[1 - turn[0]]
            turn[0] = 1 - turn[0]
            live = buf[:n]
            # the rows hold ids below new_id, so the rows up to it are the
            # whole of the merge's delta
            merge_step(words, freqs, new_id, buf[1:n].view(new_id + 1, 4), buf[:1], a=a, b=b,
                       zero=other[:n])
            reduce_sum(live)
            out = host[:n]
            out.copy_(live)
            arr = out.numpy()
            return self._apply_delta_hist(arr[1:].reshape(-1, 4), int(arr[0]), a, b, new_id)

        return apply_merge

    def _hist_on_device(self, V: int) -> torch.Tensor:
        """The host's pair counts as a dense [V, V] int32 histogram on the
        card."""
        hist = np.zeros((V, V), np.int32)
        if self.pair_freqs:
            keys = np.array(list(self.pair_freqs.keys()), dtype=np.int64).reshape(-1, 2)
            vals = np.fromiter(self.pair_freqs.values(), np.int64, len(self.pair_freqs))
            ok = (keys[:, 0] >= 0) & (keys[:, 0] < V) & (keys[:, 1] >= 0) & (keys[:, 1] < V)
            ok &= vals > 0
            hist[keys[ok, 0], keys[ok, 1]] = vals[ok]
        return torch.from_numpy(hist).to(self.device)

    def _mint(self, a: int, b: int) -> int:
        """A new merge into vocab, merges and velocity; returns its id."""
        merged = self.vocab_r[a] + self.vocab_r[b]
        new_id = len(self.vocab)
        self.vocab[merged] = new_id
        self.vocab_r[new_id] = merged
        self.merges.append((self.vocab_r[a], self.vocab_r[b]))
        self.velocity[new_id] = (self.velocity.get(a, 0.0) + self.velocity.get(b, 0.0)) / 2.0
        return new_id

    def _progress(self, iteration: int, target_merges: int) -> None:
        print(f"\r  {iteration}/{target_merges} ({iteration / target_merges * 100:.1f}%)",
              end="", file=sys.stderr)
        if self.config.progress_callback is not None:
            self.config.progress_callback("merge", iteration, target_merges)

    def _done(self, iteration: int, target_merges: int, t_start: float) -> None:
        if target_merges:
            print(f"\r  {iteration}/{target_merges} done", file=sys.stderr)
            if self.config.progress_callback is not None:
                self.config.progress_callback("merge", iteration, target_merges)
        counters.add("merges", iteration)
        counters.add_time("merges", time.perf_counter() - t_start)

    def _batched_selection_loop(self, words, freqs, V: int) -> None:
        """Classic mode in blocks of ``_SELECT_BLOCK_K`` device-resident
        steps.  The host reads the block's log (a, b, minted) and mints; the
        pair counts come back from the card's histogram at the end (its
        clamp at zero is the host's deletion of non-positive entries, so its
        nonzero entries are the host's dict)."""
        cfg = self.config
        target = cfg.vocab_size
        target_merges = max(target - len(self.vocab), 0)
        t_start = time.perf_counter()
        k = self._SELECT_BLOCK_K
        dev = self.device
        hist = self._hist_on_device(V)
        log = torch.empty((3, k), dtype=torch.int32, device=dev)
        deltas = torch.empty((k, V, 4), dtype=torch.int32, device=dev)
        scratch = SelectScratch(dev) if dev.type == "cuda" else None
        iteration = 0
        self._select_block_times: list[float] = []
        self._select_block_merges: list[int] = []
        while len(self.vocab) < target:
            n_do = min(k, target - len(self.vocab))
            v0b = len(self.vocab)
            tb = time.perf_counter()
            deltas[:n_do].zero_()
            log[2].zero_()
            run_steps(n_do, v0b, words, freqs, hist, log, deltas, scratch=scratch)
            ma, mb, mf = log.cpu().numpy()
            self._select_block_times.append(time.perf_counter() - tb)
            applied = 0
            for i in range(n_do):
                if ma[i] < 0:
                    break
                a, b, minted = int(ma[i]), int(mb[i]), int(mf[i])
                self._count_minted(a, b, self._mint(a, b), minted)
                applied += 1
            self._select_block_merges.append(applied)
            it_before = iteration
            iteration += applied
            if target_merges and iteration // 1000 > it_before // 1000:
                self._progress(iteration, target_merges)
            if applied < n_do:
                break  # the histogram is exhausted
        hist_np = hist.cpu().numpy()
        ys, xs = np.nonzero(hist_np)
        self.pair_freqs = defaultdict(int)
        for a, b in zip(ys.tolist(), xs.tolist()):
            self.pair_freqs[(a, b)] = int(hist_np[a, b])
        self._done(iteration, target_merges, t_start)

    def _inl_window_loop(self, words, freqs, V: int) -> None:
        """INL mode in device-resident rebuild windows.  At each boundary the
        host scores and orders the pairs (float64, as the host trainer) and
        ships the first ``_INL_WINDOW_T``; K15 walks them on the card.  The
        host replays the window's logged deltas merge by merge, so its pair
        and token counts stay exact for the next boundary.  When the card's
        candidates run out before the window's end, the host continues the
        same walk one K14 launch a merge and puts its counts back on the
        card."""
        cfg = self.config
        target = cfg.vocab_size
        target_merges = max(target - len(self.vocab), 0)
        t_start = time.perf_counter()
        k = REBUILD_INTERVAL
        T = self._INL_WINDOW_T
        dev = self.device
        hist = self._hist_on_device(V)
        log = torch.empty((3, k), dtype=torch.int32, device=dev)
        deltas = torch.empty((k, V, 4), dtype=torch.int32, device=dev)
        per_merge = None
        iteration = 0
        self._select_block_times: list[float] = []
        self._select_block_merges: list[int] = []
        while len(self.vocab) < target:
            pairs, order = self._ordered_pairs()  # host float64 scoring
            if not len(order):
                break
            pairs_np = np.asarray(pairs, np.int32).reshape(-1, 2)
            n_cand = min(T, len(order))
            sel = order[:n_cand]
            cand_np = np.zeros((2, T), np.int32)
            cand_np[0, :n_cand] = pairs_np[sel, 0]
            cand_np[1, :n_cand] = pairs_np[sel, 1]
            # the window (the rebuild cadence) against the card's steps,
            # also bounded by the candidates (each step spends at least one)
            window = min(k, target - len(self.vocab))
            n_do = min(window, n_cand)
            v0b = len(self.vocab)
            tb = time.perf_counter()
            cand = torch.from_numpy(cand_np).to(dev)
            state = torch.tensor([-1, 0], dtype=torch.int32, device=dev)
            deltas[:n_do].zero_()
            log[2].zero_()
            run_steps(n_do, v0b, words, freqs, hist, log, deltas,
                      cand=(cand[0], cand[1], n_cand, state))
            ma, mb, mf = log.cpu().numpy()
            applied = 0
            while applied < n_do and ma[applied] >= 0:
                applied += 1
            deltas_np = deltas[:applied].cpu().numpy()
            last_pos = int(state[0])
            self._select_block_times.append(time.perf_counter() - tb)
            for i in range(applied):
                a, b, minted = int(ma[i]), int(mb[i]), int(mf[i])
                new_id = self._mint(a, b)
                self._apply_delta_hist(deltas_np[i], minted, a, b, new_id)
            self._select_block_merges.append(applied)
            iteration += applied
            if applied < window:
                # the card's walk ran out of its T candidates; the host's
                # walk ends the window only when the whole order has no live
                # candidate left, so continue it past T, one merge at a time
                pos = last_pos
                while applied < window and len(self.vocab) < target:
                    nxt = None
                    while pos + 1 < len(order):
                        pos += 1
                        cand_pair = (int(pairs_np[order[pos], 0]), int(pairs_np[order[pos], 1]))
                        if self.pair_freqs.get(cand_pair, 0) > 0:
                            nxt = cand_pair
                            break
                    if nxt is None:
                        break  # the window (and maybe training) is exhausted
                    if per_merge is None:
                        per_merge = self._per_merge_step(words, freqs, V)
                    per_merge(nxt, self._mint(*nxt))
                    hist = self._hist_on_device(V)
                    applied += 1
                    iteration += 1
                if applied == 0:
                    break  # nothing live anywhere: training is done
            if target_merges and iteration and iteration % 1000 < k:
                self._progress(iteration, target_merges)
        self._done(iteration, target_merges, t_start)

    def _apply_delta_hist(self, delta: np.ndarray, minted: int, a: int, b: int, new_id: int):
        """Fold one merge's (reduced) delta histograms into the host's pair
        and token counts; returns the pairs whose counts changed.

        The JAX package then deletes every non-positive entry of the dict;
        here only the touched entries are checked.  The same entries go:
        every entry is positive before a merge (the seed histogram's,
        a checkpoint's and the host trainer's all are), and only touched
        entries change."""
        pf = self.pair_freqs
        pf.pop((a, b), None)
        if not isinstance(pf, defaultdict):
            self.pair_freqs = pf = defaultdict(int, pf)
        touched = set()
        # kind by kind, each in ascending index: the JAX package's order of
        # insertion into the dict
        kinds, xs = np.nonzero(delta.T)
        for kind, x in zip(kinds.tolist(), xs.tolist()):
            v = int(delta[x, kind])
            if kind == 0:
                p = (x, a)
                pf[p] -= v
            elif kind == 1:
                p = (b, x)
                pf[p] -= v
            elif kind == 2:
                p = (x, new_id)
                pf[p] += v
            else:
                p = (new_id, x)
                pf[p] += v
            touched.add(p)
        for p in touched:
            if pf.get(p, 0) <= 0:
                pf.pop(p, None)
        self._count_minted(a, b, new_id, minted)
        return touched

    def _count_minted(self, a: int, b: int, new_id: int, minted: int) -> None:
        """The token counts after a merge of ``minted`` occurrences."""
        if a in self.token_freqs:
            self.token_freqs[a] = max(self.token_freqs[a] - minted, 0)
        if b in self.token_freqs:
            self.token_freqs[b] = max(self.token_freqs[b] - minted, 0)
        self.token_freqs[new_id] = minted

"""Device Unigram trainer: the E-step on the card, kernels K12 and K17.

The JAX package's ``parallel/unigram_trainer.py`` with ``torch.distributed``
in place of the mesh:

- the distinct sentences (up to 128 characters) go to the card once,
  ragged and ordered by length in K12's lane groups
  (``ops/unigram_device.py:UnigramDevice.pack``), with their frequencies and their
  places in the corpus; each process of the group holds the sentences
  ``rank::world_size``;
- each EM round builds the piece tables on the host
  (``build_piece_tables``: the CHD table and the pieces' characters,
  lengths and scores), puts them on the card in one copy, and runs K12
  (the Viterbi, ``viterbi``; single-character fallbacks marked -2 and
  scored by ``<unk>``'s score) then K17 (``piece_hist``: each piece's
  expected count, the frequency of every sentence that chose it, into a
  ``[V]`` int32 histogram, beside the poison flag of each sentence), sums
  the buffer over the processes and reads it back once;
- sentences the card cannot decide exactly (K12 poisons a decision inside
  the float32 margin or a failed exact check) and sentences over 128
  characters are segmented by the host's float64 DP and added to the
  counts, so the trained vocabulary equals the host
  :class:`UnigramTrainer`'s;
- a vocabulary ``build_piece_tables`` refuses, or a corpus whose piece mass
  could wrap int32, takes the host E-step, as in JAX.

The M-step (sort by expected count, prune) stays on the host.  JAX pads the
id axis to a power of two to reuse compiled programs; the kernels take any
size, so nothing is padded here.
"""

from __future__ import annotations

import time
from collections import Counter

import numpy as np
import torch

from ..ops.unigram_device import (
    FALLBACK_ID,
    UnigramDevice,
    build_piece_tables,
    piece_hist,
    viterbi,
)
from ..ops.wordpiece_device import _W
from ..trainers.unigram_trainer import UnigramTrainer, UnigramTrainerConfig
from ..utils.device import resolve_device
from .mesh import rank_and_world, reduce_sum

__all__ = ["DistributedUnigramTrainer"]


class DistributedUnigramTrainer(UnigramTrainer):
    """Unigram trainer whose E-step runs on the card (``cuda`` unless
    ``device="cpu"``, where the kernels' plain versions run; raising
    without a card).  API-compatible with :class:`UnigramTrainer` (train /
    train_from_texts / train_from_iterator); only the expected-count pass
    differs.  ``rounds`` lists each E-step of the last run: its route
    (``"device"``, or ``"host"`` and why), the pieces, the seconds of the
    tables' build, of their copy to the card and of the whole E-step, and
    the sentences poisoned and over 128 characters.  ``capture``, when
    set, is called as ``capture(round, inputs)`` before each device
    E-step's launches, ``inputs`` the arguments of K12 (``"viterbi"``) and
    of K17 but K12's result (``"piece_hist"``)."""

    def __init__(self, config: UnigramTrainerConfig | None = None, device=None):
        super().__init__(config)
        self.device = resolve_device(device)
        self._corpus = None  # (sentences, chars, offs, lens, freqs, gidx, groups, host_idx)
        self._count_overflow = False
        self.rounds: list[dict] = []
        self.capture = None

    def _train_from_sentences(self, sentences):
        # a reused trainer instance must re-stage: the staged corpus belongs
        # to the previous train call's sentence set
        self._corpus = None
        self._count_overflow = False
        self.rounds = []
        return super()._train_from_sentences(sentences)

    def _stage_corpus(self, sentence_freqs: Counter):
        """Put this process's share of the (constant) sentences on the card
        in one copy: characters, offsets, lengths, frequencies and places."""
        sentences = list(sentence_freqs.keys())
        host_idx = [i for i, s in enumerate(sentences) if len(s) > _W]
        # the device histogram accumulates in int32: bound the total emitted
        # piece mass (<= sum freq * len) exactly on host and use the
        # all-host E-step when a count could wrap
        self._count_overflow = (
            sum(sentence_freqs[s] * max(len(s), 1) for s in sentences)
            >= (1 << 31)
        )
        if self._count_overflow:
            self._corpus = (sentences, None, None, None, None, None, None, host_idx)
            return
        rank, world = rank_and_world()
        dev_idx = np.array([i for i, s in enumerate(sentences) if len(s) <= _W],
                           np.int64)[rank::world]
        texts = [sentences[i] for i in dev_idx.tolist()]
        chars, offs, lens, order, groups, _wide = UnigramDevice.pack(texts)
        B = len(texts)
        freqs = np.fromiter((sentence_freqs[texts[j]] for j in order.tolist()), np.int64, B)
        gidx = dev_idx[order].astype(np.int32)
        N = len(chars)
        buf = torch.from_numpy(np.concatenate(
            [chars, offs, lens, freqs.astype(np.int32), gidx])).to(self.device)
        self._corpus = (sentences, buf[:N], buf[N:N + B + 1], buf[N + B + 1:N + 2 * B + 1],
                        buf[N + 2 * B + 1:N + 3 * B + 1], buf[N + 3 * B + 1:], groups, host_idx)

    def _expected_counts(self, sentence_freqs: Counter) -> dict[int, float]:
        t0 = time.perf_counter()
        pieces = {t: (i, s) for i, (t, s) in enumerate(self.vocab)}
        built = build_piece_tables(pieces)
        t_table = time.perf_counter() - t0
        V = len(self.vocab)
        if built is None:
            # ineligible vocab (hash collision / oversized piece): the
            # host E-step is the exact fallback
            self.rounds.append({"route": "host", "reason": "tables refused", "pieces": V,
                                "table_s": t_table})
            return super()._expected_counts(sentence_freqs)
        chd, pc, pl, ps, Lt = built
        cfg = self.config

        if self._corpus is None:
            self._stage_corpus(sentence_freqs)
        if self._count_overflow:
            self.rounds.append({"route": "host", "reason": "int32 piece mass", "pieces": V,
                                "table_s": t_table})
            return super()._expected_counts(sentence_freqs)
        sentences, chars, offs, lens, freqs, gidx, groups, host_idx = self._corpus

        # the tables in one copy: the CHD rows first (16-byte aligned), then
        # the displacements, the pieces' characters, lengths and scores
        t1 = time.perf_counter()
        Vt = pc.shape[0]
        host = np.concatenate([chd.rows.ravel(), chd.disp, pc.ravel(), pl, ps.view(np.int32)])
        tab = torch.from_numpy(host).to(self.device)
        r_end = chd.rows.size
        d_end = r_end + chd.disp.size
        c_end = d_end + pc.size
        rows, disp = tab[:r_end].view(-1, 4), tab[r_end:d_end]
        pc_d, pl_d = tab[d_end:c_end].view(Vt, Lt), tab[c_end:c_end + Vt]
        ps_d = tab[c_end + Vt:].view(torch.float32)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t_copy = time.perf_counter() - t1

        maxcand = min(cfg.max_piece_length, _W)
        fb = float(np.float32(dict(self.vocab).get("<unk>", -100.0)))
        vit = (chars, offs, lens, groups, disp, rows, chd.size, chd.n_buckets, pc_d, pl_d, ps_d,
               fb, maxcand, FALLBACK_ID)
        if self.capture is not None:
            self.capture(len(self.rounds), {"viterbi": vit,
                                            "piece_hist": (offs, freqs, gidx, V, len(sentences))})
        res = viterbi(*vit)
        hist = reduce_sum(piece_hist(res, offs, freqs, gidx, V, len(sentences))).cpu().numpy()

        expected: Counter = Counter()
        for i in np.nonzero(hist[:V])[0].tolist():
            expected[i] = int(hist[i])

        # poisoned rows were excluded from the device histogram;
        # re-segment them (and over-wide sentences) with the exact host DP
        poisoned = np.nonzero(hist[V:])[0].tolist()
        host_rows = sorted(set(host_idx) | set(poisoned))
        if host_rows:
            vocab_map = dict(self.vocab)
            index = {t: i for i, (t, _) in enumerate(self.vocab)}
            for i in host_rows:
                s = sentences[i]
                sfreq = sentence_freqs[s]
                for tok in self._viterbi_segment(s, vocab_map):
                    j = index.get(tok)
                    if j is not None:
                        expected[j] += sfreq
        self.rounds.append({"route": "device", "pieces": V, "table_s": t_table,
                            "to_card_s": t_copy, "e_step_s": time.perf_counter() - t0,
                            "poisoned": len(poisoned), "over_wide": len(host_idx)})
        return expected

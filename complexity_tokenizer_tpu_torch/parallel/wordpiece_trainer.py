"""Device WordPiece trainer: the greedy re-tokenization and the pair count
of every round on the card, kernels K18 and K19.

The JAX package's ``parallel/wordpiece_trainer.py`` with ``torch.distributed``
in place of the mesh:

- the distinct words (up to 128 characters) go to the card once, ragged and
  ordered by length (``ops/wordpiece_device.py:_pack_words``), with their
  frequencies; each process of the group holds the words
  ``rank::world_size``;
- the longest-match tables are an open-address table of the forms' hashes
  that grows by the minted entry's forms each round: the host master
  (:class:`_MatchTables`, JAX's arrays entry for entry) and its mirror on
  the card, to which each round's inserts go as one indexed write;
- each round is K18 (``ops/wordpiece_train_device.py:train_match``: every
  word's greedy match, unmatched characters falling back to their
  ``##``-aware symbols) then K19 (``pair_count``: the words' adjacent
  symbol pairs, keyed ``(a << 16) | b`` and weighted by frequency, summed in
  a hash table on the card), whose (key, count) pairs come back, with one
  process in one asynchronous copy to pinned memory (:class:`_PairReader`);
  with more than one process every process gathers every process's pairs
  and adds them up, so all hold the same global counts;
- words wider than the lanes and words K18 poisons (a hash collision) are
  tokenized and counted on the host each round and added to those counts;
- the selection (the highest count, ties to the lexicographically smallest
  string pair) and the minting run on the host, the same on every process.

The trained vocabulary equals the host :class:`WordPieceTrainer`'s.  The
routes that fall back to the host trainer (after resetting the vocabulary)
are JAX's: the symbol cap (pair keys pack two symbols below 2**15), a
refused insert (a 64-bit collision between two forms, the probe budget,
the slot capacity) and the int32 bound on the weighted pair mass.
"""

from __future__ import annotations

import time
from collections import Counter

import numpy as np
import torch
import torch.distributed as dist

from ..models.wordpiece import WordPieceModel
from ..ops.hashtable import _mix_hash_np
from ..ops.wordpiece_device import _SEED_CONT1, _SEED_CONT2, _W, _key, _pack_words
from ..ops.wordpiece_train_device import (
    MAX_CP,
    MAXP,
    PairCountScratch,
    match_table_views,
    pair_count,
    split_pairs,
    train_match,
)
from ..trainers.wordpiece_trainer import WordPieceTrainer, WordPieceTrainerConfig
from ..utils.device import resolve_device
from .mesh import rank_and_world, reduce_sum

__all__ = ["DistributedWordPieceTrainer", "select_pair"]

_EMPTY_H1 = 0  # (0, 1) marks an empty slot; a real form hashing to it
_EMPTY_H2 = 1  # falls back to the host trainer (2^-64, checked on insert)
_MAX_SYMS = 1 << 15


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def _form_hashes(chars: list[int], cont: bool) -> tuple[int, int]:
    """A form's two hashes as int32 bit patterns, seeded for a continuation."""
    return _key(chars, _SEED_CONT1, _SEED_CONT2) if cont else _key(chars, 0, 0)


def select_pair(keys: np.ndarray, counts: np.ndarray, sym_str: list[str]):
    """The round's pair as strings: the highest count, ties to the
    lexicographically smallest ``(a, b)`` (``parallel/wordpiece_trainer.py:
    499`` in the JAX package, ``min`` over a Counter of string pairs);
    None when there is no pair.  ``keys`` are ``(a << 16) | b`` over the
    symbols ``sym_str``, each once."""
    if counts.size == 0:
        return None
    top = keys[counts == counts.max()].tolist()
    return min((sym_str[k >> 16], sym_str[k & 0xFFFF]) for k in top)


class _MatchTables:
    """Host master + device mirror of the updatable longest-match tables.

    Slots: one per matchable *form* (plain spelling at word start,
    prefix-stripped body for continuations, as
    ops/wordpiece_device.build_wordpiece_tables keys them).  The
    open-address table maps the form's two rolling hashes to its slot;
    ``emit_sym[slot]`` is the trainer symbol emitted on a match.
    """

    def __init__(self, s_cap: int):
        self.s_cap = s_cap
        self.t_size = _pow2(max(4 * s_cap, 64))
        self.h1 = np.full(self.t_size, _EMPTY_H1, np.int32)
        self.h2 = np.full(self.t_size, _EMPTY_H2, np.int32)
        self.slotv = np.zeros(self.t_size, np.int32)
        self.token_chars = np.full((s_cap, _W), -1, np.int32)
        self.token_lens = np.zeros(s_cap, np.int32)
        self.emit_sym = np.full(s_cap, -1, np.int32)
        self.n_slots = 0
        self.max_len = 1
        self.seen_keys: dict[tuple[int, int], int] = {}
        self._dev: torch.Tensor | None = None  # match_table_views' buffer
        self._pending: list[tuple] = []

    def insert_form(self, chars: list[int], cont: bool, sym: int) -> bool:
        """Returns False when the device tier must be abandoned (hash
        collision between two distinct forms, probe overflow, slot
        capacity)."""
        if len(chars) > (_W - 1 if cont else _W):
            return True  # unmatchable within the lane width: skip
        key = _form_hashes(chars, cont)
        if key == (_EMPTY_H1, _EMPTY_H2):
            return False
        if key in self.seen_keys:
            return False  # 64-bit collision between two distinct forms
        if self.n_slots >= self.s_cap:
            return False
        slot = self.n_slots
        self.n_slots += 1
        self.seen_keys[key] = slot
        self.token_chars[slot, : len(chars)] = chars
        self.token_lens[slot] = len(chars)
        self.emit_sym[slot] = sym
        self.max_len = max(self.max_len, len(chars))
        pos = self._probe_insert(key, slot)
        if pos is None:
            return False
        self._pending.append((pos, key, slot))
        return True

    def _probe_insert(self, key, slot):
        mask = self.t_size - 1
        h = int(
            _mix_hash_np(
                np.uint32(key[0] & 0xFFFFFFFF),
                np.uint32(key[1] & 0xFFFFFFFF),
                mask,
            )
        )
        for j in range(MAXP):
            pos = (h + j) & mask
            if (self.h1[pos], self.h2[pos]) == (_EMPTY_H1, _EMPTY_H2):
                self.h1[pos] = key[0]
                self.h2[pos] = key[1]
                self.slotv[pos] = slot
                return pos
        return None  # probe overflow: caller falls back to host

    def device_buffer(self, device) -> torch.Tensor:
        """The mirror on ``device``, one int32 buffer
        (``match_table_views(buf, t_size, s_cap)``), with the pending
        inserts applied in place: one copy of their (index, value) pairs
        and one indexed write, no rebuild.  Each filled row's fourth word
        holds its slot's ``(length << 16) | symbol`` (K18 reads it; a length
        is at most 128 and a symbol below 2**15), an empty row's 0."""
        if self._dev is None:
            filled = (self.h1 != _EMPTY_H1) | (self.h2 != _EMPTY_H2)
            packed = np.where(filled, self.token_lens[self.slotv] << 16 | self.emit_sym[self.slotv],
                              0).astype(np.int32)
            rows = np.stack([self.h1, self.h2, self.slotv, packed], 1)
            meta = np.stack([self.token_lens, self.emit_sym], 1)
            host = np.concatenate([rows.ravel(), meta.ravel(), self.token_chars.ravel()])
            self._dev = torch.from_numpy(host).to(device)
            self._pending.clear()
        elif self._pending:
            t4 = 4 * self.t_size
            m = t4 + 2 * self.s_cap
            cols = np.arange(_W)
            idx, val = [], []
            for pos, key, slot in self._pending:
                ln, sym = self.token_lens[slot], self.emit_sym[slot]
                idx.append([4 * pos, 4 * pos + 1, 4 * pos + 2, 4 * pos + 3, t4 + 2 * slot,
                            t4 + 2 * slot + 1])
                val.append([key[0], key[1], slot, ln << 16 | sym, ln, sym])
                idx.append(m + _W * slot + cols)
                val.append(self.token_chars[slot])
            upd = np.stack([np.concatenate(idx), np.concatenate(val)]).astype(np.int32)
            upd = torch.from_numpy(upd).to(self._dev.device)
            self._dev[upd[0]] = upd[1]
            self._pending.clear()
        return self._dev


class DistributedWordPieceTrainer(WordPieceTrainer):
    """WordPiece trainer whose re-tokenization and pair counting run on the
    card (``cuda`` unless ``device="cpu"``, where the kernels' plain
    versions run; raising without a card).  API-compatible with
    :class:`WordPieceTrainer`.  ``last_stats`` describes the last run: its
    route (``"device"``, or ``"host"`` and why), rounds, the words poisoned
    over all rounds and those over the lanes, and the seconds spent
    launching and reading back (the kernels included) and on the host.
    ``capture``, when set, is called as ``capture(round, inputs)`` before
    each round's launches, ``inputs`` the arguments of K18 (its lane groups
    among them) and the frequencies (the tables are updated in place
    afterwards: copy what is kept)."""

    def __init__(self, config: WordPieceTrainerConfig | None = None, device=None):
        super().__init__(config)
        self.device = resolve_device(device)
        self.last_stats: dict = {}
        self.capture = None

    def _host_fallback(self, word_freqs: Counter, reason: str):
        """Delegate the whole run to the host trainer, resetting any
        partially-built vocab first — the host path assumes a clean start
        (ids are assigned by insertion order)."""
        self.vocab = {}
        self.last_stats = {"route": "host", "reason": reason}
        return super()._train_from_word_freqs(word_freqs)

    def _train_from_word_freqs(self, word_freqs: Counter):
        cfg = self.config
        word_freqs = Counter(
            {w: f for w, f in word_freqs.items() if f >= cfg.min_frequency}
        )
        prefix = cfg.continuing_subword_prefix

        # ---- vocab init: specials then sorted alphabet (host semantics)
        next_id = 0
        for tok in cfg.special_tokens:
            self.vocab[tok] = next_id
            next_id += 1
        alphabet = sorted({c for w in word_freqs for c in w})
        for c in alphabet:
            if c not in self.vocab:
                self.vocab[c] = next_id
                next_id += 1

        # ---- symbol registry: vocab strings + fallback prefix+char syms
        sym_of: dict[str, int] = {}
        sym_str: list[str] = []

        def sym(s: str) -> int:
            i = sym_of.get(s)
            if i is None:
                i = len(sym_str)
                sym_of[s] = i
                sym_str.append(s)
            return i

        cap = cfg.vocab_size + 2 * len(alphabet) + len(cfg.special_tokens) + 8
        if cap >= _MAX_SYMS:
            # pair keys pack into (a<<16)|b int32: symbol space too large
            return self._host_fallback(word_freqs, "symbol cap")

        tables = _MatchTables(2 * cap)
        ok = True
        for tok in self.vocab:
            s = sym(tok)
            ok = ok and tables.insert_form([ord(c) for c in tok], False, s)
            if tok.startswith(prefix) and len(tok) > len(prefix):
                ok = ok and tables.insert_form(
                    [ord(c) for c in tok[len(prefix):]], True, s
                )
        fb_map = np.full((2, MAX_CP), -1, np.int32)  # plain_map, cont_map
        for c in alphabet:
            cp = ord(c)
            fb_map[0, cp] = sym(c)
            fb_map[1, cp] = sym(prefix + c)
        if not ok:
            return self._host_fallback(word_freqs, "insert refused")

        words = list(word_freqs.keys())
        host_words = [w for w in words if len(w) > _W]
        dev_words = [w for w in words if len(w) <= _W]
        # the device pair counts accumulate in int32; bound the total
        # weighted adjacency mass exactly on host and fall back when a sum
        # could wrap (the host trainer uses unbounded ints)
        pair_weight_bound = sum(
            word_freqs[w] * max(len(w) - 1, 0) for w in dev_words
        )
        if pair_weight_bound >= (1 << 31):
            return self._host_fallback(word_freqs, "int32 pair mass")

        # ---- stage this process's share of the (constant) words, once
        dev = self.device
        rank, world = rank_and_world()
        local = dev_words[rank::world]
        wl = np.fromiter(map(len, local), np.int64, len(local))
        chars, offs, order, groups = _pack_words(local, wl, wl)
        B = len(local)
        freqs = np.fromiter((word_freqs[local[j]] for j in order.tolist()), np.int64, B)
        gidx = (rank + world * order).astype(np.int32)  # packed word -> dev_words index
        N = len(chars)
        host = np.concatenate([chars, offs, wl[order].astype(np.int32), freqs.astype(np.int32),
                               gidx])
        buf = torch.from_numpy(host).to(dev)
        chars_d, offs_d = buf[:N], buf[N:N + B + 1]
        lens_d, freqs_d = buf[N + B + 1:N + 2 * B + 1], buf[N + 2 * B + 1:N + 3 * B + 1]
        gidx_d = buf[N + 3 * B + 1:]
        fb_d = torch.from_numpy(fb_map).to(dev)
        scratch = PairCountScratch(N, dev) if dev.type == "cuda" else None
        reader = _PairReader()

        def host_pairs(word_list) -> Counter:
            out: Counter = Counter()
            for wd in word_list:
                toks = self._tokenize_for_training(wd)
                f = word_freqs[wd]
                for i in range(len(toks) - 1):
                    out[(toks[i], toks[i + 1])] += f
            return out

        stats = {"route": "device", "rounds": 0, "poisoned": 0, "over_wide": len(host_words),
                 "device_s": 0.0, "host_s": 0.0}
        while len(self.vocab) < cfg.vocab_size:
            t0 = time.perf_counter()
            lt_cap = min(_pow2(max(tables.max_len, 8)), _W)
            table, meta, schars = match_table_views(tables.device_buffer(dev), tables.t_size,
                                                    tables.s_cap)
            if self.capture is not None:
                self.capture(stats["rounds"], dict(
                    chars=chars_d, offs=offs_d, lens=lens_d, groups=groups, table=table,
                    slot_meta=meta, slot_chars=schars, fb_map=fb_d, lt_cap=lt_cap, freqs=freqs_d))
            out, poison = train_match(chars_d, offs_d, lens_d, groups, table, meta, schars, fb_d,
                                      lt_cap)
            res = pair_count(out, offs_d, freqs_d, poison, scratch)
            # JAX grows its unique-pair budget and retries (at most six
            # times, then the host trainer); K19's table holds every pair
            # of the corpus, so that route does not exist here
            keys, counts, poisoned = _read_pairs(res, poison, gidx_d, len(dev_words), world,
                                                 reader)
            t1 = time.perf_counter()
            stats["device_s"] += t1 - t0
            stats["rounds"] += 1
            stats["poisoned"] += len(poisoned)
            extra = host_pairs(host_words + [dev_words[i] for i in poisoned])
            if extra:
                hk = np.fromiter(((sym(a) << 16) | sym(b) for a, b in extra), np.int64, len(extra))
                hc = np.fromiter(extra.values(), np.int64, len(extra))
                keys, inv = np.unique(np.concatenate([keys, hk]), return_inverse=True)
                agg = np.zeros(len(keys), np.int64)
                np.add.at(agg, inv, np.concatenate([counts, hc]))
                counts = agg
            pick = select_pair(keys, counts, sym_str)
            if pick is None:
                break
            a, b = pick
            if b.startswith(prefix):
                merged = a + b[len(prefix):]
            else:
                merged = a + b
            if merged in self.vocab:
                break  # vocab unchanged -> counts won't change
            self.vocab[merged] = next_id
            next_id += 1
            s = sym(merged)
            if len(sym_str) >= _MAX_SYMS:
                return self._host_fallback(word_freqs, "symbol cap")
            ok = tables.insert_form([ord(c) for c in merged], False, s)
            if merged.startswith(prefix) and len(merged) > len(prefix):
                ok = ok and tables.insert_form(
                    [ord(c) for c in merged[len(prefix):]], True, s
                )
            if not ok:
                return self._host_fallback(word_freqs, "insert refused")
            stats["host_s"] += time.perf_counter() - t1
        self.last_stats = stats

        return WordPieceModel(
            dict(self.vocab),
            cfg.continuing_subword_prefix,
            "[UNK]",
            cfg.max_input_chars_per_word,
        )


class _PairReader:
    """K19's result back on the host, one process: the head and as many pairs
    as the round before had keys, plus a margin, in one asynchronous copy
    into pinned memory and one wait; a second copy only when the round has
    more keys than that (as a first round may)."""

    FIRST = 4096  # keys the first round's copy takes

    def __init__(self):
        self.host: torch.Tensor | None = None
        self.expect = self.FIRST

    def _copy(self, res, lo: int, hi: int) -> None:
        self.host[lo:hi].copy_(res[lo:hi], non_blocking=True)
        if res.is_cuda:
            torch.cuda.current_stream(res.device).synchronize()

    def read(self, res) -> np.ndarray:
        """``res [2 + 2 cap]`` (K19's result) -> its head and pairs, a numpy
        view of the pinned buffer (the next call overwrites it)."""
        if self.host is None or self.host.numel() != res.numel():
            self.host = torch.empty(res.numel(), dtype=torch.int32, pin_memory=res.is_cuda)
        m = min(self.expect, (res.numel() - 2) // 2)
        self._copy(res, 0, 2 + 2 * m)
        n = int(self.host[0])
        if n > m:
            self._copy(res, 2 + 2 * m, 2 + 2 * n)
        self.expect = n + max(1024, n // 16)
        return self.host[:2 + 2 * n].numpy()


def _read_pairs(res, poison, gidx, n_dev: int, world: int, reader: _PairReader):
    """K19's pairs back on the host: (keys int64, counts int64, the poisoned
    words' indices in the corpus's words that fit the lanes).  One process
    reads its head and pairs with ``reader``; with more than one, every
    process's pairs are gathered and summed by key, and the poisoned words
    are those of every process."""
    if world == 1:
        keys, counts, _n, n_poison = split_pairs(reader.read(res))
        keys, counts = keys.astype(np.int64), counts.astype(np.int64)
    else:
        head = res[:2].clone()
        dist.all_reduce(head, op=dist.ReduceOp.MAX)
        n_max, n_poison = (int(x) for x in head.cpu())
        chunk = res[:2 + 2 * n_max].contiguous()
        parts = [torch.empty_like(chunk) for _ in range(world)]
        dist.all_gather(parts, chunk)
        ks, cs = [], []
        for p in parts:
            k, c, _n, _p = split_pairs(p.cpu().numpy())
            ks.append(k)
            cs.append(c)
        keys, inv = np.unique(np.concatenate(ks).astype(np.int64), return_inverse=True)
        counts = np.zeros(len(keys), np.int64)
        np.add.at(counts, inv, np.concatenate(cs).astype(np.int64))
    if n_poison == 0:
        return keys, counts, []
    flags = torch.zeros(n_dev, dtype=torch.int32, device=poison.device)
    flags[gidx] = poison
    reduce_sum(flags)
    return keys, counts, np.flatnonzero(flags.cpu().numpy()).tolist()

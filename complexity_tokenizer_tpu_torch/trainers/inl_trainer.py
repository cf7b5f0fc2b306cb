"""INL-BPE trainer: BPE merge learning with INL-dynamics-scored selection.

The JAX package's ``trainers/inl_trainer.py`` on the host, line for line, so
that vocab, merges, counts and the saved file are the same bit for bit.
Semantics match the reference's ``src/trainer.rs:69-651``:

- ByteLevel pre-tokenization with NFC normalization by default;
- streaming accumulation via ``count_batch`` / ``finish_training``;
- merge selection by score = pair_freq - gate * (v_a' + v_b') where
  v' = clamp(alpha * v - clamp(beta, 0, beta_max) * (tok_freq - mu), +/-v_max)
  and mu = mu_target * total_token_freq (trainer.rs:369-403).  The stored
  velocities are only ever written at token mint time as (v_a + v_b) / 2,
  as in the reference, which leaves all stored velocities at 0.0;
- candidate scores refresh every 100 merges with stale-entry skipping
  (trainer.rs:406-516);
- incremental pair-count deltas on merge application (trainer.rs:519-588),
  with a pair -> containing-words reverse index instead of the reference's
  full scan per merge;
- save() emits tokenizer.json with ByteLevel pre_tokenizer/decoder
  (trainer.rs:598-651).

The device trainer (``parallel/trainer.py``: pair counts and merge steps in
kernels K13-K16) reuses this class's ingestion, scoring and selection.
"""

from __future__ import annotations

import heapq
import json
import sys
from collections import Counter, defaultdict
from dataclasses import dataclass, field

from ..core import normalizers as N
from ..core import pretokenizers as PT

__all__ = ["TrainerConfig", "InlBpeTrainer", "REBUILD_INTERVAL"]

# INL-mode ranking rebuild cadence (trainer.rs:406-516); also the
# granularity at which INL-mode checkpoints are exactly resumable
REBUILD_INTERVAL = 100


@dataclass
class TrainerConfig:
    vocab_size: int = 32000
    min_frequency: int = 2
    special_tokens: list = field(
        default_factory=lambda: ["</s>", "<pad>", "<s>", "<unk>"]
    )
    min_word_length: int = 1
    inl_alpha: float = 0.9
    inl_beta: float = 0.3
    inl_gate: float = 0.5
    inl_mu_target: float = 0.01
    inl_velocity_max: float = 10.0
    inl_beta_max: float = 2.0
    normalizer: object | None = field(default_factory=N.NFC)
    pre_tokenizer: object | None = field(
        default_factory=lambda: PT.ByteLevel(add_prefix_space=False)
    )
    # mid-training fault tolerance (SURVEY §5.3 — no reference
    # counterpart): every `checkpoint_interval` merges the trainer writes
    # its full state to `checkpoint_path`; `resume_training` continues the
    # merge loop from it after a preemption
    checkpoint_path: str | None = None
    checkpoint_interval: int = 0
    # observability (SURVEY §5.1): called as callback(stage, done, total)
    # — "count"/"pairs" once per stage, "merge" every 1000 merges and at
    # loop exit.  Replaces scraping the reference's \r progress bars.
    progress_callback: object | None = None


class InlBpeTrainer:
    def __init__(self, config: TrainerConfig | None = None, **kwargs):
        # kwargs form matches the reference's Python constructor signature
        # (bindings/trainers.rs:18-55): Trainer(vocab_size=..., inl_alpha=...)
        if config is None:
            config = TrainerConfig(**kwargs)
        elif kwargs:
            raise TypeError("pass either a TrainerConfig or keyword arguments")
        self.config = config
        self.vocab: dict[str, int] = {}
        self.vocab_r: dict[int, str] = {}
        self.merges: list[tuple[str, str]] = []
        self.token_freqs: dict[int, int] = defaultdict(int)
        self.velocity: dict[int, float] = {}
        self.pair_freqs: dict[tuple[int, int], int] = defaultdict(int)
        self._word_freqs_accumulator: Counter = Counter()
        self._raw_word_freqs: Counter | None = None  # corpus for resume

    # ------------------------------------------------------------------
    # Corpus ingestion
    # ------------------------------------------------------------------

    def _pretokenize(self, text: str) -> list[str]:
        if self.config.normalizer is not None:
            text = self.config.normalizer.normalize(text)
        if self.config.pre_tokenizer is not None:
            return self.config.pre_tokenizer.pre_tokenize(text)
        return PT.ByteLevel(add_prefix_space=False).pre_tokenize(text)

    def _count_words(self, texts) -> Counter:
        """Word-frequency count: the native scanner (C++, threaded) when
        the config is the default ByteLevel(no prefix space), else the
        Python pre-tokenize path.  Word keys are byte-level ENCODED
        strings either way (one alphabet char per raw byte, so the
        min_word_length filter is identical in both)."""
        cfg = self.config
        pt = cfg.pre_tokenizer
        eligible = pt is None or (
            isinstance(pt, PT.ByteLevel) and not pt.add_prefix_space
        )
        if eligible:
            texts = list(texts)
            norm = cfg.normalizer
            if norm is not None:
                from ..core.normalizers import NFC, NFD, NFKC, NFKD

                if isinstance(norm, (NFC, NFD, NFKC, NFKD)):
                    normalized = [
                        t if t.isascii() else norm.normalize(t) for t in texts
                    ]
                else:
                    normalized = [norm.normalize(t) for t in texts]
            else:
                normalized = texts
            from ..native import count_words as native_count

            # None only where the native library has no CPython surface
            raw = native_count(normalized, cfg.min_word_length)
            if raw is not None:
                from ..utils.bytelevel import encode_bytes

                return Counter({encode_bytes(k): v for k, v in raw.items()})
            texts_iter = normalized
            # already normalized: count via pre-tokenizer only
            ptok = pt or PT.ByteLevel(add_prefix_space=False)
            wf: Counter = Counter()
            for text in texts_iter:
                for word in ptok.pre_tokenize(text):
                    if len(word) >= cfg.min_word_length:
                        wf[word] += 1
            return wf
        wf = Counter()
        for text in texts:
            for word in self._pretokenize(text):
                if len(word) >= cfg.min_word_length:
                    wf[word] += 1
        return wf

    def train(self, files) -> None:
        print("Step 1: Counting word frequencies...")
        word_freqs: Counter = Counter()
        for path in files:
            with open(path, "r", encoding="utf-8") as f:
                word_freqs.update(
                    self._count_words([line.rstrip("\n") for line in f])
                )
        word_freqs = Counter(
            {w: f for w, f in word_freqs.items() if f >= self.config.min_frequency}
        )
        print(f"  Found {len(word_freqs)} unique words")
        self._train_from_word_freqs(word_freqs)

    def train_from_texts(self, texts) -> None:
        print("Step 1: Counting word frequencies (ByteLevel)...")
        word_freqs = self._count_words(texts)
        word_freqs = Counter(
            {w: f for w, f in word_freqs.items() if f >= self.config.min_frequency}
        )
        print(f"  Found {len(word_freqs)} unique words")
        self._train_from_word_freqs(word_freqs)

    train_from_iterator = train_from_texts

    def count_batch(self, texts) -> None:
        """Streaming accumulation (trainer.rs:209-222)."""
        self._word_freqs_accumulator.update(self._count_words(texts))

    def finish_training(self) -> None:
        word_freqs = Counter(
            {
                w: f
                for w, f in self._word_freqs_accumulator.items()
                if f >= self.config.min_frequency
            }
        )
        self._word_freqs_accumulator = Counter()
        print(f"  Found {len(word_freqs)} unique words")
        self._train_from_word_freqs(word_freqs)

    # ------------------------------------------------------------------
    # Training core
    # ------------------------------------------------------------------

    def _train_from_word_freqs(self, word_freqs: Counter) -> None:
        self._raw_word_freqs = word_freqs
        if self.config.progress_callback is not None:
            self.config.progress_callback("count", len(word_freqs), len(word_freqs))
        print("Step 2: Initializing vocabulary (ByteLevel alphabet)...")
        words, freqs = self._init_vocab(word_freqs)
        print(f"  Initial vocab size: {len(self.vocab)}")

        print("Step 3: Computing initial pair frequencies...")
        pair_words: dict[tuple[int, int], set[int]] = defaultdict(set)
        for wi, toks in enumerate(words):
            f = freqs[wi]
            for i in range(len(toks) - 1):
                p = (toks[i], toks[i + 1])
                self.pair_freqs[p] += f
                pair_words[p].add(wi)
        print(f"  Found {len(self.pair_freqs)} unique pairs")
        if self.config.progress_callback is not None:
            self.config.progress_callback(
                "pairs", len(self.pair_freqs), len(self.pair_freqs)
            )

        print("Step 4: Learning merges with INL dynamics...")
        self._learn_merges(words, freqs, pair_words)
        print(f"  Final vocab size: {len(self.vocab)}")
        print(f"  Total merges: {len(self.merges)}")

    def _init_vocab(self, word_freqs: Counter):
        next_id = 0
        for tok in self.config.special_tokens:
            self.vocab[tok] = next_id
            self.vocab_r[next_id] = tok
            next_id += 1
        chars = sorted({c for w in word_freqs for c in w})
        for c in chars:
            if c not in self.vocab:
                self.vocab[c] = next_id
                self.vocab_r[next_id] = c
                next_id += 1
        words: list[list[int]] = []
        freqs: list[int] = []
        get = self.vocab.get
        for w, f in word_freqs.items():
            toks = [t for t in (get(c) for c in w) if t is not None]
            words.append(toks)
            freqs.append(f)
            for t in toks:
                self.token_freqs[t] += f
        for tid in self.vocab.values():
            self.velocity[tid] = 0.0
        return words, freqs

    def _score_arrays(self):
        """(pairs, packed_keys, freqs, scores) for every stored pair, with
        the INL dynamics score (trainer.rs:369-403) vectorized — the
        per-pair Python loop dominated training time at realistic pair
        counts.  Operand order matches the scalar formula (IEEE-identical).
        """
        import numpy as np

        cfg = self.config
        pf = self.pair_freqs
        n = len(pf)
        if n == 0:
            return [], np.empty(0, np.int64), np.empty(0), np.empty(0)
        total_freq = sum(self.token_freqs.values())
        mu = cfg.inl_mu_target * total_freq
        beta = min(max(cfg.inl_beta, 0.0), cfg.inl_beta_max)
        vmax = cfg.inl_velocity_max
        pairs = list(pf.keys())
        keys = np.fromiter(
            ((a << 32) | b for a, b in pairs), np.int64, n
        )  # packed = tuple order for non-negative id pairs
        fr = np.fromiter(pf.values(), np.float64, n)
        a_ids = keys >> 32
        b_ids = keys & 0xFFFFFFFF
        m = int(a_ids.max() | b_ids.max()) + 1
        tf_arr = np.zeros(m, np.float64)
        for t, f in self.token_freqs.items():
            if t < m:
                tf_arr[t] = f
        vel_arr = np.zeros(m, np.float64)
        for t, v in self.velocity.items():
            if t < m:
                vel_arr[t] = v
        v_a = cfg.inl_alpha * vel_arr[a_ids] - beta * (tf_arr[a_ids] - mu)
        v_b = cfg.inl_alpha * vel_arr[b_ids] - beta * (tf_arr[b_ids] - mu)
        np.clip(v_a, -vmax, vmax, out=v_a)
        np.clip(v_b, -vmax, vmax, out=v_b)
        scores = fr - cfg.inl_gate * (v_a + v_b)
        return pairs, keys, fr, scores

    def _scores(self):
        """[(score, pair)] for live pairs (compat wrapper)."""
        pairs, _, fr, scores = self._score_arrays()
        return [
            (float(s), p) for s, p, f in zip(scores, pairs, fr) if f > 0
        ]

    def _ordered_pairs(self):
        """(pairs, order): walking ``pairs[order[i]]`` visits pairs in
        merge-priority order — score desc, ties by pair ascending —
        identical to popping a heap of (-score, pair).  Dead entries
        (freq <= 0) are not filtered here; the walk's staleness check
        skips them exactly as the heap's did."""
        import numpy as np

        pairs, keys, _, scores = self._score_arrays()
        if not pairs:
            return [], np.empty(0, np.int64)
        order = np.lexsort((keys, -scores))
        return pairs, order

    def _learn_merges(self, words, freqs, pair_words) -> None:
        def apply_merge(pair, new_id):
            return self._apply_merge(words, freqs, pair_words, pair, new_id)

        self._selection_loop(apply_merge)

    def _selection_loop(self, apply_merge) -> None:
        """The merge-selection loop shared by the host and distributed
        trainers (classic exact heap / INL rebuild walk, progress,
        periodic checkpoints, merges/s counters).  ``apply_merge(pair,
        new_id)`` performs one merge on the backend's word state and
        returns the set of pairs whose counts changed."""
        import time as _time

        from ..utils.metrics import counters

        cfg = self.config
        target = cfg.vocab_size
        iteration = 0
        target_merges = max(target - len(self.vocab), 0)
        _t_start = _time.perf_counter()

        def mint(pair):
            nonlocal iteration
            a, b = pair
            merged = self.vocab_r[a] + self.vocab_r[b]
            new_id = len(self.vocab)
            self.vocab[merged] = new_id
            self.vocab_r[new_id] = merged
            self.merges.append((self.vocab_r[a], self.vocab_r[b]))
            touched = apply_merge(pair, new_id)
            v_a = self.velocity.get(a, 0.0)
            v_b = self.velocity.get(b, 0.0)
            self.velocity[new_id] = (v_a + v_b) / 2.0
            iteration += 1
            if iteration % 1000 == 0 and target_merges:
                print(
                    f"\r  {iteration}/{target_merges}"
                    f" ({iteration / target_merges * 100:.1f}%)",
                    end="",
                    file=sys.stderr,
                )
                if cfg.progress_callback is not None:
                    cfg.progress_callback("merge", iteration, target_merges)
            if (
                cfg.checkpoint_interval
                and cfg.checkpoint_path
                and iteration % cfg.checkpoint_interval == 0
                # INL mode: only rebuild boundaries are exactly resumable
                # (mid-window state includes a stale score order computed
                # from history the checkpoint does not carry); classic
                # mode's exact heap is reconstructible anywhere
                and (cfg.inl_gate == 0.0 or len(self.merges) % REBUILD_INTERVAL == 0)
                and self._is_checkpoint_writer()
            ):
                self.save_checkpoint(cfg.checkpoint_path)
            return touched

        if cfg.inl_gate == 0.0:
            # Classic mode (score == freq): one exact lazy-deletion heap —
            # entries carry the freq they were pushed with and are valid
            # only if it still matches, so every pop is the true maximum.
            # (The reference rebuilds every 100 merges and accepts stale
            # scores inside the window, trainer.rs:406-446 — but its
            # tie-order comes from a randomized HashMap iteration, i.e. the
            # reference trainer is nondeterministic; exact-max selection is
            # deterministic and at least as good, so merge tables differ
            # only within the reference's own run-to-run variance.)
            pf = self.pair_freqs
            heap = [(-f, p) for p, f in pf.items() if f > 0]
            heapq.heapify(heap)
            while len(self.vocab) < target and heap:
                nf, pair = heapq.heappop(heap)
                if pf.get(pair, 0) != -nf:
                    continue  # stale
                for p in mint(pair):
                    f = pf.get(p, 0)
                    if f > 0:
                        heapq.heappush(heap, (-f, p))
        else:
            # INL dynamics: scores drift with every merge, so rebuild the
            # ranking every 100 merges exactly like trainer.rs:406-516
            # (stale entries accepted within the window when still live).
            # A sorted walk pops in the same order as the heap it replaces.
            rebuild_interval = REBUILD_INTERVAL
            while len(self.vocab) < target:
                pairs, order = self._ordered_pairs()
                if not pairs:
                    break
                pos = 0
                n_ord = len(order)
                for _ in range(rebuild_interval):
                    if len(self.vocab) >= target:
                        break
                    pair = None
                    while pos < n_ord:
                        cand = pairs[order[pos]]
                        pos += 1
                        if self.pair_freqs.get(cand, 0) > 0:
                            pair = cand
                            break
                    if pair is None:
                        break
                    mint(pair)
        if target_merges:
            print(f"\r  {iteration}/{target_merges} done", file=sys.stderr)
            if cfg.progress_callback is not None:
                cfg.progress_callback("merge", iteration, target_merges)
        counters.add("merges", iteration)
        counters.add_time("merges", _time.perf_counter() - _t_start)

    def _apply_merge(self, words, freqs, pair_words, pair, new_id):
        """Merge + incremental pair deltas (trainer.rs:519-588), touching
        only words known to contain the pair.  Returns the set of pairs
        whose counts changed (for incremental heap updates)."""
        a, b = pair
        self.pair_freqs.pop(pair, None)
        affected = pair_words.pop(pair, set())
        new_token_freq = 0
        pf = self.pair_freqs
        pw = pair_words
        touched = set()
        for wi in affected:
            toks = words[wi]
            f = freqs[wi]
            i = 0
            while i < len(toks) - 1:
                if toks[i] == a and toks[i + 1] == b:
                    if i > 0:
                        left = (toks[i - 1], a)
                        pf[left] -= f
                        touched.add(left)
                    if i + 2 < len(toks):
                        right = (b, toks[i + 2])
                        pf[right] -= f
                        touched.add(right)
                    toks[i] = new_id
                    del toks[i + 1]
                    if i > 0:
                        nl = (toks[i - 1], new_id)
                        pf[nl] += f
                        pw[nl].add(wi)
                        touched.add(nl)
                    if i + 1 < len(toks):
                        nr = (new_id, toks[i + 1])
                        pf[nr] += f
                        pw[nr].add(wi)
                        touched.add(nr)
                    new_token_freq += f
                else:
                    i += 1
        if a in self.token_freqs:
            self.token_freqs[a] = max(self.token_freqs[a] - new_token_freq, 0)
        if b in self.token_freqs:
            self.token_freqs[b] = max(self.token_freqs[b] - new_token_freq, 0)
        self.token_freqs[new_id] = new_token_freq
        # prune exactly the entries this merge drove to zero — no dict scan
        for p in touched:
            if pf.get(p, 0) <= 0:
                pf.pop(p, None)
                pair_words.pop(p, None)
        return touched

    # ------------------------------------------------------------------
    # Accessors / save
    # ------------------------------------------------------------------

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    @property
    def num_merges(self) -> int:
        return len(self.merges)

    # ------------------------------------------------------------------
    # Checkpoint / resume (SURVEY §5.3-5.4: the reference has none; for
    # preemptible pod slices we persist the full trainer state so a run
    # can resume mid-accumulation)
    # ------------------------------------------------------------------

    def _is_checkpoint_writer(self) -> bool:
        """Whether this controller writes checkpoints (single-host: yes)."""
        return True

    def save_checkpoint(self, path) -> None:
        """Persist (vocab, merges, pair histogram, velocity, accumulator).

        Crash-safe: state is written to a temp file and os.replace()'d so
        a preemption mid-write never truncates the previous checkpoint.
        The (large, ingestion-constant) corpus word_freqs go to a sidecar
        ``<path>.corpus`` written once per run, so periodic checkpoints
        cost O(merge state), not O(corpus).
        """
        import os

        path = str(path)
        corpus_ref = None
        if self._raw_word_freqs is not None:
            corpus_ref = path + ".corpus"
            if getattr(self, "_corpus_sidecar_written", None) != corpus_ref:
                tmp = corpus_ref + ".tmp"
                with open(tmp, "w", encoding="utf-8") as f:
                    json.dump(
                        list(self._raw_word_freqs.items()),
                        f,
                        ensure_ascii=False,
                    )
                os.replace(tmp, corpus_ref)
                self._corpus_sidecar_written = corpus_ref
        state = {
            "config": {
                k: v
                for k, v in self.config.__dict__.items()
                if k not in ("normalizer", "pre_tokenizer", "progress_callback")
            },
            "vocab": self.vocab,
            "merges": self.merges,
            "token_freqs": list(self.token_freqs.items()),
            "velocity": list(self.velocity.items()),
            "pair_freqs": [[a, b, f] for (a, b), f in self.pair_freqs.items()],
            "word_freqs_accumulator": list(self._word_freqs_accumulator.items()),
            "word_freqs_file": (
                os.path.basename(corpus_ref) if corpus_ref else None
            ),
        }
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(state, f, ensure_ascii=False)
        os.replace(tmp, path)

    @classmethod
    def load_checkpoint(cls, path, config: TrainerConfig | None = None, **init_kwargs):
        """A trainer in the checkpoint's state (``init_kwargs`` go to the
        constructor, e.g. the device trainer's ``device``)."""
        with open(path, "r", encoding="utf-8") as f:
            state = json.load(f)
        if config is None:
            config = TrainerConfig(**state["config"])
        self = cls(config, **init_kwargs)
        self.vocab = dict(state["vocab"])
        self.vocab_r = {v: k for k, v in self.vocab.items()}
        self.merges = [tuple(m) for m in state["merges"]]
        self.token_freqs = defaultdict(
            int, {int(k): v for k, v in state["token_freqs"]}
        )
        self.velocity = {int(k): v for k, v in state["velocity"]}
        self.pair_freqs = defaultdict(
            int, {(a, b): f for a, b, f in state["pair_freqs"]}
        )
        self._word_freqs_accumulator = Counter(
            dict(state["word_freqs_accumulator"])
        )
        if state.get("word_freqs") is not None:  # legacy inline form
            self._raw_word_freqs = Counter(dict(state["word_freqs"]))
        elif state.get("word_freqs_file"):
            import os

            sidecar = os.path.join(
                os.path.dirname(os.path.abspath(str(path))),
                state["word_freqs_file"],
            )
            with open(sidecar, "r", encoding="utf-8") as f:
                self._raw_word_freqs = Counter(dict(json.load(f)))
            self._corpus_sidecar_written = sidecar
        return self

    # ------------------------------------------------------------------
    # Mid-training resume (SURVEY §5.3: preempted pod slices resume)
    # ------------------------------------------------------------------

    @classmethod
    def resume_training(cls, path, config: TrainerConfig | None = None, **init_kwargs):
        """Continue a checkpointed merge loop to ``vocab_size``.

        Word state is rebuilt by greedily re-encoding every distinct word
        with the checkpointed partial merge table — identical to the state
        the loop had, because training applies merges in rank order (the
        same well-formedness argument as the batch kernel).  The rebuilt
        pair histogram is verified against the checkpointed one before
        continuing.
        """
        self = cls.load_checkpoint(path, config, **init_kwargs)
        if self._raw_word_freqs is None:
            raise ValueError(
                "checkpoint has no word_freqs; it predates mid-training "
                "resume support or was saved before ingestion"
            )
        if len(self.vocab) >= self.config.vocab_size:
            return self  # already done
        words, freqs = self._rebuild_words()
        check: dict[tuple[int, int], int] = defaultdict(int)
        pair_words: dict[tuple[int, int], set] = defaultdict(set)
        for wi, toks in enumerate(words):
            f = freqs[wi]
            for i in range(len(toks) - 1):
                p = (toks[i], toks[i + 1])
                check[p] += f
                pair_words[p].add(wi)
        saved = {k: v for k, v in self.pair_freqs.items() if v > 0}
        rebuilt = {k: v for k, v in check.items() if v > 0}
        if saved != rebuilt:
            raise ValueError(
                "rebuilt pair histogram does not match the checkpoint "
                "(corrupt checkpoint or non-well-formed merge history)"
            )
        self._resume_merge_loop(words, freqs, pair_words)
        return self

    def _rebuild_words(self):
        """Distinct words re-encoded with the current partial merge table
        (greedy lowest-rank loop, the training-order equivalent)."""
        ranks: dict[tuple[int, int], int] = {}
        minted: dict[int, int] = {}
        for r, (a, b) in enumerate(self.merges):
            ia, ib, iab = (
                self.vocab.get(a),
                self.vocab.get(b),
                self.vocab.get(a + b),
            )
            if ia is None or ib is None or iab is None:
                continue
            ranks[(ia, ib)] = r
            minted[r] = iab
        get = self.vocab.get
        words: list[list[int]] = []
        freqs: list[int] = []
        for w, f in self._raw_word_freqs.items():
            toks = [t for t in (get(c) for c in w) if t is not None]
            # toks may contain minted ids for 1-char tokens only at seed
            # stage; apply the merge loop
            while len(toks) > 1:
                best_i = -1
                best_r = -1
                for i in range(len(toks) - 1):
                    r = ranks.get((toks[i], toks[i + 1]))
                    if r is not None and (best_i < 0 or r < best_r):
                        best_i = i
                        best_r = r
                if best_i < 0:
                    break
                toks[best_i] = minted[best_r]
                del toks[best_i + 1]
            words.append(toks)
            freqs.append(f)
        return words, freqs

    def _resume_merge_loop(self, words, freqs, pair_words) -> None:
        print("Resuming merge loop from checkpoint...")
        self._learn_merges(words, freqs, pair_words)
        print(f"  Final vocab size: {len(self.vocab)}")
        print(f"  Total merges: {len(self.merges)}")

    def save(self, path) -> None:
        """tokenizer.json with ByteLevel pretok/decoder (trainer.rs:598-651)."""
        merges_str = [f"{a} {b}" for a, b in self.merges]
        added_tokens = [
            {
                "id": i,
                "content": tok,
                "special": True,
                "single_word": False,
                "lstrip": False,
                "rstrip": False,
                "normalized": False,
            }
            for i, tok in enumerate(self.config.special_tokens)
        ]
        tokenizer_json = {
            "version": "1.0",
            "model": {"type": "BPE", "vocab": self.vocab, "merges": merges_str},
            "added_tokens": added_tokens,
            "pre_tokenizer": {
                "type": "ByteLevel",
                "add_prefix_space": False,
                "use_regex": True,
            },
            "decoder": {"type": "ByteLevel"},
        }
        with open(path, "w", encoding="utf-8") as f:
            json.dump(tokenizer_json, f, ensure_ascii=False, indent=2)
        self._export_warm_cache(path)

    # words beyond this (by frequency) stay out of the shipped warm
    # cache: the Zipf tail contributes ~nothing to serve-time hit rate
    # but grows the artifact linearly
    _WARM_CACHE_MAX_WORDS = 262_144

    def _export_warm_cache(self, path) -> None:
        """Ship the trainer's word knowledge with the artifact: the
        distinct corpus words it counted, pre-merged under the final
        table, land in <stem>.warmcache.npz so a ``from_file`` process
        serves its first batch warm (the reference re-merges the corpus
        head in every process, mod.rs:601-605; the trainer already paid
        for that knowledge once).  Best-effort — failures leave only the
        load-time vocab warm-start."""
        try:
            from ..tokenizer import Tokenizer
            from ..utils.bytelevel import unicode_to_bytes

            if len(self.vocab) < Tokenizer._WARM_START_MIN_VOCAB:
                return
            inv = unicode_to_bytes()
            extra: list[bytes] = []
            if self._raw_word_freqs:
                top = sorted(
                    self._raw_word_freqs.items(),
                    key=lambda kv: -kv[1],
                )[: self._WARM_CACHE_MAX_WORDS]
                for w, _f in top:
                    try:
                        extra.append(bytes(inv[c] for c in w))
                    except KeyError:
                        continue
            tok = Tokenizer.from_file(path)
            tok.export_warm_cache(extra)
        except Exception:
            pass

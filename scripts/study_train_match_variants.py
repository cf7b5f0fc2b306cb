#!/usr/bin/env python3
"""Time designs of the WordPiece trainer's greedy match K18 on one NVIDIA card.

    python3 scripts/study_train_match_variants.py [--variants NAME,...] [--size 30522]
                                                 [--reps 2] [--skip-run]

Every variant is built alone, with the package's ``nvcc`` flags and ``-I``
the package's ``csrc``, all at once: ``package`` is the package's
``csrc/wordpiece_train.cu``; ``parent`` is
``scripts/train_match_variants/parent_train_match.cu``, the K18 the package
shipped before its redesign (a thread a word, the candidate lengths one
after another; its entry ``ctok_train_match_parent``); the others are
``scripts/train_match_variants/train_match_variants.cu`` (the package's K18
with the designs it was measured against behind switches, see its header)
with these macros:

- ``study-defaults``: none (the study source's copy of the package);
- ``meta-from-slot``: ``K18_META=0``, a hit's length and symbol read from
  ``slot_meta`` after the probe, not from the row's fourth word;
- ``check-ahead``: ``K18_AHEAD=1``, the exact check sent out with the next
  step's probes, not right after the step's ballots;
- ``word-order``: ``K18_LONGEST=0``, the warps in the words' order, not the
  longest words' first;
- ``unfitted``: ``K18_FIT=0``, the caller's lane groups as given, not
  narrowed to ``lt_cap``'s candidates;
- ``first-design``: ``K18_AHEAD=1,K18_FIT=0``, the design first built;
- ``bare``: ``K18_META=0,K18_LONGEST=0,K18_FIT=0``, the lane groups alone;
- ``min-blocks-16``: ``K18_MINB=16``, 16 blocks of 128 threads an SM asked
  of the register allocator (32 registers a thread), so that the run's
  blocks fit the card at once.

What it measures, on ``zipf_corpus(10_000, seed=17)`` and the multilingual
pieces (the WordPiece 30,522 run of ``chip_smoke.py``), its vocabulary
entry for entry ``.cache/bench_wordpiece_30k.json``:

1. Over the run: the trainer's K18 replaced by every variant in turns, each
   round (the order rotating a step a round), on the round's inputs behind
   a ``torch.cuda._sleep`` that holds the card while the host enqueues,
   timed with CUDA events around each variant's launch and summed; each
   round's ``out`` and ``poison`` equal to the first variant's (the
   package's), whose result goes on to the trainer.  The inputs of rounds
   0, 1,000, 10,000 and the last are kept.
2. At those rounds: each variant bit for bit against the plain version and
   timed warm and cold (``chip_smoke._time_ms``, ``_time_cold_ms``) in
   turns (``--reps`` rounds, forward then backward), beside the plain
   version and the bound (``chip_smoke._k18_need``); the words, characters,
   ``lt_cap`` and probes of the round.

Prints the card's name and power limit, each build's register report, a
line per measurement, and one JSON line of every number.  Needs a card and
``nvcc``.  ``chip_smoke.py`` imports the parent's K18 and the round timer
from here.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "complexity_tokenizer_tpu_torch", "csrc")
VARIANT_DIR = os.path.join(REPO, "scripts", "train_match_variants")
STUDY_SRC = os.path.join(VARIANT_DIR, "train_match_variants.cu")
PARENT_SRC = os.path.join(VARIANT_DIR, "parent_train_match.cu")
BUILD = os.path.join(REPO, "build", "train_match_study")
P, I, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint

VARIANTS = {
    "study-defaults": "",
    "meta-from-slot": "K18_META=0",
    "check-ahead": "K18_AHEAD=1",
    "word-order": "K18_LONGEST=0",
    "unfitted": "K18_FIT=0",
    "first-design": "K18_AHEAD=1,K18_FIT=0",
    "bare": "K18_META=0,K18_LONGEST=0,K18_FIT=0",
    "min-blocks-16": "K18_MINB=16",
}
STATES = (0, 1000, 10_000, -1)  # -1: the last round
# the card held (about 60 us a library) while the host enqueues every library's launch
SLEEP_CYCLES_EACH = 120_000
MATCH_KEYS = ("chars", "offs", "lens", "groups", "table", "slot_meta", "slot_chars", "fb_map",
              "lt_cap")


def build(jobs: dict) -> dict:
    """name -> ctypes library for each (source, macros), built at once
    (``study_pair_count_variants.build``) under ``build/train_match_study``."""
    import study_pair_count_variants as k19study

    return k19study.build(jobs, BUILD, "train_match")


class K18:
    """One library's K18: ``parent`` (its own entry, no lane groups) or the
    package's signature.  Called with :func:`train_match`'s arguments."""

    def __init__(self, lib, parent: bool = False):
        self.parent = parent
        if parent:
            self.fn = lib.ctok_train_match_parent
            self.fn.argtypes = (P, P, P, I, P, U, P, P, P, I, P, P, P)
        else:
            self.fn = lib.ctok_train_match
            self.fn.argtypes = (P, P, P, I, I, I, P, U, P, P, P, I, P, P, P)
        self.fn.restype = I

    def __call__(self, chars, offs, lens, groups, table, slot_meta, slot_chars, fb_map, lt_cap):
        """Launches K18 into new buffers; returns (out, poison)."""
        import torch

        N, B = chars.numel(), lens.numel()
        out = torch.empty(N, dtype=torch.int32, device=chars.device)
        poison = torch.empty(B, dtype=torch.int32, device=chars.device)
        stream = torch.cuda.current_stream().cuda_stream
        head = (chars.data_ptr(), offs.data_ptr(), lens.data_ptr())
        tail = (table.data_ptr(), table.shape[0] - 1, slot_meta.data_ptr(), slot_chars.data_ptr(),
                fb_map.data_ptr(), int(lt_cap), out.data_ptr(), poison.data_ptr(), stream)
        if self.parent:
            err = self.fn(*head, B, *tail)
        else:
            err = self.fn(*head, int(groups[0]), int(groups[1]), B, *tail)
        if err:
            raise RuntimeError(f"K18: CUDA error {err}")
        return out, poison


def kept_inputs(args) -> dict:
    """A round's K18 arguments as a dict, the tensors cloned."""
    import torch

    return {k: v.clone() if isinstance(v, torch.Tensor) else v for k, v in zip(MATCH_KEYS, args)}


def match_args(inp: dict) -> tuple:
    return tuple(inp[k] for k in MATCH_KEYS)


class RoundTimer:
    """The WordPiece trainer's K18 replaced, each round, by every library of
    ``k18s`` in turns on the round's inputs (the order rotating a step a
    round, behind a ``torch.cuda._sleep``), each timed with CUDA events and
    summed; the first library's result goes on to the trainer, and every
    library's ``out`` and ``poison`` must equal it.  ``kept[r]``: the inputs
    of the rounds ``keep`` (-1: the last, kept under its own number as
    ``kept[-1] = (round, inputs)``)."""

    def __init__(self, k18s: dict, keep=()):
        self.k18s = k18s
        self.names = list(k18s)
        self.ms = {n: 0.0 for n in self.names}
        self.keep = set(keep)
        self.kept: dict = {}
        self.rounds = 0
        self._last = None

    def train_match(self, *args):
        import torch

        r = self.rounds
        self.rounds += 1
        if r in self.keep:
            self.kept[r] = kept_inputs(args)
        if -1 in self.keep:
            # the mirror is written only by the next round's update, so the
            # last round's inputs are still whole when the run ends
            self._last = (r, args)
        k = r % len(self.names)
        order = self.names[k:] + self.names[:k]
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(order) + 1)]
        torch.cuda._sleep(SLEEP_CYCLES_EACH * (1 + len(order)))
        ev[0].record()
        res = {}
        for i, n in enumerate(order):
            res[n] = self.k18s[n](*args)
            ev[i + 1].record()
        ev[-1].synchronize()
        for i, n in enumerate(order):
            self.ms[n] += ev[i].elapsed_time(ev[i + 1])
        ref = res[self.names[0]]
        for n in self.names[1:]:
            if not (torch.equal(res[n][0], ref[0]) and torch.equal(res[n][1], ref[1])):
                raise AssertionError(f"K18 round {r}: {n} differs from {self.names[0]}")
        return ref

    def finish(self):
        """Keeps the last round's inputs (a copy: the trainer has ended)."""
        if self._last is not None:
            r, args = self._last
            self.kept[-1] = (r, kept_inputs(args))
            self._last = None

    @contextlib.contextmanager
    def installed(self):
        from complexity_tokenizer_tpu_torch.parallel import wordpiece_trainer as wt

        import study_pair_count_variants as k19study

        with k19study.patched(wt, train_match=self.train_match):
            yield
        self.finish()


def state_items(kept: dict):
    """(round, inputs) of the kept rounds in order, the last one last."""
    for r in sorted(kept, key=lambda x: (x < 0, x)):
        yield kept[r] if r == -1 else (r, kept[r])


def round_stats(inp: dict) -> dict:
    """A round's K18 work: words, characters, lt_cap, groups, the candidates
    probed and the table bytes they need (``chip_smoke._k18_need``)."""
    import chip_smoke as smoke

    n_probe, table_bytes = smoke._k18_need(inp)
    return dict(words=inp["lens"].numel(), chars=inp["chars"].numel(), lt_cap=inp["lt_cap"],
                groups=list(inp["groups"]), probes=n_probe, table_bytes=table_bytes)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=None, help="NAME,... (package and parent always)")
    ap.add_argument("--size", type=int, default=30_522, help="the WordPiece vocabulary size")
    ap.add_argument("--reps", type=int, default=2, help="rounds of turns at each state")
    ap.add_argument("--skip-run", action="store_true", help="no sum over the run")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("study_train_match_variants: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import chip_smoke as smoke
    import study_pair_count_variants as k19study
    from complexity_tokenizer_tpu_torch.ops.wordpiece_train_device import train_match_plain

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    keep = None if args.variants is None else set(args.variants.split(","))
    jobs = {"package": (os.path.join(CSRC, "wordpiece_train.cu"), ""),
            "parent": (PARENT_SRC, "")}
    for name, macros in VARIANTS.items():
        if keep is None or name in keep:
            jobs[name] = (STUDY_SRC, macros)
    libs = build(jobs)
    k18s = {n: K18(lib, parent=n == "parent") for n, lib in libs.items()}
    names = list(k18s)
    out: dict = {"card": smi.stdout.strip(), "variants": {n: jobs[n] for n in names}}

    # 1. every round of the run, every variant in turns (or the package alone)
    timer = RoundTimer(k18s if not args.skip_run else {"package": k18s["package"]}, keep=STATES)
    t0 = time.perf_counter()
    with timer.installed():
        entries, wall, _st, _ = k19study.wordpiece_run(args.size)
    k19study._check_golden(entries, args.size, "the run in turns")
    if not args.skip_run:
        out["run_ms"] = timer.ms
        out["run_rounds"] = timer.rounds
        print(f"the run in turns: {timer.rounds} rounds in {time.perf_counter() - t0:.1f} s",
              flush=True)
        for n in names:
            print(f"K18 over the run's {timer.rounds} rounds, {n}: {timer.ms[n]:.3f} ms "
                  f"({1e3 * timer.ms[n] / timer.rounds:.2f} us a round)", flush=True)

    # 2. the states: bit for bit, warm and cold in turns, plain, bound
    out["states"] = {}
    for r, inp in state_items(timer.kept):
        margs = match_args(inp)
        want = train_match_plain(*margs)
        for n, k in k18s.items():
            got = k(*margs)
            if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                raise AssertionError(f"{n} differs from the plain version at round {r}")
        st = round_stats(inp)
        N, B = st["chars"], st["words"]
        bound_ms, bound_by = smoke._bound(4 * (N + 2 * B + 1) + 4 * (N + B) + st["table_bytes"],
                                          14 * st["probes"])
        plain_ms = smoke._time_ms(lambda: train_match_plain(*margs), 2, graph=False)
        rec = out["states"][str(r)] = dict(stats=st, bound_ms=bound_ms, bound_by=bound_by,
                                           plain_ms=plain_ms, poisoned=int(want[1].sum()),
                                           times={})
        print(f"round {r}: every variant bit for bit the plain version; {st}; bound "
              f"{bound_ms:.5f} ms ({bound_by}); plain {plain_ms:.3f} ms", flush=True)
        tensors = [i for i, a in enumerate(margs) if isinstance(a, torch.Tensor)]
        per_set = 4 * (N + B) + sum(margs[i].numel() * 4 for i in tensors)
        for rnd in range(args.reps):
            for n in (names if rnd % 2 == 0 else names[::-1]):
                k = k18s[n]
                warm = smoke._time_ms(lambda: k(*margs), 20)

                def cold_fn(*ts, k=k):
                    a = list(margs)
                    for i, t in zip(tensors, ts):
                        a[i] = t
                    return k(*a)

                sets = [tuple(margs[i].clone() for i in tensors)
                        for _ in range(-(-smoke.COLD_BYTES // per_set))]
                cold = smoke._time_cold_ms(cold_fn, sets, 20)
                del sets
                rec["times"].setdefault(n, []).append(dict(warm=warm, cold=cold))
                print(f"round {r} rep {rnd} {n}: warm {warm:.5f} ms, cold {cold:.5f}", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

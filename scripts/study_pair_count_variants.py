#!/usr/bin/env python3
"""Time designs of the WordPiece trainer's pair count K19, and its round's readback, on one NVIDIA card.

    python3 scripts/study_pair_count_variants.py [--variants NAME,...] [--size 30522]
                                                [--reps 4] [--skip-run] [--skip-walls]

Every variant is built alone, with the package's ``nvcc`` flags and ``-I``
the package's ``csrc``, all at once: ``package`` is the package's
``csrc/wordpiece_train.cu``; ``parent`` is
``scripts/pair_count_variants/parent_pair_count.cu``, the K19 the package
shipped before its redesign (three clears, a thread a word, a pass over the
whole table; its own C signature); the others are
``scripts/pair_count_variants/pair_count_variants.cu`` (the package's K19
with the designs it was measured against behind switches, see its header)
with these macros:

- ``study-defaults``: none (the study source's copy of the package);
- ``steps-2``, ``steps-4``: ``K19_STEPS``, 32-slot steps a warp (1);
- ``agg``: ``K19_AGG=1``, a block's pairs summed in shared memory first;
- ``warp-claims``: ``K19_CLAIM=0``, a global atomic a warp for the list;
- ``no-pdl``: ``K19_PDL=0``, the compaction a plain launch;
- ``walk``: ``K19_WALK=1``, a thread a word (the parent's insert) with the
  package's list and compaction;
- ``read-first``: ``K19_CAS=0``, a probe reads the row's key before its
  atomicCAS (the design first shipped);
- ``dedup``: ``K19_DEDUP=1``, a warp's lanes of one key add their sum once;
- ``fused``: ``K19_FUSED=1``, one cooperative launch with a grid barrier.

What it measures, on ``zipf_corpus(10_000, seed=17)`` and the multilingual
pieces (the WordPiece 30,522 run of ``chip_smoke.py``), its vocabulary
entry for entry ``.cache/bench_wordpiece_30k.json``:

1. Over the run: the trainer's K19 replaced by every variant in turns, each
   round (the order rotating a step a round), on the round's K18 output
   behind a ``torch.cuda._sleep`` that holds the card while the host
   enqueues, timed with CUDA events around each variant's launches and
   summed; each round's head (keys, poisoned words) equal to the package's.
   The package's result goes on to the trainer.  The inputs of rounds 0,
   1,000, 10,000 and the last are kept.
2. At those rounds: each variant bit for bit against the plain version (a
   set of (key, count)) and timed warm and cold (``chip_smoke._time_ms``,
   ``_time_cold_ms``) in turns (``--reps`` rounds, forward then backward),
   beside the library call (``torch.unique`` + ``index_add_``) and the
   bound; the pairs, keys and the atomics on the hottest key.
3. The training wall, in turns: the parent's route (its K19 and its
   readback: ``int(res[0])``, then a pageable copy of the pairs) and the
   package's (K19 and one pinned copy), parent, change, change, parent; each
   round's host time by stage from timers wrapped around the table mirror's
   update (``_MatchTables.device_buffer``), K18's and K19's launches and the
   readback (``_read_pairs``), nothing added to the package.

Prints the card's name and power limit, each build's register report, a
line per measurement, and one JSON line of every number.  Needs a card and
``nvcc``.  ``chip_smoke.py`` imports the parent's route and the round timer
from here.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import io
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "complexity_tokenizer_tpu_torch", "csrc")
VARIANT_DIR = os.path.join(REPO, "scripts", "pair_count_variants")
STUDY_SRC = os.path.join(VARIANT_DIR, "pair_count_variants.cu")
PARENT_SRC = os.path.join(VARIANT_DIR, "parent_pair_count.cu")
BUILD = os.path.join(REPO, "build", "pair_count_study")
P, I = ctypes.c_void_p, ctypes.c_int

VARIANTS = {
    "study-defaults": "",
    "steps-2": "K19_STEPS=2",
    "steps-4": "K19_STEPS=4",
    "agg": "K19_AGG=1",
    "warp-claims": "K19_CLAIM=0",
    "no-pdl": "K19_PDL=0",
    "walk": "K19_WALK=1",
    "read-first": "K19_CAS=0",
    "dedup": "K19_DEDUP=1",
    "fused": "K19_FUSED=1",
}
STATES = (0, 1000, 10_000, -1)  # -1: the last round
# the card held (about 60 us a library) while the host enqueues every library's launches
SLEEP_CYCLES_EACH = 120_000


def build(jobs: dict, build_dir: str = BUILD, kernel: str = "pair") -> dict:
    """name -> ctypes library for each (source, macros), built at once into
    ``build_dir``; prints the register report of each entry function whose
    name holds ``kernel``."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    from complexity_tokenizer_tpu_torch.utils.cuda_build import NVCC_FLAGS, _nvcc

    os.makedirs(build_dir, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name, (src, macros) in jobs.items():
        so = os.path.join(build_dir, f"{name}.so")
        flags = [f"-D{m}" for m in macros.split(",") if m]
        procs[name] = (so, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *flags, "-I", CSRC, "-shared", src, "-o", so],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, p) in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed on {jobs[name]}:\n{log}")
        entry = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line
            elif ("Used" in line or "spill" in line) and kernel in entry:
                print(f"  {name}: {entry}: {line.split(':', 1)[-1].strip()}", flush=True)
        libs[name] = ctypes.CDLL(so)
    print(f"built {len(libs)} libraries in {time.perf_counter() - t0:.1f} s", flush=True)
    return libs


class K19:
    """One library's K19: ``parent`` (its own C signature and state: keys and
    counts [2, T], res [2 + T]) or the package's signature."""

    def __init__(self, lib, parent: bool = False):
        self.lib, self.parent = lib, parent
        if parent:
            lib.ctok_pair_count.argtypes = (P, P, P, P, I, P, P, I, P, I, P)
        else:
            lib.ctok_pair_count.argtypes = (P, I, P, P, P, I, P, I, P, P, P, P)
        lib.ctok_pair_count.restype = I

    def scratch(self, n_slots: int):
        """The state one stream's calls share (made cleared)."""
        import torch

        from complexity_tokenizer_tpu_torch.ops.wordpiece_train_device import (
            PairCountScratch,
            pair_table_size,
        )

        if not self.parent:
            return PairCountScratch(n_slots, "cuda")
        T = pair_table_size(n_slots)
        return dict(t_size=T, table=torch.empty(2, T, dtype=torch.int32, device="cuda"),
                    res=torch.empty(2 + T, dtype=torch.int32, device="cuda"))

    def __call__(self, out, offs, freqs, poison, sc):
        """Launches K19; returns its result buffer ``[2 + T]``."""
        import torch

        stream = torch.cuda.current_stream().cuda_stream
        N, B = out.numel(), offs.numel() - 1
        if self.parent:
            T = sc["t_size"]
            err = self.lib.ctok_pair_count(
                out.data_ptr(), offs.data_ptr(), freqs.data_ptr(), poison.data_ptr(), B,
                sc["table"][0].data_ptr(), sc["table"][1].data_ptr(), T, sc["res"].data_ptr(),
                T // 2, stream)
            res = sc["res"]
        else:
            err = self.lib.ctok_pair_count(
                out.data_ptr(), N, offs.data_ptr(), freqs.data_ptr(), poison.data_ptr(), B,
                sc.table.data_ptr(), sc.t_size, sc.rows.data_ptr(), sc.head.data_ptr(),
                sc.res.data_ptr(), stream)
            res = sc.res
        if err:
            raise RuntimeError(f"ctok_pair_count: CUDA error {err}")
        return res


def parent_read_pairs(res, poison, gidx, n_dev: int, world: int, reader=None):
    """The parent's readback of K19's pairs at world size 1 (commit 65588a4,
    ``parallel/wordpiece_trainer.py:_read_pairs``): the head with
    ``int(res[0])``, then a pageable copy of the pairs."""
    import numpy as np
    import torch

    from complexity_tokenizer_tpu_torch.ops.wordpiece_train_device import split_pairs
    from complexity_tokenizer_tpu_torch.parallel.mesh import reduce_sum

    if world != 1:
        raise ValueError("the parent's route is timed at world size 1")
    n = int(res[0])
    keys, counts, _n, n_poison = split_pairs(res[:2 + 2 * n].cpu().numpy())
    keys, counts = keys.astype(np.int64), counts.astype(np.int64)
    if n_poison == 0:
        return keys, counts, []
    flags = torch.zeros(n_dev, dtype=torch.int32, device=poison.device)
    flags[gidx] = poison
    reduce_sum(flags)
    return keys, counts, np.flatnonzero(flags.cpu().numpy()).tolist()


@contextlib.contextmanager
def patched(module, **attrs):
    """Sets attributes of ``module`` (or a class) for the block."""
    old = {k: getattr(module, k) for k in attrs}
    for k, v in attrs.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(module, k, v)


@contextlib.contextmanager
def parent_route(k19: K19):
    """The WordPiece trainer with the parent's K19 and readback."""
    from complexity_tokenizer_tpu_torch.parallel import wordpiece_trainer as wt

    scratch = {}

    def pair_count(out, offs, freqs, poison, _scratch=None):
        sc = scratch.get(out.numel())
        if sc is None:
            sc = scratch[out.numel()] = k19.scratch(out.numel())
        return k19(out, offs, freqs, poison, sc)

    with patched(wt, pair_count=pair_count, _read_pairs=parent_read_pairs):
        yield


class RoundTimer:
    """The WordPiece trainer's K19 replaced, each round, by every library of
    ``k19s`` in turns on the round's inputs (the order rotating a step a
    round, behind a ``torch.cuda._sleep``), each timed with CUDA events and
    summed; the first library's result goes on to the trainer, and every
    library's head (keys, poisoned words) must equal it.  ``kept[r]``: the
    inputs of the rounds ``keep`` (-1: the last)."""

    def __init__(self, k19s: dict, keep=()):
        self.k19s = k19s
        self.names = list(k19s)
        self.ms = {n: 0.0 for n in self.names}
        self.keep = set(keep)
        self.kept: dict = {}
        self.rounds = 0
        self._scratch: dict = {}
        self._last = None

    def pair_count(self, out, offs, freqs, poison, _scratch=None):
        import torch

        N = out.numel()
        if N not in self._scratch:
            self._scratch[N] = {n: k.scratch(N) for n, k in self.k19s.items()}
        sc = self._scratch[N]
        r = self.rounds
        self.rounds += 1
        if r in self.keep:
            self.kept[r] = tuple(t.clone() for t in (out, offs, freqs, poison))
        if -1 in self.keep:
            self._last = (r, out, offs, freqs, poison)
        k = r % len(self.names)
        order = self.names[k:] + self.names[:k]
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(order) + 1)]
        torch.cuda._sleep(SLEEP_CYCLES_EACH * (1 + len(order)))
        ev[0].record()
        res = {}
        for i, n in enumerate(order):
            res[n] = self.k19s[n](out, offs, freqs, poison, sc[n])
            ev[i + 1].record()
        ev[-1].synchronize()
        for i, n in enumerate(order):
            self.ms[n] += ev[i].elapsed_time(ev[i + 1])
        ref = res[self.names[0]]
        heads = torch.stack([res[n][:2] for n in self.names])
        if not bool((heads == ref[:2]).all()):
            raise AssertionError(f"K19 round {r}: heads differ: "
                                 f"{dict(zip(self.names, heads.tolist()))}")
        return ref

    def finish(self):
        """Keeps the last round's inputs (a copy: the trainer has ended)."""
        if self._last is not None:
            r, *ts = self._last
            self.kept[-1] = (r,) + tuple(t.clone() for t in ts)
            self._last = None

    @contextlib.contextmanager
    def installed(self):
        from complexity_tokenizer_tpu_torch.parallel import wordpiece_trainer as wt

        with patched(wt, pair_count=self.pair_count):
            yield
        self.finish()


def wordpiece_run(size: int, stage_timers: bool = False):
    """One WordPiece training at ``size`` entries on chip_smoke.py's corpus:
    (its vocabulary entries in id order, wall s, last_stats, host s by stage
    when ``stage_timers``)."""
    import torch

    from complexity_tokenizer_tpu_torch.parallel import wordpiece_trainer as wt
    from complexity_tokenizer_tpu_torch.trainers import WordPieceTrainerConfig
    from complexity_tokenizer_tpu_torch.utils.corpus import MULTI_PIECES, zipf_corpus

    texts = zipf_corpus(10_000, seed=17) + list(MULTI_PIECES)
    stages = {"tables": 0.0, "train_match": 0.0, "pair_count": 0.0, "read_pairs": 0.0}

    def timed(name, fn):
        def run(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                stages[name] += time.perf_counter() - t0
        return run

    attrs = {}
    if stage_timers:
        attrs = dict(train_match=timed("train_match", wt.train_match),
                     pair_count=timed("pair_count", wt.pair_count),
                     _read_pairs=timed("read_pairs", wt._read_pairs))
    tables = {"device_buffer": timed("tables", wt._MatchTables.device_buffer)} if stage_timers else {}
    trainer = wt.DistributedWordPieceTrainer(WordPieceTrainerConfig(vocab_size=size))
    torch.cuda.synchronize()
    with patched(wt, **attrs), patched(wt._MatchTables, **tables), \
            contextlib.redirect_stdout(io.StringIO()):
        t0 = time.perf_counter()
        model = trainer.train_from_texts(texts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    entries = sorted(model.vocab, key=model.vocab.__getitem__)
    return entries, wall, dict(trainer.last_stats), stages


def _check_golden(entries, size: int, what: str) -> None:
    from complexity_tokenizer_tpu_torch.utils.corpus import wordpiece_30k_vocab

    golden = wordpiece_30k_vocab()
    if entries != golden[:size]:
        raise AssertionError(f"{what}: the vocabulary is not the golden file's first {size}")


def round_stats(out, offs, freqs, poison) -> dict:
    """A round's K19 work: slots, words, pairs, keys, the atomics on the
    hottest key (its pairs) and the poisoned words."""
    import torch

    import chip_smoke as smoke

    keys, _w = smoke._pair_keys(out, offs, freqs, poison)
    if keys.numel():
        _u, c = torch.unique(keys, return_counts=True)
        n_keys, hottest = int(_u.numel()), int(c.max())
    else:
        n_keys, hottest = 0, 0
    return dict(slots=out.numel(), words=offs.numel() - 1, pairs=int(keys.numel()), keys=n_keys,
                hottest_key_atomics=hottest, poisoned=int((poison != 0).sum()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=None, help="NAME,... (package and parent always)")
    ap.add_argument("--size", type=int, default=30_522, help="the WordPiece vocabulary size")
    ap.add_argument("--reps", type=int, default=4, help="rounds of turns at each state")
    ap.add_argument("--skip-run", action="store_true", help="no sum over the run")
    ap.add_argument("--skip-walls", action="store_true", help="no training walls")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("study_pair_count_variants: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as smoke
    from complexity_tokenizer_tpu_torch.ops.wordpiece_train_device import (
        pair_count_plain,
        pair_table_size,
    )

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
    k19s = {n: K19(lib, parent=n == "parent") for n, lib in libs.items()}
    names = list(k19s)
    out: dict = {"card": smi.stdout.strip(), "variants": {n: jobs[n] for n in names}}

    # 1. every round of the run, every variant in turns
    timer = RoundTimer(k19s, keep=STATES)
    if not args.skip_run:
        t0 = time.perf_counter()
        with timer.installed():
            entries, wall, st, _ = wordpiece_run(args.size)
        _check_golden(entries, args.size, "the run in turns")
        out["run_ms"] = timer.ms
        out["run_rounds"] = timer.rounds
        print(f"the run in turns: {timer.rounds} rounds in {time.perf_counter() - t0:.1f} s",
              flush=True)
        for n in names:
            print(f"K19 over the run's {timer.rounds} rounds, {n}: {timer.ms[n]:.3f} ms "
                  f"({1e3 * timer.ms[n] / timer.rounds:.2f} us a round)", flush=True)
    else:  # the states alone, from one run of the package
        timer = RoundTimer({"package": k19s["package"]}, keep=STATES)
        with timer.installed():
            entries, _wall, _st, _ = wordpiece_run(args.size)

    # 2. the states: bit for bit, warm and cold in turns, library, bound
    out["states"] = {}
    for r in sorted(timer.kept, key=lambda x: (x < 0, x)):
        if r == -1:
            r_label, *inp = timer.kept[-1]
        else:
            r_label, inp = r, list(timer.kept[r])
        o, offs, freqs, poison = inp
        N, B = o.numel(), offs.numel() - 1
        st = round_stats(o, offs, freqs, poison)
        want = smoke._sorted_pairs(pair_count_plain(o, offs, freqs, poison, pair_table_size(N)))
        for n, k in k19s.items():
            got = smoke._sorted_pairs(k(o, offs, freqs, poison, k.scratch(N)))
            if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
                    and got[2:] == want[2:]):
                raise AssertionError(f"{n} differs from the plain version at round {r_label}")
        keys, wts = smoke._pair_keys(o, offs, freqs, poison)

        def library():
            u, inv = torch.unique(keys, return_inverse=True)
            return torch.zeros(u.numel(), dtype=torch.int32, device="cuda").index_add_(0, inv, wts)

        bound_ms, bound_by = smoke._bound(4 * (N + 3 * B + 1) + 8 * st["keys"] + 8, st["pairs"])
        rec = out["states"][str(r_label)] = dict(stats=st, bound_ms=bound_ms, bound_by=bound_by,
                                                  library_ms=[], times={})
        print(f"round {r_label}: every variant bit for bit the plain version; {st}; "
              f"bound {bound_ms:.5f} ms ({bound_by})", flush=True)
        args_ = (o, offs, freqs, poison)
        t_size = pair_table_size(N)
        for rnd in range(args.reps):
            rec["library_ms"].append(smoke._time_ms(library, 5, graph=False))
            for n in (names if rnd % 2 == 0 else names[::-1]):
                k = k19s[n]
                sc = k.scratch(N)
                warm = smoke._time_ms(lambda: k(*args_, sc), 20)
                per_set = 4 * (N + 3 * B + 1) + 4 * (3 * t_size + 4)
                sets = [tuple(t.clone() for t in args_) + (k.scratch(N),)
                        for _ in range(-(-smoke.COLD_BYTES // per_set))]
                cold = smoke._time_cold_ms(lambda a, b, c, d, s: k(a, b, c, d, s), sets, 20)
                del sets
                rec["times"].setdefault(n, []).append(dict(warm=warm, cold=cold))
                print(f"round {r_label} rep {rnd} {n}: warm {warm:.5f} ms, cold {cold:.5f}",
                      flush=True)
        print(f"round {r_label} library: {min(rec['library_ms']):.5f}-"
              f"{max(rec['library_ms']):.5f} ms", flush=True)
        del keys, wts
    torch.cuda.empty_cache()

    # 3. the walls: parent, change, change, parent
    if not args.skip_walls:
        out["walls"] = []
        for label in ("parent", "change", "change", "parent"):
            route = parent_route(k19s["parent"]) if label == "parent" else contextlib.nullcontext()
            with route:
                entries, wall, st, stages = wordpiece_run(args.size, stage_timers=True)
            _check_golden(entries, args.size, f"the {label}'s route")
            rounds = st["rounds"]
            rec = dict(route=label, wall_s=wall, rounds=rounds,
                       device_ms_per_round=1e3 * st["device_s"] / rounds,
                       host_ms_per_round=1e3 * st["host_s"] / rounds,
                       stage_ms_per_round={k: 1e3 * v / rounds for k, v in stages.items()})
            out["walls"].append(rec)
            print(f"wall {label}: {wall:.3f} s, {rounds} rounds; launch and read back "
                  f"{rec['device_ms_per_round']:.4f} ms a round, host "
                  f"{rec['host_ms_per_round']:.4f}; by stage (ms a round) "
                  + ", ".join(f"{k} {v:.4f}" for k, v in rec["stage_ms_per_round"].items()),
                  flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

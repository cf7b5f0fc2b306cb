#!/usr/bin/env python3
"""Time designs of the trainers' histogram kernels K13 and K17 on one NVIDIA card.

    python3 scripts/study_hist_variants.py [--parent DIR] [--rounds 2] [--only k13|k17]
                                          [--variants NAME,...]

Every variant is built alone from a study source under
``scripts/hist_variants/`` (``pair_hist_variants.cu`` for K13,
``piece_hist_variants.cu`` for K17: the package's kernel with the designs
it was measured against behind switches), with the package's ``nvcc``
flags, ``-I`` the package's ``csrc`` and these macros, all at once:

- K17: ``package`` (no switch: the package's K17, a thread a text in
  blocks of 128, its first 16 ids loaded before the wait for the clear, a
  kernel of its own whose programmatic dependent K17 is);
  ``text-dependent`` (``K17_PREFETCH=0``: the first design's body behind
  that clear), ``prefetch-4``, ``prefetch-8``, ``threads-256``
  (``K17_THREADS``), ``prefetch-8-threads-256``; ``gidx-late`` (``K17_GIDX_LATE=1``: a
  poisoned text's place loaded after the wait, not every text's before);
  ``flags-all`` (``K17_FLAGS=1``: every text writes its flag, 0 too; the
  package writes only the poisoned texts' 1 into the cleared buffer);
  ``clear-zeros`` (``K17_CLEAR=0``: the caller's ``torch.zeros`` before
  the launch, as the first design), ``clear-memset`` (``K17_CLEAR=1``:
  ``cudaMemsetAsync`` in the entry); ``warp`` (``K17_BODY=0``: the first
  redesign, a warp 32 texts, their slots in coalesced steps of 32, a
  slot's text by a shuffle search), and with it ``warp-fused``
  (``K17_CLEAR=3``: one cooperative launch, each block clearing its share,
  a grid barrier), ``warp-aggregate`` (``K17_AGGREGATE=1``: the lanes of a
  step holding one id add with one atomic), ``warp-aggregate-dup``
  (``K17_AGGREGATE=2``: only in a step where two neighbouring lanes hold
  one id), ``warp-batch-4``, ``warp-batch-8`` (steps loaded and searched
  together; 16 in ``warp``); timed only, not checked: ``clear-only``
  (``K17_ABLATE=1``: the package's clear alone) and ``kernel-only``
  (``K17_CLEAR=0`` into a buffer allocated once: K17 with no clear);
- K13: ``package`` (no switch: the package's plan; past 241 ids the slices
  on ``blockIdx.y``, each block reading the rows of its x); ``cluster``
  (``K13_SLICED=1``: the slices over a thread block cluster's distributed
  shared memory, every block reading its own rows); ``grid-N``
  (``K13_GRID=N`` blocks, or blocks along x, in place of the plan's).

``--variants``: only these (``package`` always, and ``parent`` with
``--parent``).  ``--parent DIR``: a checkout of an earlier commit (``git archive <commit>
complexity_tokenizer_tpu_torch/csrc | tar -x -C DIR``) whose ``train.cu``
and ``unigram_train.cu`` have the same C entries (``ctok_pair_hist``,
``ctok_piece_hist``) with the buffer zeroed by the caller, as before this
design: built the same way as the variant ``parent``, and called after a
``torch.zeros`` inside the timed call.

Inputs, as ``chip_smoke.py`` makes them: K13 on the classic 50,000 route's
initial rows (``[48968,13]``, v0 = 58) and on the same rows with Zipf ids
below 260 (``utils/corpus.py:zipf_pair_rows``); K17 on K12's result of
every E-step of the Unigram 32,000 run (722,683 pieces at the first,
40,695 at the last) and on ``utils/corpus.py:piece_hist_edge_results``'s
hot id.  Every variant must equal the plain version bit for bit on them
(and K17 on every edge result).  Then ``--rounds`` rounds take the
variants in turn (forward, then backward), each warm (CUDA-graph replay on
the same buffers) and cold (``chip_smoke._time_cold_ms``), with the
library call of ``chip_smoke.py`` (``torch.zeros`` + ``index_add_``)
timed in the same rounds.  Prints each build's register report, a line per
variant and input, for K17 each variant's sum over the run's E-steps (the
least warm time of each E-step's rounds), and one JSON line of every time.
Needs a card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "complexity_tokenizer_tpu_torch", "csrc")
STUDY = os.path.join(REPO, "scripts", "hist_variants")
BUILD = os.path.join(REPO, "build", "hist_study")
P, I = ctypes.c_void_p, ctypes.c_int

# name -> macros of the study source; the macro words become -D flags
K17_VARIANTS = {
    "package": "",
    "text-dependent": "K17_PREFETCH=0",
    "prefetch-4": "K17_PREFETCH=4",
    "prefetch-8": "K17_PREFETCH=8",
    "threads-256": "K17_THREADS=256",
    "prefetch-8-threads-256": "K17_PREFETCH=8,K17_THREADS=256",
    "gidx-late": "K17_GIDX_LATE=1",
    "flags-all": "K17_FLAGS=1",
    "clear-zeros": "K17_CLEAR=0",
    "clear-memset": "K17_CLEAR=1",
    "warp": "K17_BODY=0",
    "warp-fused": "K17_BODY=0,K17_CLEAR=3",
    "warp-aggregate": "K17_BODY=0,K17_AGGREGATE=1",
    "warp-aggregate-dup": "K17_BODY=0,K17_AGGREGATE=2",
    "warp-batch-4": "K17_BODY=0,K17_BATCH=4",
    "warp-batch-8": "K17_BODY=0,K17_BATCH=8",
    "clear-only": "K17_ABLATE=1",
    "kernel-only": "K17_CLEAR=0",
}
K13_VARIANTS = {
    "package": "",
    "cluster": "K13_SLICED=1",
    "grid-16": "K13_GRID=16",
    "grid-33": "K13_GRID=33",
    "grid-66": "K13_GRID=66",
    "grid-132": "K13_GRID=132",
    "grid-264": "K13_GRID=264",
}
# the variants whose caller zeroes the buffer (the parent's contract too)
CALLER_ZEROES = ("parent", "clear-zeros")
# timed only, not checked: the package's clear alone, and K17 adding into a
# buffer allocated once (no clear: its sums grow from call to call)
TIMED_ONLY = ("clear-only", "kernel-only")


def build(jobs: dict) -> dict:
    """(kernel, name) -> ctypes library for each (source, macros), built at once."""
    from complexity_tokenizer_tpu_torch.utils.cuda_build import NVCC_FLAGS, _nvcc

    os.makedirs(BUILD, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for (kernel, name), (src, macros) in jobs.items():
        so = os.path.join(BUILD, f"{kernel}-{name}.so")
        flags = [f"-D{m}" for m in macros.split(",") if m]
        procs[(kernel, name)] = (so, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *flags, "-I", CSRC, "-shared", src, "-o", so],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (so, p) in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed on {jobs[key]}:\n{log}")
        entry = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line
            elif "Used" in line and "hist" in entry and "clear" not in entry:
                print(f"  {key[0]} {key[1]}: {entry}: {line.split(':', 1)[-1].strip()}")
        lib = ctypes.CDLL(so)
        if key[0] == "k13":
            lib.ctok_pair_hist.argtypes = (P, P, I, I, I, P, P)
            lib.ctok_pair_hist.restype = I
        else:
            lib.ctok_piece_hist.argtypes = (P, P, P, P, I, I, I, I, P, P)
            lib.ctok_piece_hist.restype = I
        libs[key] = lib
    print(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s", flush=True)
    return libs


def k13_launcher(lib, zero: bool):
    """``fn(words, freqs, v0) -> hist`` over one library; ``zero``: the
    caller zeroes the histogram (the parent's contract)."""
    import torch

    def fn(words, freqs, v0):
        N, W = words.shape
        alloc = torch.zeros if zero else torch.empty
        hist = alloc(v0 * v0, dtype=torch.int32, device=words.device)
        code = lib.ctok_pair_hist(words.data_ptr(), freqs.data_ptr(), N, W, v0, hist.data_ptr(),
                                  torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"ctok_pair_hist: CUDA error {code}")
        return hist
    return fn


def k17_launcher(lib, zero: bool, reuse: bool = False):
    """``fn(res, offs, freqs, gidx, V, n_global) -> buf`` over one library;
    ``reuse``: into one buffer for every call (allocated at the first)."""
    import torch

    kept = {}

    def fn(res, offs, freqs, gidx, V, n_global):
        B = offs.numel() - 1
        alloc = torch.zeros if zero else torch.empty
        if reuse:
            if kept.get("n") != V + n_global:
                kept.update(n=V + n_global, buf=alloc(V + n_global, dtype=torch.int32,
                                                      device=res.device))
            buf = kept["buf"]
        else:
            buf = alloc(V + n_global, dtype=torch.int32, device=res.device)
        code = lib.ctok_piece_hist(res.data_ptr(), offs.data_ptr(), freqs.data_ptr(),
                                   gidx.data_ptr(), B, res.numel() - 2 * B, V, n_global,
                                   buf.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"ctok_piece_hist: CUDA error {code}")
        return buf
    return fn


def k13_inputs() -> list[tuple]:
    """(label, words, freqs, v0, library fn) on the card."""
    import torch

    from chip_smoke import TRAIN_ROUTES, _train_inputs
    from complexity_tokenizer_tpu_torch.utils.corpus import zipf_corpus, zipf_pair_rows

    texts = zipf_corpus(8000, seed=29, lo=100, hi=800)
    words0, freqs, _vocab, v0 = _train_inputs(texts, TRAIN_ROUTES[0][1])
    out = []
    for v, words in ((v0, words0),
                     (260, torch.from_numpy(zipf_pair_rows(words0.cpu().numpy(), 260,
                                                           seed=260)).cuda())):
        left, right = words[:, :-1].long(), words[:, 1:].long()
        valid = (left >= 0) & (right >= 0)
        key = (left * v + right)[valid]
        fval = freqs[:, None].expand_as(left)[valid]

        def library(key=key, fval=fval, v=v):
            return torch.zeros(v * v, dtype=torch.int32, device="cuda").index_add_(0, key, fval)
        N, W = words.shape
        out.append((f"[{N},{W}] v0={v}", words, freqs, v, library))
    return out


def k17_inputs() -> list[tuple]:
    """(label, (res, offs, freqs, gidx), V, n_global, library fn, timed) on
    the card: every E-step of the Unigram 32,000 run, then the edge results
    (the hot id timed)."""
    import contextlib
    import io

    import torch

    from complexity_tokenizer_tpu_torch.ops.unigram_device import viterbi
    from complexity_tokenizer_tpu_torch.parallel.unigram_trainer import DistributedUnigramTrainer
    from complexity_tokenizer_tpu_torch.trainers import UnigramTrainerConfig
    from complexity_tokenizer_tpu_torch.utils.corpus import (
        MULTI_PIECES,
        piece_hist_edge_results,
        zipf_corpus,
    )

    texts = zipf_corpus(10_000, seed=17) + list(MULTI_PIECES)
    words = [w for t in texts for w in t.split()]
    kept = {}
    trainer = DistributedUnigramTrainer(UnigramTrainerConfig(vocab_size=31_997))
    trainer.capture = kept.__setitem__
    with contextlib.redirect_stdout(io.StringIO()):
        trainer.train_from_texts(words)
    out = []

    def library_of(res, offs, freqs, V):
        B = offs.numel() - 1
        N = res.numel() - 2 * B
        word = torch.repeat_interleave(torch.arange(B, device="cuda"), (offs[1:] - offs[:-1]).long())
        ids = res[:N]
        ok = (ids >= 0) & (res[N + B:][word] == 0)
        lib_ids, lib_f = ids[ok].long(), freqs[word[ok]]
        return lambda: torch.zeros(V, dtype=torch.int32, device="cuda").index_add_(0, lib_ids, lib_f)

    for r, inp in sorted(kept.items()):
        res = viterbi(*inp["viterbi"])
        offs, freqs, gidx, V, n_global = inp["piece_hist"]
        out.append((f"E-step {r} (V {V}, {offs.numel() - 1} texts, {res.numel()} res)",
                    (res, offs, freqs, gidx), V, n_global, library_of(res, offs, freqs, V), True))
    for i, (label, *arrays, Ve, ne) in enumerate(piece_hist_edge_results()):
        args = tuple(torch.from_numpy(a).cuda() for a in arrays)
        out.append((f"edge: {label}", args, Ve, ne, library_of(args[0], args[1], args[2], Ve),
                    i == 0))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=None, help="an earlier checkout's directory")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--only", choices=("k13", "k17"), default=None)
    ap.add_argument("--variants", default=None, help="NAME,... (package always)")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("study_hist_variants: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from chip_smoke import _cold_sets, _time_cold_ms, _time_ms
    from complexity_tokenizer_tpu_torch.ops.trainer_device import pair_hist_plain
    from complexity_tokenizer_tpu_torch.ops.unigram_device import piece_hist_plain

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())
    kinds = [args.only] if args.only else ["k13", "k17"]
    jobs = {}
    for kind, study, src, variants in (
            ("k13", "pair_hist_variants.cu", "train.cu", K13_VARIANTS),
            ("k17", "piece_hist_variants.cu", "unigram_train.cu", K17_VARIANTS)):
        if kind not in kinds:
            continue
        keep = None if args.variants is None else {"package", *args.variants.split(",")}
        for name, macros in variants.items():
            if keep is None or name in keep:
                jobs[(kind, name)] = (os.path.join(STUDY, study), macros)
        if args.parent:
            jobs[(kind, "parent")] = (os.path.join(
                os.path.abspath(args.parent), "complexity_tokenizer_tpu_torch", "csrc", src), "")
    libs = build(jobs)
    times: dict = {}
    print(f"library: torch.zeros + index_add_ (chip_smoke.py's yardstick)", flush=True)

    def in_turns(kind, cases, fns, call, cold_args, out_bytes):
        names = list(fns) + ["library"]
        for rnd in range(args.rounds):
            order = names if rnd % 2 == 0 else names[::-1]
            for case in cases:
                label = case[0]
                if not case[-1]:
                    continue
                for name in order:
                    fn = case[-2] if name == "library" else call(fns[name], case)
                    ms = _time_ms(fn, 50)
                    ms_cold = None
                    if name != "library":
                        sets = _cold_sets(cold_args(case), out_bytes(case))
                        ms_cold = _time_cold_ms(call(fns[name], case, cold=True), sets, 50)
                        del sets
                    times.setdefault(kind, {}).setdefault(label, {}).setdefault(name, []).append(
                        [ms, ms_cold])
                    cold = f", cold {ms_cold:.5f} ms" if ms_cold is not None else ""
                    print(f"round {rnd} {kind} {label} {name}: warm {ms:.5f} ms{cold}", flush=True)

    if "k13" in kinds:
        fns = {name: k13_launcher(lib, name in CALLER_ZEROES)
               for (kind, name), lib in libs.items() if kind == "k13"}
        cases = [c + (True,) for c in k13_inputs()]
        for label, words, freqs, v0, _lib, _t in cases:
            exp = pair_hist_plain(words, freqs, v0)
            for name, fn in fns.items():
                got = fn(words, freqs, v0)
                torch.cuda.synchronize()
                if not torch.equal(got, exp):
                    raise AssertionError(f"k13 {name} differs from the plain version on {label}")
            print(f"k13 {label}: every variant bit for bit the plain version", flush=True)

        def call13(fn, case, cold=False):
            _label, words, freqs, v0, _lib, _t = case
            if cold:
                return lambda w, f: fn(w, f, v0)
            return lambda: fn(words, freqs, v0)

        in_turns("k13", cases, fns, call13, lambda c: (c[1], c[2]), lambda c: 4 * c[3] * c[3])
    if "k17" in kinds:
        fns = {name: k17_launcher(lib, name in CALLER_ZEROES, reuse=name == "kernel-only")
               for (kind, name), lib in libs.items() if kind == "k17"}
        cases = k17_inputs()
        for label, arrays, V, n_global, _lib, _t in cases:
            exp = piece_hist_plain(*arrays, V, n_global)
            for name, fn in fns.items():
                if name in TIMED_ONLY:
                    continue
                got = fn(*arrays, V, n_global)
                torch.cuda.synchronize()
                if not torch.equal(got, exp):
                    raise AssertionError(f"k17 {name} differs from the plain version on {label}")
            print(f"k17 {label}: every variant but {', '.join(TIMED_ONLY)} bit for bit the "
                  "plain version", flush=True)

        def call17(fn, case, cold=False):
            _label, arrays, V, n_global, _lib, _t = case
            if cold:
                return lambda r, o, f, g: fn(r, o, f, g, V, n_global)
            return lambda: fn(*arrays, V, n_global)

        in_turns("k17", cases, fns, call17, lambda c: c[1], lambda c: 4 * (c[2] + c[3]))
        # each variant's K17 time over the run: the least warm time of each
        # E-step's rounds, summed over the E-steps
        steps = [label for label in times["k17"] if label.startswith("E-step")]
        for name in list(fns) + ["library"]:
            total = sum(min(t[0] for t in times["k17"][label][name]) for label in steps)
            print(f"k17 the run's {len(steps)} E-steps, {name}: {total:.5f} ms", flush=True)
    print(json.dumps({"card": smi.stdout.strip(), "times_ms_warm_cold": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Time designs of the BPE trainers' merge step K14 and histogram update K16 on one NVIDIA card.

    python3 scripts/study_merge_variants.py [--parent DIR] [--variants NAME,...] [--rounds 2]
                                           [--chunk 100] [--skip-run] [--skip-blocks]

Every variant is built alone, with the package's ``nvcc`` flags and ``-I``
the package's ``csrc``, all at once: ``package`` is the package's
``csrc/train.cu``; the others are ``scripts/train_variants/merge_step_variants.cu``
(the package's K14, K15 and K16 with the designs they were measured
against behind switches, see its header) with these macros:

- ``study-defaults``: none (the study source's copy of the package's
  design: what the two builds and the order of the turns differ by);
- ``threads-64``, ``threads-256``: ``K14_THREADS`` (the package 128);
- ``rows-32``, ``rows-8``: ``K14_ROWS``, a warp 32 or 8 rows (16);
- ``batch-2``, ``batch-4``, ``batch-16``: ``K14_BATCH``, loads in flight a
  lane (8); ``rows-32-batch-4``: both;
- ``no-tile``: ``K14_TILE=0``, the walk from the lines the scan brought
  into L1, not from the rows' copy in shared memory; ``tile-early``:
  ``K14_PDL=2``, the copy loaded before K14 waits for K15;
- ``k14-behind-k15``: ``K14_PDL=1``, K14 the programmatic dependent of
  K15 on the device-resident steps (the package launches it plainly on
  both routes); ``k14-dependent``: ``K14_PDL=3``, the dependent launch on
  the per-merge route too; ``k16-plain``: ``K16_PDL=0``, K16 a plain
  launch (the package: K14's programmatic dependent);
- ``clear-kernel``: ``K14_CLEAR=1``, one buffer, cleared before each merge
  by a kernel of its own that K14 overlaps; ``clear-wait``:
  ``K14_CLEAR=2``, K14 waiting for that clear before it reads;
- ``caller-zero`` (the package's library): one buffer, zeroed by the
  caller's ``Tensor.zero_`` before K14, the parent's route;
- ``package-again`` (the package's library, last in the turns): what the
  order of the turns gives the first.

The package's route keeps two buffers that take turns (K14 adds into the
one the merge before zeroed and zeroes the other).  ``--parent DIR``: a
checkout of an earlier commit (``git archive <commit>
complexity_tokenizer_tpu_torch/csrc | tar -x -C DIR``) whose ``train.cu``
has the first K14 (a thread a row) and a ``ctok_merge_step`` taking no
buffer to zero (the caller zeroes one), built the same way as ``parent``.

What it measures, each variant in turns with the others (forward, then
backward), bit for bit against the package at every step:

1. K14 at merges 0, 1,000, 10,000 and 40,000 of the classic 50,000
   training (the rows after that many of the golden file's merges, each
   merge by the package's K14; the plain version checked at each state):
   warm and cold (``chip_smoke._time_reset_ms``, ``separate``: the rows
   restored before each launch, each launch behind a memset), with its
   route's zeroing and alone, and the
   state's changed slots, delta entries, atomics, the most atomics into one
   entry and the rows holding both tokens.
2. K14 summed over every launch of that run: the 49,942 golden merges in
   CUDA graphs of ``--chunk`` merges (each merge as the variant's route
   launches it, its zeroing included, behind a 4-byte memset: the route
   reads each merge back before the next, so no K14 runs behind another),
   each graph replayed once to warm and twice timed on the restored rows
   (the less time counts), less a graph of the memsets alone; the variants' rows and last merge's buffer must
   equal the package's after every chunk.
3. Every block of the classic 4,096 route (32 steps, K15 -> K14 -> K16)
   and every window of the INL 4,096 route, their inputs from a replay of
   each route with the package's kernels (``chip_smoke.classic_blocks``,
   ``chip_smoke.inl_windows``; their merges must be the golden files'
   prefixes), each captured as a CUDA graph and timed the same way (the
   less of two replays); every output (rows, histogram, merge log, deltas,
   cursor) equal to the package's.

Prints the card's name and power limit, each build's register report, a
line per measurement, and one JSON line of every time.  Needs a card and
``nvcc``.
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
STUDY_SRC = os.path.join(REPO, "scripts", "train_variants", "merge_step_variants.cu")
BUILD = os.path.join(REPO, "build", "merge_study")
P, I = ctypes.c_void_p, ctypes.c_int

# name -> (macros of the study source, how the per-merge route zeroes a
# merge's buffer: "turns" two buffers, K14 zeroing the other; "own" one
# buffer, cleared by the library's K14 entry first; "caller" one buffer,
# zeroed by Tensor.zero_; "old" as "caller", the parent's C signature)
VARIANTS = {
    "study-defaults": ("", "turns"),
    "threads-64": ("K14_THREADS=64", "turns"),
    "threads-256": ("K14_THREADS=256", "turns"),
    "rows-32": ("K14_ROWS=32", "turns"),
    "rows-8": ("K14_ROWS=8", "turns"),
    "batch-2": ("K14_BATCH=2", "turns"),
    "batch-4": ("K14_BATCH=4", "turns"),
    "rows-32-batch-4": ("K14_ROWS=32,K14_BATCH=4", "turns"),
    "batch-16": ("K14_BATCH=16", "turns"),
    "no-tile": ("K14_TILE=0", "turns"),
    "tile-early": ("K14_PDL=2", "turns"),
    "k14-behind-k15": ("K14_PDL=1", "turns"),
    "k14-dependent": ("K14_PDL=3", "turns"),
    "k16-plain": ("K16_PDL=0", "turns"),
    "clear-kernel": ("K14_CLEAR=1", "own"),
    "clear-wait": ("K14_CLEAR=2", "own"),
}
STATES = (0, 1000, 10_000, 40_000)


def build(jobs: dict) -> dict:
    """name -> ctypes library for each (source, macros), built at once."""
    from complexity_tokenizer_tpu_torch.utils.cuda_build import NVCC_FLAGS, _nvcc

    os.makedirs(BUILD, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name, (src, macros) in jobs.items():
        so = os.path.join(BUILD, f"{name}.so")
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
            elif "Used" in line and ("merge" in entry or "hist_update" in entry):
                print(f"  {name}: {entry}: {line.split(':', 1)[-1].strip()}")
        libs[name] = ctypes.CDLL(so)
    print(f"built {len(libs)} libraries in {time.perf_counter() - t0:.1f} s", flush=True)
    return libs


class Kernels:
    """K14, K15 and K16 of one library; ``mode``: how its per-merge route
    zeroes a merge's buffer (see ``VARIANTS``)."""

    def __init__(self, lib, mode: str):
        self.lib, self.mode = lib, mode
        merge_args = (P, P, I, I, P, P, I, I, I, I, P, I, P)
        if mode != "old":
            merge_args += (P, ctypes.c_longlong)
        lib.ctok_merge_step.argtypes = merge_args + (P,)
        lib.ctok_select_argmax.argtypes = (P, I, P, I, P, P, P)
        lib.ctok_select_window.argtypes = (P, I, P, P, I, I, P, I, P, P, P)
        lib.ctok_hist_update.argtypes = (P, I, I, P, P, I, P, P)
        for f in ("ctok_merge_step", "ctok_select_argmax", "ctok_select_window",
                  "ctok_hist_update"):
            getattr(lib, f).restype = I

    @staticmethod
    def _ok(code, what):
        if code:
            raise RuntimeError(f"{what}: CUDA error {code}")

    def merge(self, words, freqs, new_id, delta, minted, a=0, b=0, log=None, step=0, zero=None):
        """One K14 launch (``zero``: the buffer the entry zeroes)."""
        import torch

        stream = torch.cuda.current_stream().cuda_stream
        ma_p, mb_p = (0, 0) if log is None else (log[0].data_ptr(), log[1].data_ptr())
        N, W = words.shape
        args = [words.data_ptr(), freqs.data_ptr(), N, W, ma_p, mb_p, step, int(a), int(b), new_id,
                delta.data_ptr(), delta.shape[0], minted.data_ptr()]
        if self.mode != "old":
            args += [0, 0] if zero is None else [zero.data_ptr(), zero.numel()]
        elif zero is not None:
            raise ValueError("the parent's K14 zeroes nothing")
        self._ok(self.lib.ctok_merge_step(*args, stream), "ctok_merge_step")

    def slot(self, i: int) -> int:
        """The buffer of bufs [2, n] that merge i of the route adds into."""
        return i % 2 if self.mode == "turns" else 0

    def route_merge(self, words, freqs, new_id, a, b, bufs, i):
        """Merge i of the per-merge route, as the route launches it: its
        [minted | delta] in bufs[self.slot(i)][:1 + 4 * (new_id + 1)]."""
        n = 1 + 4 * (new_id + 1)
        cur = bufs[self.slot(i)]
        zero = None
        if self.mode == "turns":
            zero = bufs[1 - self.slot(i)][:n]
        elif self.mode == "own":
            zero = cur[:n]
        else:
            cur[:n].zero_()
        self.merge(words, freqs, new_id, cur[1:n].view(new_id + 1, 4), cur[:1], a, b, zero=zero)

    def steps(self, n_do, v0b, words, freqs, hist, log, deltas, cand, scratch):
        """``parallel/trainer.py:run_steps`` at world size 1 on this library."""
        import torch

        stream = torch.cuda.current_stream().cuda_stream
        V = hist.shape[0]
        ma, mb, mf = log[0], log[1], log[2]
        for i in range(n_do):
            if cand is None:
                self._ok(self.lib.ctok_select_argmax(hist.data_ptr(), V, scratch.data_ptr(), i,
                                                     ma.data_ptr(), mb.data_ptr(), stream), "K15")
            else:
                ca, cb, n_cand, state = cand
                self._ok(self.lib.ctok_select_window(
                    hist.data_ptr(), V, ca.data_ptr(), cb.data_ptr(), ca.shape[0], n_cand,
                    state.data_ptr(), i, ma.data_ptr(), mb.data_ptr(), stream), "K15")
            self.merge(words, freqs, v0b + i, deltas[i], mf[i:i + 1], log=(ma, mb), step=i)
            self._ok(self.lib.ctok_hist_update(hist.data_ptr(), V, i, ma.data_ptr(), mb.data_ptr(),
                                               v0b + i, deltas[i].data_ptr(), stream), "K16")


def golden_ids(vocab: dict, v0: int, merges: list) -> list[tuple[int, int]]:
    """The golden merges as (a, b) ids, new ids from v0 on."""
    inv = {i: t for t, i in vocab.items()}
    tid = dict(vocab)
    out = []
    for i, (x, y) in enumerate(merges):
        out.append((tid[x], tid[y]))
        tid[x + y] = v0 + i
        inv[v0 + i] = x + y
    return out


def merge_stats(words, freqs, a: int, b: int, new_id: int, V: int) -> dict:
    """What one merge (a, b) does on the rows: taken occurrences, changed
    slots, the atomics K14 adds (two for each side with a neighbour), the
    delta entries they touch and the most into one entry, and the rows (and
    32-row warps) that hold both tokens."""
    import torch

    N, W = words.shape
    alive = words >= 0
    rows, cols = torch.nonzero(alive, as_tuple=True)
    rank = (alive.cumsum(1) - 1)[rows, cols]
    na = alive.sum(1)[:, None]
    c = torch.full((N, W + 3), -1, dtype=torch.int64, device=words.device)
    c[rows, rank] = words[rows, cols].long()
    j = torch.arange(W, device=words.device)[None, :]
    m = (j + 1 < na) & (c[:, :W] == a) & (c[:, 1:W + 1] == b)
    last_non = torch.where(m, -1, j.expand(N, W)).cummax(1).values
    sel = m & ((j - last_non) % 2 == 1)
    nxt2 = torch.zeros_like(sel)
    nxt2[:, :-2] = sel[:, 2:]
    prv2 = torch.zeros_like(sel)
    prv2[:, 2:] = sel[:, :-2]
    left = sel & (j >= 1)
    right = sel & (j + 2 < na) & ~nxt2
    x = torch.cat([torch.full((N, 1), -1, dtype=torch.int64, device=words.device), c[:, :W - 1]], 1)
    y = c[:, 2:W + 2]
    keys = []
    for kind, mask, idx in ((0, left, x), (1, right, y), (2, left, torch.where(prv2, new_id, x)),
                            (3, right, y)):
        mask = mask & (idx < V)
        keys.append(idx[mask] * 4 + kind)
    keys = torch.cat(keys)
    uniq, counts = torch.unique(keys, return_counts=True)
    holds = ((words == a).any(1) & (words == b).any(1))
    warps = int(holds[: (N // 32) * 32].view(-1, 32).any(1).sum()) + int(holds[(N // 32) * 32:].any())
    return dict(occurrences=int(sel.sum()), changed_slots=2 * int(sel.sum()),
                atomics=int(keys.numel()), delta_entries=int(uniq.numel()),
                most_into_one_entry=int(counts.max()) if counts.numel() else 0,
                rows_holding_pair=int(holds.sum()), warps_holding_pair=warps)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=None, help="an earlier checkout's directory")
    ap.add_argument("--variants", default=None, help="NAME,... (package always)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--chunk", type=int, default=100, help="merges a graph in the run's sum")
    ap.add_argument("--skip-run", action="store_true", help="no sum over the run")
    ap.add_argument("--skip-blocks", action="store_true", help="no blocks and windows")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("study_merge_variants: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as smoke
    from complexity_tokenizer_tpu_torch.ops.trainer_device import merge_step_plain, pair_hist
    from complexity_tokenizer_tpu_torch.utils.corpus import zipf_corpus

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    keep = None if args.variants is None else set(args.variants.split(","))
    if args.chunk % 2:
        raise ValueError("--chunk must be even (the two buffers' turns restart with each graph)")
    jobs = {"package": (os.path.join(CSRC, "train.cu"), "")}
    modes = {"package": "turns"}
    for name, (macros, mode) in VARIANTS.items():
        if keep is None or name in keep:
            jobs[name] = (STUDY_SRC, macros)
            modes[name] = mode
    if args.parent:
        jobs["parent"] = (os.path.join(os.path.abspath(args.parent), "complexity_tokenizer_tpu_torch",
                                       "csrc", "train.cu"), "")
        modes["parent"] = "old"
    libs = build(jobs)
    ks = {name: Kernels(lib, modes[name]) for name, lib in libs.items()}
    for name, mode in (("caller-zero", "caller"), ("package-again", "turns")):
        if keep is None or name in keep:
            ks[name] = Kernels(libs["package"], mode)
    names = list(ks)
    out: dict = {"card": smi.stdout.strip(),
                 "variants": {n: [jobs.get(n, ("", "the package's library"))[1], ks[n].mode]
                              for n in names}}

    texts = zipf_corpus(8000, seed=29, lo=100, hi=800)
    words0, freqs, vocab, v0 = smoke._train_inputs(texts, smoke.TRAIN_ROUTES[0][1])
    with open(smoke.TOKENIZER_JSON, "rb") as f:
        gm = [tuple(m.split(" ")) for m in json.loads(f.read())["model"]["merges"]]
    pairs = golden_ids(vocab, v0, gm)
    N, W = words0.shape
    V = 50_000  # the per-merge route's delta rows
    print(f"classic 50,000: rows [{N},{W}], v0 {v0}, {len(pairs)} merges", flush=True)

    # 1-2. every merge of the run in chunks; the states on the way
    state_rows = {}
    run_ms = {n: 0.0 for n in names}
    chunk_ms: dict = {n: [] for n in names}
    rows = words0.clone()
    work = {n: words0.clone() for n in names}
    bufs = {n: torch.zeros(2, 1 + 4 * V, dtype=torch.int32, device="cuda") for n in names}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    sep = torch.zeros(1, dtype=torch.int32, device="cuda")

    def timed_replay(g, restore=None) -> float:
        """The less of two timed replays of g (each after restore())."""
        ms = float("inf")
        for _ in range(2):
            if restore is not None:
                restore()
            torch.cuda.synchronize()
            start.record()
            g.replay()
            end.record()
            torch.cuda.synchronize()
            ms = min(ms, start.elapsed_time(end))
        return ms

    t0 = time.perf_counter()
    last = len(pairs) if not args.skip_run else max(STATES)
    for c0 in range(0, last, args.chunk):
        c1 = min(c0 + args.chunk, last)
        if c0 in STATES:
            state_rows[c0] = rows.clone()
        if args.skip_run:  # reach the states with the package alone, untimed
            k = ks["package"]
            for i in range(c0, c1):
                k.route_merge(rows, freqs, v0 + i, *pairs[i], bufs["package"], i)
            continue
        # each merge behind a 4-byte memset, as the route launches it behind
        # the merge before's read back, less a graph of the memsets alone
        g0 = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g0):
            for i in range(c0, c1):
                sep.zero_()
        g0.replay()
        ms0 = timed_replay(g0)
        del g0
        order = names if (c0 // args.chunk) % 2 == 0 else names[::-1]
        for n in order:
            k, w, buf = ks[n], work[n], bufs[n]
            w.copy_(rows)
            torch.cuda.synchronize()
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                for i in range(c0, c1):
                    sep.zero_()
                    k.route_merge(w, freqs, v0 + i, *pairs[i], buf, i)
            g.replay()
            ms = timed_replay(g, lambda w=w: w.copy_(rows)) - ms0
            run_ms[n] += ms
            chunk_ms[n].append(ms)
            del g
        ref_w, ref_b = work["package"], bufs["package"][ks["package"].slot(c1 - 1)]
        n_live = 1 + 4 * (v0 + c1)
        for n in names:
            b_n = bufs[n][ks[n].slot(c1 - 1)]
            if not torch.equal(work[n], ref_w) or not torch.equal(b_n[:n_live], ref_b[:n_live]):
                raise AssertionError(f"{n} differs from the package after merge {c1}")
        rows.copy_(ref_w)
    print(f"run replay ({last} merges) in {time.perf_counter() - t0:.1f} s", flush=True)
    if not args.skip_run:
        for n in names:
            print(f"K14 over the run's {last} merges (as its route launches them), {n}: "
                  f"{run_ms[n]:.4f} ms", flush=True)
        out["run_ms"] = run_ms
        out["chunk_ms"] = chunk_ms

    # the states: each variant's single merge checked against the plain version
    out["states"] = {}
    for s, w_s in sorted(state_rows.items()):
        a, b = pairs[s]
        new = v0 + s
        want_w = w_s.clone()
        want_d = torch.zeros(V, 4, dtype=torch.int32, device="cuda")
        want_m = torch.zeros(1, dtype=torch.int32, device="cuda")
        merge_step_plain(want_w, freqs, new, want_d, want_m, a=a, b=b)
        new_rows = 1 + 4 * (new + 1)
        for n in names:
            k = ks[n]
            w = w_s.clone()
            tb = torch.zeros(2, new_rows, dtype=torch.int32, device="cuda")
            tb[1 if k.mode == "turns" else 0].fill_(9)  # the buffer the route zeroes is stale
            k.route_merge(w, freqs, new, a, b, tb, 0)
            torch.cuda.synchronize()
            if (not torch.equal(w, want_w) or not torch.equal(tb[0, 1:], want_d.view(-1)[:new_rows - 1])
                    or int(tb[0, 0]) != int(want_m) or (k.mode == "turns" and tb[1].any())):
                raise AssertionError(f"{n} differs from the plain version at merge {s}")
        st = merge_stats(w_s, freqs, a, b, new, V)
        # as chip_smoke.py counts it: the rows, the frequencies of the rows
        # holding both tokens, the changed slots, touched entries and
        # count, the other buffer zeroed
        bound_ms, bound_by = smoke._bound(4 * N * W + 4 * st["rows_holding_pair"]
                                          + 4 * st["changed_slots"] + 4 * st["delta_entries"] + 4
                                          + 4 * new_rows, N * W)
        st.update(bound_ms=bound_ms, bound_by=bound_by)
        print(f"merge {s} {gm[s]}: every variant bit for bit the plain version; {st}", flush=True)
        rec = out["states"].setdefault(str(s), dict(stats=st, times={}))
        n_cold = -(-smoke.COLD_BYTES // (8 * N * W)) + 1
        for rnd in range(args.rounds):
            for n in (names if rnd % 2 == 0 else names[::-1]):
                k = ks[n]
                t = {}
                tb = torch.zeros(2, new_rows, dtype=torch.int32, device="cuda")
                for key, n_sets in (("warm", 10), ("cold", n_cold)):
                    copies = [(w_s, w_s.clone()) for _ in range(n_sets)]
                    t[key] = smoke._time_reset_ms(
                        [lambda s_=s_, x=x: x.copy_(s_) for s_, x in copies],
                        [lambda x=x: k.route_merge(x, freqs, new, a, b, tb, 0) for _s, x in copies],
                        separate=True)
                    if key == "warm":  # K14 alone: zeroing nothing (the rows restored as above)
                        t["warm_alone"] = smoke._time_reset_ms(
                            [lambda s_=s_, x=x: x.copy_(s_) for s_, x in copies],
                            [lambda x=x: k.merge(x, freqs, new, tb[0, 1:].view(new + 1, 4),
                                                 tb[0, :1], a, b) for _s, x in copies],
                            separate=True)
                    del copies
                rec["times"].setdefault(n, []).append(t)
                print(f"round {rnd} merge {s} {n}: warm {t['warm']:.5f} ms, cold {t['cold']:.5f}, "
                      f"K14 alone warm {t['warm_alone']:.5f}", flush=True)

    # 3. the blocks of the classic 4,096 route and the windows of INL 4,096
    if not args.skip_blocks:
        out["blocks"] = {}
        with open(smoke.INL_32K, "rb") as f:
            gm_inl = [tuple(m.split(" ")) for m in json.loads(f.read())["model"]["merges"]]
        for label in ("classic 4,096", "INL 4,096"):
            if label == "classic 4,096":
                hist0 = torch.zeros(4096, 4096, dtype=torch.int32, device="cuda")
                hist0[:v0, :v0] = pair_hist(words0, freqs, v0).view(v0, v0)
                ids, kept = smoke.classic_blocks(words0.clone(), freqs, hist0, v0, 4096 - v0)
                merged = [tuple(p) for p in ids] == pairs[: len(ids)]
                n_merges = len(ids)
                del hist0
            else:
                tr, kept = smoke.inl_windows(texts, dict(vocab_size=4096, min_frequency=2))
                merged = tr.merges == gm_inl[: len(tr.merges)]
                n_merges = len(tr.merges)
                del tr
            if not merged:
                raise AssertionError(f"{label}: the replay's merges are not the golden file's")
            kept = [kept[i] for i in sorted(kept)]
            Vb = kept[0]["hist"].shape[0]
            kmax = max(x["n_do"] for x in kept)
            print(f"{label}: {len(kept)} blocks, {sum(x['n_do'] for x in kept)} steps, "
                  f"{n_merges} merges", flush=True)
            wk = {}
            for n in names:
                wk[n] = dict(words=kept[0]["words"].clone(), hist=kept[0]["hist"].clone(),
                             log=torch.zeros(3, kmax, dtype=torch.int32, device="cuda"),
                             deltas=torch.zeros(kmax, Vb, 4, dtype=torch.int32, device="cuda"),
                             scratch=torch.zeros(2, dtype=torch.int64, device="cuda"),
                             state=torch.zeros(2, dtype=torch.int32, device="cuda"))
            times = {n: [] for n in names}
            for bi, blk in enumerate(kept):
                def reset(b_):
                    b_["words"].copy_(blk["words"])
                    b_["hist"].copy_(blk["hist"])
                    b_["log"].zero_()
                    b_["deltas"].zero_()
                    if blk["cand"] is not None:
                        b_["state"].copy_(blk["cand"][3])

                for n in (names if bi % 2 == 0 else names[::-1]):
                    k, b_ = ks[n], wk[n]
                    cand = None if blk["cand"] is None else (blk["cand"][0], blk["cand"][1],
                                                             blk["cand"][2], b_["state"])
                    reset(b_)
                    torch.cuda.synchronize()
                    g = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(g):
                        k.steps(blk["n_do"], blk["v0b"], b_["words"], blk["freqs"], b_["hist"],
                                b_["log"], b_["deltas"], cand, b_["scratch"])
                    g.replay()
                    times[n].append(timed_replay(g, lambda b_=b_: reset(b_)))
                    del g
                ref = wk["package"]
                for n in names:
                    for key in ("words", "hist", "log", "deltas", "state"):
                        if not torch.equal(wk[n][key], ref[key]):
                            raise AssertionError(f"{label} block {bi}: {n} differs in {key}")
                whole = bool((ref["log"][0][:blk["n_do"]] >= 0).all())
                if whole and bi + 1 < len(kept) and kept[bi + 1]["v0b"] == blk["v0b"] + blk["n_do"]:
                    nxt = kept[bi + 1]
                    if not (torch.equal(ref["words"], nxt["words"]) and torch.equal(ref["hist"], nxt["hist"])):
                        raise AssertionError(f"{label} block {bi}: not the trainer's next block's input")
            rec = out["blocks"][label] = dict(blocks=len(kept),
                                              steps=sum(x["n_do"] for x in kept), ms=times)
            for n in names:
                ts = times[n]
                print(f"{label} {n}: first block {ts[0]:.4f} ms, sum over {len(ts)} blocks "
                      f"{sum(ts):.4f} ms", flush=True)
            rec["sum_ms"] = {n: sum(times[n]) for n in names}
            del kept, wk
            torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

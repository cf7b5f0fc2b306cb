#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 17] [--texts 10000]

Phases (each prints its seconds):

1. device: a CUDA card must be present; prints its name, the device count
   and ``nvidia-smi``'s name and power limit.
2. build: compiles the kernels of ``complexity_tokenizer_tpu_torch/csrc``
   with ``nvcc`` and prints the build's seconds and ``-Xptxas -v`` report.
3. main path: ``Tokenizer.encode_batch(texts, backend="device")`` at the
   50K vocabulary over the Zipf corpus (plus multilingual pieces, a text
   over 4,096 bytes and texts holding ``</s>``), compared with the host
   oracle on every text; the kernels' launch counts are set to 0 just
   before and read just after, and must both be above 0.  The first
   ``[B, L]`` batch of every shape the run launched is kept.
4. kernels: each kernel against its plain PyTorch version on the card, bit
   for bit, on the kept main-path batch of every shape; K1 also on random
   bytes (some OOV table entries) at ``[8192, 512]`` and ``[16, 4096]``
   and on edge shapes (``seed_edge_batches``), and is timed warm, cold
   (``_time_cold_ms``: no call finds its own lines in L2) and at
   ``[1, 16]`` (its launch floor);
   K2 also on ``[16, 4096]`` rows filled with corpus text, on the rows
   that separate its greedy apply from the JAX rule (``run_rows``) at
   ``[16, 1024]`` and ``[4, 4096]``, with and without OOV bytes inside
   the runs, and on one 4,096-byte word of one letter.  Kernels and the
   library expression are timed by replaying a CUDA graph, K2's plain
   version with CUDA events around its calls (``_time_ms``).
5. report: one JSON line of per-kernel numbers, then as the last line
   ``{"ok": true, "device": {...}}``.

Any failure raises and the script exits nonzero without the last line.
Needs the repository beside it and imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
TOKENIZER_JSON = os.path.join(REPO, ".cache", "bench_tokenizer_r4_50k.json")

# H100 SXM peaks at the full 700 W.  HBM3 bytes/s: NVIDIA data sheet.
# int32 operations/s: 132 SMs x 64 INT32 lanes per SM (NVIDIA H100
# architecture whitepaper) x the 1.98 GHz maximum boost clock
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# bytes that a cold timing rotates through: twice the H100's 50 MB L2
COLD_BYTES = 2 * 50 * 2**20
# int32 operations of one cuckoo probe: two multiply-xor-shift hashes, the
# key pack and the compares
OPS_PER_PROBE = 12


def _phase(name: str, t0: float) -> None:
    print(f"[phase] {name}: {time.perf_counter() - t0:.3f} s", flush=True)


def _time_ms(fn, reps: int, graph: bool = True, warm: bool = True) -> float:
    """Mean device milliseconds of one call of ``fn``.

    With ``graph`` (kernels and library expressions): one warm-up call, so
    that one-time work (the kernel's shared-memory opt-in, the allocator)
    stays outside the capture, then ``reps`` calls captured in one CUDA
    graph, replayed once to warm and three times between CUDA events.
    Replay keeps the host's issue rate out of the time.  Without it (K2's
    plain version, which syncs to the host on every step and cannot be
    captured): CUDA events around a Python loop of ``reps`` calls, after
    one warm-up call unless ``warm`` is false."""
    import torch

    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if not graph:
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start.record()
    for _ in range(3):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (3 * reps)


def _time_cold_ms(fn, arg_sets: list, reps: int) -> float:
    """Mean device milliseconds of one call ``fn(*args)`` when no call finds
    its own inputs or output in L2: the calls rotate through ``arg_sets``
    (together over ``COLD_BYTES``, twice the L2, outputs included), all
    captured in one CUDA graph with every output kept alive, so each call
    writes a buffer of its own.  The graph is replayed once to warm, then
    timed over at least ``reps`` calls."""
    import torch

    fn(*arg_sets[0])
    torch.cuda.synchronize()
    outs = []
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for args in arg_sets:
            outs.append(fn(*args))
    g.replay()
    torch.cuda.synchronize()
    replays = max(3, -(-reps // len(arg_sets)))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * len(arg_sets))


def _cold_sets(tensors: tuple, out_bytes: int) -> list:
    """Copies of ``tensors`` enough that they and one output of
    ``out_bytes`` each fill more than ``COLD_BYTES``."""
    per_set = out_bytes + sum(t.numel() * t.element_size() for t in tensors)
    n = -(-COLD_BYTES // per_set)
    return [tuple(t.clone() for t in tensors) for _ in range(n)]


def _bound(bytes_moved: float, ops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _max_abs_err(a, b) -> int:
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.long() - b.long()).abs().max())


def _corpus_rows(texts: list[str], B: int, L: int):
    """[B, L] rows filled with corpus texts joined by spaces."""
    from complexity_tokenizer_tpu_torch.ops.pipeline import pack_texts

    rows: list[bytes] = []
    it = iter(texts)
    while len(rows) < B:
        row = b""
        for t in it:
            d = t.encode("utf-8")
            row = (row + b" " + d) if row else d
            if len(row) >= L:
                break
        rows.append(row[:L])
    return pack_texts(rows, L, B)


def check_seed(label: str, arr, lens, table, timed: bool = True) -> dict:
    """K1 against its plain version on ``arr``/``lens`` (on the card).  With
    ``timed``: the kernel warm (``ms``: graph replay on the same buffers,
    which then sit in L2) and cold (``ms_cold``: ``_time_cold_ms``), its
    plain version and the library expression warm, and the share of the
    bytes bound that the cold time reaches."""
    import torch

    from complexity_tokenizer_tpu_torch.ops.seed import seed_tokens, seed_tokens_plain

    B, W = arr.shape
    got = seed_tokens(arr, lens, table)
    exp = seed_tokens_plain(arr, lens, table)
    torch.cuda.synchronize()
    err = _max_abs_err(got, exp)
    match = bool(torch.equal(got, exp))
    print(f"[seed_tokens] {label} [{B},{W}] match={match} max_abs_err={err}", flush=True)
    if not match:
        raise AssertionError(f"seed_tokens kernel differs from its plain version: {label} [{B},{W}]")
    res = dict(inputs=label, shape=[B, W], match=match, max_abs_err=err)
    if not timed:
        return res
    valid = torch.arange(W, device="cuda")[None, :] < lens[:, None]
    reps = 50 if B * W >= 1 << 20 else 200
    ms = _time_ms(lambda: seed_tokens(arr, lens, table), reps)
    sets = _cold_sets((arr, lens), 4 * B * W)
    ms_cold = _time_cold_ms(lambda a, n: seed_tokens(a, n, table), sets, reps)
    del sets
    plain_ms = _time_ms(lambda: seed_tokens_plain(arr, lens, table), reps)
    library_ms = _time_ms(lambda: torch.where(valid, table[arr.long()], -1), reps)
    # the function reads no byte at or past lens[r]: count the live bytes in
    live = int(lens.clamp(0, W).sum())
    bound_ms, bound_by = _bound(live + 4 * B + 4 * 256 + 4 * B * W, B * W)
    print(
        f"[seed_tokens] {label} [{B},{W}] kernel warm={ms:.4f} ms cold={ms_cold:.4f} ms "
        f"plain={plain_ms:.4f} ms library={library_ms:.4f} ms bound={bound_ms:.4f} ms "
        f"({bound_by}; {live} live bytes; cold share {bound_ms / ms_cold:.3f})",
        flush=True,
    )
    return dict(
        res, ms=ms, ms_cold=ms_cold, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, bound_share=bound_ms / ms_cold, library_ms=library_ms,
    )


def seed_launch_floor_ms(table) -> float:
    """K1's time at [1, 16] by graph replay: one launch carrying almost no
    work."""
    import torch

    from complexity_tokenizer_tpu_torch.ops.seed import seed_tokens

    arr = torch.arange(16, dtype=torch.uint8, device="cuda")[None, :]
    lens = torch.tensor([16], dtype=torch.int32, device="cuda")
    check_seed("launch floor", arr, lens, table, timed=False)
    ms = _time_ms(lambda: seed_tokens(arr, lens, table), 200)
    print(f"[seed_tokens] launch floor [1,16] {ms:.4f} ms", flush=True)
    return ms


def seed_edge_batches(rng) -> list[tuple]:
    """(label, arr, lens) on the card at shapes that reach the kernel's edge
    cases: W not a multiple of the 128-byte segment, one row and 8,193 rows,
    rows of length 0, 1, 15, 16, 17 and W, and rows handed in as an offset
    row slice (16-byte aligned) of a larger buffer."""
    import torch

    out = []
    for B, W, skip in ((5, 48, 3), (257, 2064, 1), (1, 16, 0), (8193, 16, 0), (8193, 144, 0)):
        arr = torch.from_numpy(rng.randint(0, 256, size=(B + skip, W)).astype("uint8")).cuda()
        lens = rng.randint(0, W + 1, size=B + skip).astype("int32")
        edge = [n for n in (0, 1, 15, 16, 17, W) if n <= W]
        lens[skip : skip + len(edge)] = edge[:B]
        lens = torch.from_numpy(lens).cuda()
        label = f"edge, rows {skip}.. of {B + skip}" if skip else "edge"
        out.append((label, arr[skip:], lens[skip:]))
    return out


def check_merge(label: str, tb, arr, lens, byte_table=None, plain_reps: int = 2) -> dict:
    """K2 against its plain version on the pre-split ``arr`` rows, seeded
    with ``byte_table`` (the vocabulary's own by default).  The plain
    version is timed over ``plain_reps`` calls; with 1, the comparison's
    own call is the warm-up."""
    import torch

    from complexity_tokenizer_tpu_torch.ops.merge import (
        merge_fixpoint_qc_plain,
        merge_words_qc,
    )
    from complexity_tokenizer_tpu_torch.ops.presplit import presplit
    from complexity_tokenizer_tpu_torch.ops.seed import seed_tokens_plain

    B, L = arr.shape
    _, wid, _ = presplit(arr, lens, tb.class_table)
    byte_table = tb.byte_token_table if byte_table is None else byte_table
    tokens = seed_tokens_plain(arr, lens, byte_table)

    def kernel():
        return merge_words_qc(tokens, wid, tb.qc_t1, tb.qc_t2, tb.qc_size)

    def plain():
        return merge_fixpoint_qc_plain(tokens, wid, tb.qc_t1, tb.qc_t2, tb.qc_size)

    got_t, got_c = kernel()
    exp_t, exp_c = plain()
    torch.cuda.synchronize()
    err = max(_max_abs_err(got_t, exp_t), _max_abs_err(got_c, exp_c))
    match = bool(torch.equal(got_t, exp_t) and torch.equal(got_c, exp_c))
    ms = _time_ms(kernel, 20)
    plain_ms = _time_ms(plain, plain_reps, graph=False, warm=plain_reps > 1)
    # the least work any fixpoint needs on these rows: every initial
    # adjacent pair of a word probed once, and the up to two new pairs of
    # each merge; bytes: tokens, wid and both tables in, tokens and counts out
    alive = tokens >= 0
    rows = alive.nonzero()[:, 0]
    wids = wid[alive]
    pairs = int(((rows[1:] == rows[:-1]) & (wids[1:] == wids[:-1])).sum())
    merges = int(alive.sum()) - int(exp_c.sum())
    probes = pairs + 2 * merges
    table_bytes = 2 * tb.qc_t1.numel() * 4
    bound_ms, bound_by = _bound(12 * B * L + 4 * B + table_bytes, probes * OPS_PER_PROBE)
    print(
        f"[merge_fixpoint_qc] {label} [{B},{L}] match={match} max_abs_err={err} "
        f"kernel={ms:.4f} ms plain={plain_ms:.4f} ms bound={bound_ms:.4f} ms "
        f"({bound_by}; {probes} probes, {merges} merges) "
        f"live={int(exp_c.sum())}/{int(alive.sum())}",
        flush=True,
    )
    if not match:
        raise AssertionError(
            f"merge_fixpoint_qc kernel differs from its plain version: {label} [{B},{L}]"
        )
    return dict(
        inputs=label, shape=[B, L], match=match, max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
    )


def main_corpus(n_texts: int, seed: int) -> list[str]:
    from complexity_tokenizer_tpu_torch.utils.corpus import MULTI_PIECES, zipf_corpus

    texts = zipf_corpus(n_texts, seed=seed)
    texts += list(MULTI_PIECES)
    texts += [" ".join(MULTI_PIECES[i:] + MULTI_PIECES[:i]) for i in range(0, 29, 4)]
    long_text = " ".join(texts[:40])
    while len(long_text.encode("utf-8")) <= 4096:
        long_text += " " + long_text
    texts.append(long_text)  # over the widest bucket: cut at word boundaries
    texts.append("z" * 4200)  # one word over the widest bucket: host oracle
    texts += [
        "end of doc</s>next doc",
        "</s>",
        "a <s> b </s> c <pad> d <unk>",
        texts[1] + " </s> " + texts[2],
    ]
    return texts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=17, help="corpus and input seed")
    ap.add_argument("--texts", type=int, default=10_000, help="Zipf texts")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    # 1. device -------------------------------------------------------------
    t0 = time.perf_counter()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        from complexity_tokenizer_tpu_torch.ops.merge import merge_words_qc
        from complexity_tokenizer_tpu_torch.ops.pipeline import pack_texts
        from complexity_tokenizer_tpu_torch.ops.seed import seed_tokens
        from complexity_tokenizer_tpu_torch.tokenizer import Tokenizer
        from complexity_tokenizer_tpu_torch.utils.corpus import RUN_BREAKS, run_rows
        from complexity_tokenizer_tpu_torch.utils.cuda_build import kernel_library
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script: {e}", file=sys.stderr)
        return 3
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    print(f"device: {kind} (count {count})")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    print(smi_line)
    _phase("device", t0)

    # 2. build --------------------------------------------------------------
    t0 = time.perf_counter()
    lib = kernel_library()
    built = f"{lib.build_seconds:.3f} s nvcc" if lib.build_seconds else "reused an earlier build"
    print(f"build: {built} -> {os.path.relpath(lib.path, REPO)}")
    for line in lib.ptxas_log.splitlines():
        if "ptxas info" in line and ("Compiling" in line or "registers" in line or "Function properties" in line):
            print("  " + line.strip())
    _phase("build", t0)

    # 3. main path at full width --------------------------------------------
    t0 = time.perf_counter()
    if not os.path.exists(TOKENIZER_JSON):
        print(f"chip_smoke: missing {TOKENIZER_JSON}", file=sys.stderr)
        return 4
    tok = Tokenizer.from_file(TOKENIZER_JSON)
    texts = main_corpus(args.texts, args.seed)
    t1 = time.perf_counter()
    pipe = tok.pipeline("cuda")  # tables built and moved to the card
    torch.cuda.synchronize()
    print(f"pipeline set-up (tables, class table): {time.perf_counter() - t1:.3f} s")
    n_bytes = sum(len(t.encode("utf-8")) for t in texts)

    # keep the first [B, L] batch of every shape the main path launches,
    # so the kernels are checked on exactly those inputs in phase 4
    batches: dict[tuple[int, int], tuple] = {}
    encode_rows = pipe.encode_rows

    def keep_batch(arr, lens):
        batches.setdefault(arr.shape, (arr.copy(), lens.copy()))
        return encode_rows(arr, lens)

    pipe.encode_rows = keep_batch
    seed_tokens.launches = 0
    merge_words_qc.launches = 0
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    try:
        got = tok.encode_batch(texts, backend="device")
        torch.cuda.synchronize()
    finally:
        del pipe.encode_rows
    wall = time.perf_counter() - t1
    launches = {"seed_tokens": seed_tokens.launches, "merge_fixpoint_qc": merge_words_qc.launches}
    t1 = time.perf_counter()
    again = tok.encode_batch(texts, backend="device")
    torch.cuda.synchronize()
    wall2 = time.perf_counter() - t1
    t1 = time.perf_counter()
    host = tok.encode_batch(texts, backend="host")
    host_s = time.perf_counter() - t1
    bad = [i for i, (g, h) in enumerate(zip(got, host)) if g != h]
    n_ids = sum(len(g) for g in got)
    shapes = sorted(batches)
    print(
        f"main path: {len(texts)} texts, {n_bytes} bytes, {n_ids} ids; "
        f"encode_batch(device) {wall:.3f} s first (batches kept), {wall2:.3f} s second; "
        f"host oracle {host_s:.3f} s; launches {launches}; "
        f"batch shapes {[list(x) for x in shapes]}; mismatches {len(bad)}",
        flush=True,
    )
    if bad:
        i = bad[0]
        raise AssertionError(
            f"{len(bad)} texts differ from the host oracle; first {texts[i][:80]!r}: "
            f"{got[i][:16]} vs {host[i][:16]}"
        )
    if again != got:
        raise AssertionError("a second encode_batch gave other ids")
    n_vocab = len(tok.bpe.vocab)
    if not all(0 <= i < n_vocab for g in got for i in g):
        raise AssertionError("an id lies outside the vocabulary")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    _phase("main path", t0)

    # 4. kernels against their plain versions -------------------------------
    t0 = time.perf_counter()
    tb = pipe.tables
    seed_res: list[dict] = []
    merge_res: list[dict] = []
    for shape in shapes:
        arr, lens = (torch.from_numpy(x).cuda() for x in batches[shape])
        seed_res.append(check_seed("main path", arr, lens, tb.byte_token_table))
        merge_res.append(check_merge("main path", tb, arr, lens))
    rng = np.random.RandomState(args.seed)
    table = rng.randint(0, 50000, size=256).astype(np.int32)
    oov = rng.choice(256, 24, replace=False)
    table[oov] = -1  # OOV bytes
    table = torch.from_numpy(table).cuda()
    for B, W in ((8192, 512), (16, 4096)):
        arr = torch.from_numpy(rng.randint(0, 256, size=(B, W)).astype(np.uint8)).cuda()
        lens = torch.from_numpy(rng.randint(0, W + 1, size=B).astype(np.int32)).cuda()
        seed_res.append(check_seed("random bytes", arr, lens, table))
    for label, arr, lens in seed_edge_batches(rng):
        seed_res.append(check_seed(label, arr, lens, table, timed=False))
    launch_floor_ms = seed_launch_floor_ms(tb.byte_token_table)
    arr, lens = (torch.from_numpy(x).cuda() for x in _corpus_rows(texts, 16, 4096))
    merge_res.append(check_merge("corpus rows", tb, arr, lens))
    # the rows that separate the greedy apply from the JAX rule, also with
    # the random table's OOV bytes (and the run breakers) as tombstones
    oov_table = tb.byte_token_table.clone()
    oov_table[torch.from_numpy(oov).cuda()] = -1
    oov_table[list(RUN_BREAKS)] = -1
    corpus_bytes = " ".join(texts).encode("utf-8")
    for B, L in ((16, 1024), (4, 4096)):
        for with_oov in (False, True):
            rows = run_rows(corpus_bytes, B, L, with_oov)
            arr, lens = (torch.from_numpy(x).cuda() for x in pack_texts(rows, L, B))
            merge_res.append(check_merge(
                "run rows, OOV breaks" if with_oov else "run rows", tb, arr, lens,
                byte_table=oov_table if with_oov else None, plain_reps=1,
            ))
    arr, lens = (torch.from_numpy(x).cuda() for x in pack_texts([b"a" * 4096], 4096, 1))
    merge_res.append(check_merge("one letter", tb, arr, lens, plain_reps=1))
    _phase("kernels", t0)

    # 5. report --------------------------------------------------------------
    # the headline numbers are those of the main path's largest batch
    largest = list(max(shapes, key=lambda x: x[0] * x[1]))
    kernels = []
    for name, res, src_line, replaces in (
        ("seed_tokens", seed_res, "ops/seed.py",
         "complexity_tokenizer_tpu/ops/pallas_kernels.py:70"),
        ("merge_fixpoint_qc", merge_res, "ops/merge.py",
         "complexity_tokenizer_tpu/ops/merge.py:187"),
    ):
        main = next(r for r in res if r["inputs"] == "main path" and r["shape"] == largest)
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "complexity_tokenizer_tpu_torch/csrc/kernels.cu",
            "wrapper": "complexity_tokenizer_tpu_torch/" + src_line,
            "replaces": replaces,
            "launches": launches[name],
            "match": all(r["match"] for r in res),
            "max_abs_err": max(r["max_abs_err"] for r in res),
            "shape": largest,
            "ms": main["ms"],
            "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
            "checks": res,
        })
        if name == "seed_tokens":
            kernels[-1].update(
                ms_cold=main["ms_cold"], bound_share=main["bound_share"],
                launch_floor_ms=launch_floor_ms,
            )
    print(json.dumps({"kernels": kernels}))
    print(f"power: {smi_line}")
    _phase("total", t_start)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 17] [--texts 10000]

Phases (each prints its seconds):

1. device: a CUDA card must be present; prints its name, the device count
   and ``nvidia-smi``'s name and power limit.
2. build: compiles the kernels of ``complexity_tokenizer_tpu_torch/csrc``
   (one ``nvcc`` per source, all at once) and, beside them, the native host
   runtime with ``g++``; prints both builds' seconds and the kernels'
   ``-Xptxas -v`` report, and K7's launch shape (registers, shared bytes,
   blocks per SM).
3. the paths (``drive_paths``), on the Zipf corpus (plus multilingual
   pieces, a text over 4,096 bytes, one word over 4,096 bytes and texts
   holding ``</s>``, which go to the host oracle), for two configurations:
   the 50,000-entry vocabulary (its merge fixpoint is K2, on the u16 cuckoo
   table) and the 100,000-entry one (ids and ranks past u16: K5, on the CHD
   table; the word path's ids are int32).  For each: the load cost
   (``from_file``, the tables' build, the tables to the card);
   the text pipeline (``Tokenizer.pipeline().encode_bytes``: pre-split, K1,
   K2 or K5); every distinct word through the device on a fresh native
   context, each word's ids against the host merge; ``backend="device"``
   from a fresh ``Tokenizer.from_file`` (a first call that fills, a warm
   call); ``backend="auto"`` from another fresh tokenizer in five batches,
   drained, then the corpus again, ``encode_batch_ragged`` and
   ``backend="native"``.  Every text's ids equal the host oracle's; the
   launch counts are set to 0 just before each path and read just after;
   each path must have launched its kernels and no other: the text pipeline
   K1 and the fixpoint of its table, the word paths K6 and K4 (the fill in
   two launches) and not K1, K2, K3 or K5.  The first ``[B, L]`` batch and
   word pack of every shape are kept.
   Then decode (``drive_decode``) at both vocabularies, on the ids the
   corpus encoded to (every seventh row framed by special ids): the device
   pipeline (``decode_pipeline("cuda")``, K7) in its batch and ragged
   forms, ``skip_special`` both ways, each row against the host decode and
   the native decoder, launching K7 and no encode kernel; the public decode
   entry points (the native route) for every ``skip_special_tokens`` x
   ``clean_up_tokenization_spaces``, launching nothing.  And the entry layer
   at 50K (``drive_added_tokens``): added tokens with ``lstrip`` and
   ``rstrip`` after a first ``backend="device"`` call, which rebuilds the
   tables and the word path; ``"device"``, ``"auto"`` and ``encode`` on
   texts that hold them, against the host oracle.
   Then the transformers ``__call__`` at both vocabularies (``drive_call``):
   ``<|bos|>`` and ``<|eos|>`` added and set as the Llama layout's static
   frame through the public API; the columnar route with
   ``return_tensors="pt"`` (padding True and ``"max_length"``, right and
   left, stride 0 and 16, ``max_length=512``), every field an int32 tensor
   on ``cuda`` and every row equal to the per-row Encoding of
   ``_call_one`` on the host, and to the ``"np"`` and list results;
   ``add_special_tokens=False`` with ``encode_backend`` ``"device"`` and
   ``"auto"`` (fresh tokenizers), the host oracle's ids, launching K6 and K4
   only; offsets of 512 texts against the Python pre-tokenizer's; the
   framed ``input_ids`` through ``decode_pipeline("cuda")``, launching K7
   only; the walls of ``"pt"``, ``"np"`` and lists.  And the warm-cache
   file (``drive_warm_cache``): the tracked 50K file read and left byte for
   byte (its sha1 before and after, and unchanged over the whole run); the
   100K tokenizer in a temporary directory, ``from_file`` without the file
   (which writes it) and with it, the corpus's ids against the oracle
   after each.
   Then the text pipeline from text at 50K (``drive_norm``):
   ``EncodePipeline.encode_batch`` with the tokenizer's NFC normalizer,
   K8 proving rows stable before the host rewrites the others, against
   the oracle, launching K8, K1 and K2 only; K8 against its plain version
   on each of that run's batches under the NFC and ``BertNormalizer()``
   bitmaps, timed warm, cold and plain.  And the word-level models at full
   width (``drive_models``), each through ``encode_batch`` on the corpus
   launching its tier's kernel once and nothing else: ByteLevel BPE on the
   50K and 100K tables (K9), CharBPE on its test table (K9), WordPiece at
   30,522 entries (K10), WordLevel at 40,001 (K11); every text and every
   distinct word against the host ``encode``; the words the host took
   (poisoned, over 128 lanes) printed; each kernel against its plain
   version on the path's input (K9 also on ``run_rows``), timed warm,
   cold and plain beside its bound.
4. kernels: each kernel against its plain PyTorch version on the card, bit
   for bit, on the kept batches and packs of every shape.  At 50K: K1 also
   on random bytes (some OOV table entries) at ``[8192, 512]`` and
   ``[16, 4096]`` and on edge shapes (``seed_edge_batches``), timed warm,
   cold (``_time_cold_ms``: no call finds its own lines in L2) and at
   ``[1, 16]`` (its launch floor).  K2 also on ``[16, 4096]`` rows filled
   with corpus text, on the rows that separate its greedy apply from the JAX
   rule (``run_rows``) at ``[16, 1024]`` and ``[4, 4096]``, with and without
   OOV bytes inside the runs, and on one 4,096-byte word of one letter.  K5
   on the same packs and batches as K2 and on the one-letter word, under
   the 50K vocabulary's CHD table (built for this check: the pipeline
   builds none where the cuckoo table fits), equal to K2 there, both timed
   warm and cold.
   At 100K: K5 on its own packs and batches and on the one-letter word
   (warm and cold) and on edge shapes (cold only at ``[16, 1024]``).
   Every K2 and K5 line carries its probe and merge counts and the launch's
   shape on the card (``ops/merge.py:launch_shape``: threads, registers,
   spilled bytes, shared memory a block, resident blocks per SM).
   On the word packs of both vocabularies (uint16 ids at 50K, int32 at
   100K): K6 (the word path's merge from the packed bytes) against its
   plain version on the card and on the CPU and against K3 -> K1 -> the
   fixpoint, timed warm and cold with its bound and launch shape; the fill
   (K6, then K4) against the four-launch chain (K3 -> K1 -> K2 or K5 ->
   K4) and against its plain versions on the card and on the CPU at the
   compact capacity and at full capacity, the fill and the chain timed in
   turns, warm and cold; K3 and K4 against their plain versions, timed
   warm and cold.  K6 and the fill also on both probes with both id widths
   (the 50K CHD table, and int32 ids at 50K) and on ``edge_word_pack``
   rows.  Kernels and the library expression are timed by replaying a CUDA
   graph, the plain versions that synchronise with CUDA events around
   their calls (``_time_ms``).  K7 (``check_decode``, one launch a call) at
   both vocabularies on the corpus's rows, random ids at ``[8192, 128]``
   and ``[16, 4096]`` (1% special ids), and edge rows (pads, negatives, ids
   >= V, specials, empty and one-id rows, rows across its 1,024-id tiles),
   skip_special both ways, timed warm and cold beside its bytes bound; then
   on the long-token vocabulary (``utils/corpus.py:long_token_vocab``:
   tokens past the 12 bytes an entry holds inline, one past the 16 KB
   staging window) with random ids, edge rows and tiles that start at every
   residue mod 16; K7's state is zero again after each call.
5. report: one JSON line of the ``__call__`` walls, launches and the
   warm-cache loads, one JSON line of per-kernel numbers, then as the last line
   ``{"ok": true, "device": {...}}``.

The kernels' line lists K1-K11 (``launches_by_path``: every path above).
Any failure raises and the script exits nonzero without the last line.
Needs the repository beside it and imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))
TOKENIZER_JSON = os.path.join(REPO, ".cache", "bench_tokenizer_r4_50k.json")
# past u16: the CHD fixpoint (scripts/make_bench_tokenizer_100k.py)
TOKENIZER_100K = os.path.join(REPO, ".cache", "bench_tokenizer_100k.json")

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
# of one CHD probe: the two hashes, the displacement's add and two masks,
# the two key compares
OPS_PER_PROBE_CHD = 14


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


def _probe_work(tb, table: str, tokens, wid, count) -> tuple:
    """The least work any fixpoint needs on these rows: every initial
    adjacent pair of a word probed once, and the up to two new pairs of
    each merge.  Returns (probes, merges, table bytes, operations): the
    table's bytes these probes touch, each once (a probe reads K2's two
    8-byte cuckoo rows, or K5's 4-byte displacement and 16-byte row; no
    probe count needs more than the whole table), and their operations."""
    alive = tokens >= 0
    rows = alive.nonzero()[:, 0]
    wids = wid[alive]
    pairs = int(((rows[1:] == rows[:-1]) & (wids[1:] == wids[:-1])).sum())
    merges = int(alive.sum()) - int(count.sum())
    probes = pairs + 2 * merges
    if table == "qc":
        return (probes, merges, min(probes * 16, 2 * tb.qc_t1.numel() * 4),
                probes * OPS_PER_PROBE)
    return (probes, merges, min(probes * (4 + 16), 4 * (tb.chd_disp.numel() + tb.chd_rows.numel())),
            probes * OPS_PER_PROBE_CHD)


def check_merge(label: str, tb, arr, lens, byte_table=None, plain_reps: int = 2,
                wid=None, table: str = "qc", cold: bool = False) -> dict:
    """K2 (``table="qc"``) or K5 (``table="chd"``) against its plain version
    on the ``arr`` rows, seeded with ``byte_table`` (the vocabulary's own by
    default), with the word ids ``wid`` (the GPT-2 pre-split's by default).
    K5 on tables that also hold a cuckoo table must also equal K2 there.
    The kernel is timed warm and, with ``cold``, cold; the plain version
    over ``plain_reps`` calls (with 1, the comparison's own call is the
    warm-up; with 0 it is not timed)."""
    import torch

    from complexity_tokenizer_tpu_torch.ops.merge import (
        launch_shape,
        merge_fixpoint_chd_plain,
        merge_fixpoint_qc_plain,
        merge_words,
        merge_words_qc,
    )
    from complexity_tokenizer_tpu_torch.ops.presplit import presplit
    from complexity_tokenizer_tpu_torch.ops.seed import seed_tokens_plain

    B, L = arr.shape
    if wid is None:
        _, wid, _ = presplit(arr, lens, tb.class_table)
    byte_table = tb.byte_token_table if byte_table is None else byte_table
    tokens = seed_tokens_plain(arr, lens, byte_table)
    if table == "qc":
        name, args = "merge_fixpoint_qc", (tb.qc_t1, tb.qc_t2, tb.qc_size)
        kernel_fn, plain_fn = merge_words_qc, merge_fixpoint_qc_plain
    else:
        name = "merge_fixpoint_chd"
        args = (tb.chd_disp, tb.chd_rows, tb.chd_size, tb.chd_n_buckets)
        kernel_fn, plain_fn = merge_words, merge_fixpoint_chd_plain

    def kernel():
        return kernel_fn(tokens, wid, *args)

    got_t, got_c = kernel()
    exp_t, exp_c = plain_fn(tokens, wid, *args)
    torch.cuda.synchronize()
    err = max(_max_abs_err(got_t, exp_t), _max_abs_err(got_c, exp_c))
    match = bool(torch.equal(got_t, exp_t) and torch.equal(got_c, exp_c))
    equals_k2 = None
    if table == "chd" and tb.qc_t1 is not None:
        k2_t, k2_c = merge_words_qc(tokens, wid, tb.qc_t1, tb.qc_t2, tb.qc_size)
        equals_k2 = bool(torch.equal(got_t, k2_t) and torch.equal(got_c, k2_c))
    ms = _time_ms(kernel, 20)
    ms_cold = None
    if cold:
        sets = _cold_sets((tokens, wid), 4 * B * L + 4 * B)
        ms_cold = _time_cold_ms(lambda t, w: kernel_fn(t, w, *args), sets, 20)
        del sets
    plain_ms = None
    if plain_reps:
        plain_ms = _time_ms(lambda: plain_fn(tokens, wid, *args), plain_reps, graph=False,
                            warm=plain_reps > 1)
    probes, merges, table_bytes, ops = _probe_work(tb, table, tokens, wid, exp_c)
    bound_ms, bound_by = _bound(12 * B * L + 4 * B + table_bytes, ops)
    cold_txt = f" cold={ms_cold:.4f} ms" if ms_cold is not None else ""
    plain_txt = f"{plain_ms:.4f} ms" if plain_ms is not None else "not timed"
    k2_txt = f" equals K2={equals_k2}" if equals_k2 is not None else ""
    shape = launch_shape(L, chd=table == "chd")
    print(
        f"[{name}] {label} [{B},{L}] match={match} max_abs_err={err}{k2_txt} "
        f"kernel={ms:.4f} ms{cold_txt} plain={plain_txt} bound={bound_ms:.4f} ms "
        f"({bound_by}; {probes} probes, {merges} merges) "
        f"live={int(exp_c.sum())}/{int((tokens >= 0).sum())}; launch {shape['threads']} threads, "
        f"{shape['registers']} registers, {shape['local_bytes']} B spilled a thread, "
        f"shared {shape['static_smem']} + {shape['dynamic_smem']} B a block, "
        f"{shape['blocks_per_sm']} blocks per SM",
        flush=True,
    )
    if not match:
        raise AssertionError(f"{name} kernel differs from its plain version: {label} [{B},{L}]")
    if equals_k2 is False:
        raise AssertionError(f"K5 differs from K2 on the same rows: {label} [{B},{L}]")
    res = dict(
        inputs=label, shape=[B, L], match=match, max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None, probes=probes, merges=merges,
        launch=shape,
    )
    if ms_cold is not None:
        res["ms_cold"] = ms_cold
    if equals_k2 is not None:
        res["equals_k2"] = equals_k2
    return res


def check_word_fill(label: str, tb, cpu_tb, a, bits, row_len, itemsize: int) -> tuple:
    """The word path's fill on one pack (on the card).  K6 (the merge from
    the packed bytes) against its plain version on the card and on the CPU
    and against K3 -> K1 -> the fixpoint (merged rows and counts); the fill
    (K6, then K4) against the four-launch chain (K3 -> K1 -> K2 or K5 ->
    K4) and its plain versions on the card and on the CPU, byte for byte on
    the fused buffer, at the compact capacity (3/8 of the lanes) and at
    full capacity; K3 and K4 against their plain versions.  K3, K4 and K6
    are timed warm and cold, the fill and the chain in turns (fill, chain,
    chain, fill) warm and cold at the compact capacity, the plain versions
    warm.  K6's bound counts the pack's bytes, start bits, lengths and byte
    table in, the merged rows and counts out and the table bytes its probes
    touch, once each.  Returns (K3, K4, K6 results)."""
    import torch

    from complexity_tokenizer_tpu_torch.ops.merge import launch_shape
    from complexity_tokenizer_tpu_torch.ops.seed import seed_tokens
    from complexity_tokenizer_tpu_torch.ops.wordfill import (
        fill_compact,
        fill_compact_plain,
        fill_layout,
        word_fill,
        word_fill_chain,
        word_fill_plain,
        word_ids,
        word_ids_plain,
        word_merge,
        word_merge_plain,
    )

    B, W = a.shape
    cap = B * W * 3 // 8
    got3 = word_ids(bits, row_len)
    exp3 = word_ids_plain(bits, row_len)
    tokens = seed_tokens(a, row_len, tb.byte_token_table)
    merged, count = tb.merge_fixpoint(tokens, got3)
    got6 = word_merge(a, bits, row_len, tables=tb)
    errs6 = []
    match6 = True
    for exp6 in (word_merge_plain(a, bits, row_len, tables=tb), (merged, count),
                 word_merge(a.cpu(), bits.cpu(), row_len.cpu(), tables=cpu_tb)):
        for g, e in zip(got6, exp6):
            errs6.append(_max_abs_err(g.cpu(), e.cpu()))
            match6 &= bool(torch.equal(g.cpu(), e.cpu()))
    errs4, match4, match_fill = [], True, True
    for c in (cap, B * W):
        got4 = fill_compact(merged, count, c, itemsize)
        exp4 = fill_compact_plain(merged, count, c, itemsize)
        fill = word_fill(a, bits, row_len, c, tables=tb, itemsize=itemsize)
        chain = word_fill_chain(a, bits, row_len, c, tables=tb, itemsize=itemsize)
        plain = word_fill_plain(a, bits, row_len, c, tables=tb, itemsize=itemsize)
        cpu = word_fill(a.cpu(), bits.cpu(), row_len.cpu(), c, tables=cpu_tb, itemsize=itemsize)
        torch.cuda.synchronize()
        errs4.append(_max_abs_err(got4, exp4))
        match4 &= bool(torch.equal(got4, exp4))
        match_fill &= bool(torch.equal(fill, chain) and torch.equal(fill, plain)
                           and torch.equal(fill.cpu(), cpu))
    err3 = _max_abs_err(got3, exp3)
    match3 = bool(torch.equal(got3, exp3))
    total = int(count.sum())
    table = "qc" if tb.qc_t1 is not None else "chd"
    print(
        f"[word_fill] {label} [{B},{W}] K6 == plain (card) == K3+K1+fixpoint == plain (CPU): "
        f"{match6}; fill (K6+K4) == chain == plain (card) == plain (CPU): {match_fill}; "
        f"K3 match={match3} K4 match={match4} (ids of {itemsize} B, largest {int(merged.max())}) "
        f"live={total} cap={cap} ({'spills' if total > cap else 'fits'}); at cap {cap} and {B * W}",
        flush=True,
    )
    if not (match3 and match4 and match6 and match_fill):
        raise AssertionError(f"the fill's kernels differ from their plain versions: {label} [{B},{W}]")
    reps = 200
    out_bytes = fill_layout(B, W, cap, itemsize)[2]
    k3_ms = _time_ms(lambda: word_ids(bits, row_len), reps)
    sets = _cold_sets((bits, row_len), 4 * B * W)
    k3_cold = _time_cold_ms(word_ids, sets, reps)
    del sets
    k3_plain = _time_ms(lambda: word_ids_plain(bits, row_len), 50, graph=False)
    k4_ms = _time_ms(lambda: fill_compact(merged, count, cap, itemsize), reps)
    sets = _cold_sets((merged, count), out_bytes)
    k4_cold = _time_cold_ms(lambda m, n: fill_compact(m, n, cap, itemsize), sets, reps)
    del sets
    k4_plain = _time_ms(lambda: fill_compact_plain(merged, count, cap, itemsize), 20, graph=False)

    def k6_fn(x, y, z):
        return word_merge(x, y, z, tables=tb)

    def fill_fn(x, y, z):
        return word_fill(x, y, z, cap, tables=tb, itemsize=itemsize)

    def chain_fn(x, y, z):
        return word_fill_chain(x, y, z, cap, tables=tb, itemsize=itemsize)

    k6_ms = _time_ms(lambda: k6_fn(a, bits, row_len), 50)
    sets = _cold_sets((a, bits, row_len), 4 * B * W + 4 * B)
    k6_cold = _time_cold_ms(k6_fn, sets, 50)
    del sets
    fill_ms, chain_ms = [], []
    for fn, res in ((fill_fn, fill_ms), (chain_fn, chain_ms), (chain_fn, chain_ms),
                    (fill_fn, fill_ms)):
        res.append(_time_ms(lambda fn=fn: fn(a, bits, row_len), 50))
    # the intermediates (the chain's word ids, tokens and merged tokens, 12
    # B a lane; the fill's merged tokens, 4 B) count as outputs of each call
    sets = _cold_sets((a, bits, row_len), out_bytes + 12 * B * W)
    fill_cold, chain_cold = [], []
    for fn, res in ((fill_fn, fill_cold), (chain_fn, chain_cold), (chain_fn, chain_cold),
                    (fill_fn, fill_cold)):
        res.append(_time_cold_ms(fn, sets, 50))
    del sets
    k6_plain = _time_ms(lambda: word_merge_plain(a, bits, row_len, tables=tb), 3, graph=False)
    # bytes the functions must move: each input read once, each output
    # written once; about one operation a lane
    b3, by3 = _bound(B * W // 8 + 4 * B + 4 * B * W, B * W)
    b4, by4 = _bound(4 * B * W + 4 * B + out_bytes, B * W)
    probes, merges, table_bytes, ops = _probe_work(tb, table, tokens, got3, count)
    b6, by6 = _bound(B * W + B * W // 8 + 4 * B + 4 * 256 + 4 * B * W + 4 * B + table_bytes, ops)
    shape = launch_shape(W, chd=table == "chd", fill=True)
    print(
        f"[word_fill] {label} [{B},{W}] K6 warm={k6_ms:.4f} ms cold={k6_cold:.4f} ms "
        f"plain={k6_plain:.4f} ms bound={b6:.4f} ms ({by6}; {probes} probes, {merges} merges; "
        f"warm share {b6 / k6_ms:.3f}); launch {shape['threads']} threads, {shape['registers']} "
        f"registers, {shape['local_bytes']} B spilled a thread, shared {shape['static_smem']} + "
        f"{shape['dynamic_smem']} B a block, {shape['blocks_per_sm']} blocks per SM; fill "
        f"(K6+K4) warm={min(fill_ms):.4f}-{max(fill_ms):.4f} ms cold={min(fill_cold):.4f}-"
        f"{max(fill_cold):.4f} ms; chain (K3+K1+fixpoint+K4) warm={min(chain_ms):.4f}-"
        f"{max(chain_ms):.4f} ms cold={min(chain_cold):.4f}-{max(chain_cold):.4f} ms",
        flush=True,
    )
    print(
        f"[word_fill] {label} [{B},{W}] K3 warm={k3_ms:.4f} ms cold={k3_cold:.4f} ms "
        f"plain={k3_plain:.4f} ms bound={b3:.4f} ms ({by3}); K4 warm={k4_ms:.4f} ms "
        f"cold={k4_cold:.4f} ms plain={k4_plain:.4f} ms bound={b4:.4f} ms ({by4})",
        flush=True,
    )
    common = dict(inputs=label, shape=[B, W], library_ms=None)
    return (
        dict(common, match=match3, max_abs_err=err3, ms=k3_ms, ms_cold=k3_cold,
             plain_ms=k3_plain, bound_ms=b3, bound_by=by3),
        dict(common, match=match4, max_abs_err=max(errs4), ms=k4_ms, ms_cold=k4_cold,
             plain_ms=k4_plain, bound_ms=b4, bound_by=by4, cap=cap, live=total,
             itemsize=itemsize),
        dict(common, match=match6 and match_fill, max_abs_err=max(errs6), ms=k6_ms,
             ms_cold=k6_cold, fill_ms=fill_ms, fill_ms_cold=fill_cold, chain_ms=chain_ms,
             chain_ms_cold=chain_cold, plain_ms=k6_plain, bound_ms=b6, bound_by=by6,
             probes=probes, merges=merges, launch=shape, cap=cap, live=total,
             itemsize=itemsize),
    )


def check_k6_probes(label: str, tables: list, a, bits, row_len) -> None:
    """K6 against K3 -> K1 -> the fixpoint on one pack, merged rows and
    counts bit for bit, for each (probe, tables) of ``tables`` ("qc": the
    cuckoo table, K2's walk; "chd": the CHD table, K5's walk); then K4 on
    K6's rows against the plain K4 on the chain's, byte for byte, with
    uint16 and int32 ids at the compact and the full capacity."""
    import torch

    from complexity_tokenizer_tpu_torch.ops.merge import merge_words, merge_words_qc
    from complexity_tokenizer_tpu_torch.ops.seed import seed_tokens
    from complexity_tokenizer_tpu_torch.ops.wordfill import (
        fill_compact,
        fill_compact_plain,
        word_ids,
        word_merge_chd,
        word_merge_qc,
    )

    B, W = a.shape
    for probe, tb in tables:
        if probe == "qc":
            pair = (tb.qc_t1, tb.qc_t2, tb.qc_size)
            k6_fn, fixpoint = word_merge_qc, merge_words_qc
        else:
            pair = (tb.chd_disp, tb.chd_rows, tb.chd_size, tb.chd_n_buckets)
            k6_fn, fixpoint = word_merge_chd, merge_words
        got = k6_fn(a, bits, row_len, tb.byte_token_table, *pair)
        tokens = seed_tokens(a, row_len, tb.byte_token_table)
        exp = fixpoint(tokens, word_ids(bits, row_len), *pair)
        torch.cuda.synchronize()
        if not all(torch.equal(g, e) for g, e in zip(got, exp)):
            raise AssertionError(f"K6 differs from K3 -> K1 -> fixpoint: {label} [{B},{W}] {probe}")
        for itemsize in (2, 4):
            for cap in (B * W * 3 // 8, B * W):
                if not torch.equal(fill_compact(*got, cap, itemsize),
                                   fill_compact_plain(*exp, cap, itemsize)):
                    raise AssertionError(f"the fill differs from the chain: {label} [{B},{W}] "
                                         f"{probe} ids of {itemsize} B cap {cap}")
    print(f"[word_fill] {label} [{B},{W}] K6 == K3 -> K1 -> fixpoint, and the fill == the "
          f"chain with ids of 2 and 4 B at both capacities, on {', '.join(p for p, _ in tables)}",
          flush=True)


def text_pipeline_encode(tok, pipe, texts: list[str]) -> list[list[int]]:
    """The text pipeline's ids: texts no added token can match through
    ``pipe.encode_bytes``, the others through the host oracle."""
    data = tok._prepare_bytes([tok._normalize(t) for t in texts])
    flags = tok._added_route_flags(data)
    fast = [i for i in range(len(texts)) if flags is None or not flags[i]]
    out = [None] * len(texts)
    for i, ids in zip(fast, pipe.encode_bytes([data[i] for i in fast])):
        out[i] = ids
    return [ids if ids is not None else tok._encode_host(t) for t, ids in zip(texts, out)]


def _compare(what: str, texts, got, host) -> None:
    bad = [i for i, (g, h) in enumerate(zip(got, host)) if g != h]
    if len(got) != len(host) or bad:
        i = bad[0] if bad else 0
        raise AssertionError(
            f"{what}: {len(bad)} texts differ from the host oracle; first "
            f"{texts[i][:80]!r}: {got[i][:16]} vs {host[i][:16]}"
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


KERNEL_NAMES = ("seed_tokens", "merge_fixpoint_qc", "merge_fixpoint_chd", "word_ids",
                "fill_compact", "word_merge")


def with_chd_table(tok):
    """The tables of ``tok``, whose merges fit the u16 cuckoo table, on the
    card with the vocabulary's CHD table beside the cuckoo table (the
    pipeline builds a CHD table only past u16): K5 then runs on the rows K2
    runs on."""
    from complexity_tokenizer_tpu_torch.convert import tables_to_device
    from complexity_tokenizer_tpu_torch.ops.hashtable import build_chd_table
    from complexity_tokenizer_tpu_torch.utils.unicode_tables import gpt2_class_table

    dt = tok.device_tables()
    chd = build_chd_table(tok.bpe.merge_ranks, tok.bpe.merge_ops)
    return tables_to_device(
        byte_token_table=dt.byte_token_table, class_table=gpt2_class_table(), device="cuda",
        qc_t1=dt.qc.t1, qc_t2=dt.qc.t2, qc_size=dt.qc.size, chd_disp=chd.disp, chd_rows=chd.rows,
    )


def _zero_launches(kernels_of: dict) -> None:
    """Sets every kernel's launch count to 0, just before a path is driven."""
    for k in kernels_of.values():
        k.launches = 0


def _read_launches(kernels_of: dict) -> dict:
    """Every kernel's launch count, read just after a path was driven."""
    return {name: k.launches for name, k in kernels_of.items()}


def drive_paths(label: str, path: str, texts: list[str], kernels_of: dict, native) -> dict:
    """The port's paths on one configuration, each against the host oracle
    on every text, each with the launch counts set to 0 just before and
    read just after:

    - the text pipeline (``pipeline().encode_bytes``; the first ``[B, L]``
      batch of every shape is kept);
    - every distinct word through the device on a fresh native context
      without warm start, each word's ids against the host merge of the
      same words (``NativeEncoder.warm_start``; the first pack of every
      shape is kept);
    - ``encode_batch(texts, backend="device")`` from a fresh
      ``Tokenizer.from_file``, a first call (it fills) and a warm one;
    - ``encode_batch(texts)`` (``backend="auto"``) from another fresh
      tokenizer in five batches, then ``drain_async``; then the corpus again
      and ``encode_batch_ragged``.

    Returns the launch counts by path, the kept batches and packs, the
    pipeline and the word encoder of the fresh context, and the walls."""
    import numpy as np
    import torch

    from complexity_tokenizer_tpu_torch.ops.tables import byte_token_table
    from complexity_tokenizer_tpu_torch.ops.wordpath import DeviceWordEncoder
    from complexity_tokenizer_tpu_torch.tokenizer import Tokenizer

    out: dict = {}
    # load cost: the tokenizer, its tables (the CHD build) and the tables on the card
    t0 = time.perf_counter()
    t1 = time.perf_counter()
    tok = Tokenizer.from_file(path)
    load_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    tables = tok.device_tables()
    tables_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    pipe = tok.pipeline("cuda")
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t1
    fixpoint = "K2 (cuckoo)" if pipe.tables.qc_t1 is not None else "K5 (CHD)"
    pair_table = (
        f"u16 cuckoo, {tables.qc.size} rows" if tables.qc is not None
        else f"CHD, {tables.chd.size} rows / {tables.chd.n_buckets} buckets"
    )
    print(
        f"[{label}] {len(tok.bpe.vocab)} ids, {len(tok.bpe.merge_ranks)} merges, largest rank "
        f"{max(tok.bpe.merge_ranks.values())}, largest id {tables.max_id}; fixpoint {fixpoint}; "
        f"from_file {load_s:.3f} s, tables ({pair_table}) {tables_s:.3f} s, "
        f"tables to the card {upload_s:.3f} s",
        flush=True,
    )
    n_bytes = sum(len(t.encode("utf-8")) for t in texts)
    t1 = time.perf_counter()
    host = tok.encode_batch(texts, backend="host")
    host_s = time.perf_counter() - t1
    n_vocab = len(tok.bpe.vocab)
    if not all(0 <= i < n_vocab for h in host for i in h):
        raise AssertionError(f"[{label}] an oracle id lies outside the vocabulary")

    # text pipeline: keep the first [B, L] batch of every shape it launches
    batches: dict[tuple[int, int], tuple] = {}
    encode_rows = pipe.encode_rows

    def keep_batch(arr, lens):
        batches.setdefault(arr.shape, (arr.copy(), lens.copy()))
        return encode_rows(arr, lens)

    pipe.encode_rows = keep_batch
    _zero_launches(kernels_of)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    try:
        got = text_pipeline_encode(tok, pipe, texts)
        torch.cuda.synchronize()
    finally:
        del pipe.encode_rows
    wall = time.perf_counter() - t1
    out["text pipeline"] = _read_launches(kernels_of)
    t1 = time.perf_counter()
    again = text_pipeline_encode(tok, pipe, texts)
    torch.cuda.synchronize()
    wall2 = time.perf_counter() - t1
    shapes = sorted(batches)
    print(
        f"[{label}] text pipeline: {len(texts)} texts, {n_bytes} bytes, {sum(map(len, host))} ids; "
        f"encode_bytes {wall:.3f} s first (batches kept), {wall2:.3f} s second; "
        f"host oracle {host_s:.3f} s; launches {out['text pipeline']}; "
        f"batch shapes {[list(x) for x in shapes]}",
        flush=True,
    )
    _compare(f"[{label}] text pipeline", texts, got, host)
    _compare(f"[{label}] text pipeline, second call", texts, again, host)
    _phase(f"{label}: text pipeline", t0)

    # every distinct word through the device, on a fresh native context
    t0 = time.perf_counter()

    def fresh_native():
        return native.NativeEncoder(tok.bpe.packed_merge_arrays(), byte_token_table(tok.bpe.vocab))

    packs: dict[int, tuple] = {}

    def keep_packs(word_encoder):
        fill_fn = word_encoder._fn

        def keep_pack(a, bits, row_len):
            packs.setdefault(a.shape[0], (a.copy(), bits.copy(), row_len.copy()))
            return fill_fn(a, bits, row_len)

        word_encoder._fn = keep_pack

    data = tok._prepare_bytes([tok._normalize(t) for t in texts])
    wp = DeviceWordEncoder(pipe, fresh_native())
    keep_packs(wp)
    words, lens = wp.native.collect_miss_words(data, 128)
    _zero_launches(kernels_of)
    t1 = time.perf_counter()
    ids, counts = wp._encode_words_packed(words, lens)
    fill_s = time.perf_counter() - t1
    out["every distinct word"] = _read_launches(kernels_of)
    exp_ids, exp_counts = fresh_native().warm_start(words, lens)
    uncovered = int((counts < 0).sum())
    bounds = np.zeros(len(counts) + 1, np.int64)
    np.cumsum(np.maximum(counts, 0), out=bounds[1:])
    exp_bounds = np.zeros(len(counts) + 1, np.int64)
    np.cumsum(exp_counts, out=exp_bounds[1:])
    mismatched = sum(
        1 for w in range(len(counts))
        if counts[w] != exp_counts[w]
        or not np.array_equal(ids[bounds[w] : bounds[w + 1]], exp_ids[exp_bounds[w] : exp_bounds[w + 1]])
    )
    fill = wp.last_fill
    print(
        f"[{label}] word path, every distinct word: {len(lens)} words, {int(lens.sum())} bytes "
        f"(up to 128 bytes each); ids {np.dtype(wp._out_dtype).name}, largest {int(ids.max())}; "
        f"packs {dict(sorted(fill['packs'].items()))} (rows: count), "
        f"spills {fill['spills']}, redispatches {fill['spills']}; fill {fill_s:.3f} s; "
        f"host seconds {({k: round(v, 4) for k, v in fill['seconds'].items()})}; "
        f"launches {out['every distinct word']}; "
        f"against the host merge: {mismatched} mismatches, {uncovered} uncovered",
        flush=True,
    )
    if mismatched or uncovered or len(lens) == 0:
        raise AssertionError(f"[{label}] device word ids: {mismatched} mismatches, {uncovered} uncovered")
    _phase(f"{label}: every distinct word", t0)

    # backend="device" from a fresh tokenizer
    t0 = time.perf_counter()
    t1 = time.perf_counter()
    tok_d = Tokenizer.from_file(path)
    load_d = time.perf_counter() - t1
    t1 = time.perf_counter()
    wp_d = tok_d._get_word_path("cuda")
    keep_packs(wp_d)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t1
    _zero_launches(kernels_of)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    got = tok_d.encode_batch(texts, backend="device")
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t1
    out["backend=device"] = _read_launches(kernels_of)
    fill_first = dict(wp_d.last_fill)
    t1 = time.perf_counter()
    again = tok_d.encode_batch(texts, backend="device")
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t1
    print(
        f"[{label}] word path, backend=device: from_file {load_d:.3f} s "
        f"({tok_d._warm_start_words} words warm-started), word-path set-up (the tables "
        f"built and to the card) {setup_s:.3f} s; first call {first_s:.3f} s "
        f"({wp_d.words_filled} words filled; packs {dict(sorted(fill_first['packs'].items()))}, "
        f"spills {fill_first['spills']}; host seconds "
        f"{({k: round(v, 4) for k, v in fill_first['seconds'].items()})}), warm {warm_s:.3f} s "
        f"({n_bytes / warm_s / 1e6:.2f} MB/s); assembly route: bytes (ctok_encode_batch); "
        f"launches {out['backend=device']}",
        flush=True,
    )
    _compare(f"[{label}] backend=device", texts, got, host)
    _compare(f"[{label}] backend=device, second call", texts, again, host)
    if wp_d.words_filled <= 0:
        raise AssertionError(f"[{label}] backend=device filled no word")
    _phase(f"{label}: backend=device", t0)

    # backend="auto" from another fresh tokenizer
    t0 = time.perf_counter()
    tok_a = Tokenizer.from_file(path)
    keep_packs(tok_a._get_word_path("cuda"))  # tables on the card before the batches
    torch.cuda.synchronize()
    _zero_launches(kernels_of)
    step = -(-len(texts) // 5)
    got = []
    batch_s = []
    for i in range(0, len(texts), step):
        t1 = time.perf_counter()
        got += tok_a.encode_batch(texts[i : i + step], backend="auto")
        batch_s.append(time.perf_counter() - t1)
    wp_a = tok_a._auto_word_path("cuda")
    t1 = time.perf_counter()
    drained = wp_a.drain_async(timeout=600)
    drain_s = time.perf_counter() - t1
    torch.cuda.synchronize()
    out["backend=auto"] = _read_launches(kernels_of)
    _compare(f"[{label}] backend=auto", texts, got, host)
    t1 = time.perf_counter()
    again = tok_a.encode_batch(texts, backend="auto")
    auto_warm_s = time.perf_counter() - t1
    _compare(f"[{label}] backend=auto, after the fill", texts, again, host)
    flat, offs = tok_a.encode_batch_ragged(texts, backend="auto")
    ragged = [flat[offs[i] : offs[i + 1]].tolist() for i in range(len(texts))]
    if ragged != again:
        raise AssertionError(f"[{label}] encode_batch_ragged differs from encode_batch")
    wp_a.drain_async(timeout=600)
    t1 = time.perf_counter()
    native_ids = tok_a.encode_batch(texts, backend="native")
    native_s = time.perf_counter() - t1
    _compare(f"[{label}] backend=native", texts, native_ids, host)
    print(
        f"[{label}] word path, backend=auto: 5 batches {[round(x, 3) for x in batch_s]} s, drain "
        f"{drain_s:.3f} s ({drained} words inserted by the drain, {wp_a.words_filled} filled "
        f"in all); whole corpus after the fill {auto_warm_s:.3f} s; encode_batch_ragged "
        f"equal; backend=native {native_s:.3f} s, equal; launches {out['backend=auto']}",
        flush=True,
    )
    if wp_a.words_filled <= 0:
        raise AssertionError(f"[{label}] backend=auto filled no word")
    _phase(f"{label}: backend=auto", t0)
    return dict(launches=out, batches=batches, shapes=shapes, packs=packs, pipe=pipe, wp=wp,
                tok=tok, host=host)


def _ragged_on_card(rows):
    """Rows of ids -> (ids int32 [N], row offsets int64 [B + 1]) on the card."""
    import itertools

    import numpy as np
    import torch

    offs = np.zeros(len(rows) + 1, np.int64)
    np.cumsum([len(r) for r in rows], out=offs[1:])
    flat = np.fromiter(itertools.chain.from_iterable(rows), np.int64, count=int(offs[-1]))
    return torch.from_numpy(flat.astype(np.int32)).cuda(), torch.from_numpy(offs).cuda()


def _decode_edge_rows(V: int, special, rng) -> list[list[int]]:
    """K7's edge rows: empty rows first and last, one-id rows (0, V - 1,
    -1, V, a special, the int32 extremes), and rows of 3 to 4,096 ids across
    its 1,024-id tiles with pads, ids >= V, negatives and specials, some
    followed by empty rows."""
    import numpy as np

    edge = [[], [], [0], [V - 1], [-1], [V], [int(special[0])], [-(2**31)], [2**31 - 1]]
    for n in (1023, 1024, 1025, 4096, 3, 2055):
        r = rng.randint(0, V, size=n)
        what = rng.randint(0, 10, size=n)
        r = np.where(what == 0, -1, np.where(what == 1, V + rng.randint(0, 100, size=n), r))
        r = np.where(what == 2, -rng.randint(2, 50, size=n), r)
        r = np.where(what == 3, rng.choice(special, size=n), r)
        edge += [r.tolist()] + [[]] * int(rng.randint(0, 3))
    return edge + [[], []]


def _decode_bytes_moved(ids, offs, tabs, skip: bool, out_numel: int) -> int:
    """The bytes K7's function must move: the ids and row offsets in, the
    table entries of the distinct kept ids (their bytes, two offsets and,
    with ``skip``, the special flag; at most the whole table), the buffer
    out."""
    import torch

    arena, offsets, special = tabs
    V = special.numel()
    ids64 = ids.long()
    ok = (ids64 >= 0) & (ids64 < V)
    distinct = torch.unique(ids64[ok])
    if skip:
        distinct = distinct[special[distinct] == 0]
    touched = int((offsets[distinct + 1] - offsets[distinct]).sum()) + 16 * distinct.numel()
    if skip:
        touched += int(torch.unique(ids64[ok]).numel())
    whole = arena.numel() + 8 * offsets.numel() + (V if skip else 0)
    return 4 * ids.numel() + 8 * offs.numel() + min(touched, whole) + out_numel


def check_decode(label: str, pipe, ids, offs, skip: bool, timed: bool = True,
                 bound_tables=None) -> dict:
    """K7 (one launch) against its plain version on the card, bit for bit,
    on a decode pipeline's tables (its entries and padded arena), with the
    capacity the pipeline gives (``N`` times the longest token).  With
    ``timed``: warm (graph replay on the same buffers and state) and cold
    (``_time_cold_ms`` over copies of the ids and offsets, each call a
    buffer of its own; the table stays shared, as K2's does), its plain
    version (CUDA events; it reads its output size back), and its bound
    from ``bound_tables`` (the arena, offsets and special mask on the
    card)."""
    import torch

    from complexity_tokenizer_tpu_torch.ops.decode import (
        decode_gather,
        decode_gather_plain,
        decode_state,
        live_part,
    )

    B, N = offs.numel() - 1, ids.numel()
    cap = N * pipe.max_len
    state = decode_state(N, ids.device)
    got = live_part(decode_gather(ids, offs, pipe.entries, pipe.arena, skip, cap, state=state), B)
    exp = decode_gather_plain(ids, offs, pipe.entries, pipe.arena, skip)
    torch.cuda.synchronize()
    err = _max_abs_err(got, exp)
    match = bool(torch.equal(got, exp))
    total = got.numel() - 8 * (B + 1)
    print(f"[decode_gather] {label} B={B} ids={N} skip_special={skip} bytes={total} "
          f"match={match} max_abs_err={err}", flush=True)
    if not match:
        raise AssertionError(f"decode_gather kernel differs from its plain version: {label}")
    if state.any():
        raise AssertionError(f"decode_gather left its state nonzero: {label}")
    res = dict(inputs=label, shape=[B, N], skip_special=skip, match=match, max_abs_err=err,
               bytes_out=total)
    if not timed:
        return res
    reps = 50 if N >= 1 << 18 else 200

    def fn(i, o):
        return decode_gather(i, o, pipe.entries, pipe.arena, skip, cap, state=state)

    ms = _time_ms(lambda: fn(ids, offs), reps)
    sets = _cold_sets((ids, offs), 8 * (B + 1) + cap)
    ms_cold = _time_cold_ms(fn, sets, reps)
    del sets
    plain_ms = _time_ms(lambda: decode_gather_plain(ids, offs, pipe.entries, pipe.arena, skip), 5,
                        graph=False)
    moved = _decode_bytes_moved(ids, offs, bound_tables, skip, got.numel())
    bound_ms, bound_by = _bound(moved, 0)
    print(
        f"[decode_gather] {label} B={B} ids={N} kernel warm={ms:.4f} ms cold={ms_cold:.4f} ms "
        f"plain={plain_ms:.4f} ms bound={bound_ms:.4f} ms ({bound_by}; {moved} bytes; "
        f"cold share {bound_ms / ms_cold:.3f}); library: none",
        flush=True,
    )
    return dict(res, ms=ms, ms_cold=ms_cold, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, bound_share=bound_ms / ms_cold, library_ms=None)


def _with_specials(tok, host: list[list[int]]) -> list[list[int]]:
    """The corpus's ids, every seventh row framed by the first and last
    special token, so that ``skip_special`` drops something."""
    sp = sorted(tok.special_tokens.values())
    return [[sp[0]] + r + [sp[-1]] if i % 7 == 0 else r for i, r in enumerate(host)]


def drive_decode(label: str, tok, host: list[list[int]], kernels_of: dict) -> dict:
    """Decode at one vocabulary, on the ids the corpus encoded to (framed by
    specials every seventh row), each route against the host decode
    (``_decode_impl``), with the launch counts set to 0 just before each
    route and read just after:

    - the device pipeline, ``decode_pipeline("cuda").decode_batch`` and
      ``decode_ragged``, ``skip_special`` both ways, also against the native
      decoder's rows: it must launch K7 and no encode kernel;
    - the public entry points (the native route) for every
      ``skip_special_tokens`` x ``clean_up_tokenization_spaces``: they must
      launch nothing.

    Returns the launch counts by route, the walls and the rows."""
    import numpy as np
    import torch

    t0 = time.perf_counter()
    rows = _with_specials(tok, host)
    offs = np.zeros(len(rows) + 1, np.int64)
    np.cumsum([len(r) for r in rows], out=offs[1:])
    flat = np.concatenate([np.asarray(r, np.int32) for r in rows])
    walls: dict = {}
    out: dict = {}
    t1 = time.perf_counter()
    pipe = tok.decode_pipeline("cuda")
    torch.cuda.synchronize()
    walls["decode tables to the card"] = time.perf_counter() - t1
    nd = tok._get_native_decoder()
    if nd is None:
        raise AssertionError(f"[{label}] the native decoder is not eligible")
    mismatches = 0
    device_calls = 0
    _zero_launches(kernels_of)
    for skip in (False, True):
        t1 = time.perf_counter()
        host_txt = [tok._decode_impl(r, skip, False) for r in rows]
        walls[f"host, skip={skip}"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        native_txt, flagged = nd.decode_batch(rows, skip, False)
        walls[f"native decoder, skip={skip}"] = time.perf_counter() - t1
        for i in flagged:
            native_txt[i] = tok._decode_impl(rows[i], skip, False)
        for name in ("batch", "ragged"):
            t1 = time.perf_counter()
            got = pipe.decode_batch(rows, skip) if name == "batch" else pipe.decode_ragged(flat, offs, skip)
            walls[f"device pipeline {name}, skip={skip}"] = time.perf_counter() - t1
            device_calls += 1
            bad = sum(g != h or g != n for g, h, n in zip(got, host_txt, native_txt))
            mismatches += bad + abs(len(got) - len(host_txt))
        if native_txt != host_txt:
            raise AssertionError(f"[{label}] the native decoder differs from the host decode")
    torch.cuda.synchronize()
    out["device decode"] = _read_launches(kernels_of)
    k7 = out["device decode"]["decode_gather"]
    if k7 % device_calls:
        raise AssertionError(
            f"[{label}] K7 launched {k7} times in {device_calls} device decode calls")
    per_call = k7 // device_calls
    # the public entry points: the native route
    _zero_launches(kernels_of)
    for skip in (False, True):
        for cleanup in (False, True):
            host_txt = [tok._decode_impl(r, skip, cleanup) for r in rows]
            t1 = time.perf_counter()
            got = tok.decode_batch_with_options(rows, skip, cleanup)
            walls[f"decode_batch_with_options, skip={skip}, cleanup={cleanup}"] = time.perf_counter() - t1
            ragged = tok.decode_batch_ragged(flat, offs, skip, cleanup)
            mismatches += sum(g != h for g, h in zip(got, host_txt))
            mismatches += sum(g != h for g, h in zip(ragged, host_txt))
            mismatches += sum(tok.batch_decode(rows[:200], skip, cleanup)[i] != host_txt[i] for i in range(200))
    mismatches += sum(tok.decode(r) != tok._decode_impl(r, False, True) for r in rows[:500])
    out["native decode"] = _read_launches(kernels_of)
    print(
        f"[{label}] decode: {len(rows)} rows, {len(flat)} ids; walls "
        f"{({k: round(v, 4) for k, v in walls.items()})}; launches {out}, {per_call} a device decode call; "
        f"{mismatches} mismatches",
        flush=True,
    )
    if mismatches:
        raise AssertionError(f"[{label}] decode: {mismatches} rows differ from the host decode")
    for route, counts in out.items():
        for name, n in counts.items():
            if (n > 0) != (route == "device decode" and name == "decode_gather"):
                raise AssertionError(f"kernel {name} was launched {n} times on the {label} {route}")
    _phase(f"{label}: decode", t0)
    bound_tables = tuple(torch.from_numpy(x).cuda() for x in (pipe.tables.arena, pipe.tables.offsets,
                                                              pipe.tables.special))
    return dict(launches=out, launches_per_call=per_call, walls=walls, rows=rows, pipe=pipe,
                bound_tables=bound_tables)


def drive_added_tokens(path: str, texts: list[str], kernels_of: dict) -> dict:
    """The entry layer on the card at 50K: a tokenizer encodes with
    ``backend="device"`` (tables, word path, fill), then takes added tokens
    with ``lstrip`` and ``rstrip`` (``add_token_with_config``), which drop
    its tables, word path and native context; then ``encode_batch`` with
    ``"device"`` and ``"auto"`` and ``encode`` on corpus texts that hold the
    tokens, each against the host oracle."""
    import torch

    from complexity_tokenizer_tpu_torch.tokenizer import Tokenizer

    t0 = time.perf_counter()
    base = texts[:2000]
    tok = Tokenizer.from_file(path)
    tok.encode_batch(base, backend="device")
    wp0, tables0 = tok._get_word_path("cuda"), tok._tables
    V = max(tok.id_to_token_map) + 1

    def add_tokens(t):
        t.add_token_with_config("zqxlst", V, False, lstrip=True)
        t.add_token_with_config("zqxrst", V + 1, False, rstrip=True)
        t.add_token_with_config("qqmid", V + 2, True, lstrip=True, rstrip=True)

    add_tokens(tok)
    forms = ("zqxlst {}", "{} zqxlst", "zqxrst{}", "{} zqxrst", "zqxrst", "{}qqmid", "qqmid", "{} zqxrstx")
    mixed = [forms[i % len(forms)].format(t) if i % 3 == 0 else t for i, t in enumerate(base)]
    host = [tok._encode_host(t) for t in mixed]
    matched = sum(1 for h in host if any(i >= V for i in h))
    _zero_launches(kernels_of)
    got = tok.encode_batch(mixed, backend="device")
    torch.cuda.synchronize()
    launches = _read_launches(kernels_of)
    _compare("[50K] added tokens, backend=device", mixed, got, host)
    wp1 = tok._get_word_path("cuda")
    if wp1 is wp0 or tok._tables is tables0 or launches["word_merge"] == 0:
        raise AssertionError("[50K] adding tokens did not rebuild the tables and the word path")
    tok_a = Tokenizer.from_file(path)
    add_tokens(tok_a)
    got = tok_a.encode_batch(mixed, backend="auto")
    tok_a._auto_word_path("cuda").drain_async(timeout=600)
    _compare("[50K] added tokens, backend=auto", mixed, got, host)
    _compare("[50K] added tokens, backend=auto, after the fill", mixed, tok_a.encode_batch(mixed), host)
    _compare("[50K] added tokens, encode", mixed, [tok.encode(t) for t in mixed], host)
    print(
        f"[50K] added tokens (lstrip, rstrip, both): {len(mixed)} texts, {matched} hold a matched "
        f"token; the tables and the word path rebuilt; backend=device launches {launches}; "
        f"backend=auto, encode: equal to the host oracle",
        flush=True,
    )
    if matched == 0:
        raise AssertionError("[50K] no added token matched")
    _phase("50K: added tokens", t0)
    return dict(launches=launches, matched=matched)


def _sha1(path: str) -> str:
    import hashlib

    with open(path, "rb") as f:
        return hashlib.sha1(f.read()).hexdigest()


def _call_rows(e, max_len: int, stride: int, pad_to: int, pad_id: int, pad_token: str,
               pad_left: bool):
    """The four batch fields of one per-row Encoding ``e`` (a copy) after
    ``__call__``'s truncation and padding."""
    from complexity_tokenizer_tpu_torch.core.encoding import Encoding

    c = Encoding(ids=list(e.ids), type_ids=list(e.type_ids), tokens=list(e.tokens),
                 attention_mask=list(e.attention_mask),
                 special_tokens_mask=list(e.special_tokens_mask), sequence_ids=list(e.sequence_ids))
    if len(c) > max_len:
        if stride > 0:
            c.truncate_with_stride(max_len, stride)
        else:
            c.truncate(max_len)
    c.pad(pad_to, pad_id, pad_token, pad_left)
    return c.ids, c.attention_mask, c.type_ids, c.special_tokens_mask


def drive_call(label: str, path: str, texts: list[str], host: list[list[int]],
               kernels_of: dict) -> dict:
    """The transformers ``__call__`` at one vocabulary, on the whole corpus:

    - the tokenizer takes ``<|bos|>`` and ``<|eos|>`` (``add_special_tokens_list``)
      and the Llama layout's static frame (``set_post_processor`` of
      ``PostProcessor.template("<|bos|> $A <|eos|>")``);
    - the columnar route, ``tok(texts, padding=..., truncation=True,
      max_length=512, stride=..., return_tensors="pt")`` for padding in
      {True, "max_length"}, right and left, stride 0 and 16: every field an
      int32 tensor on ``cuda``, every row equal to the per-row Encoding of
      ``_call_one`` (on the host), ``return_tensors=None`` and ``"np"`` the
      same rows, and the Encodings of some rows with their overflow windows;
    - ``add_special_tokens=False`` with ``encode_backend`` ``"device"`` and
      ``"auto"``, each from a fresh ``from_file``: the host oracle's ids,
      launching K6 and K4 and nothing else;
    - ``return_offsets_mapping=True`` on 512 texts: the offsets of the
      native word boundaries equal those of the Python pre-tokenizer;
    - ``decode_pipeline("cuda")`` over the framed ``input_ids`` without
      their pads, ``skip_special`` both ways: the host decode's texts,
      launching K7 and nothing else;
    - the walls of ``__call__`` (fields read) for ``"pt"``, ``"np"`` and
      lists, two runs each.

    Returns the launch counts by route and the walls."""
    import numpy as np
    import torch

    from complexity_tokenizer_tpu_torch.batch_encoding import ColumnarBatchEncoding
    from complexity_tokenizer_tpu_torch.components import PostProcessor
    from complexity_tokenizer_tpu_torch.tokenizer import Tokenizer

    def only(route, counts, names):
        for name, n in counts.items():
            if (n > 0) != (name in names):
                raise AssertionError(f"kernel {name} was launched {n} times on the {label} {route}")

    t0 = time.perf_counter()
    out: dict = {"launches": {}, "walls": {}}
    n_bytes = sum(len(t.encode("utf-8")) for t in texts)
    tok = Tokenizer.from_file(path)
    tok.add_special_tokens_list(["<|bos|>", "<|eos|>"])
    bos, eos = tok.special_tokens["<|bos|>"], tok.special_tokens["<|eos|>"]
    tok.set_post_processor(PostProcessor.template(
        "<|bos|> $A <|eos|>", None, [("<|bos|>", bos), ("<|eos|>", eos)]))
    pad_id, pad_token = tok._pad_id_token()
    t1 = time.perf_counter()
    base = [tok._call_one(t, None, True) for t in texts]
    per_row_s = time.perf_counter() - t1
    fields = ("input_ids", "attention_mask", "token_type_ids", "special_tokens_mask")
    mismatches = 0
    configs = 0
    framed = None
    _zero_launches(kernels_of)
    for padding in (True, "max_length"):
        for side in ("right", "left"):
            tok.padding_side = side
            for stride in (0, 16):
                kw = dict(padding=padding, truncation=True, max_length=512, stride=stride,
                          return_special_tokens_mask=True)
                be = tok(texts, return_tensors="pt", **kw)
                if not isinstance(be, ColumnarBatchEncoding):
                    raise AssertionError(f"[{label}] __call__ did not take the columnar route")
                mats = {}
                for f in fields:
                    v = be[f]
                    if not (isinstance(v, torch.Tensor) and v.dtype == torch.int32
                            and v.device.type == "cuda"):
                        raise AssertionError(f"[{label}] {f} is not an int32 tensor on cuda")
                    mats[f] = v.cpu().numpy()
                pad_to = mats["input_ids"].shape[1]
                want = [_call_rows(e, 512, stride, pad_to, pad_id, pad_token, side == "left")
                        for e in base]
                got = [m.tolist() for m in mats.values()]
                mismatches += sum(
                    any(got[k][i] != want[i][k] for k in range(4)) for i in range(len(texts)))
                np_be = tok(texts, return_tensors="np", **kw)
                list_be = tok(texts, **kw)
                for f in fields:
                    mismatches += int((np_be[f] != mats[f]).any(axis=1).sum())
                    mismatches += sum(a != b for a, b in zip(list_be[f], got[fields.index(f)]))
                for i in (0, 1, len(texts) - 6, len(texts) - 5):  # the long text, the long word
                    ref = tok._call_one(texts[i], None, True)
                    if len(ref) > 512:
                        if stride:
                            ref.truncate_with_stride(512, stride)
                        else:
                            ref.truncate(512)
                    ref.pad(pad_to, pad_id, pad_token, side == "left")
                    e = be[i]
                    if (e.ids, e.special_tokens_mask, [o.ids for o in e.overflowing]) != (
                            ref.ids, ref.special_tokens_mask, [o.ids for o in ref.overflowing]):
                        mismatches += 1
                if padding is True and side == "right" and stride == 0:
                    keep = mats["attention_mask"].astype(bool)
                    framed = [row[k].tolist() for row, k in zip(mats["input_ids"], keep)]
                configs += 1
    torch.cuda.synchronize()
    out["launches"]["__call__ columnar"] = _read_launches(kernels_of)
    only("__call__ columnar", out["launches"]["__call__ columnar"], ())
    framed_ok = all(r[0] == bos and r[-1] == eos for r in framed if len(r) < 512)
    print(
        f"[{label}] __call__ columnar: {configs} configurations (padding True / max_length, "
        f"right / left, stride 0 / 16, max_length 512) over {len(texts)} texts; per-row Encodings "
        f"on the host {per_row_s:.3f} s; every field int32 on cuda; {mismatches} mismatches against "
        f"the per-row Encodings, np and lists; frame <|bos|>={bos} ... <|eos|>={eos} "
        f"{'present' if framed_ok else 'MISSING'}; launches {out['launches']['__call__ columnar']}",
        flush=True,
    )
    if mismatches or not framed_ok:
        raise AssertionError(f"[{label}] __call__ columnar: {mismatches} mismatches")

    # add_special_tokens=False: encode_batch on the card, from a fresh tokenizer each
    for backend in ("device", "auto"):
        t2 = Tokenizer.from_file(path)
        t2.encode_backend = backend
        t2._get_word_path("cuda")
        torch.cuda.synchronize()
        _zero_launches(kernels_of)
        t1 = time.perf_counter()
        be = t2(texts, add_special_tokens=False)
        if backend == "auto":
            t2._auto_word_path("cuda").drain_async(timeout=600)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        route = f"__call__ add_special_tokens=False, {backend}"
        out["launches"][route] = counts = _read_launches(kernels_of)
        got = [e.ids for e in be.encodings()]
        bad = sum(g != h for g, h in zip(got, host))
        print(f"[{label}] {route}: {wall:.3f} s (the fill included); {bad} mismatches against the "
              f"host oracle; launches {counts}", flush=True)
        if bad:
            raise AssertionError(f"[{label}] {route}: {bad} mismatches")
        only(route, counts, ("word_merge", "fill_compact"))
        if counts["word_merge"] != counts["fill_compact"]:
            raise AssertionError(f"[{label}] {route}: K6 and K4 launched unequally")

    # offsets: the native word boundaries against the Python pre-tokenizer
    sample = texts[:512]
    t1 = time.perf_counter()
    be = tok(sample, return_offsets_mapping=True)
    offs = be.offset_mapping
    offsets_s = time.perf_counter() - t1
    tok._pre_tokenize_fast = lambda s: None
    try:
        ref = [tok._call_one(t, None, True) for t in sample]
    finally:
        del tok._pre_tokenize_fast
    bad = sum(o != r.offsets or e.word_ids != r.word_ids
              for o, e, r in zip(offs, be.encodings(), ref))
    print(f"[{label}] __call__ return_offsets_mapping: {len(sample)} texts, {offsets_s:.3f} s; "
          f"{bad} mismatches against the Python pre-tokenizer's offsets", flush=True)
    if bad:
        raise AssertionError(f"[{label}] offsets: {bad} mismatches")

    # the framed ids, pads cut off, through the device decode (K7)
    pipe = tok.decode_pipeline("cuda")
    torch.cuda.synchronize()
    _zero_launches(kernels_of)
    bad = 0
    for skip in (False, True):
        got = pipe.decode_batch(framed, skip)
        bad += sum(g != tok._decode_impl(r, skip, False) for g, r in zip(got, framed))
    torch.cuda.synchronize()
    out["launches"]["decode of the framed ids"] = counts = _read_launches(kernels_of)
    print(f"[{label}] decode_pipeline('cuda') of the framed input_ids, skip_special both ways: "
          f"{bad} mismatches against the host decode; launches {counts}", flush=True)
    if bad:
        raise AssertionError(f"[{label}] decode of the framed ids: {bad} mismatches")
    only("decode of the framed ids", counts, ("decode_gather",))

    # walls: the fields read, "pt" ending in a synchronize
    tok.padding_side = "right"
    kw = dict(padding=True, truncation=True, max_length=512)
    for kind in ("pt", "np", None):
        runs = []
        for _ in range(2):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            tok(texts, return_tensors=kind, **kw).to_dict()
            if kind == "pt":
                torch.cuda.synchronize()
            runs.append(time.perf_counter() - t1)
        out["walls"][str(kind)] = runs
    print(f"[{label}] __call__ walls (padding=True, truncation, max_length 512, the fields read), "
          f"{n_bytes} bytes: " + "; ".join(
              f"{k}: {', '.join(f'{w:.4f} s ({n_bytes / w / 1e6:.2f} MB/s)' for w in v)}"
              for k, v in out["walls"].items()), flush=True)
    _phase(f"{label}: __call__", t0)
    return out


def drive_warm_cache(texts: list[str], host100: list[list[int]]) -> dict:
    """The warm-cache file: the tracked 50K file is read and left byte for
    byte; the 100K tokenizer, copied into a temporary directory, writes its
    file at a first ``from_file`` and reads it at a second, with the
    corpus's ids equal to the host oracle's after each."""
    import shutil
    import tempfile

    from complexity_tokenizer_tpu_torch.tokenizer import Tokenizer

    t0 = time.perf_counter()
    blob50 = TOKENIZER_JSON.replace(".json", ".warmcache.npz")
    before = _sha1(blob50)
    t1 = time.perf_counter()
    tok = Tokenizer.from_file(TOKENIZER_JSON)
    load50 = time.perf_counter() - t1
    after = _sha1(blob50)
    print(f"[50K] warm-cache file {os.path.relpath(blob50, REPO)}: sha1 {before} before, {after} "
          f"after; from_file {load50:.3f} s, {tok._warm_start_words} words from the file "
          f"({tok._warm_start_s:.3f} s)", flush=True)
    if before != after or not tok._warm_start_from_blob:
        raise AssertionError("[50K] the tracked warm-cache file was not read, or was written")
    out = {"50K": dict(sha1_before=before, sha1_after=after, from_file_s=load50)}
    with tempfile.TemporaryDirectory() as d:
        src = os.path.join(d, "tok100k.json")
        shutil.copy(TOKENIZER_100K, src)
        blob = os.path.join(d, "tok100k.warmcache.npz")
        loads = []
        for step in ("no file (writes it)", "with the file"):
            existed = os.path.exists(blob)
            t1 = time.perf_counter()
            tok = Tokenizer.from_file(src)
            s = time.perf_counter() - t1
            ids = tok.encode_batch(texts, backend="native")
            bad = sum(g != h for g, h in zip(ids, host100))
            loads.append(s)
            print(f"[100K] from_file, {step}: {s:.3f} s (warm start {tok._warm_start_s:.3f} s, "
                  f"{tok._warm_start_words} words, from the file: {tok._warm_start_from_blob}); "
                  f"{bad} mismatches against the host oracle", flush=True)
            if bad or tok._warm_start_from_blob != existed or not os.path.exists(blob):
                raise AssertionError(f"[100K] warm-cache file, {step}: {bad} mismatches")
        out["100K"] = dict(from_file_s=loads)
    _phase("warm-cache file", t0)
    return out


def _drive_launches(kernels_of: dict, fn):
    """Runs ``fn()`` with every launch count set to 0 just before and read
    just after; returns (its result, the counts, the wall ending in a
    synchronise)."""
    import torch

    _zero_launches(kernels_of)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    return res, _read_launches(kernels_of), wall


def _need_only(label: str, counts: dict, need: dict) -> None:
    """Each kernel in ``need`` launched that many times (None: at least
    once) on the path, and no other kernel."""
    for name, n in counts.items():
        want = need.get(name, 0)
        if (want is None and n == 0) or (want is not None and n != want):
            raise AssertionError(f"kernel {name} was launched {n} times on {label}")


def _timings(kernel, plain, cold_fn, cold_inputs: tuple, out_bytes: int, plain_reps: int = 2):
    """Warm and cold kernel ms (CUDA graph replay), and the plain version's
    ms (CUDA events around ``plain_reps`` calls)."""
    ms = _time_ms(kernel, 20)
    sets = _cold_sets(cold_inputs, out_bytes)
    ms_cold = _time_cold_ms(cold_fn, sets, 20)
    del sets
    plain_ms = _time_ms(plain, plain_reps, graph=False)
    return ms, ms_cold, plain_ms


def check_norm(label: str, arr, lens, bitmap, sectors: int) -> dict:
    """K8 against its plain version on one batch of the main path, timed
    warm, cold and plain; the bound counts the rows' live bytes (the
    function reads no byte at or past ``lens[r]``: the rows are whole UTF-8
    texts, so no lead byte's tail lies past it), the lengths and flags and
    ``sectors`` 32-byte sectors of the bitmap (those the rows' codepoints
    land in), each once."""
    import torch

    from complexity_tokenizer_tpu_torch.ops.normalize_device import (
        norm_stable_rows,
        norm_stable_rows_plain,
    )

    B, L = arr.shape
    got = norm_stable_rows(arr, lens, bitmap)
    torch.cuda.synchronize()
    exp = norm_stable_rows_plain(arr, lens, bitmap)
    match = bool(torch.equal(got, exp))
    err = _max_abs_err(got.int(), exp.int())
    ms, ms_cold, plain_ms = _timings(
        lambda: norm_stable_rows(arr, lens, bitmap), lambda: norm_stable_rows_plain(arr, lens, bitmap),
        lambda a, n: norm_stable_rows(a, n, bitmap), (arr, lens), B)
    live = int(lens.clamp(0, L).sum())
    bound_ms, bound_by = _bound(live + 5 * B + 32 * sectors, live * 4)
    print(f"[norm_check] {label} [{B},{L}] match={match} max_abs_err={err} kernel={ms:.4f} ms "
          f"cold={ms_cold:.4f} ms plain={plain_ms:.4f} ms bound={bound_ms:.4f} ms ({bound_by}; "
          f"{live} live bytes, {sectors} bitmap sectors); stable rows {int(exp.sum())}/{B}",
          flush=True)
    if not match:
        raise AssertionError(f"K8 differs from its plain version: {label} [{B},{L}]")
    return dict(inputs=label, shape=[B, L], match=match, max_abs_err=err, ms=ms, ms_cold=ms_cold,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                stable=int(exp.sum()))


def drive_norm(texts: list[str], host: list[list[int]], kernels_of: dict) -> dict:
    """The text pipeline with its normalization check, at 50K (NFC):
    ``EncodePipeline.encode_batch(texts)`` from a fresh tokenizer, whose rows
    K8 proves stable skip the host rewrite, against the host oracle, with
    the launch counts set to 0 just before and read just after (K8, K1 and
    K2, no other); then K8 against its plain version on every batch of that
    run (the same length buckets, at most 8,192 rows), under the NFC plan
    and under ``BertNormalizer()``'s."""
    import torch

    from complexity_tokenizer_tpu_torch.core.normalizers import BertNormalizer
    from complexity_tokenizer_tpu_torch.ops.normalize_device import plan_for_normalizer
    from complexity_tokenizer_tpu_torch.ops.pipeline import _LENGTH_BUCKETS, pack_texts
    from complexity_tokenizer_tpu_torch.tokenizer import Tokenizer

    t0 = time.perf_counter()
    tok = Tokenizer.from_file(TOKENIZER_JSON)
    pipe = tok.pipeline("cuda")
    t1 = time.perf_counter()
    checker = pipe._norm_checker  # the NFC bitmap: built and on the card
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t1
    got, counts, wall = _drive_launches(kernels_of, lambda: pipe.encode_batch(texts))
    _need_only("the 50K text pipeline with K8", counts,
               {"norm_stable_rows": None, "seed_tokens": None, "merge_fixpoint_qc": None})
    # the texts that may hold an added token go to the oracle on the
    # Tokenizer's own routes; EncodePipeline.encode_batch has no scan
    flags = tok._added_route_flags(tok._prepare_bytes([tok._normalize(t) for t in texts]))
    keep = [i for i in range(len(texts)) if flags is None or not flags[i]]
    _compare("[50K] EncodePipeline.encode_batch (K8, NFC)", [texts[i] for i in keep],
             [got[i] for i in keep], [host[i] for i in keep])
    raw = [t.encode("utf-8") for t in texts]
    clean = checker.check_bytes(raw, _LENGTH_BUCKETS, pack_texts)
    groups: dict[int, list[int]] = {}
    for i, d in enumerate(raw):
        L = next((b for b in _LENGTH_BUCKETS if max(len(d), 1) <= b), None)
        if L is not None:
            groups.setdefault(L, []).append(i)
    print(f"[50K] EncodePipeline.encode_batch (K8, NFC): {len(texts)} texts, {len(keep)} against the "
          f"oracle (the others may hold an added token), 0 mismatches; NFC bitmap built and to the "
          f"card {setup_s:.3f} s; wall {wall:.3f} s; rows proven stable {int(clean.sum())}, "
          f"normalized on the host {int((~clean).sum())} ({len(texts) - sum(map(len, groups.values()))} "
          f"over the widest bucket); batches {sorted((L, len(v)) for L, v in groups.items())}; "
          f"launches {counts}", flush=True)
    results = []
    bert = torch.from_numpy(plan_for_normalizer(BertNormalizer()).bitmap).cuda()
    for L, idxs in sorted(groups.items()):
        chunk = idxs[:8192]
        arr, lens = pack_texts([raw[i] for i in chunk], L, len(chunk))
        sectors = len({ord(c) >> 5 for i in chunk for c in texts[i]})
        arr, lens = torch.from_numpy(arr).cuda(), torch.from_numpy(lens).cuda()
        results.append(check_norm("corpus batch, NFC", arr, lens, checker.bitmap, sectors))
        results.append(check_norm("corpus batch, BertNormalizer", arr, lens, bert, sectors))
    _phase("50K: text pipeline with K8", t0)
    return dict(launches={"50K EncodePipeline.encode_batch (NFC)": counts}, checks=results)


def _symbol_probe_work(tokens, count, disp, rows) -> tuple:
    """As _probe_work, with one word a row: every initial adjacent pair of
    a row probed once and two probes a merge.  (probes, merges, table
    bytes, operations)."""
    alive = (tokens >= 0).sum(dim=1)
    pairs = int((alive - 1).clamp(min=0).sum())
    merges = int(alive.sum()) - int(count.sum())
    probes = pairs + 2 * merges
    return (probes, merges, min(probes * 20, 4 * (disp.numel() + rows.numel())),
            probes * OPS_PER_PROBE_CHD)


def check_model_kernel(label: str, name: str, tier, words: list[str], sym_rows=None) -> dict:
    """The kernel of a model's tier (K9, K10 or K11) against its plain
    version on the main path's input (the batch's distinct words, packed by
    the tier), timed warm, cold and plain, with its bound.  The bound
    counts the live input only (each row's symbols or characters, and a
    length a row; a WordPiece word over its limit needs its length alone),
    the dense outputs, and the table bytes the probes touch, each once."""
    import torch

    from complexity_tokenizer_tpu_torch.ops.merge import merge_word_rows, merge_word_rows_plain
    from complexity_tokenizer_tpu_torch.ops.wordpiece_device import (
        wordlevel_lookup,
        wordlevel_lookup_plain,
        wordpiece_match,
        wordpiece_match_plain,
    )

    table_bytes_all = 4 * (tier.disp.numel() + tier.rows.numel())
    if name == "merge_word_rows":
        tokens = torch.from_numpy(tier.pack(sym_rows)[0]).cuda()
        args = (tier.disp, tier.rows, tier.chd.size, tier.chd.n_buckets)
        kernel = lambda: merge_word_rows(tokens, *args)  # noqa: E731
        plain = lambda: merge_word_rows_plain(tokens, *args)  # noqa: E731
        cold_fn, inputs = (lambda t: merge_word_rows(t, *args)), (tokens,)
        B, W = tokens.shape
        out_bytes = 4 * B * W + 4 * B
    else:
        chars, lens, _ = tier.pack(words)
        chars, lens = torch.from_numpy(chars).cuda(), torch.from_numpy(lens).cuda()
        B, W = chars.shape
        if name == "wordpiece_match":
            extra = (tier.t.max_input_chars,)
            kfn, pfn = wordpiece_match, wordpiece_match_plain
            out_bytes = 4 * B * W + 5 * B
        else:
            extra = ()
            kfn, pfn = wordlevel_lookup, wordlevel_lookup_plain
            out_bytes = 4 * B
        kernel = lambda: kfn(chars, lens, *tier.args(), *extra)  # noqa: E731
        plain = lambda: pfn(chars, lens, *tier.args(), *extra)  # noqa: E731
        cold_fn, inputs = (lambda c, n: kfn(c, n, *tier.args(), *extra)), (chars, lens)
    got = kernel()
    torch.cuda.synchronize()
    exp = plain()
    got_t = got if isinstance(got, tuple) else (got,)
    exp_t = exp if isinstance(exp, tuple) else (exp,)
    match = all(torch.equal(a, b) for a, b in zip(got_t, exp_t))
    err = max(_max_abs_err(a.long(), b.long()) for a, b in zip(got_t, exp_t))
    ms, ms_cold, plain_ms = _timings(kernel, plain, cold_fn, inputs, out_bytes)
    if name == "merge_word_rows":
        live = int((tokens >= 0).sum())
        probes, merges, tbytes, ops = _symbol_probe_work(tokens, exp_t[1], tier.disp, tier.rows)
        work = f"{live} symbols, {probes} probes, {merges} merges"
    elif name == "wordpiece_match":
        live = int(lens[lens <= tier.t.max_input_chars].sum())
        emits = int(exp_t[1].sum())  # at least one probe (a hit) and its check an id
        probes, tbytes = emits, min(emits * 20, table_bytes_all)
        ops = emits * OPS_PER_PROBE_CHD
        work = f"{live} characters, {emits} ids, {int(exp_t[2].sum())} poisoned"
    else:
        live = int(lens.sum())
        probes = int((lens > 0).sum())
        tbytes, ops = min(probes * 20, table_bytes_all), probes * OPS_PER_PROBE_CHD
        work = f"{live} characters, {probes} probes, {int((exp_t[0] == tier.t.unk_id).sum())} UNK"
    bound_ms, bound_by = _bound(4 * (live + B) + out_bytes + tbytes, ops)
    print(f"[{name}] {label} [{B},{W}] match={match} max_abs_err={err} kernel={ms:.4f} ms "
          f"cold={ms_cold:.4f} ms plain={plain_ms:.4f} ms bound={bound_ms:.4f} ms ({bound_by}; "
          f"{work})", flush=True)
    if not match:
        raise AssertionError(f"{name} differs from its plain version: {label}")
    return dict(inputs=label, shape=[B, W], match=match, max_abs_err=err, ms=ms, ms_cold=ms_cold,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                probes=probes)


def _bytelevel_model(path: str):
    from complexity_tokenizer_tpu_torch.models import ByteLevelBpeModel

    with open(path, encoding="utf-8") as fh:
        m = json.load(fh)["model"]
    merges = [tuple(x.split(" ")) if isinstance(x, str) else tuple(x) for x in m["merges"]]
    return ByteLevelBpeModel(m["vocab"], merges)


def _charbpe_model():
    """The CharBPE table of the JAX package's tests (``</w>`` fused to the
    last character), with runs of ``l``."""
    from complexity_tokenizer_tpu_torch.models import CharBpeModel

    merges = [("l", "o"), ("lo", "w</w>"), ("e", "r</w>"), ("w", "e"), ("lo", "w"), ("n", "e"),
              ("ne", "w</w>"), ("we", "er</w>"), ("l", "l"), ("ll", "ll")]
    vocab = {"<unk>": 0}
    for sym in "lowernstuv":
        vocab.setdefault(sym, len(vocab))
        vocab.setdefault(sym + "</w>", len(vocab))
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    return CharBpeModel(vocab, merges)


MODEL_CONFIGS = (
    # label, the model, the kernel of its tier
    ("ByteLevel BPE 50K", lambda: _bytelevel_model(TOKENIZER_JSON), "merge_word_rows"),
    ("ByteLevel BPE 100K", lambda: _bytelevel_model(TOKENIZER_100K), "merge_word_rows"),
    ("CharBPE (test table)", _charbpe_model, "merge_word_rows"),
    ("WordPiece 30,522", None, "wordpiece_match"),
    ("WordLevel 40,001", None, "wordlevel_lookup"),
)


def drive_models(texts: list[str], kernels_of: dict) -> dict:
    """The word-level models at full width, each through ``encode_batch``
    (the entry point a user calls) on the corpus, with the launch counts
    set to 0 just before and read just after (its tier's kernel once, no
    other): ByteLevel BPE on the tracked 50K and 100K tables (K9), CharBPE
    on its test table (K9), WordPiece at bert-base-uncased's size (K10) and
    WordLevel at 40,001 entries (K11).  Every text against the host
    ``encode`` (assembled from each distinct word's host ids), every
    distinct word through ``encode_batch`` alone against the host; the
    words the host took (poisoned, over 128 lanes, an ineligible table)
    are counted.  Then each kernel against its plain version on the main
    path's input."""
    import torch

    from complexity_tokenizer_tpu_torch.models import WordLevelModel, WordPieceModel
    from complexity_tokenizer_tpu_torch.utils.corpus import (
        RUN_BREAKS,
        bert_scale_wordpiece_vocab,
        run_rows,
        wordlevel_vocab,
    )

    makers = {"WordPiece 30,522": lambda: WordPieceModel(bert_scale_wordpiece_vocab()),
              "WordLevel 40,001": lambda: WordLevelModel(wordlevel_vocab())}
    out: dict = {"launches": {}, "checks": {}, "walls": {}, "stats": {}}
    for label, make, kname in MODEL_CONFIGS:
        t0 = time.perf_counter()
        t1 = time.perf_counter()
        model = (make or makers[label])()
        tier = model._tiers.get("cuda")
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t1
        if tier is None:
            raise AssertionError(f"[{label}] the tables are not eligible for the device tier")
        got, counts, wall = _drive_launches(kernels_of, lambda: model.encode_batch(texts))
        stats = dict(model.last_stats)
        if model.last_route != "device":
            raise AssertionError(f"[{label}] encode_batch took the {model.last_route} route")
        _need_only(f"[{label}] encode_batch", counts, {kname: 1})
        split = model._split_words if hasattr(model, "_split_words") else str.split
        rows = [split(t) for t in texts]
        uniq = sorted({w for r in rows for w in r})
        t1 = time.perf_counter()
        host = {w: model.encode(w) for w in uniq}
        host_s = time.perf_counter() - t1
        bad_texts = sum(g != [i for w in r for i in host[w]] for g, r in zip(got, rows))
        per_word = model.encode_batch(uniq)
        bad_words = sum(g != host[w] for g, w in zip(per_word, uniq))
        print(f"[{label}] encode_batch: {len(texts)} texts, {len(uniq)} distinct words; tables "
              f"built and to the card {setup_s:.3f} s; wall {wall:.3f} s; host encode of the "
              f"distinct words {host_s:.3f} s; {bad_texts} texts and {bad_words} words differ from "
              f"the host; words the host took {stats['host']} (poisoned {stats['poisoned']}, over "
              f"128 lanes {stats['over_width']}); launches {counts}", flush=True)
        if bad_texts or bad_words:
            raise AssertionError(f"[{label}] {bad_texts} texts, {bad_words} words differ from the host")
        sym_rows = None
        if kname == "merge_word_rows":
            sym_rows = ([list(model._text_to_byte_tokens(w)) for w in uniq]
                        if hasattr(model, "_text_to_byte_tokens")
                        else [list(w)[:-1] + [w[-1] + model.end_of_word_suffix] for w in uniq])
        out["checks"].setdefault(kname, []).append(
            check_model_kernel(label, kname, tier, uniq, sym_rows))
        if label == "ByteLevel BPE 50K":
            # the rows that separate the greedy apply from the JAX rule, as
            # words of 128 byte-level symbols; with breaks, the run breakers
            # are symbols no merge names (ids past the table's universe)
            corpus_bytes = " ".join(texts).encode("utf-8")
            enc = model._byte_encoder
            for breaks in (False, True):
                runs = [[enc[b] + ("\0" if b in RUN_BREAKS else "") for b in r]
                        for r in run_rows(corpus_bytes, 64, 128, breaks)]
                out["checks"][kname].append(check_model_kernel(
                    "run rows, unknown-symbol breaks" if breaks else "run rows", kname, tier, [],
                    runs))
        out["launches"][label] = counts
        out["walls"][label] = wall
        out["stats"][label] = stats
        _phase(f"model {label}", t0)
    return out


def _call_launches(name: str, *calls) -> dict:
    """A kernel's launches on each route of ``drive_call``, by vocabulary."""
    return {f"{label} {route}": counts[name]
            for label, c in zip(("50K", "100K"), calls)
            for route, counts in c["launches"].items()}


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
        from complexity_tokenizer_tpu_torch import native
        from complexity_tokenizer_tpu_torch.ops.decode import (
            DecodePipeline,
            build_decode_tables,
            decode_gather,
            decode_launch_shape,
        )
        from complexity_tokenizer_tpu_torch.ops.merge import (
            merge_word_rows,
            merge_words,
            merge_words_qc,
        )
        from complexity_tokenizer_tpu_torch.ops.normalize_device import norm_stable_rows
        from complexity_tokenizer_tpu_torch.ops.pipeline import pack_texts
        from complexity_tokenizer_tpu_torch.ops.seed import seed_tokens
        from complexity_tokenizer_tpu_torch.ops.wordfill import (
            fill_compact,
            word_ids,
            word_ids_plain,
            word_merge,
        )
        from complexity_tokenizer_tpu_torch.ops.wordpiece_device import (
            wordlevel_lookup,
            wordpiece_match,
        )
        from complexity_tokenizer_tpu_torch.utils.corpus import (
            RUN_BREAKS,
            edge_word_pack,
            long_token_vocab,
            run_rows,
        )
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
    for path in (TOKENIZER_JSON, TOKENIZER_100K):
        if not os.path.exists(path):
            print(f"chip_smoke: missing {path}", file=sys.stderr)
            return 4
    _phase("device", t0)

    # 2. build: the kernels and the native runtime side by side --------------
    t0 = time.perf_counter()
    native_build: dict = {}

    def build_native():
        t1 = time.perf_counter()
        try:
            native.load_library()
            native_build["route"] = "fused extension" if native.load_ext() else "bytes"
        except BaseException as e:  # raised below, in this thread
            native_build["error"] = e
        native_build["seconds"] = time.perf_counter() - t1

    builder = threading.Thread(target=build_native)
    builder.start()
    lib = kernel_library()
    builder.join()
    if "error" in native_build:
        raise native_build["error"]
    built = f"{lib.build_seconds:.3f} s nvcc" if lib.build_seconds else "reused an earlier build"
    print(f"build: {built} -> {os.path.relpath(lib.path, REPO)}")
    for line in lib.ptxas_log.splitlines():
        if "ptxas info" in line and ("Compiling" in line or "registers" in line or "Function properties" in line):
            print("  " + line.strip())
    k7_shape = decode_launch_shape()
    print(f"  K7 decode_gather: {k7_shape['threads']} threads, {k7_shape['registers']} registers, "
          f"{k7_shape['static_smem']} B shared, {k7_shape['local_bytes']} B local a thread, "
          f"{k7_shape['blocks_per_sm']} blocks per SM")
    print(
        f"native runtime: {native_build['seconds']:.3f} s g++ (with the kernels' build) -> "
        f"{os.path.relpath(native._lib_path, REPO)}; batch route: {native_build['route']}"
    )
    _phase("build", t0)

    # 3. the paths at 50K (K2) and at 100K (K5) -----------------------------------
    texts = main_corpus(args.texts, args.seed)
    blob50 = TOKENIZER_JSON.replace(".json", ".warmcache.npz")
    blob50_sha1 = _sha1(blob50)
    kernels_of = {"seed_tokens": seed_tokens, "merge_fixpoint_qc": merge_words_qc,
                  "merge_fixpoint_chd": merge_words, "word_ids": word_ids,
                  "fill_compact": fill_compact, "word_merge": word_merge,
                  "decode_gather": decode_gather, "norm_stable_rows": norm_stable_rows,
                  "merge_word_rows": merge_word_rows, "wordpiece_match": wordpiece_match,
                  "wordlevel_lookup": wordlevel_lookup}
    r50 = drive_paths("50K", TOKENIZER_JSON, texts, kernels_of, native)
    r100 = drive_paths("100K", TOKENIZER_100K, texts, kernels_of, native)
    d50 = drive_decode("50K", r50["tok"], r50["host"], kernels_of)
    d100 = drive_decode("100K", r100["tok"], r100["host"], kernels_of)
    added = drive_added_tokens(TOKENIZER_JSON, texts, kernels_of)
    call50 = drive_call("50K", TOKENIZER_JSON, texts, r50["host"], kernels_of)
    call100 = drive_call("100K", TOKENIZER_100K, texts, r100["host"], kernels_of)
    warm = drive_warm_cache(texts, r100["host"])
    norm = drive_norm(texts, r50["host"], kernels_of)
    mdl = drive_models(texts, kernels_of)
    # the paths of this slice, by name, for every kernel's launches_by_path
    new_paths = {**norm["launches"], **{f"model {k}": v for k, v in mdl["launches"].items()}}
    # every kernel of a path was launched on it and no other: the text
    # pipeline runs K1 and the fixpoint of its table, the word paths one K6
    # (K3, K1 and the fixpoint folded into it) and one K4 a pack
    for label, r, fixpoint in (("50K", r50, "merge_fixpoint_qc"), ("100K", r100, "merge_fixpoint_chd")):
        for path_name, counts in r["launches"].items():
            text = path_name == "text pipeline"
            need = [fixpoint, "seed_tokens"] if text else ["word_merge", "fill_compact"]
            for name, n in counts.items():
                if (n > 0) != (name in need):
                    raise AssertionError(f"kernel {name} was launched {n} times on the {label} {path_name}")
            if not text and counts["word_merge"] != counts["fill_compact"]:
                raise AssertionError(f"K6 and K4 launched unequally on the {label} {path_name}")

    # 4. kernels against their plain versions -------------------------------
    t0 = time.perf_counter()
    tb = r50["pipe"].tables
    cpu_tb = r50["tok"].pipeline("cpu").tables
    tb_chd = with_chd_table(r50["tok"])
    itemsize = np.dtype(r50["wp"]._out_dtype).itemsize
    seed_res: list[dict] = []
    merge_res: list[dict] = []
    chd_res: list[dict] = []
    k3_res: list[dict] = []
    k4_res: list[dict] = []
    k6_res: list[dict] = []
    packs, batches = r50["packs"], r50["batches"]
    # 50K: K5 on the same rows as K2 (on the vocabulary's CHD table, which
    # the pipeline does not build where the cuckoo table fits), so the cost
    # of the dependent probe shows
    for B in sorted(packs):
        a, bits, row_len = (torch.from_numpy(x).cuda() for x in packs[B])
        r3, r4, r6 = check_word_fill("word pack", tb, cpu_tb, a, bits, row_len, itemsize)
        k3_res.append(r3)
        k4_res.append(r4)
        k6_res.append(r6)
        check_k6_probes("word pack", [("qc", tb), ("chd", tb_chd)], a, bits, row_len)
        seed_res.append(check_seed("word pack", a, row_len, tb.byte_token_table))
        wid = word_ids_plain(bits, row_len)
        merge_res.append(check_merge("word pack", tb, a, row_len, wid=wid, cold=True))
        chd_res.append(check_merge("word pack, 50K", tb_chd, a, row_len, wid=wid, table="chd",
                                   cold=True, plain_reps=0))
    # K6 at the fill's edges (edge_word_pack): runs before the first start
    # bit, rows of length 0 and 128, OOV bytes and runs, a one-letter word
    corpus_words = [w.encode("utf-8") for t in texts[:2000] for w in t.split()]
    edge_packs = [tuple(torch.from_numpy(x).cuda() for x in edge_word_pack(corpus_words, B, seed=B))
                  for B in (1, 7, 1024)]
    for pack in edge_packs:
        check_k6_probes("edge rows", [("qc", tb), ("chd", tb_chd)], *pack)
    for shape in r50["shapes"]:
        arr, lens = (torch.from_numpy(x).cuda() for x in batches[shape])
        seed_res.append(check_seed("text batch", arr, lens, tb.byte_token_table))
        merge_res.append(check_merge("text batch", tb, arr, lens, cold=True))
        chd_res.append(check_merge("text batch, 50K", tb_chd, arr, lens, table="chd", cold=True,
                                   plain_reps=0))
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
    one_letter = [torch.from_numpy(x).cuda() for x in pack_texts([b"a" * 4096], 4096, 1)]
    merge_res.append(check_merge("one letter", tb, *one_letter, plain_reps=1))
    chd_res.append(check_merge("one letter, 50K", tb_chd, *one_letter, table="chd", plain_reps=0))
    _phase("kernels at 50K", t0)

    # 100K: K5 on its own paths' batches and packs, K4 with int32 ids
    t0 = time.perf_counter()
    tb = r100["pipe"].tables
    cpu_tb = r100["tok"].pipeline("cpu").tables
    itemsize = np.dtype(r100["wp"]._out_dtype).itemsize
    if itemsize != 4:
        raise AssertionError("the 100K word path does not take int32 ids")
    packs, batches = r100["packs"], r100["batches"]
    for B in sorted(packs):
        a, bits, row_len = (torch.from_numpy(x).cuda() for x in packs[B])
        r3, r4, r6 = check_word_fill("word pack, 100K", tb, cpu_tb, a, bits, row_len, itemsize)
        k3_res.append(r3)
        k4_res.append(r4)
        k6_res.append(r6)
        check_k6_probes("word pack, 100K", [("chd", tb)], a, bits, row_len)
        seed_res.append(check_seed("word pack, 100K", a, row_len, tb.byte_token_table, timed=False))
        chd_res.append(check_merge("word pack", tb, a, row_len, wid=word_ids_plain(bits, row_len),
                                   table="chd", cold=True))
    for pack in edge_packs:
        check_k6_probes("edge rows, 100K", [("chd", tb)], *pack)
    for shape in r100["shapes"]:
        arr, lens = (torch.from_numpy(x).cuda() for x in batches[shape])
        chd_res.append(check_merge("text batch", tb, arr, lens, table="chd", cold=True))
    chd_res.append(check_merge("one letter", tb, *one_letter, table="chd", plain_reps=1,
                               cold=True))
    # edge shapes: one row, three rows of 8, a width that is no multiple of
    # 16, and run rows with OOV bytes (the random table's and the run
    # breakers) as tombstones
    oov_table = tb.byte_token_table.clone()
    oov_table[torch.from_numpy(oov).cuda()] = -1
    oov_table[list(RUN_BREAKS)] = -1
    for B, L in ((1, 16), (3, 8), (5, 200), (16, 1024)):
        rows = run_rows(corpus_bytes, B, L, B == 16)
        arr, lens = (torch.from_numpy(x).cuda() for x in pack_texts(rows, L, B))
        # cold only where the rows are large enough for a rotation through
        # twice the L2 to stay a few thousand launches
        chd_res.append(check_merge(
            "edge, run rows, OOV breaks" if B == 16 else "edge", tb, arr, lens, table="chd",
            plain_reps=0, byte_table=oov_table if B == 16 else None, cold=B == 16,
        ))
    _phase("kernels at 100K", t0)

    # K7 against its plain version: the corpus's rows, random ids at
    # [8192, 128] and [16, 4096], edge rows; at both vocabularies; then the
    # long-token vocabulary (tokens past the entry's 12 inline bytes, one
    # past the 16 KB staging window) and tiles at every residue mod 16
    t0 = time.perf_counter()
    k7_res: list[dict] = []
    for label, d in (("50K", d50), ("100K", d100)):
        pipe, btabs = d["pipe"], d["bound_tables"]
        V = pipe.V
        ids, offs = _ragged_on_card(d["rows"])
        k7_res.append(check_decode(f"corpus rows, {label}", pipe, ids, offs, False, bound_tables=btabs))
        k7_res.append(check_decode(f"corpus rows, {label}", pipe, ids, offs, True, timed=False))
        special = np.nonzero(pipe.tables.special)[0]
        for B, T in ((8192, 128), (16, 4096)):
            rand = rng.randint(0, V, size=(B, T))
            rand[rng.rand(B, T) < 0.01] = rng.choice(special, size=1)[0]
            ids = torch.from_numpy(rand.astype(np.int32).ravel()).cuda()
            offs = torch.arange(0, B * T + 1, T, dtype=torch.int64, device="cuda")
            k7_res.append(check_decode(f"random ids, {label}", pipe, ids, offs, False,
                                       bound_tables=btabs))
            k7_res.append(check_decode(f"random ids, {label}", pipe, ids, offs, True, timed=False))
        ids, offs = _ragged_on_card(_decode_edge_rows(V, special, rng))
        for skip in (False, True):
            k7_res.append(check_decode(f"edge rows, {label}", pipe, ids, offs, skip, timed=False))
        ids, offs = _ragged_on_card([[]] * 4)
        k7_res.append(check_decode(f"empty rows, {label}", pipe, ids, offs, False, timed=False))
    lpipe = DecodePipeline(build_decode_tables(*long_token_vocab()), "cuda")
    V = lpipe.V
    special = np.nonzero(lpipe.tables.special)[0]
    rows = [rng.randint(-3, V + 3, size=n).tolist() for n in (0, 300, 3000, 1025, 0)] + [[9, 3, 9]]
    rows += _decode_edge_rows(V, special, rng)
    for r in range(16):  # tile 1 at residue r: r one-byte ids (id 1), ids of no bytes (15)
        rows += [[1] * r + [15] * (1024 - r) + rng.randint(0, V, size=50).tolist()]
    ids, offs = _ragged_on_card(rows)
    for skip in (False, True):
        k7_res.append(check_decode("long tokens", lpipe, ids, offs, skip, timed=False))
    _phase("decode kernel", t0)

    # 5. report --------------------------------------------------------------
    # the headline numbers are those of the word path's largest pack (K5:
    # at 100K; the others at 50K); launches those of the path that runs the
    # kernel (K1 and the fixpoint: the text pipeline; K6 and K4:
    # backend="device"; K3, folded into K6: backend="device", where it
    # shows 0)
    kernels = []
    for name, res, src, wrapper, replaces, path_name in (
        ("seed_tokens", seed_res, "kernels.cu", "ops/seed.py",
         "complexity_tokenizer_tpu/ops/pallas_kernels.py:70", "text pipeline"),
        ("merge_fixpoint_qc", merge_res, "kernels.cu", "ops/merge.py",
         "complexity_tokenizer_tpu/ops/merge.py:187", "text pipeline"),
        ("merge_fixpoint_chd", chd_res, "kernels.cu", "ops/merge.py",
         "complexity_tokenizer_tpu/ops/merge.py:342", "text pipeline"),
        ("word_ids", k3_res, "wordfill.cu", "ops/wordfill.py",
         "complexity_tokenizer_tpu/ops/wordpath.py:292", "backend=device"),
        ("fill_compact", k4_res, "wordfill.cu", "ops/wordfill.py",
         "complexity_tokenizer_tpu/ops/wordpath.py:317", "backend=device"),
        ("word_merge", k6_res, "kernels.cu", "ops/wordfill.py",
         "complexity_tokenizer_tpu/ops/wordpath.py:259", "backend=device"),
    ):
        main_run = r100 if name == "merge_fixpoint_chd" else r50
        largest = [max(main_run["packs"]), 128]
        main = next(r for r in res if r["inputs"] == "word pack" and r["shape"] == largest)
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "complexity_tokenizer_tpu_torch/csrc/" + src,
            "wrapper": "complexity_tokenizer_tpu_torch/" + wrapper,
            "replaces": replaces,
            "launches": main_run["launches"][path_name][name],
            "launches_path": f"{'100K' if main_run is r100 else '50K'} {path_name}",
            "launches_by_path": {
                f"{label} {path_name}": counts[name]
                for label, r in (("50K", r50), ("100K", r100))
                for path_name, counts in r["launches"].items()
            },
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
        kernels[-1]["launches_by_path"].update(_call_launches(name, call50, call100))
        kernels[-1]["launches_by_path"].update({p: c[name] for p, c in new_paths.items()})
        if "ms_cold" in main:
            kernels[-1]["ms_cold"] = main["ms_cold"]
        if "launch" in main:
            kernels[-1]["launch"] = main["launch"]
        if name == "word_merge":
            for key in ("fill_ms", "fill_ms_cold", "chain_ms", "chain_ms_cold"):
                kernels[-1][key] = min(main[key])
        if name == "word_ids":
            kernels[-1]["folded_into"] = "word_merge"
        if name == "seed_tokens":
            kernels[-1]["launch_floor_ms"] = launch_floor_ms
    main = next(r for r in k7_res if r["inputs"] == "corpus rows, 50K" and "ms" in r)
    kernels.append({
        "name": "decode_gather",
        "route": "cuda",
        "source": "complexity_tokenizer_tpu_torch/csrc/decode.cu",
        "wrapper": "complexity_tokenizer_tpu_torch/ops/decode.py",
        "replaces": "complexity_tokenizer_tpu/ops/decode.py:71",
        "launches": d50["launches"]["device decode"]["decode_gather"],
        "launches_path": "50K device decode (decode_batch and decode_ragged, skip_special both ways)",
        "launches_per_call": d50["launches_per_call"],
        "launches_by_path": {
            **{f"{label} {route}": counts["decode_gather"]
               for label, d in (("50K", d50), ("100K", d100))
               for route, counts in d["launches"].items()},
            **_call_launches("decode_gather", call50, call100),
            **{p: c["decode_gather"] for p, c in new_paths.items()},
        },
        "match": all(r["match"] for r in k7_res),
        "max_abs_err": max(r["max_abs_err"] for r in k7_res),
        "shape": main["shape"],
        "ms": main["ms"],
        "ms_cold": main["ms_cold"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": None,
        "launch": k7_shape,
        "checks": k7_res,
    })
    # K8-K11: the paths of this slice
    norm_main = max((r for r in norm["checks"] if r["inputs"] == "corpus batch, NFC"),
                    key=lambda r: r["shape"][0])
    for name, res, src, wrapper, replaces, path_name, main in (
        ("norm_stable_rows", norm["checks"], "normcheck.cu", "ops/normalize_device.py",
         "complexity_tokenizer_tpu/ops/normalize_device.py:226",
         "50K EncodePipeline.encode_batch (NFC)", norm_main),
        ("merge_word_rows", mdl["checks"]["merge_word_rows"], "kernels.cu", "ops/merge.py",
         "complexity_tokenizer_tpu/ops/merge.py:157", "model ByteLevel BPE 50K", None),
        ("wordpiece_match", mdl["checks"]["wordpiece_match"], "wordpiece.cu",
         "ops/wordpiece_device.py", "complexity_tokenizer_tpu/ops/wordpiece_device.py:185",
         "model WordPiece 30,522", None),
        ("wordlevel_lookup", mdl["checks"]["wordlevel_lookup"], "wordpiece.cu",
         "ops/wordpiece_device.py", "complexity_tokenizer_tpu/ops/wordpiece_device.py:384",
         "model WordLevel 40,001", None),
    ):
        main = main or res[0]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "complexity_tokenizer_tpu_torch/csrc/" + src,
            "wrapper": "complexity_tokenizer_tpu_torch/" + wrapper,
            "replaces": replaces,
            "launches": new_paths[path_name][name],
            "launches_path": path_name,
            "launches_by_path": {
                **{f"{label} {p}": counts[name]
                   for label, r in (("50K", r50), ("100K", r100))
                   for p, counts in r["launches"].items()},
                **_call_launches(name, call50, call100),
                **{p: c[name] for p, c in new_paths.items()},
            },
            "match": all(r["match"] for r in res),
            "max_abs_err": max(r["max_abs_err"] for r in res),
            "shape": main["shape"],
            "ms": main["ms"],
            "ms_cold": main["ms_cold"],
            "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"],
            "library_ms": None,
            "checks": res,
        })
    if _sha1(blob50) != blob50_sha1:
        raise AssertionError("the tracked 50K warm-cache file changed during the run")
    print(json.dumps({"call": {
        label: {"walls_s": c["walls"], "launches": c["launches"]}
        for label, c in (("50K", call50), ("100K", call100))
    }, "warm_cache": warm, "models": {"walls_s": mdl["walls"], "host_words": mdl["stats"]},
        "card": smi_line}))
    print(json.dumps({"kernels": kernels}))
    print(f"power: {smi_line}")
    _phase("total", t_start)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

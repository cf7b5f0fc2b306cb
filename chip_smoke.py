#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 17] [--texts 10000] [--parent DIR]

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
   the text pipeline (``Tokenizer.pipeline().encode_bytes``: K21 the
   pre-split, K1, K2 or K5); every distinct word through the device on a fresh native
   context, each word's ids against the host merge; ``backend="device"``
   from a fresh ``Tokenizer.from_file`` (a first call that fills, a warm
   call); ``backend="auto"`` from another fresh tokenizer in five batches,
   drained, then the corpus again, ``encode_batch_ragged`` and
   ``backend="native"``.  Every text's ids equal the host oracle's; the
   launch counts are set to 0 just before each path and read just after;
   each path must have launched its kernels and no other: the text pipeline
   K21, K1 and the fixpoint of its table, once a batch each, the word paths
   K6 and K4 (the fill in two launches) and not K1, K2, K3 or K5.  The first ``[B, L]`` batch and
   word pack of every shape are kept.
   Then the sharded and the phased fill at both vocabularies
   (``drive_shards``): every distinct word again, unsharded, sharded over
   ``[cuda:0]`` and over ``[cuda:0, cuda:0]`` (two blocks on two streams;
   the machine has one card), phased (``CTOK_PHASE_N1=6``: K20, the
   fixpoint, K4's phased mode) and phased over two blocks, two rounds in
   turns; each variant's ids and counts equal the unsharded fill's and the
   host merge's bit for bit, each launches its kernels only, and each
   variant's wall is printed on a line of its own; and the text pipeline
   over ``[cuda:0, cuda:0]`` against the host oracle.
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
   K8 proving rows stable (every row in one launch) before the host
   rewrites the others, against the oracle, launching K8 once, K21, K1 and
   K2 only; K8 against its plain version on that run's rows under the NFC and
   ``BertNormalizer()`` bitmaps, timed warm, cold and plain with its launch
   shape, and on the edge rows of ``utils/corpus.py:norm_edge_rows``
   (truncated leads before continuation-looking bytes, rows of exactly
   128, 512 and 4,096 bytes, rows across a block's edge, runs of empty
   rows, one-byte rows) under those and the trap bitmap.  And the models at
   full width (``drive_models``), each through ``encode_batch`` on the
   corpus launching its tier's kernel once and nothing else: ByteLevel BPE
   on the 50K and 100K tables (K9), CharBPE on its test table (K9),
   WordPiece at 30,522 entries (K10), WordLevel at 40,001 (K11), and
   Unigram at t5-base's 32,000 pieces (K12, the Viterbi) on the corpus's
   ``▁word`` pieces (the input a T5 pipeline's ``Metaspace`` gives the
   model, one call); every text (Unigram: every piece) and every distinct
   word against the host ``encode``; the words the host took (poisoned,
   over 128 lanes) printed; each kernel against its plain version on the
   path's input (K9, K10, K11 and K12 on the ragged words or pieces as
   their tiers pack them; K9 also on ``run_rows``; K22, K9's fixpoint on the
   u16 cuckoo table, which no path launches, on the 50K ByteLevel BPE
   model's words and run rows against its plain version and K9, timed
   warm, cold and plain beside K9; K12 also on
   ``utils/corpus.py:unigram_edge_texts``, with ``maxcand`` 3 and 16 under
   the fallback marker -2, and with every text a warp and every text in a
   group of 8 lanes), timed warm, cold and plain beside its bound and
   the bound of the dense [B, 128] rows the earlier tiers wrote (K9, K10)
   or read (K11); K9 also at every tile size
   of ``TILE_SWEEP``, each checked; K10's and K11's words counted by lane
   group, K11 also with every word in groups of 8 and every word a warp.
   Then the trainer (``drive_train``): ``DistributedInlTrainer`` on
   ``cuda`` over the golden files' corpus (``utils/corpus.py:zipf_corpus(8000,
   seed=29, lo=100, hi=800)``), each route's launches counted from 0 to its
   end, each route launching its kernels and no other: classic 50,000
   (``min_frequency=1``; K13 once, K14 a merge, the host's exact heap) and
   INL 32,000 (the reference's settings; the host's rebuild walk), each
   saved into a temporary directory byte for byte equal to
   ``.cache/bench_tokenizer_r4_50k.json`` (its warm-cache sidecar holding
   the tracked one's words and ids) and ``.cache/bench_inl_32k.json``;
   classic 4,096 (K13, then K15 -> K14 -> K16 a step on the card) and INL
   4,096 (windows), also with 96 candidates a window (the host ends each
   window), their merges the golden files' prefixes; the wall, merges per
   second and an estimate of the host's share.  Then K13-K16 against their
   plain versions on the card, bit for bit, on the classic route's initial
   rows and its state after 1,000 merges (the first 1,000 device-resident
   steps, equal to the golden file's), K14 also on
   ``utils/corpus.py:merge_edge_rows``; K15 in both modes; each timed warm,
   cold (K15's window: warm only) and plainly beside its bound and the
   library call (K13: ``index_add_``; K15: ``torch.argmax``).
   Then the WordPiece and Unigram trainers (``drive_train2``) on
   ``zipf_corpus(10_000, seed=17)`` and the multilingual pieces, each run's
   launches counted from 0 to its end: ``DistributedUnigramTrainer`` at
   t5-base's 32,000 pieces (JAX's defaults, every word its own text),
   byte for byte ``.cache/bench_unigram_32k.json``, launching K12 and K17
   once a device E-step and nothing else (each E-step's pieces, table
   build, copy, poisoned and over-wide sentences printed);
   ``DistributedWordPieceTrainer`` at bert-base-uncased's 30,522 (JAX's
   defaults), entry for entry ``.cache/bench_wordpiece_30k.json``,
   launching K18 and K19 once a round and nothing else, and at 400 on
   ``utils/corpus.py:wordpiece_train_edge_texts`` (words of 1, 13, 127, 128
   and 129 characters) equal to the host trainer's; the walls, rounds, poisoned
   words and the host's ms a round.  Then K12 against its plain version
   on every E-step's inputs (the first timed), K17 on every E-step's K12
   result and a crafted one (ids 0 and V - 1,
   fallbacks, poisoned texts), K18 and K19 on the 30,522 run's rounds 0,
   1,000, 10,000 and the last, the edge run's and its forged tables, bit for
   bit (K19 as a set); each timed warm, cold and plainly beside its bound
   and the library call (K17: ``index_add_``; K19: ``torch.unique`` then
   ``index_add_``).  K19 beside the K19 of commit 65588a4 (its source in
   ``scripts/pair_count_variants/parent_pair_count.cu``): the 30,522
   training again with that K19 and that commit's readback (its wall and
   ms a round against this route's), and once more with both K19s and both
   K18s (the K18 of commit c29595f, a thread a word:
   ``scripts/train_match_variants/parent_train_match.cu``) timed in turns
   every round (each summed over the run) and their inputs kept at rounds
   0, 1,000, 10,000 and the last, where each pair is checked against the
   plain version and timed warm and cold in turns (parent, this, this,
   parent).
   With ``--parent DIR`` (a checkout of an earlier commit): the kernels of
   it that ``scripts/parent_word_kernels.py`` knows, built beside the
   package's kernels, on the same rows, words and texts laid out as that
   commit laid them out, checked against these and timed in turns
   (parent, kernel, kernel, parent), and cold: the one-row-a-warp K8 and
   K11 of 86e566f to ef545a1 (K8: a zero-padded batch and a launch a
   length bucket), the first K12 of e635772 (a warp a text), and a
   commit's K4 launched plainly after this K6 (the fills in turns).
4. kernels: each kernel against its plain PyTorch version on the card, bit
   for bit, on the kept batches and packs of every shape.  At 50K: K1 also
   on random bytes (some OOV table entries) at ``[8192, 512]`` and
   ``[16, 4096]`` and on edge shapes (``seed_edge_batches``), timed warm,
   cold (``_time_cold_ms``: no call finds its own lines in L2) and at
   ``[1, 16]`` (its launch floor).  K21 (the pre-split) on the text
   pipeline's batches, on random bytes with random lengths at ``[16,
   4096]``, ``[8192, 128]`` and ``[8192, 512]`` (timed warm and cold
   beside its bytes bound, and its plain version, what the text pipeline
   ran before it, eagerly and replayed from a CUDA graph) and on
   ``utils/corpus.py:presplit_edge_rows`` at every bucket width; at 100K
   on that vocabulary's text batches.  K2 also on ``[16, 4096]`` rows filled
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
   rows; the fill also replayed from a CUDA graph (K4 is K6's programmatic
   dependent).  On the same packs, the phased fill at ``n1 = 6``
   (``check_phased``): K20 and K4's phased mode against their plain
   versions, the phased fill against its plain versions on the card and on
   the CPU, K20 and K4's phased mode timed warm, cold and plainly beside
   their bounds, and the phased and the unphased fill in turns.  Kernels and the library expression are timed by replaying a CUDA
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

The kernels' line lists K1-K22 and K4's phased mode (``launches_by_path``:
every path above; K22's is 0 on every path).
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


# int32 operations a valid column of the pre-split needs at the least: the
# lead byte's decode and class gather, the continuation check and the
# class's propagation, the absorbed, quote and contraction flags, the
# start and the running count (a column past the length needs none)
OPS_PER_PRESPLIT_COLUMN = 24


def _presplit_table_bytes(arr, lens, table) -> int:
    """Bytes of the class table that the valid columns' lead bytes look up:
    128 staged (the ASCII part) and one 32-byte sector per distinct sector
    of the other code points."""
    import torch

    B, L = arr.shape
    b = torch.nn.functional.pad(arr.int(), (0, 3))
    b0, b1, b2, b3 = (b[:, k:k + L] for k in range(4))
    cp = torch.where(b0 < 0xE0, ((b0 & 0x1F) << 6) | (b1 & 0x3F),
                     torch.where(b0 < 0xF0, ((b0 & 0x0F) << 12) | ((b1 & 0x3F) << 6) | (b2 & 0x3F),
                                 ((b0 & 0x07) << 18) | ((b1 & 0x3F) << 12) | ((b2 & 0x3F) << 6)
                                 | (b3 & 0x3F))).clamp(max=0x10FFFF)
    valid = torch.arange(L, device=arr.device)[None, :] < lens[:, None].long()
    lead = valid & (b0 >= 0xC0)
    return 128 + 32 * int(torch.unique(cp[lead] >> 5).numel())


def check_presplit(label: str, arr, lens, table, timed: bool = True) -> dict:
    """K21 against its plain version on ``arr``/``lens`` (on the card), bit
    for bit in all three outputs.  With ``timed``: the kernel warm and cold
    (``_time_cold_ms``), the plain version (what the text pipeline ran
    before K21) eagerly with CUDA events around its calls (``plain_ms``:
    its launches from the host included) and replayed from a CUDA graph
    (``plain_graph_ms``: its device time alone), and the bound: the bytes
    the valid columns need (each up to three bytes past it, within the
    row), the lengths, the class-table bytes their lead bytes look up, and
    the three outputs (6 B a column), against 24 operations a valid column
    (``OPS_PER_PRESPLIT_COLUMN``)."""
    import torch

    from complexity_tokenizer_tpu_torch.ops.presplit import (
        presplit,
        presplit_launch_shape,
        presplit_plain,
    )

    B, L = arr.shape
    got = presplit(arr, lens, table)
    exp = presplit_plain(arr, lens, table)
    torch.cuda.synchronize()
    err = max(_max_abs_err(g, e) for g, e in zip(got, exp))
    match = all(bool(torch.equal(g, e)) for g, e in zip(got, exp))
    n_valid = lens.long().clamp(0, L)
    print(f"[presplit] {label} [{B},{L}] match={match} max_abs_err={err} "
          f"valid columns {int(n_valid.sum())} starts {int(exp[0].sum())}", flush=True)
    if not match:
        raise AssertionError(f"presplit kernel differs from its plain version: {label} [{B},{L}]")
    res = dict(inputs=label, shape=[B, L], match=match, max_abs_err=err)
    if not timed:
        return res
    reps = 50 if B * L >= 1 << 20 else 200
    ms = _time_ms(lambda: presplit(arr, lens, table), reps)
    sets = _cold_sets((arr, lens), 6 * B * L)
    ms_cold = _time_cold_ms(lambda a, n: presplit(a, n, table), sets, reps)
    del sets
    plain_ms = _time_ms(lambda: presplit_plain(arr, lens, table), 5, graph=False)
    try:  # a measurement only: the plain version's ops may refuse capture
        plain_graph_ms = _time_ms(lambda: presplit_plain(arr, lens, table), 5)
    except RuntimeError as e:
        print(f"[presplit] {label}: the plain version does not replay from a CUDA graph: {e}")
        plain_graph_ms = None
    read = int(torch.where(n_valid > 0, (n_valid + 3).clamp(max=L), 0).sum())
    table_bytes = _presplit_table_bytes(arr, lens, table)
    bound_ms, bound_by = _bound(read + 4 * B + table_bytes + 6 * B * L,
                                OPS_PER_PRESPLIT_COLUMN * int(n_valid.sum()))
    shape = presplit_launch_shape(L)
    print(
        f"[presplit] {label} [{B},{L}] kernel warm={ms:.4f} ms cold={ms_cold:.4f} ms "
        f"plain={plain_ms:.4f} ms (graph replay {plain_graph_ms} ms) bound={bound_ms:.4f} ms "
        f"({bound_by}; {read} bytes read, {table_bytes} table bytes; cold share "
        f"{bound_ms / ms_cold:.3f}); launch {shape['threads']} threads, {shape['registers']} "
        f"registers, {shape['local_bytes']} B spilled a thread, {shape['static_smem']} B shared, "
        f"{shape['blocks_per_sm']} blocks per SM, {shape['row_warps']} warps a row",
        flush=True,
    )
    return dict(
        res, ms=ms, ms_cold=ms_cold, plain_ms=plain_ms, plain_graph_ms=plain_graph_ms,
        bound_ms=bound_ms, bound_by=bound_by, bound_share=bound_ms / ms_cold, library_ms=None,
        launch=shape,
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


def check_word_fill(label: str, tb, cpu_tb, a, bits, row_len, itemsize: int,
                    parent=None) -> tuple:
    """The word path's fill on one pack (on the card).  K6 (the merge from
    the packed bytes) against its plain version on the card and on the CPU
    and against K3 -> K1 -> the fixpoint (merged rows and counts); the fill
    (K6, then K4) against the four-launch chain (K3 -> K1 -> K2 or K5 ->
    K4) and its plain versions on the card and on the CPU, byte for byte on
    the fused buffer, at the compact capacity (3/8 of the lanes) and at
    full capacity; K3 and K4 against their plain versions.  K3, K4 and K6
    are timed warm and cold, the fill and the chain in turns (fill, chain,
    chain, fill) warm and cold at the compact capacity, the plain versions
    warm.  K4 is launched as K6's programmatic dependent: the fill is also
    captured in a CUDA graph and replayed into a buffer filled with junk,
    and checked again.  With ``parent`` (``scripts/parent_word_kernels.py``)
    the earlier K4, launched plainly after this K6, is checked against the
    fill and the two fills are timed in turns, warm.  K6's bound counts the
    pack's bytes, start bits, lengths and byte table in, the merged rows and
    counts out and the table bytes its probes touch, once each.  Returns
    (K3, K4, K6 results)."""
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
    # the fill captured in a graph (K4 a programmatic dependent of K6 there
    # too) and replayed into junk
    fill_ref = fill_fn(a, bits, row_len)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = fill_fn(a, bits, row_len)
    replayed.fill_(0xA5)
    graph.replay()
    torch.cuda.synchronize()
    if not torch.equal(replayed, fill_ref):
        raise AssertionError(f"the fill replayed from a CUDA graph differs: {label} [{B},{W}]")
    del graph
    parent_fill = {}
    if parent is not None and parent.has("fill_compact"):
        def parent_fill_fn(x, y, z):
            return parent.fill_compact(*word_merge(x, y, z, tables=tb), cap, itemsize)

        if not torch.equal(parent_fill_fn(a, bits, row_len), fill_ref):
            raise AssertionError(f"the parent's K4 after K6 differs from the fill: {label}")
        turns_ms, parent_ms = _in_turns(lambda: fill_fn(a, bits, row_len),
                                        lambda: parent_fill_fn(a, bits, row_len), 50)
        parent_fill = dict(fill_ms_in_turns=turns_ms, parent_fill_ms=parent_ms)
        print(f"[word_fill] {label} [{B},{W}] K6 then the parent's K4 (a plain launch) match=True: "
              f"in turns parent {parent_ms[0]:.4f} ms, fill {turns_ms[0]:.4f}, {turns_ms[1]:.4f}, "
              f"parent {parent_ms[1]:.4f}", flush=True)
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
             itemsize=itemsize, **parent_fill),
    )


PHASE_N1 = 6  # the phased fill's steps before its compaction (CTOK_PHASE_N1)


def check_phased(label: str, tb, cpu_tb, a, bits, row_len, itemsize: int) -> tuple:
    """The phased fill on one pack (on the card), at ``PHASE_N1`` steps:
    K20 (block-flat word ids, the seed, the JAX steps, the half-row
    compaction) against its plain version on the card, bit for bit (tokens,
    word ids, kept lanes); K4's phased mode on the fixpoint's rows against
    its plain version; the phased fill (K20, K2 or K5, K4's phased mode)
    against its plain versions on the card and on the CPU, byte for byte.
    K20 and K4's phased mode timed warm, cold and plainly; the phased and
    the unphased fill (K6, K4) in turns, warm.  K20's bound counts the
    pack's bytes, start bits, lengths and byte table in, the half rows
    (tokens and word ids) and kept lanes out, and the table bytes its
    first phase's probes touch (every adjacent pair of a word once and the
    two new pairs of each merge it makes), once each.  Returns (K20, K4
    phased mode) results."""
    import torch

    from complexity_tokenizer_tpu_torch.ops.merge import segmented_fixpoint_bounded_plain
    from complexity_tokenizer_tpu_torch.ops.seed import seed_tokens_plain
    from complexity_tokenizer_tpu_torch.ops.wordfill import (
        block_word_ids_plain,
        fill_compact_phased,
        fill_compact_phased_plain,
        fill_layout_phased,
        phase_compact,
        phase_compact_plain,
        word_fill,
        word_fill_phased,
        word_fill_phased_plain,
    )

    B, W = a.shape
    cap = B * W * 3 // 8
    n1 = PHASE_N1
    got = phase_compact(a, bits, row_len, n1, tables=tb)
    exp = phase_compact_plain(a, bits, row_len, n1, tables=tb)
    torch.cuda.synchronize()
    match20 = all(torch.equal(g, e) for g, e in zip(got, exp))
    err20 = max(_max_abs_err(g, e) for g, e in zip(got, exp))
    t2, w2, kept = got
    merged, count = tb.merge_fixpoint(t2, w2)
    got4 = fill_compact_phased(merged, count, w2, kept, cap, itemsize)
    exp4 = fill_compact_phased_plain(merged, count, w2, kept, cap, itemsize)
    match4 = bool(torch.equal(got4, exp4))
    err4 = _max_abs_err(got4, exp4)
    fill = word_fill_phased(a, bits, row_len, cap, n1, tables=tb, itemsize=itemsize)
    plain = word_fill_phased_plain(a, bits, row_len, cap, n1, tables=tb, itemsize=itemsize)
    cpu = word_fill_phased(a.cpu(), bits.cpu(), row_len.cpu(), cap, n1, tables=cpu_tb,
                           itemsize=itemsize)
    torch.cuda.synchronize()
    match_fill = bool(torch.equal(fill, plain) and torch.equal(fill.cpu(), cpu))
    total = int(fill[-4:].cpu().numpy().view("int32")[0])
    spilled = bool((kept > W // 2).any())
    print(
        f"[phased] {label} [{B},{W}] n1={n1}: K20 == plain (card) {match20}; K4 phased mode == "
        f"plain {match4}; phased fill (K20 + fixpoint + K4 phased) == plain (card) == plain (CPU) "
        f"{match_fill}; rows kept up to {int(kept.max())} of {W} lanes "
        f"({'spills: B*W + 1 in the total' if spilled else 'fits'}), total {total}",
        flush=True,
    )
    if not (match20 and match4 and match_fill):
        raise AssertionError(f"the phased fill's kernels differ from their plain versions: "
                             f"{label} [{B},{W}]")
    reps = 50
    out20 = 4 * B * W + 4 * B
    k20_ms, k20_cold, k20_plain = _timings(
        lambda: phase_compact(a, bits, row_len, n1, tables=tb),
        lambda: phase_compact_plain(a, bits, row_len, n1, tables=tb),
        lambda x, y, z: phase_compact(x, y, z, n1, tables=tb), (a, bits, row_len), out20,
    )
    out4 = fill_layout_phased(B, W, cap, itemsize)[3]
    k4_ms, k4_cold, k4_plain = _timings(
        lambda: fill_compact_phased(merged, count, w2, kept, cap, itemsize),
        lambda: fill_compact_phased_plain(merged, count, w2, kept, cap, itemsize),
        lambda m, c, w, k: fill_compact_phased(m, c, w, k, cap, itemsize),
        (merged, count, w2, kept), out4,
    )
    phased_ms, unphased_ms = _in_turns(
        lambda: word_fill_phased(a, bits, row_len, cap, n1, tables=tb, itemsize=itemsize),
        lambda: word_fill(a, bits, row_len, cap, tables=tb, itemsize=itemsize), reps)
    # the first phase's probes: every adjacent pair of a word, and the two
    # new pairs of each merge the n1 steps make
    tokens = seed_tokens_plain(a, row_len, tb.byte_token_table)
    wid = block_word_ids_plain(bits, row_len)
    after = segmented_fixpoint_bounded_plain(tokens, wid, tb.pair_lookup, n1)
    table = "qc" if tb.qc_t1 is not None else "chd"
    probes, merges, table_bytes, ops = _probe_work(
        tb, table, tokens, wid, (after >= 0).sum(dim=1, dtype=torch.int32))
    b20, by20 = _bound(B * W + B * W // 8 + 4 * B + 4 * 256 + out20 + table_bytes, ops)
    b4, by4 = _bound(4 * B * W + 2 * B + 4 * B + out4, B * W // 2)
    print(
        f"[phased] {label} [{B},{W}] K20 warm={k20_ms:.4f} ms cold={k20_cold:.4f} ms "
        f"plain={k20_plain:.4f} ms bound={b20:.4f} ms ({by20}; {probes} probes, {merges} merges "
        f"in {n1} steps; warm share {b20 / k20_ms:.3f}); K4 phased mode warm={k4_ms:.4f} ms "
        f"cold={k4_cold:.4f} ms plain={k4_plain:.4f} ms bound={b4:.4f} ms ({by4}); in turns the "
        f"phased fill {phased_ms[0]:.4f}, {phased_ms[1]:.4f} ms against the unphased fill (K6 + "
        f"K4) {unphased_ms[0]:.4f}, {unphased_ms[1]:.4f} ms",
        flush=True,
    )
    common = dict(inputs=label, shape=[B, W], library_ms=None, n1=n1, spilled=spilled)
    return (
        dict(common, match=match20 and match_fill, max_abs_err=err20, ms=k20_ms, ms_cold=k20_cold,
             plain_ms=k20_plain, bound_ms=b20, bound_by=by20, probes=probes, merges=merges,
             kept_max=int(kept.max()), phased_fill_ms=phased_ms, unphased_fill_ms=unphased_ms),
        dict(common, match=match4, max_abs_err=err4, ms=k4_ms, ms_cold=k4_cold,
             plain_ms=k4_plain, bound_ms=b4, bound_by=by4, cap=cap, itemsize=itemsize),
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


# the fill variants of drive_shards: (name, mesh or None, CTOK_PHASE_N1)
FILL_VARIANTS = (
    ("unsharded", None, 0),
    ("one block", ["cuda:0"], 0),
    ("two blocks", ["cuda:0", "cuda:0"], 0),
    ("phased", None, 6),
    ("phased, two blocks", ["cuda:0", "cuda:0"], 6),
)


def drive_shards(label: str, r: dict, texts: list[str], kernels_of: dict, native) -> dict:
    """The sharded and the phased fill on one configuration: every distinct
    word of the corpus (the words of drive_paths' "every distinct word")
    through ``DeviceWordEncoder._encode_words_packed`` on a fresh native
    context, in each of ``FILL_VARIANTS``: unsharded, sharded over
    ``[cuda:0]`` (one block) and over ``[cuda:0, cuda:0]`` (two blocks on
    two streams, ``parallel.shard_word_encoder``), phased
    (``CTOK_PHASE_N1=6``: K20, the fixpoint, K4's phased mode; a spilled
    pack again through K6 and K4) and phased over two blocks.  Two rounds
    in turns; the launch counts set to 0 just before each call and read
    just after.  Every variant's ids and counts equal the unsharded fill's
    and the host merge's bit for bit; each launches its kernels and no
    other.  Then the text pipeline split over ``[cuda:0, cuda:0]``
    (``parallel.shard_encode_pipeline``) against the host oracle.  Prints
    each variant's wall on a line of its own.  Returns the launches by
    path, the walls and the per-variant fill statistics."""
    import numpy as np
    import torch

    from complexity_tokenizer_tpu_torch.ops.pipeline import build_encode_pipeline
    from complexity_tokenizer_tpu_torch.ops.tables import byte_token_table
    from complexity_tokenizer_tpu_torch.ops.wordpath import DeviceWordEncoder
    from complexity_tokenizer_tpu_torch.parallel import (
        data_mesh,
        shard_encode_pipeline,
        shard_word_encoder,
    )

    t0 = time.perf_counter()
    tok, pipe = r["tok"], r["pipe"]
    fixpoint = "merge_fixpoint_qc" if pipe.tables.qc_t1 is not None else "merge_fixpoint_chd"

    def fresh_native():
        return native.NativeEncoder(tok.bpe.packed_merge_arrays(), byte_token_table(tok.bpe.vocab))

    data = tok._prepare_bytes([tok._normalize(t) for t in texts])
    words, lens = fresh_native().collect_miss_words(data, 128)
    exp_ids, exp_counts = fresh_native().warm_start(words, lens)
    encoders = {}
    for name, mesh, n1 in FILL_VARIANTS:
        saved = os.environ.get("CTOK_PHASE_N1")
        os.environ["CTOK_PHASE_N1"] = str(n1)
        try:
            wp = DeviceWordEncoder(pipe, fresh_native())
            if wp._phase_n1 != n1:
                raise AssertionError(f"[{label}] CTOK_PHASE_N1={n1} read as {wp._phase_n1}")
        finally:
            if saved is None:
                del os.environ["CTOK_PHASE_N1"]
            else:
                os.environ["CTOK_PHASE_N1"] = saved
        if mesh is not None:
            shard_word_encoder(wp, data_mesh(devices=mesh))
        encoders[name] = wp
    launches: dict = {}
    walls: dict = {name: [] for name, _m, _n in FILL_VARIANTS}
    stats: dict = {}
    for rnd in range(2):
        for name, mesh, n1 in FILL_VARIANTS:
            wp = encoders[name]
            (ids, counts), counts_l, wall = _drive_launches(
                kernels_of, lambda wp=wp: wp._encode_words_packed(words, lens))
            walls[name].append(wall)
            fill = wp.last_fill
            path = f"{label} every distinct word, {name}"
            if not (np.array_equal(counts, exp_counts) and np.array_equal(ids, exp_ids)):
                bad = int((counts != exp_counts).sum())
                raise AssertionError(f"[{path}] ids or counts differ from the unsharded fill "
                                     f"and the host merge ({bad} counts differ)")
            packs, blocks = sum(fill["packs"].values()), fill["blocks"]
            if n1 == 0:
                need = {"word_merge": (packs + fill["spills"]) * blocks,
                        "fill_compact": (packs + fill["spills"]) * blocks}
            else:
                # a pack's blocks each go through K20, the fixpoint and K4's
                # phased mode; a spilled pack again unphased through K6, K4
                need = {"phase_compact": packs * blocks, fixpoint: packs * blocks,
                        "fill_compact_phased": packs * blocks,
                        "word_merge": fill["spills"] * blocks,
                        "fill_compact": fill["spills"] * blocks}
            _need_only(path, counts_l, {k: v for k, v in need.items() if v})
            if rnd == 0:
                launches[path] = counts_l
                stats[name] = dict(packs=dict(sorted(fill["packs"].items())),
                                   spills=fill["spills"], blocks=fill["blocks"],
                                   phase_n1=fill["phase_n1"])
    for name, _mesh, _n1 in FILL_VARIANTS:
        st = stats[name]
        print(
            f"[{label}] fill wall, {name}: {walls[name][0]:.4f} s first, {walls[name][1]:.4f} s "
            f"second ({len(lens)} words; packs {st['packs']}, blocks {st['blocks']}, "
            f"CTOK_PHASE_N1={st['phase_n1']}, spills {st['spills']}); ids and counts equal the "
            f"unsharded fill and the host merge",
            flush=True,
        )
    # the text pipeline over two blocks on one card
    sp = build_encode_pipeline(tok, "cuda")
    shard_encode_pipeline(sp, data_mesh(devices=["cuda:0", "cuda:0"]))
    got, counts_l, wall = _drive_launches(kernels_of, lambda: text_pipeline_encode(tok, sp, texts))
    _compare(f"[{label}] text pipeline, two blocks", texts, got, r["host"])
    _need_only(f"{label} text pipeline, two blocks", counts_l,
               {"presplit": None, "seed_tokens": None, fixpoint: None})
    if (not counts_l["presplit"] == counts_l["seed_tokens"] == counts_l[fixpoint]
            or counts_l["seed_tokens"] % 2):
        raise AssertionError(f"[{label}] the two-block text pipeline launched K21, K1 and the "
                             f"fixpoint {counts_l['presplit']} / {counts_l['seed_tokens']} / "
                             f"{counts_l[fixpoint]} times")
    launches[f"{label} text pipeline, two blocks"] = counts_l
    print(f"[{label}] text pipeline over [cuda:0, cuda:0]: {wall:.3f} s, equal to the host oracle; "
          f"launches {counts_l}", flush=True)
    _phase(f"{label}: sharded and phased fills", t0)
    return dict(launches=launches, walls=walls, stats=stats, text_two_blocks_s=wall)


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


def check_norm(label: str, rows: list[bytes], bitmap, sectors: int, timed: bool = True,
               parent=None) -> dict:
    """K8 against its plain version on byte rows, all in one launch, as
    ``DeviceNormChecker.check_bytes`` packs them (``pack_norm_rows``); with
    ``timed``, timed warm, cold and plain.  The bound counts the rows' bytes,
    their offsets, the block index and one flag a row, and ``sectors``
    32-byte sectors of the bitmap (those the rows' codepoints land in), each
    once.  With ``parent`` (``scripts/parent_word_kernels.py``) the earlier
    one-warp-a-row K8 runs on the same rows as that commit laid them out
    (one zero-padded batch a length bucket, a launch each), is checked
    against this one and the two are timed in turns, warm, and the parent
    cold."""
    import torch

    from complexity_tokenizer_tpu_torch.ops.normalize_device import (
        norm_launch_shape,
        norm_stable_rows,
        norm_stable_rows_ragged_plain,
        pack_norm_rows,
    )

    data, offs, blocks, stable = pack_norm_rows(rows, "cuda")
    B, T = offs.numel() - 1, blocks.numel() - 1
    N = sum(map(len, rows))
    got = norm_stable_rows(data, offs, blocks, bitmap, stable)
    torch.cuda.synchronize()
    exp = norm_stable_rows_ragged_plain(data, offs, bitmap)
    match = bool(torch.equal(got, exp))
    err = _max_abs_err(got.int(), exp.int())
    if not match:
        raise AssertionError(f"K8 differs from its plain version: {label} ({B} rows)")
    res = dict(inputs=label, shape=[N, B], match=match, max_abs_err=err, stable=int(exp.sum()))
    if not timed:
        print(f"[norm_check] {label}: {B} rows, {N} bytes, {T} blocks, match={match}; stable "
              f"rows {res['stable']}/{B}", flush=True)
        return res
    ms, ms_cold, plain_ms = _timings(
        lambda: norm_stable_rows(data, offs, blocks, bitmap, stable),
        lambda: norm_stable_rows_ragged_plain(data, offs, bitmap),
        lambda d, o, b, f: norm_stable_rows(d, o, b, bitmap, f), (data, offs, blocks, stable), 0)
    bound_ms, bound_by = _bound(N + 4 * (B + 1) + 4 * (T + 1) + B + 32 * sectors, N * 4)
    launch = norm_launch_shape()
    print(f"[norm_check] {label} [{N} bytes, {B} rows, {T} blocks] match={match} max_abs_err={err} "
          f"kernel={ms:.4f} ms cold={ms_cold:.4f} ms plain={plain_ms:.4f} ms bound={bound_ms:.4f} "
          f"ms ({bound_by}; {sectors} bitmap sectors); stable rows {res['stable']}/{B} "
          f"launch={launch}", flush=True)
    res.update(ms=ms, ms_cold=ms_cold, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
               library_ms=None, blocks=T, launch=launch)
    if parent is not None and parent.has("norm_check"):
        res.update(_parent_norm(label, rows, bitmap, parent, exp,
                                lambda: norm_stable_rows(data, offs, blocks, bitmap, stable)))
    return res


def _parent_norm(label: str, rows: list[bytes], bitmap, parent, exp, kernel) -> dict:
    """The earlier K8 on ``rows`` in its batches (``bucket_rows``: a launch
    a length bucket), its flags against this kernel's ``exp``, the two timed
    in turns; the parent also cold."""
    import torch

    from complexity_tokenizer_tpu_torch.ops.pipeline import _LENGTH_BUCKETS

    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from parent_word_kernels import bucket_rows

    batches = [(idxs, torch.from_numpy(a).cuda(), torch.from_numpy(n).cuda())
               for idxs, a, n in bucket_rows(rows, _LENGTH_BUCKETS)]

    def pfn(*tensors):
        return [parent.norm_check(a, n, bitmap) for a, n in zip(tensors[::2], tensors[1::2])]

    tensors = tuple(t for _, a, n in batches for t in (a, n))
    got = pfn(*tensors)
    torch.cuda.synchronize()
    flags = torch.empty_like(exp)
    for (idxs, _, _), g in zip(batches, got):
        flags[torch.tensor(idxs, device="cuda")] = g
    if sum(len(b[0]) for b in batches) != exp.numel() or not torch.equal(flags, exp):
        raise AssertionError(f"the parent's K8 differs from this one's: {label}")
    turns_ms, parent_ms = _in_turns(kernel, lambda: pfn(*tensors))
    sets = _cold_sets(tensors, exp.numel())
    parent_cold = _time_cold_ms(pfn, sets, 20)
    del sets
    shapes = [list(a.shape) for _, a, _ in batches]
    print(f"[norm_check] {label} parent (a warp a row, a launch a bucket: {shapes}) match=True: in "
          f"turns parent {parent_ms[0]:.4f} ms, kernel {turns_ms[0]:.4f}, {turns_ms[1]:.4f}, "
          f"parent {parent_ms[1]:.4f}; parent cold {parent_cold:.4f} ms", flush=True)
    return dict(parent_ms=parent_ms, parent_ms_cold=parent_cold, ms_in_turns=turns_ms,
                parent_shapes=shapes)


def drive_norm(texts: list[str], host: list[list[int]], kernels_of: dict, parent=None) -> dict:
    """The text pipeline with its normalization check, at 50K (NFC):
    ``EncodePipeline.encode_batch(texts)`` from a fresh tokenizer, whose rows
    K8 proves stable skip the host rewrite, against the host oracle, with
    the launch counts set to 0 just before and read just after (K8 once, K1
    and K2, no other); then K8 against its plain version on that run's rows
    (every row up to the widest length bucket, one launch), under the NFC
    plan and under ``BertNormalizer()``'s, timed (and beside ``parent``'s
    K8, when given); and, untimed, on ``norm_edge_rows`` under both and
    the trap bitmap."""
    import torch

    from complexity_tokenizer_tpu_torch.core.normalizers import BertNormalizer
    from complexity_tokenizer_tpu_torch.ops.normalize_device import (
        NORM_SPAN,
        norm_stable_rows,
        pack_norm_rows,
        plan_for_normalizer,
    )
    from complexity_tokenizer_tpu_torch.ops.pipeline import _LENGTH_BUCKETS
    from complexity_tokenizer_tpu_torch.tokenizer import Tokenizer
    from complexity_tokenizer_tpu_torch.utils.corpus import norm_edge_rows, norm_trap_bitmap

    t0 = time.perf_counter()
    tok = Tokenizer.from_file(TOKENIZER_JSON)
    pipe = tok.pipeline("cuda")
    t1 = time.perf_counter()
    checker = pipe._norm_checker  # the NFC bitmap: built and on the card
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t1
    got, counts, wall = _drive_launches(kernels_of, lambda: pipe.encode_batch(texts))
    _need_only("the 50K text pipeline with K8", counts,
               {"norm_stable_rows": 1, "presplit": None, "seed_tokens": None,
                "merge_fixpoint_qc": None})
    if not counts["presplit"] == counts["seed_tokens"] == counts["merge_fixpoint_qc"]:
        raise AssertionError(f"K21, K1 and K2 launched unequally on the 50K text pipeline with "
                             f"K8: {counts}")
    # the texts that may hold an added token go to the oracle on the
    # Tokenizer's own routes; EncodePipeline.encode_batch has no scan
    flags = tok._added_route_flags(tok._prepare_bytes([tok._normalize(t) for t in texts]))
    keep = [i for i in range(len(texts)) if flags is None or not flags[i]]
    _compare("[50K] EncodePipeline.encode_batch (K8, NFC)", [texts[i] for i in keep],
             [got[i] for i in keep], [host[i] for i in keep])
    raw = [t.encode("utf-8") for t in texts]
    clean = checker.check_bytes(raw, _LENGTH_BUCKETS)
    max_L = _LENGTH_BUCKETS[-1]
    sent = [i for i, d in enumerate(raw) if 0 < len(d) <= max_L]
    rows = [raw[i] for i in sent]
    print(f"[50K] EncodePipeline.encode_batch (K8, NFC): {len(texts)} texts, {len(keep)} against the "
          f"oracle (the others may hold an added token), 0 mismatches; NFC bitmap built and to the "
          f"card {setup_s:.3f} s; wall {wall:.3f} s; rows proven stable {int(clean.sum())}, "
          f"normalized on the host {int((~clean).sum())} ({sum(len(d) > max_L for d in raw)} over "
          f"the widest bucket); rows checked in one launch {len(rows)} ({sum(map(len, rows))} "
          f"bytes); launches {counts}", flush=True)
    bert = torch.from_numpy(plan_for_normalizer(BertNormalizer()).bitmap).cuda()
    trap = torch.from_numpy(norm_trap_bitmap()).cuda()
    sectors = len({ord(c) >> 5 for i in sent for c in texts[i]})
    results = [check_norm("corpus rows, NFC", rows, checker.bitmap, sectors, parent=parent),
               check_norm("corpus rows, BertNormalizer", rows, bert, sectors, parent=parent)]
    text = " ".join(texts[:200]).encode()
    for label, edge in norm_edge_rows(text, NORM_SPAN):
        for name, bm in (("NFC", checker.bitmap), ("BertNormalizer", bert), ("trap", trap)):
            r = check_norm(f"edge, {label}, {name}", edge, bm, 0, timed=False)
            results.append(r)
            if label == "truncated leads" and name == "trap":
                # the cut-off leads decode with zeros past their rows' ends
                stable = norm_stable_rows(*pack_norm_rows(edge, "cuda")[:3], trap).cpu().numpy()
                if not (stable[0::4].all() and not stable[3::4].any()):
                    raise AssertionError("K8 read a truncated lead's tail from the next row")
    _phase("50K: text pipeline with K8", t0)
    return dict(launches={"50K EncodePipeline.encode_batch (NFC)": counts}, checks=results)


def _symbol_probe_work(syms, offs, count, disp, rows) -> tuple:
    """As _probe_work, over ragged words: every initial adjacent pair of a
    word probed once and two probes a merge.  (probes, merges, table bytes,
    operations)."""
    import torch.nn.functional as F

    csum = F.pad((syms >= 0).int().cumsum(0), (1, 0))
    live = csum[offs[1:].long()] - csum[offs[:-1].long()]
    pairs = int((live - 1).clamp(min=0).sum())
    merges = int(live.sum()) - int(count.sum())
    probes = pairs + 2 * merges
    return (probes, merges, min(probes * 20, 4 * (disp.numel() + rows.numel())),
            probes * OPS_PER_PROBE_CHD)


# K9's tile sizes (symbols a tile) timed beside the package's TILE_SYMBOLS
TILE_SWEEP = (256, 384, 640, 896, 1408, 1920)


def _in_turns(kernel, parent, reps: int = 20) -> tuple[list, list]:
    """Warm ms of ``parent`` and ``kernel`` in turns: parent, kernel,
    kernel, parent."""
    p0, k0, k1, p1 = (_time_ms(f, reps) for f in (parent, kernel, kernel, parent))
    return [k0, k1], [p0, p1]


def check_word_rows_qc(label: str, model, tier, sym_rows) -> dict:
    """K22 (K9's fixpoint on the u16 cuckoo table) against its plain version
    and against K9, bit for bit, on the ragged words ``sym_rows`` as the
    model's tier packs them, over the cuckoo table of the same symbol ids
    (``ops/stringbpe_device.py:string_qc_table``); timed warm, cold and
    plain beside K9 on the same words, with the bound of K9's ragged form
    (the live symbols in, offsets, an id a symbol and a count a word out,
    and the probes' table bytes: two 8-byte cuckoo rows a probe, at most
    the whole table).  No path launches K22."""
    import numpy as np
    import torch

    from complexity_tokenizer_tpu_torch.ops.merge import (
        TILE_SYMBOLS,
        WORD_LANES,
        launch_shape,
        merge_word_rows,
        merge_word_rows_qc,
        merge_word_rows_qc_ragged_plain,
        word_tiles,
    )
    from complexity_tokenizer_tpu_torch.ops.stringbpe_device import string_qc_table

    qc = string_qc_table(model.merge_ranks)
    if qc is None:
        raise AssertionError(f"[{label}] the merge table does not fit the u16 cuckoo table")
    on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()  # noqa: E731
    t1, t2 = on(qc.t1.view(np.int32)), on(qc.t2.view(np.int32))
    syms_np, offs_np = tier.pack(sym_rows)[:2]
    syms, offs, tiles = on(syms_np), on(offs_np), on(word_tiles(offs_np, TILE_SYMBOLS))
    args = (t1, t2, qc.size)
    k9_args = (tier.disp, tier.rows, tier.chd.size, tier.chd.n_buckets)
    got = merge_word_rows_qc(syms, offs, tiles, *args)
    exp = merge_word_rows_qc_ragged_plain(syms, offs, *args)
    k9 = merge_word_rows(syms, offs, tiles, *k9_args)
    torch.cuda.synchronize()
    err = max(_max_abs_err(got[0], exp[0]), _max_abs_err(got[1], exp[1]))
    match = bool(torch.equal(got[0], exp[0]) and torch.equal(got[1], exp[1]))
    equals_k9 = bool(torch.equal(got[0], k9[0]) and torch.equal(got[1], k9[1]))
    B, N = offs.numel() - 1, syms.numel()
    ms = _time_ms(lambda: merge_word_rows_qc(syms, offs, tiles, *args), 20)
    sets = _cold_sets((syms, offs, tiles), 4 * N + 4 * B)
    ms_cold = _time_cold_ms(lambda s_, o_, t_: merge_word_rows_qc(s_, o_, t_, *args), sets, 20)
    del sets
    k9_ms = _time_ms(lambda: merge_word_rows(syms, offs, tiles, *k9_args), 20)
    plain_ms = _time_ms(lambda: merge_word_rows_qc_ragged_plain(syms, offs, *args), 2,
                        graph=False)
    probes, merges = _symbol_probe_work(syms, offs, exp[1], tier.disp, tier.rows)[:2]
    table_bytes = min(probes * 16, 2 * t1.numel() * 4)
    bound_ms, bound_by = _bound(4 * int((syms >= 0).sum()) + 4 * (B + 1) + 4 * N + 4 * B
                                + table_bytes, probes * OPS_PER_PROBE)
    shape = launch_shape(TILE_SYMBOLS + WORD_LANES - 1, chd=False, ragged=True)
    print(
        f"[merge_word_rows_qc] {label} {N} symbols, {B} words, {tiles.numel() - 1} tiles: "
        f"match={match} max_abs_err={err} equals K9={equals_k9} kernel warm={ms:.4f} ms "
        f"cold={ms_cold:.4f} ms (K9 on the same words {k9_ms:.4f} ms) plain={plain_ms:.4f} ms "
        f"bound={bound_ms:.4f} ms ({bound_by}; {probes} probes, {merges} merges); launch "
        f"{shape['threads']} threads, {shape['registers']} registers, {shape['local_bytes']} B "
        f"spilled a thread, shared {shape['static_smem']} + {shape['dynamic_smem']} B a block, "
        f"{shape['blocks_per_sm']} blocks per SM",
        flush=True,
    )
    if not match:
        raise AssertionError(f"merge_word_rows_qc kernel differs from its plain version: {label}")
    if not equals_k9:
        raise AssertionError(f"K22 differs from K9 on the same words: {label}")
    return dict(inputs=label, shape=[N, B], match=match, max_abs_err=err, equals_k9=equals_k9,
                ms=ms, ms_cold=ms_cold, k9_ms=k9_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None, probes=probes, merges=merges, launch=shape)


def check_model_kernel(label: str, name: str, tier, words: list[str], sym_rows=None,
                       parent=None, edge=None) -> dict:
    """The kernel of a model's tier (K9, K10, K11 or K12) against its plain
    version on the main path's input (the batch's distinct words, or
    Unigram's distinct pieces, packed by the tier: ragged), timed warm, cold
    and plain, with its bound.  The bound counts the live input only (each
    word's symbols or characters, and its offset and length; a WordPiece
    word over its limit needs its length alone), the outputs (K9 and K10: an
    id a live position, a count a word, K10's poison flags; K11: an id a
    word; K12: an id a character, a count and a flag a piece) and the table
    bytes the probes touch (K11: also the lengths and characters its exact
    checks read; K12: the CHD entries its probes touch, and the lengths,
    scores and characters of the pieces on the chosen paths, which every
    check reads), each once; ``dense_bound_ms`` the same with the [B, 128] output
    the dense K9 and K10 wrote, or the [B, 128] input the dense K11 read.
    K9 is also timed at every tile size of ``TILE_SWEEP`` (each checked),
    K10's and K11's words counted by lane group, K11 also checked with
    every word in groups of 8 and every word a warp.  With ``parent``
    (``scripts/parent_word_kernels.py``) the earlier one-word-a-row K11
    runs on the same words as its tier laid them out, is checked against
    this kernel's result, and the two are timed in turns, warm, and the
    parent cold.  K12 is also checked on ``edge`` ((case, texts) pairs) and,
    on the main input and the edges, with ``maxcand`` 3 (under the longest
    piece) and 16 and the fallback marker -2, and with every text a warp and
    every text in a group of 8; with ``parent``, the first K12 (a warp a
    text) is checked and timed the same way on the main input."""
    import numpy as np
    import torch

    from complexity_tokenizer_tpu_torch.ops.merge import (
        TILE_SYMBOLS,
        WORD_LANES,
        launch_shape,
        merge_word_rows,
        merge_word_rows_ragged_plain,
        word_tiles,
    )
    from complexity_tokenizer_tpu_torch.ops.wordpiece_device import (
        wordlevel_launch_shape,
        wordlevel_lookup,
        wordlevel_lookup_ragged_plain,
        wordpiece_launch_shape,
        wordpiece_match,
        wordpiece_match_ragged_plain,
    )
    from complexity_tokenizer_tpu_torch.ops.unigram_device import (
        FALLBACK_ID,
        split_viterbi,
        viterbi,
        viterbi_launch_shape,
        viterbi_ragged_plain,
    )

    table_bytes_all = 4 * (tier.disp.numel() + tier.rows.numel())
    on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()  # noqa: E731
    extra_out: dict = {}
    if name == "merge_word_rows":
        syms_np, offs_np = tier.pack(sym_rows)[:2]
        syms, offs = on(syms_np), on(offs_np)
        args = (tier.disp, tier.rows, tier.chd.size, tier.chd.n_buckets)
        tiles = on(word_tiles(offs_np, TILE_SYMBOLS))
        kernel = lambda: merge_word_rows(syms, offs, tiles, *args)  # noqa: E731
        plain = lambda: merge_word_rows_ragged_plain(syms, offs, *args)  # noqa: E731
        cold_fn, inputs = (lambda s, o, t: merge_word_rows(s, o, t, *args)), (syms, offs, tiles)
        B, N = offs.numel() - 1, syms.numel()
        out_bytes = 4 * N + 4 * B
        shape = [N, B]
    elif name == "wordpiece_match":
        chars_np, offs_np, lens_np, order, groups, _host = tier.pack(words)
        chars, offs, lens = on(chars_np), on(offs_np), on(lens_np)
        mi = tier.t.max_input_chars
        kernel = lambda: wordpiece_match(chars, offs, lens, groups, *tier.args(), mi)  # noqa: E731
        plain = lambda: wordpiece_match_ragged_plain(chars, offs, lens, *tier.args(), mi)  # noqa: E731
        cold_fn = lambda c, o, n: wordpiece_match(c, o, n, groups, *tier.args(), mi)  # noqa: E731
        inputs = (chars, offs, lens)
        B, N = lens.numel(), chars.numel()
        out_bytes = 4 * N + 5 * B
        shape = [N, B]
    elif name == "viterbi":
        chars_np, offs_np, lens_np, order, groups, _host = tier.pack(words)
        chars, offs, lens = on(chars_np), on(offs_np), on(lens_np)
        kernel = lambda: viterbi(chars, offs, lens, groups, *tier.args())  # noqa: E731
        plain = lambda: viterbi_ragged_plain(chars, offs, lens, *tier.args())  # noqa: E731
        cold_fn = lambda c, o, n: viterbi(c, o, n, groups, *tier.args())  # noqa: E731
        inputs = (chars, offs, lens)
        B, N = lens.numel(), chars.numel()
        out_bytes = 4 * N + 8 * B
        shape = [N, B]
    else:
        chars_np, offs_np, lens_np, order, groups, _host = tier.pack(words)
        chars, offs, lens = on(chars_np), on(offs_np), on(lens_np)
        kernel = lambda: wordlevel_lookup(chars, offs, lens, groups, *tier.args())  # noqa: E731
        plain = lambda: wordlevel_lookup_ragged_plain(chars, offs, lens, *tier.args())  # noqa: E731
        cold_fn = lambda c, o, n: wordlevel_lookup(c, o, n, groups, *tier.args())  # noqa: E731
        inputs = (chars, offs, lens)
        B, N = lens.numel(), chars.numel()
        out_bytes = 4 * B
        shape = [N, B]
    got = kernel()
    torch.cuda.synchronize()
    exp = plain()
    got_t = got if isinstance(got, tuple) else (got,)
    exp_t = exp if isinstance(exp, tuple) else (exp,)
    match = all(torch.equal(a, b) for a, b in zip(got_t, exp_t))
    err = max(_max_abs_err(a.long(), b.long()) for a, b in zip(got_t, exp_t))
    if not match:
        raise AssertionError(f"{name} differs from its plain version: {label}")
    ms, ms_cold, plain_ms = _timings(kernel, plain, cold_fn, inputs, out_bytes)
    if name == "merge_word_rows":
        live = int((syms >= 0).sum())
        probes, merges, tbytes, ops = _symbol_probe_work(syms, offs, exp_t[1], tier.disp,
                                                         tier.rows)
        T = tiles.numel() - 1
        sweep = {}
        for S in TILE_SWEEP:  # every tile size bit for bit, then timed
            t_S = on(word_tiles(offs_np, S))
            r = merge_word_rows(syms, offs, t_S, *args, tile=S)
            if not (torch.equal(r[0], exp_t[0]) and torch.equal(r[1], exp_t[1])):
                raise AssertionError(f"K9 at tiles of {S} symbols differs: {label}")
            sweep[S] = {"tiles": t_S.numel() - 1,
                        "ms": _time_ms(lambda: merge_word_rows(syms, offs, t_S, *args, tile=S), 20),
                        "launch": launch_shape(S + WORD_LANES - 1, ragged=True)}
        extra_out.update(tile=TILE_SYMBOLS, tiles=T, sweep=sweep,
                         launch=launch_shape(TILE_SYMBOLS + WORD_LANES - 1, ragged=True))
        work = (f"{live} symbols, {B} words, {probes} probes, {merges} merges; S={TILE_SYMBOLS}, "
                f"{T} tiles; sweep (S: tiles, ms) "
                + ", ".join(f"{S}: {v['tiles']}, {v['ms']:.4f}" for S, v in sweep.items()))
        in_bytes = 4 * live + 4 * (B + 1)
    elif name == "wordpiece_match":
        within = lens <= tier.t.max_input_chars
        live = int(lens[within].sum())
        emits = int(exp_t[1].sum())  # at least one probe (a hit) and its check an id
        probes, tbytes = emits, min(emits * 20, table_bytes_all)
        ops = emits * OPS_PER_PROBE_CHD
        hist = {"8 lanes": groups[0], "16 lanes": groups[1] - groups[0], "warp": B - groups[1]}
        warps = -(-groups[0] // 4) + -(-(groups[1] - groups[0]) // 2) + (B - groups[1])
        extra_out.update(groups=hist, warps=warps, launch=wordpiece_launch_shape())
        work = (f"{live} characters, {B} words, {emits} ids, {int(exp_t[2].sum())} poisoned; "
                f"words by lane group {hist}, {warps} warps")
        in_bytes = 4 * live + 4 * (B + 1) + 4 * B
    elif name == "viterbi":
        # the main input and the edge texts, at the longest piece, at
        # maxcand 3 and at 16 (the trainer's longest piece), under the
        # fallback marker -2, bit for bit; and in other lane groups than the
        # pack's (every text a warp; every text in a group of 8, so that the
        # longer ones are taken by the whole warp afterwards)
        edge_poisoned = {}
        for case, texts_c in [("main input", None)] + list(edge or []):
            if texts_c is None:
                c, o, n, gr = chars, offs, lens, groups
            else:
                packed = tier.pack(texts_c)
                (c, o, n), gr = (on(x) for x in packed[:3]), packed[4]
            Bc = n.numel()
            for maxcand, gr_c in ((tier.Lt, gr), (3, gr), (16, gr), (tier.Lt, (0, 0)),
                                  (tier.Lt, (Bc, Bc))):
                got_c = viterbi(c, o, n, gr_c, *tier.args(maxcand), fallback_id=FALLBACK_ID)
                torch.cuda.synchronize()
                exp_c = viterbi_ragged_plain(c, o, n, *tier.args(maxcand),
                                             fallback_id=FALLBACK_ID)
                if not torch.equal(got_c, exp_c):
                    raise AssertionError(f"K12 on {case} (maxcand {maxcand}, groups {gr_c}) "
                                         f"differs from its plain version: {label}")
                if texts_c is not None and maxcand == tier.Lt and gr_c == gr:
                    edge_poisoned[case] = int(split_viterbi(exp_c, n.numel())[2].sum())
        live = int(lens.sum())
        Lc = min(tier.Lt, 128)
        ln = lens_np.astype(np.int64)
        # candidates (end, length <= min(end, Lc)) of every piece: one probe each
        probes = int(np.where(ln <= Lc, ln * (ln + 1) // 2,
                              Lc * (Lc + 1) // 2 + (ln - Lc) * Lc).sum())
        out_t, count_t, poison_t = split_viterbi(exp_t[0], B)
        path_ids = out_t[out_t >= 0].long()
        path_chars = int(tier.piece_lens[path_ids].sum())
        V = tier.piece_lens.numel()
        tbytes = (min(probes * 20, table_bytes_all) + min(8 * path_ids.numel(), 8 * V)
                  + min(4 * path_chars, 4 * tier.piece_chars.numel()))
        ops = probes * OPS_PER_PROBE_CHD + 4 * live
        # 4 lanes a text of up to 16 characters, 8 a warp in each class; a
        # warp a longer one
        hist = {"1-8 characters": groups[0], "9-16 characters": groups[1] - groups[0],
                "a warp": B - groups[1]}
        warps = -(-groups[0] // 8) + -(-(groups[1] - groups[0]) // 8) + (B - groups[1])
        extra_out.update(launch=viterbi_launch_shape(), edge_poisoned=edge_poisoned,
                         poisoned=int(poison_t.sum()),
                         fallbacks=int((out_t == FALLBACK_ID).sum()), groups=hist, warps=warps)
        work = (f"{live} characters, {B} pieces, {probes} candidates, {int(count_t.sum())} ids "
                f"({extra_out['fallbacks']} fallbacks), {extra_out['poisoned']} poisoned; pieces "
                f"by class {hist}, {warps} warps; edge texts poisoned by case "
                f"{edge_poisoned}; also at maxcand 3 and 16 and in other groups, bit for bit")
        in_bytes = 4 * live + 4 * (B + 1) + 4 * B
    else:
        # every word in groups of 8 lanes and every word a warp (the longer
        # words overflow their group), bit for bit
        for g in ((B, B), (0, 0)):
            if not torch.equal(wordlevel_lookup(chars, offs, lens, g, *tier.args()), exp_t[0]):
                raise AssertionError(f"K11 in groups {g} differs from its plain version: {label}")
        live = N
        probes = int((lens > 0).sum())
        hit = (exp_t[0] >= 0) & (exp_t[0] != tier.t.unk_id)
        checked = int(lens[hit].sum())  # the characters the hits' exact checks read
        all_tables = table_bytes_all + 4 * (tier.token_chars.numel() + tier.token_lens.numel())
        tbytes = min(probes * 24 + 4 * checked, all_tables)
        ops = probes * OPS_PER_PROBE_CHD + 4 * live  # the probes, two hash steps a character
        hist = {"8 lanes": groups[0], "16 lanes": groups[1] - groups[0], "warp": B - groups[1]}
        warps = -(-groups[0] // 4) + -(-(groups[1] - groups[0]) // 2) + (B - groups[1])
        extra_out.update(groups=hist, warps=warps, launch=wordlevel_launch_shape())
        work = (f"{live} characters, {B} words, {probes} probes, {int(hit.sum())} hits, "
                f"{int((exp_t[0] == tier.t.unk_id).sum())} UNK; words by lane group {hist}, "
                f"{warps} warps")
        in_bytes = 4 * live + 4 * (B + 1) + 4 * B
    bound_ms, bound_by = _bound(in_bytes + out_bytes + tbytes, ops)
    if name in ("merge_word_rows", "wordpiece_match"):
        # the yardstick of the dense tiers: [B, 128] ids out, counts (and
        # K10's poison flags)
        dense_out = 4 * B * WORD_LANES + (5 if name == "wordpiece_match" else 4) * B
        extra_out["dense_bound_ms"] = _bound(in_bytes + dense_out + tbytes, ops)[0]
    elif name == "wordlevel_lookup":
        # the dense tier's input: [B, 128] rows of characters and lengths
        extra_out["dense_bound_ms"] = _bound(4 * B * WORD_LANES + 4 * B + out_bytes + tbytes,
                                             ops)[0]
    print(f"[{name}] {label} {shape} match={match} max_abs_err={err} kernel={ms:.4f} ms "
          f"cold={ms_cold:.4f} ms plain={plain_ms:.4f} ms bound={bound_ms:.4f} ms ({bound_by}; "
          f"{work})"
          + (f" dense bound={extra_out['dense_bound_ms']:.4f} ms" if "dense_bound_ms" in extra_out
             else "")
          + (f" launch={extra_out['launch']}" if "launch" in extra_out else ""), flush=True)
    if parent is not None and name == "wordlevel_lookup" and parent.has("wordlevel_lookup"):
        extra_out.update(_parent_wordlevel(label, tier, parent, kernel, exp_t[0], words, order))
    if parent is not None and name == "viterbi" and parent.has("viterbi"):
        extra_out.update(_parent_viterbi(label, tier, parent, kernel, exp_t[0], inputs))
    return dict(inputs=label, shape=shape, match=match, max_abs_err=err, ms=ms, ms_cold=ms_cold,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                probes=probes, **extra_out)


def _parent_wordlevel(label: str, tier, parent, kernel, exp, words: list[str], order) -> dict:
    """The earlier one-word-a-warp K11 on the same words as its tier laid
    them out ([B, 128] rows in the words' order, ``dense_word_rows``), its
    ids against this kernel's ``exp`` (in the packing ``order``), and the
    two timed in turns; the parent also cold."""
    import torch

    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from parent_word_kernels import dense_word_rows

    chars, lens = (torch.from_numpy(x).cuda() for x in dense_word_rows(words))
    targs = tier.args()
    pfn = lambda: parent.wordlevel_lookup(chars, lens, *targs)  # noqa: E731
    got = pfn()
    torch.cuda.synchronize()
    if not torch.equal(got[torch.from_numpy(order).cuda()], exp):
        raise AssertionError(f"the parent's K11 differs from this one's: {label}")
    turns_ms, parent_ms = _in_turns(kernel, pfn)
    sets = _cold_sets((chars, lens), 4 * lens.numel())
    parent_cold = _time_cold_ms(lambda c, n: parent.wordlevel_lookup(c, n, *targs), sets, 20)
    del sets
    print(f"[wordlevel_lookup] {label} parent (a warp a [B, 128] row) match=True: in turns "
          f"parent {parent_ms[0]:.4f} ms, kernel {turns_ms[0]:.4f}, {turns_ms[1]:.4f}, parent "
          f"{parent_ms[1]:.4f}; parent cold {parent_cold:.4f} ms", flush=True)
    return dict(parent_ms=parent_ms, parent_ms_cold=parent_cold, ms_in_turns=turns_ms)


def _parent_viterbi(label: str, tier, parent, kernel, exp, inputs: tuple) -> dict:
    """The first K12 (a warp a text, ``parent``'s) on the same packed texts:
    checked against this kernel's result, the two timed in turns, warm; the
    parent also cold."""
    import torch

    targs = tier.args()
    got = parent.viterbi(*inputs, *targs)
    torch.cuda.synchronize()
    if not torch.equal(got, exp):
        raise AssertionError(f"the parent's K12 differs from this one's: {label}")
    turns_ms, parent_ms = _in_turns(kernel, lambda: parent.viterbi(*inputs, *targs))
    N, B = inputs[0].numel(), inputs[2].numel()
    sets = _cold_sets(inputs, 4 * N + 8 * B)
    parent_cold = _time_cold_ms(lambda c, o, n: parent.viterbi(c, o, n, *targs), sets, 20)
    del sets
    print(f"[viterbi] {label} parent (a warp a text) match=True: in turns parent "
          f"{parent_ms[0]:.4f} ms, kernel {turns_ms[0]:.4f}, {turns_ms[1]:.4f}, parent "
          f"{parent_ms[1]:.4f}; parent cold {parent_cold:.4f} ms", flush=True)
    return dict(parent_ms=parent_ms, parent_ms_cold=parent_cold, ms_in_turns=turns_ms)


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
    ("Unigram 32,000", None, "viterbi"),
)


def drive_models(texts: list[str], kernels_of: dict, parent=None) -> dict:
    """The models at full width, each through ``encode_batch`` (the entry
    point a user calls) on the corpus, with the launch counts set to 0 just
    before and read just after (its tier's kernel once, no other):
    ByteLevel BPE on the tracked 50K and 100K tables (K9), CharBPE on its
    test table (K9), WordPiece at bert-base-uncased's size (K10), WordLevel
    at 40,001 entries (K11) and Unigram at t5-base's 32,000 pieces (K12) on
    the corpus's ``▁word`` pieces in text order, one call (what a T5
    pipeline's ``Metaspace`` hands the model).  Every text (Unigram: every
    piece) against the host ``encode`` (assembled from each distinct word's
    host ids), every distinct word or piece through ``encode_batch`` alone
    against the host; the words the host took (poisoned, over 128 lanes, an
    ineligible table) are counted.  Then each kernel against its plain
    version on the main path's input (K11 and K12 also against
    ``parent``'s, where it holds them; K12 also on the edge texts)."""
    import torch

    from complexity_tokenizer_tpu_torch.models import UnigramModel, WordLevelModel, WordPieceModel
    from complexity_tokenizer_tpu_torch.utils.corpus import (
        RUN_BREAKS,
        bert_scale_wordpiece_vocab,
        metaspace_pieces,
        run_rows,
        unigram_32k_vocab,
        unigram_edge_texts,
        wordlevel_vocab,
    )

    makers = {"WordPiece 30,522": lambda: WordPieceModel(bert_scale_wordpiece_vocab()),
              "WordLevel 40,001": lambda: WordLevelModel(wordlevel_vocab()),
              "Unigram 32,000": lambda: UnigramModel(unigram_32k_vocab())}
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
        # Unigram segments each text whole: its texts are the corpus's pieces
        inputs = metaspace_pieces(texts) if kname == "viterbi" else texts
        got, counts, wall = _drive_launches(kernels_of, lambda: model.encode_batch(inputs))
        stats = dict(model.last_stats)
        if model.last_route != "device":
            raise AssertionError(f"[{label}] encode_batch took the {model.last_route} route")
        _need_only(f"[{label}] encode_batch", counts, {kname: 1})
        if kname == "viterbi":
            split = lambda t: [t]  # noqa: E731
        else:
            split = model._split_words if hasattr(model, "_split_words") else str.split
        rows = [split(t) for t in inputs]
        uniq = sorted({w for r in rows for w in r})
        t1 = time.perf_counter()
        host = {w: model.encode(w) for w in uniq}
        host_s = time.perf_counter() - t1
        bad_texts = sum(g != [i for w in r for i in host[w]] for g, r in zip(got, rows))
        per_word = model.encode_batch(uniq)
        bad_words = sum(g != host[w] for g, w in zip(per_word, uniq))
        unit = "pieces" if kname == "viterbi" else "texts"
        print(f"[{label}] encode_batch: {len(inputs)} {unit}, {len(uniq)} distinct words "
              f"({sum(map(len, uniq))} characters); tables built and to the card {setup_s:.3f} s; "
              f"wall {wall:.3f} s; host encode of the distinct words {host_s:.3f} s; {bad_texts} "
              f"{unit} and {bad_words} words differ from the host; words the host took "
              f"{stats['host']} (poisoned {stats['poisoned']}, over 128 lanes "
              f"{stats['over_width']}); launches {counts}", flush=True)
        if bad_texts or bad_words:
            raise AssertionError(f"[{label}] {bad_texts} texts, {bad_words} words differ from the host")
        sym_rows = None
        if kname == "merge_word_rows":
            sym_rows = ([list(model._text_to_byte_tokens(w)) for w in uniq]
                        if hasattr(model, "_text_to_byte_tokens")
                        else [list(w)[:-1] + [w[-1] + model.end_of_word_suffix] for w in uniq])
        edge = unigram_edge_texts(unigram_32k_vocab()) if kname == "viterbi" else None
        out["checks"].setdefault(kname, []).append(
            check_model_kernel(label, kname, tier, uniq, sym_rows, parent, edge))
        if label == "ByteLevel BPE 50K":
            # K22 on the same words, over the cuckoo table of the same ids
            out["checks"]["merge_word_rows_qc"] = [
                check_word_rows_qc("corpus words, 50K", model, tier, sym_rows)]
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
                out["checks"]["merge_word_rows_qc"].append(check_word_rows_qc(
                    "run rows, unknown-symbol breaks" if breaks else "run rows", model, tier,
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


# ---------------------------------------------------------------------------
# the trainer (K13-K16)

# the golden file of INL mode at the reference's 32,000 (scripts/make_bench_inl_32k.py)
INL_32K = os.path.join(REPO, ".cache", "bench_inl_32k.json")
CLASSIC = dict(inl_alpha=0.0, inl_beta=0.0, inl_gate=0.0)
# (label, config, _INL_WINDOW_T, golden file, the whole file or its prefix)
TRAIN_ROUTES = (
    ("classic 50,000", dict(vocab_size=50_000, min_frequency=1, **CLASSIC), None, TOKENIZER_JSON, True),
    ("INL 32,000", dict(vocab_size=32_000, min_frequency=2), None, INL_32K, True),
    ("classic 4,096", dict(vocab_size=4096, min_frequency=1, **CLASSIC), None, TOKENIZER_JSON, False),
    ("INL 4,096", dict(vocab_size=4096, min_frequency=2), None, INL_32K, False),
    # fewer candidates than a window's 100 merges: every window ends on the host
    ("INL 4,096, T 96", dict(vocab_size=4096, min_frequency=2), 96, INL_32K, False),
)
TRAIN_KERNELS = ("pair_hist", "merge_step", "select_pair", "hist_update")
# the merges of classic 50,000 before which K14 is checked and timed on the
# route's rows (replayed with K14 from the golden merges), the classic
# 4,096 route's 32-step blocks and the INL 4,096 route's windows whose
# device-resident steps are checked and timed (each replayed from the start)
K14_STATES = (0, 1000, 10_000, 40_000)
CLASSIC_BLOCKS = (0, 30)
INL_WINDOWS = (0, 10)


def _warm_cache_map(path: str) -> dict:
    """A warm-cache file as {word bytes: ids}."""
    import numpy as np

    with np.load(path) as z:
        wb, lens, ids, counts = z["words_buf"], z["lens"], z["ids_flat"], z["counts"]
    wo = np.concatenate([[0], np.cumsum(lens)])
    io_ = np.concatenate([[0], np.cumsum(counts)])
    return {bytes(wb[wo[i]:wo[i + 1]]): tuple(ids[io_[i]:io_[i + 1]].tolist())
            for i in range(len(lens))}


def _time_reset_ms(resets: list, runs: list, reps: int = 3, separate: bool = False) -> float:
    """Device ms of one ``runs[i]()``, for kernels that change their own
    input: a CUDA graph of every ``resets[i]()`` then every ``runs[i]()``
    (so with many large sets the runs find their inputs cold) less a graph
    of the resets alone, over the number of runs.  ``separate``: a 4-byte
    memset before each run, in both graphs, so that no run is launched
    right behind another (a kernel launched as the programmatic dependent
    of the one before would overlap it), as a route that reads each result
    back launches them."""
    import torch

    def graph(fns):
        for f in fns:
            f()
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for f in fns:
                f()
        g.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            g.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    if not separate:
        return (graph(resets + runs) - graph(resets)) / len(runs)
    sep = torch.zeros(1, dtype=torch.int32, device="cuda")
    return (graph(resets + [f for run in runs for f in (sep.zero_, run)])
            - graph(resets + [sep.zero_] * len(runs))) / len(runs)


def _train_state(texts, cfg, device="cuda"):
    """A device trainer with its vocabulary initialized, and its initial
    rows as it builds them: (trainer, words [N, W], freqs [N])."""
    import contextlib
    import io
    from collections import Counter

    import torch

    from complexity_tokenizer_tpu_torch.parallel.trainer import DistributedInlTrainer, pack_word_rows
    from complexity_tokenizer_tpu_torch.trainers.inl_trainer import TrainerConfig

    t = DistributedInlTrainer(TrainerConfig(**cfg), device=device)
    wf = t._count_words(texts)
    wf = Counter({w: f for w, f in wf.items() if f >= t.config.min_frequency})
    with contextlib.redirect_stdout(io.StringIO()):
        words_list, freqs_list = t._init_vocab(wf)
    words, freqs = pack_word_rows(words_list, freqs_list)
    return t, torch.from_numpy(words).to(device), torch.from_numpy(freqs).to(device)


def _train_inputs(texts, cfg):
    """The trainer's initial rows on the card, as the device trainer builds
    them: (words [N, W], freqs [N], vocab, v0)."""
    t, words, freqs = _train_state(texts, cfg)
    return words, freqs, t.vocab, len(t.vocab)


def _leading(ma, n_do: int) -> int:
    """The steps of a block's merge log that merged (those before the
    first -1)."""
    applied = 0
    while applied < n_do and ma[applied] >= 0:
        applied += 1
    return applied


def classic_blocks(words, freqs, hist, v0: int, n_steps: int, keep=None):
    """The classic device-resident route's blocks replayed as
    ``DistributedInlTrainer._batched_selection_loop`` enqueues them
    (``run_steps``, 32 steps a block, the deltas and log zeroed first), on
    ``words`` and ``hist`` in place, for ``n_steps`` steps or until a step
    does nothing.  Returns the merges (id pairs) and, for each block index
    in ``keep`` (every block when None), a copy of its input as
    ``check_block`` takes it."""
    import torch

    from complexity_tokenizer_tpu_torch.ops.trainer_device import SelectScratch
    from complexity_tokenizer_tpu_torch.parallel.trainer import DistributedInlTrainer, run_steps

    k = DistributedInlTrainer._SELECT_BLOCK_K
    dev = words.device
    log = torch.empty(3, k, dtype=torch.int32, device=dev)
    deltas = torch.empty(k, hist.shape[0], 4, dtype=torch.int32, device=dev)
    scratch = SelectScratch(dev) if dev.type == "cuda" else None
    merges, kept, done = [], {}, 0
    while done < n_steps:
        n_do = min(k, n_steps - done)
        if keep is None or done // k in keep:
            kept[done // k] = dict(v0b=v0 + done, n_do=n_do, words=words.clone(),
                                   hist=hist.clone(), freqs=freqs, cand=None)
        deltas[:n_do].zero_()
        log[2].zero_()
        run_steps(n_do, v0 + done, words, freqs, hist, log, deltas, scratch=scratch)
        ma, mb, _mf = log.cpu().numpy()
        applied = _leading(ma, n_do)
        merges += [(int(a), int(b)) for a, b in zip(ma[:applied], mb[:applied])]
        done += applied
        if applied < n_do:
            break
    return merges, kept


def inl_windows(texts, cfg, n_windows=None, keep=None, device="cuda"):
    """The INL device-resident route's rebuild windows replayed from the
    start of training as ``DistributedInlTrainer._inl_window_loop`` runs
    them: the host seeds its pair counts from K13, scores and orders the
    pairs at each window's start, ships the first ``_INL_WINDOW_T`` as the
    candidates, the card runs ``run_steps`` over them, and the host folds
    the window's logged deltas back merge by merge.  Stops after
    ``n_windows`` windows, at the vocabulary's size, or after the first
    window whose candidates ran out (the loop goes on there one K14 launch
    a merge, which this does not replay).  Returns the trainer (its
    ``merges``) and, for each window index in ``keep`` (every one when
    None), a copy of its input as ``check_block`` takes it."""
    import numpy as np
    import torch

    from complexity_tokenizer_tpu_torch.ops.trainer_device import pair_hist
    from complexity_tokenizer_tpu_torch.parallel.trainer import REBUILD_INTERVAL, run_steps

    t, words, freqs = _train_state(texts, cfg, device)
    v0 = len(t.vocab)
    seed = pair_hist(words, freqs, v0).view(v0, v0).cpu().numpy()
    ys, xs = np.nonzero(seed)
    for a, b in zip(ys.tolist(), xs.tolist()):
        t.pair_freqs[(a, b)] = int(seed[a, b])
    target = t.config.vocab_size
    V = max(target, v0 + 1)
    hist = t._hist_on_device(V)
    k, T = REBUILD_INTERVAL, t._INL_WINDOW_T
    log = torch.empty(3, k, dtype=torch.int32, device=device)
    deltas = torch.empty(k, V, 4, dtype=torch.int32, device=device)
    kept, w = {}, 0
    while len(t.vocab) < target and (n_windows is None or w < n_windows):
        pairs, order = t._ordered_pairs()
        if not len(order):
            break
        pairs_np = np.asarray(pairs, np.int32).reshape(-1, 2)
        n_cand = min(T, len(order))
        cand_np = np.zeros((2, T), np.int32)
        cand_np[:, :n_cand] = pairs_np[order[:n_cand]].T
        window = min(k, target - len(t.vocab))
        n_do = min(window, n_cand)
        v0b = len(t.vocab)
        cand = torch.from_numpy(cand_np).to(device)
        state = torch.tensor([-1, 0], dtype=torch.int32, device=device)
        if keep is None or w in keep:
            kept[w] = dict(v0b=v0b, n_do=n_do, words=words.clone(), hist=hist.clone(),
                           freqs=freqs, cand=(cand[0].clone(), cand[1].clone(), n_cand,
                                              state.clone()))
        deltas[:n_do].zero_()
        log[2].zero_()
        run_steps(n_do, v0b, words, freqs, hist, log, deltas, cand=(cand[0], cand[1], n_cand, state))
        ma, mb, mf = log.cpu().numpy()
        applied = _leading(ma, n_do)
        deltas_np = deltas[:applied].cpu().numpy()
        for i in range(applied):
            a, b = int(ma[i]), int(mb[i])
            t._apply_delta_hist(deltas_np[i], int(mf[i]), a, b, t._mint(a, b))
        w += 1
        if applied < window:
            break
    return t, kept


def _check_equal(name: str, label: str, got, exp) -> dict:
    import torch

    torch.cuda.synchronize()
    got = got if isinstance(got, (list, tuple)) else [got]
    exp = exp if isinstance(exp, (list, tuple)) else [exp]
    err = max(_max_abs_err(g, e) for g, e in zip(got, exp))
    match = all(torch.equal(g, e) for g, e in zip(got, exp))
    print(f"[{name}] {label} match={match} max_abs_err={err}", flush=True)
    if not match:
        raise AssertionError(f"{name} kernel differs from its plain version: {label}")
    return dict(inputs=label, match=match, max_abs_err=err)


def check_train_kernels(texts: list[str], golden50: list, golden_inl: list) -> dict:
    """K13-K16 against their plain versions on the card, bit for bit, on the
    classic route's real inputs: its initial rows and the state after 1,000
    merges (the classic 4,096 route's first 1,000 steps, K15 -> K14 -> K16
    in blocks of 32, ``classic_blocks``, whose merges must be the golden
    file's first 1,000); K13 also on the initial rows with Zipf-skewed ids
    below 260, 241 and 700 (each branch of its plan); K14 (with its clear,
    as the per-merge route calls it, into buffers that held other values)
    on the classic 50,000 route's rows before merges ``K14_STATES``
    (reached by K14 itself, the golden merges applied one launch each, as
    that route launches them, each minting) and on
    ``utils/corpus.py:merge_edge_rows``; the 32-step blocks
    ``CLASSIC_BLOCKS`` of that replay and the 100-step windows
    ``INL_WINDOWS`` of the INL 4,096 route (``inl_windows``, whose merges
    must be the INL golden file's) through ``run_steps`` (K15, K14, then K16
    as K14's programmatic dependent) against the plain versions' steps.
    Each timed warm, cold (except K14, whose rows are restored before each
    launch, and the blocks: see ``_time_reset_ms``) and plainly, beside its
    bound and the library call where there is one."""
    import numpy as np
    import torch

    from complexity_tokenizer_tpu_torch.ops import trainer_device as td
    from complexity_tokenizer_tpu_torch.utils.corpus import merge_edge_rows, zipf_pair_rows

    out = {k: [] for k in TRAIN_KERNELS}
    words0, freqs, vocab, v0 = _train_inputs(texts, TRAIN_ROUTES[0][1])
    N, W = words0.shape
    Vr = 4096  # the device-resident routes' histogram side
    V50 = 50_000  # the per-merge route's delta rows
    # K13 on the initial rows
    got = td.pair_hist(words0, freqs, v0)
    r = _check_equal("pair_hist", f"initial rows [{N},{W}]", got, td.pair_hist_plain(words0, freqs, v0))
    left, right = words0[:, :-1].long(), words0[:, 1:].long()
    valid = (left >= 0) & (right >= 0)
    key = (left * v0 + right)[valid]
    fval = freqs[:, None].expand_as(left)[valid]
    ms = _time_ms(lambda: td.pair_hist(words0, freqs, v0), 50)
    sets = _cold_sets((words0, freqs), 4 * v0 * v0)
    ms_cold = _time_cold_ms(lambda w, f: td.pair_hist(w, f, v0), sets, 50)
    del sets
    plain_ms = _time_ms(lambda: td.pair_hist_plain(words0, freqs, v0), 3, graph=False)
    library_ms = _time_ms(
        lambda: torch.zeros(v0 * v0, dtype=torch.int32, device="cuda").index_add_(0, key, fval), 50)
    bound_ms, bound_by = _bound(4 * N * W + 4 * N + 4 * v0 * v0, N * (W - 1))
    launch = td.pair_hist_launch_shape(N, W, v0)
    out["pair_hist"].append(dict(r, shape=[N, W], v0=v0, ms=ms, ms_cold=ms_cold,
                                 plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                                 library_ms=library_ms, launch=launch))
    print(f"[pair_hist] [{N},{W}] v0={v0} warm={ms:.4f} cold={ms_cold:.4f} plain={plain_ms:.4f} "
          f"library={library_ms:.4f} bound={bound_ms:.5f} ms ({bound_by}); launch {launch}",
          flush=True)
    # K13's other branches on the classic rows' lengths and frequencies with
    # Zipf-skewed ids below v0 (utils/corpus.py:zipf_pair_rows): 260, a
    # byte-level alphabet (the slices on blockIdx.y), timed as above; 241,
    # the last side of one block's histogram, and 700, past the slices'
    # reach (global atomics), checked
    for vz in (260, 241, 700):
        wz = torch.from_numpy(zipf_pair_rows(words0.cpu().numpy(), vz, seed=vz)).cuda()
        rz = _check_equal("pair_hist", f"Zipf ids below {vz} on the rows [{N},{W}]",
                          td.pair_hist(wz, freqs, vz), td.pair_hist_plain(wz, freqs, vz))
        rz.update(shape=[N, W], v0=vz, launch=td.pair_hist_launch_shape(N, W, vz))
        if vz == 260:
            lz, rgt = wz[:, :-1].long(), wz[:, 1:].long()
            vz_valid = (lz >= 0) & (rgt >= 0)
            kz = (lz * vz + rgt)[vz_valid]
            fz = freqs[:, None].expand_as(lz)[vz_valid]
            ms_z = _time_ms(lambda: td.pair_hist(wz, freqs, vz), 50)
            sets = _cold_sets((wz, freqs), 4 * vz * vz)
            ms_cold_z = _time_cold_ms(lambda w, f: td.pair_hist(w, f, vz), sets, 50)
            del sets
            plain_z = _time_ms(lambda: td.pair_hist_plain(wz, freqs, vz), 3, graph=False)
            library_z = _time_ms(
                lambda: torch.zeros(vz * vz, dtype=torch.int32, device="cuda").index_add_(0, kz, fz),
                50)
            bz, bz_by = _bound(4 * N * W + 4 * N + 4 * vz * vz, N * (W - 1))
            rz.update(ms=ms_z, ms_cold=ms_cold_z, plain_ms=plain_z, library_ms=library_z,
                      bound_ms=bz, bound_by=bz_by)
            print(f"[pair_hist] [{N},{W}] v0={vz} warm={ms_z:.4f} cold={ms_cold_z:.4f} "
                  f"plain={plain_z:.4f} library={library_z:.4f} bound={bz:.5f} ms ({bz_by})",
                  flush=True)
        print(f"[pair_hist] v0={vz} launch {rz['launch']}", flush=True)
        out["pair_hist"].append(rz)

    # the state after 1,000 merges: the classic 4,096 route's first 1,000
    # steps, in its blocks of 32
    hist0 = torch.zeros(Vr, Vr, dtype=torch.int32, device="cuda")
    hist0[:v0, :v0] = got.view(v0, v0)
    words1k, hist1k = words0.clone(), hist0.clone()
    scratch = td.SelectScratch("cuda")
    merged, blocks = classic_blocks(words1k, freqs, hist1k, v0, 1000, keep=CLASSIC_BLOCKS)
    inv = {i: t for t, i in vocab.items()}
    for i, (ia, ib) in enumerate(merged):
        a, b = inv[ia], inv[ib]
        inv[v0 + i] = a + b
        if (a, b) != golden50[i]:
            raise AssertionError(f"device-resident merge {i} is {(a, b)}, the golden file's {golden50[i]}")
    if len(merged) != 1000:
        raise AssertionError(f"the classic 4,096 replay stopped after {len(merged)} merges")
    # the INL 4,096 route's windows, replayed
    trainer, windows = inl_windows(texts, TRAIN_ROUTES[3][1], n_windows=max(INL_WINDOWS) + 1,
                                   keep=INL_WINDOWS)
    if trainer.merges != golden_inl[: len(trainer.merges)] or len(windows) != len(INL_WINDOWS):
        raise AssertionError(f"the INL 4,096 replay's {len(trainer.merges)} merges are not the "
                             f"golden file's")
    del trainer

    # the classic 50,000 route's rows before each merge of K14_STATES: the
    # golden merges applied by K14 as that route launches it (the pair as
    # scalars, adding into one of two buffers while it zeroes the other),
    # each minting at least one occurrence, and the rows after 1,000 merges
    # those of the device-resident replay
    gids = dict(vocab)
    pairs50 = []
    for i, (x, y) in enumerate(golden50[: max(K14_STATES)]):
        pairs50.append((gids[x], gids[y]))
        gids.setdefault(x + y, v0 + i)
    states = {}
    rows = words0.clone()
    route = torch.zeros(2, 1 + 4 * V50, dtype=torch.int32, device="cuda")
    mints = torch.zeros(len(pairs50), dtype=torch.int32, device="cuda")
    for i in range(len(pairs50) + 1):
        if i in K14_STATES:
            states[i] = rows.clone()
        if i == len(pairs50):
            break
        (a, b), new, n_buf = pairs50[i], v0 + i, 1 + 4 * (v0 + i + 1)
        cur, other = route[i % 2], route[1 - i % 2]
        td.merge_step(rows, freqs, new, cur[1:n_buf].view(new + 1, 4), mints[i:i + 1], a=a, b=b,
                      zero=other[:n_buf])
    if not bool((mints > 0).all()):
        raise AssertionError(f"golden merge {int((mints <= 0).nonzero()[0])} of classic 50,000 "
                             f"minted nothing on the replayed rows")
    if not torch.equal(states[1000], words1k):
        raise AssertionError("the rows after 1,000 golden merges are not the device-resident route's")
    del route, mints

    # K14 as the per-merge route calls it (the pair as scalars, adding into
    # a zeroed buffer while it zeroes the other) before each merge of
    # K14_STATES, on that route's rows; then the edge rows
    for s_ in K14_STATES:
        words, new = states[s_], v0 + s_
        a, b = gids[golden50[s_][0]], gids[golden50[s_][1]]
        label = f"before merge {s_:,}"
        n_buf = 1 + 4 * (new + 1)
        res = []
        for fn in (td.merge_step, td.merge_step_plain):
            w = words.clone()
            bufs = torch.zeros(2, n_buf, dtype=torch.int32, device="cuda")
            bufs[1].fill_(7)  # the merge before's buffer: K14 zeroes it
            fn(w, freqs, new, bufs[0, 1:].view(new + 1, 4), bufs[0, :1], a=a, b=b, zero=bufs[1])
            res.append((w, bufs))
        r = _check_equal("merge_step", f"{label} [{N},{W}], {golden50[s_]}", res[0], res[1])
        changed = int((res[0][0] != words).sum())
        nz = int((res[0][1][0, 1:] != 0).sum())
        holding = int(((words == a).any(1) & (words == b).any(1)).sum())
        src = words
        bufs = torch.zeros(2, n_buf, dtype=torch.int32, device="cuda")
        d, m = bufs[0, 1:].view(new + 1, 4), bufs[0, :1]
        timed = {}
        # warm: 10 restored copies (their rows and sources fit the L2 together);
        # cold: copies of twice the L2, restored before any of them merges;
        # alone: not zeroing the other buffer; each launch after a memset,
        # not behind the one before (the route reads each merge back)
        for key, n_sets, zero in (("warm", 10, bufs[1]), ("alone", 10, None),
                                  ("cold", -(-COLD_BYTES // (8 * N * W)) + 1, bufs[1])):
            copies = [(src, src.clone()) for _ in range(n_sets)]
            timed[key] = _time_reset_ms(
                [lambda s=s, x=x: x.copy_(s) for s, x in copies],
                [lambda x=x, z=zero: td.merge_step(x, freqs, new, d, m, a=a, b=b, zero=z)
                 for _s, x in copies], separate=True)
            del copies
        ms, ms_cold = timed["warm"], timed["cold"]
        w = words.clone()

        def plain():
            w.copy_(src)
            td.merge_step_plain(w, freqs, new, d, m, a=a, b=b, zero=bufs[1])

        plain_ms = _time_ms(plain, reps=3, graph=False)
        # the rows read, the frequencies of the rows that hold both tokens
        # (no other row's is read), changed slots and the touched delta
        # entries and count written, the other buffer zeroed
        bound_ms, bound_by = _bound(4 * N * W + 4 * holding + 4 * changed + 4 * nz + 4 + 4 * n_buf,
                                    N * W)
        out["merge_step"].append(dict(r, shape=[N, W], merge=s_, ms=ms, ms_cold=ms_cold,
                                      ms_alone=timed["alone"], plain_ms=plain_ms,
                                      bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                                      changed_slots=changed, delta_entries=nz,
                                      rows_holding_pair=holding))
        print(f"[merge_step] {label} [{N},{W}] warm={ms:.4f} cold={ms_cold:.4f} "
              f"alone={timed['alone']:.4f} plain={plain_ms:.4f} bound={bound_ms:.5f} ms "
              f"({bound_by}; {changed} slots changed, {nz} delta entries, {holding} rows hold "
              f"both tokens)", flush=True)
    for label, words_np, freqs_np, a, b, new in merge_edge_rows():
        res = []
        for fn in (td.merge_step, td.merge_step_plain):
            w = torch.from_numpy(words_np.copy()).cuda()
            d = torch.zeros(new + 1, 4, dtype=torch.int32, device="cuda")
            m = torch.zeros(1, dtype=torch.int32, device="cuda")
            fn(w, torch.from_numpy(freqs_np).cuda(), new, d, m, a=a, b=b)
            res.append((w, d, m))
        out["merge_step"].append(dict(_check_equal("merge_step", f"edge rows: {label}", res[0], res[1]),
                                      shape=list(words_np.shape)))

    # K15 classic and K16 on the histogram at both states
    for label, hist, step, words in (("initial rows", hist0, 0, words0), ("after 1,000 merges", hist1k, 1000, words1k)):
        logs = [torch.full((2, 4), -7, dtype=torch.int32, device="cuda") for _ in range(2)]
        td.select_pair(hist, 1, logs[0][0], logs[0][1], scratch=scratch)
        td.select_pair_plain(hist, 1, logs[1][0], logs[1][1])
        r = _check_equal("select_pair", f"classic, {label} [{Vr},{Vr}]", logs[0], logs[1])
        ma2, mb2 = logs[0][0], logs[0][1]
        ms = _time_ms(lambda: td.select_pair(hist, 1, ma2, mb2, scratch=scratch), 50)
        sets = _cold_sets((hist,), 8)
        ms_cold = _time_cold_ms(lambda h: td.select_pair(h, 1, ma2, mb2, scratch=scratch), sets, 50)
        del sets
        plain_ms = _time_ms(lambda: td.select_pair_plain(hist, 1, ma2, mb2), 5, graph=False)
        library_ms = _time_ms(lambda: torch.argmax(hist.view(-1)), 50)
        bound_ms, bound_by = _bound(4 * Vr * Vr + 8, Vr * Vr)
        out["select_pair"].append(dict(r, shape=[Vr, Vr], mode="classic", ms=ms, ms_cold=ms_cold,
                                       plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                                       library_ms=library_ms))
        print(f"[select_pair] classic {label} [{Vr},{Vr}] warm={ms:.4f} cold={ms_cold:.4f} "
              f"plain={plain_ms:.4f} library={library_ms:.4f} bound={bound_ms:.4f} ms ({bound_by})",
              flush=True)
        # K16: the step's update with K14's delta of the selected pair
        new = v0 + step
        w = words.clone()
        d = torch.zeros(Vr, 4, dtype=torch.int32, device="cuda")
        m = torch.zeros(1, dtype=torch.int32, device="cuda")
        td.merge_step(w, freqs, new, d, m, log=(ma2, mb2), step=1)
        hs = [hist.clone(), hist.clone()]
        td.hist_update(hs[0], 1, ma2, mb2, new, d)
        td.hist_update_plain(hs[1], 1, ma2, mb2, new, d)
        r = _check_equal("hist_update", f"{label} [{Vr},{Vr}]", hs[0], hs[1])
        h = hs[0]
        ms = _time_ms(lambda: td.hist_update(h, 1, ma2, mb2, new, d), 50)
        sets = [(x.clone(), d.clone()) for x in [h] * 4]  # 4 x 64 MB: over twice the L2
        ms_cold = _time_cold_ms(lambda x, dd: td.hist_update(x, 1, ma2, mb2, new, dd), sets, 50)
        del sets
        plain_ms = _time_ms(lambda: td.hist_update_plain(h, 1, ma2, mb2, new, d), 5, graph=False)
        bound_ms, bound_by = _bound(2 * 4 * 4 * Vr + 16 * Vr + 8, 4 * 4 * Vr)
        out["hist_update"].append(dict(r, shape=[Vr, Vr], ms=ms, ms_cold=ms_cold, plain_ms=plain_ms,
                                       bound_ms=bound_ms, bound_by=bound_by, library_ms=None))
        print(f"[hist_update] {label} [{Vr},{Vr}] warm={ms:.4f} cold={ms_cold:.4f} "
              f"plain={plain_ms:.4f} bound={bound_ms:.5f} ms ({bound_by})", flush=True)
        # K15, INL window: the 2,048 pairs of largest count in a shuffled walk
        # order with dead pairs among them; from the window's start, from a
        # cursor inside it, and stopped
        rng = np.random.RandomState(step)
        flat = torch.topk(hist.view(-1), 1536).indices.cpu().numpy()
        dead = rng.randint(0, Vr * Vr, size=512)
        walk = np.concatenate([flat, dead])
        rng.shuffle(walk)
        T = 2048
        ca = torch.from_numpy((walk // Vr).astype(np.int32)).cuda()
        cb = torch.from_numpy((walk % Vr).astype(np.int32)).cuda()
        for state0 in ((-1, 0), (700, 0), (-1, 1)):
            res = []
            for fn in (td.select_pair, td.select_pair_plain):
                lg = torch.full((2, 4), -7, dtype=torch.int32, device="cuda")
                st = torch.tensor(state0, dtype=torch.int32, device="cuda")
                kw = dict(scratch=scratch) if fn is td.select_pair else {}
                fn(hist, 2, lg[0], lg[1], cand=(ca, cb, T - 3, st), **kw)
                res.append((lg, st))
            out["select_pair"].append(dict(_check_equal(
                "select_pair", f"window, {label}, state {state0}", res[0], res[1]), shape=[T], mode="window"))
        # the walk moves its cursor: 64 cursors, each restored before the
        # launches (a launch is a few µs; one alone is lost in the graph's)
        st0 = torch.tensor((-1, 0), dtype=torch.int32, device="cuda")
        sts = [st0.clone() for _ in range(64)]
        lg = torch.empty(2, 4, dtype=torch.int32, device="cuda")
        ms = _time_reset_ms([lambda x=x: x.copy_(st0) for x in sts],
                            [lambda x=x: td.select_pair(hist, 2, lg[0], lg[1], cand=(ca, cb, T, x))
                             for x in sts])
        st = sts[0]
        plain_ms = _time_ms(lambda: (st.copy_(st0), td.select_pair_plain(hist, 2, lg[0], lg[1],
                                                                          cand=(ca, cb, T, st))), 5,
                            graph=False)
        bound_ms, bound_by = _bound(12 * T + 16, 3 * T)
        out["select_pair"][-1].update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                                      library_ms=None)
        print(f"[select_pair] window {label} T={T} warm={ms:.4f} plain={plain_ms:.4f} "
              f"bound={bound_ms:.5f} ms ({bound_by})", flush=True)
    out["blocks"] = [check_block(f"classic 4,096, block {i}", blk, scratch)
                     for i, blk in sorted(blocks.items())]
    out["blocks"] += [check_block(f"INL 4,096, window {i}", blk, scratch)
                      for i, blk in sorted(windows.items())]
    return out


def check_block(label: str, blk: dict, scratch) -> dict:
    """A device-resident block or window, from ``classic_blocks`` or
    ``inl_windows``: ``run_steps`` (K15, K14, then K16 as K14's programmatic
    dependent) against
    the plain versions' steps on the same inputs, bit for bit (rows,
    histogram, merge log, deltas, the window's cursor), then timed as one
    CUDA graph on inputs restored before each replay (``_time_reset_ms``)."""
    import torch

    from complexity_tokenizer_tpu_torch.ops import trainer_device as td
    from complexity_tokenizer_tpu_torch.parallel.trainer import run_steps

    n_do, v0b, freqs, cand = blk["n_do"], blk["v0b"], blk["freqs"], blk["cand"]
    V = blk["hist"].shape[0]

    def fresh():
        st = dict(words=blk["words"].clone(), hist=blk["hist"].clone(),
                  log=torch.zeros(3, n_do, dtype=torch.int32, device="cuda"),
                  deltas=torch.zeros(n_do, V, 4, dtype=torch.int32, device="cuda"),
                  state=torch.zeros(2, dtype=torch.int32, device="cuda"))
        if cand is not None:
            st["state"].copy_(cand[3])
        st["cand"] = None if cand is None else (cand[0], cand[1], cand[2], st["state"])
        return st

    got, want = fresh(), fresh()
    run_steps(n_do, v0b, got["words"], freqs, got["hist"], got["log"], got["deltas"],
              cand=got["cand"], scratch=scratch)
    for i in range(n_do):
        ma, mb, mf = want["log"][0], want["log"][1], want["log"][2]
        td.select_pair_plain(want["hist"], i, ma, mb, cand=want["cand"])
        td.merge_step_plain(want["words"], freqs, v0b + i, want["deltas"][i], mf[i:i + 1],
                            log=(ma, mb), step=i)
        td.hist_update_plain(want["hist"], i, ma, mb, v0b + i, want["deltas"][i])
    keys = ("words", "hist", "log", "deltas", "state")
    r = _check_equal("run_steps", f"{label}: {n_do} steps from merge {v0b}",
                     [got[k] for k in keys], [want[k] for k in keys])
    applied = int((got["log"][0] >= 0).sum())
    work = fresh()

    def reset():
        work["words"].copy_(blk["words"])
        work["hist"].copy_(blk["hist"])
        work["log"].zero_()
        work["deltas"].zero_()
        if cand is not None:
            work["state"].copy_(cand[3])

    ms = _time_reset_ms([reset], [lambda: run_steps(n_do, v0b, work["words"], freqs, work["hist"],
                                                    work["log"], work["deltas"],
                                                    cand=work["cand"], scratch=scratch)])
    print(f"[run_steps] {label}: {n_do} steps ({applied} merges) from id {v0b}, "
          f"graph-replayed {ms:.4f} ms ({ms / n_do * 1e3:.2f} us a step)", flush=True)
    return dict(r, block=label, steps=n_do, merges=applied, v0b=v0b, ms=ms)


def drive_train(kernels_of: dict) -> dict:
    """The device trainer on the card at world size 1, every route on the
    golden files' corpus (``zipf_corpus(8000, seed=29, lo=100, hi=800)``),
    counting launches from 0 to the end of each: classic 50,000 and INL
    32,000 (K13 once, K14 a merge, the host's selection), classic 4,096
    (K13, then K15 -> K14 -> K16 a step) and INL 4,096 (windows), also with
    96 candidates a window (the host ends every window).  Each saves into a
    temporary directory; the 50K and 32K files equal the golden files byte
    for byte (the 50K one's warm-cache sidecar holds the tracked one's words
    and ids), the 4,096 routes' merges are the golden files' prefixes.
    Then K13-K16 against their plain versions (``check_train_kernels``)."""
    import contextlib
    import io
    import shutil
    import tempfile

    import torch

    from complexity_tokenizer_tpu_torch.parallel.trainer import DistributedInlTrainer
    from complexity_tokenizer_tpu_torch.trainers.inl_trainer import TrainerConfig
    from complexity_tokenizer_tpu_torch.utils.corpus import zipf_corpus

    t0 = time.perf_counter()
    texts = zipf_corpus(8000, seed=29, lo=100, hi=800)
    goldens = {}
    for path in (TOKENIZER_JSON, INL_32K):
        with open(path, "rb") as f:
            raw = f.read()
        merges = [tuple(m.split(" ")) for m in json.loads(raw)["model"]["merges"]]
        goldens[path] = (raw, merges)
    launches, walls = {}, {}
    tmp = tempfile.mkdtemp(prefix="ctok_train_")
    for label, cfg, window_t, golden, whole in TRAIN_ROUTES:
        DistributedInlTrainer._INL_WINDOW_T = window_t or 2048
        trainer = DistributedInlTrainer(TrainerConfig(**cfg))
        with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
            _res, counts, wall = _drive_launches(kernels_of, lambda: trainer.train_from_texts(texts))
        DistributedInlTrainer._INL_WINDOW_T = 2048
        raw, gmerges = goldens[golden]
        n = len(trainer.merges)
        if trainer.merges != gmerges[:n] or (whole and n != len(gmerges)):
            raise AssertionError(f"train {label}: {n} merges, not the golden file's")
        route = "device-resident" if getattr(trainer, "_select_block_times", None) else "per merge"
        on_host = n - sum(getattr(trainer, "_select_block_merges", []))
        need = {"pair_hist": 1, "merge_step": n}
        if route == "device-resident":
            steps = counts["select_pair"]
            need = {"pair_hist": 1, "select_pair": steps, "hist_update": steps,
                    "merge_step": steps + on_host}
            if steps < n - on_host or (window_t is not None) != (on_host > 0):
                raise AssertionError(f"train {label}: {steps} steps, {on_host} merges on the host")
        _need_only(f"train {label}", counts, need)
        if whole:
            out = os.path.join(tmp, f"{label.split()[0]}.json")
            trainer.save(out)
            with open(out, "rb") as f:
                if f.read() != raw:
                    raise AssertionError(f"train {label}: the saved file differs from {golden}")
            if golden == TOKENIZER_JSON:
                # the same words and ids; words of equal frequency come in
                # the order of the native count's threads
                blob = TOKENIZER_JSON.replace(".json", ".warmcache.npz")
                if _warm_cache_map(out.replace(".json", ".warmcache.npz")) != _warm_cache_map(blob):
                    raise AssertionError(f"train {label}: the warm-cache sidecar differs")
        launches[f"train {label}"] = counts
        walls[label] = dict(wall_s=wall, merges=n, merges_per_s=n / wall, route=route,
                            merges_on_host=on_host)
        print(f"[train] {label}: {route}, {n} merges ({on_host} with the host's walk), "
              f"wall {wall:.3f} s, {n / wall:.1f} merges/s; launches "
              + ", ".join(f"{k} {counts[k]}" for k in TRAIN_KERNELS), flush=True)
    shutil.rmtree(tmp)
    _phase("train routes", t0)
    t0 = time.perf_counter()
    checks = check_train_kernels(texts, goldens[TOKENIZER_JSON][1], goldens[INL_32K][1])
    # the host's share of each route's wall: the wall less the kernels' time
    # (each launch at the warm time of its check on the classic rows; K14 at
    # the mean of its times at the states)
    warm = {k: min(r["ms"] for r in checks[k] if "ms" in r) for k in TRAIN_KERNELS}
    # K14 on the per-merge routes: the mean of its warm times at the states
    per_merge = [r["ms"] for r in checks["merge_step"] if "merge" in r]
    k14_per_merge = sum(per_merge) / len(per_merge)
    for label, wl in walls.items():
        dev_s = sum(launches[f"train {label}"][k] * (k14_per_merge if k == "merge_step" else warm[k])
                    for k in TRAIN_KERNELS) / 1e3
        wl["kernel_s_est"] = dev_s
        wl["host_share_est"] = 1.0 - dev_s / wl["wall_s"]
        print(f"[train] {label}: kernels about {dev_s:.3f} s of {wl['wall_s']:.3f} s "
              f"(host share about {wl['host_share_est']:.4f})", flush=True)
    _phase("train kernels", t0)
    torch.cuda.synchronize()
    return {"launches": launches, "walls": walls, "checks": checks}


# ---------------------------------------------------------------------------
# the WordPiece and Unigram trainers (K12, K17-K19)

# the golden vocabularies (scripts/make_bench_unigram_32k.py,
# scripts/make_bench_wordpiece_30k.py)
UNIGRAM_32K = os.path.join(REPO, ".cache", "bench_unigram_32k.json")
WORDPIECE_30K = os.path.join(REPO, ".cache", "bench_wordpiece_30k.json")
TRAIN2_KERNELS = ("viterbi", "piece_hist", "train_match", "pair_count")
WP_CAPTURE_ROUNDS = (0, 1000, 10_000, -1)  # the rounds whose K18 inputs are checked (-1: last)
K19_ROUNDS = (0, 1000, 10_000, -1)  # the rounds K19 is timed at, beside the parent's (-1: last)
K18_ROUNDS = (0, 1000, 10_000, -1)  # the rounds K18 is timed at, beside the parent's (-1: last)


def _sorted_pairs(res):
    """K19's result as (keys, counts) int64 tensors in key order, its number
    and the poisoned words."""
    import torch

    from complexity_tokenizer_tpu_torch.ops.wordpiece_train_device import split_pairs

    keys, counts, n, n_poison = split_pairs(res.cpu())
    order = torch.argsort(keys.long())
    return keys.long()[order], counts.long()[order], n, n_poison


def _check_pairs(label: str, got, exp) -> dict:
    gk, gc, gn, gp = _sorted_pairs(got)
    ek, ec, en, ep = _sorted_pairs(exp)
    if (gn, gp) != (en, ep):
        raise AssertionError(f"pair_count kernel differs from its plain version: {label}: "
                             f"{gn} keys, {gp} poisoned against {en}, {ep}")
    r = _check_equal("pair_count", label, [gk, gc], [ek, ec])
    return dict(r, keys=gn, poisoned_words=gp)


def check_train2_kernels(ug_kept: dict, wp_kept: dict, edge_kept: dict) -> dict:
    """K12 (on the Unigram trainer's inputs: ``maxcand`` 16, the marker -2,
    the first E-step timed warm and cold), K17, K18 and K19 against their
    plain versions on the card, bit for bit (K19 as a set of (key, count),
    their number and the poisoned words): K17 on K12's results of the Unigram 32,000 run's
    E-steps (each with its poisoned pieces; timed at the first and the
    last), on a crafted result holding
    ids 0 and V - 1, fallbacks and poisoned texts, and on
    ``utils/corpus.py:piece_hist_edge_results`` (a hot id among them); K18 and K19 on the
    WordPiece 30,522 run's rounds ``WP_CAPTURE_ROUNDS`` (its last among
    them), on the edge run's (words of 1, 13, 127 and 128 characters) and on
    its tables with every form of two characters or more forged (which
    poisons the words that choose one).  K17 timed warm and cold on the main
    run's inputs, and plainly, beside the bound and the library call
    (``index_add_`` of the frequencies); K18's and K19's times are
    ``check_k18_rounds``'s and ``check_k19_rounds``'s."""
    import numpy as np
    import torch

    from complexity_tokenizer_tpu_torch.ops.unigram_device import (
        FALLBACK_ID,
        piece_hist,
        piece_hist_launch_shape,
        piece_hist_plain,
        viterbi,
        viterbi_ragged_plain,
    )
    from complexity_tokenizer_tpu_torch.ops.wordpiece_train_device import (
        PairCountScratch,
        pair_count,
        pair_count_plain,
        train_match,
        train_match_plain,
    )
    from complexity_tokenizer_tpu_torch.utils.corpus import piece_hist_edge_results

    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import study_train_match_variants as k18study

    out = {"viterbi": [], "piece_hist": [], "train_match": [], "pair_count": []}
    # K12 and K17 on the Unigram run's E-steps
    for r, inp in sorted(ug_kept.items()):
        vit = inp["viterbi"]
        res = viterbi(*vit)
        a = _check_equal("viterbi", f"Unigram 32,000 E-step {r} (maxcand {vit[12]}, marker "
                         f"{vit[13]})", res, viterbi_ragged_plain(*vit[:3], *vit[4:]))
        if r == min(ug_kept):
            ms = _time_ms(lambda: viterbi(*vit), 20)
            sets = _cold_sets(vit[:3], 4 * res.numel())
            ms_cold = _time_cold_ms(lambda c, o, n: viterbi(c, o, n, *vit[3:]), sets, 20)
            del sets
            a.update(ms=ms, ms_cold=ms_cold, pieces=int(vit[8].shape[0]))
            print(f"[viterbi] trainer E-step {r}: {a['pieces']} pieces, {vit[2].numel()} texts: "
                  f"warm={ms:.4f} cold={ms_cold:.4f} ms", flush=True)
        out["viterbi"].append(a)
        offs, freqs, gidx, V, n_global = inp["piece_hist"]
        B = offs.numel() - 1
        N = res.numel() - 2 * B
        label = f"Unigram 32,000 E-step {r} (V {V}, {B} texts)"
        got = piece_hist(res, offs, freqs, gidx, V, n_global)
        exp = piece_hist_plain(res, offs, freqs, gidx, V, n_global)
        c = _check_equal("piece_hist", label, got, exp)
        poisoned = int(exp[V:].sum())
        c.update(poisoned=poisoned, shape=[N, B, V])
        # timed at the first E-step (the largest V: the clear's bytes) and
        # the last (the smallest V: the atomics)
        if r in (min(ug_kept), max(ug_kept)):
            args = (res, offs, freqs, gidx)
            fn = lambda x, o, f, g: piece_hist(x, o, f, g, V, n_global)  # noqa: E731
            ms = _time_ms(lambda: fn(*args), 20)
            sets = _cold_sets(args, 4 * (V + n_global))
            ms_cold = _time_cold_ms(fn, sets, 20)
            del sets
            plain_ms = _time_ms(lambda: piece_hist_plain(res, offs, freqs, gidx, V, n_global), 3,
                                graph=False)
            # the library call: index_add_ of the frequencies at the ids
            word = torch.repeat_interleave(torch.arange(B, device="cuda"),
                                           (offs[1:] - offs[:-1]).long())
            ids = res[:N]
            ok = (ids >= 0) & (res[N + B:][word] == 0)
            lib_ids, lib_f = ids[ok].long(), freqs[word[ok]]
            library_ms = _time_ms(lambda: torch.zeros(V, dtype=torch.int32, device="cuda")
                                  .index_add_(0, lib_ids, lib_f), 20)
            bound_ms, bound_by = _bound(4 * (N + 4 * B + 1) + 4 * (V + n_global), N)
            c.update(ms=ms, ms_cold=ms_cold, plain_ms=plain_ms, library_ms=library_ms,
                     bound_ms=bound_ms, bound_by=bound_by, launch=piece_hist_launch_shape())
            print(f"[piece_hist] {label}: warm={ms:.4f} cold={ms_cold:.4f} plain={plain_ms:.4f} "
                  f"library={library_ms:.4f} bound={bound_ms:.5f} ms ({bound_by}); "
                  f"{poisoned} poisoned; launch {c['launch']}", flush=True)
        out["piece_hist"].append(c)
    # K17 on a crafted result: ids 0 and V - 1, fallbacks, -1, poisoned texts
    rng = np.random.RandomState(5)
    V, B = 32_000, 4096
    lens = rng.randint(0, 129, size=B)
    offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    ids = rng.randint(-1, V, size=offs[-1]).astype(np.int32)
    ids[::5] = 0
    ids[2::7] = V - 1
    ids[3::11] = FALLBACK_ID
    poison = (rng.rand(B) < 0.1).astype(np.int32)
    res = torch.from_numpy(np.concatenate([ids, lens.astype(np.int32), poison])).cuda()
    freqs = torch.from_numpy(rng.randint(1, 1 << 12, size=B).astype(np.int32)).cuda()
    gidx = torch.from_numpy(rng.permutation(B + 7)[:B].astype(np.int32)).cuda()
    o = torch.from_numpy(offs).cuda()
    exp = piece_hist_plain(res, o, freqs, gidx, V, B + 7)
    if not (int(exp[0]) > 0 and int(exp[V - 1]) > 0 and int(exp[V:].sum()) == int(poison.sum())):
        raise AssertionError("piece_hist: the crafted result does not reach ids 0 and V - 1")
    out["piece_hist"].append(_check_equal("piece_hist", "crafted: ids 0 and V - 1, fallbacks, "
                                          "poisoned texts", piece_hist(res, o, freqs, gidx, V, B + 7),
                                          exp))
    # K17 on utils/corpus.py:piece_hist_edge_results: a hot id most texts
    # choose, texts of no slot, texts of 100 slots and more, every text
    # poisoned, one text, V = 1, ids at and past V
    for label, *arrays, Ve, ne in piece_hist_edge_results():
        args = [torch.from_numpy(a).cuda() for a in arrays]
        out["piece_hist"].append(_check_equal("piece_hist", f"crafted: {label}",
                                              piece_hist(*args, Ve, ne),
                                              piece_hist_plain(*args, Ve, ne)))
    print(f"[piece_hist] launch {piece_hist_launch_shape()}", flush=True)

    # K18 and K19 on the WordPiece runs' rounds
    cases = [(f"WordPiece round {r}", inp) for r, inp in sorted(wp_kept.items())]
    cases += [(f"edge words round {r}", inp) for r, inp in sorted(edge_kept.items())]
    last = dict(edge_kept[max(edge_kept)])
    last["slot_chars"] = last["slot_chars"].clone()
    last["slot_chars"][last["slot_meta"][:, 0] >= 2, 0] += 1
    cases.append(("edge words, forms of 2+ characters forged", last))
    for label, inp in cases:
        args = k18study.match_args(inp)
        N, B = inp["chars"].numel(), inp["lens"].numel()
        m, p = train_match(*args)
        mp_, pp = train_match_plain(*args)
        c = _check_equal("train_match", label, [m, p], [mp_, pp])
        c.update(poisoned=int(pp.sum()), shape=[N, B], lt_cap=inp["lt_cap"],
                 groups=list(inp["groups"]))
        if "forged" in label and c["poisoned"] == 0:
            raise AssertionError("train_match: the forged rows poisoned no word")
        scratch = PairCountScratch(N, "cuda")
        got = pair_count(m, inp["offs"], inp["freqs"], p, scratch)
        d = _check_pairs(label, got, pair_count_plain(m, inp["offs"], inp["freqs"], p,
                                                      scratch.t_size))
        d.update(shape=[N, B], table=scratch.t_size)
        out["train_match"].append(c)
        out["pair_count"].append(d)
    return out


def _pair_keys(out, offs, freqs, poison):
    """The adjacent pairs' keys and weights of K18's output (the input of the
    library call beside K19): weight 0 pairs of poisoned words left out."""
    import torch

    B = offs.numel() - 1
    word = torch.repeat_interleave(torch.arange(B, device=out.device), (offs[1:] - offs[:-1]).long())
    live = torch.nonzero(out >= 0)[:, 0]
    w = word[live]
    same = (w[:-1] == w[1:]) & (poison[w[:-1]] == 0)
    keys = (out[live[:-1]][same].long() << 16) | out[live[1:]][same].long()
    return keys, freqs[w[:-1][same]]


def check_k19_rounds(timer, parent) -> list:
    """K19 (this package's wrapper) and the parent's (``parent``, a
    ``scripts/study_pair_count_variants.py:K19``) at the WordPiece 30,522
    rounds ``timer`` kept (its ``K19_ROUNDS``): each against the plain
    version bit for bit (a set of (key, count), their number, the poisoned
    words); timed warm and cold in turns (parent, this, this, parent),
    plainly and beside the library call (``torch.unique(return_inverse=True)``
    then ``index_add_`` over the pairs' keys) and the bound (4 B a slot,
    offset, frequency and flag in, 8 B a key out); the pairs, keys and the
    atomics on the hottest key."""
    import torch

    from complexity_tokenizer_tpu_torch.ops.wordpiece_train_device import (
        PairCountScratch,
        pair_count,
        pair_count_launch_shape,
        pair_count_plain,
    )

    recs = []
    for r in K19_ROUNDS:
        if r == -1:
            r, *inp = timer.kept[-1]
        else:
            inp = timer.kept[r]
        o, offs, freqs, poison = inp
        N, B = o.numel(), offs.numel() - 1
        label = f"WordPiece 30,522 round {r}"
        scratch = PairCountScratch(N, "cuda")
        exp = pair_count_plain(o, offs, freqs, poison, scratch.t_size)
        d = _check_pairs(label, pair_count(o, offs, freqs, poison, scratch), exp)
        _check_pairs(f"{label} (the parent's K19)", parent(o, offs, freqs, poison,
                                                            parent.scratch(N)), exp)
        keys, wts = _pair_keys(o, offs, freqs, poison)
        hottest = int(torch.unique(keys, return_counts=True)[1].max()) if keys.numel() else 0
        args = (o, offs, freqs, poison)
        runs = {"this": [], "parent": []}
        n_sets = -(-COLD_BYTES // (4 * (N + 3 * B + 1) + 4 * (3.5 * scratch.t_size + 6)))
        for who in ("parent", "this", "this", "parent"):
            if who == "this":
                fn = lambda a, b, c, d_, sc: pair_count(a, b, c, d_, sc)  # noqa: E731
                mk = lambda: PairCountScratch(N, "cuda")  # noqa: E731
            else:
                fn, mk = parent, (lambda: parent.scratch(N))
            sc = mk()
            warm = _time_ms(lambda: fn(*args, sc), 20)
            sets = [tuple(t.clone() for t in args) + (mk(),) for _ in range(int(n_sets))]
            cold = _time_cold_ms(fn, sets, 20)
            del sets, sc
            runs[who].append(dict(warm=warm, cold=cold))
        plain_ms = _time_ms(lambda: pair_count_plain(*args, scratch.t_size), 2, graph=False)

        def library():
            u, inv = torch.unique(keys, return_inverse=True)
            return torch.zeros(u.numel(), dtype=torch.int32, device="cuda").index_add_(
                0, inv, wts)

        library_ms = _time_ms(library, 5, graph=False)
        bound_ms, bound_by = _bound(4 * (N + 3 * B + 1) + 8 * d["keys"] + 8, keys.numel())
        mean = lambda who, k: sum(x[k] for x in runs[who]) / 2  # noqa: E731
        d.update(round=r, shape=[N, B], table=scratch.t_size, pairs=int(keys.numel()),
                 hottest_key_atomics=hottest, ms=mean("this", "warm"),
                 ms_cold=mean("this", "cold"), parent_ms=mean("parent", "warm"),
                 parent_ms_cold=mean("parent", "cold"), turns=runs, plain_ms=plain_ms,
                 library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                 launch=pair_count_launch_shape())
        print(f"[pair_count] {label}: [{N} slots, {B} words] {d['pairs']} pairs, {d['keys']} keys "
              f"(the hottest {hottest} pairs), table {scratch.t_size}: in turns warm "
              + " ".join(f"{w}={x['warm']:.4f}" for w in ("parent", "this") for x in runs[w])
              + " cold " + " ".join(f"{w}={x['cold']:.4f}" for w in ("parent", "this")
                                    for x in runs[w])
              + f" ms; plain={plain_ms:.4f} library={library_ms:.4f} bound={bound_ms:.5f} ms "
              f"({bound_by}); launch {d['launch']}", flush=True)
        recs.append(d)
        del keys, wts, scratch
    return recs


def check_k18_rounds(timer, parent) -> list:
    """K18 (this package's wrapper) and the parent's (``parent``, a
    ``scripts/study_train_match_variants.py:K18``) at the WordPiece 30,522
    rounds ``timer`` kept (its ``K18_ROUNDS``): each against the plain
    version bit for bit (``out`` and ``poison``); timed warm and cold in
    turns (parent, this, this, parent), plainly and beside the bound (the
    words in, the symbols and flags out, and the table bytes the round's
    probes need, each once: ``_k18_need``); the round's words, characters,
    ``lt_cap``, lane groups and probes, and K18's launch shape."""
    import torch

    from complexity_tokenizer_tpu_torch.ops.wordpiece_train_device import (
        train_match,
        train_match_launch_shape,
        train_match_plain,
    )

    import study_train_match_variants as k18study

    recs = []
    for r, inp in k18study.state_items(timer.kept):
        args = k18study.match_args(inp)
        N, B = inp["chars"].numel(), inp["lens"].numel()
        label = f"WordPiece 30,522 round {r}"
        exp = train_match_plain(*args)
        c = _check_equal("train_match", label, list(train_match(*args)), list(exp))
        _check_equal("train_match", f"{label} (the parent's K18)", list(parent(*args)), list(exp))
        tensors = [i for i, a in enumerate(args) if isinstance(a, torch.Tensor)]
        per_set = 4 * (N + B) + sum(args[i].numel() * 4 for i in tensors)
        runs = {"this": [], "parent": []}
        for who in ("parent", "this", "this", "parent"):
            k = train_match if who == "this" else parent
            warm = _time_ms(lambda: k(*args), 20)

            def cold_fn(*ts, k=k):
                a = list(args)
                for i, t in zip(tensors, ts):
                    a[i] = t
                return k(*a)

            sets = [tuple(args[i].clone() for i in tensors)
                    for _ in range(-(-COLD_BYTES // per_set))]
            cold = _time_cold_ms(cold_fn, sets, 20)
            del sets
            runs[who].append(dict(warm=warm, cold=cold))
        plain_ms = _time_ms(lambda: train_match_plain(*args), 2, graph=False)
        # the bytes: the words in, the symbols and poison flags out, and the
        # table's bytes that the round's probes need, each once
        n_probe, table_bytes = _k18_need(inp)
        bound_ms, bound_by = _bound(4 * (N + 2 * B + 1) + 4 * (N + B) + table_bytes,
                                    14 * n_probe)
        if r == 1000:
            c["host_us"] = _k18_host_us(args)
            print(f"[train_match] {label}: the wrapper's host time a call "
                  + ", ".join(f"{k} {v:.2f} us" for k, v in c["host_us"].items()), flush=True)
        mean = lambda who, key: sum(x[key] for x in runs[who]) / 2  # noqa: E731
        c.update(round=r, shape=[N, B], lt_cap=inp["lt_cap"], groups=list(inp["groups"]),
                 poisoned=int(exp[1].sum()), probes=n_probe, table_bytes=table_bytes,
                 ms=mean("this", "warm"), ms_cold=mean("this", "cold"),
                 parent_ms=mean("parent", "warm"), parent_ms_cold=mean("parent", "cold"),
                 turns=runs, plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms,
                 bound_by=bound_by, launch=train_match_launch_shape())
        print(f"[train_match] {label}: [{N} chars, {B} words, groups {tuple(inp['groups'])}] "
              f"lt_cap {inp['lt_cap']}, {n_probe} probes: in turns warm "
              + " ".join(f"{w}={x['warm']:.4f}" for w in ("parent", "this") for x in runs[w])
              + " cold " + " ".join(f"{w}={x['cold']:.4f}" for w in ("parent", "this")
                                    for x in runs[w])
              + f" ms; plain={plain_ms:.4f} bound={bound_ms:.5f} ms ({bound_by}); launch "
              f"{c['launch']}", flush=True)
        recs.append(c)
    return recs


def _k18_host_us(args, n: int = 2000) -> dict:
    """The host's microseconds a call of K18's wrapper on these arguments
    (each mean over ``n`` calls, the launches left queued on the card):
    its argument checks (``_check_match``), the ctypes call of the entry
    alone (into buffers made once), and the whole wrapper (the checks, two
    ``torch.empty``, the ctypes call and the count)."""
    import torch

    from complexity_tokenizer_tpu_torch.ops.wordpiece_train_device import _check_match, train_match
    from complexity_tokenizer_tpu_torch.utils.cuda_build import kernel_library

    chars, offs, lens, groups, table, meta, schars, fb, lt_cap = args
    out = torch.empty(chars.numel(), dtype=torch.int32, device="cuda")
    poison = torch.empty(lens.numel(), dtype=torch.int32, device="cuda")
    entry = kernel_library().lib.ctok_train_match
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = (chars.data_ptr(), offs.data_ptr(), lens.data_ptr(), int(groups[0]), int(groups[1]),
            lens.numel(), table.data_ptr(), table.shape[0] - 1, meta.data_ptr(), schars.data_ptr(),
            fb.data_ptr(), lt_cap, out.data_ptr(), poison.data_ptr(), stream)

    def per_call(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        t = time.perf_counter() - t0
        torch.cuda.synchronize()
        return 1e6 * t / n

    return dict(checks=per_call(lambda: _check_match(*args)),
                ctypes=per_call(lambda: entry(*ptrs)), wrapper=per_call(lambda: train_match(*args)))


def _k18_need(inp) -> tuple[int, int]:
    """The candidates K18 probes on these inputs and the table bytes they
    need, each once: the greedy walk's starts from the plain version's
    pieces, every length up to lt_cap that fits hashed and probed as the
    kernel probes it (from the mixed hash's row to the key's row or an empty
    one, at most 16 rows).  The bytes: each distinct table row touched
    (16 B), each distinct slot entry a hit reads (8 B), the characters of
    each distinct longest hit checked (4 B each) and each distinct fallback
    symbol a miss reads (4 B)."""
    import torch

    from complexity_tokenizer_tpu_torch.ops.hashtable import mix_hash
    from complexity_tokenizer_tpu_torch.ops.wordpiece_device import (
        _B1,
        _B2,
        _M32,
        _SEED_CONT1,
        _SEED_CONT2,
        _to_i32,
    )
    from complexity_tokenizer_tpu_torch.ops.wordpiece_train_device import (
        MAXP,
        MAX_CP,
        train_match_plain,
    )

    out, _poison = train_match_plain(inp["chars"], inp["offs"], inp["lens"], inp["groups"],
                                     inp["table"], inp["slot_meta"], inp["slot_chars"],
                                     inp["fb_map"], inp["lt_cap"])
    chars, offs, lens = inp["chars"].long(), inp["offs"].long(), inp["lens"].long()
    table, meta = inp["table"], inp["slot_meta"]
    mask = table.shape[0] - 1
    starts = torch.nonzero(out >= 0)[:, 0]
    word = torch.searchsorted(offs, starts, right=True) - 1
    rest = lens[word] - (starts - offs[word])
    cont = starts > offs[word]
    h1 = torch.where(cont, _SEED_CONT1, 0)
    h2 = torch.where(cont, _SEED_CONT2, 0)
    best_l = torch.zeros_like(starts)
    best = torch.zeros_like(starts)
    rows, slots, n_cand = [], [], 0
    for length in range(1, inp["lt_cap"] + 1):
        live = torch.nonzero(rest >= length)[:, 0]
        if live.numel() == 0:
            break
        n_cand += live.numel()
        u = chars[starts[live] + length - 1] + 1
        h1[live] = (h1[live] * _B1 + u) & _M32
        h2[live] = (h2[live] * _B2 + u) & _M32
        k1, k2 = _to_i32(h1[live]), _to_i32(h2[live])
        base = mix_hash(k1, k2, mask).long()
        slot = torch.full_like(live, -1)
        going = torch.ones_like(live, dtype=torch.bool)
        for j in range(MAXP):
            r = (base + j) & mask
            rows.append(r[going])
            t = table[r]
            hit = going & (t[:, 0] == k1) & (t[:, 1] == k2)
            slot = torch.where(hit, t[:, 2].long(), slot)
            going &= ~hit & ~((t[:, 0] == 0) & (t[:, 1] == 1))
        slots.append(slot[slot >= 0])
        ok = (slot >= 0) & (meta[slot.clamp(min=0), 0] == length)
        best_l[live[ok]] = length
        best[live[ok]] = slot[ok]
    read = torch.unique(torch.cat(slots))
    checked = torch.unique(best[best_l > 0])
    miss = best_l == 0
    fb = torch.unique(cont[miss].long() * MAX_CP + chars[starts[miss]].clamp(0, MAX_CP - 1))
    n_rows = min(int(torch.unique(torch.cat(rows)).numel()), table.shape[0])
    return n_cand, (16 * n_rows + 8 * read.numel() + 4 * int(meta[checked, 0].sum())
                    + 4 * fb.numel())


def drive_train2(kernels_of: dict, wp_size: int = 30_522) -> dict:
    """The WordPiece and Unigram trainers on the card at world size 1, each
    run's launches counted from 0 to its end and each launching its kernels
    and no other, on ``zipf_corpus(10_000, seed=17)`` and the multilingual
    pieces:
    - ``DistributedUnigramTrainer`` at t5-base's 32,000 pieces (the JAX
      defaults, ``vocab_size=31_997``; every word its own text), its
      ``[piece, score]`` list byte for byte ``.cache/bench_unigram_32k.json``;
      K12 and K17 once a device E-step;
    - ``DistributedWordPieceTrainer`` at bert-base-uncased's 30,522 (the JAX
      defaults), its vocabulary entry for entry
      ``.cache/bench_wordpiece_30k.json``; K18 and K19 once a round;
    - the same at 400 entries on ``utils/corpus.py:wordpiece_train_edge_texts``
      (words of 1, 13, 127, 128 and 129 characters), equal to the host
      trainer's.
    Prints the walls, rounds, poisoned and over-wide words and sentences,
    the host's table builds and ms a round.  Then K17-K19 against their
    plain versions, and K12 on the Unigram run's E-steps
    (``check_train2_kernels``)."""
    import contextlib
    import io

    import torch

    from complexity_tokenizer_tpu_torch.parallel.unigram_trainer import DistributedUnigramTrainer
    from complexity_tokenizer_tpu_torch.parallel.wordpiece_trainer import (
        DistributedWordPieceTrainer,
    )
    from complexity_tokenizer_tpu_torch.trainers import (
        UnigramTrainerConfig,
        WordPieceTrainer,
        WordPieceTrainerConfig,
    )
    from complexity_tokenizer_tpu_torch.utils.corpus import (
        MULTI_PIECES,
        wordpiece_30k_vocab,
        wordpiece_train_edge_texts,
        zipf_corpus,
    )

    t0 = time.perf_counter()
    texts = zipf_corpus(10_000, seed=17) + list(MULTI_PIECES)
    launches, walls = {}, {}

    # Unigram 32,000: every device E-step's inputs kept for K17's check
    ug_kept = {}
    words = [w for t in texts for w in t.split()]
    trainer = DistributedUnigramTrainer(UnigramTrainerConfig(vocab_size=31_997))
    trainer.capture = ug_kept.__setitem__
    with contextlib.redirect_stdout(io.StringIO()):
        model, counts, wall = _drive_launches(kernels_of, lambda: trainer.train_from_texts(words))
    pieces = [[model.vocab_r[i], model.vocab[model.vocab_r[i]][1]] for i in range(len(model.vocab_r))]
    raw = json.dumps(pieces, ensure_ascii=False).encode("utf-8")
    with open(UNIGRAM_32K, "rb") as f:
        if raw != f.read():
            raise AssertionError("train Unigram 32,000: the pieces differ from the golden file")
    dev_rounds = [r for r in trainer.rounds if r["route"] == "device"]
    for r in trainer.rounds:
        if r["route"] != "device":
            print(f"[train] Unigram 32,000: an E-step on the host ({r['reason']}, "
                  f"{r['pieces']} pieces)", flush=True)
    _need_only("train Unigram 32,000", counts,
               {"viterbi": len(dev_rounds), "piece_hist": len(dev_rounds)})
    launches["train Unigram 32,000"] = counts
    table_s = sum(r["table_s"] for r in trainer.rounds)
    walls["Unigram 32,000"] = dict(
        wall_s=wall, words=len(words), pieces=len(pieces), em_rounds=len(trainer.rounds),
        device_rounds=len(dev_rounds), table_s=table_s,
        to_card_s=sum(r["to_card_s"] for r in dev_rounds),
        e_step_s=sum(r["e_step_s"] for r in dev_rounds),
        rounds=[{k: v for k, v in r.items()} for r in trainer.rounds])
    print(f"[train] Unigram 32,000: {len(words)} words, {len(pieces)} pieces byte for byte the "
          f"golden file; wall {wall:.3f} s, {len(trainer.rounds)} EM rounds, {len(dev_rounds)} "
          f"with K12 and K17; host table builds {table_s:.3f} s; launches "
          + ", ".join(f"{k} {counts[k]}" for k in TRAIN2_KERNELS), flush=True)
    for i, r in enumerate(trainer.rounds):
        print(f"  E-step {i}: {r['route']}, {r['pieces']} pieces, tables {r['table_s']:.3f} s"
              + (f", to the card {r['to_card_s']:.4f} s, E-step {r['e_step_s']:.3f} s, "
                 f"{r['poisoned']} poisoned, {r['over_wide']} over 128" if r["route"] == "device"
                 else ""), flush=True)
    del trainer, model

    # WordPiece 30,522, and the edge words at 400
    golden = wordpiece_30k_vocab()

    def keeper(kept, rounds):
        """A capture hook keeping the inputs of ``rounds`` (-1: the last, kept
        under its number by ``keep.finish()``: the mirror is written only by
        the next round's update, so they are still whole when the run
        ends)."""
        last = []

        def clone(inp):
            return {k: v.clone() if isinstance(v, torch.Tensor) else v for k, v in inp.items()}

        def keep(r, inp):
            if r in rounds:
                kept[r] = clone(inp)
            last[:] = [r, inp]

        def finish():
            if -1 in rounds and last:
                kept[last[0]] = clone(last[1])
        keep.finish = finish
        return keep

    wp_kept, edge_kept = {}, {}
    for label, size, corpus, kept, rounds in (
        (f"WordPiece {wp_size:,}", wp_size, texts, wp_kept, WP_CAPTURE_ROUNDS),
        ("WordPiece edge words 400", 400, wordpiece_train_edge_texts(), edge_kept, (0, 40, 300)),
    ):
        trainer = DistributedWordPieceTrainer(WordPieceTrainerConfig(vocab_size=size))
        trainer.capture = keeper(kept, rounds)
        model, counts, wall = _drive_launches(kernels_of, lambda: trainer.train_from_texts(corpus))
        trainer.capture.finish()
        entries = sorted(model.vocab, key=model.vocab.__getitem__)
        st = trainer.last_stats
        if st["route"] != "device":
            raise AssertionError(f"train {label}: the host trainer ran ({st})")
        if size == wp_size:
            if entries != golden[:size]:
                n_same = next((i for i, (a, b) in enumerate(zip(entries, golden)) if a != b),
                              min(len(entries), len(golden)))
                raise AssertionError(f"train {label}: {len(entries)} entries, the golden file's "
                                     f"{len(golden)}; the first {n_same} equal")
        else:
            host = WordPieceTrainer(WordPieceTrainerConfig(vocab_size=size))
            host.train_from_texts(corpus)
            if host.vocab != model.vocab or st["over_wide"] == 0:
                raise AssertionError(f"train {label}: the card's vocabulary differs from the host's")
        _need_only(f"train {label}", counts, {"train_match": st["rounds"], "pair_count": st["rounds"]})
        launches[f"train {label}"] = counts
        walls[label] = dict(wall_s=wall, entries=len(entries), rounds=st["rounds"],
                            poisoned=st["poisoned"], over_wide=st["over_wide"],
                            device_ms_per_round=1e3 * st["device_s"] / st["rounds"],
                            host_ms_per_round=1e3 * st["host_s"] / st["rounds"])
        print(f"[train] {label}: {len(entries)} entries"
              + (" entry for entry the golden file" if size == wp_size else ", the host trainer's")
              + f"; wall {wall:.3f} s, {st['rounds']} rounds, launches "
              + ", ".join(f"{k} {counts[k]}" for k in TRAIN2_KERNELS)
              + f"; {st['poisoned']} poisoned word-rounds, {st['over_wide']} words over 128; "
              f"launch and read back {walls[label]['device_ms_per_round']:.3f} ms a round, "
              f"host {walls[label]['host_ms_per_round']:.3f} ms a round", flush=True)
        del trainer, model
    _phase("train WordPiece and Unigram", t0)

    # K19 beside the parent's: its route (K19 and readback), then both K19s
    # and both K18s in turns every round, their inputs kept at K19_ROUNDS
    # and K18_ROUNDS
    t0 = time.perf_counter()
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import study_pair_count_variants as k19study
    import study_train_match_variants as k18study

    from complexity_tokenizer_tpu_torch.utils.cuda_build import kernel_library

    parent = k19study.K19(k19study.build({"parent": (k19study.PARENT_SRC, "")})["parent"],
                          parent=True)
    parent18 = k18study.K18(k18study.build({"parent": (k18study.PARENT_SRC, "")})["parent"],
                            parent=True)
    this = f"WordPiece {wp_size:,}"
    timer = k19study.RoundTimer({"this": k19study.K19(kernel_library().lib), "parent": parent},
                                keep=K19_ROUNDS)
    timer18 = k18study.RoundTimer({"this": k18study.K18(kernel_library().lib),
                                   "parent": parent18}, keep=K18_ROUNDS)

    @contextlib.contextmanager
    def both_timers():
        with timer.installed(), timer18.installed():
            yield

    for label, route in ((f"{this} (the parent's K19 and readback)", k19study.parent_route(parent)),
                         (f"{this} (both K19s and both K18s in turns a round)", both_timers())):
        trainer = DistributedWordPieceTrainer(WordPieceTrainerConfig(vocab_size=wp_size))
        with route, contextlib.redirect_stdout(io.StringIO()):
            model, _counts, wall = _drive_launches(kernels_of,
                                                   lambda: trainer.train_from_texts(texts))
        st = trainer.last_stats
        if sorted(model.vocab, key=model.vocab.__getitem__) != golden[:wp_size]:
            raise AssertionError(f"train {label}: the vocabulary is not the golden file's")
        walls[label] = dict(wall_s=wall, rounds=st["rounds"],
                            device_ms_per_round=1e3 * st["device_s"] / st["rounds"],
                            host_ms_per_round=1e3 * st["host_s"] / st["rounds"])
        print(f"[train] {label}: entry for entry the golden file; wall {wall:.3f} s (this "
              f"route {walls[this]['wall_s']:.3f}), launch and read back "
              f"{walls[label]['device_ms_per_round']:.3f} ms a round (this route "
              f"{walls[this]['device_ms_per_round']:.3f}), host "
              f"{walls[label]['host_ms_per_round']:.3f} ms a round (this route "
              f"{walls[this]['host_ms_per_round']:.3f})", flush=True)
        del trainer, model
    k19_run = dict(rounds=timer.rounds, ms=timer.ms)
    k18_run = dict(rounds=timer18.rounds, ms=timer18.ms)
    print(f"[pair_count] over the {timer.rounds} rounds of {this}, in turns a round: "
          f"{timer.ms['this']:.3f} ms, the parent's {timer.ms['parent']:.3f} ms", flush=True)
    print(f"[train_match] over the {timer18.rounds} rounds of {this}, in turns a round: "
          f"{timer18.ms['this']:.3f} ms, the parent's {timer18.ms['parent']:.3f} ms", flush=True)
    if timer18.rounds != timer.rounds:
        raise AssertionError("the two round timers saw different rounds")
    _phase("train WordPiece beside the parent's K19 and K18", t0)
    t0 = time.perf_counter()
    checks = check_train2_kernels(ug_kept, wp_kept, edge_kept)
    checks["train_match"] += check_k18_rounds(timer18, parent18)
    checks["pair_count"] += check_k19_rounds(timer, parent)
    _phase("train WordPiece and Unigram kernels", t0)
    torch.cuda.synchronize()
    return {"launches": launches, "walls": walls, "checks": checks, "k19_run": k19_run,
            "k18_run": k18_run}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=17, help="corpus and input seed")
    ap.add_argument("--texts", type=int, default=10_000, help="Zipf texts")
    ap.add_argument("--parent", default=None,
                    help="a checkout of an earlier commit whose K8 and K11 (dense), K12 (a warp "
                         "a text) or K4 are built and timed beside these "
                         "(scripts/parent_word_kernels.py)")
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
            merge_word_rows_qc,
            merge_words,
            merge_words_qc,
        )
        from complexity_tokenizer_tpu_torch.ops.normalize_device import norm_stable_rows
        from complexity_tokenizer_tpu_torch.ops.pipeline import pack_texts
        from complexity_tokenizer_tpu_torch.ops.presplit import presplit
        from complexity_tokenizer_tpu_torch.ops.seed import seed_tokens
        from complexity_tokenizer_tpu_torch.ops.wordfill import (
            fill_compact,
            fill_compact_phased,
            phase_compact,
            word_ids,
            word_ids_plain,
            word_merge,
        )
        from complexity_tokenizer_tpu_torch.ops.wordpiece_device import (
            wordlevel_lookup,
            wordpiece_match,
        )
        from complexity_tokenizer_tpu_torch.ops.unigram_device import piece_hist, viterbi
        from complexity_tokenizer_tpu_torch.ops import trainer_device
        from complexity_tokenizer_tpu_torch.ops.wordpiece_train_device import (
            pair_count,
            train_match,
        )
        from complexity_tokenizer_tpu_torch.utils.corpus import (
            RUN_BREAKS,
            edge_word_pack,
            long_token_vocab,
            presplit_edge_rows,
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
    for path in (TOKENIZER_JSON, TOKENIZER_100K, INL_32K, UNIGRAM_32K, WORDPIECE_30K):
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

    parent_build: dict = {}

    def build_parent():
        try:
            sys.path.insert(0, os.path.join(REPO, "scripts"))
            from parent_word_kernels import ParentKernels

            parent_build["kernels"] = ParentKernels(args.parent)
        except BaseException as e:  # raised below, in this thread
            parent_build["error"] = e

    builder = threading.Thread(target=build_native)
    builder.start()
    parent_thread = threading.Thread(target=build_parent)
    if args.parent:
        parent_thread.start()
    lib = kernel_library()
    builder.join()
    if "error" in native_build:
        raise native_build["error"]
    if args.parent:
        parent_thread.join()
        if "error" in parent_build:
            raise parent_build["error"]
        pk = parent_build["kernels"]
        print(f"parent's {', '.join(pk.kernels)} ({args.parent}): {pk.build_seconds:.3f} s nvcc")
        fn = ""
        for line in pk.ptxas_log.splitlines():  # the bound kernels' entries only
            if "Compiling entry function" in line:
                fn = line
            elif "registers" in line and any(k in fn for k in (
                    "norm_check_kernel", "wordlevel_kernel", "viterbi_kernel",
                    "fill_compact_kernel")):
                print("  parent " + fn.split("'")[1] + ": " + line.split(":", 1)[-1].strip())
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
                  "wordlevel_lookup": wordlevel_lookup, "viterbi": viterbi,
                  **{k: getattr(trainer_device, k) for k in TRAIN_KERNELS},
                  "piece_hist": piece_hist, "train_match": train_match, "pair_count": pair_count,
                  "phase_compact": phase_compact, "fill_compact_phased": fill_compact_phased,
                  "presplit": presplit, "merge_word_rows_qc": merge_word_rows_qc}
    r50 = drive_paths("50K", TOKENIZER_JSON, texts, kernels_of, native)
    r100 = drive_paths("100K", TOKENIZER_100K, texts, kernels_of, native)
    s50 = drive_shards("50K", r50, texts, kernels_of, native)
    s100 = drive_shards("100K", r100, texts, kernels_of, native)
    d50 = drive_decode("50K", r50["tok"], r50["host"], kernels_of)
    d100 = drive_decode("100K", r100["tok"], r100["host"], kernels_of)
    added = drive_added_tokens(TOKENIZER_JSON, texts, kernels_of)
    call50 = drive_call("50K", TOKENIZER_JSON, texts, r50["host"], kernels_of)
    call100 = drive_call("100K", TOKENIZER_100K, texts, r100["host"], kernels_of)
    warm = drive_warm_cache(texts, r100["host"])
    norm = drive_norm(texts, r50["host"], kernels_of, parent_build.get("kernels"))
    mdl = drive_models(texts, kernels_of, parent_build.get("kernels"))
    train = drive_train(kernels_of)
    train2 = drive_train2(kernels_of)
    # the paths of the later slices, by name, for every kernel's launches_by_path
    new_paths = {**s50["launches"], **s100["launches"], **norm["launches"],
                 **{f"model {k}": v for k, v in mdl["launches"].items()},
                 **train["launches"], **train2["launches"]}
    # every kernel of a path was launched on it and no other: the text
    # pipeline runs K21, K1 and the fixpoint of its table once a batch, the
    # word paths one K6 (K3, K1 and the fixpoint folded into it) and one K4
    # a pack
    for label, r, fixpoint in (("50K", r50, "merge_fixpoint_qc"), ("100K", r100, "merge_fixpoint_chd")):
        for path_name, counts in r["launches"].items():
            text = path_name == "text pipeline"
            need = [fixpoint, "seed_tokens", "presplit"] if text else ["word_merge", "fill_compact"]
            for name, n in counts.items():
                if (n > 0) != (name in need):
                    raise AssertionError(f"kernel {name} was launched {n} times on the {label} {path_name}")
            if not text and counts["word_merge"] != counts["fill_compact"]:
                raise AssertionError(f"K6 and K4 launched unequally on the {label} {path_name}")
            if text and not counts["presplit"] == counts["seed_tokens"] == counts[fixpoint]:
                raise AssertionError(f"K21, K1 and the fixpoint launched unequally on the {label} "
                                     f"{path_name}: {counts}")

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
    k20_res: list[dict] = []
    k4p_res: list[dict] = []
    packs, batches = r50["packs"], r50["batches"]
    # 50K: K5 on the same rows as K2 (on the vocabulary's CHD table, which
    # the pipeline does not build where the cuckoo table fits), so the cost
    # of the dependent probe shows
    for B in sorted(packs):
        a, bits, row_len = (torch.from_numpy(x).cuda() for x in packs[B])
        r3, r4, r6 = check_word_fill("word pack", tb, cpu_tb, a, bits, row_len, itemsize,
                                     parent_build.get("kernels"))
        k3_res.append(r3)
        k4_res.append(r4)
        k6_res.append(r6)
        r20, r4p = check_phased("word pack", tb, cpu_tb, a, bits, row_len, itemsize)
        k20_res.append(r20)
        k4p_res.append(r4p)
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
    # K21 (the pre-split): the text pipeline's batches, random bytes with
    # random lengths (some past L, some negative) at the pipeline's three
    # batch shapes, and the edge rows at every bucket width
    presplit_res: list[dict] = []
    for shape in r50["shapes"]:
        arr, lens = (torch.from_numpy(x).cuda() for x in batches[shape])
        presplit_res.append(check_presplit("text batch", arr, lens, tb.class_table))
    prng = np.random.RandomState(args.seed + 21)
    for B, W in ((16, 4096), (8192, 128), (8192, 512)):
        arr = torch.from_numpy(prng.randint(0, 256, size=(B, W)).astype(np.uint8)).cuda()
        lens = torch.from_numpy(prng.randint(-2, W + 3, size=B).astype(np.int32)).cuda()
        presplit_res.append(check_presplit("random bytes", arr, lens, tb.class_table))
    for W in (128, 512, 2048, 4096):
        arr, lens = (torch.from_numpy(x).cuda() for x in presplit_edge_rows(W))
        presplit_res.append(check_presplit("edge rows", arr, lens, tb.class_table, timed=False))
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
        r3, r4, r6 = check_word_fill("word pack, 100K", tb, cpu_tb, a, bits, row_len, itemsize,
                                     parent_build.get("kernels"))
        k3_res.append(r3)
        k4_res.append(r4)
        k6_res.append(r6)
        r20, r4p = check_phased("word pack, 100K", tb, cpu_tb, a, bits, row_len, itemsize)
        k20_res.append(r20)
        k4p_res.append(r4p)
        check_k6_probes("word pack, 100K", [("chd", tb)], a, bits, row_len)
        seed_res.append(check_seed("word pack, 100K", a, row_len, tb.byte_token_table, timed=False))
        chd_res.append(check_merge("word pack", tb, a, row_len, wid=word_ids_plain(bits, row_len),
                                   table="chd", cold=True))
    for pack in edge_packs:
        check_k6_probes("edge rows, 100K", [("chd", tb)], *pack)
    for shape in r100["shapes"]:
        arr, lens = (torch.from_numpy(x).cuda() for x in batches[shape])
        chd_res.append(check_merge("text batch", tb, arr, lens, table="chd", cold=True))
        presplit_res.append(check_presplit("text batch, 100K", arr, lens, tb.class_table,
                                           timed=False))
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
            for key in ("fill_ms_in_turns", "parent_fill_ms"):
                if key in main:
                    kernels[-1][key] = main[key]
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
    # K8-K12: the paths of the later slices
    norm_main = next(r for r in norm["checks"] if r["inputs"] == "corpus rows, NFC")
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
        ("viterbi", mdl["checks"]["viterbi"], "unigram.cu", "ops/unigram_device.py",
         "complexity_tokenizer_tpu/ops/unigram_device.py:107", "model Unigram 32,000", None),
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
        for key in ("dense_bound_ms", "tile", "tiles", "sweep", "groups", "warps", "blocks",
                    "launch", "parent_ms", "parent_ms_cold", "ms_in_turns", "parent_shapes",
                    "poisoned", "fallbacks", "edge_poisoned"):
            if key in main:
                kernels[-1][key] = main[key]
    # K13-K16: the trainer's routes
    for name, replaces, path_name in (
        ("pair_hist", "complexity_tokenizer_tpu/parallel/trainer.py:48", "train classic 50,000"),
        ("merge_step", "complexity_tokenizer_tpu/parallel/trainer.py:64", "train classic 50,000"),
        ("select_pair", "complexity_tokenizer_tpu/parallel/trainer.py:179", "train classic 4,096"),
        ("hist_update", "complexity_tokenizer_tpu/parallel/trainer.py:220", "train classic 4,096"),
    ):
        res = train["checks"][name]
        main = res[0]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "complexity_tokenizer_tpu_torch/csrc/train.cu",
            "wrapper": "complexity_tokenizer_tpu_torch/ops/trainer_device.py",
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
            "library_ms": main["library_ms"],
            "checks": res,
        })
        if "launch" in main:
            kernels[-1]["launch"] = main["launch"]
    # K20 and K4's phased mode: the phased fill (CTOK_PHASE_N1), on the
    # 50K word path's largest pack; launches on the phased fill of every
    # distinct word
    for name, res, src, wrapper, replaces in (
        ("phase_compact", k20_res, "kernels.cu", "ops/wordfill.py",
         "complexity_tokenizer_tpu/ops/merge.py:294"),
        ("fill_compact_phased", k4p_res, "wordfill.cu", "ops/wordfill.py",
         "complexity_tokenizer_tpu/ops/wordpath.py:303"),
    ):
        largest = [max(r50["packs"]), 128]
        main = next(r for r in res if r["inputs"] == "word pack" and r["shape"] == largest)
        path_name = "50K every distinct word, phased"
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
            "inputs": main["inputs"],
            "shape": main["shape"],
            "ms": main["ms"],
            "ms_cold": main["ms_cold"],
            "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"],
            "library_ms": None,
            "checks": res,
        })
    # K21: the text pipeline's first pass since this kernel; headline
    # numbers at its widest batch
    text_res = [r for r in presplit_res if r["inputs"] == "text batch"]
    main = max(text_res, key=lambda r: r["shape"][0] * r["shape"][1])
    # K22: no path launches it (as no JAX path calls merge_word_rows_qc); its
    # numbers on the 50K ByteLevel BPE model's words
    k22_res = mdl["checks"]["merge_word_rows_qc"]
    for name, res, src, wrapper, replaces, path_name, head in (
        ("presplit", presplit_res, "presplit.cu", "ops/presplit.py",
         "complexity_tokenizer_tpu/ops/presplit.py:75", "50K text pipeline", main),
        ("merge_word_rows_qc", k22_res, "kernels.cu", "ops/merge.py",
         "complexity_tokenizer_tpu/ops/merge.py:175", None, k22_res[0]),
    ):
        by_path = {
            **{f"{label} {p}": counts[name]
               for label, r in (("50K", r50), ("100K", r100))
               for p, counts in r["launches"].items()},
            **_call_launches(name, call50, call100),
            **{p: c[name] for p, c in new_paths.items()},
        }
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "complexity_tokenizer_tpu_torch/csrc/" + src,
            "wrapper": "complexity_tokenizer_tpu_torch/" + wrapper,
            "replaces": replaces,
            "launches": by_path[path_name] if path_name else 0,
            "launches_path": path_name or "none: no path calls it, as no JAX path calls "
                                          "merge_word_rows_qc",
            "launches_by_path": by_path,
            "match": all(r["match"] for r in res),
            "max_abs_err": max(r["max_abs_err"] for r in res),
            "inputs": head["inputs"],
            "shape": head["shape"],
            "ms": head["ms"],
            "ms_cold": head["ms_cold"],
            "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"],
            "library_ms": None,
            "launch": head["launch"],
            "checks": res,
        })
        for key in ("plain_graph_ms", "k9_ms", "equals_k9"):
            if key in head:
                kernels[-1][key] = head[key]
    if any(n for p, n in kernels[-1]["launches_by_path"].items()):
        raise AssertionError("a path launched K22, which no path calls")
    # K12 inside the Unigram trainer: its checks and times on the E-steps
    next(k for k in kernels if k["name"] == "viterbi")["trainer_checks"] = train2["checks"]["viterbi"]
    # K17-K19: the WordPiece and Unigram trainers' routes
    for name, src, wrapper, replaces, path_name in (
        ("piece_hist", "unigram_train.cu", "ops/unigram_device.py",
         "complexity_tokenizer_tpu/parallel/unigram_trainer.py:64", "train Unigram 32,000"),
        ("train_match", "wordpiece_train.cu", "ops/wordpiece_train_device.py",
         "complexity_tokenizer_tpu/parallel/wordpiece_trainer.py:197", "train WordPiece 30,522"),
        ("pair_count", "wordpiece_train.cu", "ops/wordpiece_train_device.py",
         "complexity_tokenizer_tpu/parallel/wordpiece_trainer.py:274", "train WordPiece 30,522"),
    ):
        res = train2["checks"][name]
        main = next(r for r in res if "ms" in r and r.get("round", 1000) == 1000)
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
            "inputs": main["inputs"],
            "shape": main["shape"],
            "ms": main["ms"],
            "ms_cold": main["ms_cold"],
            "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
            "launch": main["launch"],
            "checks": res,
        })
    # K19 at the four rounds and over the run, beside the parent's
    k19 = next(k for k in kernels if k["name"] == "pair_count")
    k19["rounds"] = [{k: r[k] for k in ("round", "shape", "pairs", "keys", "hottest_key_atomics",
                                          "ms", "ms_cold", "parent_ms", "parent_ms_cold",
                                          "plain_ms", "library_ms", "bound_ms", "bound_by")}
                     for r in train2["checks"]["pair_count"] if "round" in r]
    k19["run_sum_ms"] = train2["k19_run"]
    # K18 the same
    k18 = next(k for k in kernels if k["name"] == "train_match")
    k18["rounds"] = [{k: r[k] for k in ("round", "shape", "lt_cap", "groups", "probes",
                                          "table_bytes", "ms", "ms_cold", "parent_ms",
                                          "parent_ms_cold", "plain_ms", "bound_ms", "bound_by")}
                     for r in train2["checks"]["train_match"] if "round" in r]
    k18["run_sum_ms"] = train2["k18_run"]
    if _sha1(blob50) != blob50_sha1:
        raise AssertionError("the tracked 50K warm-cache file changed during the run")
    print(json.dumps({"call": {
        label: {"walls_s": c["walls"], "launches": c["launches"]}
        for label, c in (("50K", call50), ("100K", call100))
    }, "warm_cache": warm, "models": {"walls_s": mdl["walls"], "host_words": mdl["stats"]},
        "train": {**train["walls"], **train2["walls"]},
        "fill_walls_s": {"50K": s50["walls"], "100K": s100["walls"]},
        "text_pipeline_two_blocks_s": {"50K": s50["text_two_blocks_s"],
                                       "100K": s100["text_two_blocks_s"]},
        "card": smi_line}))
    print(json.dumps({"kernels": kernels}))
    print(f"power: {smi_line}")
    _phase("total", t_start)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Time variants of the CHD merge fixpoint K5 on one NVIDIA card.

    python3 scripts/study_k5_variants.py [--parent ab/parent] [--variants a,b] [--rounds 2]

A variant is ``complexity_tokenizer_tpu_torch/csrc/kernels.cu`` with some of
K5's constants set otherwise (``VARIANTS``: ``kChdWarpWordBytes``,
``kChdSmallThreads``, ``kChdSmallSmThreads``, ``kChdSmThreads``,
``kChdFirst``, ``kChdQueue``), built
alone with ``nvcc`` into a library of its own (all variants at once) and
called through its C entry ``ctok_merge_fixpoint_chd``.  ``--parent DIR``
adds the ``kernels.cu`` of another checkout (unpacked with ``git archive``)
as the variant ``parent``: its C signature must be the same.

Inputs are those of the 100,000-entry configuration, made as
``chip_smoke.py`` makes them: the word pack of the first ``backend="device"``
call after the warm start, the packs of every distinct word of the corpus
(the last, ``[256,128]``, holds the longest words), the text pipeline's
batches, one 4,096-byte word of one letter and ``chip_smoke.py``'s rows
of runs with OOV bytes at ``[16,1024]``.  Every variant's output must
equal the package's own K5, bit for bit.  Each time is the mean of one
launch over CUDA-graph replay of 20 launches (warm: inputs and table in
L2); the rounds take the variants in turn, so drift shows as spread.  Prints
each variant's registers and spills (``-Xptxas -v``), a line per variant and
shape, and one JSON line of every time.  Needs a card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "complexity_tokenizer_tpu_torch", "csrc", "kernels.cu")

# name -> the constants it changes (the rest as the source has them:
# kChdSmallSmThreads 1024, kChdSmThreads 1536, kChdFirst 2, kChdQueue 4,
# kChdSmallThreads 64, kChdWarpWordBytes 32, kChdReach 8)
VARIANTS = {
    "source": {},
    "first4": {"kChdFirst": 4},
    "all2048": {"kChdSmallSmThreads": 2048, "kChdSmThreads": 2048},
    "all1536": {"kChdSmallSmThreads": 1536, "kChdSmThreads": 1536},
    "all1024": {"kChdSmallSmThreads": 1024, "kChdSmThreads": 1024},
    "q2": {"kChdQueue": 2},
    "q8": {"kChdQueue": 8},
    "t128": {"kChdSmallThreads": 128},
    "wwb16": {"kChdWarpWordBytes": 16},
    "reach2": {"kChdReach": 2},
    "reach32": {"kChdReach": 32},
}


def build_variants(names: list[str], parent: str | None, out_dir: str) -> dict:
    """name -> (library path, ptxas log); every nvcc at once."""
    from complexity_tokenizer_tpu_torch.utils.cuda_build import NVCC_FLAGS, _nvcc

    with open(SRC) as fh:
        source = fh.read()
    texts = {}
    for name in names:
        text = source
        for const, value in VARIANTS[name].items():
            text, n = re.subn(rf"(constexpr (?:int|bool) {const} = )\w+;", rf"\g<1>{value};", text)
            if n != 1:
                raise RuntimeError(f"variant {name}: {const} not found once in {SRC}")
        texts[name] = text
    if parent:
        with open(os.path.join(parent, "complexity_tokenizer_tpu_torch", "csrc", "kernels.cu")) as fh:
            texts["parent"] = fh.read()
    procs = {}
    for name, text in texts.items():
        d = os.path.join(out_dir, name)
        os.makedirs(d, exist_ok=True)
        src = os.path.join(d, "kernels.cu")
        with open(src, "w") as fh:
            fh.write(text)
        procs[name] = subprocess.Popen(
            # the package's headers (chd_hash.cuh) beside the copied source
            [_nvcc(), *NVCC_FLAGS, "-I", os.path.dirname(SRC), "-shared", "-o",
             os.path.join(d, "lib.so"), src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
    out = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        out[name] = (os.path.join(out_dir, name, "lib.so"), log)
    return out


def chd_registers(log: str) -> dict:
    """threads -> (registers, spill stores bytes) of merge_fixpoint_kernel<ChdProbe, threads>."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            t = re.search(r"ChdProbeELi(\d+)E", name)
            cur = int(t.group(1)) if t and "merge_fixpoint_kernel" in name else None
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            out.setdefault(cur, [None, 0])[1] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(cur, [None, 0])[0] = int(m.group(1))
    return {k: tuple(v) for k, v in sorted(out.items())}


def collect_inputs(texts: list[str]):
    """[(label, tokens, wid)] on the card at 100K, and the tables."""
    import numpy as np
    import torch

    from chip_smoke import TOKENIZER_100K, text_pipeline_encode
    from complexity_tokenizer_tpu_torch import native
    from complexity_tokenizer_tpu_torch.ops.pipeline import pack_texts
    from complexity_tokenizer_tpu_torch.ops.presplit import presplit
    from complexity_tokenizer_tpu_torch.ops.seed import seed_tokens_plain
    from complexity_tokenizer_tpu_torch.ops.tables import byte_token_table
    from complexity_tokenizer_tpu_torch.ops.wordfill import word_ids_plain
    from complexity_tokenizer_tpu_torch.ops.wordpath import DeviceWordEncoder
    from complexity_tokenizer_tpu_torch.tokenizer import Tokenizer
    from complexity_tokenizer_tpu_torch.utils.corpus import RUN_BREAKS, run_rows

    tok = Tokenizer.from_file(TOKENIZER_100K)
    pipe = tok.pipeline("cuda")
    tb = pipe.tables
    batches: dict = {}
    encode_rows = pipe.encode_rows

    def keep_batch(arr, lens):
        batches.setdefault(arr.shape, (arr.copy(), lens.copy()))
        return encode_rows(arr, lens)

    pipe.encode_rows = keep_batch
    try:
        text_pipeline_encode(tok, pipe, texts)
    finally:
        del pipe.encode_rows

    def hook(wp, store, key):
        fill_fn = wp._fn

        def keep(a, bits, row_len):
            store.setdefault(key(a), (a.copy(), bits.copy(), row_len.copy()))
            return fill_fn(a, bits, row_len)

        wp._fn = keep

    device_packs: dict = {}
    wp_d = tok._get_word_path("cuda")
    hook(wp_d, device_packs, lambda a: a.shape[0])
    tok.encode_batch(texts, backend="device")
    all_packs: dict = {}
    wp = DeviceWordEncoder(pipe, native.NativeEncoder(tok.bpe.packed_merge_arrays(),
                                                      byte_token_table(tok.bpe.vocab)))
    hook(wp, all_packs, lambda a: len(all_packs))
    data = tok._prepare_bytes([tok._normalize(t) for t in texts])
    words, lens = wp.native.collect_miss_words(data, 128)
    wp._encode_words_packed(words, lens)

    def pack_rows(label, a, bits, row_len):
        a, bits, row_len = (torch.from_numpy(x).cuda() for x in (a, bits, row_len))
        tokens = seed_tokens_plain(a, row_len, tb.byte_token_table)
        return (label, tokens.contiguous(), word_ids_plain(bits, row_len).contiguous())

    out = [pack_rows(f"device pack {B}", *device_packs[B]) for B in sorted(device_packs)]
    # the last pack holds the longest words
    out.append(pack_rows("longest words", *all_packs[max(all_packs)]))
    for shape in sorted(batches):
        arr, lens = (torch.from_numpy(x).cuda() for x in batches[shape])
        _, wid, _ = presplit(arr, lens, tb.class_table)
        out.append(("text", seed_tokens_plain(arr, lens, tb.byte_token_table).contiguous(),
                    wid.contiguous()))
    arr, lens = (torch.from_numpy(x).cuda() for x in pack_texts([b"a" * 4096], 4096, 1))
    _, wid, _ = presplit(arr, lens, tb.class_table)
    out.append(("one letter", seed_tokens_plain(arr, lens, tb.byte_token_table).contiguous(),
                wid.contiguous()))
    # chip_smoke.py's edge rows: runs with OOV bytes (its random table's,
    # from the same seed, and the run breakers) as tombstones
    rng = np.random.RandomState(17)
    rng.randint(0, 50000, size=256)
    oov_table = tb.byte_token_table.clone()
    oov_table[torch.from_numpy(rng.choice(256, 24, replace=False)).cuda()] = -1
    oov_table[list(RUN_BREAKS)] = -1
    rows = run_rows(" ".join(texts).encode("utf-8"), 16, 1024, True)
    arr, lens = (torch.from_numpy(x).cuda() for x in pack_texts(rows, 1024, 16))
    _, wid, _ = presplit(arr, lens, tb.class_table)
    out.append(("run rows, OOV breaks", seed_tokens_plain(arr, lens, oov_table).contiguous(),
                wid.contiguous()))
    return out, tb


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a checkout whose kernels.cu is the variant 'parent'")
    ap.add_argument("--variants", default=",".join(VARIANTS), help="names from VARIANTS")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--texts", type=int, default=10_000)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("study_k5_variants: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from chip_smoke import _time_ms, main_corpus
    from complexity_tokenizer_tpu_torch.ops.merge import merge_words

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)}; {smi}", flush=True)
    t0 = time.perf_counter()
    names = [n for n in args.variants.split(",") if n]
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        libs = build_variants(names, args.parent, tmp)
        print(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s", flush=True)
        for name, (_, log) in libs.items():
            print(f"[{name}] K5 registers, spill bytes by threads a block: {chd_registers(log)}",
                  flush=True)
        inputs, tb = collect_inputs(main_corpus(args.texts, 17))
        fns = {}
        for name, (path, _) in libs.items():
            fn = ctypes.CDLL(path).ctok_merge_fixpoint_chd
            P, U, I = ctypes.c_void_p, ctypes.c_uint, ctypes.c_int
            fn.argtypes = (P, P, P, P, U, U, P, P, I, I, P)
            fn.restype = ctypes.c_int
            fns[name] = fn
        times: dict = {}
        for label, tokens, wid in inputs:
            B, L = tokens.shape
            key = f"{label} [{B},{L}]"
            exp_t, exp_c = merge_words(tokens, wid, tb.chd_disp, tb.chd_rows, tb.chd_size,
                                       tb.chd_n_buckets)
            outs = {}
            for name, fn in fns.items():
                out = torch.empty_like(tokens)
                cnt = torch.empty(B, dtype=torch.int32, device="cuda")

                def call(fn=fn, out=out, cnt=cnt):
                    rc = fn(tokens.data_ptr(), wid.data_ptr(), tb.chd_disp.data_ptr(),
                            tb.chd_rows.data_ptr(), tb.chd_size - 1, tb.chd_n_buckets - 1,
                            out.data_ptr(), cnt.data_ptr(), B, L,
                            torch.cuda.current_stream().cuda_stream)
                    if rc:
                        raise RuntimeError(f"variant launch failed: CUDA error {rc}")

                call()
                torch.cuda.synchronize()
                if not (torch.equal(out, exp_t) and torch.equal(cnt, exp_c)):
                    raise AssertionError(f"variant {name} differs from K5 on {key}")
                outs[name] = call
            for _ in range(args.rounds):
                for name, call in outs.items():
                    times.setdefault(key, {}).setdefault(name, []).append(_time_ms(call, 20))
            row = "  ".join(
                f"{n} {min(v):.4f}-{max(v):.4f}" for n, v in times[key].items()
            )
            print(f"{key}: {row} ms", flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "power": smi, "times_ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Time designs of the GPT-2 pre-split kernel K21 on one NVIDIA card.

    python3 scripts/study_k21_variants.py [--variant NAME=PATH] ... [--rounds 2]

``--variant NAME=PATH``: a CUDA source with the C entry ``ctok_presplit(bytes,
lens, class_table, start, wid, valid, B, L, stream)`` (the package's
signature, ``csrc/presplit.cu``); the package's own source is always the
variant ``package``.  Every source is built alone with ``nvcc`` into a
shared library (all at once) and loaded with ``ctypes``.

Inputs: the first batch of each length bucket that the text pipeline
packs from ``chip_smoke.py``'s corpus (``[16,4096]``, ``[8192,128]``,
``[8192,512]``; a text over 4,096 bytes in slices of 4,096), random bytes
with random lengths (some past the width, some negative) at those shapes,
and ``utils/corpus.py:presplit_edge_rows`` at widths 128, 512, 2,048 and
4,096 (checked, not timed).  Each variant
must equal the plain version (``ops/presplit.py:presplit_plain``) bit for
bit in all three outputs on all of them.  Then, in ``--rounds`` rounds that
take the designs in turn, each design warm (CUDA-graph replay on the same
buffers) and cold (``chip_smoke._time_cold_ms``).  Prints a line per design
and shape and one JSON line of every time.  Needs a card and ``nvcc``.
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
PACKAGE_SRC = os.path.join(REPO, "complexity_tokenizer_tpu_torch", "csrc", "presplit.cu")
BUILD = os.path.join(REPO, "build", "k21_study")
P, I = ctypes.c_void_p, ctypes.c_int


def build(variants: dict[str, str]) -> dict:
    """name -> the loaded library of each source, built all at once."""
    from complexity_tokenizer_tpu_torch.utils.cuda_build import NVCC_FLAGS, _nvcc

    os.makedirs(BUILD, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name, src in variants.items():
        so = os.path.join(BUILD, f"{name}.so")
        procs[name] = (so, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-shared", src, "-o", so],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, p) in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed on {variants[name]}:\n{log}")
        for line in log.splitlines():
            if "registers" in line:
                print(f"  {name}: {line.split(':', 1)[-1].strip()}")
        lib = ctypes.CDLL(so)
        lib.ctok_presplit.argtypes = (P, P, P, P, P, P, I, I, P)
        lib.ctok_presplit.restype = I
        libs[name] = lib
    print(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s", flush=True)
    return libs


def launcher(lib):
    """``fn(arr, lens, table) -> (start, wid, valid)`` over one library."""
    import torch

    def fn(arr, lens, table):
        B, L = arr.shape
        start = torch.empty((B, L), dtype=torch.bool, device=arr.device)
        wid = torch.empty((B, L), dtype=torch.int32, device=arr.device)
        valid = torch.empty((B, L), dtype=torch.bool, device=arr.device)
        code = lib.ctok_presplit(arr.data_ptr(), lens.data_ptr(), table.data_ptr(),
                                 start.data_ptr(), wid.data_ptr(), valid.data_ptr(), B, L,
                                 torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"ctok_presplit: CUDA error {code}")
        return start, wid, valid
    return fn


def inputs(seed: int) -> list[tuple]:
    """(label, timed, arr, lens) on the card."""
    import numpy as np
    import torch

    from chip_smoke import main_corpus
    from complexity_tokenizer_tpu_torch.ops.pipeline import (
        _BATCH_BUCKETS,
        _LENGTH_BUCKETS,
        _bucket,
        pack_texts,
    )
    from complexity_tokenizer_tpu_torch.utils.corpus import presplit_edge_rows

    on = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
    data = [t.encode("utf-8") for t in main_corpus(10_000, seed)]
    # texts over the widest bucket in slices of it, as the pipeline cuts them
    widest = _LENGTH_BUCKETS[-1]
    data = [d[i:i + widest] for d in data for i in range(0, max(len(d), 1), widest)]
    out = []
    for L in _LENGTH_BUCKETS:
        rows = [d for d in data if _bucket(max(len(d), 1), _LENGTH_BUCKETS) == L][:8192]
        if rows:
            B = _bucket(len(rows), _BATCH_BUCKETS)
            arr, lens = pack_texts(rows, L, B)
            out.append((f"text batch [{B},{L}]", True, on(arr), on(lens)))
    rng = np.random.RandomState(seed + 21)
    for B, L in ((16, 4096), (8192, 128), (8192, 512)):
        arr = rng.randint(0, 256, size=(B, L)).astype(np.uint8)
        lens = rng.randint(-2, L + 3, size=B).astype(np.int32)
        out.append((f"random bytes [{B},{L}]", True, on(arr), on(lens)))
    for L in (128, 512, 2048, 4096):
        arr, lens = presplit_edge_rows(L)
        out.append((f"edge rows [{len(lens)},{L}]", False, on(arr), on(lens)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", default=[], help="NAME=PATH")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seed", type=int, default=17)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("study_k21_variants: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from chip_smoke import _cold_sets, _time_cold_ms, _time_ms
    from complexity_tokenizer_tpu_torch.ops.presplit import presplit_plain
    from complexity_tokenizer_tpu_torch.utils.unicode_tables import gpt2_class_table

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())
    variants = {"package": PACKAGE_SRC}
    for v in args.variant:
        name, path = v.split("=", 1)
        variants[name] = os.path.abspath(path)
    fns = {name: launcher(lib) for name, lib in build(variants).items()}
    table = torch.from_numpy(gpt2_class_table()).cuda()
    cases = inputs(args.seed)
    for label, _timed, arr, lens in cases:
        exp = presplit_plain(arr, lens, table)
        for name, fn in fns.items():
            got = fn(arr, lens, table)
            torch.cuda.synchronize()
            if not all(torch.equal(g, e) for g, e in zip(got, exp)):
                raise AssertionError(f"{name} differs from the plain version on {label}")
        print(f"{label}: every variant bit for bit the plain version", flush=True)
    times: dict = {}
    for rnd in range(args.rounds):
        order = list(fns) if rnd % 2 == 0 else list(fns)[::-1]
        for label, timed, arr, lens in cases:
            if not timed:
                continue
            B, L = arr.shape
            reps = 50 if B * L >= 1 << 20 else 200
            for name in order:
                fn = fns[name]
                ms = _time_ms(lambda: fn(arr, lens, table), reps)
                sets = _cold_sets((arr, lens), 6 * B * L)
                ms_cold = _time_cold_ms(lambda a, n: fn(a, n, table), sets, reps)
                del sets
                times.setdefault(label, {}).setdefault(name, []).append([ms, ms_cold])
                print(f"round {rnd} {label} {name}: warm {ms:.4f} ms, cold {ms_cold:.4f} ms",
                      flush=True)
    print(json.dumps({"card": smi.stdout.strip(), "times_ms_warm_cold": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

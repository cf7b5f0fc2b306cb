#!/usr/bin/env python3
"""Time designs of the normalization check K8 on one NVIDIA card.

    python3 scripts/study_k8_variants.py [--parent DIR] [--variant NAME=PATH] ... [--rounds 2]

``--variant NAME=PATH``: a source with the package's C entry
``ctok_norm_check(data, n_bytes, offs, block_rows, n_blocks, bitmap, stable,
B, span, stream)`` over ragged rows (``ops/normalize_device.py:pack_norm_rows``);
PATH ``package`` is the package's own ``csrc/normcheck.cu``, which is also
always the variant ``package``.  ``--parent DIR``: a checkout whose
``csrc/normcheck.cu`` is the dense K8 (``ctok_norm_check(bytes, lens,
bitmap, stable, B, L, stream)``), run as that commit ran it: a zero-padded
batch and a launch a length bucket (``scripts/parent_word_kernels.py``).
Every source is built alone with the package's ``nvcc`` flags, all at once.

Inputs, as ``chip_smoke.py`` makes them: the corpus's rows (every row of
at most 4,096 bytes, one launch), under the NFC bitmap and
``BertNormalizer()``'s.  Each variant must equal the plain version bit for
bit there and on ``utils/corpus.py:norm_edge_rows`` under both and the
trap bitmap, except a variant whose NAME starts with ``no-`` (a design
with a part taken out, to see what that part costs), which is timed only.  Then ``--rounds`` rounds take the designs in turn (forward,
then backward), each timed warm by CUDA-graph replay on the same buffers.
Prints each build's register report, a line per design and bitmap, and
one JSON line of every time.  Needs a card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE_SRC = os.path.join(REPO, "complexity_tokenizer_tpu_torch", "csrc", "normcheck.cu")
P, I = ctypes.c_void_p, ctypes.c_int


def build(sources: dict) -> dict:
    """name -> (ctypes library, ptxas report) for each source, built at once."""
    from complexity_tokenizer_tpu_torch.utils.cuda_build import LINK_FLAGS, NVCC_FLAGS, _nvcc

    nvcc = _nvcc()
    jobs = {}
    for name, src in sources.items():
        with open(src, "rb") as fh:
            key = hashlib.sha256(fh.read()).hexdigest()[:16]
        out = os.path.join(REPO, "build", "k8_variants", key)
        os.makedirs(out, exist_ok=True)
        obj, so = os.path.join(out, "k8.o"), os.path.join(out, "libk8.so")
        jobs[name] = (so, obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", src, "-o", obj], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, obj, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {sources[name]}:\n{log}")
        link = subprocess.run([nvcc, *LINK_FLAGS, "-o", so, obj], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed on {sources[name]}:\n{link.stderr}")
        lib = ctypes.CDLL(so)
        lib.ctok_norm_check.argtypes = (P, I, P, P, I, P, P, I, I, P)
        lib.ctok_norm_check.restype = ctypes.c_int
        regs = [ln.split(":", 1)[-1].strip() for ln in log.splitlines()
                if "registers" in ln]
        libs[name] = (lib, regs)
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", default=[], help="NAME=PATH")
    ap.add_argument("--parent", default=None, help="a checkout with the dense K8")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seed", type=int, default=17)
    ap.add_argument("--texts", type=int, default=10_000)
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import torch

    if not torch.cuda.is_available():
        print("study_k8_variants: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as smoke
    from complexity_tokenizer_tpu_torch.core.normalizers import NFC, BertNormalizer
    from complexity_tokenizer_tpu_torch.ops.normalize_device import (
        NORM_SPAN,
        norm_stable_rows_ragged_plain,
        pack_norm_rows,
        plan_for_normalizer,
    )
    from complexity_tokenizer_tpu_torch.ops.pipeline import _LENGTH_BUCKETS
    from complexity_tokenizer_tpu_torch.utils.corpus import norm_edge_rows, norm_trap_bitmap

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())
    sources = {"package": PACKAGE_SRC}
    for v in args.variant:
        name, path = v.split("=", 1)
        sources[name] = PACKAGE_SRC if path == "package" else os.path.abspath(path)
    libs = build(sources)
    for name, (_, regs) in libs.items():
        print(f"{name}: {'; '.join(regs)}")

    def call(lib, data, offs, blocks, bitmap, stable):
        code = lib.ctok_norm_check(
            data.data_ptr(), data.numel(), offs.data_ptr(), blocks.data_ptr(), blocks.numel() - 1,
            bitmap.data_ptr(), stable.data_ptr(), offs.numel() - 1, NORM_SPAN,
            torch.cuda.current_stream().cuda_stream)
        if code != 0:
            raise RuntimeError(f"CUDA error {code}")
        return stable

    texts = smoke.main_corpus(args.texts, args.seed)
    rows = [d for d in (t.encode("utf-8") for t in texts) if 0 < len(d) <= _LENGTH_BUCKETS[-1]]
    bitmaps = {"NFC": torch.from_numpy(plan_for_normalizer(NFC()).bitmap).cuda(),
               "BertNormalizer": torch.from_numpy(plan_for_normalizer(BertNormalizer()).bitmap).cuda(),
               "trap": torch.from_numpy(norm_trap_bitmap()).cuda()}
    text = " ".join(texts[:200]).encode()
    cases = [("corpus rows", rows)] + norm_edge_rows(text, NORM_SPAN)
    for label, case in cases:
        for bname, bm in bitmaps.items():
            if label == "corpus rows" and bname == "trap":
                continue
            data, offs, blocks, _ = pack_norm_rows(case, "cuda")
            exp = norm_stable_rows_ragged_plain(data, offs, bm)
            for name, (lib, _) in libs.items():
                if name.startswith("no-"):
                    continue
                got = call(lib, data, offs, blocks, bm, torch.ones_like(exp))
                torch.cuda.synchronize()
                if not torch.equal(got, exp):
                    raise AssertionError(f"{name} differs from the plain version: {label}, {bname}")
    print(f"every variant bit for bit on {len(cases)} cases")

    data, offs, blocks, stable = pack_norm_rows(rows, "cuda")
    fns = {}
    for bname in ("NFC", "BertNormalizer"):
        bm = bitmaps[bname]
        for name, (lib, _) in libs.items():
            fns[(name, bname)] = (lambda lib=lib, bm=bm: call(lib, data, offs, blocks, bm, stable))
        if args.parent:
            from parent_word_kernels import ParentKernels, bucket_rows

            parent = ParentKernels(args.parent)
            batches = [(torch.from_numpy(a).cuda(), torch.from_numpy(n).cuda())
                       for _, a, n in bucket_rows(rows, _LENGTH_BUCKETS)]
            fns[("parent", bname)] = (lambda bm=bm: [parent.norm_check(a, n, bm) for a, n in batches])
    times: dict = {}
    for rnd in range(args.rounds):
        order = list(fns) if rnd % 2 == 0 else list(fns)[::-1]
        for key in order:
            times.setdefault(f"{key[0]} / {key[1]}", []).append(smoke._time_ms(fns[key], 20))
    for key, ts in times.items():
        print(f"{key}: warm {', '.join(f'{t:.4f}' for t in ts)} ms")
    print(json.dumps({"card": smi.stdout.strip(), "rows": len(rows),
                      "bytes": int(sum(map(len, rows))), "ms": times,
                      "registers": {k: v[1] for k, v in libs.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

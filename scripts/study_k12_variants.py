#!/usr/bin/env python3
"""Time designs of the Unigram Viterbi K12 on one NVIDIA card.

    python3 scripts/study_k12_variants.py [--parent DIR] [--variant NAME=FLAGS] ... [--ablate]
                                          [--rounds 2]

Every variant is built alone with the package's ``nvcc`` flags and ``-I``
the package's ``csrc``, all at once: ``package`` is the package's
``csrc/unigram.cu`` (it has no switch); the others are the study source
``scripts/k12_variants/viterbi_variants.cu`` (the package's K12 with the
designs it was measured against behind ``K12_*`` switches, see its header)
with its macros set (FLAGS: ``KEY=V`` words joined by commas, each
``-DK12_KEY=V``):

- ``package``: 4 lanes a text of up to 16 characters, end by end: each
  lane probes its share of the end's real candidates, 2 at a time with
  their reads in flight together, and folds them, and the group's folds
  are combined;
- ``study-defaults``: the study source with no macro set, which must be
  the package's kernel (bit for bit, and in time);
- ``first``: a warp a text, every (end, length <= maxcand) slot scored,
  one candidate a lane a round, three reductions a DP step: the first
  design's steps in this source;
- ``groups``, ``true-cand``, ``serial-dp``: ``first`` with one part changed
  alone (lane groups of 8 and 16, 4 and 2 texts a warp; only the real
  candidates with 4 probes in flight a lane; a lane's loop over a step's
  candidates in place of the reductions);
- ``groups-all``: every part in lane groups of 8 and 16, the layout first
  tried for this kernel;
- ``text-lanes-1``, ``-2``, ``-8``: that many lanes a text; ``batch-1``,
  ``batch-4``: that many probes in flight a lane;
- with ``--ablate``: the package with one part taken out (``no-probe``,
  ``no-dp``, ``no-check``, ``no-backtrack``: ``K12_ABLATE`` 1-4), which
  is timed only, to see what that part costs.

``--parent DIR``: a checkout with the first K12 (e635772's
``csrc/unigram.cu``, a warp a text, no groups in its C signature), built
by ``scripts/parent_word_kernels.py`` and timed beside these.

Inputs, as ``chip_smoke.py`` makes them: the corpus's distinct ``▁word``
pieces under the 32,000-piece table, packed by the tier (by length, with
its lane groups).  Every variant but those built with ``K12_ABLATE`` must
equal the plain version bit for bit there and on
``utils/corpus.py:unigram_edge_texts`` (each case packed alone) at
``maxcand`` the longest piece, 3 and 16.  Then ``--rounds`` rounds take
the designs in turn (forward, then backward), each timed warm by
CUDA-graph replay on the same buffers.  Prints each build's register
report and launch shape, a line per design, and one JSON line of every
time.  Needs a card and ``nvcc``.
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
CSRC = os.path.join(REPO, "complexity_tokenizer_tpu_torch", "csrc")
PACKAGE_SRC = os.path.join(CSRC, "unigram.cu")
STUDY_SRC = os.path.join(REPO, "scripts", "k12_variants", "viterbi_variants.cu")
P, I, U, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float

FIRST = "LAYOUT=0,TRUE_CAND=0,SERIAL_DP=0,BATCH=1"
VARIANTS = {
    "package": "",
    "study-defaults": "",
    "first": FIRST,
    "groups": "LAYOUT=1,TRUE_CAND=0,SERIAL_DP=0,BATCH=1",
    "true-cand": "LAYOUT=0,TRUE_CAND=1,SERIAL_DP=0,BATCH=4",
    "serial-dp": "LAYOUT=0,TRUE_CAND=0,SERIAL_DP=1,BATCH=1",
    "groups-all": "LAYOUT=1,BATCH=4",
    "text-lanes-1": "TEXT_LANES=1,BATCH=8",
    "text-lanes-2": "TEXT_LANES=2,BATCH=4",
    "text-lanes-8": "TEXT_LANES=8,BATCH=1",
    "batch-1": "BATCH=1",
    "batch-4": "BATCH=4",
}
ABLATIONS = {"no-probe": "ABLATE=1", "no-dp": "ABLATE=2", "no-check": "ABLATE=3",
             "no-backtrack": "ABLATE=4"}


def build(flags: dict) -> dict:
    """name -> (ctypes library, ptxas report) for each variant's flags,
    built at once."""
    from complexity_tokenizer_tpu_torch.utils.cuda_build import LINK_FLAGS, NVCC_FLAGS, _nvcc

    nvcc = _nvcc()
    jobs = {}
    for name, words in flags.items():
        src = PACKAGE_SRC if name == "package" else STUDY_SRC
        defines = [f"-DK12_{w.strip()}" for w in words.split(",") if w.strip()]
        with open(src, "rb") as fh:
            key = hashlib.sha256(fh.read())
        key.update(" ".join(defines).encode())
        out = os.path.join(REPO, "build", "k12_variants", key.hexdigest()[:16])
        os.makedirs(out, exist_ok=True)
        obj, so = os.path.join(out, "k12.o"), os.path.join(out, "libk12.so")
        jobs[name] = (so, obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *defines, "-I", CSRC, "-c", src, "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, obj, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name} ({flags[name]}):\n{log}")
        link = subprocess.run([nvcc, *LINK_FLAGS, "-o", so, obj], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed on {name}:\n{link.stderr}")
        lib = ctypes.CDLL(so)
        lib.ctok_viterbi.argtypes = (P, P, P, I, I, I, P, P, U, U, P, P, P, I, F, I, I, P, P, I, P)
        lib.ctok_viterbi.restype = ctypes.c_int
        lib.ctok_viterbi_info.argtypes = (P,)
        lib.ctok_viterbi_info.restype = ctypes.c_int
        regs = [ln.split(":", 1)[-1].strip() for ln in log.splitlines() if "registers" in ln]
        libs[name] = (lib, regs)
    return libs


def launch_shape(lib) -> dict:
    keys = ("threads", "registers", "static_smem", "local_bytes", "blocks_per_sm")
    info = (ctypes.c_int * len(keys))()
    code = lib.ctok_viterbi_info(ctypes.addressof(info))
    if code != 0:
        raise RuntimeError(f"ctok_viterbi_info: CUDA error {code}")
    return dict(zip(keys, info))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", default=[], help="NAME=FLAGS")
    ap.add_argument("--parent", default=None, help="a checkout with the first K12")
    ap.add_argument("--ablate", action="store_true", help="also time the parts taken out")
    ap.add_argument("--only", action="append", default=[], help="time only these variants")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seed", type=int, default=17)
    ap.add_argument("--texts", type=int, default=10_000)
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("study_k12_variants: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as smoke
    from complexity_tokenizer_tpu_torch.models import UnigramModel
    from complexity_tokenizer_tpu_torch.ops.unigram_device import viterbi_ragged_plain
    from complexity_tokenizer_tpu_torch.ops.wordpiece_device import hash_powers
    from complexity_tokenizer_tpu_torch.utils.corpus import (
        metaspace_pieces,
        unigram_32k_vocab,
        unigram_edge_texts,
    )

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())
    flags = {k: v for k, v in VARIANTS.items() if not args.only or k in args.only}
    if args.ablate:
        flags.update(ABLATIONS)
    for v in args.variant:
        name, words = v.split("=", 1)
        flags[name] = words
    libs = build(flags)
    shapes = {name: launch_shape(lib) for name, (lib, _) in libs.items()}
    for name, (_, regs) in libs.items():
        print(f"{name} ({flags[name] or 'defaults'}): {'; '.join(regs)}; launch {shapes[name]}")
    parent = None
    if args.parent:
        from parent_word_kernels import ParentKernels

        parent = ParentKernels(args.parent)
        if not parent.has("viterbi"):
            raise RuntimeError(f"{args.parent} holds no first K12")

    vocab = unigram_32k_vocab()
    tier = UnigramModel(vocab)._tiers.get("cuda")
    targs = tier.args()
    pows = hash_powers("cuda")
    on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()  # noqa: E731

    def call(lib, c, o, n, groups, maxcand, res):
        code = lib.ctok_viterbi(
            c.data_ptr(), o.data_ptr(), n.data_ptr(), groups[0], groups[1], n.numel(),
            tier.disp.data_ptr(), tier.rows.data_ptr(), tier.chd.size - 1,
            tier.chd.n_buckets - 1, tier.piece_chars.data_ptr(), tier.piece_lens.data_ptr(),
            tier.piece_scores.data_ptr(), tier.piece_chars.shape[1],
            ctypes.c_float(tier.min_score), min(maxcand, 128), -2, pows.data_ptr(),
            res.data_ptr(), c.numel(), torch.cuda.current_stream().cuda_stream)
        if code != 0:
            raise RuntimeError(f"CUDA error {code}")
        return res

    texts = smoke.main_corpus(args.texts, args.seed)
    uniq = sorted(set(metaspace_pieces(texts)))
    cases = [("corpus pieces", uniq)] + unigram_edge_texts(vocab)
    for label, case in cases:
        packed = tier.pack(case)
        c, o, n = (on(x) for x in packed[:3])
        groups = packed[4]
        for maxcand in (tier.Lt, 3, 16):
            exp = viterbi_ragged_plain(c, o, n, *tier.args(maxcand))
            for name, (lib, _) in libs.items():
                if "ABLATE" in flags[name]:
                    continue
                got = call(lib, c, o, n, groups, maxcand, torch.empty_like(exp))
                torch.cuda.synchronize()
                if not torch.equal(got, exp):
                    raise AssertionError(f"{name} differs from the plain version: {label}, "
                                         f"maxcand {maxcand}")
            if parent is not None:
                got = parent.viterbi(c, o, n, *tier.args(maxcand))
                torch.cuda.synchronize()
                if not torch.equal(got, exp):
                    raise AssertionError(f"the parent differs from the plain version: {label}")
    print(f"every variant bit for bit on {len(cases)} cases at maxcand {tier.Lt}, 3 and 16")

    chars_np, offs_np, lens_np, _order, groups, _host = tier.pack(uniq)
    c, o, n = on(chars_np), on(offs_np), on(lens_np)
    res = torch.empty(c.numel() + 2 * n.numel(), dtype=torch.int32, device="cuda")
    hist = {"1-8 characters": groups[0], "9-16 characters": groups[1] - groups[0],
            "a warp": n.numel() - groups[1]}
    print(f"corpus pieces: {n.numel()} pieces, {c.numel()} characters, by class {hist}")
    fns = {name: (lambda lib=lib: call(lib, c, o, n, groups, tier.Lt, res))
           for name, (lib, _) in libs.items()}
    if parent is not None:
        fns["parent"] = lambda: parent.viterbi(c, o, n, *targs)
    times: dict = {}
    for rnd in range(args.rounds):
        order = list(fns) if rnd % 2 == 0 else list(fns)[::-1]
        for name in order:
            times.setdefault(name, []).append(smoke._time_ms(fns[name], 20))
    for name, ts in times.items():
        print(f"{name}: warm {', '.join(f'{t:.4f}' for t in ts)} ms")
    print(json.dumps({"card": smi.stdout.strip(), "pieces": n.numel(), "characters": c.numel(),
                      "groups": hist, "ms": times, "flags": flags,
                      "registers": {k: v[1] for k, v in libs.items()}, "launch": shapes}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

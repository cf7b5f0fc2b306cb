#!/usr/bin/env python3
"""Run K18's CUDA source on the CPU, a warp at a time, against its plain version.

    python3 scripts/warp_emulator/emulate_k18.py [SOURCE] [-D MACRO=V ...]

Builds SOURCE (default: the package's ``csrc/wordpiece_train.cu``; the
study source ``scripts/train_match_variants/train_match_variants.cu`` takes
``-D K18_*`` switches; any source with the package's ``ctok_train_match``)
with ``g++`` into ``build/warp_emulator/`` against ``warp_emulator.h``,
which runs each warp's 32 lanes on host threads in lockstep, and checks the
emulated
K18 bit for bit against ``train_match_plain`` (``out`` and ``poison``) on
the card test's cases (``tests/test_torch_gpu.py``: the edge words of
``utils/corpus.py:train_match_edge_words`` sorted and unsorted, every group
width, one word of 128 characters, no fallback symbol, forged forms) and on
rounds 0, 40, 150 and 299 of the WordPiece trainer at 400 entries on
``utils/corpus.py:wordpiece_train_edge_texts`` (on the CPU), their tables
also forged.  A shuffle or ballot that not every lane reaches aborts with
each lane's line.  Needs no card and no ``nvcc``; it checks the kernel's
logic, not its speed or what ``nvcc`` accepts.  About a minute.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(REPO, "complexity_tokenizer_tpu_torch", "csrc")
BUILD = os.path.join(REPO, "build", "warp_emulator")

ENTRY = r'''
extern "C" int emu_train_match(const void* chars, const void* offs, const void* lens, int n8,
                               int n16, int B, const void* table, unsigned t_mask,
                               const void* slot_meta, const void* slot_chars,
                               const void* fb_map, int lt_cap, void* out, void* poison) {
  cudaStream_t stream = nullptr;
%s
}
'''


def build(src: str, macros: list[str], out_dir: str) -> ctypes.CDLL:
    """SOURCE's K18 (its device code and its entry's body, the launch run by
    ``emu_launch``) as a host library."""
    s = open(src).read()
    head = s[:s.index('extern "C" {')]
    head = head.replace("#include <cuda_runtime.h>", '#include "warp_emulator.h"')
    head = head.replace('#include "dependent_launch.cuh"', "")
    if "// K19\n" in head:  # K18 alone
        a = head.index("// ---------------------------------------------------------------------------\n// K19")
        head = head[:a] + head[head.index("}  // namespace", a):]
    entry = s[s.index("int ctok_train_match(const void* chars"):]
    body = entry[entry.index("{") + 1:entry.index("\n}\n")]
    launch = body[body.index("  train_match_kernel<<<"):body.index("return (int)cudaGetLastError();")]
    grid, rest = launch.split("<<<", 1)[1].split(">>>", 1)
    g, t = [x.strip() for x in grid.split(",")[:2]]
    call = rest.strip().rstrip(";")
    body = body.replace(launch, f"  emu_launch({g}, {t}, [&] {{ train_match_kernel{call}; }});\n  ")
    cpp = os.path.join(out_dir, "k18_emu.cpp")
    with open(cpp, "w") as f:
        f.write(head + ENTRY % body)
    so = os.path.join(out_dir, "k18_emu.so")
    subprocess.run(["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-I", HERE,
                    "-I", CSRC, *(f"-D{m}" for m in macros), cpp, "-o", so], check=True)
    lib = ctypes.CDLL(so)
    P, I, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    lib.emu_train_match.argtypes = (P, P, P, I, I, I, P, U, P, P, P, I, P, P)
    lib.emu_train_match.restype = I
    return lib


def cases():
    """(label, train_match arguments) of the card test's cases and the
    trainer's rounds, on the CPU."""
    import numpy as np
    import torch

    from complexity_tokenizer_tpu_torch.parallel.wordpiece_trainer import (
        DistributedWordPieceTrainer,
    )
    from complexity_tokenizer_tpu_torch.trainers import WordPieceTrainerConfig
    from complexity_tokenizer_tpu_torch.utils.corpus import wordpiece_train_edge_texts

    sys.path.insert(0, os.path.join(REPO, "tests"))
    import test_torch_gpu as card

    words, table, meta, schars, fb = card._k18_edge_tables("cpu")
    rng = np.random.RandomState(18)
    shuffled = [words[i] for i in rng.permutation(len(words))]
    sorted_words = card._k18_words(words, device="cpu")
    c, o, ln, groups = sorted_words
    B = len(words)
    forged = schars.clone()
    forged[meta[:, 0] >= 2, 0] += 1
    out = [(f"by length, lt_cap {lt}", (*sorted_words, table, meta, schars, fb, lt))
           for lt in (8, 16, 32, 128)]
    out += [
        ("unsorted", (*card._k18_words(shuffled, sort=False, device="cpu"), table, meta, schars,
                      fb, 128)),
        ("groups of 8", (c, o, ln, (B, B), table, meta, schars, fb, 128)),
        ("groups of 16", (c, o, ln, (0, B), table, meta, schars, fb, 32)),
        ("a warp each", (c, o, ln, (0, 0), table, meta, schars, fb, 16)),
        ("one word of 128", (*card._k18_words([max(words, key=len)], device="cpu"), table, meta,
                             schars, fb, 128)),
        ("no fallback symbol", (c, o, ln, groups, table, meta, schars, torch.full_like(fb, -1),
                                32)),
        ("forged", (c, o, ln, groups, table, meta, forged, fb, 128)),
    ]
    kept = {}

    def keep(r, inp):
        if r in (0, 40, 150, 299):
            kept[r] = {k: v.clone() if isinstance(v, torch.Tensor) else v for k, v in inp.items()}

    trainer = DistributedWordPieceTrainer(WordPieceTrainerConfig(vocab_size=400), device="cpu")
    trainer.capture = keep
    trainer.train_from_texts(wordpiece_train_edge_texts())
    for r, inp in sorted(kept.items()):
        args = tuple(inp[k] for k in ("chars", "offs", "lens", "groups", "table", "slot_meta",
                                      "slot_chars", "fb_map", "lt_cap"))
        out.append((f"trainer round {r}", args))
        ff = inp["slot_chars"].clone()
        ff[inp["slot_meta"][:, 0] >= 2, 0] += 1
        out.append((f"trainer round {r}, forged", args[:6] + (ff,) + args[7:]))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("source", nargs="?", default=os.path.join(CSRC, "wordpiece_train.cu"))
    ap.add_argument("-D", dest="macros", action="append", default=[], help="MACRO=V")
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    import torch

    from complexity_tokenizer_tpu_torch.ops.wordpiece_train_device import train_match_plain

    torch.set_num_threads(1)
    os.makedirs(BUILD, exist_ok=True)
    lib = build(args.source, args.macros, BUILD)
    for label, a in cases():
        chars, offs, lens, groups, table, meta, schars, fb, lt = a
        N, B = chars.numel(), lens.numel()
        out = torch.full((N,), -7, dtype=torch.int32)
        poison = torch.full((B,), -7, dtype=torch.int32)
        err = lib.emu_train_match(chars.data_ptr(), offs.data_ptr(), lens.data_ptr(),
                                  int(groups[0]), int(groups[1]), B, table.data_ptr(),
                                  table.shape[0] - 1, meta.data_ptr(), schars.data_ptr(),
                                  fb.data_ptr(), lt, out.data_ptr(), poison.data_ptr())
        want = train_match_plain(*a)
        same = err == 0 and torch.equal(out, want[0]) and torch.equal(poison, want[1])
        print(f"{label}: {'equal' if same else 'DIFFERS'} ({int(want[1].sum())} poisoned)",
              flush=True)
        if not same:
            return 1
    print("every case equal")
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Build and call an earlier checkout's K9 and K10, one word a [B, 128] row.

    python3 scripts/parent_word_kernels.py --parent ab/parent

``--parent DIR``: a checkout of the commit before the ragged K9 and K10
(``git archive <commit> complexity_tokenizer_tpu_torch/csrc | tar -x -C
DIR``), whose ``csrc/kernels.cu`` holds the dense K9 entry
``ctok_merge_word_rows(tokens_in, disp, rows, size_mask, bucket_mask,
tokens_out, count, B, L, stream)`` and ``csrc/wordpiece.cu`` the dense K10
``ctok_wordpiece_match(chars, lens, disp, rows, size_mask, bucket_mask,
token_chars, token_lens, emit_ids, Lt, unk, max_input, out, count, poison,
B, W, stream)``.  Both sources are compiled with the package's ``nvcc``
flags (one process each, both at once) and linked into one library under
``build/parent_kernels/``.  ``chip_smoke.py --parent DIR`` times them beside
the package's kernels in the same call, on the same words laid out as that
commit's tiers laid them out (:func:`dense_wordpiece_rows`).  Run alone,
the script builds them and prints ``nvcc``'s register report.  Needs
``nvcc``; the calls need a card.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P, I, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint


class ParentKernels:
    """The earlier K9 and K10 of the checkout ``parent_dir``, built once."""

    def __init__(self, parent_dir: str):
        sys.path.insert(0, REPO)
        from complexity_tokenizer_tpu_torch.utils.cuda_build import LINK_FLAGS, NVCC_FLAGS, _nvcc

        csrc = os.path.join(parent_dir, "complexity_tokenizer_tpu_torch", "csrc")
        sources = [os.path.join(csrc, f) for f in ("kernels.cu", "wordpiece.cu")]
        h = hashlib.sha256()
        for f in sources + [os.path.join(csrc, "chd_hash.cuh")]:
            with open(f, "rb") as fh:
                h.update(fh.read())
        out_dir = os.path.join(REPO, "build", "parent_kernels", h.hexdigest()[:16])
        os.makedirs(out_dir, exist_ok=True)
        so = os.path.join(out_dir, "libparent.so")
        t0 = time.perf_counter()
        nvcc = _nvcc()
        objs = [os.path.join(out_dir, f"{i}.o") for i in range(len(sources))]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", src, "-o", obj],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(sources, objs)]
        logs = [p.communicate()[0] for p in procs]
        for src, p, log in zip(sources, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src} ({p.returncode}):\n{log}")
        link = subprocess.run([nvcc, *LINK_FLAGS, "-o", so, *objs], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}\n{link.stderr}")
        self.build_seconds = time.perf_counter() - t0
        self.ptxas_log = "".join(logs)
        self.lib = ctypes.CDLL(so)
        self.lib.ctok_merge_word_rows.argtypes = (P, P, P, U, U, P, P, I, I, P)
        self.lib.ctok_wordpiece_match.argtypes = (P, P, P, P, U, U, P, P, P, I, I, I, P, P, P, I,
                                                  I, P)
        for fn in (self.lib.ctok_merge_word_rows, self.lib.ctok_wordpiece_match):
            fn.restype = ctypes.c_int

    def _check(self, code: int, what: str) -> None:
        if code != 0:
            raise RuntimeError(f"parent {what}: CUDA error {code}")

    def merge_word_rows(self, tokens, disp, rows, size: int, n_buckets: int):
        """The earlier K9: tokens [B, L] int32 on the card -> (out [B, L],
        count [B])."""
        import torch

        B, L = tokens.shape
        out = torch.empty_like(tokens)
        count = torch.empty(B, dtype=torch.int32, device=tokens.device)
        stream = torch.cuda.current_stream(tokens.device).cuda_stream
        self._check(self.lib.ctok_merge_word_rows(
            tokens.data_ptr(), disp.data_ptr(), rows.data_ptr(), size - 1, n_buckets - 1,
            out.data_ptr(), count.data_ptr(), B, L, stream), "merge_word_rows")
        return out, count

    def wordpiece_match(self, chars, lens, disp, rows, size: int, n_buckets: int, token_chars,
                        token_lens, emit_ids, unk: int, max_input: int):
        """The earlier K10: chars [B, W] int32, lens [B] on the card -> (out
        [B, W], count [B], poison [B])."""
        import torch

        B, W = chars.shape
        out = torch.empty_like(chars)
        count = torch.empty(B, dtype=torch.int32, device=chars.device)
        poison = torch.empty(B, dtype=torch.bool, device=chars.device)
        stream = torch.cuda.current_stream(chars.device).cuda_stream
        self._check(self.lib.ctok_wordpiece_match(
            chars.data_ptr(), lens.data_ptr(), disp.data_ptr(), rows.data_ptr(), size - 1,
            n_buckets - 1, token_chars.data_ptr(), token_lens.data_ptr(), emit_ids.data_ptr(),
            token_chars.shape[1], int(unk), int(min(max_input, 2**31 - 1)), out.data_ptr(),
            count.data_ptr(), poison.data_ptr(), B, W, stream), "wordpiece_match")
        return out, count, poison


def dense_wordpiece_rows(words: list[str], max_input: int, lanes: int = 128):
    """The earlier WordPiece tier's packing: (chars [n, lanes] int32, -1
    padded, lens [n] int32); a word wider than the lanes and not decided by
    the limit in them is left empty, any other keeps its first ``lanes``
    characters and that length."""
    chars = np.full((len(words), lanes), -1, np.int32)
    lens = np.zeros(len(words), np.int32)
    for i, w in enumerate(words):
        if len(w) > lanes and (len(w) <= max_input or max_input >= lanes):
            continue
        cps = [ord(c) for c in w[:lanes]]
        chars[i, :len(cps)] = cps
        lens[i] = len(cps)
    return chars, lens


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="checkout of the earlier commit")
    args = ap.parse_args(argv)
    k = ParentKernels(args.parent)
    print(f"built in {k.build_seconds:.3f} s")
    for line in k.ptxas_log.splitlines():
        if "registers" in line or "Compiling" in line:
            print("  " + line.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())

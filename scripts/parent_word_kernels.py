#!/usr/bin/env python3
"""Build and call an earlier checkout's dense K8 and K11.

    python3 scripts/parent_word_kernels.py --parent ab/parent

``--parent DIR``: a checkout of a commit whose K8 and K11 take dense rows
(86e566f to ef545a1: ``git archive <commit> complexity_tokenizer_tpu_torch/csrc
| tar -x -C DIR``), whose ``csrc/normcheck.cu`` holds
``ctok_norm_check(bytes, lens, bitmap, stable, B, L, stream)`` (a warp a
[B, L] row) and ``csrc/wordpiece.cu``
``ctok_wordlevel_lookup(chars, lens, disp, rows, size_mask, bucket_mask,
token_chars, token_lens, emit_ids, Lt, unk, out, B, W, stream)`` (a warp a
[B, 128] row).  Only those two sources are compiled (the commit's
``kernels.cu`` and the K10 in its ``wordpiece.cu`` are not bound), with the
package's ``nvcc`` flags, one process each, both at once, and linked into
one library under ``build/parent_kernels/``.  ``chip_smoke.py --parent
DIR`` times them beside the package's K8 and K11 in the same call, on the
same rows and words laid out as that commit laid them out
(:func:`dense_word_rows`, :func:`bucket_rows`).  Run alone, the script
builds them and prints ``nvcc``'s register report.  Needs ``nvcc``; the
calls need a card.
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
    """The earlier K8 and K11 of the checkout ``parent_dir``, built once."""

    def __init__(self, parent_dir: str):
        sys.path.insert(0, REPO)
        from complexity_tokenizer_tpu_torch.utils.cuda_build import LINK_FLAGS, NVCC_FLAGS, _nvcc

        csrc = os.path.join(parent_dir, "complexity_tokenizer_tpu_torch", "csrc")
        sources = [os.path.join(csrc, f) for f in ("normcheck.cu", "wordpiece.cu")]
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
        self.lib.ctok_norm_check.argtypes = (P, P, P, P, I, I, P)
        self.lib.ctok_wordlevel_lookup.argtypes = (P, P, P, P, U, U, P, P, P, I, I, P, I, I, P)
        for fn in (self.lib.ctok_norm_check, self.lib.ctok_wordlevel_lookup):
            fn.restype = ctypes.c_int

    def _check(self, code: int, what: str) -> None:
        if code != 0:
            raise RuntimeError(f"parent {what}: CUDA error {code}")

    def norm_check(self, arr, lens, bitmap):
        """The earlier K8: arr [B, L] uint8, lens [B] int32 on the card ->
        stable [B] bool."""
        import torch

        B, L = arr.shape
        stable = torch.empty(B, dtype=torch.bool, device=arr.device)
        stream = torch.cuda.current_stream(arr.device).cuda_stream
        self._check(self.lib.ctok_norm_check(arr.data_ptr(), lens.data_ptr(), bitmap.data_ptr(),
                                             stable.data_ptr(), B, L, stream), "norm_check")
        return stable

    def wordlevel_lookup(self, chars, lens, disp, rows, size: int, n_buckets: int, token_chars,
                         token_lens, emit_ids, unk: int):
        """The earlier K11: chars [B, W] int32, lens [B] on the card -> out
        [B] int32."""
        import torch

        B, W = chars.shape
        out = torch.empty(B, dtype=torch.int32, device=chars.device)
        stream = torch.cuda.current_stream(chars.device).cuda_stream
        self._check(self.lib.ctok_wordlevel_lookup(
            chars.data_ptr(), lens.data_ptr(), disp.data_ptr(), rows.data_ptr(), size - 1,
            n_buckets - 1, token_chars.data_ptr(), token_lens.data_ptr(), emit_ids.data_ptr(),
            token_chars.shape[1], int(unk), out.data_ptr(), B, W, stream), "wordlevel_lookup")
        return out


def dense_word_rows(words: list[str], lanes: int = 128):
    """The earlier WordLevel tier's packing: (chars [n, lanes] int32, -1
    padded, lens [n] int32); a word wider than the lanes is left empty."""
    chars = np.full((len(words), lanes), -1, np.int32)
    lens = np.zeros(len(words), np.int32)
    for i, w in enumerate(words):
        if len(w) > lanes:
            continue
        chars[i, :len(w)] = [ord(c) for c in w]
        lens[i] = len(w)
    return chars, lens


def bucket_rows(raw: list[bytes], length_buckets) -> list[tuple[list[int], np.ndarray, np.ndarray]]:
    """The earlier normalization check's batches: the rows grouped by the
    first length bucket that holds them (empty rows in the first), each
    group as zero-padded [B, L] uint8 rows and [B] int32 lengths, with the
    rows' indices; rows over the largest bucket are left out."""
    groups: dict[int, list[int]] = {}
    for i, d in enumerate(raw):
        L = next((b for b in length_buckets if max(len(d), 1) <= b), None)
        if L is not None:
            groups.setdefault(L, []).append(i)
    out = []
    for L, idxs in sorted(groups.items()):
        arr = np.zeros((len(idxs), L), np.uint8)
        lens = np.zeros(len(idxs), np.int32)
        for row, i in enumerate(idxs):
            arr[row, :len(raw[i])] = np.frombuffer(raw[i], np.uint8)
            lens[row] = len(raw[i])
        out.append((idxs, arr, lens))
    return out


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

#!/usr/bin/env python3
"""Build and call an earlier checkout's kernels beside the package's.

    python3 scripts/parent_word_kernels.py --parent ab/parent

``--parent DIR``: a checkout of an earlier commit (``git archive <commit>
complexity_tokenizer_tpu_torch/csrc | tar -x -C DIR``).  The script binds
what that checkout's sources hold, by their C signatures:

- ``csrc/normcheck.cu`` with the dense K8 (86e566f to ef545a1):
  ``ctok_norm_check(bytes, lens, bitmap, stable, B, L, stream)``, a warp a
  [B, L] row (:meth:`ParentKernels.norm_check`);
- ``csrc/wordpiece.cu`` with the dense K11 (the same commits):
  ``ctok_wordlevel_lookup(chars, lens, disp, rows, size_mask, bucket_mask,
  token_chars, token_lens, emit_ids, Lt, unk, out, B, W, stream)``, a warp
  a [B, 128] row (:meth:`ParentKernels.wordlevel_lookup`);
- ``csrc/unigram.cu`` with the first K12 (e635772):
  ``ctok_viterbi(chars, offs, lens, B, disp, rows, size_mask, bucket_mask,
  piece_chars, piece_lens, piece_scores, Lt, fallback_score, maxcand,
  fallback_id, pows, res, N, stream)``, a warp a text
  (:meth:`ParentKernels.viterbi`);
- ``csrc/wordfill.cu``'s K4, ``ctok_fill_compact(merged, count, out, B, W,
  cap, itemsize, stream)`` (one signature since K4 was written;
  :meth:`ParentKernels.fill_compact`), launched as that commit launched it.

A source of another form is not compiled (a commit's ``kernels.cu`` never
is).  The rest are compiled with the package's ``nvcc`` flags, one process
each, all at once, and linked into one library under
``build/parent_kernels/``; :attr:`ParentKernels.kernels` names what was
bound.  ``chip_smoke.py --parent DIR`` times them beside the package's
kernels in the same call, on the same inputs laid out as that commit laid
them out (:func:`dense_word_rows`, :func:`bucket_rows`).  Run alone, the
script builds them and prints ``nvcc``'s register report.  Needs ``nvcc``;
the calls need a card.
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
P, I, U, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_longlong, ctypes.c_float


# source -> (kernel name, a text only that kernel's form of the source holds,
# its ctypes argument types)
_FORMS = {
    "normcheck.cu": ("norm_check", "int ctok_norm_check(const void* bytes, const void* lens,",
                     (P, P, P, P, I, I, P)),
    "wordpiece.cu": ("wordlevel_lookup",
                     "int ctok_wordlevel_lookup(const void* chars, const void* lens,",
                     (P, P, P, P, U, U, P, P, P, I, I, P, I, I, P)),
    "unigram.cu": ("viterbi", "int ctok_viterbi(const void* chars, const void* offs, "
                   "const void* lens, int B,",
                   (P, P, P, I, P, P, U, U, P, P, P, I, F, I, I, P, P, I, P)),
    "wordfill.cu": ("fill_compact", "int ctok_fill_compact(const void* merged,",
                    (P, P, P, I, I, L, I, P)),
}


class ParentKernels:
    """The earlier kernels of the checkout ``parent_dir`` that this script
    knows (``kernels``: their names), built once."""

    def __init__(self, parent_dir: str):
        sys.path.insert(0, REPO)
        from complexity_tokenizer_tpu_torch.utils.cuda_build import LINK_FLAGS, NVCC_FLAGS, _nvcc

        csrc = os.path.join(parent_dir, "complexity_tokenizer_tpu_torch", "csrc")
        forms = {}
        for name, (kernel, mark, argtypes) in _FORMS.items():
            path = os.path.join(csrc, name)
            if os.path.exists(path):
                with open(path) as fh:
                    if mark in " ".join(fh.read().split()):
                        forms[path] = (kernel, argtypes)
        if not forms:
            raise RuntimeError(f"no kernel of a known earlier form under {csrc}")
        sources = sorted(forms)
        h = hashlib.sha256()
        for f in sources + [os.path.join(csrc, "chd_hash.cuh")]:
            if os.path.exists(f):
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
        self.kernels = sorted(kernel for kernel, _ in forms.values())
        for kernel, argtypes in forms.values():
            fn = getattr(self.lib, "ctok_" + kernel)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int

    def has(self, kernel: str) -> bool:
        """Whether the checkout holds ``kernel`` in the form this script binds."""
        return kernel in self.kernels

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


    def viterbi(self, chars, offs, lens, disp, rows, size: int, n_buckets: int, piece_chars,
                piece_lens, piece_scores, fallback_score: float, maxcand: int,
                fallback_id: int = -2):
        """The first K12 (a warp a text) on ragged texts on the card: the
        arguments of ``ops/unigram_device.py:viterbi`` without the groups ->
        res [N + 2B] int32."""
        import torch

        from complexity_tokenizer_tpu_torch.ops.wordpiece_device import hash_powers

        N, B = chars.numel(), lens.numel()
        res = torch.empty(N + 2 * B, dtype=torch.int32, device=chars.device)
        stream = torch.cuda.current_stream(chars.device).cuda_stream
        self._check(self.lib.ctok_viterbi(
            chars.data_ptr(), offs.data_ptr(), lens.data_ptr(), B, disp.data_ptr(),
            rows.data_ptr(), size - 1, n_buckets - 1, piece_chars.data_ptr(),
            piece_lens.data_ptr(), piece_scores.data_ptr(), piece_chars.shape[1],
            ctypes.c_float(fallback_score), int(min(maxcand, 128)), int(fallback_id),
            hash_powers(chars.device).data_ptr(), res.data_ptr(), N, stream), "viterbi")
        return res

    def fill_compact(self, merged, count, cap: int, itemsize: int):
        """The earlier K4 on the card: merged [B, W] int32, count [B] int32
        -> the fused buffer of ``ops/wordfill.py:fill_compact``."""
        import torch

        from complexity_tokenizer_tpu_torch.ops.wordfill import fill_layout

        B, W = merged.shape
        out = torch.empty(fill_layout(B, W, cap, itemsize)[2], dtype=torch.uint8,
                          device=merged.device)
        stream = torch.cuda.current_stream(merged.device).cuda_stream
        self._check(self.lib.ctok_fill_compact(merged.data_ptr(), count.data_ptr(),
                                               out.data_ptr(), B, W, cap, itemsize, stream),
                    "fill_compact")
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
    print(f"built {', '.join(k.kernels)} in {k.build_seconds:.3f} s")
    for line in k.ptxas_log.splitlines():
        if "registers" in line or "Compiling" in line:
            print("  " + line.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())

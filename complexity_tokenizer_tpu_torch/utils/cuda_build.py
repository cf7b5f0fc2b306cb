"""Build and load the port's CUDA kernels (``csrc/*.cu``).

One ``nvcc`` per source, all started together, compiles each for Hopper
(``sm_90a``); one more links them into a shared library with a plain C
interface, which is loaded with ``ctypes``.
No source includes PyTorch's headers, so the build takes seconds.  It runs
at first use, into ``build/`` beside the package (listed in
``.gitignore``), under a name keyed by the sources and flags, so a later
process reuses it.  A missing ``nvcc`` or a failed build raises: there is
no fallback.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from dataclasses import dataclass

__all__ = ["KernelLibrary", "kernel_library", "check", "launch_info"]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC_DIR = os.path.join(_PKG_DIR, "csrc")
_BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    # arr, lens, table, out, B, W, stream
    "ctok_seed_tokens": (_P, _P, _P, _P, _I, _I, _P),
    # tokens_in, wid, t1, t2, mask, tokens_out, count, B, L, stream
    "ctok_merge_fixpoint_qc": (_P, _P, _P, _P, _U, _P, _P, _I, _I, _P),
    # tokens_in, wid, disp, rows, size_mask, bucket_mask, tokens_out, count, B, L, stream
    "ctok_merge_fixpoint_chd": (_P, _P, _P, _P, _U, _U, _P, _P, _I, _I, _P),
    # syms, offs, tiles, n_tiles, lanes, disp, rows, size_mask, bucket_mask, out, count,
    # stream
    "ctok_merge_word_rows": (_P, _P, _P, _I, _I, _P, _P, _U, _U, _P, _P, _P),
    # syms, offs, tiles, n_tiles, lanes, t1, t2, mask, out, count, stream
    "ctok_merge_word_rows_qc": (_P, _P, _P, _I, _I, _P, _P, _U, _P, _P, _P),
    # data, n_bytes, offs, block_rows, n_blocks, bitmap, stable, B, span, stream
    "ctok_norm_check": (_P, _I, _P, _P, _I, _P, _P, _I, _I, _P),
    # info[5]
    "ctok_norm_check_info": (_P,),
    # chars, offs, lens, n8, n16, B, disp, rows, size_mask, bucket_mask, token_chars,
    # token_lens, emit_ids, Lt, unk, max_input, pows, out, count, poison, stream
    "ctok_wordpiece_match": (_P, _P, _P, _I, _I, _I, _P, _P, _U, _U, _P, _P, _P, _I, _I, _I, _P,
                             _P, _P, _P, _P),
    # info[5]
    "ctok_wordpiece_info": (_P,),
    # chars, offs, lens, n8, n16, B, disp, rows, size_mask, bucket_mask, token_chars,
    # token_lens, Lt, unk, out, stream
    "ctok_wordlevel_lookup": (_P, _P, _P, _I, _I, _I, _P, _P, _U, _U, _P, _P, _I, _I, _P, _P),
    # info[5]
    "ctok_wordlevel_info": (_P,),
    # chars, offs, lens, n8, n16, B, disp, rows, size_mask, bucket_mask, piece_chars,
    # piece_lens, piece_scores, Lt, fallback_score, maxcand, fallback_id, pows, res, N, stream
    "ctok_viterbi": (_P, _P, _P, _I, _I, _I, _P, _P, _U, _U, _P, _P, _P, _I, _F, _I, _I, _P, _P,
                     _I, _P),
    # info[5]
    "ctok_viterbi_info": (_P,),
    # chd, policy (0 rows, 1 fill, 2 ragged), L, info[6]
    "ctok_merge_fixpoint_info": (_I, _I, _I, _P),
    # bytes, start_bits, row_len, byte_table, t1, t2, mask, tokens_out, count, B, L, stream
    "ctok_word_merge_qc": (_P, _P, _P, _P, _P, _P, _U, _P, _P, _I, _I, _P),
    # bytes, start_bits, row_len, byte_table, disp, rows, size_mask, bucket_mask,
    # tokens_out, count, B, L, stream
    "ctok_word_merge_chd": (_P, _P, _P, _P, _P, _P, _U, _U, _P, _P, _I, _I, _P),
    # bits, row_len, wid, B, W, stream
    "ctok_word_ids": (_P, _P, _P, _I, _I, _P),
    # bytes, lens, class_table, start, wid, valid, B, L, stream
    "ctok_presplit": (_P, _P, _P, _P, _P, _P, _I, _I, _P),
    # L, info[6]
    "ctok_presplit_info": (_I, _P),
    # merged, count, out, B, W, cap, itemsize, stream
    "ctok_fill_compact": (_P, _P, _P, _I, _I, _L, _I, _P),
    # merged, count, wid2, kept, out, B, W, cap, itemsize, stream
    "ctok_fill_compact_phased": (_P, _P, _P, _P, _P, _I, _I, _L, _I, _P),
    # bytes, start_bits, row_len, byte_table, t1, t2, mask, n1, out_t, out_w, kept, B, W,
    # stream
    "ctok_phase_compact_qc": (_P, _P, _P, _P, _P, _P, _U, _I, _P, _P, _P, _I, _I, _P),
    # bytes, start_bits, row_len, byte_table, disp, rows, size_mask, bucket_mask, n1, out_t,
    # out_w, kept, B, W, stream
    "ctok_phase_compact_chd": (_P, _P, _P, _P, _P, _P, _U, _U, _I, _P, _P, _P, _I, _I, _P),
    # ids, n, row_off, B, entries, arena, V, skip_special, state, out, cap, stream
    "ctok_decode_gather": (_P, _L, _P, _I, _P, _P, _I, _I, _P, _P, _L, _P),
    # info[5]
    "ctok_decode_info": (_P,),
    # words, freqs, N, W, v0, hist, stream
    "ctok_pair_hist": (_P, _P, _I, _I, _I, _P, _P),
    # N, W, v0, info[11]
    "ctok_pair_hist_info": (_I, _I, _I, _P),
    # words, freqs, N, W, ma, mb, step, a, b, new_id, delta, V, minted, stream
    "ctok_merge_step": (_P, _P, _I, _I, _P, _P, _I, _I, _I, _I, _P, _I, _P, _P, _L, _P),
    # hist, V, scratch, step, ma, mb, stream
    "ctok_select_argmax": (_P, _I, _P, _I, _P, _P, _P),
    # hist, V, ca, cb, T, n_cand, state, step, ma, mb, stream
    "ctok_select_window": (_P, _I, _P, _P, _I, _I, _P, _I, _P, _P, _P),
    # hist, V, step, ma, mb, new_id, delta, stream
    "ctok_hist_update": (_P, _I, _I, _P, _P, _I, _P, _P),
    # res, offs, freqs, gidx, B, N, V, n_global, buf, stream
    "ctok_piece_hist": (_P, _P, _P, _P, _I, _I, _I, _I, _P, _P),
    # info[5]
    "ctok_piece_hist_info": (_P,),
    # chars, offs, lens, n8, n16, B, table, t_mask, slot_meta, slot_chars, fb_map, lt_cap,
    # out, poison, stream
    "ctok_train_match": (_P, _P, _P, _I, _I, _I, _P, _U, _P, _P, _P, _I, _P, _P, _P),
    # info[5]
    "ctok_train_match_info": (_P,),
    # out, N, offs, freqs, poison, B, table, t_size, rows, head, res, stream
    "ctok_pair_count": (_P, _I, _P, _P, _P, _I, _P, _I, _P, _P, _P, _P),
    # info[5]
    "ctok_pair_count_info": (_P,),
}


@dataclass
class KernelLibrary:
    lib: ctypes.CDLL
    path: str
    build_seconds: float  # 0.0 when an earlier build was reused
    ptxas_log: str  # nvcc's -Xptxas -v report (registers, shared memory)


_lock = threading.Lock()
_loaded: KernelLibrary | None = None


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = os.path.join(home, "bin", "nvcc")
        path = cand if os.path.exists(cand) else None
    if path is None:
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin): cannot build the CUDA kernels"
        )
    return path


def _build() -> KernelLibrary:
    sources = sorted(glob.glob(os.path.join(_SRC_DIR, "*.cu")))
    headers = sorted(glob.glob(os.path.join(_SRC_DIR, "*.cuh")))
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for f in sources + headers:
        with open(f, "rb") as fh:
            h.update(fh.read())
    key = h.hexdigest()[:16]
    os.makedirs(_BUILD_DIR, exist_ok=True)
    so = os.path.join(_BUILD_DIR, f"libctok_kernels_{key}.so")
    log_path = so + ".log"
    seconds = 0.0
    if not os.path.exists(so):
        nvcc = _nvcc()
        tmp_dir = tempfile.mkdtemp(dir=_BUILD_DIR)
        tmp = os.path.join(tmp_dir, "lib.so")
        t0 = time.perf_counter()
        try:
            objs = [os.path.join(tmp_dir, f"{i}.o") for i in range(len(sources))]
            procs = [
                subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-c", src, "-o", obj],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                )
                for src, obj in zip(sources, objs)
            ]
            logs = [p.communicate()[0] for p in procs]
            for src, p, out in zip(sources, procs, logs):
                if p.returncode != 0:
                    raise RuntimeError(f"nvcc failed on {src} ({p.returncode}):\n{out}")
            proc = subprocess.run(
                [nvcc, *LINK_FLAGS, "-o", tmp, *objs], capture_output=True, text=True
            )
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc link failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
                )
            seconds = time.perf_counter() - t0
            with open(log_path, "w") as fh:
                fh.write("".join(logs) + proc.stdout + proc.stderr)
            os.replace(tmp, so)  # atomic: a concurrent process sees a whole file
        finally:
            shutil.rmtree(tmp_dir, ignore_errors=True)
    with open(log_path) as fh:
        log = fh.read()
    lib = ctypes.CDLL(so)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.ctok_error_string.argtypes = (ctypes.c_int,)
    lib.ctok_error_string.restype = ctypes.c_char_p
    return KernelLibrary(lib, so, seconds, log)


def kernel_library() -> KernelLibrary:
    """The loaded kernel library, built on first use."""
    global _loaded
    with _lock:
        if _loaded is None:
            _loaded = _build()
        return _loaded


def check(code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if code != 0:
        msg = kernel_library().lib.ctok_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def launch_info(entry: str, what: str) -> dict:
    """A kernel's launch shape from its ``ctok_*_info(int* info)`` entry:
    threads a block, registers a thread, static shared bytes a block, local
    (spill) bytes a thread, resident blocks per SM.  Needs a card; launches
    nothing."""
    keys = ("threads", "registers", "static_smem", "local_bytes", "blocks_per_sm")
    info = (ctypes.c_int * len(keys))()
    check(getattr(kernel_library().lib, entry)(ctypes.addressof(info)), what)
    return dict(zip(keys, info))

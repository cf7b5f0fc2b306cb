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

__all__ = ["KernelLibrary", "kernel_library", "check"]

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
_SIGNATURES = {
    # arr, lens, table, out, B, W, stream
    "ctok_seed_tokens": (_P, _P, _P, _P, _I, _I, _P),
    # tokens_in, wid, t1, t2, mask, tokens_out, count, B, L, stream
    "ctok_merge_fixpoint_qc": (_P, _P, _P, _P, _U, _P, _P, _I, _I, _P),
    # tokens_in, wid, disp, rows, size_mask, bucket_mask, tokens_out, count, B, L, stream
    "ctok_merge_fixpoint_chd": (_P, _P, _P, _P, _U, _U, _P, _P, _I, _I, _P),
    # tokens_in, disp, rows, size_mask, bucket_mask, tokens_out, count, B, L, stream
    "ctok_merge_word_rows": (_P, _P, _P, _U, _U, _P, _P, _I, _I, _P),
    # bytes, lens, bitmap, stable, B, L, stream
    "ctok_norm_check": (_P, _P, _P, _P, _I, _I, _P),
    # chars, lens, disp, rows, size_mask, bucket_mask, token_chars, token_lens, emit_ids,
    # Lt, unk, max_input, out, count, poison, B, W, stream
    "ctok_wordpiece_match": (_P, _P, _P, _P, _U, _U, _P, _P, _P, _I, _I, _I, _P, _P, _P, _I, _I,
                             _P),
    # chars, lens, disp, rows, size_mask, bucket_mask, token_chars, token_lens, emit_ids,
    # Lt, unk, out, B, W, stream
    "ctok_wordlevel_lookup": (_P, _P, _P, _P, _U, _U, _P, _P, _P, _I, _I, _P, _I, _I, _P),
    # chd, fill, L, info[6]
    "ctok_merge_fixpoint_info": (_I, _I, _I, _P),
    # bytes, start_bits, row_len, byte_table, t1, t2, mask, tokens_out, count, B, L, stream
    "ctok_word_merge_qc": (_P, _P, _P, _P, _P, _P, _U, _P, _P, _I, _I, _P),
    # bytes, start_bits, row_len, byte_table, disp, rows, size_mask, bucket_mask,
    # tokens_out, count, B, L, stream
    "ctok_word_merge_chd": (_P, _P, _P, _P, _P, _P, _U, _U, _P, _P, _I, _I, _P),
    # bits, row_len, wid, B, W, stream
    "ctok_word_ids": (_P, _P, _P, _I, _I, _P),
    # merged, count, out, B, W, cap, itemsize, stream
    "ctok_fill_compact": (_P, _P, _P, _I, _I, _L, _I, _P),
    # ids, n, row_off, B, entries, arena, V, skip_special, state, out, cap, stream
    "ctok_decode_gather": (_P, _L, _P, _I, _P, _P, _I, _I, _P, _P, _L, _P),
    # info[5]
    "ctok_decode_info": (_P,),
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

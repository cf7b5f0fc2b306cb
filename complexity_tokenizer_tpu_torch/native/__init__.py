"""ctypes bindings for the port's copy of the native host runtime
(``ctok_host.cpp``): the GPT-2 pre-split, the word caches, the host merge
loop, the miss-word scan, the segment packer of the word path, the
multi-pattern added-token scan and the ByteLevel batch decoder.

Built at first use with ``g++`` into ``build/torch_native/`` beside the
package, under a name keyed by the source, the flags, the CPU that
``-march=native`` resolves to and the Python version, so that a library
built on one machine is never loaded on another.  When ``Python.h`` exists
the same library is also a CPython extension (``_ctok_ext``) with the fused
batch entry points; without it the callers take the bytes route
(``NativeEncoder._encode_batch_raw``).  A missing compiler or a failed build
raises: there is no pure-Python fallback.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import sys
import sysconfig
import tempfile
import threading

import numpy as np

__all__ = ["load_library", "load_ext", "NativeEncoder", "NativeDecoder", "match_any",
           "scanner_ctx", "count_words", "native_pack"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "ctok_host.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build", "torch_native")
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")
_lock = threading.Lock()
_lib = None
_lib_path: str | None = None
_ext = None
_ext_tried = False

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int32
_SIGNATURES = {
    # name: (restype, argtypes)
    "ctok_new": (_P, (_I64, _P, _P, _P, _P, _I64, _P, _P, _I64)),
    "ctok_free": (None, (_P,)),
    "ctok_encode": (_I64, (_P, _P, _I64, _P)),
    "ctok_encode_batch": (None, (_P, _P, _P, _I64, _P, _P, _I32)),
    "ctok_compact": (None, (_P, _P, _P, _I64, _P, _P)),
    "ctok_match_any": (None, (_P, _P, _I64, _P, _P, _I64, _P, _I32)),
    "ctok_encode_batch_gated": (None, (_P, _P, _P, _I64, _P, _P, _I64, _P, _P, _I32)),
    "ctok_collect_miss_words": (_I64, (_P, _P, _P, _I64, _I64, _P, _P, _I64, _I64, _I32)),
    "ctok_cache_insert_batch": (None, (_P, _P, _P, _I64, _P, _P)),
    "ctok_warm_start": (_I64, (_P, _P, _P, _I64, _P, _P, _I32)),
    "ctok_pack_seg": (_I64, (_P, _P, _I64, _I64, _I64, _P, _P, _P, _P)),
    "ctok_decoder_new": (_P, (_P, _P, _I64, _P, _P, _I64)),
    "ctok_decoder_free": (None, (_P,)),
    "ctok_decode_batch": (_I64, (_P, _P, _P, _I64, _I32, _I32, _P, _P, _P, _I64)),
    "ctok_pack": (None, (_P, _P, _I64, _I64, _P, _P)),
}


def _python_include() -> str | None:
    inc = sysconfig.get_paths().get("include")
    if inc and os.path.exists(os.path.join(inc, "Python.h")):
        return inc
    return None


def _cxx() -> str:
    path = shutil.which("g++")
    if path is None:
        raise RuntimeError("g++ not found on PATH: cannot build the native host runtime")
    return path


def _native_target(cxx: str) -> str:
    """The compiler's expansion of ``-march=native`` on this machine."""
    proc = subprocess.run(
        [cxx, "-march=native", "-###", "-E", "-x", "c++", os.devnull],
        capture_output=True, text=True, timeout=60,
    )
    lines = [ln for ln in proc.stderr.splitlines() if "-march=" in ln and "cc1" in ln]
    return lines[-1] if lines else proc.stderr


def _flags() -> list[str]:
    flags = list(CXX_FLAGS)
    inc = _python_include()
    if inc:
        flags += ["-DCTOK_WITH_PYTHON", f"-I{inc}"]
    return flags


def _build() -> str:
    cxx = _cxx()
    flags = _flags()
    h = hashlib.sha256(" ".join(flags).encode())
    h.update(_native_target(cxx).encode())
    h.update(sys.version.encode())
    with open(_SRC, "rb") as fh:
        h.update(fh.read())
    os.makedirs(_BUILD_DIR, exist_ok=True)
    py = f"py{sys.version_info[0]}{sys.version_info[1]}"
    so = os.path.join(_BUILD_DIR, f"libctok_host_{py}_{h.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so
    # one build at a time across processes (test workers start together)
    with open(os.path.join(_BUILD_DIR, "build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(so):
            return so
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        proc = subprocess.run(
            [cxx, *flags, _SRC, "-o", tmp], capture_output=True, text=True, timeout=600
        )
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"g++ failed ({proc.returncode}) building {_SRC}:\n{proc.stderr[-4000:]}"
            )
        os.replace(tmp, so)  # atomic: a concurrent process sees a whole file
    return so


def load_library():
    """The native library (ctypes), built on first use.  Raises when it
    cannot be built or loaded."""
    global _lib, _lib_path
    with _lock:
        if _lib is not None:
            return _lib
        path = _build()
        lib = ctypes.CDLL(path)
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _lib, _lib_path = lib, path
        return _lib


def load_ext():
    """The CPython extension view of the native library (the fused batch
    entry points), or None when the library was built without
    ``Python.h``.  Raises when the extension was built but does not load."""
    global _ext, _ext_tried
    load_library()
    with _lock:
        if _ext_tried:
            return _ext
        _ext_tried = True
        if _python_include() is None:
            return None
        import importlib.util
        from importlib.machinery import ExtensionFileLoader

        loader = ExtensionFileLoader("_ctok_ext", _lib_path)
        spec = importlib.util.spec_from_file_location("_ctok_ext", _lib_path, loader=loader)
        mod = importlib.util.module_from_spec(spec)
        loader.exec_module(mod)
        if not hasattr(mod, "encode_ragged"):
            raise RuntimeError(f"{_lib_path} lacks the _ctok_ext entry points")
        _ext = mod
        return _ext


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _joined(data: list[bytes]):
    """(joined uint8 buffer, int64 offsets[n + 1]) of byte strings."""
    offsets = np.zeros(len(data) + 1, np.int64)
    np.cumsum([len(d) for d in data], out=offsets[1:])
    joined = b"".join(data)
    jb = np.frombuffer(joined, np.uint8) if joined else np.zeros(1, np.uint8)
    return jb, offsets


class NativeEncoder:
    """Native byte-level BPE encoder (pre-split + seed + merge loop, with
    word caches shared by every call).  Exactly the host oracle's ids for
    ByteLevel configurations."""

    def __init__(self, packed, byte_token_table: np.ndarray):
        """``packed`` is ``(pa, pb, pr, rank_new)`` from
        ``core.bpe.BpeTokenizer.packed_merge_arrays``."""
        from ..utils.unicode_tables import gpt2_class_table

        lib = load_library()
        self._lib = lib
        pa, pb, pr, rank_new = (np.ascontiguousarray(a, np.int32) for a in packed)
        # keep referenced arrays alive for the ctx lifetime
        self._keep = (
            pa, pb, pr, rank_new,
            np.ascontiguousarray(byte_token_table, np.int32),
            np.ascontiguousarray(gpt2_class_table()),
        )
        cls = self._keep[5]
        self._ctx = lib.ctok_new(
            len(pa), _ptr(pa), _ptr(pb), _ptr(pr), _ptr(rank_new), len(rank_new),
            _ptr(self._keep[4]), _ptr(cls), len(cls),
        )

    def __del__(self):
        if getattr(self, "_ctx", None):
            self._lib.ctok_free(self._ctx)
            self._ctx = None

    def encode_one_fused(self, text: str, add_prefix_space: bool,
                         patterns: list[bytes] | None) -> list[int] | None:
        """One text's ids in one native call (UTF-8 view, prefix space,
        added-token gate, encode, list build).  None when an added-token
        pattern occurs in the text's bytes (the caller's oracle encodes
        it).  Without the extension: the same steps over the bytes."""
        ext = load_ext()
        if ext is not None:
            return ext.encode_one(self._ctx, text, int(bool(add_prefix_space)), patterns)
        if add_prefix_space and text and not text.startswith(" "):
            text = " " + text
        data = text.encode("utf-8")
        if patterns and match_any([data], patterns)[0]:
            return None
        return self.encode(data)

    def encode(self, data: bytes) -> list[int]:
        n = len(data)
        if n == 0:
            return []
        buf = np.frombuffer(data, np.uint8)
        out = np.empty(n, np.int32)
        m = self._lib.ctok_encode(self._ctx, _ptr(buf), n, _ptr(out))
        return out[:m].tolist()

    def _encode_batch_raw(
        self,
        data: list[bytes],
        n_threads: int | None,
        gate_patterns: list[bytes] | None = None,
    ):
        """Returns (out, offsets, counts): text i's ids at
        ``out[offsets[i]:offsets[i] + counts[i]]``.  With ``gate_patterns``,
        texts containing any pattern are skipped with count -1."""
        n = len(data)
        if n_threads is None:
            n_threads = os.cpu_count() or 1
        jb, offsets = _joined(data)
        out = np.empty(max(int(offsets[-1]), 1), np.int32)
        counts = np.zeros(n, np.int32)
        if gate_patterns:
            pb, pat_offsets = _joined(gate_patterns)
            self._lib.ctok_encode_batch_gated(
                self._ctx, _ptr(jb), _ptr(offsets), n, _ptr(pb), _ptr(pat_offsets),
                len(gate_patterns), _ptr(out), _ptr(counts), int(n_threads),
            )
        else:
            self._lib.ctok_encode_batch(
                self._ctx, _ptr(jb), _ptr(offsets), n, _ptr(out), _ptr(counts),
                int(n_threads),
            )
        return out, offsets, counts

    def collect_miss_words(
        self, data: list[bytes], max_wlen: int = 32,
        cap_words: int = 1 << 20, cap_bytes: int = 1 << 24,
        n_threads: int | None = None,
    ):
        """Distinct pre-split words of the corpus (at most ``max_wlen``
        bytes) that the shared caches do not hold yet: (words_buf uint8,
        lens int32[n]).  Probes only the shared caches under their own
        native mutex, so it may run on a background thread beside host
        encodes; ``n_threads=1`` keeps it off the worker pool."""
        n = len(data)
        if n == 0:
            return np.zeros(0, np.uint8), np.zeros(0, np.int32)
        jb, offsets = _joined(data)
        total = int(offsets[-1])
        cap_bytes = min(cap_bytes, total + 1)
        cap_words = min(cap_words, total + 1)
        words = np.empty(cap_bytes, np.uint8)
        lens = np.empty(cap_words, np.int32)
        n_words = self._lib.ctok_collect_miss_words(
            self._ctx, _ptr(jb), _ptr(offsets), n, int(max_wlen),
            _ptr(words), _ptr(lens), cap_words, cap_bytes, int(n_threads or 0),
        )
        lens = lens[:n_words]
        return (words[: int(lens.sum())] if n_words else np.zeros(0, np.uint8)), lens

    def warm_start(self, words_buf: np.ndarray, word_lens, n_threads: int | None = None):
        """Merge distinct words through the native merge loop and insert
        them into the shared caches.  Returns (ids_flat int32, counts
        int64[n]) in input order: the host merge's own ids of each word."""
        n = len(word_lens)
        if n == 0:
            return np.zeros(0, np.int32), np.zeros(0, np.int64)
        lens = np.ascontiguousarray(word_lens, np.int64)
        offsets = np.zeros(n + 1, np.int64)
        np.cumsum(lens, out=offsets[1:])
        wb = np.ascontiguousarray(words_buf, np.uint8)
        if not wb.size:
            wb = np.zeros(1, np.uint8)
        ids_tmp = np.empty(max(int(offsets[-1]), 1), np.int32)
        counts32 = np.zeros(n, np.int32)
        self._lib.ctok_warm_start(
            self._ctx, _ptr(wb), _ptr(offsets), n, _ptr(ids_tmp), _ptr(counts32),
            int(n_threads if n_threads is not None else min(os.cpu_count() or 1, 16)),
        )
        counts = counts32.astype(np.int64)
        # ids sit at each word's byte offset: gather them into a flat buffer
        out_offs = np.zeros(n + 1, np.int64)
        np.cumsum(counts, out=out_offs[1:])
        idx = (
            np.arange(int(out_offs[-1]), dtype=np.int64)
            - np.repeat(out_offs[:-1], counts)
            + np.repeat(offsets[:-1], counts)
        )
        return ids_tmp[idx], counts

    def cache_insert(self, words_buf: np.ndarray, word_lens: np.ndarray,
                     ids_rows: list[list[int]]):
        """Insert precomputed word encodes into the shared caches."""
        n = len(word_lens)
        if n == 0:
            return
        ids_counts = np.fromiter((len(r) for r in ids_rows), np.int64, count=n)
        total = int(ids_counts.sum())
        ids_buf = (
            np.fromiter((i for r in ids_rows for i in r), np.int32, count=total)
            if total else np.zeros(1, np.int32)
        )
        self.cache_insert_flat(words_buf, word_lens, ids_buf, ids_counts)

    def cache_insert_flat(self, words_buf: np.ndarray, word_lens,
                          ids_flat: np.ndarray, ids_counts):
        """Insert word w's ids ``ids_flat[cumsum(ids_counts)[w-1]:...[w]]``
        into the shared caches (the native work mutex serialises it against
        encode calls)."""
        n = len(word_lens)
        if n == 0:
            return
        word_offsets = np.zeros(n + 1, np.int64)
        np.cumsum(word_lens, out=word_offsets[1:])
        ids_offsets = np.zeros(n + 1, np.int64)
        np.cumsum(ids_counts, out=ids_offsets[1:])
        ids_buf = np.ascontiguousarray(ids_flat, np.int32)
        if ids_buf.size == 0:
            ids_buf = np.zeros(1, np.int32)
        wb = np.ascontiguousarray(words_buf, np.uint8)
        self._lib.ctok_cache_insert_batch(
            self._ctx, _ptr(wb), _ptr(word_offsets), n, _ptr(ids_buf), _ptr(ids_offsets),
        )

    def compact(self, out: np.ndarray, offsets: np.ndarray, counts: np.ndarray):
        """Per-text id regions at byte offsets -> (flat int32, row_offsets
        int64).  All counts must be >= 0."""
        n = len(counts)
        total_ids = int(counts.sum())
        flat = np.empty(max(total_ids, 1), np.int32)
        row_offsets = np.zeros(n + 1, np.int64)
        self._lib.ctok_compact(
            _ptr(out), _ptr(offsets), _ptr(counts), n, _ptr(flat), _ptr(row_offsets)
        )
        return flat[:total_ids], row_offsets

    def encode_batch(self, data: list[bytes], n_threads: int | None = None):
        """Batch encode through the word caches; a list of id lists."""
        if not data:
            return []
        out, offsets, counts = self._encode_batch_raw(data, n_threads)
        return [
            out[int(offsets[i]) : int(offsets[i]) + int(counts[i])].tolist()
            for i in range(len(data))
        ]

    def encode_batch_ragged(self, data: list[bytes], n_threads: int | None = None):
        """(flat ids int32 [total], row offsets int64 [n + 1])."""
        if not data:
            return np.zeros(0, np.int32), np.zeros(1, np.int64)
        out, offsets, counts = self._encode_batch_raw(data, n_threads)
        return self.compact(out, offsets, counts)

    def encode_ragged_fused(
        self,
        texts: list[str],
        add_prefix_space: bool,
        patterns: list[bytes] | None,
        n_threads: int | None = None,
        ascii_norm: bool = False,
    ):
        """Batch encode from Python strings in one native call (UTF-8
        views, prefix space, added-token gate, encode, ragged compaction).
        Returns (flat int32, row_offsets int64, flagged indices or None,
        non-ASCII indices or None): those rows are empty in the output and
        are encoded by the caller (``ascii_norm=True`` flags non-ASCII rows
        instead of encoding them).  None without the extension."""
        ext = load_ext()
        if ext is None:
            return None
        if n_threads is None:
            n_threads = os.cpu_count() or 1
        flat_b, off_b, flagged, nonascii = ext.encode_ragged(
            self._ctx, texts, int(bool(add_prefix_space)), patterns or [],
            int(n_threads), int(bool(ascii_norm)),
        )
        return np.frombuffer(flat_b, np.int32), np.frombuffer(off_b, np.int64), flagged, nonascii

    def encode_rows_fused(
        self,
        texts: list[str],
        add_prefix_space: bool,
        patterns: list[bytes] | None,
        n_threads: int | None = None,
        ascii_norm: bool = False,
    ):
        """list[list[int]] built in C; None rows are the rows that
        :meth:`encode_ragged_fused` flags.  None without the extension."""
        ext = load_ext()
        if ext is None:
            return None
        if n_threads is None:
            n_threads = os.cpu_count() or 1
        return ext.encode_rows(
            self._ctx, texts, int(bool(add_prefix_space)), patterns or [],
            int(n_threads), int(bool(ascii_norm)),
        )


class NativeDecoder:
    """Native ByteLevel batch decoder: each id's raw bytes from an arena,
    a strict UTF-8 check, the reference's cleanup table and the
    whitespace split-join.  Rows of invalid UTF-8 are flagged back (None)
    for the caller's lossy host decode."""

    def __init__(self, arena: np.ndarray, offsets: np.ndarray, special_mask: np.ndarray):
        """``arena`` uint8 and ``offsets`` int64 ``[V + 1]``: id i's bytes
        are ``arena[offsets[i]:offsets[i + 1]]``; ``special_mask`` uint8
        ``[V]``, 1 where ``skip_special_tokens`` drops the id."""
        from ..utils.unicode_tables import gpt2_class_table

        lib = load_library()
        self._lib = lib
        n = len(offsets) - 1
        arena = np.ascontiguousarray(arena, np.uint8)
        offsets = np.ascontiguousarray(offsets, np.int64)
        sm = np.ascontiguousarray(special_mask, np.uint8)
        if n < 0 or len(sm) != n or int(offsets[-1]) > arena.size:
            raise ValueError("inconsistent decoder tables")
        if arena.size == 0:
            arena = np.zeros(1, np.uint8)
        # the context copies the arena, offsets and mask, and borrows the
        # class table for its lifetime
        self._cls = np.ascontiguousarray(gpt2_class_table())
        self._ctx = lib.ctok_decoder_new(
            _ptr(arena), _ptr(offsets), n, _ptr(sm), _ptr(self._cls), len(self._cls)
        )

    def __del__(self):
        if getattr(self, "_ctx", None):
            self._lib.ctok_decoder_free(self._ctx)
            self._ctx = None

    def decode_batch(self, batch, skip_special_tokens: bool, cleanup: bool):
        """(texts, flagged): rows of ids -> strings; flagged rows are None."""
        from itertools import chain

        row_offsets = np.zeros(len(batch) + 1, np.int64)
        np.cumsum([len(r) for r in batch], out=row_offsets[1:])
        total = int(row_offsets[-1])
        ids_flat = np.fromiter(chain.from_iterable(batch), np.int32, count=total)
        return self.decode_ragged(ids_flat, row_offsets, skip_special_tokens, cleanup)

    def decode_ragged(self, ids_flat, row_offsets, skip_special_tokens: bool, cleanup: bool):
        """(texts, flagged) from ragged rows: row i's ids are
        ``ids_flat[row_offsets[i]:row_offsets[i + 1]]``."""
        ids_flat = np.ascontiguousarray(ids_flat, np.int32)
        row_offsets = np.ascontiguousarray(row_offsets, np.int64)
        n = len(row_offsets) - 1
        if n < 0 or (n > 0 and (row_offsets[0] < 0 or np.any(np.diff(row_offsets) < 0)
                                or row_offsets[-1] > ids_flat.size)):
            raise ValueError("inconsistent ragged decode input")
        if ids_flat.size == 0:
            ids_flat = np.zeros(1, np.int32)
        ext = load_ext()
        if ext is not None:
            texts, flagged = ext.decode_ragged(
                self._ctx, ids_flat, row_offsets, int(skip_special_tokens), int(cleanup)
            )
            return texts, (list(flagged) if flagged is not None else [])
        cap = max(int(row_offsets[-1]) * 16 + 64, 1024)
        while True:
            out = np.empty(cap, np.uint8)
            out_offsets = np.zeros(n + 1, np.int64)
            flags = np.zeros(max(n, 1), np.uint8)
            written = self._lib.ctok_decode_batch(
                self._ctx, _ptr(ids_flat), _ptr(row_offsets), n, int(skip_special_tokens),
                int(cleanup), _ptr(out), _ptr(out_offsets), _ptr(flags), cap,
            )
            if written >= 0:
                break
            cap *= 4
        buf = out[:written].tobytes()
        texts: list[str | None] = [None] * n
        flagged: list[int] = []
        for i in range(n):
            if flags[i]:
                flagged.append(i)
            else:
                texts[i] = buf[out_offsets[i] : out_offsets[i + 1]].decode("utf-8")
        return texts, flagged


def match_any(data: list[bytes], patterns: list[bytes],
              n_threads: int | None = None) -> np.ndarray:
    """Per-text flags: True iff any pattern byte string occurs in the text
    (the native SIMD multi-pattern scan)."""
    lib = load_library()
    n = len(data)
    flags = np.zeros(max(n, 1), np.uint8)
    if n == 0 or not patterns:
        return flags[:n].astype(bool)
    jb, offsets = _joined(data)
    pb, pat_offsets = _joined(patterns)
    if n_threads is None:
        n_threads = os.cpu_count() or 1
    lib.ctok_match_any(
        _ptr(jb), _ptr(offsets), n, _ptr(pb), _ptr(pat_offsets), len(patterns),
        _ptr(flags), int(n_threads),
    )
    return flags.astype(bool)


_scan_ctx = None
_scan_keep = None


def scanner_ctx():
    """A native context with no vocabulary, for scanning alone: the word
    boundaries of the trainers' word count."""
    global _scan_ctx, _scan_keep
    lib = load_library()
    with _lock:
        if _scan_ctx is None:
            from ..utils.unicode_tables import gpt2_class_table

            cls = np.ascontiguousarray(gpt2_class_table())
            empty = np.zeros(1, np.int32)
            bt = np.full(256, -1, np.int32)
            _scan_keep = (cls, empty, bt)
            _scan_ctx = lib.ctok_new(
                0, _ptr(empty), _ptr(empty), _ptr(empty), _ptr(empty), 0,
                _ptr(bt), _ptr(cls), len(cls),
            )
    return _scan_ctx


def count_words(texts: list[str], min_len: int = 1,
                n_threads: int | None = None) -> dict[bytes, int] | None:
    """The corpus's word frequencies through the native scanner: {raw word
    bytes: count}, words of at least ``min_len`` bytes.  None when the
    library was built without ``Python.h`` (no extension surface)."""
    ext = load_ext()
    if ext is None:
        return None
    ctx = scanner_ctx()
    if n_threads is None:
        n_threads = os.cpu_count() or 1
    return ext.count_words(ctx, texts, int(min_len), int(n_threads))


def native_pack(data: list[bytes], L: int, B: int):
    """``ops.pipeline.pack_texts`` in C: a zero-padded [B, L] uint8 matrix
    (each row cut at L bytes) and [B] int32 lengths."""
    if len(data) > B:
        raise ValueError(f"native_pack: {len(data)} strings for {B} rows")
    lib = load_library()
    jb, offsets = _joined(data)
    arr = np.empty((B, L), np.uint8)
    lens = np.zeros(B, np.int32)
    lib.ctok_pack(_ptr(jb), _ptr(offsets), len(data), L, _ptr(arr), _ptr(lens))
    if len(data) < B:
        arr[len(data):] = 0
    return arr, lens

"""Device word path: the GPU merges the distinct words the caches miss.

The twin of the JAX package's ``ops/wordpath.py``.
The native runtime (``native/``) finds the distinct pre-split words that
its shared caches do not hold; they are sorted by length and packed back
to back into dense ``[B, 128]`` byte rows (a word never spans two rows,
``ctok_pack_seg``), with a start bitmap and each row's content length.
Each pack goes through the fill (``ops/wordfill.py``: K6, then K4, on
the card) and comes back as one fused byte buffer, in one copy into pinned
host memory.  The results go into the shared caches, and the native runtime
assembles every text from them.

Two modes:

- synchronous (``backend="device"``, :meth:`DeviceWordEncoder.fill_caches`):
  the fill runs before the batch is assembled;
- asynchronous (``backend="auto"``, :meth:`DeviceWordEncoder.maybe_fill_async`):
  the miss scan and the fill run on a background thread with a CUDA stream
  of its own; the serving thread harvests a finished fill into the caches
  at its next batch.  Every batch is exact whatever the timing, since the
  native runtime merges whatever is not cached yet.

Two variants, as in JAX, in either mode:

- sharded (``parallel/encode.py:shard_word_encoder``): a pack whose rows
  split evenly over the mesh's devices goes out as one block a device, each
  block's fill on its device and a stream of its own, with the tables copied
  there once, into a pinned buffer and an event of its own; the host joins
  the blocks' ids and bitmaps in row order.  A spill in any block sends the
  whole pack again at full capacity, sharded.
- phased (``CTOK_PHASE_N1=N``, read once per encoder; 0, the default, turns
  it off): a pack (sharded: a block) of an even number of rows fills
  through ``word_fill_phased`` (K20, then K2 or K5, then K4's phased mode):
  ``N`` steps on the rows, then the fixpoint finishes on half as many rows.
  Word boundaries then come from the buffer's start bitmap; a pack whose
  rows kept more than half their lanes, or whose bitmap does not show one
  start a word, is sent again unphased at full capacity.

One difference from the JAX package: a background fill that fails is not
counted and switched off after a few failures.  The error is raised again
in the serving thread, at the next harvest or :meth:`drain_async`; nothing
hides a failing device behind the host merge.
"""

from __future__ import annotations

import functools
import os
import threading
import time

import numpy as np
import torch

from .wordfill import word_fill, word_fill_phased

__all__ = ["DeviceWordEncoder", "build_word_encoder"]

# row width: one word of up to 128 bytes fits a row; longer words are left
# to the native merge loop
_WORD_W = 128
# rows of a pack; fills larger than the last go out as several packs of
# 1024 rows, graded by word length
_ROW_BUCKETS = (64, 256, 1024)


class _FillResult:
    """Result slot of one background scan and fill."""

    __slots__ = ("result", "error", "done", "words", "lens")

    def __init__(self):
        self.result = None
        self.error = None
        self.done = threading.Event()
        # the scanned miss words (set by the background thread before the
        # fill; consumed by the harvest)
        self.words = None
        self.lens = None


# Fill threads still running at interpreter exit are joined, so that no
# daemon thread is torn down inside a CUDA or native call.  A thread is
# joined to its end, not only until its result is set: when its tokenizer
# is otherwise unreferenced, the thread's last references free the
# native context, and that must not overlap the interpreter's teardown.
_live_fills: set = set()
_live_mu = threading.Lock()
_exit_hook_installed = False

# Serialises device fills across threads: the background fill and a
# synchronous one share the kernels' launch counters and the devices (one
# lock for the process covers every device of a mesh).  Host encodes never
# take this lock.
_device_lock = threading.Lock()


def _get_device_lock():
    return _device_lock


def _wait_live_fills():
    with _live_mu:
        threads = list(_live_fills)
    for thread in threads:
        thread.join()


def _track_fill(thread) -> None:
    global _exit_hook_installed
    with _live_mu:
        if not _exit_hook_installed:
            import atexit

            atexit.register(_wait_live_fills)
            _exit_hook_installed = True
        _live_fills.difference_update([t for t in _live_fills if not t.is_alive()])
        _live_fills.add(thread)


class DeviceWordEncoder:
    """Encodes batches by merging the distinct uncached words on the device."""

    # distinct words per fill at most; the rest is merged and cached by
    # the native runtime, which never changes a result
    fill_cap = 65536
    # once warm, skip the miss scan and sweep every sweep_interval batches;
    # empty sweeps back the interval off up to max_sweep_interval
    sweep_interval = 32
    max_sweep_interval = 512
    # below this many misses the background fill leaves them to the host
    min_async_fill = 64
    # id slots of the fused buffer as a fraction of the pack's lanes; a pack
    # with more live ids is dispatched once more with a slot for every lane
    _CAP_NUM, _CAP_DEN = 3, 8

    def __init__(self, pipeline, native):
        self.pipeline = pipeline  # ops/pipeline.py EncodePipeline: tables on a device
        self.native = native  # native.NativeEncoder
        self.device = pipeline.device
        self._steady = False
        self._batches_since_sweep = 0
        self._sweep_cur = self.sweep_interval
        # _async_mu guards _pending / _steady / _batches_since_sweep against
        # concurrent serving threads; it is never held while blocking
        self._async_mu = threading.Lock()
        self._pending = None
        # set when the batch that launched a fill has been served: the
        # background scan waits for it (at most half a second)
        self._serving_idle = threading.Event()
        self._serving_idle.set()
        # the fills' own stream, made here: the first side stream of a
        # process sets up PyTorch's stream pool (tens of milliseconds)
        self._stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self.words_filled = 0  # words inserted into the caches from the device
        # the last fill: words, packs by shape, spills, host seconds by stage
        self.last_fill: dict = {}
        # parallel/mesh.py BatchSharding of the packs' rows, or None; the
        # blocks' devices, tables and streams, made at the first sharded fill
        self._sharding = None
        self._blocks = None

    @property
    def sharding(self):
        return self._sharding

    @sharding.setter
    def sharding(self, value):
        # the blocks' tables and streams belong to the mesh they were made
        # for, and the unpack splits by the current mesh: a new one drops them
        self._sharding = value
        self._blocks = None

    @property
    def _phase_n1(self) -> int:
        """Steps of the fixpoint before the phased fill's compaction, from
        ``CTOK_PHASE_N1`` at first use (0, the default: no phasing)."""
        v = getattr(self, "_phase_n1_cached", None)
        if v is None:
            v = self._phase_n1_cached = int(os.environ.get("CTOK_PHASE_N1", "0"))
        return v

    def _n1_for(self, rows: int) -> int:
        """The phased fill's steps for a pack (or block) of ``rows`` rows:
        0 (unphased) unless phasing is on and the rows pair up."""
        return self._phase_n1 if self._phase_n1 > 0 and rows % 2 == 0 else 0

    @functools.cached_property
    def _out_dtype(self):
        """Device id dtype: uint16 when every producible id is below 65,535
        (0xFFFF is the dead-lane value), else int32."""
        return np.uint16 if self.pipeline.max_id < 65535 else np.int32

    # ------------------------------------------------------------------
    # packed device encode

    def _pack_seg(self, words_buf: np.ndarray, offs: np.ndarray, w0: int,
                  n_words: int, max_rows: int):
        """Segment-pack words [w0, w0+n_words) into dense rows (the native
        ``ctok_pack_seg``).  Returns (bytes [max_rows, W], marks [max_rows,
        W] with 1 = start, 2 = continuation, 0 = pad, starts [n_fit],
        n_fit, rows_used)."""
        from ..native import _ptr

        lib = self.native._lib
        arr = np.empty((max_rows, _WORD_W), np.uint8)
        marks = np.empty((max_rows, _WORD_W), np.uint8)
        starts = np.empty(max(n_words, 1), np.int64)
        wb = np.ascontiguousarray(words_buf, np.uint8)
        if not wb.size:
            wb = np.zeros(1, np.uint8)
        chunk_offs = np.ascontiguousarray(offs[w0 : w0 + n_words + 1], np.int64)
        rows_used = np.zeros(1, np.int64)
        n_fit = lib.ctok_pack_seg(
            _ptr(wb), _ptr(chunk_offs), n_words, _WORD_W, max_rows,
            _ptr(arr), _ptr(marks), _ptr(starts), _ptr(rows_used),
        )
        return arr, marks, starts[:n_fit], int(n_fit), int(rows_used[0])

    def _encode_words_packed(self, words_buf: np.ndarray, lens: np.ndarray):
        """Ragged distinct words -> (ids_flat int32, counts int64[n]).

        ``counts[w]`` is word w's number of ids, or -1 for a word the
        device did not cover (longer than a row); ``ids_flat`` holds the
        covered words' ids in input order.  Touches no native cache, so it
        may run off the serving thread.  Fills are serialised process-wide
        and run on a CUDA stream of their own, synchronised before the
        result is handed back."""
        with _get_device_lock():
            if self.device.type != "cuda":
                return self._encode_words_packed_locked(words_buf, lens)
            stream = self._stream
            stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(stream):
                out = self._encode_words_packed_locked(words_buf, lens)
            stream.synchronize()
            return out

    def _launch(self, dev, tables, a, bits, row_len, cap: int, n1: int):
        """Launch the fill of one pack or block on ``dev`` (its current
        stream), phased when ``n1`` > 0.  Returns (host uint8 tensor, CUDA
        event or None): on a card, the fused buffer is copied once into a
        pinned host tensor of its own, and the event marks the copy's end."""
        args = [torch.from_numpy(x).to(dev) for x in (a, bits, row_len)]
        isz = np.dtype(self._out_dtype).itemsize
        if n1:
            fused = word_fill_phased(*args, cap, n1, tables=tables, itemsize=isz)
        else:
            fused = word_fill(*args, cap, tables=tables, itemsize=isz)
        if dev.type != "cuda":
            return fused, None
        # a fresh pinned tensor per pack: no later fill writes into a buffer
        # that a harvest still reads, and the pinned allocator reuses the
        # block only after this copy has completed
        host = torch.empty(fused.shape, dtype=torch.uint8, pin_memory=True)
        host.copy_(fused, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(dev))
        return host, event

    def _fn(self, a, bits, row_len):
        """The fill of one pack at the compact capacity (3/8 of its lanes),
        phased when ``CTOK_PHASE_N1`` asks and the rows pair up."""
        B = a.shape[0]
        cap = B * _WORD_W * self._CAP_NUM // self._CAP_DEN
        return self._launch(self.device, self.pipeline.tables, a, bits, row_len, cap,
                            self._n1_for(B))

    def _fn_full(self, a, bits, row_len):
        """The fill of one pack with a slot for every lane, unphased: cannot
        spill."""
        return self._launch(self.device, self.pipeline.tables, a, bits, row_len,
                            a.shape[0] * _WORD_W, 0)

    def _block_state(self) -> list[tuple]:
        if self._blocks is None:
            self._blocks = self.pipeline.block_state(self._sharding)
        return self._blocks

    def _sharded(self, a, bits, row_len, cap_num: int, cap_den: int, phased: bool) -> list:
        """Launch every block of a sharded pack, each on its device and
        stream, before any is read back.  Returns each block's (host,
        event)."""
        blocks = self._sharding.blocks(a.shape[0])
        out = []
        for (dev, tables, stream), (_dev, rows) in zip(self._block_state(), blocks):
            B_loc = rows.stop - rows.start
            cap = B_loc * _WORD_W * cap_num // cap_den
            n1 = self._n1_for(B_loc) if phased else 0
            if stream is None:
                out.append(self._launch(dev, tables, a[rows], bits[rows], row_len[rows], cap, n1))
                continue
            with torch.cuda.device(dev):
                stream.wait_stream(torch.cuda.current_stream(dev))
                with torch.cuda.stream(stream):
                    out.append(self._launch(dev, tables, a[rows], bits[rows], row_len[rows],
                                            cap, n1))
        return out

    def _fn_sharded(self, a, bits, row_len):
        """The sharded fill of one pack at the compact capacity, each block
        phased as :meth:`_fn` would phase a pack of its rows."""
        return self._sharded(a, bits, row_len, self._CAP_NUM, self._CAP_DEN, True)

    def _fn_full_sharded(self, a, bits, row_len):
        """The sharded fill of one pack with a slot for every lane, unphased."""
        return self._sharded(a, bits, row_len, 1, 1, False)

    @staticmethod
    def _raw(fused) -> np.ndarray:
        """Wait for one fill and return its fused buffer."""
        host, event = fused
        if event is not None:
            event.synchronize()
        return host.numpy()

    def _unpack_fused(self, fused, cap: int):
        """Wait for one fill and split its fused buffer into (ids
        ndarray[cap], alive bit per lane, total)."""
        raw = self._raw(fused)
        ids_bytes = cap * np.dtype(self._out_dtype).itemsize
        out_ids = raw[:ids_bytes].view(self._out_dtype)
        alive = np.unpackbits(raw[ids_bytes:-4], bitorder="little")
        total = int(raw[-4:].view(np.int32)[0])
        return out_ids, alive, total

    def _unpack_fused_phased(self, fused, B: int, cap: int):
        """Phased twin of :meth:`_unpack_fused`: the buffer covers B*W/2
        lanes with an alive and a word-start bitmap.  Returns (ids, alive
        bits, word-start bits, total)."""
        raw = self._raw(fused)
        ids_bytes = cap * np.dtype(self._out_dtype).itemsize
        nb = B * _WORD_W // 16
        out_ids = raw[:ids_bytes].view(self._out_dtype)
        alive = np.unpackbits(raw[ids_bytes : ids_bytes + nb], bitorder="little")
        wstart = np.unpackbits(raw[ids_bytes + nb : -4], bitorder="little")
        total = int(raw[-4:].view(np.int32)[0])
        return out_ids, alive, wstart, total

    def _unpack_fused_sharded(self, fused, B: int, cap_num: int, cap_den: int):
        """Join a sharded fill's blocks (a list of one for an unsharded
        pack): (ids in row order, alive bits, spilled).  Each block's buffer
        is :meth:`_unpack_fused`'s with B/n rows; the blocks hold contiguous
        rows, so joining them in device order gives what one block of all
        the rows would."""
        B_loc = B // len(fused)
        cap_loc = B_loc * _WORD_W * cap_num // cap_den
        ids_parts, alive_parts, spilled = [], [], False
        for blk in fused:
            ids, alive, total = self._unpack_fused(blk, cap_loc)
            alive_parts.append(alive)
            if total > cap_loc:
                spilled = True
                total = cap_loc
            ids_parts.append(ids[:total])
        return np.concatenate(ids_parts), np.concatenate(alive_parts), spilled

    def _unpack_fused_sharded_phased(self, fused, B: int, cap_num: int, cap_den: int):
        """Join a sharded phased fill's blocks, each with its own phased
        layout and sentinel: (ids, alive bits, word-start bits, spilled)."""
        B_loc = B // len(fused)
        cap_loc = B_loc * _WORD_W * cap_num // cap_den
        ids_parts, alive_parts, ws_parts, spilled = [], [], [], False
        for blk in fused:
            ids, alive, wstart, total = self._unpack_fused_phased(blk, B_loc, cap_loc)
            alive_parts.append(alive)
            ws_parts.append(wstart)
            if total > cap_loc:  # a capacity spill or the phase's sentinel
                spilled = True
                total = cap_loc
            ids_parts.append(ids[:total])
        return (np.concatenate(ids_parts), np.concatenate(alive_parts),
                np.concatenate(ws_parts), spilled)

    @staticmethod
    def _ragged_gather(src, starts, counts):
        """Concatenate src[starts[i] : starts[i]+counts[i]] for all i."""
        out_offs = np.zeros(len(counts) + 1, np.int64)
        np.cumsum(counts, out=out_offs[1:])
        tot = int(out_offs[-1])
        idx = (
            np.arange(tot, dtype=np.int64)
            - np.repeat(out_offs[:-1], counts)
            + np.repeat(starts, counts)
        )
        return src[idx]

    def _encode_words_packed_locked(self, words_buf, lens):
        n = len(lens)
        stats = {"words": n, "packs": {}, "spills": 0, "seconds": {},
                 "blocks": self._sharding.n_devices if self._sharding is not None else 1,
                 "phase_n1": self._phase_n1}
        self.last_fill = stats
        secs = stats["seconds"]
        if n == 0:
            return np.zeros(0, np.int32), np.zeros(0, np.int64)
        t0 = time.perf_counter()
        lens = np.asarray(lens, np.int32)
        words_buf = np.asarray(words_buf, np.uint8)
        # sort by length: rows of equal-length words pack densely, and each
        # pack's fixpoint takes as many steps as its own deepest word needs;
        # the results are put back in input order at the end
        order = None
        if n > 64:
            order = np.argsort(lens, kind="stable").astype(np.int64)
            if np.array_equal(order, np.arange(n)):
                order = None
        if order is not None:
            offs0 = np.zeros(n + 1, np.int64)
            np.cumsum(lens, out=offs0[1:])
            work_lens = lens[order]
            work_buf = self._ragged_gather(words_buf, offs0[:-1][order], work_lens)
        else:
            work_buf, work_lens = words_buf, lens
        offs = np.zeros(n + 1, np.int64)
        np.cumsum(work_lens, out=offs[1:])
        secs["sort"] = time.perf_counter() - t0
        # dispatch every pack before harvesting any: pack k + 1's copies and
        # kernels queue behind pack k's while the host packs on
        t_pack = t_dispatch = 0.0
        pending = []
        w_done = 0
        max_rows = _ROW_BUCKETS[-1]
        ndev = self._sharding.n_devices if self._sharding is not None else 1
        while w_done < n:
            t0 = time.perf_counter()
            arr, marks, starts, n_fit, rows_used = self._pack_seg(
                work_buf, offs, w_done, n - w_done, max_rows
            )
            if n_fit == 0:
                break
            B = next(b for b in _ROW_BUCKETS if b >= rows_used)
            a = arr[:B]
            mk = marks[:B]
            # the marks go out as a 1-bit start map (little endian within
            # each byte) and each row's content length: rows are packed
            # densely from column 0
            bits = np.packbits(mk == 1, axis=1, bitorder="little")
            row_len = (mk > 0).sum(axis=1).astype(np.int32)
            sharded = self._sharding is not None and B % ndev == 0
            t1 = time.perf_counter()
            fused = (self._fn_sharded if sharded else self._fn)(a, bits, row_len)
            t_dispatch += time.perf_counter() - t1
            t_pack += t1 - t0
            stats["packs"][B] = stats["packs"].get(B, 0) + 1
            pending.append((fused, starts, w_done, n_fit, B, sharded, (a, bits, row_len)))
            w_done += n_fit
        secs["pack"] = t_pack
        secs["dispatch"] = t_dispatch
        # harvest in dispatch order
        t0 = time.perf_counter()
        t_spill = 0.0
        ids_parts: list[np.ndarray] = []
        counts_sorted = np.full(n, -1, np.int64)  # -1 = not covered
        for fused, starts, w0, n_fit, B, sharded, args in pending:
            # an unsharded pack is one block of all its rows
            blocks = fused if sharded else [fused]
            cnts = None
            if self._n1_for(B // len(blocks)):
                # word boundaries from the buffer's start bitmap: compaction
                # moved the words off the byte positions of `starts`
                out_ids, alive, wstart, spilled = self._unpack_fused_sharded_phased(
                    blocks, B, self._CAP_NUM, self._CAP_DEN)
                sf = np.flatnonzero(wstart)
                if not spilled and len(sf) != n_fit:  # not one start a word: trust none
                    spilled = True
                if not spilled:
                    cs = np.zeros(len(alive) + 1, np.int64)
                    np.cumsum(alive, out=cs[1:])
                    bounds = np.append(sf, len(alive))
                    cnts = cs[bounds[1:]] - cs[bounds[:-1]]
            else:
                out_ids, alive, spilled = self._unpack_fused_sharded(
                    blocks, B, self._CAP_NUM, self._CAP_DEN)
            if spilled:
                # more live ids than slots, or a phased row over half its
                # lanes: dispatch this pack once more, unphased, with a slot
                # for every lane, so every word stays covered
                t1 = time.perf_counter()
                stats["spills"] += 1
                again = self._fn_full_sharded(*args) if sharded else [self._fn_full(*args)]
                out_ids, alive, _spilled = self._unpack_fused_sharded(again, B, 1, 1)
                cnts = None
                t_spill += time.perf_counter() - t1
            if cnts is None:
                cs = np.zeros(len(alive) + 1, np.int64)
                np.cumsum(alive, out=cs[1:])
                ln = work_lens[w0 : w0 + n_fit].astype(np.int64)
                cnts = cs[starts + ln] - cs[starts]
            counts_sorted[w0 : w0 + n_fit] = cnts
            ids_parts.append(out_ids)
        ids_sorted = np.concatenate(ids_parts) if ids_parts else np.zeros(0, np.int32)
        secs["harvest"] = time.perf_counter() - t0 - t_spill
        secs["spill"] = t_spill
        t0 = time.perf_counter()
        try:
            if order is None:
                return ids_sorted.astype(np.int32), counts_sorted
            counts = np.full(n, -1, np.int64)
            counts[order] = counts_sorted
            s_cnt = np.where(counts_sorted < 0, 0, counts_sorted)
            s_off = np.zeros(n + 1, np.int64)
            np.cumsum(s_cnt, out=s_off[1:])
            spos = np.empty(n, np.int64)
            spos[order] = np.arange(n)
            ids_flat = self._ragged_gather(
                ids_sorted, s_off[:-1][spos], np.where(counts < 0, 0, counts)
            )
            return ids_flat.astype(np.int32), counts
        finally:
            secs["unsort"] = time.perf_counter() - t0

    # ------------------------------------------------------------------
    # synchronous fill (backend="device")

    def fill_caches(self, data: list[bytes], max_words: int | None = None) -> int:
        """Merge the distinct uncached words of the corpus on the device and
        insert them into the native shared caches.  Returns the number of
        words filled.  ``max_words`` caps the fill (the rest is merged by
        the native runtime when it meets them)."""
        t0 = time.perf_counter()
        words_buf, lens = self.native.collect_miss_words(data, _WORD_W)
        t_scan = time.perf_counter() - t0
        n = len(lens)
        if n == 0:
            self.last_fill = {"words": 0, "packs": {}, "spills": 0, "seconds": {"scan": t_scan}}
            return 0
        cap = max_words if max_words is not None else self.fill_cap
        if n > cap:
            n = cap
            lens = lens[:n]
            words_buf = words_buf[: int(np.sum(lens))]
        ids_flat, counts = self._encode_words_packed(words_buf, lens)
        t0 = time.perf_counter()
        filled = self._insert_covered(words_buf, lens, ids_flat, counts)
        self.last_fill["seconds"].update(scan=t_scan, insert=time.perf_counter() - t0)
        return filled

    def _insert_covered(self, words_buf, lens, ids_flat, counts) -> int:
        """Insert the device-covered words (counts >= 0) into the shared
        caches; the others are left to the native runtime.  Returns the
        number inserted."""
        lens = np.asarray(lens, np.int32)
        covered = counts >= 0
        n_cov = int(covered.sum())
        if n_cov == 0:
            return 0
        if n_cov == len(lens):
            self.native.cache_insert_flat(words_buf, lens, ids_flat, counts)
        else:
            offs = np.zeros(len(lens) + 1, np.int64)
            np.cumsum(lens, out=offs[1:])
            keep_lens = lens[covered]
            keep_buf = self._ragged_gather(
                np.asarray(words_buf, np.uint8), offs[:-1][covered], keep_lens
            )
            self.native.cache_insert_flat(keep_buf, keep_lens, ids_flat, counts[covered])
        self.words_filled += n_cov
        return n_cov

    def _maybe_fill(self, data: list[bytes]) -> int:
        """Scan and fill until the caches are warm, then only every
        ``sweep_interval`` batches; skipping never changes a result."""
        if self._steady and self._batches_since_sweep < self.sweep_interval:
            self._batches_since_sweep += 1
            return 0
        n = self.fill_caches(data, max_words=self.fill_cap)
        self._batches_since_sweep = 0
        self._steady = n < max(16, self.fill_cap // 4096)
        return n

    def encode_batch(self, data: list[bytes]) -> list[list[int]]:
        """Batch encode: the device merges the distinct new words, the
        native runtime assembles each text from the caches."""
        self._maybe_fill(data)
        return self.native.encode_batch(data)

    def encode_batch_ragged(self, data: list[bytes]):
        self._maybe_fill(data)
        return self.native.encode_batch_ragged(data)

    # ------------------------------------------------------------------
    # asynchronous fill (backend="auto")

    def _harvest(self, holder) -> int:
        """Consume a finished fill: raise its error in this thread, or insert
        its results into the shared caches.  The caller has detached
        ``holder`` from ``self._pending`` under ``_async_mu``.  Returns the
        number of words inserted."""
        if holder.error is not None:
            raise RuntimeError("the background device word fill failed") from holder.error
        if holder.words is None or len(holder.lens) == 0:
            return 0  # the scan found too few misses to fill
        if holder.result is None:
            raise RuntimeError("the background device word fill ended without a result")
        ids_flat, counts = holder.result
        return self._insert_covered(holder.words, holder.lens, ids_flat, counts)

    def maybe_fill_async(self, data_fn) -> None:
        """Called at the top of a batch encode on the serving thread:
        harvests a finished fill into the shared caches, else starts a
        background scan and fill when one is due.  ``data_fn`` makes the
        corpus byte strings on the background thread.  Safe under
        concurrent callers."""
        with self._async_mu:
            pending = self._pending
            if pending is not None:
                if not pending.done.is_set():
                    return
                self._pending = None
            elif self._steady and self._batches_since_sweep < self._sweep_cur:
                self._batches_since_sweep += 1
                return
        if pending is not None:
            self._harvest(pending)
            return
        holder = _FillResult()
        with self._async_mu:
            if self._pending is not None:
                return  # another caller started one meanwhile
            self._batches_since_sweep = 0
            self._pending = holder
        self._serving_idle.clear()

        def _run():
            try:
                # let the launching batch finish serving first (bounded)
                self._serving_idle.wait(0.5)
                try:
                    # below the serving threads (Linux: per-thread nice)
                    os.setpriority(os.PRIO_PROCESS, threading.get_native_id(), 10)
                except (OSError, AttributeError):
                    pass
                # n_threads=1: stay off the worker pool of the serving encode
                words_buf, lens = self.native.collect_miss_words(
                    data_fn(), _WORD_W, n_threads=1
                )
                n = len(lens)
                with self._async_mu:
                    self._steady = n < self.min_async_fill
                    if n < self.min_async_fill:
                        # an empty sweep backs off; a real fill resets
                        self._sweep_cur = min(self._sweep_cur * 2, self.max_sweep_interval)
                    else:
                        self._sweep_cur = self.sweep_interval
                if n < self.min_async_fill:
                    return  # the native runtime merges and caches the stragglers
                if n > self.fill_cap:
                    n = self.fill_cap
                    lens = lens[:n]
                    words_buf = words_buf[: int(np.sum(lens))]
                holder.words, holder.lens = words_buf, lens
                holder.result = self._encode_words_packed(words_buf, lens)
            except Exception as e:  # raised again by the harvest
                holder.error = e
            finally:
                holder.done.set()

        thread = threading.Thread(target=_run, name="ctok-devfill", daemon=True)
        _track_fill(thread)
        thread.start()

    def batch_done(self) -> None:
        """The batch that may have started a fill has been served: the
        background scan may start."""
        self._serving_idle.set()

    def drain_async(self, timeout: float | None = None) -> int:
        """Wait for a fill in flight and insert its results (tests,
        benchmarks).  Returns the number of words inserted; raises the
        fill's error."""
        with self._async_mu:
            pending = self._pending
        if pending is None:
            return 0
        if not pending.done.wait(timeout):
            return 0
        with self._async_mu:
            if self._pending is not pending:
                return 0  # another thread harvested it
            self._pending = None
        return self._harvest(pending)


def build_word_encoder(tokenizer, device=None) -> DeviceWordEncoder:
    """Word-path encoder of a Tokenizer on ``device``: the device pipeline's
    tables and the native runtime.  Raises ``NotImplementedError`` for a
    configuration the device path does not run."""
    pipeline = tokenizer.pipeline(device)
    native = tokenizer._get_native_encoder()
    if native is None:
        raise NotImplementedError("the word path needs the native runtime")
    return DeviceWordEncoder(pipeline, native)

#!/usr/bin/env python3
"""Where the time of the port's encode goes, on one NVIDIA GPU.

    python3 scripts/profile_torch_encode.py [--texts 10000] [--seed 17] [--vocab 50k|100k] [--decode]

Encodes the ``chip_smoke.py`` corpus at the 50K vocabulary (the merge
fixpoint K2) or, with ``--vocab 100k``, at the 100K one (K5), each run from
a fresh ``Tokenizer.from_file`` (warm start on), under ``torch.profiler``:

1. ``backend="device"``, first call (it fills the word caches) and a warm
   call.  The first call is run stage by stage as ``encode_batch`` runs it,
   with a host timer around each stage: normalize, prepare bytes, the
   added-token scan, the miss scan, the length sort, pack, dispatch (copies
   and launches), harvest (waiting for the fill and unpacking it), spill
   redispatches, unsort, the cache insert, the native encode of the texts
   and the oracle for texts that hold an added token.
2. ``backend="auto"``: the whole corpus as one batch, the background fill
   drained, then the corpus again.  The serving thread's stages (the fused
   native encode; the oracle for flagged rows) and the background fill's
   (miss scan, sort, pack, dispatch, harvest, insert) are timed apart.
3. The text pipeline (``Tokenizer.pipeline().encode_bytes``), warm.

For each: the wall time, the device's busy time (the union of kernel
intervals) and idle share, and the kernels that take the most device time.
Then the merge fixpoint alone on rows of one 4,096-byte word of one
repeated letter.  With ``--decode``, instead: the device decode
(``decode_pipeline("cuda").decode_ragged``, K7) of the corpus's ids in
ragged form, once to warm and once profiled, with its host stages.  Needs
a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _busy_us(events) -> float:
    """Union of the device kernel intervals, in microseconds."""
    spans = sorted(
        (e.time_range.start, e.time_range.end)
        for e in events
        if e.device_type.name == "CUDA"
    )
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


class Stages:
    """Host seconds by stage, in the order first seen."""

    def __init__(self):
        self.s: dict[str, float] = {}

    def add(self, name: str, seconds: float) -> None:
        self.s[name] = self.s.get(name, 0.0) + seconds

    def run(self, name: str, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        self.add(name, time.perf_counter() - t0)
        return out

    def line(self) -> str:
        total = sum(self.s.values())
        parts = ", ".join(f"{k} {v * 1e3:.2f}" for k, v in self.s.items())
        return f"{parts} (sum {total * 1e3:.2f} ms)"


def _profiled(label: str, fn, n_bytes: int, table_rows: int = 0):
    """Run ``fn`` once under torch.profiler; print wall, busy, idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = _busy_us(prof.events()) / 1e6
    print(
        f"{label}: wall {wall:.4f} s ({n_bytes / wall / 1e6:.3f} MB/s) with the profiler on; "
        f"device busy {busy * 1e3:.3f} ms, idle share {1 - busy / wall:.4f}",
        flush=True,
    )
    if table_rows:
        print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=table_rows))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--texts", type=int, default=10_000)
    ap.add_argument("--seed", type=int, default=17)
    ap.add_argument("--vocab", choices=("50k", "100k"), default="50k")
    ap.add_argument("--decode", action="store_true", help="profile the device decode only")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("profile_torch_encode: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from chip_smoke import TOKENIZER_100K, TOKENIZER_JSON, _time_ms, main_corpus
    from complexity_tokenizer_tpu_torch.ops.pipeline import pack_texts
    from complexity_tokenizer_tpu_torch.ops.presplit import presplit
    from complexity_tokenizer_tpu_torch.ops.seed import seed_tokens
    from complexity_tokenizer_tpu_torch.tokenizer import Tokenizer

    path = TOKENIZER_100K if args.vocab == "100k" else TOKENIZER_JSON
    print(f"device: {torch.cuda.get_device_name(0)}; tokenizer {os.path.basename(path)}")
    texts = main_corpus(args.texts, args.seed)
    n_bytes = sum(len(t.encode("utf-8")) for t in texts)
    print(f"texts {len(texts)} bytes {n_bytes}")
    if args.decode:
        return profile_decode(path, texts)
    host = Tokenizer.from_file(path).encode_batch(texts, backend="host")

    # 1. backend="device", stage by stage, as encode_batch runs it
    tok = Tokenizer.from_file(path)
    wp = tok._get_word_path("cuda")  # tables on the card; kernels built
    torch.cuda.synchronize()
    st = Stages()

    def device_first_call():
        normalized = st.run("normalize", lambda: [tok._normalize(t) for t in texts])
        data = st.run("prepare bytes", tok._prepare_bytes, normalized)
        flags = st.run("added-token scan", tok._added_route_flags, data)
        fast = [i for i in range(len(texts)) if flags is None or not flags[i]]
        fast_data = [data[i] for i in fast]
        t0 = time.perf_counter()
        filled = wp.fill_caches(fast_data)
        fill_s = time.perf_counter() - t0
        for name, s in wp.last_fill["seconds"].items():
            st.add(name, s)
        st.add("fill, rest", fill_s - sum(wp.last_fill["seconds"].values()))
        ids = st.run("native encode", wp.native.encode_batch, fast_data)
        out = [None] * len(texts)
        for i, r in zip(fast, ids):
            out[i] = r
        out = st.run("oracle (added tokens)", lambda: [
            r if r is not None else tok._encode_host(n, already_normalized=True)
            for r, n in zip(out, normalized)
        ])
        return out, filled

    out, filled = _profiled("backend=device, first call (fills)", device_first_call, n_bytes, 12)
    fill = wp.last_fill
    print(f"  host ms by stage: {st.line()}")
    print(f"  words filled {filled}; packs {dict(sorted(fill['packs'].items()))}, spills {fill['spills']}")
    assert out == host, "backend=device differs from the host oracle"
    warm = _profiled(
        "backend=device, warm call", lambda: tok.encode_batch(texts, backend="device"), n_bytes
    )
    assert warm == host

    # 2. backend="auto"
    tok = Tokenizer.from_file(path)
    wp = tok._auto_word_path("cuda")
    torch.cuda.synchronize()
    st = Stages()
    native = tok._get_native_encoder()
    pats = tok._added_patterns

    def auto_first_batch():
        wp.maybe_fill_async(lambda: tok._prepare_bytes([tok._normalize(t) for t in texts]))
        rows = st.run("native encode (fused)", native.encode_rows_fused, texts,
                      tok.pre_tokenizer.add_prefix_space, pats, None, True)
        wp.batch_done()
        out = st.run("oracle (flagged rows)", lambda: [
            r if r is not None else tok._encode_row_exact(t, True) for r, t in zip(rows, texts)
        ])
        t0 = time.perf_counter()
        n = wp.drain_async(timeout=600)
        st.add("wait for the background fill", time.perf_counter() - t0)
        return out, n

    (out, drained) = _profiled("backend=auto, first batch and its fill", auto_first_batch, n_bytes, 12)
    print(f"  serving-thread ms: {st.line()}")
    bg = Stages()
    for name, s in wp.last_fill["seconds"].items():
        bg.add(name, s)
    print(f"  background fill ms: {bg.line()}; {drained} words inserted")
    assert out == host, "backend=auto differs from the host oracle"
    warm = _profiled("backend=auto, corpus again", lambda: tok.encode_batch(texts), n_bytes)
    assert warm == host

    # 3. the text pipeline, warm
    pipe = tok.pipeline("cuda")
    data = tok._prepare_bytes([tok._normalize(t) for t in texts])
    flags = tok._added_route_flags(data)
    fast_data = [d for d, f in zip(data, flags) if not f]
    pipe.encode_bytes(fast_data)
    _profiled("text pipeline, warm (texts without added tokens)",
              lambda: pipe.encode_bytes(fast_data), sum(map(len, fast_data)), 8)

    tb = pipe.tables
    for B in (1, 16):
        arr, lens = pack_texts([b"a" * 4096] * B, 4096, B)
        arr, lens = torch.from_numpy(arr).cuda(), torch.from_numpy(lens).cuda()
        _, wid, _ = presplit(arr, lens, tb.class_table)
        tokens = seed_tokens(arr, lens, tb.byte_token_table)
        ms = _time_ms(lambda: tb.merge_fixpoint(tokens, wid), 3)
        fixpoint = "K2" if tb.qc_t1 is not None else "K5"
        print(f"{fixpoint} one 4096-byte word per row, [{B},4096]: {ms:.3f} ms")
    return 0


def profile_decode(path: str, texts: list[str]) -> int:
    """The device decode of the corpus's ids (ragged, every seventh row
    framed by specials, as ``chip_smoke.py`` makes them) under the
    profiler: wall, device busy and idle share, host ms by stage."""
    import numpy as np

    from chip_smoke import _with_specials
    from complexity_tokenizer_tpu_torch.tokenizer import Tokenizer

    tok = Tokenizer.from_file(path)
    rows = _with_specials(tok, tok.encode_batch(texts, backend="native"))
    offs = np.zeros(len(rows) + 1, np.int64)
    np.cumsum([len(r) for r in rows], out=offs[1:])
    flat = np.concatenate([np.asarray(r, np.int32) for r in rows])
    pipe = tok.decode_pipeline("cuda")
    exp = [tok._decode_impl(r, False, False) for r in rows]
    if pipe.decode_ragged(flat, offs) != exp:  # warm: the kernels built, the buffers grown
        raise AssertionError("the device decode differs from the host decode")
    st = Stages()

    def ragged():
        raw = st.run("copies, K7, reads back, rows split", pipe.decode_ragged_bytes, flat, offs)
        return st.run("UTF-8 decode", lambda: [b.decode("utf-8", "replace") for b in raw])

    got = _profiled(f"device decode, ragged ({len(rows)} rows, {len(flat)} ids)", ragged,
                    len(flat) * 4, 8)
    print(f"  host ms by stage: {st.line()}")
    if got != exp:
        raise AssertionError("the device decode differs from the host decode")
    return 0


if __name__ == "__main__":
    sys.exit(main())

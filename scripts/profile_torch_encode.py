#!/usr/bin/env python3
"""Where the time of the port's device encode goes, on one NVIDIA GPU.

    python3 scripts/profile_torch_encode.py [--texts 10000] [--seed 17]

Encodes the ``chip_smoke.py`` corpus at the 50K vocabulary with
``Tokenizer.encode_batch(backend="device")`` once to warm up, then once
under ``torch.profiler``, and prints the wall time, the device's busy time
(the union of kernel intervals) and idle share, and the kernels that take
the most device time.  Then it times K2 alone (``chip_smoke._time_ms``,
CUDA-graph replay) on rows that each hold one 4,096-byte word of a single
repeated letter: the case that took a one-thread-per-word kernel with the
JAX apply rule (one merge per equal-pair run and step) about two seconds.
Needs a CUDA card; imports nothing of JAX.
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--texts", type=int, default=10_000)
    ap.add_argument("--seed", type=int, default=17)
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_encode: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from chip_smoke import TOKENIZER_JSON, main_corpus
    from complexity_tokenizer_tpu_torch.tokenizer import Tokenizer

    print(f"device: {torch.cuda.get_device_name(0)}")
    tok = Tokenizer.from_file(TOKENIZER_JSON)
    texts = main_corpus(args.texts, args.seed)
    n_bytes = sum(len(t.encode("utf-8")) for t in texts)
    tok.encode_batch(texts)  # warm-up: tables, kernel build, allocator
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tok.encode_batch(texts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    busy = _busy_us(events) / 1e6
    print(
        f"texts {len(texts)} bytes {n_bytes} wall {wall:.4f} s "
        f"({n_bytes / wall / 1e6:.3f} MB/s) device busy {busy:.6f} s "
        f"idle share {1 - busy / wall:.4f}"
    )
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=20)
    print(table)

    from chip_smoke import _time_ms
    from complexity_tokenizer_tpu_torch.ops.merge import merge_words_qc
    from complexity_tokenizer_tpu_torch.ops.pipeline import pack_texts
    from complexity_tokenizer_tpu_torch.ops.presplit import presplit
    from complexity_tokenizer_tpu_torch.ops.seed import seed_tokens

    tb = tok.pipeline("cuda").tables
    for B in (1, 16):
        arr, lens = pack_texts([b"a" * 4096] * B, 4096, B)
        arr, lens = torch.from_numpy(arr).cuda(), torch.from_numpy(lens).cuda()
        _, wid, _ = presplit(arr, lens, tb.class_table)
        tokens = seed_tokens(arr, lens, tb.byte_token_table)
        ms = _time_ms(
            lambda: merge_words_qc(tokens, wid, tb.qc_t1, tb.qc_t2, tb.qc_size), 3
        )
        print(f"K2 one 4096-byte word per row, [{B},4096]: {ms:.3f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())

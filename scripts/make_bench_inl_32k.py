#!/usr/bin/env python3
"""Train the INL-mode byte-level BPE at the reference's 32,000 entries.

    python3 scripts/make_bench_inl_32k.py

Writes ``.cache/bench_inl_32k.json``: the JAX package's INL-BPE trainer with
the reference example's settings (``TrainerConfig(vocab_size=32_000,
min_frequency=2)``: NFC, ByteLevel, alpha 0.9, beta 0.3, gate 0.5, mu 0.01),
trained on ``bench.py:_zipf_corpus(8000, seed=29, lo=100, hi=800)``, the
corpus of the 50K bench tokenizer.  It is the golden file of the port's INL
trainer: INL mode's selection does not depend on the target size, so its
merges' first n are the merges of any smaller target.  The trainer's
warm-cache sidecar is removed; only the JSON is kept.  Prints the merge
count, the id count, the file's sha256 and the trainer's seconds.  Tooling,
not part of the port: it imports the JAX package's trainer; the port and
``chip_smoke.py`` read only the JSON.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, ".cache", "bench_inl_32k.json")
VOCAB_SIZE = 32_000


def main() -> int:
    sys.path.insert(0, REPO)
    from bench import _zipf_corpus
    from complexity_tokenizer_tpu.trainers.inl_trainer import InlBpeTrainer, TrainerConfig

    texts = _zipf_corpus(8000, seed=29, lo=100, hi=800)
    t0 = time.perf_counter()
    trainer = InlBpeTrainer(TrainerConfig(vocab_size=VOCAB_SIZE, min_frequency=2))
    trainer.train_from_texts(texts)
    seconds = time.perf_counter() - t0
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    trainer.save(OUT)
    sidecar = os.path.splitext(OUT)[0] + ".warmcache.npz"
    if os.path.exists(sidecar):
        os.remove(sidecar)
    with open(OUT, "rb") as f:
        raw = f.read()
    model = json.loads(raw)["model"]
    print(json.dumps({
        "path": os.path.relpath(OUT, REPO),
        "ids": len(model["vocab"]),
        "merges": len(model["merges"]),
        "bytes": len(raw),
        "sha256": hashlib.sha256(raw).hexdigest(),
        "seconds": round(seconds, 1),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

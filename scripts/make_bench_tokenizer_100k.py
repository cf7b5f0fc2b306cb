#!/usr/bin/env python3
"""Train the 100,000-entry byte-level BPE that the port runs past u16.

    python3 scripts/make_bench_tokenizer_100k.py

Writes ``.cache/bench_tokenizer_100k.json``: the JAX package's INL-BPE
trainer at ``vocab_size=100_000`` (the scale of OpenAI's cl100k_base) with
the settings of ``bench.py:build_tokenizer`` (``min_frequency=1``,
alpha = beta = gate = 0), trained on ``bench.py:_zipf_corpus(8000, seed=29,
lo=100, hi=800)``.  Its largest ids and ranks are past 65,535, so the
u16 cuckoo table does not fit it and every device path runs the CHD
fixpoint.  Same special tokens, ByteLevel pre-tokenizer and decoder as the
50K bench tokenizer.  Prints the id count, merge count, largest rank and
the file's sha256.  Tooling, not part of the port: it imports the JAX
package's trainer; the port and ``chip_smoke.py`` read only the JSON.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, ".cache", "bench_tokenizer_100k.json")
VOCAB_SIZE = 100_000


def main() -> int:
    sys.path.insert(0, REPO)
    from bench import _zipf_corpus
    from complexity_tokenizer_tpu.trainers.inl_trainer import InlBpeTrainer, TrainerConfig

    t0 = time.perf_counter()
    trainer = InlBpeTrainer(
        TrainerConfig(
            vocab_size=VOCAB_SIZE, min_frequency=1, inl_alpha=0.0, inl_beta=0.0, inl_gate=0.0
        )
    )
    trainer.train_from_texts(_zipf_corpus(8000, seed=29, lo=100, hi=800))
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    trainer.save(OUT)
    # the trainer also exports a warm-cache sidecar; only the JSON is kept
    sidecar = os.path.splitext(OUT)[0] + ".warmcache.npz"
    if os.path.exists(sidecar):
        os.remove(sidecar)
    with open(OUT, "rb") as f:
        raw = f.read()
    model = json.loads(raw)["model"]
    ids = max(model["vocab"].values())
    print(json.dumps({
        "path": os.path.relpath(OUT, REPO),
        "ids": len(model["vocab"]),
        "largest_id": ids,
        "merges": len(model["merges"]),
        "largest_rank": len(model["merges"]) - 1,
        "bytes": len(raw),
        "sha256": hashlib.sha256(raw).hexdigest(),
        "seconds": round(time.perf_counter() - t0, 1),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

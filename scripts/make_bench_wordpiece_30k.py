#!/usr/bin/env python3
"""Train the WordPiece vocabulary at bert-base-uncased's 30,522 entries.

    python3 scripts/make_bench_wordpiece_30k.py

Writes ``.cache/bench_wordpiece_30k.json``: the vocabulary, a list of
entries in id order, of the JAX package's host ``WordPieceTrainer`` with
its defaults (``min_frequency`` 2, ``[PAD] [UNK] [CLS] [SEP] [MASK]``,
``##``, NFC + Lowercase, ``Whitespace``) at ``vocab_size=30_522``, trained
on ``bench.py:_zipf_corpus(10_000, seed=17)`` and its multilingual pieces.
It is the golden file of the port's ``DistributedWordPieceTrainer``: the
loop is the same for any target until it stops, so a smaller target's
vocabulary is this list's prefix.  If the trainer stops early (its pick is
already in the vocabulary, or no pair is left), the file holds the size it
reached.  Prints the entry count, the file's size and sha256 and the
trainer's seconds (about an hour on one CPU core).  Tooling, not part of
the port: it imports the JAX package's trainer; the port and
``chip_smoke.py`` read only the JSON.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, ".cache", "bench_wordpiece_30k.json")
VOCAB_SIZE = 30_522


def main() -> int:
    sys.path.insert(0, REPO)
    from bench import _MULTI_PIECES, _zipf_corpus
    from complexity_tokenizer_tpu.trainers.wordpiece_trainer import (
        WordPieceTrainer,
        WordPieceTrainerConfig,
    )

    texts = _zipf_corpus(10_000, seed=17) + list(_MULTI_PIECES)
    t0 = time.perf_counter()
    model = WordPieceTrainer(WordPieceTrainerConfig(vocab_size=VOCAB_SIZE)).train_from_texts(texts)
    seconds = time.perf_counter() - t0
    entries = sorted(model.vocab, key=model.vocab.__getitem__)
    assert [model.vocab[e] for e in entries] == list(range(len(entries)))
    raw = json.dumps(entries, ensure_ascii=False).encode("utf-8")
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "wb") as f:
        f.write(raw)
    print(json.dumps({
        "path": os.path.relpath(OUT, REPO),
        "texts": len(texts),
        "entries": len(entries),
        "target": VOCAB_SIZE,
        "bytes": len(raw),
        "sha256": hashlib.sha256(raw).hexdigest(),
        "seconds": round(seconds, 1),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

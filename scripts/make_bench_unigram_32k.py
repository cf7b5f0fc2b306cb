#!/usr/bin/env python3
"""Train the 32,000-piece Unigram table that the port's Unigram model runs at.

    python3 scripts/make_bench_unigram_32k.py

Writes ``.cache/bench_unigram_32k.json``: a list of ``[piece, score]`` in id
order, the JAX package's ``UnigramTrainer`` with its defaults (NFC,
``Metaspace("▁")``, ``max_piece_length=16``, SentencePiece's settings as in
t5-base's tokenizer) at ``vocab_size=31_997``, trained on every
whitespace-separated word of ``bench.py:_zipf_corpus(10_000, seed=17)`` and
its multilingual pieces, in order, each passed as its own text (so its
``Metaspace`` gives ``▁word``, the piece a T5 pipeline's ``Metaspace`` gives the
model).  The three special tokens are pruned and appended again, so the
table holds exactly 32,000 pieces, t5-base's count.  Prints the piece count,
the longest piece, the count of distinct scores, the file's size and sha256
and the trainer's seconds.  Tooling, not part of the port: it imports the
JAX package's trainer; the port and ``chip_smoke.py`` read only the JSON
(``complexity_tokenizer_tpu_torch/utils/corpus.py:unigram_32k_vocab``).
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, ".cache", "bench_unigram_32k.json")
VOCAB_SIZE = 31_997  # + the three specials appended after the last prune


def main() -> int:
    sys.path.insert(0, REPO)
    from bench import _MULTI_PIECES, _zipf_corpus
    from complexity_tokenizer_tpu.trainers.unigram_trainer import (
        UnigramTrainer,
        UnigramTrainerConfig,
    )

    words = [w for t in _zipf_corpus(10_000, seed=17) + list(_MULTI_PIECES) for w in t.split()]
    t0 = time.perf_counter()
    model = UnigramTrainer(UnigramTrainerConfig(vocab_size=VOCAB_SIZE)).train_from_texts(words)
    seconds = time.perf_counter() - t0
    pieces = [[model.vocab_r[i], model.vocab[model.vocab_r[i]][1]] for i in range(len(model.vocab_r))]
    raw = json.dumps(pieces, ensure_ascii=False).encode("utf-8")
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "wb") as f:
        f.write(raw)
    print(json.dumps({
        "path": os.path.relpath(OUT, REPO),
        "words": len(words),
        "pieces": len(pieces),
        "longest_piece": max(len(p) for p, _ in pieces),
        "distinct_scores": len({s for _, s in pieces}),
        "bytes": len(raw),
        "sha256": hashlib.sha256(raw).hexdigest(),
        "seconds": round(seconds, 1),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

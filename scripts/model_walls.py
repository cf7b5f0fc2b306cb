#!/usr/bin/env python3
"""Walls of the word-level models' ``encode_batch`` on one NVIDIA card.

    python3 scripts/model_walls.py [--root DIR] [--runs 3] [--seed 17] [--texts 10000] [--only LABEL]

Imports ``complexity_tokenizer_tpu_torch`` from ``--root`` (default: this
repository), so that one script times two checkouts of the package (unpack
the other with ``git archive <commit> | tar -x -C DIR``) in turns, one
process each.  The models are ``chip_smoke.py``'s, at full width:
ByteLevel BPE on the 50K and 100K tables, CharBPE on its test table,
WordPiece at 30,522 entries, WordLevel at 40,001 and Unigram at 32,000
pieces (on the corpus's ``▁word`` pieces, one call), and the text pipeline
``EncodePipeline.encode_batch`` at 50K with its NFC normalizer (K8, then
K1 and K2); the texts its corpus (``chip_smoke.main_corpus``).  Each
one's first ``encode_batch`` builds its tier (or tables and bitmap) and is
left out; then ``--runs`` calls, each ending in
``torch.cuda.synchronize()``.  ``--only LABEL`` (repeatable) times those
labels alone.  Prints the card's ``nvidia-smi`` name and
power limit and one JSON line ``{"root": ..., "walls_s": {label: [s,
...]}}``.  Needs a card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _unigram():
    # imported here: a checkout from before the Unigram model has none
    from complexity_tokenizer_tpu_torch.models import UnigramModel
    from complexity_tokenizer_tpu_torch.utils.corpus import unigram_32k_vocab

    return UnigramModel(unigram_32k_vocab())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=REPO, help="the checkout whose package is timed")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--seed", type=int, default=17)
    ap.add_argument("--texts", type=int, default=10_000)
    ap.add_argument("--only", action="append", default=None, help="a label to time (repeatable)")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("model_walls: no CUDA device is available", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from complexity_tokenizer_tpu_torch.models import WordLevelModel, WordPieceModel
    from complexity_tokenizer_tpu_torch.tokenizer import Tokenizer
    from complexity_tokenizer_tpu_torch.utils.corpus import (
        bert_scale_wordpiece_vocab,
        wordlevel_vocab,
    )

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())
    texts = smoke.main_corpus(args.texts, args.seed)
    makers = {"ByteLevel BPE 50K": lambda: smoke._bytelevel_model(smoke.TOKENIZER_JSON),
              "ByteLevel BPE 100K": lambda: smoke._bytelevel_model(smoke.TOKENIZER_100K),
              "CharBPE (test table)": smoke._charbpe_model,
              "WordPiece 30,522": lambda: WordPieceModel(bert_scale_wordpiece_vocab()),
              "WordLevel 40,001": lambda: WordLevelModel(wordlevel_vocab()),
              "EncodePipeline.encode_batch (NFC, 50K)":
                  lambda: Tokenizer.from_file(smoke.TOKENIZER_JSON).pipeline("cuda"),
              "Unigram 32,000": _unigram}
    walls: dict = {}
    for label, make in makers.items():
        if args.only and label not in args.only:
            continue
        model = make()
        if label == "Unigram 32,000":
            from complexity_tokenizer_tpu_torch.utils.corpus import metaspace_pieces

            inputs = metaspace_pieces(texts)
        else:
            inputs = texts
        first = model.encode_batch(inputs)
        torch.cuda.synchronize()
        if getattr(model, "last_route", "device") != "device":
            raise AssertionError(f"[{label}] encode_batch took the {model.last_route} route")
        walls[label] = []
        for _ in range(args.runs):
            t0 = time.perf_counter()
            got = model.encode_batch(inputs)
            torch.cuda.synchronize()
            walls[label].append(time.perf_counter() - t0)
            if got != first:
                raise AssertionError(f"[{label}] two calls differ")
    print(json.dumps({"root": args.root, "walls_s": walls}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

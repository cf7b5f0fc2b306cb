"""A member of a ``torch.distributed`` group (gloo, on the CPU) that trains
the port's device trainers on its share of the rows: for
``tests/test_torch_trainers.py``, ``DistributedInlTrainer`` in classic and
INL mode, each on the device-resident route and on the per-merge route;
for ``tests/test_torch_wordpiece_trainer.py`` and
``tests/test_torch_unigram_trainer.py``, ``DistributedWordPieceTrainer``
and ``DistributedUnigramTrainer`` (``run_world_member``'s ``which``).
Writes what it learned to ``<out_dir>/rank<rank>.json``.  Imports torch and
the port only."""

import contextlib
import io
import json
import os

TEXTS = ["the quick brown fox jumps over the lazy dog", "hello world hello",
         "pack my box with five dozen liquor jugs", "aaa aaaa aaaaa repeated runs a a aa",
         "worldly words matter"] * 6
CONFIGS = [dict(vocab_size=300, min_frequency=1, inl_gate=0.0),
           dict(vocab_size=300, min_frequency=1)]


def train_all(device: str = "cpu") -> list:
    from complexity_tokenizer_tpu_torch.parallel.trainer import DistributedInlTrainer
    from complexity_tokenizer_tpu_torch.trainers.inl_trainer import TrainerConfig

    out = []
    for cfg in CONFIGS:
        for max_v in ("4096", "1"):
            os.environ["CTOK_TRAINER_DEVICE_SELECT_MAX_V"] = max_v
            try:
                t = DistributedInlTrainer(TrainerConfig(**cfg), device=device)
                with contextlib.redirect_stdout(io.StringIO()), \
                        contextlib.redirect_stderr(io.StringIO()):
                    t.train_from_texts(TEXTS)
            finally:
                del os.environ["CTOK_TRAINER_DEVICE_SELECT_MAX_V"]
            out.append({
                "merges": [list(m) for m in t.merges],
                "vocab": t.vocab,
                "pair_freqs": sorted([a, b, f] for (a, b), f in t.pair_freqs.items()),
                "token_freqs": sorted([k, v] for k, v in t.token_freqs.items()),
            })
    return out


WP_TEXTS = TEXTS + ["x" * 130 + " " + "ab" * 70, "café über naïve ##literal"] * 2
UG_TEXTS = [w for t in TEXTS + ["unigram training corpus with 日本語 and café text",
                                "y" * 140] for w in t.split()]


def forge_rows(r: int, inputs: dict) -> None:
    """At round 20, corrupt the card's copy of every form of two characters
    or more (its first character): K18 then poisons each word that chooses
    one, and the host must count it, so the vocabulary does not change."""
    if r == 20:
        long_forms = inputs["slot_meta"][:, 0] >= 2
        inputs["slot_chars"][long_forms, 0] += 1


def train_wordpiece(device: str = "cpu") -> list:
    """The port's DistributedWordPieceTrainer at two targets, then the first
    again with forged rows on the card (:func:`forge_rows`)."""
    from complexity_tokenizer_tpu_torch.parallel.wordpiece_trainer import (
        DistributedWordPieceTrainer,
    )
    from complexity_tokenizer_tpu_torch.trainers.wordpiece_trainer import WordPieceTrainerConfig

    out = []
    for vs, mf, forge in ((120, 1, False), (80, 2, False), (120, 1, True)):
        t = DistributedWordPieceTrainer(WordPieceTrainerConfig(vocab_size=vs, min_frequency=mf),
                                        device=device)
        if forge:
            t.capture = forge_rows
        t.train_from_texts(WP_TEXTS)
        out.append({"vocab": t.vocab, "route": t.last_stats["route"],
                    "poisoned": t.last_stats["poisoned"], "over_wide": t.last_stats["over_wide"]})
    return out


def train_unigram(device: str = "cpu") -> list:
    """The port's DistributedUnigramTrainer on two configurations."""
    from complexity_tokenizer_tpu_torch.parallel.unigram_trainer import DistributedUnigramTrainer
    from complexity_tokenizer_tpu_torch.trainers.unigram_trainer import UnigramTrainerConfig

    out = []
    for cfg in (dict(vocab_size=60, n_iterations=4, max_piece_length=6, initial_vocab_size=400),
                dict(vocab_size=40, n_iterations=3, initial_vocab_size=300)):
        t = DistributedUnigramTrainer(UnigramTrainerConfig(**cfg), device=device)
        t.train_from_texts(UG_TEXTS)
        out.append({"vocab": [list(p) for p in t.vocab],
                    "routes": [r["route"] for r in t.rounds]})
    return out


RUNS = {"inl": train_all, "wordpiece": train_wordpiece, "unigram": train_unigram}


def run_world_member(rank: int, store: str, world: int, out_dir: str, which: str = "inl") -> None:
    import torch
    import torch.distributed as dist

    from complexity_tokenizer_tpu_torch.parallel.mesh import initialize_distributed, rank_and_world

    torch.set_num_threads(1)  # small tensors; the test workers share the machine
    initialize_distributed("gloo", "file://" + store, world, rank)
    try:
        assert rank_and_world() == (rank, world)
        res = RUNS[which]()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)

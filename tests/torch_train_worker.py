"""A member of a ``torch.distributed`` group (gloo, on the CPU) that trains
the port's ``DistributedInlTrainer`` on its share of the rows, for
``tests/test_torch_trainers.py``: classic and INL mode, each on the
device-resident route and on the per-merge route.  Writes what it learned
to ``<out_dir>/rank<rank>.json``.  Imports torch and the port only."""

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


def run_world_member(rank: int, store: str, world: int, out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    from complexity_tokenizer_tpu_torch.parallel.mesh import initialize_distributed, rank_and_world

    torch.set_num_threads(1)  # small tensors; the test workers share the machine
    initialize_distributed("gloo", "file://" + store, world, rank)
    try:
        assert rank_and_world() == (rank, world)
        res = train_all()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)

"""The sharded encode (``shard_encode_pipeline``, ``shard_word_encoder``:
a batch's rows split over a mesh of devices in one process, with no
collective) and its mesh helpers; training across processes:
``DistributedInlTrainer`` (pair counts and merge steps on the card, kernels
K13-K16), ``DistributedWordPieceTrainer`` (each round's greedy match and
pair count, K18 and K19), ``DistributedUnigramTrainer`` (the E-step, K12
and K17) and their process-group helpers."""

from . import mesh
from .encode import shard_encode_pipeline, shard_word_encoder
from .mesh import (
    BatchSharding,
    batch_sharding,
    data_mesh,
    initialize_distributed,
    rank_and_world,
    reduce_sum,
)

__all__ = [
    "mesh",
    "shard_encode_pipeline",
    "shard_word_encoder",
    "BatchSharding",
    "batch_sharding",
    "data_mesh",
    "initialize_distributed",
    "rank_and_world",
    "reduce_sum",
]


def __getattr__(name):
    if name == "DistributedInlTrainer":
        from .trainer import DistributedInlTrainer

        return DistributedInlTrainer
    if name == "DistributedWordPieceTrainer":
        from .wordpiece_trainer import DistributedWordPieceTrainer

        return DistributedWordPieceTrainer
    if name == "DistributedUnigramTrainer":
        from .unigram_trainer import DistributedUnigramTrainer

        return DistributedUnigramTrainer
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

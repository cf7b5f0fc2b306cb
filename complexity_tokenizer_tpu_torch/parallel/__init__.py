"""Training across processes: ``DistributedInlTrainer`` (pair counts and
merge steps on the card, kernels K13-K16) and its process-group helpers."""

from . import mesh
from .mesh import initialize_distributed, rank_and_world, reduce_sum

__all__ = ["mesh", "initialize_distributed", "rank_and_world", "reduce_sum"]


def __getattr__(name):
    if name == "DistributedInlTrainer":
        from .trainer import DistributedInlTrainer

        return DistributedInlTrainer
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

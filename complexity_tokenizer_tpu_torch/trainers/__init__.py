"""The trainers, on the host; ``parallel.DistributedInlTrainer`` runs the
INL-BPE trainer's pair counts and merge steps on the card.

The WordPiece and Unigram trainers are not ported yet: their names raise
``AttributeError`` here and in the package.
"""

from .bpe_trainer import BpeTrainer, BpeTrainerBuilder, BpeTrainerConfig
from .inl_trainer import InlBpeTrainer, TrainerConfig

# `Trainer` is the INL-BPE trainer in the reference's Python API
# (src/bindings/trainers.rs:11-92)
Trainer = InlBpeTrainer

__all__ = [
    "Trainer",
    "InlBpeTrainer",
    "TrainerConfig",
    "BpeTrainer",
    "BpeTrainerBuilder",
    "BpeTrainerConfig",
]

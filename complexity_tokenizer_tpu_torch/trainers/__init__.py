"""The trainers, on the host; ``parallel.DistributedInlTrainer`` runs the
INL-BPE trainer's pair counts and merge steps on the card,
``parallel.DistributedWordPieceTrainer`` and
``parallel.DistributedUnigramTrainer`` the WordPiece trainer's rounds and
the Unigram trainer's E-step.
"""

from .bpe_trainer import BpeTrainer, BpeTrainerBuilder, BpeTrainerConfig
from .inl_trainer import InlBpeTrainer, TrainerConfig
from .unigram_trainer import UnigramTrainer, UnigramTrainerConfig
from .wordpiece_trainer import WordPieceTrainer, WordPieceTrainerConfig

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
    "WordPieceTrainer",
    "WordPieceTrainerConfig",
    "UnigramTrainer",
    "UnigramTrainerConfig",
]

"""complexity_tokenizer_tpu_torch — the PyTorch + CUDA port of the tokenizer.

The device encode pipeline (pre-split -> byte->token seed -> segmented
merge fixpoint) runs as PyTorch on an NVIDIA GPU, with the seed and the
merge fixpoint as hand-written CUDA kernels (``csrc/kernels.cu``).  Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``; on the
CPU every kernel wrapper runs its plain PyTorch version.

The standalone models (``models/``: ByteLevel BPE, CharBPE, WordPiece,
WordLevel) run their distinct words through kernels K9-K11, and the Unigram
model (SentencePiece's Viterbi) its distinct texts through K12.

The trainers (``Trainer``, the INL-BPE trainer, ``BpeTrainer``,
``WordPieceTrainer`` and ``UnigramTrainer``) run on the host;
``parallel.DistributedInlTrainer`` counts pairs and applies merges on the
card (K13-K16), ``parallel.DistributedWordPieceTrainer`` re-tokenizes and
counts pairs there (K18, K19) and ``parallel.DistributedUnigramTrainer``
runs its E-step there (K12, K17).

The package imports ``torch`` and ``numpy`` only: it keeps its own copy of
every host layer it needs (loading, normalizers, the GPT-2 split and the
BPE oracle).
"""

from .version import __version__

__all__ = ["Tokenizer", "ByteLevelBpeModel", "CharBpeModel", "UnigramModel", "WordLevelModel",
           "WordPieceModel", "Trainer", "BpeTrainer", "WordPieceTrainer", "WordPieceTrainerConfig",
           "UnigramTrainer", "UnigramTrainerConfig", "__version__"]


def __getattr__(name):
    # lazy: `import complexity_tokenizer_tpu_torch` stays light
    if name == "Tokenizer":
        from .tokenizer import Tokenizer

        return Tokenizer
    if name in ("ByteLevelBpeModel", "CharBpeModel", "UnigramModel", "WordLevelModel",
                "WordPieceModel"):
        from . import models

        return getattr(models, name)
    if name in ("Trainer", "BpeTrainer", "WordPieceTrainer", "WordPieceTrainerConfig",
                "UnigramTrainer", "UnigramTrainerConfig"):
        from . import trainers

        return getattr(trainers, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

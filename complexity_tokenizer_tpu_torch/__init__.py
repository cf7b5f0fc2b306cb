"""complexity_tokenizer_tpu_torch — the PyTorch + CUDA port of the tokenizer.

The device encode pipeline (pre-split -> byte->token seed -> segmented
merge fixpoint) runs as PyTorch on an NVIDIA GPU, with the seed and the
merge fixpoint as hand-written CUDA kernels (``csrc/kernels.cu``).  Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``; on the
CPU every kernel wrapper runs its plain PyTorch version.

The standalone word-level models (``models/``: ByteLevel BPE, CharBPE,
WordPiece, WordLevel) run their distinct words through kernels K9-K11.

The package imports ``torch`` and ``numpy`` only: it keeps its own copy of
every host layer it needs (loading, normalizers, the GPT-2 split and the
BPE oracle).
"""

__all__ = ["Tokenizer", "ByteLevelBpeModel", "CharBpeModel", "WordLevelModel", "WordPieceModel"]


def __getattr__(name):
    # lazy: `import complexity_tokenizer_tpu_torch` stays light
    if name == "Tokenizer":
        from .tokenizer import Tokenizer

        return Tokenizer
    if name in ("ByteLevelBpeModel", "CharBpeModel", "WordLevelModel", "WordPieceModel"):
        from . import models

        return getattr(models, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

"""The standalone word-level models, each with its device tier:
ByteLevel BPE and CharBPE (kernel K9, ``ops/stringbpe_device.py``),
WordPiece (K10) and WordLevel (K11, ``ops/wordpiece_device.py``).

Each ``encode_batch(texts, device=None)`` splits on the host, runs the
batch's distinct words through its device tier (on ``cuda`` unless the
caller passes ``device="cpu"``, where the kernels' plain versions run) and
assembles the rows on the host.  A model whose tables the tier cannot take
(its build returns None) runs on the host, as in the JAX package, and
says so in ``last_route``; nothing else falls back.
"""

from .bytelevel_bpe import ByteLevelBpeModel
from .charbpe import CharBpeModel
from .wordlevel import WordLevelModel
from .wordpiece import WordPieceModel

__all__ = ["ByteLevelBpeModel", "CharBpeModel", "WordLevelModel", "WordPieceModel"]

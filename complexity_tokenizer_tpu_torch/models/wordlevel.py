"""WordLevel model: whitespace split and a dictionary lookup with UNK, as
the reference's (models.rs:316-362) and the JAX package's
(``models/wordlevel.py``).  Its device tier is kernel K11
(``ops/wordpiece_device.py``)."""

from __future__ import annotations

from ..ops.wordpiece_device import WordLevelDevice, build_wordlevel_tables
from ._device import DeviceTiers

__all__ = ["WordLevelModel"]


class WordLevelModel:
    def __init__(self, vocab: dict[str, int], unk_token: str = "<unk>"):
        self.vocab = dict(vocab)
        self.vocab_r = {v: k for k, v in vocab.items()}
        self.unk_token = unk_token
        self._tiers = DeviceTiers(self._build_tier)
        self.last_route: str | None = None
        self.last_stats: dict = {}

    def _build_tier(self, dev):
        tables = build_wordlevel_tables(self)
        return None if tables is None else WordLevelDevice(tables, dev)

    def encode(self, text: str) -> list[int]:
        unk_id = self.vocab.get(self.unk_token, 0)
        return [self.vocab.get(w, unk_id) for w in text.split()]

    def encode_batch(self, texts: list[str], device=None) -> list[list[int]]:
        """Batch encode: the distinct words resolved by K11 on ``device``
        (``cuda`` unless the caller passes ``"cpu"``), one probe and the
        exact check each.  Words over 128 characters are set to UNK on the
        host, as is every word when the vocabulary is not eligible
        (``last_route``); ``last_stats["host"]`` counts them."""
        dev = self._tiers.get(device)
        rows = [t.split() for t in texts]
        uniq = sorted({w for r in rows for w in r})
        if dev is None:
            self.last_route = "host"
            unk_id = self.vocab.get(self.unk_token, 0)
            ids = [self.vocab.get(w, unk_id) for w in uniq]
            host, over_width = len(uniq), 0
        else:
            self.last_route = "device"
            ids = dev.lookup_words(uniq)
            host = over_width = dev.last_over_width
        self.last_stats = {"words": len(uniq), "host": host, "poisoned": 0,
                           "over_width": over_width}
        table = dict(zip(uniq, ids))
        return [[table[w] for w in r] for r in rows]

    def decode(self, ids) -> str:
        return " ".join(self.vocab_r[int(i)] for i in ids if int(i) in self.vocab_r)

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def token_to_id(self, token: str):
        return self.vocab.get(token)

    def id_to_token(self, idx: int):
        return self.vocab_r.get(idx)

"""The vocabulary and the special-token registry.

``SpecialTokens`` names the unk, bos, eos, pad, sep, cls and mask tokens
(inferred from a tokenizer.json's special added tokens by ``hf/loading``);
``Vocab`` maps the model vocabulary both ways and resolves the ids of the
first four.  Added tokens outside the model vocabulary have no entry.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["SpecialTokens", "Vocab"]


@dataclass
class SpecialTokens:
    unk_token: str | None = "<unk>"
    bos_token: str | None = "<s>"
    eos_token: str | None = "</s>"
    pad_token: str | None = "<pad>"
    sep_token: str | None = None
    cls_token: str | None = None
    mask_token: str | None = None


class Vocab:
    def __init__(self, token_to_id: dict[str, int], special_tokens: SpecialTokens):
        self._token_to_id = dict(token_to_id)
        self._id_to_token = {v: k for k, v in token_to_id.items()}
        self._special_tokens = special_tokens
        self._special_token_ids: dict[str, int] = {}
        for name in ("unk", "bos", "eos", "pad"):
            tok = getattr(special_tokens, f"{name}_token")
            if tok is not None and tok in self._token_to_id:
                self._special_token_ids[name] = self._token_to_id[tok]

    def get_id(self, token: str) -> int | None:
        return self._token_to_id.get(token)

    def get_token(self, idx: int) -> str | None:
        return self._id_to_token.get(idx)

    def unk_id(self) -> int | None:
        return self._special_token_ids.get("unk")

    def bos_id(self) -> int | None:
        return self._special_token_ids.get("bos")

    def eos_id(self) -> int | None:
        return self._special_token_ids.get("eos")

    def pad_id(self) -> int | None:
        return self._special_token_ids.get("pad")

    def __len__(self) -> int:
        return len(self._token_to_id)

    def is_empty(self) -> bool:
        return not self._token_to_id

    def special_token_ids(self) -> dict[str, int]:
        return self._special_token_ids

    def token_to_id_map(self) -> dict[str, int]:
        return self._token_to_id

    def special_tokens(self) -> SpecialTokens:
        return self._special_tokens

    def is_special_token(self, token: str) -> bool:
        st = self._special_tokens
        return token is not None and token in (
            st.unk_token, st.bos_token, st.eos_token, st.pad_token,
            st.sep_token, st.cls_token, st.mask_token,
        )

"""BatchEncoding: the dict-like result of ``tokenizer(texts, ...)``.

``return_tensors`` is None (lists of lists), ``"np"`` (int32 ``[B, L]``
arrays) or ``"pt"`` (int32 ``[B, L]`` torch tensors on the device the
call named, ``cuda`` unless ``device="cpu"``).  A ``"pt"`` field is built
on the host, written into pinned memory and copied to the card in one
``non_blocking`` copy.  Rows of unequal length need padding.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.encoding import Encoding

__all__ = ["BatchEncoding", "ColumnarBatchEncoding"]

TENSOR_KINDS = (None, "np", "pt")
_RAGGED = "return_tensors requires padding (rows have unequal lengths)"


def _staging(shape, device: torch.device):
    """(host tensor, its numpy view) to fill and then hand to
    :func:`_to_device`: pinned memory when the field goes to a card."""
    host = torch.empty(shape, dtype=torch.int32, pin_memory=device.type == "cuda")
    return host, host.numpy()


def _to_device(host: torch.Tensor, device: torch.device) -> torch.Tensor:
    if device.type == "cpu":
        return host
    return host.to(device, non_blocking=True)


def _to_tensor(rows, kind: str, device: torch.device | None):
    """Stack equal-length rows into one int32 array (``"np"``) or tensor
    (``"pt"``, on ``device``)."""
    try:
        arr = np.asarray(rows, dtype=np.int32)
    except ValueError as e:  # numpy's "inhomogeneous shape" for ragged rows
        raise ValueError(_RAGGED) from e
    if kind == "np":
        return arr
    host, view = _staging(arr.shape, device)
    view[...] = arr
    return _to_device(host, device)


_FIELD_KEYS = {
    "input_ids",
    "attention_mask",
    "token_type_ids",
    "special_tokens_mask",
    "offset_mapping",
}


class BatchEncoding:
    # set by Tokenizer.__call__: the return_tensors kind and, for "pt", the
    # device the tensors go to
    _tensor_kind: str | None = None
    _device: torch.device | None = None

    def __init__(
        self,
        encodings: list[Encoding],
        return_attention_mask: bool = True,
        return_token_type_ids: bool = True,
        return_offsets_mapping: bool = False,
        return_special_tokens_mask: bool = False,
    ):
        self._encodings = encodings
        self.return_attention_mask = return_attention_mask
        self.return_token_type_ids = return_token_type_ids
        self.return_offsets_mapping = return_offsets_mapping
        self.return_special_tokens_mask = return_special_tokens_mask

    def _maybe_tensor(self, rows):
        return _to_tensor(rows, self._tensor_kind, self._device)

    @property
    def input_ids(self):
        rows = [e.ids for e in self._encodings]
        return self._maybe_tensor(rows) if self._tensor_kind else rows

    @property
    def attention_mask(self):
        if not self.return_attention_mask:
            return []
        rows = [e.attention_mask for e in self._encodings]
        return self._maybe_tensor(rows) if self._tensor_kind else rows

    @property
    def token_type_ids(self):
        if not self.return_token_type_ids:
            return []
        rows = [e.type_ids for e in self._encodings]
        return self._maybe_tensor(rows) if self._tensor_kind else rows

    @property
    def special_tokens_mask(self):
        if not self.return_special_tokens_mask:
            return []
        rows = [e.special_tokens_mask for e in self._encodings]
        return self._maybe_tensor(rows) if self._tensor_kind else rows

    @property
    def offset_mapping(self):
        if not self.return_offsets_mapping:
            return []
        return [e.offsets for e in self._encodings]

    def encodings(self) -> list[Encoding]:
        return list(self._encodings)

    def __len__(self) -> int:
        return len(self._encodings)

    def __getitem__(self, key):
        if isinstance(key, str):
            if key not in _FIELD_KEYS or key not in self.keys():
                raise KeyError(key)
            return getattr(self, key)
        if not 0 <= key < len(self._encodings):
            raise IndexError("Index out of range")
        return self._encodings[key]

    def keys(self):
        out = ["input_ids"]
        if self.return_attention_mask:
            out.append("attention_mask")
        if self.return_token_type_ids:
            out.append("token_type_ids")
        if self.return_special_tokens_mask:
            out.append("special_tokens_mask")
        if self.return_offsets_mapping:
            out.append("offset_mapping")
        return out

    def input_ids_as_numpy(self):
        return [np.asarray(e.ids, dtype=np.uint32) for e in self._encodings]

    def attention_mask_as_numpy(self):
        return [np.asarray(e.attention_mask, dtype=np.uint32) for e in self._encodings]

    def to_dict(self) -> dict:
        return {k: getattr(self, k) for k in self.keys()}


class ColumnarBatchEncoding(BatchEncoding):
    """The ``tokenizer(texts, ...)`` result of the columnar route: the batch
    fields come from the native ragged encode and a static post-processor
    frame (prefix ids, suffix ids) in one native pass each (``frame_rows``,
    ``frame_matrix``, ``mask_rows``, ``mask_matrix``), with no Encoding per
    row.  The Encodings are built on first use (``encodings()``, indexing)
    by the per-row route (``Tokenizer._build_call_encoding``, then truncate
    and pad), so the alignment API and the overflow windows are the
    per-row route's.

    A row's lengths: processed m = p + n + s; truncated t = min(m,
    max_len); final max(t, pad_to) when padding.  The special mask is
    ``[0] * n + [1] * (m - n)`` before truncation (the frame counted at the
    end wherever it sits), ORed with membership of the special ids, then 1
    at pads.
    """

    def __init__(
        self,
        tokenizer,
        texts,
        flat,
        offs,
        prefix,
        suffix,
        truncation: bool,
        max_len: int,
        stride: int,
        padding,
        pad_to: int,
        pad_id: int,
        pad_token: str,
        pad_left: bool,
        return_attention_mask: bool = True,
        return_token_type_ids: bool = True,
        return_special_tokens_mask: bool = False,
    ):
        from .native import load_ext

        self._ext = load_ext()
        self._tok = tokenizer
        self._texts = texts
        self._flat = np.ascontiguousarray(flat, np.int32)
        self._offs = np.ascontiguousarray(offs, np.int64)
        self._prefix = list(prefix)
        self._suffix = list(suffix)
        self._truncation = truncation
        self._max_len = max_len
        self._stride = stride
        self._padding = padding
        self._pad_to = pad_to
        self._pad_id = pad_id
        self._pad_token = pad_token
        self._pad_left = pad_left
        self.return_attention_mask = return_attention_mask
        self.return_token_type_ids = return_token_type_ids
        self.return_offsets_mapping = False
        self.return_special_tokens_mask = return_special_tokens_mask
        n = np.diff(self._offs)
        m = n + len(self._prefix) + len(self._suffix)
        t = np.minimum(m, max_len) if truncation else m
        self._t = np.ascontiguousarray(t, np.int64)
        self._final = np.ascontiguousarray(
            np.maximum(t, pad_to) if padding is not None else t, np.int64
        )
        self._rows_cache = None
        self._mat_cache = None
        self._encs = None

    def __len__(self) -> int:
        return len(self._t)

    # -- columnar fields ------------------------------------------------
    def _frame_args(self):
        """The frame entry points' arguments after (flat, offs): -1 turns
        truncation or padding off."""
        trunc = self._max_len if self._truncation else -1
        pad_to = self._pad_to if self._padding is not None else -1
        return (self._prefix, self._suffix, int(trunc), int(pad_to), int(self._pad_id),
                int(self._pad_left))

    def _frame_rows(self):
        if self._rows_cache is None:
            self._rows_cache = self._ext.frame_rows(self._flat, self._offs, *self._frame_args())
        return self._rows_cache

    def _check_rect(self):
        lens = self._final
        if len(lens) and int(lens.min()) != int(lens.max()):
            raise ValueError(_RAGGED)

    def _width(self) -> int:
        return int(self._final.max(initial=0))

    def _tensor_field(self, fill):
        """One ``[B, L]`` int32 field for ``return_tensors``: ``fill(out)``
        writes it into a numpy array, for ``"pt"`` the view of a pinned
        host tensor that then goes to the device in one copy."""
        self._check_rect()
        shape = (len(self._final), self._width())
        if self._tensor_kind == "np":
            out = np.empty(shape, np.int32)
            fill(out)
            return out
        host, view = _staging(shape, self._device)
        fill(view)
        return _to_device(host, self._device)

    @property
    def input_ids(self):
        if self._tensor_kind is not None:
            return self._tensor_field(
                lambda out: self._ext.frame_matrix(self._flat, self._offs, *self._frame_args(), out)
            )
        return self._frame_rows()

    @property
    def attention_mask(self):
        if not self.return_attention_mask:
            return []
        if self._tensor_kind is not None:
            return self._tensor_field(
                lambda out: self._ext.mask_matrix(
                    self._t, self._final, int(self._pad_left), out.shape[1], out
                )
            )
        # fresh lists on every read: callers may mutate the rows
        return self._ext.mask_rows(self._t, self._final, int(self._pad_left))

    @property
    def token_type_ids(self):
        if not self.return_token_type_ids:
            return []
        if self._tensor_kind is not None:
            return self._tensor_field(lambda out: out.fill(0))
        return [[0] * int(f) for f in self._final]

    @property
    def special_tokens_mask(self):
        if not self.return_special_tokens_mask:
            return []
        if self._tensor_kind is not None:
            return self._tensor_field(lambda out: np.copyto(out, self._special_mask_matrix()))
        lens = self._final
        mask = self._special_mask_matrix()
        return [mask[i, : int(lens[i])].tolist() for i in range(len(lens))]

    def _special_mask_matrix(self) -> np.ndarray:
        """``[B, Lmax]`` int64 special mask; past a row's final length it
        holds pads (1)."""
        mat, _ = self._ids_matrix()
        max_id = int(mat.max(initial=0))
        lut = np.zeros(max_id + 1, bool)
        for sid in self._tok.special_tokens.values():
            if 0 <= sid <= max_id:
                lut[sid] = True
        is_spec = lut[np.clip(mat, 0, max_id)]
        L = mat.shape[1]
        pos = np.arange(L, dtype=np.int64)[None, :]
        n = np.diff(self._offs)[:, None]
        t = self._t[:, None]
        f = self._final[:, None]
        if self._pad_left:
            rel = pos - (f - t)  # the row's content starts at f - t
            mask = (rel >= np.minimum(n, t)) | (rel < 0) | is_spec
        else:
            mask = (pos >= np.minimum(n, t)) | is_spec
        return mask.astype(np.int64)

    def _ids_matrix(self):
        """(``[B, Lmax]`` int32 matrix padded with the pad id, per-row final
        lengths), filled straight from the ragged encode by the native
        ``frame_matrix``."""
        if self._mat_cache is None:
            lens = self._final
            mat = np.empty((len(lens), self._width()), np.int32)
            self._ext.frame_matrix(self._flat, self._offs, *self._frame_args(), mat)
            self._mat_cache = (mat, lens)
        return self._mat_cache

    def input_ids_as_numpy(self):
        mat, lens = self._ids_matrix()
        return [np.asarray(mat[i, : int(lens[i])], dtype=np.uint32) for i in range(mat.shape[0])]

    def attention_mask_as_numpy(self):
        return [np.asarray(m, dtype=np.uint32) for m in self.attention_mask]

    # -- per-row Encodings, built on first use ----------------------------
    def _materialize_row(self, i: int) -> Encoding:
        ids = self._flat[self._offs[i] : self._offs[i + 1]].tolist()
        enc = self._tok._build_call_encoding(self._texts[i], ids)
        if self._truncation and len(enc) > self._max_len:
            if self._stride > 0:
                enc.truncate_with_stride(self._max_len, self._stride)
            else:
                enc.truncate(self._max_len)
        if self._padding is not None:
            enc.pad(int(self._pad_to), self._pad_id, self._pad_token, self._pad_left)
        return enc

    def _materialize(self) -> list:
        if self._encs is None:
            self._encs = [self._materialize_row(i) for i in range(len(self._t))]
        return self._encs

    def encodings(self) -> list:
        return list(self._materialize())

    def __getitem__(self, key):
        if isinstance(key, str):
            if key not in _FIELD_KEYS or key not in self.keys():
                raise KeyError(key)
            return getattr(self, key)
        if not 0 <= key < len(self._t):
            raise IndexError("Index out of range")
        return self._materialize()[key]

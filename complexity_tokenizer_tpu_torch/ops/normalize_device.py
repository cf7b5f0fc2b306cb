"""Device normalization check: which rows are already fixed points of the
normalizer (kernel K8, ``csrc/normcheck.cu``).

Full Unicode normalization is a sequential, expanding rewrite, but most
text is already normalized, and proving that is one table read per
codepoint.  So the work is split:

- every supported normalizer gets a **stability bitmap** over codepoints:
  a row holding no flagged codepoint is a fixed point of the normalizer,
  and its host rewrite is skipped;
- on the device, K8 decodes the UTF-8 lead bytes of each packed row,
  reads the bitmap and reduces per row (:func:`norm_stable_rows`);
- flagged rows are rewritten on the host with the exact reference
  semantics, so the result equals host normalization by construction.

The bitmaps are the JAX package's (``ops/normalize_device.py``), byte for
byte:

- NFC/NFKC: flag cp when F(cp) != cp, when ccc(cp) != 0, when cp is the
  second element of an effective canonical composition pair, or when cp
  is a Hangul jamo V/T.
- NFD/NFKD: flag when F(cp) != cp or ccc(cp) != 0.
- Lowercase: flag when lower(cp) != cp.
- StripAccents: the NFD bitmap plus the reference's combining marks.
- Strip: positional, checked on the host (first and last character).
- Replace / Precompiled: every codepoint of the pattern(s).
- BertNormalizer: the union of its passes (control and whitespace
  cleanup, CJK spacing, NFC, accents, lowercase).
- Sequence: the union (a text unchanged by every stage alone is
  unchanged by the composition).

A build loops over the 1,114,112 codepoints in Python (each kind is cached
for the process, as in JAX).
"""

from __future__ import annotations

import functools
import unicodedata

import numpy as np
import torch

from ..core import normalizers as N
from ..utils.cuda_build import check, kernel_library
from ..utils.device import resolve_device
from ..utils.unicode_tables import (
    is_cjk_bert,
    is_combining_mark,
    is_control_char,
    whitespace_set,
)

__all__ = [
    "NormPlan",
    "plan_for_normalizer",
    "DeviceNormChecker",
    "stability_bitmap",
    "norm_stable_rows",
    "norm_stable_rows_plain",
]

_MAX_CP = 0x110000
# rows per launch of the check (the pipeline's largest batch bucket)
_MAX_ROWS = 8192


class NormPlan:
    """bitmap: uint8 [0x110000], 1 = a row holding this codepoint needs the
    host rewrite; host_pred: optional text -> bool positional check (Strip)."""

    __slots__ = ("bitmap", "host_pred")

    def __init__(self, bitmap: np.ndarray, host_pred=None):
        self.bitmap = bitmap
        self.host_pred = host_pred


@functools.lru_cache(maxsize=None)
def _composition_second_elements() -> frozenset:
    """Second elements of effective canonical composition pairs, and the
    Hangul jamo V and T."""
    out = set()
    for cp in range(_MAX_CP):
        if 0xD800 <= cp <= 0xDFFF:
            continue
        d = unicodedata.decomposition(chr(cp))
        if not d or d.startswith("<"):
            continue
        parts = d.split()
        if len(parts) != 2:
            continue
        a, b = int(parts[0], 16), int(parts[1], 16)
        if unicodedata.normalize("NFC", chr(a) + chr(b)) == chr(cp):
            out.add(b)  # an effective pair (not composition-excluded)
    out.update(range(0x1161, 0x1176))  # Hangul jamo V
    out.update(range(0x11A8, 0x11C3))  # Hangul jamo T
    return frozenset(out)


@functools.lru_cache(maxsize=None)
def stability_bitmap(kind: str) -> np.ndarray:
    """uint8 [0x110000] bitmap (read-only): 1 = a text holding this
    codepoint is not guaranteed to be a fixed point of ``kind``."""
    bm = np.zeros(_MAX_CP, np.uint8)
    bm[0xD800:0xE000] = 1
    if kind in ("NFC", "NFD", "NFKC", "NFKD"):
        second = _composition_second_elements() if kind in ("NFC", "NFKC") else ()
        for cp in range(_MAX_CP):
            if bm[cp]:
                continue
            c = chr(cp)
            if (
                unicodedata.combining(c) != 0
                or unicodedata.normalize(kind, c) != c
                or cp in second
            ):
                bm[cp] = 1
    elif kind == "lowercase":
        for cp in range(_MAX_CP):
            if not bm[cp] and chr(cp).lower() != chr(cp):
                bm[cp] = 1
    elif kind == "strip_accents":
        bm |= stability_bitmap("NFD")
        for cp in range(_MAX_CP):
            if not bm[cp] and is_combining_mark(chr(cp)):
                bm[cp] = 1
    elif kind == "bert_clean_text":
        ws = whitespace_set()
        for cp in range(_MAX_CP):
            if bm[cp]:
                continue
            c = chr(cp)
            if is_control_char(c) or (c in ws and c != " "):
                bm[cp] = 1
    elif kind == "bert_cjk":
        for cp in range(_MAX_CP):
            if not bm[cp] and is_cjk_bert(chr(cp)):
                bm[cp] = 1
    else:
        raise ValueError(kind)
    bm.setflags(write=False)
    return bm


def _pattern_bitmap(patterns) -> np.ndarray | None:
    """Flag every codepoint of any pattern; None when a pattern is empty
    (an empty pattern's replace touches every position)."""
    bm = np.zeros(_MAX_CP, np.uint8)
    for p in patterns:
        if not p:
            return None
        for c in p:
            bm[ord(c)] = 1
    return bm


def plan_for_normalizer(norm) -> NormPlan | None:
    """The stability plan of a normalizer; None when there is none (the
    pipeline then normalizes every row on the host)."""
    if norm is None:
        return NormPlan(np.zeros(_MAX_CP, np.uint8))
    for cls, kind in (
        (N.NFC, "NFC"), (N.NFD, "NFD"), (N.NFKC, "NFKC"), (N.NFKD, "NFKD"),
        (N.Lowercase, "lowercase"), (N.StripAccents, "strip_accents"),
    ):
        if isinstance(norm, cls):
            return NormPlan(stability_bitmap(kind).copy())
    if isinstance(norm, N.Strip):
        ws = whitespace_set()

        def strip_pred(t: str) -> bool:
            return bool(t) and (t[0] in ws or t[-1] in ws)

        return NormPlan(np.zeros(_MAX_CP, np.uint8), strip_pred)
    if isinstance(norm, N.Replace):
        bm = _pattern_bitmap([norm.pattern])
        return None if bm is None else NormPlan(bm)
    if isinstance(norm, N.Precompiled):
        bm = _pattern_bitmap([frm for frm, _ in norm.charsmap])
        return None if bm is None else NormPlan(bm)
    if isinstance(norm, N.BertNormalizer):
        bm = np.zeros(_MAX_CP, np.uint8)
        if norm.clean_text:
            bm |= stability_bitmap("bert_clean_text")
        if norm.handle_chinese_chars:
            bm |= stability_bitmap("bert_cjk")
        bm |= stability_bitmap("NFC")
        should_strip = norm.strip_accents if norm.strip_accents is not None else norm.lowercase
        if should_strip:
            bm |= stability_bitmap("strip_accents")
        if norm.lowercase:
            bm |= stability_bitmap("lowercase")
        return NormPlan(bm)
    if isinstance(norm, N.Sequence):
        bm = np.zeros(_MAX_CP, np.uint8)
        preds = []
        for child in norm.normalizers:
            sub = plan_for_normalizer(child)
            if sub is None:
                return None
            bm |= sub.bitmap
            if sub.host_pred is not None:
                preds.append(sub.host_pred)
        pred = None
        if preds:
            def pred(t, _preds=tuple(preds)):
                return any(p(t) for p in _preds)
        return NormPlan(bm, pred)
    return None


# ---------------------------------------------------------------------------
# K8 and its plain version


def _shift_left(x: torch.Tensor, k: int) -> torch.Tensor:
    out = torch.zeros_like(x)
    out[:, : x.shape[1] - k] = x[:, k:]
    return out


def norm_stable_rows_plain(byte_arr, lengths, bitmap) -> torch.Tensor:
    """Plain PyTorch version of K8, on any device: the JAX
    ``DeviceNormChecker._fn``.

    Args:
      byte_arr: [B, L] uint8 packed UTF-8 rows.
      lengths: [B] int32 bytes of each row.
      bitmap: [0x110000] uint8 stability bitmap.
    Returns:
      [B] bool: True where no lead byte before the row's length decodes to
      a flagged codepoint.  Bytes past the array's width read as 0; the
      codepoint is clamped to 0x10FFFF.
    """
    b0 = byte_arr.to(torch.int32)
    L = b0.shape[1]
    valid = torch.arange(L, device=b0.device)[None, :] < lengths[:, None]
    b1, b2, b3 = (_shift_left(b0, k) for k in (1, 2, 3))
    is_cont = (b0 & 0xC0) == 0x80
    cp2 = ((b0 & 0x1F) << 6) | (b1 & 0x3F)
    cp3 = ((b0 & 0x0F) << 12) | ((b1 & 0x3F) << 6) | (b2 & 0x3F)
    cp4 = ((b0 & 0x07) << 18) | ((b1 & 0x3F) << 12) | ((b2 & 0x3F) << 6) | (b3 & 0x3F)
    cp = torch.where(b0 < 0x80, b0, torch.where(b0 < 0xE0, cp2, torch.where(b0 < 0xF0, cp3, cp4)))
    cp = cp.clamp(0, 0x10FFFF)
    unstable = valid & ~is_cont & (bitmap[cp.long()] != 0)
    return ~unstable.any(dim=1)


def norm_stable_rows(byte_arr, lengths, bitmap) -> torch.Tensor:
    """K8 on CUDA tensors, the plain version on CPU tensors; same
    arguments and result as :func:`norm_stable_rows_plain`."""
    if byte_arr.device.type == "cpu":
        return norm_stable_rows_plain(byte_arr, lengths, bitmap)
    if byte_arr.device.type != "cuda":
        raise ValueError(f"norm_stable_rows: unsupported device {byte_arr.device}")
    B, L = byte_arr.shape
    for name, t, dtype, shape in (
        ("byte_arr", byte_arr, torch.uint8, (B, L)),
        ("lengths", lengths, torch.int32, (B,)),
        ("bitmap", bitmap, torch.uint8, (_MAX_CP,)),
    ):
        if t.device != byte_arr.device or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"norm_stable_rows: {name} must be {dtype} {shape} on {byte_arr.device}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"norm_stable_rows: {name} must be contiguous")
    out = torch.empty(B, dtype=torch.bool, device=byte_arr.device)
    if B == 0:
        return out
    stream = torch.cuda.current_stream(byte_arr.device).cuda_stream
    check(
        kernel_library().lib.ctok_norm_check(
            byte_arr.data_ptr(), lengths.data_ptr(), bitmap.data_ptr(), out.data_ptr(),
            B, L, stream,
        ),
        "norm_stable_rows",
    )
    norm_stable_rows.launches += 1
    return out


norm_stable_rows.launches = 0  # launches of K8 (not of the plain version)


class DeviceNormChecker:
    """The stability check of one plan on one device (``cuda`` unless the
    caller passes ``device="cpu"``)."""

    def __init__(self, plan: NormPlan, device=None):
        self.plan = plan
        self.device = resolve_device(device)
        self.bitmap = torch.from_numpy(np.ascontiguousarray(plan.bitmap)).to(self.device)

    def check_bytes(self, raw: list[bytes], length_buckets, pack) -> np.ndarray:
        """Per-row stability flags (numpy bool).  Rows are grouped by length
        bucket and checked at the exact batch size (at most 8,192 rows a
        launch); rows wider than the largest bucket are reported unstable
        (the host normalizes them, exact either way)."""
        clean = np.zeros(len(raw), dtype=bool)
        groups: dict[int, list[int]] = {}
        for i, d in enumerate(raw):
            n = max(len(d), 1)
            L = next((b for b in length_buckets if n <= b), None)
            if L is not None:
                groups.setdefault(L, []).append(i)
        for L, idxs in groups.items():
            for c0 in range(0, len(idxs), _MAX_ROWS):
                chunk = idxs[c0 : c0 + _MAX_ROWS]
                arr, lens = pack([raw[i] for i in chunk], L, len(chunk))
                flags = norm_stable_rows(
                    torch.from_numpy(arr).to(self.device),
                    torch.from_numpy(lens).to(self.device),
                    self.bitmap,
                )
                clean[chunk] = flags.cpu().numpy()
        if self.plan.host_pred is not None:
            for i, d in enumerate(raw):
                if clean[i] and self.plan.host_pred(d.decode("utf-8")):
                    clean[i] = False
        return clean

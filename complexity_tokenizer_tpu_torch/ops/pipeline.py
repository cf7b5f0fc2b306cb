"""End-to-end device encode pipeline.

Batch encode = normalize and prefix (``encode_batch``: the rows that
kernel K8 proves to be fixed points of the normalizer skip the host
rewrite, ``ops/normalize_device.py``; ``encode_bytes`` takes the bytes
normalized and prefixed by the Tokenizer) -> UTF-8 bytes packed into
``[B, L]`` uint8 tensors at bucketed widths -> on the device:
pre-split (torch ops), byte -> token seed (kernel K1), segmented merge
fixpoint (``TorchTables.merge_fixpoint``: kernel K2 on the u16 cuckoo
table when it is eligible, kernel K5 on the CHD table otherwise)
-> host unpack to ragged id lists.  Texts longer than
the widest bucket are cut at word boundaries; one word longer than that
goes to the host oracle.

Eligibility: BPE + the ByteLevel pre-tokenizer + a well-formed merge table
with a cuckoo or a CHD pair table.  Anything else raises ``NotImplementedError``: the
pipeline never falls back.  Texts that may hold an added token are routed to the host tier
by the Tokenizer.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..convert import tables_to_device
from ..core.pretokenizers import ByteLevel, gpt2_split_spans
from ..utils.bytelevel import encode_bytes
from ..utils.device import resolve_device
from ..utils.unicode_tables import gpt2_class_table
from .normalize_device import DeviceNormChecker, plan_for_normalizer
from .presplit import presplit
from .seed import seed_tokens

__all__ = ["EncodePipeline", "build_encode_pipeline", "pack_texts"]

# few, coarse buckets (the JAX package's): every (B, L) is one shape
_LENGTH_BUCKETS = (128, 512, 2048, 4096)
_BATCH_BUCKETS = (16, 256, 2048, 8192)


def _bucket(n: int, buckets) -> int | None:
    for b in buckets:
        if n <= b:
            return b
    return None


def pack_texts(data: list[bytes], L: int, B: int):
    """Pack UTF-8 byte strings into a zero-padded [B, L] uint8 matrix and
    [B] int32 lengths."""
    arr = np.zeros((B, L), dtype=np.uint8)
    lens = np.zeros(B, dtype=np.int32)
    flat = np.frombuffer(b"".join(data), dtype=np.uint8)
    off = 0
    for i, d in enumerate(data):
        n = len(d)
        arr[i, :n] = flat[off : off + n]
        lens[i] = n
        off += n
    return arr, lens


class EncodePipeline:
    """Holds the tables on one device and runs the encode pass there."""

    def __init__(self, tables, host_bpe, device, normalizer=None, add_prefix_space=False):
        if tables.qc is None and tables.chd is None:
            raise NotImplementedError(
                "the merge table fits neither the u16 cuckoo table nor a CHD table"
            )
        self.device = torch.device(device)
        self._host_bpe = host_bpe
        self.normalizer = normalizer
        self.add_prefix_space = add_prefix_space
        self.max_id = tables.max_id
        qc, chd = tables.qc, tables.chd
        self.tables = tables_to_device(
            byte_token_table=tables.byte_token_table,
            class_table=gpt2_class_table(),
            device=self.device,
            **(dict(qc_t1=qc.t1, qc_t2=qc.t2, qc_size=qc.size) if qc is not None else {}),
            **(dict(chd_disp=chd.disp, chd_rows=chd.rows) if chd is not None else {}),
        )

    def encode_rows(self, arr: np.ndarray, lens: np.ndarray) -> np.ndarray:
        """[B, L] uint8 + [B] int32 -> [B, L] int32 ids with -1 tombstones."""
        tb = self.tables
        arr_t = torch.from_numpy(arr).to(self.device)
        lens_t = torch.from_numpy(lens).to(self.device)
        _start, word_id, _valid = presplit(arr_t, lens_t, tb.class_table)
        tokens = seed_tokens(arr_t, lens_t, tb.byte_token_table)
        tokens, _count = tb.merge_fixpoint(tokens, word_id)
        return tokens.cpu().numpy()

    def _encode_packed(self, data: list[bytes]) -> list[list[int]]:
        """Encode byte strings that fit the widest bucket, grouped by length
        bucket and chunked by batch bucket."""
        results: list[list[int]] = [[] for _ in data]
        groups: dict[int, list[int]] = {}
        for i, d in enumerate(data):
            groups.setdefault(_bucket(max(len(d), 1), _LENGTH_BUCKETS), []).append(i)
        for L, idxs in groups.items():
            B = _bucket(len(idxs), _BATCH_BUCKETS) or len(idxs)
            for c0 in range(0, len(idxs), B):
                chunk = idxs[c0 : c0 + B]
                Bpad = _bucket(len(chunk), _BATCH_BUCKETS) or len(chunk)
                arr, lens = pack_texts([data[i] for i in chunk], L, Bpad)
                tokens = self.encode_rows(arr, lens)
                for row, i in enumerate(chunk):
                    rt = tokens[row]
                    results[i] = rt[rt >= 0].tolist()
        return results

    @functools.cached_property
    def _norm_checker(self) -> DeviceNormChecker | None:
        """K8's stability check for the normalizer on this pipeline's device;
        None when the normalizer has no plan (``Prepend``, an empty
        ``Replace``: every row is normalized on the host).  A failed build
        raises."""
        plan = plan_for_normalizer(self.normalizer)
        return None if plan is None else DeviceNormChecker(plan, self.device)

    def _prepare(self, texts: list[str], already_normalized: bool = False) -> list[bytes]:
        """Normalize and prefix: the UTF-8 bytes the pre-tokenizer splits.
        Rows that K8 proves stable skip ``normalize()``; the others are
        rewritten on the host, so the result equals host normalization."""
        norm = None if already_normalized else self.normalizer
        raw = [t.encode("utf-8") for t in texts]
        if norm is not None:
            checker = self._norm_checker
            if checker is None:
                raw = [norm.normalize(t).encode("utf-8") for t in texts]
            else:
                clean = checker.check_bytes(raw, _LENGTH_BUCKETS, pack_texts)
                raw = [d if c else norm.normalize(t).encode("utf-8")
                       for t, d, c in zip(texts, raw, clean)]
        if self.add_prefix_space:
            raw = [b" " + d if d and not d.startswith(b" ") else d for d in raw]
        return raw

    def encode_batch(self, texts: list[str], already_normalized: bool = False) -> list[list[int]]:
        """Ids of each text: normalized (unless ``already_normalized``) with
        K8's check, prefixed, then encoded as :meth:`encode_bytes`."""
        return self.encode_bytes(self._prepare(texts, already_normalized))

    def encode_bytes(self, data: list[bytes]) -> list[list[int]]:
        """Ids of each text, given as the UTF-8 bytes the pre-tokenizer
        splits (already normalized and prefixed)."""
        max_L = _LENGTH_BUCKETS[-1]
        fit = [i for i, d in enumerate(data) if len(d) <= max_L]
        results: list[list[int]] = [[] for _ in data]
        for i, ids in zip(fit, self._encode_packed([data[i] for i in fit])):
            results[i] = ids
        for i, d in enumerate(data):
            if len(d) > max_L:
                results[i] = self._encode_long(d)
        return results

    def _encode_long(self, d: bytes) -> list[int]:
        """Over-long text: cut at word boundaries into pieces of at most the
        widest bucket (merges never cross a word, so the concatenation is
        exact); a single word longer than that goes to the host oracle."""
        text = d.decode("utf-8")
        max_L = _LENGTH_BUCKETS[-1]
        pieces: list[tuple[str, str]] = []  # ("dev" | "host", text)
        cur: list[str] = []
        cur_len = 0
        for a, b in gpt2_split_spans(text):
            w = text[a:b]
            wb = len(w.encode("utf-8"))
            if wb > max_L or cur_len + wb > max_L:
                if cur:
                    pieces.append(("dev", "".join(cur)))
                cur, cur_len = [], 0
            if wb > max_L:
                pieces.append(("host", w))
                continue
            cur.append(w)
            cur_len += wb
        if cur:
            pieces.append(("dev", "".join(cur)))

        dev_idx = [j for j, (kind, _) in enumerate(pieces) if kind == "dev"]
        dev_ids = self._encode_packed([pieces[j][1].encode("utf-8") for j in dev_idx])
        piece_ids: dict[int, list[int]] = dict(zip(dev_idx, dev_ids))
        out: list[int] = []
        for j, (kind, w) in enumerate(pieces):
            if kind == "host":
                out.extend(self._host_bpe.encode(encode_bytes(w.encode("utf-8"))))
            else:
                out.extend(piece_ids[j])
        return out


def build_encode_pipeline(tokenizer, device=None) -> EncodePipeline:
    """Pipeline for a port Tokenizer on ``device`` (``cuda`` by default).

    Raises ``NotImplementedError`` for a configuration the device path does
    not run, and ``RuntimeError`` when CUDA is asked for without a card."""
    dev = resolve_device(device)
    if not isinstance(tokenizer.pre_tokenizer, ByteLevel):
        raise NotImplementedError(
            f"the device path runs the ByteLevel pre-tokenizer, not "
            f"{type(tokenizer.pre_tokenizer).__name__}"
        )
    if not tokenizer.bpe.vocab:
        raise NotImplementedError("empty vocabulary")
    tables = tokenizer.device_tables()
    if not tables.well_formed:
        raise NotImplementedError(
            "the merge table is not well-formed: the device fixpoint would "
            "differ from the one-merge-per-step oracle"
        )
    return EncodePipeline(
        tables, host_bpe=tokenizer.bpe, device=dev, normalizer=tokenizer.normalizer,
        add_prefix_space=tokenizer.pre_tokenizer.add_prefix_space,
    )

"""The Tokenizer: tokenizer.json loading, the host oracle, the native
runtime and the device word path.

Backends of ``encode_batch`` and ``encode_batch_ragged``, as in the JAX
package:

- ``"auto"`` (the default): the native runtime encodes every text through
  its word caches, while the device merges the distinct words the caches
  miss in the background (``ops/wordpath.py``, asynchronous fill);
- ``"device"``: the device merges the batch's missing words first, then
  the native runtime assembles each text from the caches;
- ``"native"``: the native runtime alone;
- ``"host"``: the pure-Python oracle.

``"auto"`` and ``"device"`` run on ``cuda`` unless the caller passes
``device="cpu"``, where every kernel wrapper runs its plain version.  Texts
that may hold an added token go to the oracle, which splits on added
tokens.  A configuration the device path does not run raises; nothing
falls back.  The text-level pipeline (pre-split, K1, K2 or K5 over whole
texts) stays available as ``Tokenizer.pipeline(device).encode_bytes``.
"""

from __future__ import annotations

import json
import threading

import numpy as np
import torch

from .core.bpe import BpeTokenizer
from .hf.loading import TokenizerSpec, load_spec
from .ops.pipeline import EncodePipeline, build_encode_pipeline
from .ops.tables import DeviceTables, build_device_tables, byte_token_table
from .ops.wordpath import DeviceWordEncoder, build_word_encoder
from .utils.bytelevel import unicode_to_bytes
from .utils.device import resolve_device

__all__ = ["Tokenizer"]

BACKENDS = ("auto", "device", "native", "host")


class Tokenizer:
    # below this vocabulary size, pre-merging the vocabulary into the word
    # caches costs more than it saves
    _WARM_START_MIN_VOCAB = 4096

    def __init__(self, spec: TokenizerSpec):
        self.bpe = BpeTokenizer(spec.vocab, spec.merges)
        self.normalizer = spec.normalizer
        self.pre_tokenizer = spec.pre_tokenizer
        self.added_tokens: dict[str, int] = {t.content: t.id for t in spec.added_tokens}
        self._added_patterns = self._byte_patterns()
        self._tables: DeviceTables | None = None
        self._pipelines: dict[torch.device, EncodePipeline] = {}
        self._word_paths: dict[torch.device, DeviceWordEncoder] = {}
        self._native = None
        self._native_built = False
        self._warm_started = False
        self._warm_start_words = 0
        # serialises the one-time builds (native context, tables, word
        # path) between serving threads
        self._build_lock = threading.RLock()

    @staticmethod
    def from_str(s: str) -> "Tokenizer":
        return Tokenizer(load_spec(json.loads(s)))

    @staticmethod
    def from_file(path) -> "Tokenizer":
        with open(path, "r", encoding="utf-8") as f:
            tok = Tokenizer(load_spec(json.load(f)))
        if len(tok.bpe.vocab) >= Tokenizer._WARM_START_MIN_VOCAB:
            # loading pays the native build and the warm start, not the
            # first batch
            tok._get_native_encoder()
        return tok

    # ------------------------------------------------------------------
    # host tier (the oracle)

    def _normalize(self, text: str) -> str:
        # every loaded normalizer is a Unicode form: the identity on ASCII
        if self.normalizer is None or text.isascii():
            return text
        return self.normalizer.normalize(text)

    def _encode_host(self, text: str, already_normalized: bool = False) -> list[int]:
        """Reference-exact scalar encode: pre-tokenize, then match added
        tokens inside each byte-level word, BPE-encoding what lies between."""
        normalized = text if already_normalized else self._normalize(text)
        result: list[int] = []
        for word in self.pre_tokenizer.pre_tokenize(normalized):
            remaining = word
            while remaining:
                best = None  # (token, id), the longest added token at 0
                for token, tid in self.added_tokens.items():
                    if remaining.startswith(token) and (
                        best is None or len(token) > len(best[0])
                    ):
                        best = (token, tid)
                if best is not None:
                    result.append(best[1])
                    remaining = remaining[len(best[0]) :]
                    continue
                next_pos = self._next_added_token(remaining)
                if 0 < next_pos < len(remaining):
                    result.extend(self.bpe.encode(remaining[:next_pos]))
                    remaining = remaining[next_pos:]
                else:
                    result.extend(self.bpe.encode(remaining))
                    break
        return result

    def _next_added_token(self, text: str) -> int:
        """First position > 0 where an added token occurs, else len(text)."""
        min_pos = len(text)
        for token in self.added_tokens:
            pos = text.find(token)
            if pos > 0:
                min_pos = min(min_pos, pos)
        return min_pos

    def encode(self, text: str) -> list[int]:
        """Encode one text with the host oracle."""
        return self._encode_host(text)

    # ------------------------------------------------------------------
    # native tier

    def _get_native_encoder(self):
        """The native (C++) encoder, built and warm-started once; None for an
        empty vocabulary.  Raises when the native runtime cannot be built."""
        with self._build_lock:
            if not self._native_built:
                native = None
                if self.bpe.vocab:
                    from .native import NativeEncoder

                    native = NativeEncoder(
                        self.bpe.packed_merge_arrays(), byte_token_table(self.bpe.vocab)
                    )
                    self._warm_start_native(native)
                self._native, self._native_built = native, True
            return self._native

    def warm_start(self) -> int:
        """Pre-merge every vocabulary word into the native word caches
        (whatever the vocabulary size).  Returns the words inserted."""
        native = self._get_native_encoder()
        if native is None:
            return 0
        return self._warm_start_native(native, force=True)

    def _warm_start_native(self, native, force: bool = False) -> int:
        """Vocabulary warm start, in memory: every vocabulary word's ids
        follow from the merge table alone, and the vocabulary is the head of
        any Zipf-like corpus, so merging it at load time makes a fresh
        tokenizer's caches start warm.  Returns the words inserted."""
        with self._build_lock:
            if self._warm_started:
                return 0
            if not force and len(self.bpe.vocab) < self._WARM_START_MIN_VOCAB:
                return 0
            self._warm_started = True
        inv = unicode_to_bytes()
        parts: list[bytes] = []
        for tok_str in self.bpe.vocab:
            try:
                b = bytes(inv[c] for c in tok_str)
            except KeyError:
                continue  # special or added token outside the alphabet
            if 0 < len(b) <= 256:
                parts.append(b)
        if not parts:
            return 0
        words_buf = np.frombuffer(b"".join(parts), np.uint8)
        lens = np.fromiter((len(b) for b in parts), np.int64, count=len(parts))
        native.warm_start(words_buf, lens)
        self._warm_start_words = len(parts)
        return len(parts)

    def _byte_patterns(self) -> list[bytes]:
        """Byte patterns whose presence in a text's bytes is a superset of
        any possible added-token match: each token's UTF-8 bytes, and for a
        token with non-ASCII chars its byte-level-alphabet inverse too
        (added tokens are matched against the byte-level words)."""
        inv = unicode_to_bytes()
        pats: set[bytes] = set()
        for t in self.added_tokens:
            pats.add(t.encode("utf-8"))
            if any(ord(c) >= 128 for c in t) and all(c in inv for c in t):
                pats.add(bytes(inv[c] for c in t))
        return sorted(pats)

    def _added_route_flags(self, data: list[bytes]):
        """Per-text flags over the bytes to be encoded: True where an added
        token may match (the oracle encodes that text).  None when there are
        no added tokens.  The native multi-pattern scan."""
        if not self.added_tokens:
            return None
        from .native import match_any

        return match_any(data, self._added_patterns)

    def _prepare_bytes(self, normalized: list[str]) -> list[bytes]:
        """The UTF-8 bytes the pre-tokenizer splits: the input of the fast
        tiers and of the added-token scan."""
        aps = self.pre_tokenizer.add_prefix_space
        out = []
        for t in normalized:
            if aps and t and not t.startswith(" "):
                t = " " + t
            out.append(t.encode("utf-8"))
        return out

    def _encode_row_exact(self, text: str, raw: bool) -> list[int]:
        """The oracle for a row the native pass flagged back (an added-token
        candidate, or a non-ASCII row it left to the normalizer).  ``raw`` =
        not normalized yet."""
        return self._encode_host(text, already_normalized=not raw)

    def _encode_native(self, texts: list[str], native, wp) -> list[list[int]]:
        """Native batch encode; with ``wp`` (backend="auto") the device
        fills the word caches in the background."""
        # every loaded normalizer is a Unicode form, the identity on ASCII:
        # the native pass takes the raw strings and flags non-ASCII rows back
        ascii_norm = self.normalizer is not None
        pats = self._added_patterns if self.added_tokens else None
        aps = self.pre_tokenizer.add_prefix_space
        if wp is not None:
            # the background scan sees the normalized bytes the encode
            # tokenizes
            wp.maybe_fill_async(
                lambda: self._prepare_bytes([self._normalize(t) for t in texts])
            )
        rows = native.encode_rows_fused(texts, aps, pats, ascii_norm=ascii_norm)
        if wp is not None:
            wp.batch_done()
        if rows is not None:
            return [
                r if r is not None else self._encode_row_exact(texts[i], ascii_norm)
                for i, r in enumerate(rows)
            ]
        # the bytes route, without the extension
        normalized = [self._normalize(t) for t in texts]
        raw, offsets, counts = native._encode_batch_raw(
            self._prepare_bytes(normalized), None, pats
        )
        out = []
        for i, c in enumerate(counts.tolist()):
            if c >= 0:
                a = int(offsets[i])
                out.append(raw[a : a + c].tolist())
            else:  # added-token candidate
                out.append(self._encode_host(normalized[i], already_normalized=True))
        return out

    def _encode_native_ragged(self, texts: list[str], native, wp):
        """:meth:`_encode_native` with ragged output."""
        ascii_norm = self.normalizer is not None
        pats = self._added_patterns if self.added_tokens else None
        aps = self.pre_tokenizer.add_prefix_space
        if wp is not None:
            wp.maybe_fill_async(
                lambda: self._prepare_bytes([self._normalize(t) for t in texts])
            )
        fused = native.encode_ragged_fused(texts, aps, pats, ascii_norm=ascii_norm)
        if wp is not None:
            wp.batch_done()
        if fused is not None:
            flat, offs, flagged, nonascii = fused
            if not flagged and not nonascii:
                return flat, offs
            redo = set(flagged or ()) | set(nonascii or ())
            return _ragged_from_parts([
                np.asarray(self._encode_row_exact(texts[i], ascii_norm), np.int32)
                if i in redo else flat[offs[i] : offs[i + 1]]
                for i in range(len(texts))
            ])
        normalized = [self._normalize(t) for t in texts]
        raw, offsets, counts = native._encode_batch_raw(
            self._prepare_bytes(normalized), None, pats
        )
        if len(texts) == 0 or counts.min() >= 0:
            return native.compact(raw, offsets, counts)
        return _ragged_from_parts([
            raw[offsets[i] : offsets[i] + c] if c >= 0
            else np.asarray(self._encode_host(normalized[i], already_normalized=True), np.int32)
            for i, c in enumerate(counts.tolist())
        ])

    # ------------------------------------------------------------------
    # device tier

    def device_tables(self) -> DeviceTables:
        """The numpy encode tables, built once per tokenizer."""
        with self._build_lock:
            if self._tables is None:
                self._tables = build_device_tables(self.bpe)
            return self._tables

    def pipeline(self, device=None) -> EncodePipeline:
        """The device pipeline on ``device`` (``cuda`` by default), built
        once per device: the tables on the card, and the text-level encode
        ``encode_bytes``."""
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        with self._build_lock:
            if dev not in self._pipelines:
                self._pipelines[dev] = build_encode_pipeline(self, dev)
            return self._pipelines[dev]

    def _get_word_path(self, device=None) -> DeviceWordEncoder:
        """The word-path encoder on ``device``, shared by ``backend="device"``
        and ``"auto"``.  Builds the device tables first, so a table the
        device path does not run raises ``NotImplementedError``."""
        dev = self.pipeline(device).device
        with self._build_lock:
            if dev not in self._word_paths:
                self._word_paths[dev] = build_word_encoder(self, dev)
            return self._word_paths[dev]

    def _auto_word_path(self, device=None) -> DeviceWordEncoder:
        """The word path of ``backend="auto"``: on the resolved device, a
        card unless the caller asked for the CPU (where the fill runs the
        kernels' plain versions)."""
        return self._get_word_path(device)

    def _device_split(self, texts: list[str]):
        """backend="device": (normalized texts, their bytes, indices of the
        texts no added token can match)."""
        normalized = [self._normalize(t) for t in texts]
        data = self._prepare_bytes(normalized)
        flags = self._added_route_flags(data)
        fast_idx = [i for i in range(len(texts)) if flags is None or not flags[i]]
        return normalized, data, fast_idx

    def encode_batch(
        self, texts: list[str], backend: str = "auto", device=None
    ) -> list[list[int]]:
        """Batch encode (see the module note for the backends)."""
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
        dev = resolve_device(device) if backend in ("auto", "device") else None
        if backend in ("auto", "native"):
            native = self._get_native_encoder()
            if native is not None:
                wp = self._auto_word_path(dev) if backend == "auto" else None
                return self._encode_native(texts, native, wp)
        if backend in ("auto", "device"):
            wp = self._get_word_path(dev)
            normalized, data, fast_idx = self._device_split(texts)
            out: list[list[int] | None] = [None] * len(texts)
            if fast_idx:
                encoded = wp.encode_batch([data[i] for i in fast_idx])
                for i, ids in zip(fast_idx, encoded):
                    out[i] = ids
            return [
                ids if ids is not None else self._encode_host(normalized[i], already_normalized=True)
                for i, ids in enumerate(out)
            ]
        return [self._encode_host(t) for t in texts]

    def encode_batch_ragged(self, texts: list[str], backend: str = "auto", device=None):
        """Batch encode into (flat ids int32, row offsets int64 [n + 1]):
        row i's ids are ``flat[offsets[i]:offsets[i + 1]]``."""
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
        dev = resolve_device(device) if backend in ("auto", "device") else None
        if backend in ("auto", "native"):
            native = self._get_native_encoder()
            if native is not None:
                wp = self._auto_word_path(dev) if backend == "auto" else None
                return self._encode_native_ragged(texts, native, wp)
        if backend == "device":
            wp = self._get_word_path(dev)
            _normalized, data, fast_idx = self._device_split(texts)
            if len(fast_idx) == len(texts):
                return wp.encode_batch_ragged(data)
        return _ragged_from_parts(
            [np.asarray(r, np.int32) for r in self.encode_batch(texts, backend, device)]
        )


def _ragged_from_parts(parts):
    """(flat int32, offsets int64) from per-row id arrays."""
    offsets = np.zeros(len(parts) + 1, np.int64)
    np.cumsum([len(p) for p in parts], out=offsets[1:])
    flat = np.concatenate(parts).astype(np.int32) if offsets[-1] else np.zeros(0, np.int32)
    return flat, offsets

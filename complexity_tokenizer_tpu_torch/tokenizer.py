"""The Tokenizer: tokenizer.json loading, the host oracle, the native
runtime, the device word path and the decoders.

Backends of ``encode_batch`` and ``encode_batch_ragged``, as in the JAX
package:

- ``"auto"`` (the default): the native runtime encodes every text through
  its word caches, while the device merges the distinct words the caches
  miss in the background (``ops/wordpath.py``, asynchronous fill);
- ``"device"``: the device merges the batch's missing words first, then
  the native runtime assembles each text from the caches;
- ``"native"``: the native runtime alone;
- ``"host"``: the pure-Python oracle.

The native and device tiers run the GPT-2 ``ByteLevel`` pre-tokenizer over
a non-empty vocabulary.  For any other configuration (``Split``,
``Metaspace``, ``Sequence``, ...) ``"auto"`` and ``"native"`` go to the
oracle, as in the JAX package, decided from the configuration, and
``"device"`` raises ``NotImplementedError``.  ``"auto"`` and ``"device"``
run on ``cuda`` unless the caller passes ``device="cpu"``, where every
kernel wrapper runs its plain version.  Texts that may hold an added token
go to the oracle, which splits on added tokens.  Nothing falls back.  The
text-level pipeline (pre-split, K1, K2 or K5 over whole texts) stays
available as ``Tokenizer.pipeline(device).encode_bytes``.

Decode (``decode*``, ``batch_decode``) routes as the JAX package does: the
native ByteLevel decoder first; where it is not eligible (another decoder,
an empty vocabulary or ids past 2,000,000), a batch of 8 rows or more with
a ByteLevel decoder goes to the device pipeline (``decode_pipeline``,
kernel K7); the rest to the host decoders.
"""

from __future__ import annotations

import json
import threading

import numpy as np
import torch

from .core import decoders as D
from .core.bpe import BpeTokenizer
from .core.normalizers import UNICODE_FORMS
from .core.pretokenizers import ByteLevel
from .hf.loading import AddedToken, TokenizerSpec, load_spec
from .ops.decode import DecodePipeline, DecodeTables, decode_arena, special_mask
from .ops.pipeline import EncodePipeline, build_encode_pipeline
from .ops.tables import DeviceTables, build_device_tables, byte_token_table
from .ops.wordpath import DeviceWordEncoder, build_word_encoder
from .utils.bytelevel import unicode_to_bytes
from .utils.device import resolve_device
from .utils.unicode_tables import whitespace_set

__all__ = ["Tokenizer"]

BACKENDS = ("auto", "device", "native", "host")

# the native decoder takes id spaces up to this largest id
_NATIVE_DECODE_MAX_ID = 2_000_000

# the reference's cleanup table (clean_up_tokenization_spaces)
_CLEANUP = (
    (" .", "."), (" ,", ","), (" !", "!"), (" ?", "?"), (" :", ":"), (" ;", ";"),
    ('" ', '"'), (' "', '"'), ("' ", "'"), (" '", "'"), ("( ", "("), (" )", ")"),
    ("[ ", "["), (" ]", "]"), (" - ", "-"),
)


def _split_whitespace_join(text: str) -> str:
    """Split on White_Space runs and join with single spaces."""
    ws = whitespace_set()
    parts, cur = [], []
    for ch in text:
        if ch in ws:
            if cur:
                parts.append("".join(cur))
                cur = []
        else:
            cur.append(ch)
    if cur:
        parts.append("".join(cur))
    return " ".join(parts)


class Tokenizer:
    # below this vocabulary size, pre-merging the vocabulary into the word
    # caches costs more than it saves
    _WARM_START_MIN_VOCAB = 4096

    def __init__(self, spec: TokenizerSpec):
        self.bpe = BpeTokenizer(spec.vocab, spec.merges)
        # id -> token of the model vocabulary (added tokens outside it have
        # no token, as in the JAX package's Vocab)
        self.id_to_token_map: dict[int, str] = {v: k for k, v in spec.vocab.items()}
        self.normalizer = spec.normalizer
        self.pre_tokenizer = spec.pre_tokenizer
        self.decoder = spec.decoder
        self.added_tokens: dict[str, int] = {}
        self.added_tokens_config: dict[str, AddedToken] = {}
        self.special_tokens: dict[str, int] = {}
        for t in spec.added_tokens:
            self._register_added(t)
        # serialises the one-time builds (native contexts, tables, word
        # path, decode pipelines) and their invalidation between threads
        self._build_lock = threading.RLock()
        self._invalidate_pipeline()

    @staticmethod
    def from_str(s: str) -> "Tokenizer":
        return Tokenizer(load_spec(json.loads(s)))

    @staticmethod
    def from_buffer(buf: bytes) -> "Tokenizer":
        return Tokenizer(load_spec(json.loads(buf.decode("utf-8"))))

    @staticmethod
    def from_file(path) -> "Tokenizer":
        with open(path, "r", encoding="utf-8") as f:
            tok = Tokenizer(load_spec(json.load(f)))
        if len(tok.bpe.vocab) >= Tokenizer._WARM_START_MIN_VOCAB:
            # loading pays the native build and the warm start, not the
            # first batch
            tok._get_native_encoder()
        return tok

    def _invalidate_pipeline(self) -> None:
        """Drop everything built from the configuration: the device tables,
        pipelines and word paths, the decode tables and pipelines, the native
        encoder and decoder, and the added-token byte patterns.  The next
        call that needs one builds it again."""
        with self._build_lock:
            self._tables: DeviceTables | None = None
            self._pipelines: dict[torch.device, EncodePipeline] = {}
            self._word_paths: dict[torch.device, DeviceWordEncoder] = {}
            self._decode_arena_cache = None
            self._decode_pipelines: dict[torch.device, DecodePipeline] = {}
            self._native = None
            self._native_built = False
            self._warm_started = False
            self._warm_start_words = 0
            self._native_decoder = None
            self._native_decoder_built = False
            self._added_patterns_cache: list[bytes] | None = None

    # ------------------------------------------------------------------
    # added tokens

    def _register_added(self, token: AddedToken) -> None:
        if not token.content:
            raise ValueError("an added token's content is empty")
        self.added_tokens[token.content] = token.id
        self.added_tokens_config[token.content] = token
        if token.special:
            self.special_tokens[token.content] = token.id

    def add_token(self, content: str, tid: int, special: bool) -> None:
        self._register_added(AddedToken(content, tid, special, normalized=not special))
        self._invalidate_pipeline()

    def add_token_with_config(
        self, content: str, tid: int, special: bool,
        single_word: bool = False, lstrip: bool = False, rstrip: bool = False,
    ) -> None:
        self._register_added(
            AddedToken(content, tid, special, single_word=single_word, lstrip=lstrip,
                       rstrip=rstrip, normalized=not special)
        )
        self._invalidate_pipeline()

    def add_tokens(self, tokens) -> None:
        """``tokens``: (content, id, special) triples."""
        for content, tid, special in tokens:
            self.add_token(content, tid, special)

    @staticmethod
    def _find_added_token(text: str, token: str, config: AddedToken) -> int | None:
        """The first occurrence of ``token`` in ``text`` if it passes the
        token's flags, else None.  Only the first occurrence is tested, as
        in the reference: a later one that would pass is not searched for."""
        pos = text.find(token)
        if pos < 0:
            return None
        end = pos + len(token)
        if config.single_word:
            before_ok = pos == 0 or not text[pos - 1].isalnum()
            after_ok = end >= len(text) or not text[end].isalnum()
            if not (before_ok and after_ok):
                return None
        ws = whitespace_set()
        if config.lstrip and pos > 0 and text[pos - 1] not in ws:
            return None
        if config.rstrip and end < len(text) and text[end] not in ws:
            return None
        return pos

    def _find_next_added_token_in_word(self, text: str) -> int:
        """The first position > 0 where an added token matches, else
        ``len(text)``."""
        min_pos = len(text)
        for token, config in self.added_tokens_config.items():
            pos = self._find_added_token(text, token, config)
            if pos is not None and pos > 0:
                min_pos = min(min_pos, pos)
        return min_pos

    @property
    def _added_patterns(self) -> list[bytes]:
        """Byte patterns whose presence in a text's bytes is a superset of
        any possible added-token match: each token's UTF-8 bytes, and for a
        token with non-ASCII chars its byte-level-alphabet inverse too
        (added tokens are matched against the byte-level words)."""
        with self._build_lock:
            if self._added_patterns_cache is None:
                inv = unicode_to_bytes()
                pats: set[bytes] = set()
                for t in self.added_tokens:
                    pats.add(t.encode("utf-8"))
                    if any(ord(c) >= 128 for c in t) and all(c in inv for c in t):
                        pats.add(bytes(inv[c] for c in t))
                self._added_patterns_cache = sorted(pats)
            return self._added_patterns_cache

    def _added_route_flags(self, data: list[bytes]):
        """Per-text flags over the bytes to be encoded: True where an added
        token may match (the oracle encodes that text).  None when there are
        no added tokens.  The native multi-pattern scan."""
        if not self.added_tokens:
            return None
        from .native import match_any

        return match_any(data, self._added_patterns)

    # ------------------------------------------------------------------
    # host tier (the oracle)

    @property
    def _norm_ascii_ok(self) -> bool:
        """True when the normalizer is the identity on ASCII text."""
        return isinstance(self.normalizer, UNICODE_FORMS)

    def _normalize(self, text: str) -> str:
        norm = self.normalizer
        if norm is None or (self._norm_ascii_ok and text.isascii()):
            return text
        return norm.normalize(text)

    def _normalize_batch(self, texts: list[str]) -> list[str]:
        return [self._normalize(t) for t in texts]

    def _encode_host(self, text: str, already_normalized: bool = False) -> list[int]:
        """Reference-exact scalar encode: pre-tokenize, then match added
        tokens inside each word (honouring their flags), BPE-encoding what
        lies between."""
        normalized = text if already_normalized else self._normalize(text)
        words = self.pre_tokenizer.pre_tokenize(normalized) if self.pre_tokenizer else [normalized]
        result: list[int] = []
        for word in words:
            remaining = word
            while remaining:
                best = None  # (token, id), the longest added token matching at 0
                for token, config in self.added_tokens_config.items():
                    if self._find_added_token(remaining, token, config) == 0 and (
                        best is None or len(token) > len(best[0])
                    ):
                        best = (token, self.added_tokens[token])
                if best is not None:
                    result.append(best[1])
                    remaining = remaining[len(best[0]) :]
                    continue
                next_pos = self._find_next_added_token_in_word(remaining)
                if 0 < next_pos < len(remaining):
                    result.extend(self.bpe.encode(remaining[:next_pos]))
                    remaining = remaining[next_pos:]
                else:
                    result.extend(self.bpe.encode(remaining))
                    break
        return result

    def encode(self, text: str) -> list[int]:
        """Encode one text: the native runtime in one call where it runs the
        configuration and no added token can match, else the oracle."""
        normalized = self._normalize(text)
        native = self._get_native_encoder()
        if native is not None:
            pats = self._added_patterns if self.added_tokens else None
            ids = native.encode_one_fused(normalized, self._byte_level_prefix_space(), pats)
            if ids is not None:
                return ids
        return self._encode_host(normalized, already_normalized=True)

    # ------------------------------------------------------------------
    # native tier

    def _fast_tiers_run(self) -> bool:
        """Whether the native and device tiers run this configuration: the
        ByteLevel pre-tokenizer over a non-empty vocabulary."""
        return isinstance(self.pre_tokenizer, ByteLevel) and bool(self.bpe.vocab)

    def _byte_level_prefix_space(self) -> bool:
        pt = self.pre_tokenizer
        return isinstance(pt, ByteLevel) and pt.add_prefix_space

    def _get_native_encoder(self):
        """The native (C++) encoder, built and warm-started once; None where
        the native tier does not run the configuration.  Raises when the
        native runtime cannot be built."""
        with self._build_lock:
            if not self._native_built:
                native = None
                if self._fast_tiers_run():
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

    def _prepare_bytes(self, normalized: list[str]) -> list[bytes]:
        """The UTF-8 bytes the pre-tokenizer splits: the input of the fast
        tiers and of the added-token scan."""
        aps = self._byte_level_prefix_space()
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

    def _native_inputs(self, texts: list[str]):
        """(texts for the native pass, ascii_norm): a Unicode-form normalizer
        is the identity on ASCII, so the native pass takes the raw strings
        and flags non-ASCII rows back; any other normalizer runs first."""
        ascii_norm = self.normalizer is not None and self._norm_ascii_ok
        if self.normalizer is None or ascii_norm:
            return texts, ascii_norm
        return [self.normalizer.normalize(t) for t in texts], False

    def _encode_native(self, texts: list[str], native, wp) -> list[list[int]]:
        """Native batch encode; with ``wp`` (backend="auto") the device
        fills the word caches in the background."""
        normalized, ascii_norm = self._native_inputs(texts)
        pats = self._added_patterns if self.added_tokens else None
        aps = self._byte_level_prefix_space()
        if wp is not None:
            # the background scan sees the normalized bytes the encode
            # tokenizes
            wp.maybe_fill_async(lambda: self._prepare_bytes(self._normalize_batch(texts)))
        rows = native.encode_rows_fused(normalized, aps, pats, ascii_norm=ascii_norm)
        if wp is not None:
            wp.batch_done()
        if rows is not None:
            return [
                r if r is not None else self._encode_row_exact(normalized[i], ascii_norm)
                for i, r in enumerate(rows)
            ]
        # the bytes route, without the extension
        normalized = self._normalize_batch(texts)
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
        normalized, ascii_norm = self._native_inputs(texts)
        pats = self._added_patterns if self.added_tokens else None
        aps = self._byte_level_prefix_space()
        if wp is not None:
            wp.maybe_fill_async(lambda: self._prepare_bytes(self._normalize_batch(texts)))
        fused = native.encode_ragged_fused(normalized, aps, pats, ascii_norm=ascii_norm)
        if wp is not None:
            wp.batch_done()
        if fused is not None:
            flat, offs, flagged, nonascii = fused
            if not flagged and not nonascii:
                return flat, offs
            redo = set(flagged or ()) | set(nonascii or ())
            return _ragged_from_parts([
                np.asarray(self._encode_row_exact(normalized[i], ascii_norm), np.int32)
                if i in redo else flat[offs[i] : offs[i + 1]]
                for i in range(len(texts))
            ])
        normalized = self._normalize_batch(texts)
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
        """The numpy encode tables, built once per configuration."""
        with self._build_lock:
            if self._tables is None:
                self._tables = build_device_tables(self.bpe)
            return self._tables

    @staticmethod
    def _device_key(device) -> torch.device:
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev

    def pipeline(self, device=None) -> EncodePipeline:
        """The device pipeline on ``device`` (``cuda`` by default), built
        once per device: the tables on the card, and the text-level encode
        ``encode_bytes``."""
        dev = self._device_key(device)
        with self._build_lock:
            if dev not in self._pipelines:
                self._pipelines[dev] = build_encode_pipeline(self, dev)
            return self._pipelines[dev]

    def _get_word_path(self, device=None) -> DeviceWordEncoder:
        """The word-path encoder on ``device``, shared by ``backend="device"``
        and ``"auto"``.  Builds the device tables first, so a configuration
        the device path does not run raises ``NotImplementedError``."""
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
        normalized = self._normalize_batch(texts)
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
        if backend == "device":
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

    # ------------------------------------------------------------------
    # decode

    def _decode_arena(self):
        """(arena, offsets) of the model vocabulary's raw bytes, shared by
        the native decoder and the decode pipelines."""
        with self._build_lock:
            if self._decode_arena_cache is None:
                self._decode_arena_cache = decode_arena(self.id_to_token_map)
            return self._decode_arena_cache

    def _get_native_decoder(self):
        """The native ByteLevel batch decoder; None where it is not eligible
        (another decoder, an empty vocabulary, or ids past 2,000,000).
        Raises when the native runtime cannot be built."""
        with self._build_lock:
            if not self._native_decoder_built:
                nd = None
                ids = self.id_to_token_map
                if (isinstance(self.decoder, D.ByteLevel) and ids
                        and max(ids) <= _NATIVE_DECODE_MAX_ID):
                    from .native import NativeDecoder

                    arena, offsets = self._decode_arena()
                    # specials by token string, as the JAX native decoder
                    special = np.fromiter(
                        (ids.get(i) in self.special_tokens for i in range(len(offsets) - 1)),
                        np.uint8, count=len(offsets) - 1,
                    )
                    nd = NativeDecoder(arena, offsets, special)
                self._native_decoder, self._native_decoder_built = nd, True
            return self._native_decoder

    def decode_pipeline(self, device=None) -> DecodePipeline:
        """The device decode pipeline on ``device`` (``cuda`` by default),
        built once per device, for a ByteLevel decoder (others raise
        ``NotImplementedError``)."""
        dev = self._device_key(device)
        if not isinstance(self.decoder, D.ByteLevel):
            raise NotImplementedError(
                f"the device decode runs the ByteLevel decoder, not {type(self.decoder).__name__}"
            )
        with self._build_lock:
            if dev not in self._decode_pipelines:
                arena, offsets = self._decode_arena()
                # specials by id, as the JAX decode pipeline
                special = special_mask(len(offsets) - 1, self.special_tokens.values())
                self._decode_pipelines[dev] = DecodePipeline(
                    DecodeTables(arena, offsets, special), dev
                )
            return self._decode_pipelines[dev]

    def decode(self, ids) -> str:
        return self._decode_impl(ids, False, True)

    def decode_with_options(
        self, ids, skip_special_tokens: bool = False, clean_up_tokenization_spaces: bool = True
    ) -> str:
        return self._decode_impl(ids, skip_special_tokens, clean_up_tokenization_spaces)

    def _decode_impl(self, ids, skip_special_tokens: bool, clean_up: bool) -> str:
        """The host decode of one row."""
        get = self.id_to_token_map.get
        tokens = [get(int(i)) for i in ids]
        if skip_special_tokens:
            tokens = [t for t in tokens if t is None or t not in self.special_tokens]
        tokens = [t for t in tokens if t is not None]
        text = self.decoder.decode(tokens) if self.decoder is not None else "".join(tokens)
        if clean_up:
            text = self.clean_up_tokenization_spaces(text)
        return text

    def clean_up_tokenization_spaces(self, text: str) -> str:
        """The reference's replacement table, then a whitespace collapse."""
        for a, b in _CLEANUP:
            text = text.replace(a, b)
        return _split_whitespace_join(text)

    def decode_batch(self, batch, device=None) -> list[str]:
        return self.decode_batch_with_options(batch, False, True, device)

    def decode_batch_with_options(
        self, batch, skip_special_tokens: bool = False,
        clean_up_tokenization_spaces: bool = True, device=None,
    ) -> list[str]:
        """Rows of ids -> texts (see the module note for the routes);
        ``device`` is where the device route runs."""
        batch = list(batch)
        nd = self._get_native_decoder()
        if nd is not None:
            texts, flagged = nd.decode_batch(batch, skip_special_tokens, clean_up_tokenization_spaces)
            for i in flagged:  # invalid UTF-8: the lossy host decode
                texts[i] = self._decode_impl(batch[i], skip_special_tokens, clean_up_tokenization_spaces)
            return texts
        if len(batch) >= 8 and isinstance(self.decoder, D.ByteLevel):
            texts = self.decode_pipeline(device).decode_batch(batch, skip_special_tokens)
            return self._cleaned(texts, clean_up_tokenization_spaces)
        return [
            self._decode_impl(ids, skip_special_tokens, clean_up_tokenization_spaces)
            for ids in batch
        ]

    def decode_batch_ragged(
        self, flat_ids, row_offsets, skip_special_tokens: bool = False,
        clean_up_tokenization_spaces: bool = True, device=None,
    ) -> list[str]:
        """The mirror of ``encode_batch_ragged``: rows given as (flat int32
        ids, int64 row offsets)."""
        nd = self._get_native_decoder()
        if nd is not None:
            texts, flagged = nd.decode_ragged(
                flat_ids, row_offsets, skip_special_tokens, clean_up_tokenization_spaces
            )
            for i in flagged:
                texts[i] = self._decode_impl(
                    flat_ids[row_offsets[i] : row_offsets[i + 1]],
                    skip_special_tokens, clean_up_tokenization_spaces,
                )
            return texts
        n = len(row_offsets) - 1
        if n >= 8 and isinstance(self.decoder, D.ByteLevel):
            texts = self.decode_pipeline(device).decode_ragged(flat_ids, row_offsets, skip_special_tokens)
            return self._cleaned(texts, clean_up_tokenization_spaces)
        return [
            self._decode_impl(flat_ids[row_offsets[i] : row_offsets[i + 1]],
                              skip_special_tokens, clean_up_tokenization_spaces)
            for i in range(n)
        ]

    def batch_decode(
        self, sequences, skip_special_tokens: bool = False,
        clean_up_tokenization_spaces: bool = True, device=None,
    ) -> list[str]:
        return self.decode_batch_with_options(
            sequences, skip_special_tokens, clean_up_tokenization_spaces, device
        )

    def _cleaned(self, texts: list[str], clean_up: bool) -> list[str]:
        return [self.clean_up_tokenization_spaces(t) for t in texts] if clean_up else texts


def _ragged_from_parts(parts):
    """(flat int32, offsets int64) from per-row id arrays."""
    offsets = np.zeros(len(parts) + 1, np.int64)
    np.cumsum([len(p) for p in parts], out=offsets[1:])
    flat = np.concatenate(parts).astype(np.int32) if offsets[-1] else np.zeros(0, np.int32)
    return flat, offsets

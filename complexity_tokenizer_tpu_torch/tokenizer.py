"""The Tokenizer: tokenizer.json loading, the host oracle, the native
runtime, the device word path and the decoders.

Backends of ``encode_batch`` and ``encode_batch_ragged``, as in the JAX
package (``backend=None`` means ``encode_backend``, which
``CTOK_ENCODE_BACKEND`` sets, ``"auto"`` by default):

- ``"auto"``: the native runtime encodes every text through
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

The transformers surface (``__call__``, ``encode_plus``, the ``Encoding``
routes, padding, truncation, post-processors, special tokens, chat
templates, ``save``) follows the JAX package, quirks included.
``__call__`` takes one more keyword, ``device``: where ``"pt"`` tensors
go, and where ``add_special_tokens=False`` runs ``encode_batch``.

Switches, read where the JAX package reads them: ``CTOK_ENCODE_BACKEND``
(the default backend), ``CTOK_DISABLE_DEVICE=1`` (no device path:
``"auto"`` runs the native runtime alone and decode skips the device
pipeline, as in JAX; ``backend="device"`` raises, where JAX would end on
the host), ``CTOK_AUTO_DEVICE=0`` (``"auto"`` without the background
fill), ``CTOK_WARM_START`` (``0`` off, ``1`` at any vocabulary size).  The
warm start is kept beside the tokenizer.json it was loaded from
(``<stem>.warmcache.npz``, the JAX package's format and key), so a later
``from_file`` loads it instead of merging the vocabulary again.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
import zipfile
from pathlib import Path

import numpy as np
import torch

from .batch_encoding import TENSOR_KINDS, BatchEncoding, ColumnarBatchEncoding
from .core import decoders as D
from .core.bpe import BpeTokenizer
from .core.encoding import Encoding
from .core.normalizers import UNICODE_FORMS
from .core.postprocessors import BertProcessing, RobertaProcessing, TemplateProcessing
from .core.pretokenizers import ByteLevel
from .core.vocab import Vocab
from .hf import chat as chat_mod
from .hf import hub as hub_mod
from .hf import serialization
from .hf.config import PaddingConfig, TruncationConfig
from .hf.loading import AddedToken, TokenizerSpec, load_spec
from .ops.decode import DecodePipeline, DecodeTables, decode_arena, special_mask
from .ops.pipeline import EncodePipeline, build_encode_pipeline
from .ops.tables import DeviceTables, build_device_tables, byte_token_table
from .ops.wordpath import DeviceWordEncoder, build_word_encoder
from .utils.bytelevel import bytes_to_unicode, unicode_to_bytes
from .utils.device import resolve_device
from .utils.metrics import Timer, counters
from .utils.unicode_tables import whitespace_set

__all__ = ["Tokenizer", "Encoding", "BatchEncoding"]

BACKENDS = ("auto", "device", "native", "host")

# the native decoder takes id spaces up to this largest id
_NATIVE_DECODE_MAX_ID = 2_000_000

# the reference's cleanup table (clean_up_tokenization_spaces)
_CLEANUP = (
    (" .", "."), (" ,", ","), (" !", "!"), (" ?", "?"), (" :", ":"), (" ;", ";"),
    ('" ', '"'), (' "', '"'), ("' ", "'"), (" '", "'"), ("( ", "("), (" )", ")"),
    ("[ ", "["), (" ]", "]"), (" - ", "-"),
)


# what a stale or broken warm-cache file raises when it is read
_BLOB_ERRORS = (OSError, KeyError, ValueError, zipfile.BadZipFile)


class _SpecialTokensMap(dict):
    """special token -> id; also callable, as the reference's
    ``special_tokens()`` method."""

    def __call__(self) -> dict:
        return dict(self)


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
        self.vocab = Vocab(spec.vocab, spec.named_specials)
        # id -> token of the model vocabulary (added tokens outside it have
        # no token, as in the JAX package's Vocab)
        self.id_to_token_map: dict[int, str] = self.vocab._id_to_token
        self.normalizer = spec.normalizer
        self.pre_tokenizer = spec.pre_tokenizer
        self.post_processor = spec.post_processor
        self.decoder = spec.decoder
        self.added_tokens: dict[str, int] = {}
        self.added_tokens_config: dict[str, AddedToken] = {}
        self.special_tokens: _SpecialTokensMap = _SpecialTokensMap()
        for t in spec.added_tokens:
            self._register_added(t)
        self._model_max_length = 512
        self._padding_side = "right"
        self._truncation_side = "right"
        self._chat_template: str | None = None
        self.padding_config = PaddingConfig()
        self.truncation_config = TruncationConfig(max_length=512)
        # the tokenizer.json this was loaded from: the warm-cache file sits
        # beside it
        self._source_path: str | None = None
        self.use_device: bool = os.environ.get("CTOK_DISABLE_DEVICE", "") != "1"
        self.encode_backend: str = os.environ.get("CTOK_ENCODE_BACKEND", "auto")
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
        tok._source_path = str(path)
        if len(tok.bpe.vocab) >= Tokenizer._WARM_START_MIN_VOCAB:
            # loading pays the native build and the warm start, not the
            # first batch
            tok._get_native_encoder()
        return tok

    @staticmethod
    def from_pretrained(
        repo_id: str, revision: str | None = None, local_files_only: bool = False
    ) -> "Tokenizer":
        """The tokenizer.json of ``repo_id`` in the HuggingFace cache
        (``local_files_only=True``); the port downloads nothing."""
        if not local_files_only:
            raise NotImplementedError(
                "the port has no network download: pass local_files_only=True to load "
                "from the HuggingFace cache, or use from_file"
            )
        cached = hub_mod.get_cache_path(repo_id, hub_mod.HubConfig()) / "tokenizer.json"
        if cached.exists():
            return Tokenizer.from_file(cached)
        raise IOError(f"Model '{repo_id}' not found in cache and local_files_only=true")

    def _invalidate_pipeline(self) -> None:
        """Drop everything built from the configuration: the device tables,
        pipelines and word paths, the decode tables and pipelines, the native
        encoder and decoder, the added-token byte patterns and the host
        memos of the Encoding route.  The next call that needs one builds
        it again."""
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
            self._host_word_ids_cache: dict[str, list[int]] = {}
            self._token_len_cache: dict[int, tuple[str, int]] = {}

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
        configuration and no added token can match, else the oracle (always
        the oracle when ``encode_backend`` is ``"host"``)."""
        normalized = self._normalize(text)
        native = self._get_native_encoder() if self.encode_backend != "host" else None
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
        """Vocabulary warm start: every vocabulary word's ids follow from
        the merge table alone, and the vocabulary is the head of any
        Zipf-like corpus, so merging it at load time makes a fresh
        tokenizer's caches start warm.  The merged words are kept beside
        the tokenizer.json (``_warm_cache_path``), keyed by its sha1; a
        later load inserts them from there instead of merging.  A file
        whose key matches is never written, even where its arrays are
        broken: the warm start then stays in memory.  Returns the words
        inserted."""
        flag = os.environ.get("CTOK_WARM_START", "")
        if flag == "0":
            return 0
        with self._build_lock:
            if self._warm_started:
                return 0
            if not force and flag != "1" and len(self.bpe.vocab) < self._WARM_START_MIN_VOCAB:
                return 0
            self._warm_started = True
        t0 = time.perf_counter()
        blob = self._warm_cache_path()
        key = self._warm_key()
        key_matches, loaded = (
            self._read_warm_blob(blob, key) if blob is not None and blob.exists() else (False, None)
        )
        if loaded is not None:
            native.cache_insert_flat(*loaded)
            self._warm_start_from_blob = True
            return self._warm_done(t0, len(loaded[1]))
        self._warm_start_from_blob = False
        words_buf, lens = self._vocab_words()
        if not len(lens):
            return self._warm_done(t0, 0)
        ids_flat, counts = native.warm_start(words_buf, lens)
        if blob is not None and not key_matches:
            try:
                self._write_warm_blob(blob, key, words_buf, lens, ids_flat, counts)
            except OSError:
                pass  # a read-only directory: the warm start stays in memory
        return self._warm_done(t0, len(lens))

    def _warm_done(self, t0: float, n_words: int) -> int:
        self._warm_start_s = time.perf_counter() - t0
        self._warm_start_words = n_words
        if n_words:
            counters.add("warm_start_words", n_words)
            counters.add_time("warm_start", self._warm_start_s)
        return n_words

    def _vocab_words(self, extra_words=()):
        """(words_buf uint8, lens int64): the byte strings of the
        vocabulary's tokens in the byte-level alphabet (1 to 256 bytes),
        then ``extra_words``, each once."""
        inv = unicode_to_bytes()
        seen: set[bytes] = set()
        parts: list[bytes] = []
        for tok_str in self.bpe.vocab:
            try:
                b = bytes(inv[c] for c in tok_str)
            except KeyError:
                continue  # a special or added token outside the alphabet
            if 0 < len(b) <= 256 and b not in seen:
                seen.add(b)
                parts.append(b)
        for b in extra_words or ():
            if 0 < len(b) <= 256 and b not in seen:
                seen.add(b)
                parts.append(b)
        words_buf = np.frombuffer(b"".join(parts), np.uint8)
        lens = np.fromiter((len(b) for b in parts), np.int64, count=len(parts))
        return words_buf, lens

    @staticmethod
    def _read_warm_blob(blob: Path, key: str):
        """(key_matches, arrays): whether the warm-cache file's key is
        ``key``, and its (words_buf, lens, ids_flat, counts) where the key
        matches and the arrays agree, else None."""
        key_matches = False
        try:
            with np.load(blob) as z:
                key_matches = str(z["key"]) == key
                if not key_matches:
                    return False, None
                words_buf, lens, ids_flat, counts = (
                    z[k] for k in ("words_buf", "lens", "ids_flat", "counts")
                )
        except _BLOB_ERRORS:
            return key_matches, None
        if not (len(lens) == len(counts) and int(lens.sum()) == len(words_buf)
                and int(counts.sum()) == len(ids_flat) and (lens > 0).all()
                and (counts >= 0).all()):
            return True, None
        return True, (words_buf, lens, ids_flat, counts)

    @staticmethod
    def _write_warm_blob(blob: Path, key: str, words_buf, lens, ids_flat, counts) -> None:
        # a name of this process's own, then one atomic rename: loaders
        # that recompute the same file at once do not mix their writes
        tmp = blob.with_suffix(f".tmp{os.getpid()}.npz")
        np.savez(tmp, key=key, words_buf=words_buf, lens=lens, ids_flat=ids_flat, counts=counts)
        tmp.replace(blob)

    def export_warm_cache(self, extra_words=None, path=None) -> int:
        """Write the warm-cache file (``<stem>.warmcache.npz`` beside the
        tokenizer.json, or ``path``): the merged ids of every vocabulary
        word and of ``extra_words`` (pre-split byte strings, e.g. a
        corpus's words), so that a later ``from_file`` starts its caches
        there.  Returns the words written."""
        native = self._get_native_encoder()
        if native is None:
            return 0
        blob = Path(path) if path is not None else self._warm_cache_path()
        if blob is None:
            raise ValueError("no destination: tokenizer was not loaded from a file; pass path=")
        words_buf, lens = self._vocab_words(extra_words)
        if not len(lens):
            return 0
        ids_flat, counts = native.warm_start(words_buf, lens)
        self._write_warm_blob(blob, self._warm_key(), words_buf, lens, ids_flat, counts)
        self._warm_started = True  # this process's caches now hold it all
        return len(lens)

    def _warm_cache_path(self) -> Path | None:
        if not self._source_path:
            return None
        p = Path(self._source_path)
        return p.parent / (p.stem + ".warmcache.npz")

    def _warm_key(self) -> str:
        """The key of a warm-cache file: the sha1 of the tokenizer.json it
        was loaded from, else a digest of the merge table."""
        if self._source_path:
            try:
                h = hashlib.sha1()
                with open(self._source_path, "rb") as f:
                    for chunk in iter(lambda: f.read(1 << 20), b""):
                        h.update(chunk)
                return h.hexdigest()
            except OSError:
                pass
        return self._vocab_digest()

    def _vocab_digest(self) -> str:
        """A digest of (vocabulary size, merges), as the JAX package's."""
        h = hashlib.sha1()
        h.update(str(len(self.bpe.vocab)).encode())
        arr = np.array(
            [(r, ab[0], ab[1], new_id) for r, (ab, new_id) in sorted(self.bpe.merge_ops.items())],
            dtype=np.int64,
        )
        h.update(arr.tobytes())
        return h.hexdigest()

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
        the device path does not run raises ``NotImplementedError``; raises
        ``RuntimeError`` when ``CTOK_DISABLE_DEVICE=1`` turned the device
        path off."""
        self._require_device_on()
        dev = self.pipeline(device).device
        with self._build_lock:
            if dev not in self._word_paths:
                self._word_paths[dev] = build_word_encoder(self, dev)
            return self._word_paths[dev]

    def _require_device_on(self) -> None:
        if not self.use_device:
            raise RuntimeError(
                "the device path is off (CTOK_DISABLE_DEVICE=1): backend='device' does not "
                "run; 'auto' and 'native' run the native runtime"
            )

    def _auto_device_on(self) -> bool:
        """Whether ``backend="auto"`` fills the word caches on the device:
        not with ``CTOK_DISABLE_DEVICE=1`` or ``CTOK_AUTO_DEVICE=0``."""
        return self.use_device and os.environ.get("CTOK_AUTO_DEVICE", "") != "0"

    def _auto_word_path(self, device=None) -> DeviceWordEncoder | None:
        """The word path of ``backend="auto"``: on the resolved device, a
        card unless the caller asked for the CPU (where the fill runs the
        kernels' plain versions); None when the switches turned it off."""
        if not self._auto_device_on():
            return None
        return self._get_word_path(device)

    def _device_split(self, texts: list[str]):
        """backend="device": (normalized texts, their bytes, indices of the
        texts no added token can match)."""
        normalized = self._normalize_batch(texts)
        data = self._prepare_bytes(normalized)
        flags = self._added_route_flags(data)
        fast_idx = [i for i in range(len(texts)) if flags is None or not flags[i]]
        return normalized, data, fast_idx

    def _backend(self, backend: str | None, device):
        """(backend, device): ``None`` means ``encode_backend``; the device
        is resolved where the backend will use one."""
        backend = backend or self.encode_backend
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
        if backend == "device":
            self._require_device_on()
        if backend == "device" or (backend == "auto" and self._auto_device_on()):
            return backend, resolve_device(device)
        return backend, None

    def encode_batch(
        self, texts: list[str], backend: str | None = None, device=None
    ) -> list[list[int]]:
        """Batch encode (see the module note for the backends)."""
        backend, dev = self._backend(backend, device)
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

    def encode_batch_ragged(self, texts: list[str], backend: str | None = None, device=None):
        """Batch encode into (flat ids int32, row offsets int64 [n + 1]):
        row i's ids are ``flat[offsets[i]:offsets[i + 1]]``."""
        with Timer("encode_texts", count=len(texts)):
            return self._encode_batch_ragged_impl(texts, backend, device)

    def _encode_batch_ragged_impl(self, texts: list[str], backend, device):
        backend, dev = self._backend(backend, device)
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
            [np.asarray(r, np.int32) for r in self.encode_batch(texts, backend, dev)]
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
        if len(batch) >= 8 and isinstance(self.decoder, D.ByteLevel) and self.use_device:
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
        with Timer("decode_texts", count=max(len(row_offsets) - 1, 0)):
            return self._decode_batch_ragged_impl(
                flat_ids, row_offsets, skip_special_tokens, clean_up_tokenization_spaces, device
            )

    def _decode_batch_ragged_impl(
        self, flat_ids, row_offsets, skip_special_tokens: bool,
        clean_up_tokenization_spaces: bool, device,
    ) -> list[str]:
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
        if n >= 8 and isinstance(self.decoder, D.ByteLevel) and self.use_device:
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

    # ------------------------------------------------------------------
    # the Encoding routes (offsets, word ids)

    def encode_to_encoding(self, text: str) -> Encoding:
        return self._encode_to_encoding_impl(text, None, None, None)

    def encode_pair_to_encoding(self, text: str, text_pair: str) -> Encoding:
        return self._encode_to_encoding_impl(text, text_pair, None, None)

    def encode_to_encoding_with_truncation(
        self, text: str, text_pair: str | None, max_length: int, stride: int
    ) -> Encoding:
        return self._encode_to_encoding_impl(text, text_pair, max_length, stride)

    def encode_with_truncation(
        self, text: str, text_pair: str | None = None, max_length: int = 512, stride: int = 0
    ) -> Encoding:
        return self._encode_to_encoding_impl(text, text_pair, max_length, stride)

    def _encode_to_encoding_impl(self, text, text_pair, max_length, stride) -> Encoding:
        encoding = self._encode_single_to_encoding(text, 0)
        if text_pair is not None:
            encoding.merge(self._encode_single_to_encoding(text_pair, 1), 1)
        # as the reference: the pair is merged before post-processing, so
        # the single template frames both
        processed = (
            self.post_processor.process(list(encoding.ids), None)
            if self.post_processor is not None else list(encoding.ids)
        )
        added = len(processed) - len(encoding.ids)
        encoding.ids = processed
        encoding.attention_mask += [1] * added
        encoding.special_tokens_mask += [1] * added
        encoding.type_ids += [0] * added
        encoding.mark_special_tokens(list(self.special_tokens.values()))
        if max_length is not None and len(encoding) > max_length:
            encoding.truncate_with_stride(max_length, stride or 0)
        return encoding

    def _encode_single_to_encoding(self, text: str, type_id: int) -> Encoding:
        """One text with offsets, as the reference's offset route: no
        added-token matching; a token's offsets are its byte length from the
        previous token's end, clamped to its word's span in the original
        text's bytes."""
        normalized = self.normalizer.normalize(text) if self.normalizer else text
        words_with_offsets = self._pre_tokenize_with_offsets(normalized, text)
        # word -> ids and id -> (token, byte length): natural text repeats
        wcache = self._host_word_ids_cache
        tcache = self._token_len_cache
        bpe_encode = self.bpe.encode
        get_token = self.vocab.get_token
        ids, tokens, offsets, word_ids = [], [], [], []
        for word_idx, (word, word_start, word_end) in enumerate(words_with_offsets):
            word_ids_part = wcache.get(word)
            if word_ids_part is None:
                word_ids_part = wcache[word] = bpe_encode(word)
            token_char_offset = word_start
            for tid in word_ids_part:
                ids.append(tid)
                tl = tcache.get(tid)
                if tl is None:
                    token_str = get_token(tid) or ""
                    tl = tcache[tid] = (token_str, len(token_str.encode("utf-8")))
                token_str, token_byte_len = tl
                token_end = min(token_char_offset + token_byte_len, word_end)
                offsets.append((token_char_offset, token_end))
                token_char_offset = token_end
                tokens.append(token_str)
                word_ids.append(word_idx)
        n = len(ids)
        return Encoding(
            ids=ids,
            type_ids=[type_id] * n,
            tokens=tokens,
            attention_mask=[1] * n,
            special_tokens_mask=[0] * n,
            offsets=offsets,
            word_ids=word_ids,
            sequence_ids=[type_id] * n,
            overflowing=[],
        )

    def _pre_tokenize_with_offsets(self, normalized: str, original: str):
        """(word, start, end): each word with its byte span in the original
        text, found by searching forward for the word without its leading
        space marker."""
        words = self._pre_tokenize_fast(normalized)
        if words is None:
            words = self.pre_tokenizer.pre_tokenize(normalized) if self.pre_tokenizer else [normalized]
        result = []
        original_b = original.encode("utf-8")
        search_start = 0
        for word in words:
            trimmed = word.lstrip("Ġ▁")
            find_b = (trimmed if trimmed else word).encode("utf-8")
            pos = original_b.find(find_b, search_start) if find_b else -1
            if pos >= 0:
                start = pos
                end = start + len(find_b)
            else:
                start = search_start
                end = min(start + len(word.encode("utf-8")), len(original_b))
            result.append((word, start, end))
            search_start = end
        return result

    def _pre_tokenize_fast(self, normalized: str) -> list[str] | None:
        """The ByteLevel pre-tokenizer through the native runtime's word
        boundaries (``split_words``) and one latin-1 translate a word: the
        words of ``ByteLevel.pre_tokenize``.  None where the native tier does
        not run the configuration or has no extension."""
        if not isinstance(self.pre_tokenizer, ByteLevel):
            return None
        native = self._get_native_encoder()
        if native is None:
            return None
        from .native import load_ext

        ext = load_ext()
        if ext is None:
            return None
        table = getattr(self, "_bl_translate", None)
        if table is None:
            enc = bytes_to_unicode()
            table = self._bl_translate = str.maketrans({chr(b): enc[b] for b in range(256)})
        aps = self.pre_tokenizer.add_prefix_space
        bounds = np.frombuffer(ext.split_words(native._ctx, normalized, int(aps)), np.int64)
        data = normalized.encode("utf-8")
        if aps and data and not normalized.startswith(" "):
            data = b" " + data
        return [
            data[bounds[i] : bounds[i + 1]].decode("latin-1").translate(table)
            for i in range(len(bounds) - 1)
        ]

    def encode_plus(self, text: str) -> Encoding:
        return self.encode_to_encoding(text)

    def batch_encode_plus(self, texts) -> list[Encoding]:
        return self.encode_batch_to_encoding(texts)

    def encode_batch_to_encoding(self, texts) -> list[Encoding]:
        # the native route builds the same Encodings, offsets and word ids
        # deferred to their first read
        texts = list(texts)
        fast = self._call_batch_fast(texts, True)
        if fast is not None:
            return fast
        return [self.encode_to_encoding(t) for t in texts]

    def encode_batch_pairs_to_encoding(self, pairs) -> list[Encoding]:
        return [self.encode_pair_to_encoding(a, b) for a, b in pairs]

    def _pad_id_token(self):
        pad_id = self.special_tokens.get("[PAD]")
        if pad_id is None:
            pad_id = self.special_tokens.get("<pad>")
        if pad_id is None:
            pad_id = 0
        return pad_id, self.vocab.get_token(pad_id) or "<pad>"

    def _pad_all(self, encs, max_length, pad_left):
        target = max_length if max_length is not None else max((len(e) for e in encs), default=0)
        pad_id, pad_token = self._pad_id_token()
        for e in encs:
            e.pad(target, pad_id, pad_token, pad_left)
        return encs

    def encode_batch_with_padding(
        self, texts, max_length: int | None = None, pad_left: bool = False
    ) -> list[Encoding]:
        return self._pad_all([self.encode_to_encoding(t) for t in texts], max_length, pad_left)

    def encode_batch_pairs_with_padding(
        self, pairs, max_length: int | None = None, pad_left: bool = False
    ) -> list[Encoding]:
        return self._pad_all(
            [self.encode_pair_to_encoding(a, b) for a, b in pairs], max_length, pad_left
        )

    # ------------------------------------------------------------------
    # the transformers-style __call__

    def __call__(
        self,
        text,
        text_pair=None,
        add_special_tokens: bool = True,
        padding: str | None = None,
        truncation: bool = False,
        max_length: int | None = None,
        stride: int = 0,
        return_attention_mask: bool = True,
        return_token_type_ids: bool = True,
        return_offsets_mapping: bool = False,
        return_special_tokens_mask: bool = False,
        return_tensors: str | None = None,
        device=None,
    ) -> BatchEncoding:
        """Encode a text or a batch into a :class:`BatchEncoding`.

        Routes, as the JAX package: a batch with ``add_special_tokens``
        and no offsets takes the columnar route (the native ragged encode
        and a static post-processor frame, no Encoding per row) where the
        frame is static; else the native batch route with offsets deferred;
        else one Encoding a text.  ``add_special_tokens=True`` skips
        added-token matching and ``truncation_side`` is not read, as in the
        reference.  ``add_special_tokens=False`` encodes through
        ``encode_batch`` (added tokens honoured), on ``device`` for the
        ``"auto"`` and ``"device"`` backends.  ``return_tensors="pt"`` gives
        int32 tensors on ``device`` (``cuda`` unless ``"cpu"``)."""
        if return_tensors not in TENSOR_KINDS:
            raise ValueError("return_tensors must be None, 'np' or 'pt'")
        dev = resolve_device(device) if return_tensors == "pt" else None
        if isinstance(text, (list, tuple)):
            texts = list(text)
            pairs = None
            if text_pair is not None:
                if not isinstance(text_pair, (list, tuple)):
                    raise TypeError("text_pair must be a list when text is a list")
                pairs = list(text_pair)
                if len(pairs) != len(texts):
                    raise ValueError(
                        f"text and text_pair lengths differ ({len(texts)} vs {len(pairs)})"
                    )
            if pairs is not None:
                encs = [self._call_one(a, b, add_special_tokens) for a, b in zip(texts, pairs)]
            else:
                if add_special_tokens and not return_offsets_mapping:
                    cbe = self._call_batch_columnar(
                        texts, padding, truncation,
                        max_length if max_length is not None else self._model_max_length,
                        stride, return_attention_mask, return_token_type_ids,
                        return_special_tokens_mask,
                    )
                    if cbe is not None:
                        cbe._tensor_kind, cbe._device = return_tensors, dev
                        return cbe
                encs = self._call_batch_fast(texts, add_special_tokens, device)
                if encs is None:
                    encs = [self._call_one(t, None, add_special_tokens) for t in texts]
        elif isinstance(text, str):
            encs = [self._call_one(text, text_pair, add_special_tokens)]
        else:
            raise TypeError("Expected str or List[str]")

        max_len = max_length if max_length is not None else self._model_max_length
        if truncation:
            for e in encs:
                if len(e) > max_len:
                    if stride > 0:
                        e.truncate_with_stride(max_len, stride)
                    else:
                        e.truncate(max_len)
        if padding is not None:
            pad_to = max_len if padding == "max_length" else max((len(e) for e in encs), default=0)
            pad_id, pad_token = self._pad_id_token()
            pad_left = padding == "left" or self._padding_side == "left"
            for e in encs:
                e.pad(pad_to, pad_id, pad_token, pad_left)
        be = BatchEncoding(
            encs, return_attention_mask, return_token_type_ids,
            return_offsets_mapping, return_special_tokens_mask,
        )
        be._tensor_kind, be._device = return_tensors, dev
        return be

    def _id_to_token_list(self) -> list:
        """Dense id -> token list (None in the gaps) for fast gathers."""
        cached = getattr(self, "_id2tok_cache", None)
        n = len(self.vocab)
        if cached is not None and cached[0] == n:
            return cached[1]
        id2tok = self.vocab._id_to_token
        size = (max(id2tok) + 1) if id2tok else 0
        lst = [None] * size
        for i, t in id2tok.items():
            if 0 <= i < size:
                lst[i] = t
        self._id2tok_cache = (n, lst)
        return lst

    def _call_batch_fast(self, texts, add_special_tokens, device=None) -> list | None:
        """The Encodings of a batch through the native runtime, offsets and
        word ids deferred to their first read; None where the native tier
        does not run the configuration.  ``add_special_tokens=True`` skips
        added-token matching and leaves tokens and sequence ids at the base
        length; ``False`` runs ``encode_batch`` (added tokens honoured, on
        ``device``) with no offsets, as the reference's separate branch."""
        if not isinstance(self.pre_tokenizer, ByteLevel):
            return None
        native = self._get_native_encoder()
        if native is None:
            return None
        id2tok = self._id_to_token_list()
        nv = len(id2tok)
        if not add_special_tokens:
            rows = self.encode_batch(texts, device=device)
            return [
                Encoding.from_ids(
                    ids, [id2tok[i] for i in ids if 0 <= i < nv and id2tok[i] is not None]
                )
                for ids in rows
            ]
        normalized = self._normalize_batch(texts)
        aps = self._byte_level_prefix_space()
        rows = native.encode_rows_fused(normalized, aps, None)
        if rows is None:
            rows = native.encode_batch(self._prepare_bytes(normalized))
        return [self._build_call_encoding(text, ids) for text, ids in zip(texts, rows)]

    def _build_call_encoding(self, text: str, ids: list[int]) -> Encoding:
        """One ``add_special_tokens=True`` Encoding of ``__call__`` from its
        base ids (the reference's per-row flow, quirks included; offsets and
        word ids deferred)."""
        id2tok = self._id_to_token_list()
        nv = len(id2tok)
        pp = self.post_processor
        base_n = len(ids)
        tokens = [id2tok[i] if 0 <= i < nv and id2tok[i] is not None else "" for i in ids]
        processed = pp.process(list(ids), None) if pp is not None else list(ids)
        added = len(processed) - base_n
        enc = Encoding(
            ids=processed,
            type_ids=[0] * (base_n + added),
            tokens=tokens,
            attention_mask=[1] * (base_n + added),
            special_tokens_mask=[0] * base_n + [1] * added,
            offsets=[],
            word_ids=[],
            sequence_ids=[0] * base_n,
            overflowing=[],
        )
        enc.mark_special_tokens(list(self.special_tokens.values()))

        def aux(t=text):
            e = self._encode_single_to_encoding(t, 0)
            return e.offsets, e.word_ids

        enc._defer_aux(aux)
        return enc

    def _static_frame(self):
        """(prefix ids, suffix ids) where the post-processor frames a single
        sequence statically around $A, else None."""
        pp = self.post_processor
        if pp is None:
            return [], []
        if isinstance(pp, TemplateProcessing):
            if pp.single.count("$A") != 1 or "$B" in pp.single:
                return None
            return pp.compile_single()
        if isinstance(pp, BertProcessing):
            return [pp.cls[1]], [pp.sep[1]]
        if isinstance(pp, RobertaProcessing):
            return [pp.bos[1]], [pp.eos[1]]
        return None

    def _call_batch_columnar(
        self, texts, padding, truncation, max_len, stride,
        return_attention_mask, return_token_type_ids, return_special_tokens_mask,
    ):
        """The columnar ``__call__`` result (:class:`ColumnarBatchEncoding`)
        from the native ragged encode and the static frame; None where the
        route does not apply (no ByteLevel, no static frame, no native
        extension)."""
        if not isinstance(self.pre_tokenizer, ByteLevel):
            return None
        frame = self._static_frame()
        if frame is None:
            return None
        native = self._get_native_encoder()
        if native is None:
            return None
        from .native import load_ext

        if load_ext() is None:
            return None
        norm = self.normalizer
        ascii_norm = norm is not None and self._norm_ascii_ok
        normalized = texts if norm is None or ascii_norm else [norm.normalize(t) for t in texts]
        aps = self._byte_level_prefix_space()
        flat, offs, _flagged, nonascii = native.encode_ragged_fused(
            normalized, aps, None, ascii_norm=ascii_norm
        )
        if nonascii:
            # the rows left to the normalizer: normalized, then the single
            # encode without added-token matching (the offset route's quirk)
            redo = set(nonascii)
            flat, offs = _ragged_from_parts([
                np.asarray(native.encode(self._prepare_bytes([norm.normalize(t)])[0]), np.int32)
                if i in redo else flat[offs[i] : offs[i + 1]]
                for i, t in enumerate(normalized)
            ])
        prefix, suffix = frame
        pad_id, pad_token = self._pad_id_token()
        pad_left = padding == "left" or self._padding_side == "left"
        pad_to = 0
        if padding is not None:
            if padding == "max_length":
                pad_to = max_len
            else:
                m = np.diff(np.asarray(offs, np.int64)) + len(prefix) + len(suffix)
                pad_to = int((np.minimum(m, max_len) if truncation else m).max(initial=0))
        return ColumnarBatchEncoding(
            self, texts, flat, offs, prefix, suffix, bool(truncation), int(max_len),
            int(stride), padding, int(pad_to), pad_id, pad_token, bool(pad_left),
            return_attention_mask, return_token_type_ids, return_special_tokens_mask,
        )

    def _call_one(self, text, pair, add_special_tokens) -> Encoding:
        if pair is not None:
            if add_special_tokens:
                return self.encode_pair_to_encoding(text, pair)
            enc = self._encoding_of_ids(self.encode(text))
            enc.merge(self._encoding_of_ids(self.encode(pair)), 1)
            return enc
        if add_special_tokens:
            return self.encode_to_encoding(text)
        return self._encoding_of_ids(self.encode(text))

    def _encoding_of_ids(self, ids) -> Encoding:
        """An Encoding of bare ids; tokens of ids outside the vocabulary are
        left out."""
        get = self.vocab.get_token
        return Encoding.from_ids(ids, [t for t in (get(int(i)) for i in ids) if t is not None])

    # ------------------------------------------------------------------
    # components

    def set_normalizer(self, normalizer) -> None:
        self.normalizer = getattr(normalizer, "inner", normalizer)
        self._invalidate_pipeline()

    def set_pre_tokenizer(self, pre_tokenizer) -> None:
        self.pre_tokenizer = getattr(pre_tokenizer, "inner", pre_tokenizer)
        self._invalidate_pipeline()

    def set_post_processor(self, post_processor) -> None:
        self.post_processor = getattr(post_processor, "inner", post_processor)
        self._invalidate_pipeline()

    def set_decoder(self, decoder) -> None:
        self.decoder = getattr(decoder, "inner", decoder)
        self._invalidate_pipeline()

    # ------------------------------------------------------------------
    # vocabulary access

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def token_to_id(self, token: str) -> int | None:
        return self.vocab.get_id(token)

    def id_to_token(self, tid: int) -> str | None:
        return self.vocab.get_token(tid)

    def get_vocab(self) -> dict[str, int]:
        return dict(self.bpe.vocab)

    def convert_ids_to_tokens(self, ids, skip_special_tokens: bool = False):
        out = []
        for i in ids:
            tok = self.vocab.get_token(int(i))
            out.append(None if tok is not None and skip_special_tokens and tok in self.special_tokens
                       else tok)
        return out

    def convert_tokens_to_string(self, tokens) -> str:
        if self.decoder is not None:
            return self.decoder.decode(list(tokens))
        return "".join(tokens)

    def convert_tokens_to_ids(self, tokens):
        return [self.vocab.get_id(t) for t in tokens]

    def convert_token_to_id(self, token: str):
        return self.vocab.get_id(token)

    def get_special_tokens_mask(self, ids, already_has_special_tokens: bool = True):
        if not already_has_special_tokens:
            return [0] * len(ids)
        get = self.vocab.get_token
        return [1 if (t := get(int(i))) is not None and t in self.special_tokens else 0 for i in ids]

    def num_special_tokens_to_add(self, is_pair: bool = False) -> int:
        pp = self.post_processor
        if isinstance(pp, BertProcessing):
            return 3 if is_pair else 2
        if isinstance(pp, RobertaProcessing):
            return 4 if is_pair else 2
        if isinstance(pp, TemplateProcessing):
            template = (pp.pair if pp.pair is not None else pp.single) if is_pair else pp.single
            return sum(1 for part in template.split() if not part.startswith("$"))
        return 0

    @property
    def is_fast(self) -> bool:
        return True

    def tokenize(self, text: str) -> list[str]:
        """Token strings, without added-token matching."""
        normalized = self.normalizer.normalize(text) if self.normalizer else text
        words = self.pre_tokenizer.pre_tokenize(normalized) if self.pre_tokenizer else [normalized]
        get = self.vocab.get_token
        return [t for w in words for t in map(get, self.bpe.encode(w)) if t is not None]

    # ------------------------------------------------------------------
    # properties and their setters

    @property
    def model_max_length(self) -> int:
        return self._model_max_length

    @model_max_length.setter
    def model_max_length(self, value: int) -> None:
        self._model_max_length = value

    @property
    def padding_side(self) -> str:
        return self._padding_side

    @padding_side.setter
    def padding_side(self, value: str) -> None:
        self._padding_side = value

    @property
    def truncation_side(self) -> str:
        return self._truncation_side

    @truncation_side.setter
    def truncation_side(self, value: str) -> None:
        self._truncation_side = value

    @property
    def chat_template(self) -> str | None:
        return self._chat_template

    @chat_template.setter
    def chat_template(self, value: str | None) -> None:
        self._chat_template = value

    def set_model_max_length(self, value: int) -> None:
        self._model_max_length = value

    def set_padding_side(self, value: str) -> None:
        self._padding_side = value

    def set_truncation_side(self, value: str) -> None:
        self._truncation_side = value

    def set_chat_template(self, value: str | None) -> None:
        self._chat_template = value

    # the named special tokens (inferred at load) and their ids
    bos_token = property(lambda self: self.vocab.special_tokens().bos_token)
    eos_token = property(lambda self: self.vocab.special_tokens().eos_token)
    pad_token = property(lambda self: self.vocab.special_tokens().pad_token)
    unk_token = property(lambda self: self.vocab.special_tokens().unk_token)
    sep_token = property(lambda self: self.vocab.special_tokens().sep_token)
    cls_token = property(lambda self: self.vocab.special_tokens().cls_token)
    mask_token = property(lambda self: self.vocab.special_tokens().mask_token)
    bos_token_id = property(lambda self: self.vocab.bos_id())
    eos_token_id = property(lambda self: self.vocab.eos_id())
    pad_token_id = property(lambda self: self.vocab.pad_id())
    unk_token_id = property(lambda self: self.vocab.unk_id())
    sep_token_id = property(lambda self: self._named_id(self.sep_token))
    cls_token_id = property(lambda self: self._named_id(self.cls_token))
    mask_token_id = property(lambda self: self._named_id(self.mask_token))

    def _named_id(self, tok):
        return self.vocab.get_id(tok) if tok else None

    @property
    def all_special_tokens(self) -> list[str]:
        tokens = [t for t in (self.bos_token, self.eos_token, self.pad_token, self.unk_token,
                              self.sep_token, self.cls_token, self.mask_token) if t is not None]
        tokens += [t for t in self.special_tokens if t not in tokens]
        return tokens

    @property
    def all_special_ids(self) -> list[int]:
        ids = []
        for i in (self.bos_token_id, self.eos_token_id, self.pad_token_id, self.unk_token_id,
                  self.sep_token_id, self.cls_token_id, self.mask_token_id,
                  *self.special_tokens.values()):
            if i is not None and i not in ids:
                ids.append(i)
        return ids

    # ------------------------------------------------------------------
    # padding and truncation configuration

    def enable_padding(
        self,
        direction: str | None = None,
        pad_to_multiple_of: int | None = None,
        pad_id: int | None = None,
        pad_token: str | None = None,
        length: int | None = None,
    ) -> None:
        self.padding_config.enabled = True
        self.padding_config.direction = direction or "right"
        self.padding_config.pad_to_multiple_of = pad_to_multiple_of
        if direction is not None:
            self._padding_side = direction
        self.padding_config.strategy = "max_length" if length is not None else "longest"
        if pad_token is not None and pad_id is not None:
            self.add_token(pad_token, pad_id, True)

    def no_padding(self) -> None:
        self.padding_config.enabled = False

    def enable_truncation(
        self,
        max_length: int,
        stride: int | None = None,
        strategy: str | None = None,
        direction: str | None = None,
    ) -> None:
        self.truncation_config.enabled = True
        self.truncation_config.max_length = max_length
        self.truncation_config.stride = stride or 0
        self.truncation_config.strategy = strategy or "longest_first"
        self.truncation_config.direction = direction or "right"
        if direction is not None:
            self._truncation_side = direction

    def no_truncation(self) -> None:
        self.truncation_config.enabled = False

    def padding(self):
        return self.padding_config if self.padding_config.enabled else None

    def truncation(self):
        return self.truncation_config if self.truncation_config.enabled else None

    # ------------------------------------------------------------------
    # special tokens

    def add_special_tokens(self, special_tokens_dict: dict) -> int:
        """Register each value as a special token: its vocabulary id, else
        ``vocab_size`` (the same id for every new one, as the reference).
        Returns the number of new tokens."""
        num_added = 0
        for value in special_tokens_dict.values():
            tid = self.vocab.get_id(value)
            if tid is None:
                tid = self.vocab_size
                num_added += 1
            self._add_special(value, tid)
        self._invalidate_pipeline()
        return num_added

    def add_special_tokens_list(self, tokens) -> int:
        """Register each token outside the vocabulary and the added tokens
        as a special token with the next free id past both."""
        num_added = 0
        for token in tokens:
            if self.vocab.get_id(token) is None and token not in self.added_tokens:
                self._add_special(token, self.vocab_size + len(self.added_tokens))
                num_added += 1
        self._invalidate_pipeline()
        return num_added

    def _add_special(self, content: str, tid: int) -> None:
        self.special_tokens[content] = tid
        self.added_tokens[content] = tid
        self.added_tokens_config.setdefault(content, AddedToken(content, tid, True))

    # ------------------------------------------------------------------
    # training

    def train_new_from_iterator(self, texts, vocab_size: int) -> "Tokenizer":
        """A new tokenizer trained on ``texts`` with this one's pipeline
        (normalizer, pre-tokenizer, post-processor, decoder, special tokens):
        the classic ``BpeTrainer`` on the host, as the JAX package's."""
        from .trainers.bpe_trainer import BpeTrainer, BpeTrainerConfig

        special_tokens = self.all_special_tokens
        config = BpeTrainerConfig(
            vocab_size=vocab_size,
            min_frequency=2,
            special_tokens=list(special_tokens),
            show_progress=True,
            end_of_word_suffix=None,
            continuing_subword_prefix=None,
        )
        texts_list = list(texts)
        if self.pre_tokenizer is not None:
            processed = []
            for t in texts_list:
                normalized = self.normalizer.normalize(t) if self.normalizer else t
                processed.extend(self.pre_tokenizer.pre_tokenize(normalized))
        else:
            processed = [str(t) for t in texts_list]
        vocab, merges = BpeTrainer(config).train(processed)

        new = Tokenizer(TokenizerSpec(
            vocab=vocab, merges=merges, normalizer=self.normalizer,
            pre_tokenizer=self.pre_tokenizer, decoder=self.decoder,
            added_tokens=[AddedToken(t, vocab[t], True) for t in special_tokens if t in vocab],
            post_processor=self.post_processor, named_specials=self.vocab.special_tokens(),
        ))
        new._model_max_length = self._model_max_length
        new._padding_side = self._padding_side
        new._truncation_side = self._truncation_side
        new._chat_template = self._chat_template
        new.padding_config = self.padding_config
        new.truncation_config = self.truncation_config
        return new

    # ------------------------------------------------------------------
    # post-processing, chat, prepare_for_model

    def post_process(self, encoding: Encoding, pair_encoding: Encoding | None = None) -> Encoding:
        result = encoding
        if pair_encoding is not None:
            result.merge(pair_encoding, 1)
        if self.post_processor is not None:
            original_len = len(result.ids)
            processed = self.post_processor.process(list(result.ids), None)
            added = len(processed) - original_len
            result.ids = processed
            result.attention_mask += [1] * added
            result.special_tokens_mask += [1] * added
            result.type_ids += [0] * added
            result.offsets += [(0, 0)] * added
            result.word_ids += [None] * added
            result.sequence_ids += [None] * added
            result.mark_special_tokens(list(self.special_tokens.values()))
        return result

    def apply_chat_template(
        self, messages, add_generation_prompt: bool = False, tokenize: bool = True
    ):
        if self._chat_template is None:
            raise ValueError("No chat template set for this tokenizer")
        st = self.vocab.special_tokens()
        result = chat_mod.apply_chat_template(
            self._chat_template, messages, add_generation_prompt,
            st.bos_token or "<s>", st.eos_token or "</s>",
        )
        return self.encode(result) if tokenize else result

    def prepare_for_model(
        self,
        ids,
        pair_ids=None,
        add_special_tokens: bool = True,
        padding: str | None = None,
        truncation: bool = False,
        max_length: int | None = None,
        stride: int = 0,
        return_attention_mask: bool = True,
    ) -> Encoding:
        """Frame ids that are already encoded (and a pair's)."""
        encoding = self._encoding_of_ids([int(i) for i in ids])
        if pair_ids is not None:
            encoding.merge(self._encoding_of_ids([int(i) for i in pair_ids]), 1)
        if add_special_tokens and self.post_processor is not None:
            processed = self.post_processor.process(list(encoding.ids), None)
            added = len(processed) - len(encoding.ids)
            encoding.ids = processed
            encoding.attention_mask += [1] * added
            encoding.special_tokens_mask += [1] * added
            encoding.type_ids += [0] * added
        max_len = max_length if max_length is not None else self._model_max_length
        if truncation and len(encoding) > max_len:
            if stride > 0:
                encoding.truncate_with_stride(max_len, stride)
            else:
                encoding.truncate(max_len)
        if padding in ("max_length", "longest", "left", "right"):
            pad_id, pad_token = self._pad_id_token()
            pad_left = padding == "left" or self._padding_side == "left"
            encoding.pad(max_len, pad_id, pad_token, pad_left)
        return encoding

    # ------------------------------------------------------------------
    # serialization

    def _to_tokenizer_json(self) -> dict:
        vocab_r = self.id_to_token_map
        merges = [
            f"{vocab_r.get(pair[0], '')} {vocab_r.get(pair[1], '')}"
            for pair, _new_id in self.bpe.merges
        ]
        added_tokens = []
        for content, tid in self.added_tokens.items():
            cfg = self.added_tokens_config.get(content)
            added_tokens.append({
                "id": tid,
                "content": content,
                "special": cfg.special if cfg else content in self.special_tokens,
                "single_word": cfg.single_word if cfg else False,
                "lstrip": cfg.lstrip if cfg else False,
                "rstrip": cfg.rstrip if cfg else False,
                "normalized": cfg.normalized if cfg else False,
            })
        return {
            "version": "1.0",
            "model": {"type": "BPE", "vocab": dict(self.bpe.vocab), "merges": merges},
            "added_tokens": added_tokens,
            "normalizer": (
                serialization.serialize_normalizer(self.normalizer)
                if self.normalizer is not None else None
            ),
            "pre_tokenizer": (
                serialization.serialize_pre_tokenizer(self.pre_tokenizer)
                if self.pre_tokenizer is not None else None
            ),
            "post_processor": (
                serialization.serialize_post_processor(self.post_processor, self.special_tokens)
                if self.post_processor is not None else None
            ),
            "decoder": (
                serialization.serialize_decoder(self.decoder)
                if self.decoder is not None else None
            ),
        }

    def save(self, path) -> None:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self._to_tokenizer_json(), f, ensure_ascii=False, indent=2)

    def save_pretrained(self, directory) -> None:
        d = Path(directory)
        d.mkdir(parents=True, exist_ok=True)
        self.save(d / "tokenizer.json")
        st = self.vocab.special_tokens()
        config = {
            "tokenizer_class": "PreTrainedTokenizerFast",
            "model_type": "bpe",
            "bos_token": st.bos_token,
            "eos_token": st.eos_token,
            "unk_token": st.unk_token,
            "pad_token": st.pad_token,
            "sep_token": st.sep_token,
            "cls_token": st.cls_token,
            "mask_token": st.mask_token,
        }
        (d / "tokenizer_config.json").write_text(json.dumps(config, indent=2))
        special_map = {k: v for k, v in config.items() if k.endswith("_token")}
        (d / "special_tokens_map.json").write_text(json.dumps(special_map, indent=2))


def _ragged_from_parts(parts):
    """(flat int32, offsets int64) from per-row id arrays."""
    offsets = np.zeros(len(parts) + 1, np.int64)
    np.cumsum([len(p) for p in parts], out=offsets[1:])
    flat = np.concatenate(parts).astype(np.int32) if offsets[-1] else np.zeros(0, np.int32)
    return flat, offsets

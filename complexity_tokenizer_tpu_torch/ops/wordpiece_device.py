"""Device WordPiece and WordLevel: kernels K10 and K11
(``csrc/wordpiece.cu``) and their plain versions.

The reference's WordPiece is a per-word loop: at each position take the
longest substring in the vocabulary, else emit UNK and advance one
character.  The device form, as in the JAX package
(``ops/wordpiece_device.py``):

- words are codepoint rows ``[B, W]`` (W = 128 lanes), -1 padded;
- substring hashes come from prefix polynomial hashes,
  ``h(s, e) = P[e] - P[s] * pow[e - s]`` in uint32, two independent
  bases; the ``##`` continuation form adds ``seed * pow[len]``;
- the vocabulary is a CHD table keyed on the two hashes (a string key is a
  pair of 32-bit words) whose rank column holds the token's slot;
- each step probes every candidate length at the current position at
  once, keeps the longest hit, checks it exactly against the slot's
  characters, emits the id at the start column and advances.  A failed
  check poisons the word and the caller re-tokenizes it on the host.

WordLevel is one whole-word hash, one probe and the exact check per word;
a miss gives UNK.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..utils.cuda_build import check, kernel_library
from ..utils.device import resolve_device
from .hashtable import INF_RANK, _mul32, build_chd_table, chd_lookup

__all__ = [
    "WordPieceDeviceTables",
    "build_wordpiece_tables",
    "WordPieceDevice",
    "WordLevelDevice",
    "build_wordlevel_tables",
    "rolling_prefix_hashes",
    "wordpiece_match",
    "wordpiece_match_plain",
    "wordlevel_lookup",
    "wordlevel_lookup_plain",
]

_W = 128  # codepoint lanes a word row
_M32 = 0xFFFFFFFF
_B1 = 0x01000193
_B2 = 0x0BADC0DF  # odd
_SEED_CONT1 = 0x9E3779B9
_SEED_CONT2 = 0x7F4A7C15


def _poly_hash_np(chars: list[int], base: int, seed: int) -> int:
    """Polynomial hash of codepoints (each +1) in uint32 arithmetic."""
    h = seed
    for c in chars:
        h = (h * base + c + 1) & _M32
    return h


def _key(chars: list[int], s1: int, s2: int) -> tuple[int, int]:
    """The CHD key of a string: both hashes as int32 bit patterns."""
    h1 = _poly_hash_np(chars, _B1, s1)
    h2 = _poly_hash_np(chars, _B2, s2)
    return (h1 - (1 << 32) if h1 >= 1 << 31 else h1, h2 - (1 << 32) if h2 >= 1 << 31 else h2)


def _to_i32(h: torch.Tensor) -> torch.Tensor:
    """int64 holding u32 values -> their int32 bit patterns."""
    return torch.where(h >= 1 << 31, h - (1 << 32), h).to(torch.int32)


def _mul32_t(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``(x * c) mod 2**32`` for u32 values in int64 tensors (``c`` a
    tensor): 16-bit halves of ``c``, so no product overflows int64."""
    return ((x * (c & 0xFFFF)) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _powers(base: int, n: int, device) -> torch.Tensor:
    """[n + 1] int64: base**i mod 2**32."""
    out, p = [], 1
    for _ in range(n + 1):
        out.append(p)
        p = (p * base) & _M32
    return torch.tensor(out, dtype=torch.int64, device=device)


def rolling_prefix_hashes(chars: torch.Tensor):
    """(P1, P2, pow1, pow2) for substring hashing over codepoint rows, the
    JAX function of the same name: ``P[b, i]`` is the polynomial hash of
    ``chars[b, :i]`` (codepoints +1, -1 padding contributes 0), so any
    substring hash is ``P[e] - P[s] * pow[e - s]``.  int64 tensors holding
    u32 values."""
    B, W = chars.shape
    u = torch.where(chars >= 0, chars.to(torch.int64) + 1, 0)

    def prefix(base):
        P = torch.zeros((B, W + 1), dtype=torch.int64, device=chars.device)
        for i in range(W):
            P[:, i + 1] = (_mul32(P[:, i], base) + u[:, i]) & _M32
        return P

    return prefix(_B1), prefix(_B2), _powers(_B1, W, chars.device), _powers(_B2, W, chars.device)


@dataclass
class WordPieceDeviceTables:
    chd: object  # ChdTable keyed on (h1, h2); rank column = slot
    token_chars: np.ndarray  # [S, Lt] int32, -1 padded (matchable form)
    token_lens: np.ndarray  # [S] int32
    emit_ids: np.ndarray  # [S] int32: slot -> vocabulary id
    max_token_len: int
    unk_id: int  # -1 when UNK is not in the vocabulary
    max_input_chars: int


def _tables(keys, slot_chars, slot_emit, unk_id: int, max_input: int):
    chd = build_chd_table(keys)
    if chd is None:
        return None
    S = len(slot_chars)
    Lt = max(1, max(len(c) for c in slot_chars))
    token_chars = np.full((S, Lt), -1, np.int32)
    token_lens = np.zeros(S, np.int32)
    for slot, chars in enumerate(slot_chars):
        token_chars[slot, : len(chars)] = chars
        token_lens[slot] = len(chars)
    return WordPieceDeviceTables(
        chd=chd, token_chars=token_chars, token_lens=token_lens,
        emit_ids=np.asarray(slot_emit, np.int32), max_token_len=Lt, unk_id=unk_id,
        max_input_chars=max_input,
    )


def build_wordpiece_tables(model) -> WordPieceDeviceTables | None:
    """Tables of a ``models.wordpiece.WordPieceModel``; None when it is not
    eligible (a 64-bit hash collision between two forms, an empty
    vocabulary, a failed CHD build).

    Each entry goes in under every form the loop can look it up by (a slot
    each, ``emit_ids[slot]`` = its id): the plain key (its whole spelling,
    unseeded hashes), which the probe at position 0 looks up, so an entry
    that literally starts with the prefix (``##abc``) is found by its full
    spelling at a word's start; and, when the entry strictly extends the
    prefix, the continuation key (the body after the prefix, seeded
    hashes), which a probe past position 0 looks up.  Forms wider than the
    lanes are left out (a word that could match one is itself too wide and
    goes to the host)."""
    vocab = model.vocab
    if not vocab:
        return None
    prefix = model.continuing_subword_prefix
    keys: dict[tuple[int, int], int] = {}
    slot_chars: list[list[int]] = []
    slot_emit: list[int] = []

    def add_key(chars: list[int], s1: int, s2: int, tid: int) -> bool:
        key = _key(chars, s1, s2)
        if key in keys:
            return False
        keys[key] = len(slot_chars)
        slot_chars.append(chars)
        slot_emit.append(tid)
        return True

    for tok, tid in vocab.items():
        full = [ord(c) for c in tok]
        if full and len(full) <= _W and not add_key(full, 0, 0, tid):
            return None
        if tok.startswith(prefix) and len(tok) > len(prefix):
            body = [ord(c) for c in tok[len(prefix):]]
            # a continuation starts at position 1 or later
            if len(body) <= _W - 1 and not add_key(body, _SEED_CONT1, _SEED_CONT2, tid):
                return None
    if not slot_chars:
        return None
    unk_id = vocab.get(model.unk_token)
    return _tables(keys, slot_chars, slot_emit, -1 if unk_id is None else int(unk_id),
                   int(model.max_input_chars_per_word))


def build_wordlevel_tables(model) -> WordPieceDeviceTables | None:
    """Tables of a ``models.wordlevel.WordLevelModel``: whole-word hash ->
    CHD -> id, with the exact check; None for an empty vocabulary, an
    empty or over-wide entry, a hash collision or a failed CHD build.
    UNK is the vocabulary's id of the UNK token, else 0."""
    vocab = model.vocab
    if not vocab:
        return None
    keys: dict[tuple[int, int], int] = {}
    slot_chars: list[list[int]] = []
    slot_emit: list[int] = []
    for tok, tid in vocab.items():
        chars = [ord(c) for c in tok]
        if not chars or len(chars) > _W:
            return None
        key = _key(chars, 0, 0)
        if key in keys:
            return None
        keys[key] = len(slot_chars)
        slot_chars.append(chars)
        slot_emit.append(tid)
    return _tables(keys, slot_chars, slot_emit, int(vocab.get(model.unk_token, 0)), 1 << 30)


class _DeviceTables:
    """A table set on one device (``cuda`` unless the caller passes
    ``"cpu"``)."""

    def __init__(self, tables: WordPieceDeviceTables, device=None):
        self.t = tables
        self.device = resolve_device(device)
        on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(self.device)  # noqa: E731
        self.disp = on(tables.chd.disp)
        self.rows = on(tables.chd.rows)
        self.token_chars = on(tables.token_chars)
        self.token_lens = on(tables.token_lens)
        self.emit_ids = on(tables.emit_ids)

    def args(self) -> tuple:
        """The table arguments of :func:`wordpiece_match` and
        :func:`wordlevel_lookup`."""
        t = self.t
        return (self.disp, self.rows, t.chd.size, t.chd.n_buckets, self.token_chars,
                self.token_lens, self.emit_ids, t.unk_id)


# ---------------------------------------------------------------------------
# K10: the WordPiece greedy longest match


def wordpiece_match_plain(chars, lens, disp, rows, size, n_buckets, token_chars, token_lens,
                          emit_ids, unk: int, max_input: int):
    """Plain PyTorch version of K10, on any device: the JAX
    ``WordPieceDevice._fn`` step for step.

    Args:
      chars: [B, W] int32 codepoints, -1 padded; lens: [B] int32.
      disp, rows, size, n_buckets: the CHD table keyed on (h1, h2).
      token_chars [S, Lt], token_lens [S], emit_ids [S]: int32 slot tables.
      unk: UNK's id, -1 when absent; max_input: the longest word matched
        (a longer one gives one UNK at column 0, or nothing).
    Returns:
      (out [B, W] int32: ids at each match's start column, -1 elsewhere;
      count [B] int32; poison [B] bool: a longest hit failed the exact
      check).
    """
    B, W = chars.shape
    dev = chars.device
    Lt = token_chars.shape[1]
    maxlen = min(Lt, W)
    P1, P2, pow1, pow2 = rolling_prefix_hashes(chars)
    ls = torch.arange(1, maxlen + 1, device=dev)
    p1l, p2l = pow1[ls][None, :], pow2[ls][None, :]
    seed1 = _mul32(pow1[ls], _SEED_CONT1)[None, :]
    seed2 = _mul32(pow2[ls], _SEED_CONT2)[None, :]
    lens_i = lens.to(torch.int64)
    over = lens_i > max_input
    start = torch.zeros(B, dtype=torch.int64, device=dev)
    out = torch.full((B, W), -1, dtype=torch.int32, device=dev)
    poison = torch.zeros(B, dtype=torch.bool, device=dev)
    cols = torch.arange(W, device=dev)[None, :]
    jt = torch.arange(Lt, device=dev)[None, :]
    while True:
        active = (start < lens_i) & ~over
        if not bool(active.any()):
            break
        e = start[:, None] + ls[None, :]
        cand_ok = (e <= lens_i[:, None]) & active[:, None]
        e_c = e.clamp(0, W)
        s_c = start.clamp(0, W)[:, None]
        h1 = (P1.gather(1, e_c) - _mul32_t(P1.gather(1, s_c), p1l)) & _M32
        h2 = (P2.gather(1, e_c) - _mul32_t(P2.gather(1, s_c), p2l)) & _M32
        is_cont = (start > 0)[:, None]
        h1 = torch.where(is_cont, (h1 + seed1) & _M32, h1)
        h2 = torch.where(is_cont, (h2 + seed2) & _M32, h2)
        tid = chd_lookup(disp, rows, size, n_buckets, _to_i32(h1), _to_i32(h2), cand_ok)
        hit = tid != INF_RANK
        best_l = torch.where(hit, ls[None, :], 0).max(dim=1).values
        matched = best_l > 0
        cand = tid.gather(1, (best_l - 1).clamp(min=0)[:, None])[:, 0]
        safe = torch.where(matched, cand, 0).long()
        # the exact check of the chosen candidate (hash collisions)
        wchars = chars.gather(1, (start[:, None] + jt).clamp(0, W - 1))
        within = jt < best_l[:, None]
        verified = torch.where(within, token_chars[safe] == wchars, True).all(dim=1) & (
            token_lens[safe] == best_l
        )
        poison |= matched & ~verified
        good = matched & verified
        emit_unk = active & ~matched & (unk >= 0)
        emit_id = torch.where(good, emit_ids[safe], unk)
        out = torch.where((cols == start[:, None]) & (good | emit_unk)[:, None], emit_id[:, None], out)
        start = torch.where(active, start + torch.where(good, best_l, 1), start)
    out[:, 0] = torch.where(over & (unk >= 0), unk, out[:, 0])
    count = (out >= 0).sum(dim=1, dtype=torch.int32)
    return out, count, poison


def _check_args(fn: str, tensors) -> None:
    dev = tensors[0][1].device
    for name, t, dtype, shape in tensors:
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"{fn}: {name} must be {dtype} {shape} on {dev}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")


def _check_tables(fn: str, chars, lens, disp, rows, size, n_buckets, token_chars, token_lens,
                  emit_ids) -> None:
    B, W = chars.shape
    S, Lt = token_chars.shape
    if W > _W:
        raise ValueError(f"{fn}: rows of {W} lanes exceed the kernel's {_W}")
    for name, n in (("table size", size), ("bucket count", n_buckets)):
        if n <= 0 or n & (n - 1):
            raise ValueError(f"{fn}: {name} {n} is not a power of two")
    i32 = torch.int32
    _check_args(fn, (
        ("chars", chars, i32, (B, W)), ("lens", lens, i32, (B,)),
        ("disp", disp, i32, (n_buckets,)), ("rows", rows, i32, (size, 4)),
        ("token_chars", token_chars, i32, (S, Lt)), ("token_lens", token_lens, i32, (S,)),
        ("emit_ids", emit_ids, i32, (S,)),
    ))
    if rows.data_ptr() % 16:
        raise ValueError(f"{fn}: rows must be 16-byte aligned (one int4 load a probe)")


def wordpiece_match(chars, lens, disp, rows, size, n_buckets, token_chars, token_lens, emit_ids,
                    unk: int, max_input: int):
    """K10 on CUDA tensors, the plain version on CPU tensors; same
    arguments and result as :func:`wordpiece_match_plain` (rows of at most
    128 lanes)."""
    if chars.device.type == "cpu":
        return wordpiece_match_plain(chars, lens, disp, rows, size, n_buckets, token_chars,
                                     token_lens, emit_ids, unk, max_input)
    if chars.device.type != "cuda":
        raise ValueError(f"wordpiece_match: unsupported device {chars.device}")
    _check_tables("wordpiece_match", chars, lens, disp, rows, size, n_buckets, token_chars,
                  token_lens, emit_ids)
    B, W = chars.shape
    out = torch.empty_like(chars)
    count = torch.empty(B, dtype=torch.int32, device=chars.device)
    poison = torch.empty(B, dtype=torch.bool, device=chars.device)
    if B == 0 or W == 0:
        return out, count.zero_(), poison.zero_()
    stream = torch.cuda.current_stream(chars.device).cuda_stream
    check(
        kernel_library().lib.ctok_wordpiece_match(
            chars.data_ptr(), lens.data_ptr(), disp.data_ptr(), rows.data_ptr(), size - 1,
            n_buckets - 1, token_chars.data_ptr(), token_lens.data_ptr(), emit_ids.data_ptr(),
            token_chars.shape[1], int(unk), int(min(max_input, 2**31 - 1)), out.data_ptr(),
            count.data_ptr(), poison.data_ptr(), B, W, stream,
        ),
        "wordpiece_match",
    )
    wordpiece_match.launches += 1
    return out, count, poison


wordpiece_match.launches = 0  # launches of K10 (not of the plain version)


class WordPieceDevice(_DeviceTables):
    """The greedy longest match over word rows on one device."""

    last_poisoned: list[int] = []
    last_over_width = 0

    def pack(self, words: list[str]):
        """K10's input for a batch of words: (chars [n, 128] int32, lens [n]
        int32, the words left to the host: wider than the lanes and not
        decided by the limit in them; over the limit a word is one UNK, or
        nothing without UNK)."""
        max_input = self.t.max_input_chars
        chars = np.full((len(words), _W), -1, np.int32)
        lens = np.zeros(len(words), np.int32)
        skipped: list[int] = []
        for i, w in enumerate(words):
            if len(w) > _W and (len(w) <= max_input or max_input >= _W):
                skipped.append(i)
                continue
            cps = [ord(c) for c in w[:_W]]
            chars[i, : len(cps)] = cps
            lens[i] = len(cps)
        return chars, lens, skipped

    def tokenize_words(self, words: list[str]) -> list[list[int]]:
        """Greedy longest match of each word, one launch at the exact batch
        size.  ``last_poisoned`` then lists the words the caller must
        re-tokenize on the host: a failed exact check, or a word left to
        the host by :meth:`pack` (``last_over_width`` of them)."""
        n = len(words)
        if n == 0:
            self.last_poisoned, self.last_over_width = [], 0
            return []
        chars, lens, skipped = self.pack(words)
        on = lambda a: torch.from_numpy(a).to(self.device)  # noqa: E731
        out, _count, poison = wordpiece_match(on(chars), on(lens), *self.args(),
                                              self.t.max_input_chars)
        out, poison = out.cpu().numpy(), poison.cpu().numpy()
        self.last_poisoned = np.flatnonzero(poison).tolist() + skipped
        self.last_over_width = len(skipped)
        return [out[i][out[i] >= 0].tolist() for i in range(n)]


# ---------------------------------------------------------------------------
# K11: the WordLevel lookup


def wordlevel_lookup_plain(chars, lens, disp, rows, size, n_buckets, token_chars, token_lens,
                           emit_ids, unk: int):
    """Plain PyTorch version of K11, on any device: the JAX
    ``WordLevelDevice._fn``.  ``chars`` [B, W] int32 codepoints (-1
    entries are skipped by the hash), ``lens`` [B] int32, the tables as for
    :func:`wordpiece_match_plain`.  Returns [B] int32: the word's id, UNK
    on a miss, -1 for an empty word."""
    B, W = chars.shape
    Lt = token_chars.shape[1]
    u = torch.where(chars >= 0, chars.to(torch.int64) + 1, 0)

    def whole_hash(base):
        h = torch.zeros(B, dtype=torch.int64, device=chars.device)
        for i in range(W):
            c = u[:, i]
            h = torch.where(c > 0, (_mul32(h, base) + c) & _M32, h)
        return _to_i32(h)

    valid = lens > 0
    tid = chd_lookup(disp, rows, size, n_buckets, whole_hash(_B1), whole_hash(_B2), valid)
    hit = tid != INF_RANK
    safe = torch.where(hit, tid, 0).long()
    within = torch.arange(Lt, device=chars.device)[None, :] < lens[:, None]
    ok = (
        torch.where(within, token_chars[safe] == chars[:, :Lt], True).all(dim=1)
        & (token_lens[safe] == lens)
        & (lens <= Lt)
    )
    out = torch.where(hit & ok, emit_ids[safe], unk)
    return torch.where(valid, out, -1).to(torch.int32)


def wordlevel_lookup(chars, lens, disp, rows, size, n_buckets, token_chars, token_lens, emit_ids,
                     unk: int):
    """K11 on CUDA tensors, the plain version on CPU tensors; same
    arguments and result as :func:`wordlevel_lookup_plain` (rows of at most
    128 lanes)."""
    if chars.device.type == "cpu":
        return wordlevel_lookup_plain(chars, lens, disp, rows, size, n_buckets, token_chars,
                                      token_lens, emit_ids, unk)
    if chars.device.type != "cuda":
        raise ValueError(f"wordlevel_lookup: unsupported device {chars.device}")
    _check_tables("wordlevel_lookup", chars, lens, disp, rows, size, n_buckets, token_chars,
                  token_lens, emit_ids)
    B, W = chars.shape
    out = torch.empty(B, dtype=torch.int32, device=chars.device)
    if B == 0:
        return out
    stream = torch.cuda.current_stream(chars.device).cuda_stream
    check(
        kernel_library().lib.ctok_wordlevel_lookup(
            chars.data_ptr(), lens.data_ptr(), disp.data_ptr(), rows.data_ptr(), size - 1,
            n_buckets - 1, token_chars.data_ptr(), token_lens.data_ptr(), emit_ids.data_ptr(),
            token_chars.shape[1], int(unk), out.data_ptr(), B, W, stream,
        ),
        "wordlevel_lookup",
    )
    wordlevel_lookup.launches += 1
    return out


wordlevel_lookup.launches = 0  # launches of K11 (not of the plain version)


class WordLevelDevice(_DeviceTables):
    """One whole-word probe and the exact check per word, on one device."""

    last_over_width = 0

    def pack(self, words: list[str]):
        """K11's input for a batch of words: (chars [n, 128] int32, lens [n]
        int32, the words wider than the lanes, left empty)."""
        chars = np.full((len(words), _W), -1, np.int32)
        lens = np.zeros(len(words), np.int32)
        long_idx = []
        for i, w in enumerate(words):
            if len(w) > _W:
                long_idx.append(i)
                continue
            chars[i, : len(w)] = [ord(c) for c in w]
            lens[i] = len(w)
        return chars, lens, long_idx

    def lookup_words(self, words: list[str]) -> list[int]:
        """The id of each word (UNK on a miss), one launch at the exact batch
        size; a word wider than the lanes is set to UNK on the host (no
        entry is that wide), ``last_over_width`` of them."""
        if not words:
            self.last_over_width = 0
            return []
        chars, lens, long_idx = self.pack(words)
        on = lambda a: torch.from_numpy(a).to(self.device)  # noqa: E731
        out = wordlevel_lookup(on(chars), on(lens), *self.args()).cpu().tolist()
        for i in long_idx:
            out[i] = self.t.unk_id
        self.last_over_width = len(long_idx)
        return out

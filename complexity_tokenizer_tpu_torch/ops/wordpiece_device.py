"""Device WordPiece and WordLevel: kernels K10 and K11
(``csrc/wordpiece.cu``) and their plain versions.

The reference's WordPiece is a per-word loop: at each position take the
longest substring in the vocabulary, else emit UNK and advance one
character.  The device form, as in the JAX package
(``ops/wordpiece_device.py``), except that K10 takes its words ragged (the
codepoints of all words end to end, their offsets and lengths, ordered by
length so that a group of lanes sized to the word takes it):

- words are codepoint rows ``[B, W]`` (W = 128 lanes), -1 padded, in the
  plain version (:func:`wordpiece_match_plain`);
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
a miss gives UNK.  K11 takes the same ragged words as K10, in the same
lane groups.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..utils.cuda_build import check, kernel_library, launch_info
from ..utils.device import resolve_device
from .hashtable import INF_RANK, _mul32, build_chd_table, chd_lookup
from .merge import _ragged_index

__all__ = [
    "WordPieceDeviceTables",
    "build_wordpiece_tables",
    "WordPieceDevice",
    "WordLevelDevice",
    "build_wordlevel_tables",
    "rolling_prefix_hashes",
    "hash_powers",
    "wordpiece_match",
    "wordpiece_match_plain",
    "wordpiece_match_ragged_plain",
    "wordpiece_launch_shape",
    "wordlevel_launch_shape",
    "wordlevel_lookup",
    "wordlevel_lookup_plain",
    "wordlevel_lookup_ragged_plain",
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


_POWERS: dict = {}


def hash_powers(device) -> torch.Tensor:
    """K10's powers on ``device``, built once per device: [4, 129] int32
    (uint32 bit patterns), rows ``base1**l``, ``base2**l``, ``seed1 *
    base1**l`` and ``seed2 * base2**l`` mod 2**32 for l = 0..128."""
    dev = torch.device(device)
    t = _POWERS.get(dev)
    if t is None:
        p1 = _powers(_B1, _W, "cpu")
        p2 = _powers(_B2, _W, "cpu")
        rows = torch.stack([p1, p2, _mul32(p1, _SEED_CONT1), _mul32(p2, _SEED_CONT2)])
        t = _to_i32(rows).contiguous().to(dev)
        _POWERS[dev] = t
    return t


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
        # each row's fourth word (-1 in the JAX tables, read by no lookup)
        # holds its slot's emit id, so K10's row read brings the id
        rows = tables.chd.rows.copy()
        slot = rows[:, 2]
        used = (slot >= 0) & (slot < len(tables.emit_ids))
        rows[used, 3] = tables.emit_ids[slot[used]]
        self.rows = on(rows)
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


def _check_ragged(fn: str, chars, offs, lens, groups, disp, rows, size, n_buckets,
                  token_chars, token_lens, emit_ids) -> tuple[int, int]:
    """The argument checks K10 and K11 share (ragged words, the lane groups,
    the tables); returns the groups (n8, n16)."""
    N, B = chars.numel(), lens.numel()
    S, Lt = token_chars.shape
    n8, n16 = (int(g) for g in groups)
    if not 0 <= n8 <= n16 <= B:
        raise ValueError(f"{fn}: groups {groups} outside 0 <= n8 <= n16 <= {B}")
    if Lt > _W:
        raise ValueError(f"{fn}: tokens of {Lt} characters exceed the kernel's {_W}")
    for name, n in (("table size", size), ("bucket count", n_buckets)):
        if n <= 0 or n & (n - 1):
            raise ValueError(f"{fn}: {name} {n} is not a power of two")
    i32 = torch.int32
    _check_args(fn, (
        ("chars", chars, i32, (N,)), ("offs", offs, i32, (B + 1,)), ("lens", lens, i32, (B,)),
        ("disp", disp, i32, (n_buckets,)), ("rows", rows, i32, (size, 4)),
        ("token_chars", token_chars, i32, (S, Lt)), ("token_lens", token_lens, i32, (S,)),
        ("emit_ids", emit_ids, i32, (S,)),
    ))
    if rows.data_ptr() % 16:
        raise ValueError(f"{fn}: rows must be 16-byte aligned (one int4 load a probe)")
    return n8, n16


def _dense_words(chars, offs, fn: str):
    """Ragged words scattered into -1-padded 128-lane rows: (rows [B, 128]
    int32, word, column), raising if a word holds more than 128 slots."""
    B = offs.numel() - 1
    if B and int((offs[1:] - offs[:-1]).max()) > _W:
        raise ValueError(f"{fn}: a word holds more than {_W} slots")
    word, col = _ragged_index(offs)
    dense = torch.full((B, _W), -1, dtype=torch.int32, device=chars.device)
    dense[word, col] = chars
    return dense, word, col


def wordpiece_match_ragged_plain(chars, offs, lens, disp, rows, size, n_buckets, token_chars,
                                 token_lens, emit_ids, unk: int, max_input: int):
    """Plain PyTorch version of K10, on any device: the words scattered into
    128-lane rows, :func:`wordpiece_match_plain`, and gathered back.

    Args:
      chars: [N] int32, the codepoints of all words end to end.
      offs: [B + 1] int32, word i is ``chars[offs[i]:offs[i + 1]]`` (at most
        128 slots).
      lens: [B] int32, each word's length: at most its slots, or over
        ``max_input`` (then one slot, whose character is not read, takes
        its UNK).
      The tables, ``unk`` and ``max_input`` as for :func:`wordpiece_match_plain`.
    Returns:
      (out [N] int32: each match's id at its start character, -1 elsewhere;
      count [B] int32; poison [B] bool).
    """
    slots = offs[1:] - offs[:-1]
    if bool(((lens <= max_input) & (lens > slots)).any()):
        raise ValueError("wordpiece_match: a word within the limit is longer than its slots")
    dense, word, col = _dense_words(chars, offs, "wordpiece_match")
    out, count, poison = wordpiece_match_plain(dense, lens, disp, rows, size, n_buckets,
                                               token_chars, token_lens, emit_ids, unk, max_input)
    return out[word, col], count, poison


def wordpiece_match(chars, offs, lens, groups, disp, rows, size, n_buckets, token_chars,
                    token_lens, emit_ids, unk: int, max_input: int):
    """K10 on CUDA tensors, the plain version on CPU tensors; same
    arguments and result as :func:`wordpiece_match_ragged_plain`, with
    ``groups`` = (n8, n16): the words [0, n8) are matched by groups of 8
    lanes, [n8, n16) by groups of 16, the rest by a warp each (right for
    any order, fastest when each word fits its group, as
    :meth:`WordPieceDevice.pack` orders them; the plain version does not
    read them).  On the card, ``rows`` holds each slot's emit id in its
    fourth word (``_DeviceTables``)."""
    if chars.device.type == "cpu":
        return wordpiece_match_ragged_plain(chars, offs, lens, disp, rows, size, n_buckets,
                                            token_chars, token_lens, emit_ids, unk, max_input)
    if chars.device.type != "cuda":
        raise ValueError(f"wordpiece_match: unsupported device {chars.device}")
    n8, n16 = _check_ragged("wordpiece_match", chars, offs, lens, groups, disp, rows, size,
                            n_buckets, token_chars, token_lens, emit_ids)
    B, Lt = lens.numel(), token_chars.shape[1]
    out = torch.empty_like(chars)
    count = torch.empty(B, dtype=torch.int32, device=chars.device)
    poison = torch.empty(B, dtype=torch.bool, device=chars.device)
    if B == 0:
        return out, count, poison
    pows = hash_powers(chars.device)
    stream = torch.cuda.current_stream(chars.device).cuda_stream
    check(
        kernel_library().lib.ctok_wordpiece_match(
            chars.data_ptr(), offs.data_ptr(), lens.data_ptr(), n8, n16, B, disp.data_ptr(),
            rows.data_ptr(), size - 1, n_buckets - 1, token_chars.data_ptr(),
            token_lens.data_ptr(), emit_ids.data_ptr(), Lt, int(unk),
            int(min(max_input, 2**31 - 1)), pows.data_ptr(), out.data_ptr(), count.data_ptr(),
            poison.data_ptr(), stream,
        ),
        "wordpiece_match",
    )
    wordpiece_match.launches += 1
    return out, count, poison


wordpiece_match.launches = 0  # launches of K10 (not of the plain version)

def wordpiece_launch_shape() -> dict:
    """How the card launches K10: threads a block, registers a thread,
    static shared bytes a block, local (spill) bytes a thread, resident
    blocks per SM.  Needs a card; launches nothing."""
    return launch_info("ctok_wordpiece_info", "wordpiece_launch_shape")


def _pack_words(words: list[str], wl: np.ndarray, slots: np.ndarray):
    """Words ordered by their ``slots`` (stable) for K10 and K11: (chars [N]
    int32, offs [B + 1] int32, order [B] (packed word j is
    ``words[order[j]]``), groups (n8, n16): the words of at most 8 and 16
    slots).  Every word's characters in one UTF-32 string; a word whose
    slots differ from its length ``wl`` holds that many placeholders (0)."""
    order = np.argsort(slots, kind="stable")
    sorted_slots = slots[order]
    offs = np.zeros(len(words) + 1, np.int32)
    np.cumsum(sorted_slots, out=offs[1:])
    text = "".join(words[i] if slots[i] == wl[i] else "\0" * int(slots[i])
                   for i in order.tolist())
    chars = np.frombuffer(text.encode("utf-32-le", "surrogatepass"), np.uint32).astype(np.int32)
    groups = (int(np.searchsorted(sorted_slots, 8, "right")),
              int(np.searchsorted(sorted_slots, 16, "right")))
    return chars, offs, order, groups


class WordPieceDevice(_DeviceTables):
    """The greedy longest match over ragged words on one device."""

    last_poisoned: list[int] = []
    last_over_width = 0

    def pack(self, words: list[str]):
        """K10's input for a batch of words, ordered by their slots (stable):
        (chars [N] int32, offs [B + 1] int32, lens [B] int32, order [B]
        (packed word j is ``words[order[j]]``), groups (n8, n16), the words
        left to the host).  A word wider than the lanes and not decided by
        the limit in them goes to the host and holds no slot; a word over
        the limit holds one slot (character -1, not read) for its UNK and
        its length cut to the lanes; any other word its characters."""
        max_input = self.t.max_input_chars
        wl = np.fromiter(map(len, words), np.int64, len(words))
        host = (wl > _W) & ((wl <= max_input) | (max_input >= _W))
        over = ~host & (wl > max_input)
        slots = np.where(host, 0, np.where(over, 1, wl))
        chars, offs, order, groups = _pack_words(words, wl, slots)
        lens = np.where(host, 0, np.minimum(wl, _W))[order].astype(np.int32)
        chars[offs[:-1][over[order]]] = -1  # a word over the limit: one slot, -1
        return chars, offs, lens, order, groups, np.flatnonzero(host).tolist()

    def tokenize_words(self, words: list[str]) -> list[list[int]]:
        """Greedy longest match of each word, one launch over the ragged
        words.  ``last_poisoned`` then lists the words the caller must
        re-tokenize on the host: a failed exact check, or a word left to
        the host by :meth:`pack` (``last_over_width`` of them)."""
        n = len(words)
        if n == 0:
            self.last_poisoned, self.last_over_width = [], 0
            return []
        chars, offs, lens, order, groups, skipped = self.pack(words)
        # one copy to the device: the characters, the offsets and the lengths
        N = len(chars)
        buf = torch.from_numpy(np.concatenate([chars, offs, lens])).to(self.device)
        out, _count, poison = wordpiece_match(buf[:N], buf[N:N + n + 1], buf[N + n + 1:], groups,
                                              *self.args(), self.t.max_input_chars)
        out, poison = out.cpu().numpy(), poison.cpu().numpy()
        live = out >= 0
        bounds = np.concatenate([[0], np.cumsum(live)])[offs].tolist()
        ids = out[live].tolist()
        rows: list[list[int]] = [[]] * n
        for j, i in enumerate(order.tolist()):
            rows[i] = ids[bounds[j]:bounds[j + 1]]
        self.last_poisoned = sorted(order[poison].tolist()) + skipped
        self.last_over_width = len(skipped)
        return rows


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


def wordlevel_lookup_ragged_plain(chars, offs, lens, disp, rows, size, n_buckets, token_chars,
                                  token_lens, emit_ids, unk: int):
    """Plain PyTorch version of K11, on any device: the words scattered into
    -1-padded 128-lane rows and :func:`wordlevel_lookup_plain`.

    Args:
      chars: [N] int32, the codepoints of all words end to end.
      offs: [B + 1] int32, word i is ``chars[offs[i]:offs[i + 1]]`` (at most
        128 slots).
      lens: [B] int32, each word's length as the dense rows' ``lens``.
      The tables and ``unk`` as for :func:`wordlevel_lookup_plain`.
    Returns:
      [B] int32: the word's id, UNK on a miss, -1 for a length <= 0.
    """
    dense, _word, _col = _dense_words(chars, offs, "wordlevel_lookup")
    return wordlevel_lookup_plain(dense, lens, disp, rows, size, n_buckets, token_chars,
                                  token_lens, emit_ids, unk)


def wordlevel_lookup(chars, offs, lens, groups, disp, rows, size, n_buckets, token_chars,
                     token_lens, emit_ids, unk: int):
    """K11 on CUDA tensors, the plain version on CPU tensors; same
    arguments and result as :func:`wordlevel_lookup_ragged_plain`, with
    ``groups`` = (n8, n16) as for :func:`wordpiece_match` (the plain
    version does not read them).  On the card, ``rows`` holds each slot's
    emit id in its fourth word (``_DeviceTables``), which K11 reads in
    place of ``emit_ids``."""
    if chars.device.type == "cpu":
        return wordlevel_lookup_ragged_plain(chars, offs, lens, disp, rows, size, n_buckets,
                                             token_chars, token_lens, emit_ids, unk)
    if chars.device.type != "cuda":
        raise ValueError(f"wordlevel_lookup: unsupported device {chars.device}")
    n8, n16 = _check_ragged("wordlevel_lookup", chars, offs, lens, groups, disp, rows, size,
                            n_buckets, token_chars, token_lens, emit_ids)
    B = lens.numel()
    out = torch.empty(B, dtype=torch.int32, device=chars.device)
    if B == 0:
        return out
    stream = torch.cuda.current_stream(chars.device).cuda_stream
    check(
        kernel_library().lib.ctok_wordlevel_lookup(
            chars.data_ptr(), offs.data_ptr(), lens.data_ptr(), n8, n16, B, disp.data_ptr(),
            rows.data_ptr(), size - 1, n_buckets - 1, token_chars.data_ptr(),
            token_lens.data_ptr(), token_chars.shape[1], int(unk), out.data_ptr(), stream,
        ),
        "wordlevel_lookup",
    )
    wordlevel_lookup.launches += 1
    return out


wordlevel_lookup.launches = 0  # launches of K11 (not of the plain version)


def wordlevel_launch_shape() -> dict:
    """How the card launches K11, as :func:`wordpiece_launch_shape`."""
    return launch_info("ctok_wordlevel_info", "wordlevel_launch_shape")


class WordLevelDevice(_DeviceTables):
    """One whole-word probe and the exact check per word, on one device."""

    last_over_width = 0

    def pack(self, words: list[str]):
        """K11's input for a batch of words, ordered by length (stable), as
        :meth:`WordPieceDevice.pack`: (chars [N] int32, offs [B + 1] int32,
        lens [B] int32, order [B] (packed word j is ``words[order[j]]``),
        groups (n8, n16), the words wider than the lanes, which hold no
        slot and length 0)."""
        wl = np.fromiter(map(len, words), np.int64, len(words))
        slots = np.where(wl > _W, 0, wl)
        chars, offs, order, groups = _pack_words(words, wl, slots)
        return chars, offs, slots[order].astype(np.int32), order, groups, np.flatnonzero(
            wl > _W).tolist()

    def lookup_words(self, words: list[str]) -> list[int]:
        """The id of each word (UNK on a miss), one launch over the ragged
        words, one copy to the device and one back; a word wider than the
        lanes is set to UNK on the host (no entry is that wide),
        ``last_over_width`` of them."""
        n = len(words)
        if n == 0:
            self.last_over_width = 0
            return []
        chars, offs, lens, order, groups, long_idx = self.pack(words)
        N = len(chars)
        buf = torch.from_numpy(np.concatenate([chars, offs, lens])).to(self.device)
        out = wordlevel_lookup(buf[:N], buf[N:N + n + 1], buf[N + n + 1:], groups,
                               *self.args()).cpu().numpy()
        ids = np.empty(n, np.int32)
        ids[order] = out  # back to the words' order
        ids[long_idx] = self.t.unk_id
        self.last_over_width = len(long_idx)
        return ids.tolist()

"""The benchmark corpus recipe: Zipf-distributed pseudo-word texts.

The same texts as the repository's ``bench.py`` makes (``_zipf_lexicon``,
``_zipf_corpus``, ``_MULTI_PIECES``), kept here so that the port and
``chip_smoke.py`` need nothing of the JAX package.  Deterministic for a
seed.  Also the rows of long runs that separate the merge kernel's apply
rule from the JAX one (:func:`run_rows`), and word packs that reach the
word path's fill at its edges (:func:`edge_word_pack`), and a decode
vocabulary of long tokens (:func:`long_token_vocab`).
"""

from __future__ import annotations

import numpy as np

from .bytelevel import bytes_to_unicode

__all__ = [
    "LONG_TOKEN_LENGTHS", "MULTI_PIECES", "RUN_BREAKS", "edge_word_pack", "long_token_vocab",
    "run_rows", "zipf_lexicon", "zipf_corpus",
]

# multilingual UTF-8, NFC-sensitive sequences (decomposed forms, combining
# marks), mixed scripts, contractions and whitespace runs
MULTI_PIECES = [
    "café", "café", "naïve", "naïve", "über",
    "straße", "日本語", "中文", "한국어",
    "Ελληνικά", "русский",
    "العربية", "עברית",
    "हिन्दी", "emoji \U0001f600 test",
    "mixedテストwords", "it's", "don't", "we'll", "they've",
    "I'm", "you'd", "    spaces    runs", "tabs\t\tand\nnewlines",
    "123世界456", "punc!!!???...", "'''quotes'''",
    "Ą̊ring", "ṩḍ̇ odd NFC",
]


def zipf_lexicon(n: int = 50_000, seed: int = 3) -> list[str]:
    """n distinct hash-derived pseudo-words with rank-correlated lengths
    (common words short, like natural text)."""
    rng = np.random.RandomState(seed)
    ranks = np.arange(n, dtype=np.float64)
    base = 2.0 + (ranks / n) ** 0.6 * 9.0
    lens = (base + rng.rand(n) * 2.0).astype(np.int64)
    total = int(lens.sum())
    letters = np.frombuffer(b"etaoinshrdlcumwfgypbvkjxqz", dtype=np.uint8)
    p = 0.845 ** np.arange(26)
    p /= p.sum()
    buf = letters[rng.choice(26, size=total, p=p)]
    offs = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    words: list[str] = []
    seen: set[str] = set()
    extra = "abcdefghijklmnopqrstuvwxyz"
    for i in range(n):
        w = buf[offs[i] : offs[i + 1]].tobytes().decode()
        while w in seen:
            w += extra[(i * 7 + len(w)) % 26]
        seen.add(w)
        words.append(w)
    return words


def zipf_corpus(
    n_texts: int, seed: int, lo: int = 20, hi: int = 500, lexicon=None
) -> list[str]:
    """Texts drawn word by word from the lexicon under a Zipf(1.0) rank
    distribution: the head repeats like natural text, the tail keeps tens
    of thousands of distinct words in play."""
    lex = zipf_lexicon() if lexicon is None else lexicon
    n = len(lex)
    wts = 1.0 / np.arange(1, n + 1, dtype=np.float64)
    cdf = np.cumsum(wts)
    cdf /= cdf[-1]
    rng = np.random.RandomState(seed)
    need = max(200_000, n_texts * 80)
    draws = np.searchsorted(cdf, rng.rand(need)).astype(np.int64)
    caps = rng.rand(n_texts) < 0.3
    puncs = rng.rand(n_texts)
    targets = rng.randint(lo, hi + 1, size=n_texts)
    texts = []
    pos = 0
    for t in range(n_texts):
        target = int(targets[t])
        parts = []
        ln = 0
        while ln < target:
            if pos >= need:
                pos = 0
            w = lex[draws[pos]]
            pos += 1
            parts.append(w)
            ln += len(w) + 1
        s = " ".join(parts)
        if caps[t]:
            s = s.capitalize() + "."
        if puncs[t] < 0.1:
            s += " It's 2026, isn't it? Numbers: 123 456."
        texts.append(s[:target])
    return texts


# bytes that break runs when the byte table maps them to -1: a letter inside
# letter runs, a symbol inside symbol runs (the pre-split keeps each inside
# its word, so each is a tombstone inside the word)
RUN_BREAKS = (ord("y"), ord("~"))


def run_rows(text: bytes, B: int, L: int, breaks: bool = False) -> list[bytes]:
    """``B`` rows of at most ``L`` bytes on which applying every
    non-overlapping best pair per step and the JAX rule (the leading pair of
    an equal-pair run per step) take very different numbers of steps: one
    repeated letter, also after an odd prefix so that runs cross 32-entry
    chunks at both parities; runs of ``=``, ``-`` and ``.``; alternating
    ``abab...``; runs mixed with ``text``; then plain slices of ``text``.
    With ``breaks``, every 37th byte that is not a space becomes a
    :data:`RUN_BREAKS` byte."""
    mixed = b""
    for i, ch in enumerate(b"=-.a" * (L // 64 + 1)):
        mixed += bytes([ch]) * (7 + 13 * i % 61) + b" " + text[i * 40 : i * 40 + 40] + b" "
    pats = [
        b"x" + b"a" * (L - 1),
        b" " + b"=" * (L - 1),
        b"ab" * (L // 2),
        mixed,
        b"a" * L,
        b"-" * L,
        b"." * L,
        b"q" + b"ab" * (L // 2),
    ]
    rows = [pats[i][:L] if i < len(pats) else text[i * L : (i + 1) * L] for i in range(B)]
    if not breaks:
        return rows
    letter, symbol = RUN_BREAKS
    return [
        bytes(
            (letter if chr(c).isalpha() else symbol) if j % 37 == 36 and c != 0x20 else c
            for j, c in enumerate(r)
        )
        for r in rows
    ]


# words holding bytes that the benchmark vocabularies have no token for
# (control bytes, digits, ``!``, ``#``, ``%``, ``&``): tombstones inside
# their words from the seed on, alone and in runs
OOV_WORDS = (b"ab\x01cd", b"x0y1z", b"\x07", b"the!re", b"!!!!!!!!", b"a#b%c&d")


def edge_word_pack(words: list[bytes], B: int, W: int = 128, seed: int = 0):
    """``B`` word rows of ``W`` bytes that reach the word path's fill at its
    edges, as numpy (bytes uint8 [B, W], start bits uint8 [B, W / 8] little
    endian, row_len int32 [B]).

    Row 0 holds a 6-byte run before its first start bit (word id -1 where
    the word ids are counted within each row; the JAX fill body counts over
    the whole pack, which gives -1 there in row 0 only).  The others cycle
    through: words packed from column 0 as ``ctok_pack_seg`` packs them; a
    row of length 0; a full row (its last word ends at ``W``); words with
    OOV bytes inside (:data:`OOV_WORDS`); a one-byte run before the first
    start bit; an 80-byte word of one letter and a run of 10 OOV bytes;
    ``abab...``.  The words come from ``words`` in turn (those of at most
    ``W`` bytes).  Past each row's length, bytes and start bits are
    random."""
    rng = np.random.RandomState(seed)
    arr = rng.randint(0, 256, size=(B, W)).astype(np.uint8)
    starts = rng.rand(B, W) < 0.3
    row_len = np.zeros(B, np.int32)
    pool = [w for w in words if 0 < len(w) <= W]
    k = 0

    def packed(room: int) -> list:
        nonlocal k
        segs = []
        while len(pool[k % len(pool)]) <= room:
            w = pool[k % len(pool)]
            k += 1
            segs.append((w, True))
            room -= len(w)
        k += 1  # the word that did not fit goes on to the next row
        return segs

    for r in range(B):
        kind = r % 8
        if r == 0:
            segs = [(b"thethe"[:W], False)] + packed(W - 6)
        elif kind == 1:
            continue  # length 0
        elif kind == 2:
            segs = packed(W)
            room = W - sum(len(w) for w, _ in segs)
            if room:
                segs.append((bytes(pool[k % len(pool)] * W)[:room], True))
        elif kind == 3:
            segs = [(w, True) for w in OOV_WORDS] + packed(W - sum(map(len, OOV_WORDS)))
        elif kind == 4:
            segs = [(b"q", False)] + packed(W - 1)
        elif kind == 5:
            segs = [(b"a" * 80, True), (b"!" * 10, True)] + packed(W - 90)
        elif kind == 6:
            segs = [(b"ab" * 20, True)] + packed(W - 40)
        else:
            segs = packed(W - 1)
        pos = 0
        for w, start in segs:
            w = w[: W - pos]
            if not w:
                break
            arr[r, pos : pos + len(w)] = np.frombuffer(w, np.uint8)
            starts[r, pos : pos + len(w)] = False
            starts[r, pos] = start
            pos += len(w)
        row_len[r] = pos
    return arr, np.packbits(starts, axis=1, bitorder="little"), row_len


# token lengths of long_token_vocab: empty, one byte, the decode kernel's
# 12-byte inline width and past it, and far past it
LONG_TOKEN_LENGTHS = (0, 1, 12, 13, 16, 40, 300)


def long_token_vocab(V: int = 600, seed: int = 0, window_token: int = 20_000):
    """A decode vocabulary whose tokens run past the 12 bytes that the
    decode kernel (K7) keeps inline: ``(vocab_r, special_ids)``, ids ->
    byte-level token strings.  Of every 16 ids, seven take the lengths of
    :data:`LONG_TOKEN_LENGTHS` in turn, eight a random length of 2 to 11
    bytes, and one is missing from the vocabulary (no bytes); id 9 holds
    ``window_token`` bytes, more than the kernel's 16 KB staging window;
    ids 3 and 21 are special.  The bytes are random, all 256 values."""
    rng = np.random.RandomState(seed)
    enc = bytes_to_unicode()
    vocab_r: dict[int, str] = {}
    for i in range(V):
        kind = i % 16
        if kind == 15:
            continue
        n = LONG_TOKEN_LENGTHS[kind % 7] if kind < 7 else int(rng.randint(2, 12))
        if i == 9:
            n = window_token
        vocab_r[i] = "".join(enc[b] for b in rng.randint(0, 256, size=n).tolist())
    vocab_r[V - 1] = enc[ord("z")]  # V - 1 is in the vocabulary
    return vocab_r, [3, 21]

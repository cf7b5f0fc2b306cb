"""The benchmark corpus recipe: Zipf-distributed pseudo-word texts.

The same texts as the repository's ``bench.py`` makes (``_zipf_lexicon``,
``_zipf_corpus``, ``_MULTI_PIECES``), kept here so that the port and
``chip_smoke.py`` need nothing of the JAX package.  Deterministic for a
seed.  Also the vocabularies of the models at their published sizes
(:func:`bert_scale_wordpiece_vocab`, :func:`wordlevel_vocab`,
:func:`unigram_32k_vocab`), the pieces a Unigram model sees after
SentencePiece's ``Metaspace`` (:func:`metaspace_pieces`) and texts that
reach its Viterbi at its edges (:func:`unigram_edge_texts`).  Also the rows of long runs that separate the merge kernel's apply
rule from the JAX one (:func:`run_rows`), and word packs that reach the
word path's fill at its edges (:func:`edge_word_pack`), a decode
vocabulary of long tokens (:func:`long_token_vocab`), and byte rows that
reach the normalization check at a row's and a block's edge
(:func:`norm_edge_rows`), byte rows that reach the GPT-2 pre-split at its
edges (:func:`presplit_edge_rows`), and word rows that reach the trainer's
merge step at its edges (:func:`merge_edge_rows`), the trainer's rows with
Zipf-skewed ids for its pair histogram past the bench corpus's alphabet
(:func:`zipf_pair_rows`), and K12 results that reach the Unigram trainer's
piece histogram at its edges (:func:`piece_hist_edge_results`).  The golden vocabulary of the
WordPiece trainer at bert-base-uncased's 30,522 entries
(:func:`wordpiece_30k_vocab`), texts whose words reach its match at the
lanes' edge (:func:`wordpiece_train_edge_texts`) and words and a vocabulary
that reach its match at its lane groups' edges (:func:`train_match_edge_words`).
"""

from __future__ import annotations

import json
import os

import numpy as np

from .bytelevel import bytes_to_unicode, unicode_to_bytes

_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), ".cache")
# the tracked 50K byte-level BPE tokenizer (bench.py's)
BENCH_50K = os.path.join(_CACHE, "bench_tokenizer_r4_50k.json")
# the tracked 32,000-piece Unigram table (scripts/make_bench_unigram_32k.py)
BENCH_UNIGRAM_32K = os.path.join(_CACHE, "bench_unigram_32k.json")
# the tracked WordPiece vocabulary at 30,522 (scripts/make_bench_wordpiece_30k.py)
BENCH_WORDPIECE_30K = os.path.join(_CACHE, "bench_wordpiece_30k.json")

__all__ = [
    "LONG_TOKEN_LENGTHS", "MULTI_PIECES", "RUN_BREAKS", "bert_scale_wordpiece_vocab",
    "edge_word_pack", "long_token_vocab", "merge_edge_rows", "metaspace_pieces", "norm_edge_rows",
    "norm_trap_bitmap", "piece_hist_edge_results", "presplit_edge_rows", "run_rows", "unigram_32k_vocab", "unigram_edge_texts",
    "wordlevel_vocab", "wordpiece_30k_vocab", "wordpiece_train_edge_texts", "zipf_lexicon",
    "zipf_corpus", "zipf_pair_rows",
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


def norm_trap_bitmap() -> np.ndarray:
    """A stability bitmap [0x110000] uint8 that flags every codepoint past
    ASCII whose last six bits are not all 0.  A lead byte cut off at its
    row's end decodes (with zeros past the end) to none of them; with the
    next row's bytes 0xA9 or 0xBF after it, as :func:`norm_edge_rows` puts
    them, it would decode to one."""
    cp = np.arange(0x110000)
    return ((cp >= 0x80) & (cp & 0x3F != 0)).astype(np.uint8)


def norm_edge_rows(text: bytes, span: int = 4096, seed: int = 0) -> list[tuple[str, list]]:
    """Groups of byte rows, each checked in one launch, that reach the
    ragged normalization check (K8, blocks of ``span`` bytes) at its edges:
    (label, rows).

    - rows that end in the first 1..n-1 bytes of an n-byte form (n = 2, 3,
      4), each followed by a row that starts with continuation-looking
      bytes; every fourth row from the first is such a truncated row, every
      fourth from the fourth holds the whole form after the same lead;
    - rows of exactly 128, 512 and 4,096 bytes (``text`` repeated, a
      2-byte form at the end), with empty rows between;
    - a row across each block's edge, the edge at each of the 4 bytes of a
      4-byte form;
    - runs of empty rows (more rows in a block than it stages), rows of one
      byte, and rows of at most 2 bytes;
    - no rows, and empty rows only.
    """
    rng = np.random.RandomState(seed)
    cont = bytes([0xA9, 0xBF, 0x80])
    truncated = []
    for form in ("é", "中", "\U0001f601"):
        b = form.encode()
        for k in range(1, len(b)):
            for lead in (b"", b"ab", b"x" * 15, b"y" * 126):
                truncated += [lead + b[:k], cont[: 4 - k] + b"tail", b, lead + b]
    sized = [(text * (L // len(text) + 1))[:L - 2] + "é".encode() for L in (128, 512, 4096)]
    groups = [("truncated leads", truncated), ("rows of 128, 512, 4,096 bytes",
                                               sized + [b"", b""] + sized)]
    for shift in range(4):
        groups.append((f"across a block edge (shift {shift})",
                       [b"a" * (span - 1 - shift), "\U0001f601中é".encode() * 3 + text[:9000],
                        "é".encode() * 3000]))
    groups += [
        ("runs of empty rows",
         [b""] * 3000 + ["é".encode()] + [b""] * 2000 + [text[:5000]] + [b""] * 1500),
        ("one-byte rows", [bytes([c]) for c in rng.randint(0, 256, size=9000).tolist()]),
        ("short rows", [[b"", b"a", "é".encode(), b"\xc3"][c] for c in rng.randint(0, 4, 9000)]),
        ("no rows", []),
        ("empty rows", [b""] * 5),
    ]
    return groups


# byte strings at which the pre-split's local rules differ from a
# simplified rule: runs of 4-8 continuation bytes (invalid UTF-8: byte i
# takes the class computed at i - 3), continuation bytes that start a row
# (the class of the fill), a quote after them, the seven contractions, a
# quote after an absorbed and after a non-absorbed space, after a newline,
# a tab and a digit, multi-byte letters before a quote, and whole 2-, 3-
# and 4-byte forms
PRESPLIT_TRAPS = (
    b"\x80\x80\x80\x80x", b"\xa9\xa9x", b"\x80's", b"\x80\x80'll", b"\x80\x80\x80'd",
    b"ab" + b"\x80" * 4 + b" cd", b"\xc3" + b"\xa9" * 5 + b"'s", b"z" + b"\xbf" * 8 + b"q",
    b" " + b"\x9f" * 6 + b"1", b"'" + b"\x80" * 7,
    b"'s", b"'t", b"'re", b"'ve", b"'m", b"'ll", b"'d", b"it's", b"we'll ", b"they're",
    b"x 'sy", b"x  'sy", b"\n'll", b"\t 're", b"1'd", b"  'm", b"x ''s",
    "é's".encode(), "中'll".encode(), "\U0001f601'm".encode(), "é".encode(), "中".encode(),
    "\U0001f601".encode(), " \u00a0x".encode(), "a\u2028'd".encode(),
)


def presplit_edge_rows(L: int, seed: int = 0):
    """Byte rows of width ``L`` that reach the GPT-2 pre-split at its edges,
    as numpy (bytes uint8 [B, L], lengths int32 [B]); every byte past a
    row's length is non-zero (the pre-split decodes a lead byte's tail from
    the row's real bytes there, and only past column L - 1 from zeros).

    - each of :data:`PRESPLIT_TRAPS` at columns 0-3, across the edges of
      128-column steps (the kernel's window reaches 8 columns back and 4
      on: columns c - 8 .. c + 7 at the edges c = 128, 256, the middle and
      L - 128; each trap at every other such column), and at the row's
      end, after random bytes (every other row: random text, valid UTF-8
      around the trap as far as the trap is), with the length ending the trap,
      cutting 1-3 bytes off it (a lead truncated at len-1..len-3, a
      contraction cut by the length), or at, past or far past ``L``;
    - rows of random text over the traps' bytes, whose lengths include 0, 1,
      ``L``, ``L + 1``, -1 and the int32 extremes."""
    rng = np.random.RandomState(seed + L)
    fill = np.frombuffer(b"ab '\"s\tlr1.\ndmtve\x80\xc3\xa9\xe2\x80\xbf ", np.uint8)
    pieces = [p.encode() for p in ("a", "b", " ", "'", "s", "\t", "1", ".", "\n", "l", "r", "e",
                                   "d", "m", "t", "v", "  ", "é", "中", "\u00a0", "\U0001f601")]

    def filler() -> np.ndarray:
        if len(rows) % 2:
            return fill[rng.randint(0, fill.size, size=L)].copy()
        text = b""
        while len(text) < L:
            text += b"".join(pieces[i] for i in rng.randint(0, len(pieces), size=L // 2))
        return np.frombuffer(text[:L], np.uint8).copy()

    edge_cols = []
    for c0 in sorted({128, 256, L // 256 * 128, L - 128} & set(range(128, L, 128))):
        edge_cols += [c0 - 8, c0 - 5, c0 - 3, c0 - 1, c0, c0 + 1, c0 + 3, c0 + 7]
    rows, lens = [], []
    for t, trap in enumerate(PRESPLIT_TRAPS):
        n = len(trap)
        cols = [0, 1, 2, 3] + edge_cols[t % 2::2] + [L - n - 1, L - n]
        for i, c in enumerate(cols):
            if c < 0 or c + n > L:
                continue
            row = filler()
            row[c:c + n] = np.frombuffer(trap, np.uint8)
            end = c + n
            choice = (t + i) % 8
            ln = [end, end - 1, end - 2, end - 3, L, L + 1, 2 * L + 5, end][choice]
            rows.append(row)
            lens.append(max(ln, 0))
    specials = (0, 1, L, L + 1, -1, 2**31 - 1, -(2**31), L - 1)
    for i, ln in enumerate(specials * 2):
        rows.append(filler())
        lens.append(ln if i < len(specials) else int(rng.randint(0, L + 1)))
    return np.stack(rows).astype(np.uint8), np.asarray(lens, dtype=np.int64).astype(np.int32)


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


BERT_SPECIALS = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")
BERT_VOCAB_SIZE = 30_522  # bert-base-uncased's published vocabulary size
WORDLEVEL_WORDS = 40_000


def bert_scale_wordpiece_vocab() -> dict:
    """A WordPiece vocabulary of bert-base-uncased's size (30,522 entries;
    with ``##``, ``[UNK]`` and ``max_input_chars_per_word=100`` the
    published settings), derived from the tracked 50K byte-level tokenizer
    (:data:`BENCH_50K`):

    - ``[PAD] [UNK] [CLS] [SEP] [MASK]`` first;
    - then every non-whitespace character of the benchmark corpus
      (``zipf_corpus(10_000, seed=17)`` and :data:`MULTI_PIECES`), sorted,
      each in its plain and its ``##`` form;
    - then the tokens of the 50K tokenizer in id order, decoded from the
      byte-level alphabet, kept when valid UTF-8 with no whitespace after a
      leading space: a token with a leading space gives the word-initial piece,
      any other ``##`` + piece; until :data:`BERT_VOCAB_SIZE` entries.

    Characters outside the corpus (and pieces of no token) take UNK."""
    texts = zipf_corpus(10_000, seed=17) + list(MULTI_PIECES)
    vocab: dict[str, int] = {}
    for tok in BERT_SPECIALS:
        vocab.setdefault(tok, len(vocab))
    for ch in sorted({c for t in texts for c in t if not c.isspace()}):
        vocab.setdefault(ch, len(vocab))
        vocab.setdefault("##" + ch, len(vocab))
    with open(BENCH_50K, encoding="utf-8") as fh:
        model_vocab = json.load(fh)["model"]["vocab"]
    dec = unicode_to_bytes()
    for tok, _id in sorted(model_vocab.items(), key=lambda kv: kv[1]):
        if len(vocab) >= BERT_VOCAB_SIZE:
            break
        if any(c not in dec for c in tok):
            continue
        try:
            piece = bytes(dec[c] for c in tok).decode("utf-8")
        except UnicodeDecodeError:
            continue
        body = piece[1:] if piece.startswith(" ") else piece
        if not body or any(c.isspace() for c in body):
            continue
        vocab.setdefault(body if piece.startswith(" ") else "##" + body, len(vocab))
    return vocab


def wordlevel_vocab() -> dict:
    """A WordLevel vocabulary: ``<unk>`` (id 0), then the
    :data:`WORDLEVEL_WORDS` first ranks of ``zipf_lexicon(50_000)``.  The
    corpus's tail words, its capitalised and punctuated words and its
    multilingual pieces take UNK."""
    vocab = {"<unk>": 0}
    for w in zipf_lexicon(50_000)[:WORDLEVEL_WORDS]:
        vocab.setdefault(w, len(vocab))
    return vocab


METASPACE = "\u2581"  # SentencePiece's word-boundary mark


def unigram_32k_vocab() -> list[tuple[str, float]]:
    """The tracked Unigram table of t5-base's size (32,000 pieces, pieces up
    to 16 characters as SentencePiece's default; the longest has 13): the
    JAX package's ``UnigramTrainer`` on the benchmark corpus's words
    (``scripts/make_bench_unigram_32k.py``), as ``(piece, score)`` in id
    order.  Read from :data:`BENCH_UNIGRAM_32K`, never trained here."""
    with open(BENCH_UNIGRAM_32K, encoding="utf-8") as fh:
        return [(p, float(s)) for p, s in json.load(fh)]


def metaspace_pieces(texts: list[str]) -> list[str]:
    """The pieces a Unigram model sees after HF's ``Metaspace(replacement="▁",
    prepend_scheme="always", split=True)``: each whitespace-separated word
    with ``▁`` in front, in text order."""
    return [METASPACE + w for t in texts for w in t.split()]


def unigram_edge_texts(vocab: list[tuple[str, float]], seed: int = 0) -> list[tuple[str, list]]:
    """Texts that reach the Viterbi at its edges, by case: the empty text and
    one-character texts (pieces and characters of no piece); texts of 127,
    128 and 129 characters (the lanes' edge: 129 goes to the host); one
    repeated character (equal totals: exact ties); characters outside the
    table (the UNK fallback), alone and inside pieces; ends past 32 and 64
    characters (several candidate chunks a text); texts of 7, 8, 9, 15, 16
    and 17 characters (the edges of K12's lane groups of 8 and 16), also of
    one repeated character; and one text of each length 0..128 (every lane
    group in one launch)."""
    rng = np.random.RandomState(seed)
    pieces = [p for p, _ in vocab if p and not p.startswith("<")]
    singles = sorted({p for p in pieces if len(p) == 1})
    letters = [c for c in singles if c.isalpha()] or singles

    def joined(n: int) -> str:
        out = ""
        while len(out) < n:
            out += pieces[int(rng.randint(len(pieces)))]
        return out[:n]

    return [
        ("empty and one character", ["", *singles[:40], "\x00", "\u4e00", "Q", METASPACE]),
        ("127, 128 and 129 characters", [joined(n) for n in (127, 128, 129, 127, 128)]),
        ("one repeated character", [c * n for c in letters[:6] for n in (2, 3, 4, 9, 40, 128)]
         + [METASPACE * 5, METASPACE + letters[0] * 7]),
        ("characters outside the table", ["\u4e00\u4e01\u4e02", "\x00\x01", "Q" * 5,
                                          METASPACE + "\u4e00" + letters[0] + "\x07"]
         + [joined(6) + "\u3042" + joined(5) for _ in range(20)]),
        ("longer texts", [joined(int(n)) for n in rng.randint(30, 128, size=40)]),
        ("lane-group edges", [joined(n) for n in (7, 8, 9, 15, 16, 17) for _ in range(6)]
         + [c * n for c in letters[:2] for n in (8, 9, 16, 17)]),
        ("every lane group in one batch", [joined(n) for n in range(129)]),
    ]


def merge_edge_rows(V: int = 64, seed: int = 0) -> list[tuple]:
    """Word rows that reach the trainer's merge step (K14) at its edges, as
    ``(label, words [N, W] int32, freqs [N] int32, a, b, new_id)`` with
    numpy arrays, ids below ``V`` and ``new_id = V - 1``: the JAX tests'
    ``x a b a b y`` (adjacent occurrences) and ``a a a`` (a run of
    ``a == b``); runs of 1 to 7 equal tokens; rows of one alive token,
    all-tombstone rows and empty rows; tombstones between the pair's
    tokens; random tombstoned rows over three ids, with ``a == b`` and
    with ``a != b``; a with no b after it, and rows with no a; rows wider
    than 32 slots (runs of ``a == b`` across slot 32, random rows of 70);
    and a late state, 5,000 rows of mostly tombstones."""
    rng = np.random.RandomState(seed)
    new = V - 1
    x, a, b, y = 5, 1, 2, 6

    def rows(lst, W):
        arr = np.full((len(lst), W), -1, np.int32)
        for i, r in enumerate(lst):
            arr[i, : len(r)] = r
        return arr

    out = [
        ("x a b a b y", rows([[x, a, b, a, b, y]], 6), np.array([3], np.int32), a, b, new),
        ("a a a", rows([[a, a, a]], 4), np.array([2], np.int32), a, a, new),
        ("runs of a == b", rows([[a] * n for n in range(1, 8)] + [[x] + [a] * 5 + [y]], 9),
         np.arange(1, 9, dtype=np.int32), a, a, new),
    ]
    edge = rows([[a], [], [-1, -1, a, -1], [a, -1, -1, b], [a, -1, b, -1, a, -1, b],
                 [x, a, -1, b, -1, y], [b, a], [a, b], [-1] * 8], 8)
    out.append(("one token, tombstones, empty", edge, np.arange(1, 10, dtype=np.int32), a, b, new))
    for label, pa, pb in (("random, a != b", 0, 1), ("random, a == b", 2, 2)):
        words = rng.randint(0, 3, size=(300, 13)).astype(np.int32)
        words[rng.rand(300, 13) < 0.3] = -1
        freqs = rng.randint(1, 1000, size=300).astype(np.int32)
        out.append((label, words, freqs, pa, pb, new))
    # a with no b after it on the chain (b before it, b past another token,
    # a at the end), and rows that hold b and no a, between rows that merge
    lone = rows([[a, x], [x, a], [a, -1, x, b], [b, a], [a, -1, -1], [b, b, x], [y, b],
                 [x, a, b, y], [b, x, y, x]], 6)
    out.append(("a without b after it, rows with no a", lone,
                np.arange(1, 10, dtype=np.int32), a, b, new))
    # rows wider than a warp's 32 slots: runs of a == b across slot 32, and
    # random rows of 70 slots
    wide = rows([[a] * n for n in (31, 32, 33, 40)] + [[x] * 30 + [a, a, a, y]], 40)
    out.append(("runs of a == b across 32 slots, W 40", wide,
                np.arange(1, 6, dtype=np.int32), a, a, new))
    words = rng.randint(0, 3, size=(200, 70)).astype(np.int32)
    words[rng.rand(200, 70) < 0.3] = -1
    out.append(("random, W 70, a != b", words, rng.randint(1, 1000, size=200).astype(np.int32),
                0, 1, new))
    # a late state: most slots tombstones, rows of many warps and blocks
    words = rng.randint(0, 3, size=(5000, 13)).astype(np.int32)
    words[rng.rand(5000, 13) < 0.85] = -1
    out.append(("late state: 85% tombstones, 5,000 rows", words,
                rng.randint(1, 1000, size=5000).astype(np.int32), 0, 1, new))
    return out


def zipf_pair_rows(words: np.ndarray, v0: int, seed: int = 0, s: float = 1.1) -> np.ndarray:
    """``words`` (trainer rows [N, W], -1 empty) with every id replaced by
    one drawn below ``v0`` with probability proportional to ``1 / (i +
    1) ** s``: the rows' lengths (and so their pairs) kept, the ids of an
    alphabet as large as a byte-level corpus's (ByteLevel's 256 characters
    and the specials: v0 about 260) with a Zipf curve of hot pairs."""
    rng = np.random.RandomState(seed)
    p = 1.0 / np.arange(1, v0 + 1, dtype=np.float64) ** s
    out = words.astype(np.int32, copy=True)
    live = out >= 0
    out[live] = rng.choice(v0, size=int(live.sum()), p=p / p.sum()).astype(np.int32)
    return out


def piece_hist_edge_results(seed: int = 0) -> list[tuple]:
    """K12 results that reach the Unigram trainer's piece histogram (K17) at
    its edges, as ``(label, res [N + 2B], offs [B + 1], freqs [B], gidx [B],
    V, n_global)`` int32 numpy arrays and ints (res: ids of each text's
    slots, -1 and the fallback -2 among them, then each text's count and
    poison flag): one id that most texts choose, in texts of 0 to 40 slots;
    runs of texts of no slot; a text of 100 slots and more among short
    ones; every text poisoned; one text; one piece (V = 1); ids at and past
    V; a corpus index ``gidx`` that covers part of ``n_global``."""
    rng = np.random.RandomState(seed)

    def result(label, lens, ids, poison, V, n_global=None):
        lens = np.asarray(lens, np.int64)
        B = len(lens)
        n_global = B + 7 if n_global is None else n_global
        offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
        res = np.concatenate([np.asarray(ids, np.int32), lens.astype(np.int32),
                              np.asarray(poison, np.int32)])
        freqs = rng.randint(1, 1 << 12, size=B).astype(np.int32)
        gidx = rng.permutation(n_global)[:B].astype(np.int32)
        return (label, res, offs, freqs, gidx, V, n_global)

    out = []
    B, V = 3000, 5000
    lens = rng.randint(0, 41, size=B)
    ids = np.full(int(lens.sum()), 7, np.int32)  # the hot id
    other = rng.rand(len(ids))
    ids[other < 0.2] = rng.randint(0, V, size=int((other < 0.2).sum()))
    ids[(other >= 0.2) & (other < 0.35)] = -1
    ids[(other >= 0.35) & (other < 0.4)] = -2
    out.append(("a hot id in texts of 0-40 slots", lens, ids, rng.rand(B) < 0.05, V))
    lens = np.where(np.arange(B) % 97 < 40, 0, rng.randint(1, 9, size=B))
    out.append(("runs of texts of no slot", lens, rng.randint(-2, V, size=int(lens.sum())),
                rng.rand(B) < 0.05, V))
    lens = rng.randint(1, 12, size=B)
    lens[[5, 1000, B - 1]] = (100, 128, 300)
    out.append(("texts of 100, 128 and 300 slots among short ones", lens,
                rng.randint(-2, V, size=int(lens.sum())), np.zeros(B, np.int32), V))
    lens = rng.randint(0, 20, size=B)
    out.append(("every text poisoned", lens, rng.randint(0, V, size=int(lens.sum())),
                np.ones(B, np.int32), V))
    out.append(("one text", [37], rng.randint(-1, V, size=37), [0], V))
    lens = rng.randint(0, 30, size=500)
    out.append(("one piece (V = 1)", lens, rng.randint(-2, 3, size=int(lens.sum())),
                rng.rand(500) < 0.1, 1))
    lens = rng.randint(0, 30, size=B)
    out.append(("ids at and past V, a corpus four times the texts", lens,
                rng.randint(V - 3, V + 3, size=int(lens.sum())), rng.rand(B) < 0.1, V, 4 * B))
    return [result(*o) for o in out]


def wordpiece_30k_vocab() -> list[str]:
    """The WordPiece trainer's golden vocabulary, its entries in id order:
    the JAX host trainer at bert-base-uncased's 30,522 entries on
    ``zipf_corpus(10_000, seed=17)`` and :data:`MULTI_PIECES`
    (``scripts/make_bench_wordpiece_30k.py``)."""
    with open(BENCH_WORDPIECE_30K, encoding="utf-8") as f:
        return json.load(f)


def wordpiece_train_edge_texts(seed: int = 0) -> list[str]:
    """Texts for the WordPiece trainer whose words reach its match at the
    lanes' edge: words of 1, 13, 127, 128 and 129 characters (the last
    wider than the lanes, so the host tokenizes it each round), each twice
    so ``min_frequency`` 2 keeps it, over a small alphabet so that merges
    reach into them; with some corpus texts."""
    rng = np.random.RandomState(seed)
    abc = "abcdeé"
    words = []
    for n in (1, 13, 127, 128, 129):
        for _ in range(3):
            words.append("".join(abc[i] for i in rng.randint(0, len(abc), size=n)))
    words += ["ab" * 64, "ab" * 64 + "c", "é" * 128]
    return [" ".join(words)] * 2 + zipf_corpus(60, seed=seed)


# the word lengths at the edges of the WordPiece trainer's lane groups (8,
# 16 and 32 lanes a word) and of its 128 lanes
TRAIN_MATCH_EDGES = (1, 8, 9, 16, 17, 32, 33, 127, 128)


def train_match_edge_words(seed: int = 27):
    """Words for the WordPiece trainer's match at its lane groups' edges and
    a vocabulary whose forms reach every length up to 128: (words, their
    frequencies, vocabulary token -> id).  Three words of each length in
    ``TRAIN_MATCH_EDGES`` (fewer where draws repeat) over six letters; the
    vocabulary is the host trainer's 150 entries on them, then every other
    word whole and ``##`` bodies of 7 to 127 characters cut from the longer
    words, so that hits of every length lie at a word's start and past it."""
    from ..trainers.wordpiece_trainer import WordPieceTrainer, WordPieceTrainerConfig

    rng = np.random.RandomState(seed)
    letters = list("abcdé日")
    words = sorted({"".join(rng.choice(letters, size=n))
                    for n in TRAIN_MATCH_EDGES for _ in range(3)})
    freqs = [int(f) for f in rng.randint(1, 50, size=len(words))]
    host = WordPieceTrainer(WordPieceTrainerConfig(vocab_size=150, min_frequency=1))
    host._train_from_word_freqs(dict(zip(words, freqs)))
    vocab = dict(host.vocab)
    extra = words[::2]
    for w in words:
        for m in (7, 8, 9, 15, 16, 17, 31, 32, 33, 64, 100, 127):
            if len(w) > m + 1:
                extra.append("##" + w[1:1 + m])
    for tok in extra:
        vocab.setdefault(tok, len(vocab))
    return words, freqs, vocab

"""Torch pre-split vs the JAX pre-split and the host scanner, byte for byte:
``presplit`` on CPU tensors and K21's plain version ``presplit_plain``,
also on ``utils/corpus.py:presplit_edge_rows`` at every bucket width."""

import itertools

import numpy as np
import pytest
import torch

from helpers import SAMPLE_TEXT, conformance_corpus

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from complexity_tokenizer_tpu.ops.presplit import (  # noqa: E402
    class_table_jnp,
    presplit as jax_presplit,
    presplit_reference_np,
)
from complexity_tokenizer_tpu_torch.ops.presplit import presplit, presplit_plain  # noqa: E402
from complexity_tokenizer_tpu_torch.utils.corpus import (  # noqa: E402
    PRESPLIT_TRAPS,
    presplit_edge_rows,
)
from complexity_tokenizer_tpu_torch.utils.unicode_tables import gpt2_class_table  # noqa: E402

_jax_presplit = jax.jit(jax_presplit)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain version runs many ops on small tensors: with the test
    workers sharing the machine, torch's intra-op threads only wait on each
    other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pack(data: list[bytes], L: int | None = None):
    L = L or max(max((len(d) for d in data), default=1), 1)
    arr = np.zeros((len(data), L), dtype=np.uint8)
    lens = np.zeros(len(data), dtype=np.int32)
    for i, d in enumerate(data):
        arr[i, : len(d)] = np.frombuffer(d, dtype=np.uint8)
        lens[i] = len(d)
    return arr, lens


def _both(arr, lens):
    got = presplit(
        torch.from_numpy(arr), torch.from_numpy(lens), torch.from_numpy(gpt2_class_table())
    )
    exp = _jax_presplit(jnp.asarray(arr), jnp.asarray(lens), class_table_jnp())
    for g, e in zip(got, exp):
        e = np.asarray(e)
        assert g.dtype == {np.bool_: torch.bool, np.int32: torch.int32}[e.dtype.type]
        np.testing.assert_array_equal(g.numpy(), e)
    return got


def test_presplit_conformance_corpus():
    texts = conformance_corpus() + [SAMPLE_TEXT]
    arr, lens = _pack([t.encode("utf-8") for t in texts])
    start, word_id, valid = _both(arr, lens)
    for i, text in enumerate(texts):
        ref_start, ref_wid = presplit_reference_np(text)
        n = int(lens[i])
        np.testing.assert_array_equal(start[i, :n].numpy(), ref_start, err_msg=repr(text))
        np.testing.assert_array_equal(word_id[i, :n].numpy(), ref_wid, err_msg=repr(text))
        assert not valid[i, n:].any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_presplit_random_bytes_with_invalid_utf8(seed):
    rng = np.random.RandomState(seed)
    # raw random bytes (mostly invalid UTF-8) and biased ASCII-ish rows
    rows = [rng.randint(0, 256, size=rng.randint(0, 128)).astype(np.uint8).tobytes() for _ in range(24)]
    alphabet = np.frombuffer(b"ab '\"s\tlr1.\n\x80\xc3\xa9\xe2\x80", dtype=np.uint8)
    rows += [alphabet[rng.randint(0, alphabet.size, size=rng.randint(0, 128))].tobytes() for _ in range(24)]
    arr, lens = _pack(rows, L=128)
    _both(arr, lens)


def test_presplit_exhaustive_ascii_3grams():
    chars = [" ", "'", "s", "l", "r", "e", "a", "1", ".", "\n", "\t", '"']
    texts = ["".join(p) for p in itertools.product(chars, repeat=3)]
    arr, lens = _pack([t.encode() for t in texts])
    start, word_id, _ = _both(arr, lens)
    for i, text in enumerate(texts):
        ref_start, ref_wid = presplit_reference_np(text)
        np.testing.assert_array_equal(start[i, :3].numpy(), ref_start, err_msg=repr(text))
        np.testing.assert_array_equal(word_id[i, :3].numpy(), ref_wid, err_msg=repr(text))


def test_presplit_multibyte():
    texts = [
        "héllo wörld", "日本語 text", "🎉🚀 emoji", "é's contraction",
        "Ελληνικά'll test", "a\u00a0b", "\u2028line sep\u2029",
    ]
    arr, lens = _pack([t.encode() for t in texts])
    start, word_id, _ = _both(arr, lens)
    for i, text in enumerate(texts):
        ref_start, ref_wid = presplit_reference_np(text)
        n = int(lens[i])
        np.testing.assert_array_equal(start[i, :n].numpy(), ref_start, err_msg=repr(text))
        np.testing.assert_array_equal(word_id[i, :n].numpy(), ref_wid, err_msg=repr(text))


def _jax_outputs(arr, lens):
    return [np.asarray(e) for e in
            _jax_presplit(jnp.asarray(arr), jnp.asarray(lens), class_table_jnp())]


@pytest.mark.parametrize("L", [128, 512, 2048, 4096])
def test_presplit_edge_rows_equal_jax_and_the_scanner(L):
    """The edge rows (every trap at a row's start, across the kernel's
    128-column steps and at its end, lengths cutting into them, lengths of
    0, L, past L, negative and the int32 extremes, non-zero bytes past every
    length): ``presplit_plain`` and ``presplit`` on CPU tensors equal the JAX
    pre-split byte for byte, and the host scanner on each row whose text is
    valid UTF-8."""
    arr, lens = presplit_edge_rows(L)
    exp = _jax_outputs(arr, lens)
    args = (torch.from_numpy(arr), torch.from_numpy(lens), torch.from_numpy(gpt2_class_table()))
    before = presplit.launches
    for fn in (presplit_plain, presplit):
        got = fn(*args)
        for g, e, name in zip(got, exp, ("start", "word_id", "valid")):
            assert g.dtype == {np.bool_: torch.bool, np.int32: torch.int32}[e.dtype.type]
            np.testing.assert_array_equal(g.numpy(), e, err_msg=f"{name} at L={L}")
    assert presplit.launches == before  # a CPU tensor runs the plain version
    start, word_id = exp[0], exp[1]
    checked = 0
    for i in range(len(lens)):
        n = int(lens[i])
        if not 0 <= n <= L:
            continue
        try:
            text = arr[i, :n].tobytes().decode("utf-8")
        except UnicodeDecodeError:
            continue
        ref_start, ref_wid = presplit_reference_np(text)
        np.testing.assert_array_equal(start[i, :n], ref_start, err_msg=repr(text))
        np.testing.assert_array_equal(word_id[i, :n], ref_wid, err_msg=repr(text))
        checked += 1
    assert checked > len(lens) // 10


def _row(data: bytes, L: int, n: int, pad: int = 0x41):
    arr = np.full((1, L), pad, dtype=np.uint8)
    arr[0, : len(data)] = np.frombuffer(data, np.uint8)
    return arr, np.array([n], dtype=np.int32)


@pytest.mark.parametrize(
    "case,data,n,pad",
    [
        # byte 3 of a continuation run from column 0 takes the class computed
        # at column 0 (three propagation steps), not the fill's CL_NONE
        ("run of 4 from column 0", b"\x80\x80\x80\x80'sx", 7, 0x41),
        # in a run of 5 after a letter the last byte takes column 1's class
        ("run of 5 after a letter", b"a\x80\x80\x80\x80\x80 b", 8, 0x41),
        # a quote after a continuation byte whose class came from the fill
        ("quote after the fill", b"\x80'll", 4, 0x41),
        # a lead truncated at len - 1 decodes its tail from the bytes past len
        ("truncated lead", b"ab \xe4", 4, 0xB8),
        ("truncated lead, letters past len", b"ab \xc3", 4, 0x41),
        # contractions cut by the length, and at the row's very end
        ("'ll cut", b"we'll", 4, 0x6C),
        ("'re at L", b"we're", 5, 0x41),
        # a quote after an absorbed and after a non-absorbed space
        ("absorbed space", b"x 'sy", 5, 0x41),
        ("two spaces", b"x  'sy", 6, 0x41),
        ("length past L", b"it's", 2**31 - 1, 0x41),
        ("negative length", b"it's", -(2**31), 0x41),
    ],
)
def test_presplit_traps_equal_jax(case, data, n, pad):
    """Each trap on its own, at the widths 8 (the row ends inside the
    window) and 128: the plain version equals the JAX pre-split."""
    for L in (max(len(data), 5), 128):
        arr, lens = _row(data, L, n, pad)
        got = presplit_plain(torch.from_numpy(arr), torch.from_numpy(lens),
                             torch.from_numpy(gpt2_class_table()))
        for g, e in zip(got, _jax_outputs(arr, lens)):
            np.testing.assert_array_equal(g.numpy(), e, err_msg=f"{case}, L={L}")


def test_presplit_traps_are_in_the_edge_rows():
    """Every trap stands in the edge rows at a row's start at each width."""
    for L in (128, 512):
        arr, _lens = presplit_edge_rows(L)
        rows = {bytes(r[: len(t)]) for r in arr for t in PRESPLIT_TRAPS}
        assert all(t in rows for t in PRESPLIT_TRAPS)


def test_presplit_refuses_other_devices():
    arr = torch.zeros((2, 8), dtype=torch.uint8, device="meta")
    lens = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        presplit(arr, lens, torch.zeros(0x110000, dtype=torch.uint8, device="meta"))

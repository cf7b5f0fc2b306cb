"""The port's trainers against the JAX package's, on the CPU, bit for bit:
the native word count, ``BpeTrainer``, the INL-BPE trainer
(``InlBpeTrainer``, ``Trainer``), ``Tokenizer.train_new_from_iterator``,
and ``DistributedInlTrainer(device="cpu")`` (the kernels' plain versions)
against JAX's ``DistributedInlTrainer`` on the 8-device CPU mesh, in classic
and INL mode, on the device-resident route and on the per-merge route
(``CTOK_TRAINER_DEVICE_SELECT_MAX_V`` set low for both), with a window
that overflows its candidates; resumed from a checkpoint the JAX trainer
wrote mid-run; and at world size 2 (gloo, a ``file://`` store) against
world size 1.  Vocabularies up to 400 here; the golden files at 32K and
50K are checked by prefix (INL mode's and classic mode's selection does
not depend on the target size).  Every file a test writes lies in
``tmp_path``.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from helpers import SAMPLE_TEXT, trained_tokenizer_json

from complexity_tokenizer_tpu import native as jax_native
from complexity_tokenizer_tpu.parallel.trainer import DistributedInlTrainer as JaxDistributed
from complexity_tokenizer_tpu.tokenizer import Tokenizer as JaxTokenizer
from complexity_tokenizer_tpu.trainers.bpe_trainer import BpeTrainer as JaxBpe
from complexity_tokenizer_tpu.trainers.bpe_trainer import BpeTrainerConfig as JaxBpeConfig
from complexity_tokenizer_tpu.trainers.inl_trainer import InlBpeTrainer as JaxInl
from complexity_tokenizer_tpu.trainers.inl_trainer import TrainerConfig as JaxConfig
from complexity_tokenizer_tpu_torch import native
from complexity_tokenizer_tpu_torch.parallel.trainer import DistributedInlTrainer
from complexity_tokenizer_tpu_torch.tokenizer import Tokenizer
from complexity_tokenizer_tpu_torch.trainers import (
    BpeTrainer,
    BpeTrainerBuilder,
    BpeTrainerConfig,
    InlBpeTrainer,
    Trainer,
    TrainerConfig,
)
from complexity_tokenizer_tpu_torch.utils.corpus import MULTI_PIECES, zipf_corpus

import torch_train_worker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INL_32K = os.path.join(REPO, ".cache", "bench_inl_32k.json")
CLASSIC_50K = os.path.join(REPO, ".cache", "bench_tokenizer_r4_50k.json")
CLASSIC = dict(inl_alpha=0.0, inl_beta=0.0, inl_gate=0.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many ops on small tensors: with the test
    workers sharing the machine, torch's intra-op threads only wait on each
    other (one thread runs these tests many times faster under load)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def _quiet():
    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
        yield


def _texts(n=120, seed=5):
    return zipf_corpus(n, seed=seed) + list(MULTI_PIECES) + [SAMPLE_TEXT]


def _state(t):
    """What a trainer learned, comparable across the two packages."""
    return {
        "vocab": dict(t.vocab),
        "merges": [tuple(m) for m in t.merges],
        "token_freqs": {k: v for k, v in t.token_freqs.items()},
        "pair_freqs": {k: v for k, v in t.pair_freqs.items() if v > 0},
        "velocity": dict(t.velocity),
    }


@pytest.mark.parametrize("min_len", [1, 3])
def test_count_words_matches_jax_native(min_len):
    texts = _texts(300)
    got = native.count_words(texts, min_len)
    want = jax_native.count_words(texts, min_len)
    assert got is not None and got == want
    assert native.count_words(texts, min_len, n_threads=1) == want


def test_native_pack_matches_jax():
    data = [t.encode("utf-8") for t in _texts(40)]
    for L, B in ((512, len(data)), (16, len(data) + 30)):
        got, want = native.native_pack(data, L, B), jax_native.native_pack(data, L, B)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="rows"):
        native.native_pack(data, 16, len(data) - 1)


@pytest.mark.parametrize("cfg", [
    dict(vocab_size=300, min_frequency=2),
    dict(vocab_size=700, min_frequency=1, continuing_subword_prefix="##"),
    dict(vocab_size=260, min_frequency=1, end_of_word_suffix="</w>", limit_alphabet=30),
    dict(vocab_size=300, min_frequency=1, initial_alphabet=["z", "q", "!"], special_tokens=[]),
])
def test_bpe_trainer_matches_jax(cfg):
    texts = _texts()
    with _quiet():
        got = BpeTrainer(BpeTrainerConfig(**cfg)).train(texts)
        want = JaxBpe(JaxBpeConfig(**cfg)).train(texts)
    assert got == want and len(got[1]) > 50


def test_bpe_trainer_chained_config_and_iterator():
    b = (BpeTrainerBuilder().vocab_size(280).min_frequency(1).special_tokens(["<s>"])
         .show_progress(False).limit_alphabet(40).build())
    texts = _texts(60)
    want = JaxBpe(JaxBpeConfig(vocab_size=280, min_frequency=1, special_tokens=["<s>"],
                               show_progress=False, limit_alphabet=40)).train(texts)
    assert b.train_from_iterator(iter(texts)) == want
    assert BpeTrainer.with_vocab_size(123).config.vocab_size == 123


@pytest.mark.parametrize("mode", [CLASSIC, {}, dict(inl_gate=0.2, inl_beta=1.5)])
def test_inl_trainer_matches_jax_and_saves_the_same_bytes(mode, tmp_path):
    texts = _texts()
    cfg = dict(vocab_size=400, min_frequency=1, **mode)
    with _quiet():
        got = Trainer(**cfg)
        got.train_from_texts(texts)
        want = JaxInl(JaxConfig(**cfg))
        want.train_from_texts(texts)
    assert isinstance(got, InlBpeTrainer)
    assert _state(got) == _state(want) and len(got.merges) > 200
    got.save(tmp_path / "port.json")
    want.save(tmp_path / "jax.json")
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()


def test_streaming_and_files_match_jax(tmp_path):
    texts = _texts()
    cfg = dict(vocab_size=350, min_frequency=2)
    path = tmp_path / "corpus.txt"
    path.write_text("\n".join(texts), encoding="utf-8")
    with _quiet():
        a = InlBpeTrainer(TrainerConfig(**cfg))
        for i in range(0, len(texts), 40):
            a.count_batch(texts[i : i + 40])
        a.finish_training()
        b = JaxInl(JaxConfig(**cfg))
        for i in range(0, len(texts), 40):
            b.count_batch(texts[i : i + 40])
        b.finish_training()
        c = InlBpeTrainer(TrainerConfig(**cfg))
        c.train([str(path)])
        d = JaxInl(JaxConfig(**cfg))
        d.train([str(path)])
    assert _state(a) == _state(b) and _state(c) == _state(d)


def test_save_writes_the_jax_warm_cache_file(tmp_path):
    """At 4,096 entries and more, save() also writes ``<stem>.warmcache.npz``
    (the corpus's words merged under the final table): the same arrays and
    key as the JAX package's."""
    texts = zipf_corpus(1500, seed=8, lo=100, hi=800)
    cfg = dict(vocab_size=4200, min_frequency=1, **CLASSIC)
    with _quiet():
        got = InlBpeTrainer(TrainerConfig(**cfg))
        got.train_from_texts(texts)
        want = JaxInl(JaxConfig(**cfg))
        want.train_from_texts(texts)
        got.save(tmp_path / "port.json")
        want.save(tmp_path / "jax.json")
    assert got.merges == want.merges and len(got.vocab) == 4200
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    with np.load(tmp_path / "port.warmcache.npz") as g, np.load(tmp_path / "jax.warmcache.npz") as w:
        assert sorted(g.files) == sorted(w.files)
        for k in w.files:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_train_new_from_iterator_matches_jax():
    js = trained_tokenizer_json()
    texts = ["aaa bbb aaa", "bbb aaa bbb", "ab ab ab"] + _texts(60)
    with _quiet():
        got = Tokenizer.from_str(js).train_new_from_iterator(texts, vocab_size=330)
        want = JaxTokenizer.from_str(js).train_new_from_iterator(texts, vocab_size=330)
    assert got.get_vocab() == want.get_vocab() and got.vocab_size == want.vocab_size > 260
    assert got.special_tokens == want.special_tokens
    assert type(got.pre_tokenizer).__name__ == type(want.pre_tokenizer).__name__ == "ByteLevel"
    for t in texts[:20]:
        assert got.encode(t) == want.encode(t)


def test_package_exports():
    import complexity_tokenizer_tpu_torch as pkg
    from complexity_tokenizer_tpu_torch import parallel, trainers
    from complexity_tokenizer_tpu_torch.parallel.unigram_trainer import DistributedUnigramTrainer
    from complexity_tokenizer_tpu_torch.parallel.wordpiece_trainer import (
        DistributedWordPieceTrainer,
    )
    from complexity_tokenizer_tpu_torch.trainers.unigram_trainer import (
        UnigramTrainer,
        UnigramTrainerConfig,
    )
    from complexity_tokenizer_tpu_torch.trainers.wordpiece_trainer import (
        WordPieceTrainer,
        WordPieceTrainerConfig,
    )

    assert pkg.Trainer is InlBpeTrainer and pkg.BpeTrainer is BpeTrainer
    assert parallel.DistributedInlTrainer is DistributedInlTrainer
    # the WordPiece and Unigram trainers, on the host and on the card
    for mod in (pkg, trainers):
        assert mod.WordPieceTrainer is WordPieceTrainer
        assert mod.WordPieceTrainerConfig is WordPieceTrainerConfig
        assert mod.UnigramTrainer is UnigramTrainer
        assert mod.UnigramTrainerConfig is UnigramTrainerConfig
    assert {"WordPieceTrainer", "UnigramTrainer"} <= set(pkg.__all__) & set(trainers.__all__)
    assert parallel.DistributedWordPieceTrainer is DistributedWordPieceTrainer
    assert parallel.DistributedUnigramTrainer is DistributedUnigramTrainer
    with pytest.raises(AttributeError):
        parallel.DistributedBpeTrainer


def _train_both(cfg, texts, monkeypatch, max_v=None, window_t=None):
    if max_v is not None:
        monkeypatch.setenv("CTOK_TRAINER_DEVICE_SELECT_MAX_V", str(max_v))
    if window_t is not None:
        monkeypatch.setattr(DistributedInlTrainer, "_INL_WINDOW_T", window_t)
        monkeypatch.setattr(JaxDistributed, "_INL_WINDOW_T", window_t)
    with _quiet():
        got = DistributedInlTrainer(TrainerConfig(**cfg), device="cpu")
        got.train_from_texts(texts)
        want = JaxDistributed(JaxConfig(**cfg))
        want.train_from_texts(texts)
    return got, want


@pytest.mark.parametrize("mode,route", [
    ("classic", "device-resident"), ("classic", "per merge"),
    ("inl", "device-resident"), ("inl", "per merge"), ("inl", "window overflows"),
])
def test_distributed_trainer_matches_jax(mode, route, monkeypatch):
    cfg = dict(vocab_size=330 if route == "window overflows" else 380, min_frequency=1,
               **(CLASSIC if mode == "classic" else {}))
    texts = ["aaa bbb aaa bbb ccc ddd " * 3, SAMPLE_TEXT] + _texts(40)
    got, want = _train_both(cfg, texts, monkeypatch,
                            max_v=1 if route == "per merge" else None,
                            window_t=4 if route == "window overflows" else None)
    assert _state(got) == _state(want) and len(got.merges) > 150
    device_resident = route != "per merge"
    assert bool(getattr(got, "_select_block_times", None)) == device_resident
    assert bool(getattr(want, "_select_block_times", None)) == device_resident


@pytest.mark.parametrize("mode", ["classic", "inl"])
def test_chip_smoke_block_and_window_replays_match_jax(mode):
    """``chip_smoke.py``'s replays of the device-resident routes, from which
    it and ``scripts/study_merge_variants.py`` take the blocks and windows
    they check and time: the classic route's blocks of 32 steps
    (``classic_blocks``) and the INL route's windows with the host's scoring
    between them (``inl_windows``), run on the CPU, give JAX's merges, and
    each kept input starts where the block or window before it ended."""
    import importlib.util

    from complexity_tokenizer_tpu_torch.ops.trainer_device import pair_hist

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfg = dict(vocab_size=380, min_frequency=1, **(CLASSIC if mode == "classic" else {}))
    texts = ["aaa bbb aaa bbb ccc ddd " * 3, SAMPLE_TEXT] + _texts(40)
    with _quiet():
        want = JaxDistributed(JaxConfig(**cfg))
        want.train_from_texts(texts)
    if mode == "classic":
        t, words, freqs = smoke._train_state(texts, cfg, "cpu")
        v0 = len(t.vocab)
        hist = torch.zeros(380, 380, dtype=torch.int32)
        hist[:v0, :v0] = pair_hist(words, freqs, v0).view(v0, v0)
        ids, kept = smoke.classic_blocks(words, freqs, hist, v0, 380 - v0)
        inv = {i: tok for tok, i in t.vocab.items()}
        merges = []
        for i, (a, b) in enumerate(ids):
            merges.append((inv[a], inv[b]))
            inv[v0 + i] = inv[a] + inv[b]
    else:
        t, kept = smoke.inl_windows(texts, cfg, device="cpu")
        merges, v0 = t.merges, len(t.vocab) - len(t.merges)
    assert merges == want.merges and len(merges) > 150
    blocks = [kept[i] for i in sorted(kept)]
    assert sorted(kept) == list(range(len(blocks))) and blocks[0]["v0b"] == v0
    for blk, nxt in zip(blocks, blocks[1:]):
        assert nxt["v0b"] == blk["v0b"] + blk["n_do"]
    assert sum(blk["n_do"] for blk in blocks) >= len(merges)


def _checkpointed_jax_run(tmp_path, cfg, interval):
    path = tmp_path / "ck.json"
    with _quiet():
        full = JaxInl(JaxConfig(**cfg, checkpoint_path=str(path), checkpoint_interval=interval))
        full.train_from_texts(_texts())
    with open(path, encoding="utf-8") as f:
        at = len(json.load(f)["merges"])
    assert 0 < at < len(full.merges)  # taken mid-run
    return path, full


@pytest.mark.parametrize("mode,interval", [("classic", 70), ("inl", 100)])
def test_resume_from_a_jax_checkpoint(mode, interval, tmp_path, monkeypatch):
    """The port's trainers resume a checkpoint the JAX trainer wrote mid-run
    and end at the JAX trainer's merges: the host trainer, and the device
    trainer on the per-merge route (the checkpoint's own schedule) and on
    the device-resident route (no schedule)."""
    cfg = dict(vocab_size=400, min_frequency=1, **(CLASSIC if mode == "classic" else {}))
    path, full = _checkpointed_jax_run(tmp_path, cfg, interval)
    want = _state(full)
    with _quiet():
        host = InlBpeTrainer.resume_training(str(path))
        per_merge = DistributedInlTrainer.resume_training(str(path), device="cpu")
        resident = DistributedInlTrainer.resume_training(
            str(path), TrainerConfig(**cfg), device="cpu")
    assert _state(host) == want
    assert _state(per_merge) == want and not getattr(per_merge, "_select_block_times", None)
    assert _state(resident)["merges"] == want["merges"] and resident._select_block_times
    assert _state(resident) == want


def test_world_size_two_equals_world_size_one(tmp_path):
    """Two processes over gloo (a ``file://`` store), each with half the
    rows, learn what one process learns, on every route."""
    import time

    import torch.multiprocessing as mp

    ctx = mp.start_processes(torch_train_worker.run_world_member,
                             args=(str(tmp_path / "store"), 2, str(tmp_path)), nprocs=2,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + 240
    while not ctx.join(timeout=5):  # raises if a member failed
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise AssertionError("the two processes did not finish in 240 s")
    want = torch_train_worker.train_all()
    for rank in range(2):
        with open(tmp_path / f"rank{rank}.json") as f:
            assert json.load(f) == json.loads(json.dumps(want)), rank
    assert len(want[0]["merges"]) > 60


def test_host_trainer_is_a_prefix_of_the_golden_files():
    """INL mode (the reference's settings, min_frequency 2) and classic mode
    (bench.py's, min_frequency 1) on the golden files' corpus at 400
    entries: their merges are the first merges of ``.cache/bench_inl_32k.json``
    and ``.cache/bench_tokenizer_r4_50k.json``."""
    texts = zipf_corpus(8000, seed=29, lo=100, hi=800)
    for path, cfg in ((INL_32K, dict(min_frequency=2)), (CLASSIC_50K, dict(min_frequency=1, **CLASSIC))):
        with open(path, encoding="utf-8") as f:
            golden = [tuple(m.split(" ")) for m in json.load(f)["model"]["merges"]]
        with _quiet():
            t = InlBpeTrainer(TrainerConfig(vocab_size=400, **cfg))
            t.train_from_texts(texts)
        assert len(t.merges) > 300 and t.merges == golden[: len(t.merges)], path

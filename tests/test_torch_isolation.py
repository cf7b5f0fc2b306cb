"""The port stands alone and never carries on quietly on the CPU.

(g) It imports neither JAX nor the JAX package, at run time (a fresh
subprocess) and in its source (an AST scan, ``chip_smoke.py`` included).
(h) Its entry points, called with no ``device``, raise when there is no
card (``encode_batch``, the pipelines and ``EncodePipeline.encode_batch``,
the word-level models' ``encode_batch``, and ``__call__`` with
``return_tensors="pt"`` or ``add_special_tokens=False``).  Also: the loader refuses a model the port does not run, and the
kernel build raises without ``nvcc``.
"""

import ast
import json
import os
import subprocess
import sys

import pytest
import torch

from complexity_tokenizer_tpu_torch.ops.pipeline import build_encode_pipeline
from complexity_tokenizer_tpu_torch.tokenizer import Tokenizer
from complexity_tokenizer_tpu_torch.utils import cuda_build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "complexity_tokenizer_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "complexity_tokenizer_tpu")


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_port_imports_nothing_of_jax_at_run_time():
    mods = []
    for path in _port_sources():
        if path.startswith(PORT):
            rel = os.path.relpath(path, REPO)[: -len(".py")].replace(os.sep, ".")
            mods.append(rel[: -len(".__init__")] if rel.endswith(".__init__") else rel)
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "import complexity_tokenizer_tpu_torch as p; p.Tokenizer\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "complexity_tokenizer_tpu_torch.tokenizer" in loaded
    assert [m for m in loaded if _forbidden(m)] == []


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_import_in_source(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                bad.append(node.module)
    assert bad == []


def test_no_kernel_source_includes_torch_headers():
    csrc = os.path.join(PORT, "csrc")
    for f in os.listdir(csrc):
        with open(os.path.join(csrc, f), encoding="utf-8") as fh:
            text = fh.read()
        assert "torch/extension.h" not in text and "#include <torch" not in text, f


TINY = json.dumps(
    {
        "model": {"type": "BPE", "vocab": {"a": 0, "b": 1, "ab": 2}, "merges": ["a b"]},
        "pre_tokenizer": {"type": "ByteLevel", "add_prefix_space": False},
        "normalizer": None,
        "added_tokens": [],
    }
)


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_encode_batch_without_device_raises_without_card(no_card):
    tok = Tokenizer.from_str(TINY)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tok.encode_batch(["ab ab"], backend="auto")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tok.encode_batch(["ab ab"], backend="device", device="cuda")
    # the CPU is used when asked for, and only then
    assert tok.encode_batch(["ab ab"], backend="auto", device="cpu") == tok.encode_batch(
        ["ab ab"], backend="host"
    )


def test_call_without_device_raises_without_card(no_card):
    """``__call__`` puts ``"pt"`` tensors on the card and runs
    ``add_special_tokens=False`` through ``encode_batch``: with no
    ``device`` both raise where there is no card; on ``device="cpu"`` they
    run, and the host-only routes need no device."""
    tok = Tokenizer.from_str(TINY)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tok(["ab ab", "ab"], padding="longest", return_tensors="pt")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tok(["ab ab", "ab"], add_special_tokens=False)
    got = tok(["ab ab", "ab"], padding="longest", return_tensors="pt", device="cpu")
    assert got.input_ids.device.type == "cpu" and got.input_ids.dtype == torch.int32
    assert tok(["ab ab"], add_special_tokens=False, device="cpu").input_ids == [[2, 2]]
    assert tok(["ab ab"]).input_ids == tok(["ab ab"], return_tensors="np").input_ids.tolist()


def test_pipeline_without_device_raises_without_card(no_card):
    tok = Tokenizer.from_str(TINY)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_encode_pipeline(tok)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tok.pipeline()


def _models():
    from complexity_tokenizer_tpu_torch import (
        ByteLevelBpeModel,
        CharBpeModel,
        WordLevelModel,
        WordPieceModel,
    )

    return [
        ByteLevelBpeModel({"a": 0, "b": 1, "ab": 2}, [("a", "b")]),
        CharBpeModel({"a": 0, "b</w>": 1, "ab</w>": 2}, [("a", "b</w>")]),
        WordPieceModel({"[UNK]": 0, "ab": 1, "##b": 2}),
        WordLevelModel({"<unk>": 0, "ab": 1}),
        # an ineligible table: the host route, but the device is resolved all the same
        CharBpeModel({"a": 0}, []),
    ]


@pytest.mark.parametrize("i", range(5))
def test_models_without_device_raise_without_card(no_card, i):
    """The models' ``encode_batch`` with no ``device`` runs on ``cuda`` and
    raises where there is no card; ``device="cpu"`` runs the plain
    versions, equal to the host ``encode``."""
    model = _models()[i]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.encode_batch(["ab ab", "b"])
    assert model.encode_batch(["ab ab", "b"], device="cpu") == [
        model.encode("ab ab"), model.encode("b")]


def test_norm_checker_and_pipeline_encode_batch_without_device_raise(no_card):
    from complexity_tokenizer_tpu_torch.core.normalizers import NFC
    from complexity_tokenizer_tpu_torch.ops.normalize_device import (
        DeviceNormChecker,
        plan_for_normalizer,
    )

    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceNormChecker(plan_for_normalizer(NFC()))
    tok = Tokenizer.from_str(TINY)
    tok.set_normalizer(NFC())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tok.pipeline().encode_batch(["ab"])
    texts = ["ab", "a\u0301b", "ab\u00e9"]
    assert tok.pipeline("cpu").encode_batch(texts) == tok.encode_batch(texts, backend="host")


def test_device_path_refuses_ineligible_tables():
    """Past u16 the cuckoo table is ineligible: backend="device" runs the CHD
    fixpoint (K5's plain version on the CPU) and gives the host's ids, and
    a table with neither a cuckoo nor a CHD table raises."""
    vocab = {"a": 0, "b": 1, "ab": 70000}
    tok = Tokenizer.from_str(
        json.dumps({"model": {"type": "BPE", "vocab": vocab, "merges": ["a b"]}})
    )
    assert tok.device_tables().qc is None and tok.device_tables().chd is not None
    assert tok.encode_batch(["ab"], backend="device", device="cpu") == [[70000]]
    assert tok.encode_batch(["ab"], backend="host") == [[70000]]
    tok.device_tables().chd = None  # as when build_chd_table fails
    tok._pipelines.clear()
    tok._word_paths.clear()
    with pytest.raises(NotImplementedError, match="CHD"):
        tok.encode_batch(["ab"], backend="device", device="cpu")


@pytest.mark.parametrize(
    "patch,field",
    [
        ({"model": {"type": "WordPiece", "vocab": {}}}, "model.type"),
    ],
)
def test_loader_refuses_unported_config(patch, field):
    j = json.loads(TINY)
    j.update(patch)
    with pytest.raises(NotImplementedError, match=field):
        Tokenizer.from_str(json.dumps(j))


def test_loader_defaults_follow_the_reference():
    j = json.loads(TINY)
    del j["normalizer"], j["pre_tokenizer"]
    tok = Tokenizer.from_str(json.dumps(j))
    assert tok.normalizer is not None and tok.normalizer.form == "NFC"
    assert tok.pre_tokenizer.add_prefix_space is False


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(cuda_build, "_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(cuda_build, "_loaded", None)
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.kernel_library()

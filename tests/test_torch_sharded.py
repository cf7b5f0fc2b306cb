"""The sharded encode (``parallel/encode.py``, ``parallel/mesh.py``, the
sharded word fill of ``ops/wordpath.py`` and the sharded text pipeline of
``ops/pipeline.py``) on the CPU: at 2 and 8 blocks against the unsharded
port fill, bit for bit, the spill redispatch included; against the JAX
package's sharded fill on its 8-device CPU mesh; the text pipeline against
the host oracle at a batch that is not a multiple of the blocks; and the
setters.  Ids exactly."""

import numpy as np
import pytest
import torch

from helpers import conformance_corpus, trained_tokenizer_json

jax = pytest.importorskip("jax")

from complexity_tokenizer_tpu.parallel import data_mesh as jax_data_mesh  # noqa: E402
from complexity_tokenizer_tpu.parallel.encode import (  # noqa: E402
    shard_word_encoder as jax_shard_word_encoder,
)
from complexity_tokenizer_tpu.tokenizer import Tokenizer as JaxTokenizer  # noqa: E402
from complexity_tokenizer_tpu_torch import parallel  # noqa: E402
from complexity_tokenizer_tpu_torch.parallel import (  # noqa: E402
    BatchSharding,
    batch_sharding,
    data_mesh,
    shard_encode_pipeline,
    shard_word_encoder,
)
from complexity_tokenizer_tpu_torch.tokenizer import Tokenizer  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small plain-version ops: one torch thread runs them fastest
    when the test workers share the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fresh():
    return Tokenizer.from_str(trained_tokenizer_json())


def _low_merge_words(seed: int = 3, n_w: int = 700):
    """The JAX package's ``test_sharded_word_fill_matches_unsharded`` words:
    random lowercase words of 1-13 letters that barely merge, so the
    compact 3/8 capacity overflows and the spill redispatch runs."""
    rng = np.random.RandomState(seed)
    wlens = rng.randint(1, 14, size=n_w).astype(np.int32)
    wbuf = (rng.randint(0, 26, size=int(wlens.sum())) + 97).astype(np.uint8)
    return wbuf, wlens


@pytest.fixture(scope="module")
def unsharded():
    """(ids, counts, spills) of the unsharded port fill of the low-merge
    words."""
    wp = _fresh()._get_word_path("cpu")
    wbuf, wlens = _low_merge_words()
    ids, counts = wp._encode_words_packed(wbuf, wlens)
    assert (counts >= 0).all()
    return ids, counts, wp.last_fill["spills"]


def test_mesh_helpers():
    mesh = data_mesh(devices=["cpu", torch.device("cpu"), "cuda"])
    assert mesh == (torch.device("cpu"), torch.device("cpu"), torch.device("cuda", 0))
    assert data_mesh(n_devices=1, devices=["cpu", "cpu"]) == (torch.device("cpu"),) * 2
    sh = batch_sharding(mesh[:2])
    assert isinstance(sh, BatchSharding) and sh.n_devices == 2
    assert sh.blocks(8) == [(torch.device("cpu"), slice(0, 4)), (torch.device("cpu"), slice(4, 8))]
    with pytest.raises(ValueError):
        sh.blocks(7)
    with pytest.raises(ValueError):
        data_mesh(devices=[])
    with pytest.raises(ValueError):
        data_mesh(devices=["meta"])
    assert parallel.shard_word_encoder is shard_word_encoder
    assert parallel.shard_encode_pipeline is shard_encode_pipeline


@pytest.mark.parametrize("ndev", [2, 8])
def test_sharded_word_fill_matches_unsharded(unsharded, ndev):
    """Blocks of 1/ndev of each pack's rows, each compacted alone, give the
    unsharded fill's ids and counts bit for bit, the spill redispatch (at
    full capacity, sharded) included."""
    ids_1, cnt_1, spills_1 = unsharded
    wp = _fresh()._get_word_path("cpu")
    assert shard_word_encoder(wp, data_mesh(devices=["cpu"] * ndev)) is wp
    wbuf, wlens = _low_merge_words()
    ids_n, cnt_n = wp._encode_words_packed(wbuf, wlens)
    assert wp.last_fill["blocks"] == ndev
    assert wp.last_fill["spills"] == spills_1 > 0
    assert cnt_n.tolist() == cnt_1.tolist()
    assert ids_n.tolist() == ids_1.tolist()


def test_sharded_word_fill_matches_jax_sharded_fill():
    """The port's fill at 8 CPU blocks against the JAX package's shard_map
    fill on its 8-device CPU mesh: ids and counts, and one pack's per-block
    fused buffers byte for byte."""
    assert len(jax.devices()) == 8
    js = trained_tokenizer_json()
    jt = JaxTokenizer.from_str(js)
    jwp = jt._get_word_path()
    jax_shard_word_encoder(jwp, jax_data_mesh())
    wp = Tokenizer.from_str(js)._get_word_path("cpu")
    shard_word_encoder(wp, data_mesh(devices=["cpu"] * 8))
    wbuf, wlens = _low_merge_words()
    ids_j, cnt_j = jwp._encode_words_packed(wbuf, wlens)
    ids_p, cnt_p = wp._encode_words_packed(wbuf, wlens)
    assert cnt_p.tolist() == cnt_j.tolist()
    assert ids_p.tolist() == ids_j.tolist()
    # one pack of 64 rows: 8 blocks of 8, each with its own layout
    offs = np.zeros(len(wlens) + 1, np.int64)
    np.cumsum(wlens, out=offs[1:])
    arr, marks, _starts, _n_fit, _used = wp._pack_seg(wbuf, offs, 0, len(wlens), 64)
    bits = np.packbits(marks == 1, axis=1, bitorder="little")
    row_len = (marks > 0).sum(axis=1).astype(np.int32)
    for port_fn, jax_fn in ((wp._fn_sharded, jwp._fn_sharded),
                            (wp._fn_full_sharded, jwp._fn_full_sharded)):
        got = b"".join(wp._raw(blk).tobytes() for blk in port_fn(arr, bits, row_len))
        exp = np.asarray(jax_fn(*(jax.device_put(x, jwp.sharding) for x in (arr, bits, row_len))))
        assert got == exp.tobytes()


def test_word_path_on_a_mesh_that_does_not_divide_a_pack():
    """A pack whose rows do not split over the mesh goes out unsharded, on
    the encoder's device, as in JAX (``B % n_devices``)."""
    wp = _fresh()._get_word_path("cpu")
    shard_word_encoder(wp, data_mesh(devices=["cpu"] * 3))
    words = [b"hello", b"world", b"the", b"quick", b"fox"] * 20
    buf = np.frombuffer(b"".join(words), np.uint8)
    lens = np.array([len(w) for w in words], np.int32)
    ids, counts = wp._encode_words_packed(buf, lens)
    assert wp._blocks is None  # no block was launched
    bounds = np.zeros(len(counts) + 1, np.int64)
    np.cumsum(counts, out=bounds[1:])
    for w, word in enumerate(words):
        assert ids[bounds[w] : bounds[w + 1]].tolist() == wp.native.encode(word)


def test_setting_sharding_drops_the_per_device_state():
    """The word path's and the pipeline's blocks (tables, streams) belong to
    the mesh they were made for: any assignment drops them."""
    pt = _fresh()
    wp = pt._get_word_path("cpu")
    mesh = data_mesh(devices=["cpu", "cpu"])
    shard_word_encoder(wp, mesh)
    wbuf, wlens = _low_merge_words(n_w=100)
    wp._encode_words_packed(wbuf, wlens)
    blocks = wp._blocks
    assert len(blocks) == 2 and blocks[0][1] is wp.pipeline.tables
    assert blocks[0][1] is blocks[1][1]  # one copy of the tables a device
    wp.sharding = batch_sharding(mesh)
    assert wp._blocks is None and wp.sharding.n_devices == 2
    wp._encode_words_packed(wbuf, wlens)
    assert wp._blocks is not None and wp._blocks is not blocks
    wp.sharding = None
    assert wp._blocks is None and wp.sharding is None
    pipe = pt.pipeline("cpu")
    shard_encode_pipeline(pipe, data_mesh(devices=["cpu"] * 3))
    assert pipe.n_devices == 3
    pipe.encode_bytes([b"hello world"])
    assert len(pipe._blocks) == 3
    pipe.sharding = None
    assert pipe._blocks is None and pipe.n_devices == 1


@pytest.mark.parametrize("ndev", [3, 8])
def test_sharded_text_pipeline_matches_host_oracle(ndev):
    """The text pipeline split over ndev CPU blocks equals the host oracle
    on the conformance corpus (its batches of 256 and 16 rows pad to 258
    and 18 at 3 blocks, the JAX package's rule)."""
    js = trained_tokenizer_json()
    jt = JaxTokenizer.from_str(js)
    pt = Tokenizer.from_str(js)
    pipe = pt.pipeline("cpu")
    shard_encode_pipeline(pipe, data_mesh(devices=["cpu"] * ndev))
    texts = conformance_corpus()
    data = pt._prepare_bytes([pt._normalize(t) for t in texts])
    rows = []
    encode_rows = pipe.encode_rows
    pipe.encode_rows = lambda arr, lens: rows.append(arr.shape[0]) or encode_rows(arr, lens)
    got = pipe.encode_bytes(data)
    assert rows == ([258, 18] if ndev == 3 else [256, 16])
    for t, g in zip(texts, got):
        assert g == jt._encode_host(t), repr(t)


def test_background_fill_on_a_mesh_stays_exact(monkeypatch):
    """``backend="auto"`` with the word path sharded over 2 CPU blocks and
    phased: the background fill covers every block, and the batches equal
    the host oracle before and after it lands."""
    js = trained_tokenizer_json()
    jt = JaxTokenizer.from_str(js)
    monkeypatch.setenv("CTOK_PHASE_N1", "6")
    pt = Tokenizer.from_str(js)
    wp = shard_word_encoder(pt._auto_word_path("cpu"), data_mesh(devices=["cpu", "cpu"]))
    assert wp._phase_n1 == 6
    texts = conformance_corpus() * 3
    host = [jt._encode_host(t) for t in texts]
    assert pt.encode_batch(texts, backend="auto", device="cpu") == host
    assert wp.drain_async(timeout=300) > 0
    assert wp.last_fill["blocks"] == 2 and wp.last_fill["phase_n1"] == 6
    assert pt.encode_batch(texts, backend="auto", device="cpu") == host

"""Port tables vs the JAX package's: bit-identical, array for array, and
carried onto a device by ``convert.tables_to_device``."""

import os

import numpy as np
import pytest
import torch

from helpers import trained_tokenizer_json

jax = pytest.importorskip("jax")

from complexity_tokenizer_tpu.ops.tables import build_device_tables as jax_build  # noqa: E402
from complexity_tokenizer_tpu.tokenizer import Tokenizer as JaxTokenizer  # noqa: E402
from complexity_tokenizer_tpu.utils.unicode_tables import (  # noqa: E402
    gpt2_class_table as jax_class_table,
)
from complexity_tokenizer_tpu_torch.convert import tables_to_device  # noqa: E402
from complexity_tokenizer_tpu_torch.ops.hashtable import build_chd_table  # noqa: E402
from complexity_tokenizer_tpu_torch.ops.tables import build_device_tables  # noqa: E402
from complexity_tokenizer_tpu_torch.tokenizer import Tokenizer  # noqa: E402
from complexity_tokenizer_tpu_torch.utils.unicode_tables import gpt2_class_table  # noqa: E402

BENCH_50K = os.path.join(
    os.path.dirname(__file__), "..", ".cache", "bench_tokenizer_r4_50k.json"
)


def _json(name):
    if name == "fixture800":
        return trained_tokenizer_json()
    with open(BENCH_50K, encoding="utf-8") as f:
        return f.read()


@pytest.fixture(scope="module", params=["fixture800", "bench50k"])
def both(request):
    """(port tokenizer, port tables, JAX tokenizer, JAX tables), built once."""
    js = _json(request.param)
    pt = Tokenizer.from_str(js)
    jt = JaxTokenizer.from_str(js)
    return pt, build_device_tables(pt.bpe), jt, jax_build(jt.bpe)


def test_merge_tables_match(both):
    pt, _, jt, _ = both
    assert pt.bpe.merge_ranks == jt.bpe.merge_ranks
    assert pt.bpe.merge_ops == jt.bpe.merge_ops
    assert pt.bpe.vocab == jt.bpe.vocab


def test_byte_token_table_and_flags_match(both):
    _, tp, _, tj = both
    np.testing.assert_array_equal(tp.byte_token_table, tj.byte_token_table)
    assert tp.byte_token_table.dtype == tj.byte_token_table.dtype
    assert tp.well_formed == tj.well_formed


def test_qc_table_matches(both):
    _, tp, _, tj = both
    assert tj.qc is not None and tp.qc is not None
    assert tp.qc.size == tj.qc.size
    for a, b in ((tp.qc.t1, tj.qc.t1), (tp.qc.t2, tj.qc.t2)):
        assert a.dtype == b.dtype == np.uint32
        np.testing.assert_array_equal(a, b)


def test_chd_table_matches(both):
    """The port's CHD builder against the table the JAX package's
    build_device_tables holds.  The port's build_device_tables builds none
    where the cuckoo table fits (K5 reads it only past u16)."""
    pt, tp, _, tj = both
    assert tp.qc is not None and tp.chd is None
    chd = build_chd_table(pt.bpe.merge_ranks, pt.bpe.merge_ops)
    assert (chd.size, chd.n_buckets) == (tj.chd.size, tj.chd.n_buckets)
    np.testing.assert_array_equal(chd.disp, tj.chd.disp)
    np.testing.assert_array_equal(chd.rows, tj.chd.rows)


def test_class_table_matches():
    np.testing.assert_array_equal(gpt2_class_table(), jax_class_table())


def test_convert_carries_jax_tables(both):
    """The JAX package's DeviceTables fields, as numpy, become the port's
    tensors bit for bit (u32 rows held as their int32 view)."""
    _, _, _, tj = both
    tt = tables_to_device(
        byte_token_table=tj.byte_token_table,
        qc_t1=tj.qc.t1,
        qc_t2=tj.qc.t2,
        qc_size=tj.qc.size,
        chd_disp=tj.chd.disp,
        chd_rows=tj.chd.rows,
        class_table=jax_class_table(),
        device="cpu",
    )
    assert all(
        t.device == torch.device("cpu")
        for t in (tt.byte_token_table, tt.qc_t1, tt.qc_t2, tt.chd_rows, tt.class_table)
    )
    assert tt.byte_token_table.dtype == torch.int32
    assert tt.qc_t1.dtype == tt.qc_t2.dtype == torch.int32
    np.testing.assert_array_equal(tt.byte_token_table.numpy(), tj.byte_token_table)
    np.testing.assert_array_equal(tt.qc_t1.numpy().view(np.uint32), tj.qc.t1)
    np.testing.assert_array_equal(tt.qc_t2.numpy().view(np.uint32), tj.qc.t2)
    assert tt.qc_size == tj.qc.size
    np.testing.assert_array_equal(tt.chd_disp.numpy(), tj.chd.disp)
    np.testing.assert_array_equal(tt.chd_rows.numpy(), tj.chd.rows)
    assert tt.class_table.dtype == torch.uint8
    np.testing.assert_array_equal(tt.class_table.numpy(), jax_class_table())


def test_convert_rejects_bad_shapes():
    t = np.zeros((64, 2), np.uint32)
    kw = dict(
        byte_token_table=np.zeros(256, np.int32),
        qc_t1=t,
        qc_t2=t,
        chd_disp=np.zeros(4, np.int32),
        chd_rows=np.zeros((16, 4), np.int32),
        class_table=np.zeros(16, np.uint8),
        device="cpu",
    )
    with pytest.raises(ValueError):
        tables_to_device(qc_size=128, **kw)
    with pytest.raises(ValueError):
        tables_to_device(qc_size=63, **{**kw, "qc_t1": t[:63], "qc_t2": t[:63]})

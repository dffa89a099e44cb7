"""Native C++ parser: build, parse, and bit-exact hash parity with the
python spec (recsys/data/hashing.py)."""

import numpy as np
import pytest

from recsys.core.config import CriteoConfig
from recsys.data import criteo, hashing, native

pytestmark = pytest.mark.skipif(
    not native.available(), reason="no native toolchain"
)

CFG = CriteoConfig()


def test_parse_matches_python_path():
    rows = [
        "1\t" + "\t".join(str(i) for i in range(13)) + "\t"
        + "\t".join(f"cat{j:02d}" for j in range(26)),
        "0\t\t5\t\t7" + "\t" * 9 + "\t" + "\t".join([""] * 13)
        + "\t".join(["x"] + [""] * 12),
        "1\t-3\t" + "\t".join(["2"] * 12) + "\t" + "\t".join(["deadbeef"] * 26),
    ]
    blob = ("\n".join(rows) + "\n").encode()
    labels, cont, cat, consumed = native.parse_criteo_bytes(
        blob, CFG.cat_vocabs)
    assert consumed == len(blob)
    assert len(labels) == 3
    np.testing.assert_array_equal(labels, [1, 0, 1])

    py_labels, py_cont, py_cat = criteo.parse_tsv_chunk(
        [r + "\n" for r in rows])
    np.testing.assert_array_equal(labels, py_labels)
    # cont: NaNs in same places, values equal
    np.testing.assert_array_equal(np.isnan(cont), np.isnan(py_cont))
    np.testing.assert_allclose(np.nan_to_num(cont), np.nan_to_num(py_cont))
    # categorical hashing bit-exact vs python spec (incl. NULL fill)
    py_ids = criteo.hash_cat(py_cat, CFG)
    np.testing.assert_array_equal(cat, py_ids)


def test_hash_spec_examples():
    # a couple of hard-coded probes so both impls pin the same spec
    for s in ["", "NULL", "deadbeef", "a", "0123456789abcdef"]:
        for buckets in [3, 1000, 100000]:
            want = hashing.hash_bucket(s, buckets)
            blob = ("x" + s).encode()  # exercise nonzero offset
            row = ("1\t" + "\t".join(["1"] * 13) + "\t" + s
                   + "\t" * 25 + "\n").encode()
            labels, cont, cat, _ = native.parse_criteo_bytes(
                row, (buckets,) + CFG.cat_vocabs[1:])
            if s == "":
                want = hashing.hash_bucket("NULL", buckets)
            assert cat[0, 0] == want, (s, buckets)


def test_parse_partial_line_boundary():
    row = "1\t" + "\t".join(["2"] * 13) + "\t" + "\t".join(["y"] * 26) + "\n"
    blob = (row + row[: len(row) // 2]).encode()  # second line incomplete
    labels, cont, cat, consumed = native.parse_criteo_bytes(
        blob, CFG.cat_vocabs)
    assert len(labels) == 1
    assert consumed == len(row.encode())


def test_throughput_smoke():
    row = "1\t" + "\t".join(["7"] * 13) + "\t" + "\t".join(
        [f"v{i}" for i in range(26)]) + "\n"
    blob = (row * 20000).encode()
    import time
    t0 = time.perf_counter()
    labels, *_ = native.parse_criteo_bytes(blob, CFG.cat_vocabs)
    dt = time.perf_counter() - t0
    assert len(labels) == 20000
    # native path should parse >100k rows/s even on weak hosts
    assert 20000 / dt > 100_000, f"{20000/dt:.0f} rows/s"


def test_gather_rows_parity_and_fallback():
    import numpy as np
    from recsys.data import native

    rng = np.random.default_rng(0)
    for shape, dtype in (((1000, 13), np.float32), ((1000, 26), np.int32),
                         ((1000,), np.float32)):
        src = (rng.normal(size=shape) * 100).astype(dtype)
        idx = rng.permutation(len(src))[:700]
        np.testing.assert_array_equal(native.gather_rows(src, idx), src[idx])
    # repeated + out-of-order indices
    src = np.arange(50, dtype=np.int32).reshape(25, 2)
    idx = np.array([3, 3, 0, 24, 7])
    np.testing.assert_array_equal(native.gather_rows(src, idx), src[idx])


def test_gather_rows_rejects_out_of_range():
    import numpy as np
    import pytest
    from recsys.data import native

    src = np.arange(20, dtype=np.float32).reshape(10, 2)
    with pytest.raises(IndexError):
        native.gather_rows(src, np.array([0, 10]))
    with pytest.raises(IndexError):
        native.gather_rows(src, np.array([-1, 3]))

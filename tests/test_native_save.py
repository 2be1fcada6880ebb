"""Native TSV checkpoint writer (native/fastsave.cc) parity tests."""

import os

import numpy as np
import pytest

from hgaprec_jax.data import native


def _python_ref(path, x, ext):
    with open(path, "w") as f:
        for i in range(x.shape[0]):
            vals = "\t".join(f"{v:.8f}" for v in x[i])
            f.write(f"{i}\t{int(ext[i])}\t{vals}\n")


@pytest.mark.skipif(native._load() is None,
                    reason="native toolchain unavailable")
def test_write_tsv_mat_matches_python(tmp_path):
    rng = np.random.default_rng(3)
    x = rng.gamma(0.3, 3.0, (257, 7)).astype(np.float32)
    x[0, 0] = 0.0
    x[1, 1] = 1e-30
    x[2, 2] = 12345.6789
    x[3, 3] = 2.0e10       # snprintf fallback path
    ext = rng.integers(0, 10**9, 257).astype(np.int64)
    p_native = str(tmp_path / "native.tsv")
    p_py = str(tmp_path / "py.tsv")
    assert native.write_tsv_mat(p_native, x, ext)
    _python_ref(p_py, x.astype(np.float64), ext)
    # same structure; values equal to within the last printed decimal
    # (the native fixed-point formatter may differ from printf by 1 ulp
    # of the 8th decimal)
    with open(p_native) as f1, open(p_py) as f2:
        for ln, lp in zip(f1, f2):
            cn, cp = ln.rstrip("\n").split("\t"), lp.rstrip("\n").split("\t")
            assert cn[:2] == cp[:2]
            assert len(cn) == len(cp)
            for a, b in zip(cn[2:], cp[2:]):
                assert a.count(".") == 1 and len(a.split(".")[1]) == 8
                assert abs(float(a) - float(b)) <= 1.1e-8


@pytest.mark.skipif(native._load() is None,
                    reason="native toolchain unavailable")
def test_save_mat_roundtrip_via_checkpoint(tmp_path):
    from hgaprec_jax.io.checkpoint import _load_mat, _save_mat
    rng = np.random.default_rng(4)
    x = rng.gamma(0.3, 3.0, (31, 5)).astype(np.float32)
    path = str(tmp_path / "m.tsv")
    _save_mat(path, x, {i: i + 100 for i in range(31)})
    back = _load_mat(path)
    np.testing.assert_allclose(back, x, rtol=0, atol=5e-9)
    first = open(path).readline().split("\t")
    assert first[0] == "0" and first[1] == "100"

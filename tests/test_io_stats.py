"""MatrixMarket I/O (SciPy oracle) and stats/roofline utilities."""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.io
import scipy.sparse

from sparse_tpu import coo_todense, csr_from_dense, csr_todense
from sparse_tpu.io import mm_read, mm_read_coo, mm_write
from sparse_tpu.utils import matrix_stats, roofline_report, spmv_bytes


def test_roundtrip_real(tmp_path):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((7, 5)) * (rng.random((7, 5)) < 0.4)
    a = csr_from_dense(jnp.asarray(x))
    p = tmp_path / "a.mtx"
    mm_write(p, a, comment="roundtrip fixture")
    back = mm_read(p)
    np.testing.assert_allclose(np.asarray(csr_todense(back)), x, rtol=1e-15)
    # scipy agrees with what we wrote
    s = scipy.io.mmread(p)
    np.testing.assert_allclose(s.toarray(), x, rtol=1e-15)


@pytest.mark.parametrize("symm", ["general", "symmetric", "skew-symmetric"])
def test_read_matches_scipy_coordinate(tmp_path, symm):
    rng = np.random.default_rng(1)
    n = 6
    x = rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.5)
    if symm == "symmetric":
        x = np.tril(x) + np.tril(x, -1).T
    elif symm == "skew-symmetric":
        x = np.tril(x, -1) - np.tril(x, -1).T
    p = tmp_path / "m.mtx"
    scipy.io.mmwrite(p, scipy.sparse.coo_matrix(x), symmetry=symm)
    got = mm_read_coo(p)
    np.testing.assert_allclose(np.asarray(coo_todense(got)), x, rtol=1e-15)


def test_read_matches_scipy_array(tmp_path):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 3))
    p = tmp_path / "d.mtx"
    scipy.io.mmwrite(p, x)
    got = mm_read_coo(p)
    np.testing.assert_allclose(np.asarray(coo_todense(got)), x, rtol=1e-15)


def test_read_pattern(tmp_path):
    p = tmp_path / "p.mtx"
    p.write_text(
        "%%MatrixMarket matrix coordinate pattern general\n3 3 2\n1 2\n3 1\n"
    )
    got = mm_read_coo(p)
    want = np.zeros((3, 3))
    want[0, 1] = want[2, 0] = 1.0
    np.testing.assert_array_equal(np.asarray(coo_todense(got)), want)


def test_integer_field(tmp_path):
    p = tmp_path / "i.mtx"
    p.write_text(
        "%%MatrixMarket matrix coordinate integer general\n2 2 2\n1 1 5\n2 2 -3\n"
    )
    got = mm_read_coo(p)
    np.testing.assert_array_equal(
        np.asarray(coo_todense(got)), [[5, 0], [0, -3]]
    )


def test_bad_header(tmp_path):
    p = tmp_path / "bad.mtx"
    p.write_text("not a matrix\n1 1 0\n")
    with pytest.raises(ValueError):
        mm_read_coo(p)


def test_stats_and_roofline():
    x = np.zeros((4, 8))
    x[0, :3] = [1.0, 2.0, 3.0]
    x[2, 1] = 4.0
    a = csr_from_dense(jnp.asarray(x))
    s = matrix_stats(a)
    assert s.nnz == 4 and s.row_max == 3 and s.row_min == 0
    assert s.row_imbalance == 3.0
    b = spmv_bytes(a)
    assert b > 0
    rep = roofline_report(a, seconds=1e-6, hbm_gbps=819.0)
    assert rep["effective_gbps"] == b / 1e-6 / 1e9
    assert 0 < rep["roofline_fraction"] < 1e6
    assert "nnz=4" in str(s)


def test_native_parser_used_and_correct(tmp_path):
    # the native C++ parser (io/fastmm) must parse what the writer emits and
    # agree with the NumPy fallback path
    from sparse_tpu.io import fastmm

    body = b"% comment inside body\n1 2 -3.5\n3 1 2e-3\n2 2 7\n"
    out = fastmm.parse_coordinate(body, 3, False)
    if out is None:
        pytest.skip("no native toolchain")
    rows, cols, vals = out
    np.testing.assert_array_equal(rows, [0, 2, 1])
    np.testing.assert_array_equal(cols, [1, 0, 1])
    np.testing.assert_allclose(vals, [-3.5, 2e-3, 7.0])
    with pytest.raises(ValueError):
        fastmm.parse_coordinate(b"1 junk\n", 1, False)
    v = fastmm.parse_array(b"1.5\n2.5 3.5\n", 3)
    np.testing.assert_allclose(v, [1.5, 2.5, 3.5])


def test_bell_stats():
    from sparse_tpu import bsr_from_dense
    from sparse_tpu.formats.bell import bell_from_bsr
    from sparse_tpu.utils.stats import bell_stats

    rng = np.random.default_rng(13)
    n, bsz = 16, 4
    nb = n // bsz
    mask = np.kron(rng.random((nb, nb)) < 0.4, np.ones((bsz, bsz)))
    x = rng.standard_normal((n, n)) * mask
    x[np.abs(x) < 0.2] = 0.0  # some in-block zeros
    e = bell_from_bsr(bsr_from_dense(jnp.asarray(x), bsz))
    s = bell_stats(e)
    assert s.nb == nb and s.bsz == bsz
    assert s.nnz == int(np.count_nonzero(x))
    assert 0 < s.slot_fill <= 1.0 and 0 < s.block_fill <= 1.0
    assert "BELL" in str(s)


def test_nnz_roofline_model():
    """The nnz/s roofline model: intrinsic min bytes from the pattern, the
    plan ceiling from its traffic, and the derived fractions are
    arithmetically consistent at a given bandwidth."""
    import jax.numpy as jnp
    import numpy as np

    from sparse_tpu import csr_from_dense
    from sparse_tpu.utils.stats import (
        blocked_min_bytes,
        csr_min_bytes,
        nnz_roofline,
    )

    # 4x4 with 5 stored entries over 3 distinct columns
    x = np.array([[1.0, 0, 2, 0], [0, 0, 2, 0], [0, 3, 0, 0], [1, 0, 0, 0]],
                 np.float32)
    a = csr_from_dense(jnp.asarray(x))
    nb = csr_min_bytes(a, k=1)
    # values 5*4 + unique operand cols 3*4 + output 4*4
    assert nb == 5 * 4 + 3 * 4 + 4 * 4
    assert csr_min_bytes(a, k=8) == 5 * 4 + 3 * 8 * 4 + 4 * 8 * 4
    assert blocked_min_bytes(7, 2, 10, k=1) == 7 * 4 * 4 + 10 * 4 + 10 * 4

    bw = 3350.0
    rl = nnz_roofline(5, min_bytes=nb, hbm_gbps=bw, plan_bytes=4 * nb,
                      seconds=1e-6)
    # intrinsic ceiling: nnz / (min_bytes / BW)
    t_intr = nb / (bw * 1e9)
    np.testing.assert_allclose(rl["ceiling_gnnzps"], 5 / t_intr / 1e9)
    # traffic-bound plan at 4x the intrinsic bytes -> structural 1/4
    np.testing.assert_allclose(rl["structural_frac"], 0.25)
    np.testing.assert_allclose(rl["frac_of_nnz_roofline"], t_intr / 1e-6)
    np.testing.assert_allclose(
        rl["frac_of_plan_ceiling"], 4 * t_intr / 1e-6)
    # the bandwidth is an argument: half the bandwidth, half the ceiling
    rl2 = nnz_roofline(5, min_bytes=nb, hbm_gbps=bw / 2)
    np.testing.assert_allclose(rl2["ceiling_gnnzps"],
                               rl["ceiling_gnnzps"] / 2)
    # k multiplies effective nnz and the ceilings consistently
    rl3 = nnz_roofline(5, k=8, min_bytes=nb, hbm_gbps=bw)
    np.testing.assert_allclose(
        rl3["ceiling_gnnzps"], 40 / (nb / (bw * 1e9)) / 1e9)

"""CSR/CSC conformance tests.

Golden vectors are taken from the reference test suite
(reference compressed_test.fut) and README repl transcript (README.md:14-21),
plus SciPy-oracle property tests in the reference's house style
(dense-reference oracles, SURVEY.md §4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

import sparse_tpu as st


def dense(a):
    return np.asarray(a.todense())


# ---------------------------------------------------------------------------
# README fixture (reference README.md:14-21): the canonical first test.
# ---------------------------------------------------------------------------
def test_readme_smvm():
    A = st.csr_from_triples(2, 3, [(0, 0, 2.0), (1, 2, 3.0)], dtype=np.float64)
    y = st.csr_smvm(A, jnp.array([10.0, 20.0, 30.0]))
    np.testing.assert_array_equal(np.asarray(y), [20.0, 90.0])


# ---------------------------------------------------------------------------
# eye (reference compressed_test.fut:13-28, incl. degenerate shapes)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize(
    "n,m",
    [(2, 2), (2, 3), (3, 2), (1, 3), (0, 0), (0, 1), (1, 0)],
)
def test_csr_eye(n, m):
    out = dense(st.csr_eye(n, m, dtype=jnp.int32))
    np.testing.assert_array_equal(out, np.eye(n, m, dtype=np.int32))


@pytest.mark.parametrize(
    "n,m",
    [(2, 2), (2, 3), (3, 2), (1, 3), (0, 0), (0, 1), (1, 0)],
)
def test_csc_eye(n, m):
    out = dense(st.csc_eye(n, m, dtype=jnp.int32))
    np.testing.assert_array_equal(out, np.eye(n, m, dtype=np.int32))


# ---------------------------------------------------------------------------
# sparse construction (reference compressed_test.fut:33-45)
# ---------------------------------------------------------------------------
CONSTRUCTION_CASES = [
    # (n, m, rows, cols, vals, expected)
    (2, 3, [0, 1], [0, 2], [2, 3], [[2, 0, 0], [0, 0, 3]]),
    (2, 3, [1, 0], [2, 0], [3, 2], [[2, 0, 0], [0, 0, 3]]),  # unsorted
    (2, 3, [1, 0, 1], [2, 0, 2], [3, 2, 1], [[2, 0, 0], [0, 0, 4]]),  # dup sum
    (2, 3, [], [], [], [[0, 0, 0], [0, 0, 0]]),  # empty
]


@pytest.mark.parametrize("n,m,rows,cols,vals,expected", CONSTRUCTION_CASES)
def test_csr_sparse(n, m, rows, cols, vals, expected):
    A = st.csr_from_triples(n, m, zip(rows, cols, vals), dtype=np.int32)
    np.testing.assert_array_equal(dense(A), expected)


@pytest.mark.parametrize("n,m,rows,cols,vals,expected", CONSTRUCTION_CASES)
def test_csc_sparse(n, m, rows, cols, vals, expected):
    A = st.csc_from_triples(n, m, zip(rows, cols, vals), dtype=np.int32)
    np.testing.assert_array_equal(dense(A), expected)


def test_sparse_out_of_bounds_raises():
    # reference asserts bounds at construction (compressed.fut:156)
    with pytest.raises(ValueError):
        st.csr_from_triples(2, 3, [(2, 0, 1.0)])
    with pytest.raises(ValueError):
        st.csr_from_triples(2, 3, [(0, 3, 1.0)])


# ---------------------------------------------------------------------------
# smvm 5x5 fixture (reference compressed_test.fut:48-59)
# ---------------------------------------------------------------------------
def test_csr_smvm_5x5():
    rows = [0, 0, 0, 1, 1, 2, 2, 2, 3, 4, 4]
    cols = [0, 1, 3, 1, 2, 1, 2, 3, 3, 3, 4]
    vals = [1, 2, 11, 3, 4, 5, 6, 7, 8, 9, 10]
    A = st.csr_from_triples(5, 5, zip(rows, cols, vals), dtype=np.int32)
    y = st.csr_smvm(A, jnp.array([3, 1, 2, 6, 5], dtype=jnp.int32))
    np.testing.assert_array_equal(np.asarray(y), [71, 11, 59, 48, 104])


# ---------------------------------------------------------------------------
# nnz (reference compressed_test.fut:62-69): stored zeros don't count
# ---------------------------------------------------------------------------
def test_nnz():
    A = st.csr_from_triples(2, 3, [(0, 0, 2), (1, 2, 3)], dtype=np.int32)
    assert int(st.csr_nnz(A)) == 2
    Z = st.csr_from_triples(2, 3, [], dtype=np.int32)
    assert int(st.csr_nnz(Z)) == 0
    # cancellation: A - A keeps entries stored but nnz drops to 0
    D = st.csr_sub(A, A)
    assert int(st.csr_nnz(D)) == 0
    np.testing.assert_array_equal(dense(D), np.zeros((2, 3), np.int32))


def test_csc_nnz():
    A = st.csc_from_triples(2, 3, [(0, 0, 2), (1, 2, 3)], dtype=np.int32)
    assert int(st.csc_nnz(A)) == 2


# ---------------------------------------------------------------------------
# coo round trip (reference compressed_test.fut:72-78, 132-138)
# ---------------------------------------------------------------------------
def test_csr_coo():
    A = st.csr_from_triples(2, 3, [(0, 0, 2), (1, 2, 3)], dtype=np.int32)
    c = st.coo_compact(st.csr_to_coo(A))
    np.testing.assert_array_equal(np.asarray(c.row), [0, 1])
    np.testing.assert_array_equal(np.asarray(c.col), [0, 2])
    np.testing.assert_array_equal(np.asarray(c.data), [2, 3])


def test_csc_coo():
    A = st.csc_from_triples(2, 3, [(0, 0, 2), (1, 2, 3)], dtype=np.int32)
    c = st.coo_compact(st.csc_to_coo(A))
    # reference returns (r, c, v) with original orientation, column-major order
    np.testing.assert_array_equal(np.asarray(c.row), [0, 1])
    np.testing.assert_array_equal(np.asarray(c.col), [0, 2])
    np.testing.assert_array_equal(np.asarray(c.data), [2, 3])


# ---------------------------------------------------------------------------
# transpose duality (reference compressed_test.fut:140-156)
# ---------------------------------------------------------------------------
def test_csr_transpose():
    A = st.csr_from_triples(2, 3, [(0, 0, 2), (1, 2, 3)], dtype=np.int32)
    np.testing.assert_array_equal(dense(A.T), [[2, 0], [0, 0], [0, 3]])


def test_csc_transpose():
    A = st.csc_from_triples(2, 3, [(0, 0, 2), (1, 2, 3)], dtype=np.int32)
    np.testing.assert_array_equal(dense(A.T), [[2, 0], [0, 0], [0, 3]])


# ---------------------------------------------------------------------------
# add/sub vs dense oracle; diag; scale
# ---------------------------------------------------------------------------
def test_add_sub_scale_diag_random():
    # one random trial: each distinct (n, m, nse) shape-set compiles the whole
    # COO-concat-rebuild pipeline afresh (~30 s/trial on this host); breadth
    # over shapes lives in tests/test_fuzz.py
    rng = np.random.default_rng(0)
    for trial in range(1):
        n, m = int(rng.integers(1, 30)), int(rng.integers(1, 30))
        da = sp.random(n, m, density=0.3, random_state=rng, dtype=np.float64)
        db = sp.random(n, m, density=0.3, random_state=rng, dtype=np.float64)
        A = st.csr_from_dense(jnp.asarray(da.toarray()))
        B = st.csr_from_dense(jnp.asarray(db.toarray()))
        np.testing.assert_allclose(dense(A + B), (da + db).toarray(), rtol=1e-12)
        np.testing.assert_allclose(dense(A - B), (da - db).toarray(), rtol=1e-12)
        np.testing.assert_allclose(
            dense(st.csr_scale(2.5, A)), 2.5 * da.toarray(), rtol=1e-12
        )
    v = jnp.array([1.0, 2.0, 3.0])
    np.testing.assert_array_equal(dense(st.csr_diag(v)), np.diag([1.0, 2.0, 3.0]))
    np.testing.assert_array_equal(dense(st.csc_diag(v)), np.diag([1.0, 2.0, 3.0]))


def test_smvm_random_vs_scipy():
    rng = np.random.default_rng(1)
    # one trial: every random shape is a fresh compile; breadth lives in
    # tests/test_fuzz.py
    for trial in range(1):
        n, m = int(rng.integers(1, 50)), int(rng.integers(1, 50))
        da = sp.random(n, m, density=0.25, random_state=rng, dtype=np.float64).tocsr()
        v = rng.standard_normal(m)
        A = st.csr_from_dense(jnp.asarray(da.toarray()))
        np.testing.assert_allclose(
            np.asarray(st.csr_smvm(A, jnp.asarray(v))), da @ v, rtol=1e-12
        )


def test_csc_vsmm():
    A = st.csc_from_triples(2, 3, [(0, 0, 2), (1, 2, 3)], dtype=np.float64)
    y = st.csc_vsmm(jnp.array([10.0, 100.0]), A)
    np.testing.assert_array_equal(np.asarray(y), [20.0, 0.0, 300.0])


# ---------------------------------------------------------------------------
# jit-compatibility: the whole pipeline must trace once and compile
# ---------------------------------------------------------------------------
def test_jit_pipeline():
    @jax.jit
    def f(A: st.CSR, v):
        B = st.csr_add(A, A)
        return st.csr_smvm(st.csr_scale(0.5, B), v)

    A = st.csr_from_triples(2, 3, [(0, 0, 2.0), (1, 2, 3.0)], dtype=np.float64)
    v = jnp.array([10.0, 20.0, 30.0])
    np.testing.assert_array_equal(np.asarray(f(A, v)), [20.0, 90.0])
    # same structure, new values: must not retrace (pytree stability)
    A2 = st.csr_scale(2.0, A)
    np.testing.assert_array_equal(np.asarray(f(A2, v)), [40.0, 180.0])


def test_vmap_smvm():
    A = st.csr_from_triples(2, 3, [(0, 0, 2.0), (1, 2, 3.0)], dtype=np.float64)
    vs = jnp.stack([jnp.array([10.0, 20.0, 30.0]), jnp.array([1.0, 0.0, 1.0])])
    ys = jax.vmap(lambda v: st.csr_smvm(A, v))(vs)
    np.testing.assert_array_equal(np.asarray(ys), [[20.0, 90.0], [2.0, 3.0]])


def test_grad_through_smvm():
    # formats are pytrees, so AD flows through values.
    A = st.csr_from_triples(2, 2, [(0, 0, 2.0), (1, 1, 3.0)], dtype=np.float64)

    def loss(data):
        B = st.CSR(data=data, indices=A.indices, indptr=A.indptr, shape=A.shape)
        return jnp.sum(st.csr_smvm(B, jnp.array([1.0, 2.0])) ** 2)

    g = jax.grad(loss)(A.data)
    # d/d a00 (a00*1)^2 = 2*a00 = 4 ; d/d a11 (a11*2)^2 = 2*a11*2*2 = 24
    np.testing.assert_allclose(np.asarray(g), [4.0, 24.0])


def test_coo_sort_fused_key_and_wide_fallback():
    # small shape: fused single-key sort path; huge shape with tiny nse:
    # (n+1)*(m+1) overflows int32, exercising the 2-key fallback
    from sparse_tpu.formats.coo import COO, coo_sort
    from sparse_tpu.ops.segmented import INDEX_DTYPE

    for n, m in [(7, 9), (1_000_000, 3_000_000)]:
        rng = np.random.default_rng(n % 97)
        r = rng.integers(0, n, size=17)
        c = rng.integers(0, m, size=17)
        # include padding sentinels and a duplicate coordinate
        r[5], c[5] = n, m
        r[6], c[6] = r[0], c[0]
        d = rng.standard_normal(17)
        a = COO(row=jnp.asarray(r, INDEX_DTYPE), col=jnp.asarray(c, INDEX_DTYPE),
                data=jnp.asarray(d), shape=(n, m))
        s = coo_sort(a)
        rs, cs, ds = np.asarray(s.row), np.asarray(s.col), np.asarray(s.data)
        order = np.lexsort((c, r))
        np.testing.assert_array_equal(rs, r[order])
        np.testing.assert_array_equal(cs, c[order])
        np.testing.assert_allclose(ds, d[order], rtol=0)
        assert rs[-1] == n and cs[-1] == m  # padding sorts last

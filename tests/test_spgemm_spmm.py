"""SpGEMM + SpMM conformance tests.

Golden SpGEMM vectors from the reference (compressed_test.fut:158-178);
random property tests against SciPy oracles (SURVEY.md §4 house style).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

import sparse_tpu as st
from sparse_tpu.ops.spgemm import spgemm, spgemm_csr_csr, spgemm_flops
from sparse_tpu.ops.spmm import dsmm, spmm


def dense(a):
    return np.asarray(a.todense())


# reference compressed_test.fut:158-170 golden cases:
# (n, m, k, A triples, B triples, expected)
SMSMM_CASES = [
    (2, 2, 2, [(0, 1, 1)], [(1, 0, 1)], [[1, 0], [0, 0]]),
    (2, 2, 2, [(1, 0, 1)], [(0, 1, 1)], [[0, 0], [0, 1]]),
    (2, 3, 4, [(1, 0, 5)], [], [[0, 0, 0, 0], [0, 0, 0, 0]]),
    (
        2, 2, 2,
        [(0, 0, 1), (1, 1, 1)],
        [(0, 1, 8), (1, 0, 9)],
        [[0, 8], [9, 0]],
    ),
    (
        2, 2, 2,
        [(0, 0, 1), (0, 1, 7), (1, 0, 2), (1, 1, 4)],
        [(0, 0, 3), (0, 1, 3), (1, 0, 5), (1, 1, 2)],
        [[38, 17], [26, 14]],
    ),
]


@pytest.mark.parametrize("n,m,k,at,bt,expected", SMSMM_CASES)
def test_smsmm_golden(n, m, k, at, bt, expected):
    A = st.csr_from_triples(n, m, at, dtype=np.int64)
    B = st.csc_from_triples(m, k, bt, dtype=np.int64)
    C = spgemm(A, B)
    assert isinstance(C, st.CSR)
    np.testing.assert_array_equal(dense(C), expected)


def test_smsmm_matmul_operator():
    A = st.csr_from_triples(2, 2, [(0, 0, 1.0), (0, 1, 7.0), (1, 0, 2.0), (1, 1, 4.0)])
    B = st.csc_from_triples(2, 2, [(0, 0, 3.0), (0, 1, 3.0), (1, 0, 5.0), (1, 1, 2.0)])
    np.testing.assert_array_equal(dense(A @ B), [[38.0, 17.0], [26.0, 14.0]])


def test_spgemm_random_vs_scipy():
    # one trial: every distinct (shape, nse, expansion) recompiles the eager
    # symbolic+numeric passes; shape breadth lives in tests/test_fuzz.py
    rng = np.random.default_rng(7)
    for _ in range(1):
        n, m, k = (int(x) for x in rng.integers(1, 40, size=3))
        da = sp.random(n, m, density=0.2, random_state=rng, dtype=np.float64)
        db = sp.random(m, k, density=0.2, random_state=rng, dtype=np.float64)
        A = st.csr_from_dense(jnp.asarray(da.toarray()))
        B = st.csr_from_dense(jnp.asarray(db.toarray()))
        C = spgemm(A, B)
        np.testing.assert_allclose(dense(C), (da @ db).toarray(), rtol=1e-12)


def test_spgemm_jit_with_static_capacity():
    A = st.csr_from_triples(2, 2, [(0, 0, 1.0), (0, 1, 7.0), (1, 0, 2.0), (1, 1, 4.0)])
    Br = st.csr_from_triples(2, 2, [(0, 0, 3.0), (0, 1, 3.0), (1, 0, 5.0), (1, 1, 2.0)])
    f = int(spgemm_flops(A, Br))
    assert f == 8
    C = jax.jit(spgemm_csr_csr, static_argnums=2)(A, Br, f)
    np.testing.assert_array_equal(dense(C), [[38.0, 17.0], [26.0, 14.0]])


def test_spgemm_cancellation_keeps_stored_zero():
    # A = [[1, 1]], B = [[1], [-1]]: product entries +1 and -1 cancel at (0,0).
    A = st.csr_from_triples(1, 2, [(0, 0, 1.0), (0, 1, 1.0)])
    B = st.csc_from_triples(2, 1, [(0, 0, 1.0), (1, 0, -1.0)])
    C = spgemm(A, B)
    np.testing.assert_array_equal(dense(C), [[0.0]])
    # stored but zero: nnz counts only non-zero stored values
    assert int(st.csr_nnz(C)) == 0
    assert int(C.indptr[-1]) == 1  # the explicit zero occupies a slot


# ---------------------------------------------------------------------------
# dense-accumulator (method="mxu", sort-free) SpGEMM core
# ---------------------------------------------------------------------------
from sparse_tpu.ops.spgemm import spgemm_mxu_csr_csr, spgemm_mxu_nse  # noqa: E402


@pytest.mark.parametrize("n,m,k,at,bt,expected", SMSMM_CASES)
def test_smsmm_golden_mxu(n, m, k, at, bt, expected):
    A = st.csr_from_triples(n, m, at, dtype=np.float64)
    B = st.csc_from_triples(m, k, bt, dtype=np.float64)
    C = spgemm(A, B, method="mxu")
    np.testing.assert_array_equal(dense(C), np.asarray(expected, np.float64))


@pytest.mark.parametrize("method", [
    pytest.param("esc", marks=pytest.mark.slow),  # breadth: goldens +
    # cancellation + fuzz pin ESC by default
    "mxu",
])
def test_spgemm_methods_vs_scipy(method):
    rng = np.random.default_rng(11)
    for _ in range(2):
        n, m, k = (int(x) for x in rng.integers(1, 40, size=3))
        da = sp.random(n, m, density=0.2, random_state=rng, dtype=np.float64)
        db = sp.random(m, k, density=0.2, random_state=rng, dtype=np.float64)
        A = st.csr_from_dense(jnp.asarray(da.toarray()))
        B = st.csr_from_dense(jnp.asarray(db.toarray()))
        C = spgemm(A, B, method=method)
        np.testing.assert_allclose(dense(C), (da @ db).toarray(), rtol=1e-12)


def test_spgemm_mxu_structure_matches_esc():
    # identical stored structure (indices/indptr), values equal up to
    # summation order
    rng = np.random.default_rng(5)
    da = sp.random(30, 25, density=0.15, random_state=rng, dtype=np.float64)
    db = sp.random(25, 35, density=0.15, random_state=rng, dtype=np.float64)
    A = st.csr_from_dense(jnp.asarray(da.toarray()))
    B = st.csr_from_dense(jnp.asarray(db.toarray()))
    Ce = spgemm(A, B, method="esc")
    Cm = spgemm(A, B, method="mxu")
    assert Cm.nse == int(Ce.indptr[-1])
    np.testing.assert_array_equal(np.asarray(Cm.indptr), np.asarray(Ce.indptr))
    np.testing.assert_array_equal(
        np.asarray(Cm.indices), np.asarray(Ce.indices[: Cm.nse])
    )
    np.testing.assert_allclose(
        np.asarray(Cm.data), np.asarray(Ce.data[: Cm.nse]), rtol=1e-12
    )


def test_spgemm_mxu_cancellation_keeps_stored_zero():
    A = st.csr_from_triples(1, 2, [(0, 0, 1.0), (0, 1, 1.0)])
    B = st.csc_from_triples(2, 1, [(0, 0, 1.0), (1, 0, -1.0)])
    C = spgemm(A, B, method="mxu")
    np.testing.assert_array_equal(dense(C), [[0.0]])
    assert int(st.csr_nnz(C)) == 0
    assert int(C.indptr[-1]) == 1  # the explicit zero occupies a slot


def test_spgemm_mxu_jit_static_capacity():
    A = st.csr_from_triples(2, 2, [(0, 0, 1.0), (0, 1, 7.0), (1, 0, 2.0), (1, 1, 4.0)])
    Br = st.csr_from_triples(2, 2, [(0, 0, 3.0), (0, 1, 3.0), (1, 0, 5.0), (1, 1, 2.0)])
    nse = int(spgemm_mxu_nse(A, Br))
    assert nse == 4
    C = jax.jit(spgemm_mxu_csr_csr, static_argnums=2)(A, Br, nse)
    np.testing.assert_array_equal(dense(C), [[38.0, 17.0], [26.0, 14.0]])
    # over-capacity pads; the dense view is unchanged
    C8 = spgemm_mxu_csr_csr(A, Br, 8)
    assert C8.nse == 8
    np.testing.assert_array_equal(dense(C8), [[38.0, 17.0], [26.0, 14.0]])


def test_spgemm_mxu_capacity_truncation_row_major():
    A = st.csr_from_triples(2, 2, [(0, 0, 1.0), (0, 1, 7.0), (1, 0, 2.0), (1, 1, 4.0)])
    Br = st.csr_from_triples(2, 2, [(0, 0, 3.0), (0, 1, 3.0), (1, 0, 5.0), (1, 1, 2.0)])
    C = spgemm_mxu_csr_csr(A, Br, 3)  # true count is 4: drops (1,1)
    np.testing.assert_array_equal(dense(C), [[38.0, 17.0], [26.0, 0.0]])
    assert int(C.indptr[-1]) == 3


def test_spgemm_auto_dispatch():
    # floats within budget -> dense core (exact-capacity result); ints -> ESC
    rng = np.random.default_rng(6)
    da = sp.random(20, 20, density=0.2, random_state=rng, dtype=np.float32)
    A = st.csr_from_dense(jnp.asarray(da.toarray()))
    C = spgemm(A, A)
    np.testing.assert_allclose(dense(C), (da @ da).toarray(), rtol=1e-5, atol=1e-6)
    Ai = st.csr_from_triples(2, 2, [(0, 0, 3), (1, 1, 4)], dtype=np.int64)
    Ci = spgemm(Ai, Ai)
    assert Ci.dtype == np.int64
    np.testing.assert_array_equal(dense(Ci), [[9, 0], [0, 16]])


# ---------------------------------------------------------------------------
# SpMM
# ---------------------------------------------------------------------------
def test_spmm_vs_scipy():
    # two trials (each shape = one compile); breadth in tests/test_fuzz.py
    rng = np.random.default_rng(3)
    for _ in range(2):
        n, m, k = (int(x) for x in rng.integers(1, 50, size=3))
        da = sp.random(n, m, density=0.25, random_state=rng, dtype=np.float64).tocsr()
        b = rng.standard_normal((m, k))
        A = st.csr_from_dense(jnp.asarray(da.toarray()))
        np.testing.assert_allclose(
            np.asarray(spmm(A, jnp.asarray(b))), da @ b, rtol=1e-12
        )


def test_spmm_matmul_operator_and_jit():
    A = st.csr_from_triples(2, 3, [(0, 0, 2.0), (1, 2, 3.0)])
    B = jnp.arange(6, dtype=jnp.float64).reshape(3, 2)
    np.testing.assert_array_equal(np.asarray(A @ B), [[0.0, 2.0], [12.0, 15.0]])
    np.testing.assert_array_equal(
        np.asarray(jax.jit(spmm)(A, B)), [[0.0, 2.0], [12.0, 15.0]]
    )


def test_dsmm_vs_scipy():
    rng = np.random.default_rng(4)
    n, m, k = 17, 23, 5
    da = sp.random(n, m, density=0.3, random_state=rng, dtype=np.float64)
    b = rng.standard_normal((k, n))
    A = st.csc_from_dense(jnp.asarray(da.toarray()))
    np.testing.assert_allclose(np.asarray(dsmm(jnp.asarray(b), A)), b @ da, rtol=1e-12)


# ---------------------------------------------------------------------------
# symbolic/numeric split: spgemm_prepare + spgemm_apply
# ---------------------------------------------------------------------------
def test_spgemm_plan_matches_esc_structure_and_values():
    from sparse_tpu import spgemm_apply, spgemm_prepare
    from sparse_tpu.formats.csr import csr_compact

    rng = np.random.default_rng(23)
    n, m, k = 30, 25, 35
    da = sp.random(n, m, density=0.15, random_state=rng, dtype=np.float64)
    db = sp.random(m, k, density=0.15, random_state=rng, dtype=np.float64)
    A = st.csr_from_dense(jnp.asarray(da.toarray()))
    B = st.csr_from_dense(jnp.asarray(db.toarray()))
    plan = spgemm_prepare(A, B)
    C = spgemm_apply(plan, A, B)
    ref = csr_compact(spgemm(A, B, method="esc"))
    assert C.nse == ref.nse
    np.testing.assert_array_equal(np.asarray(C.indptr), np.asarray(ref.indptr))
    np.testing.assert_array_equal(np.asarray(C.indices), np.asarray(ref.indices))
    np.testing.assert_allclose(np.asarray(C.data), np.asarray(ref.data),
                               rtol=1e-12)
    np.testing.assert_allclose(dense(C), (da @ db).toarray(), rtol=1e-12)


def test_spgemm_plan_csc_operand_and_value_update():
    from sparse_tpu import spgemm_apply, spgemm_prepare

    rng = np.random.default_rng(29)
    n, m, k = 12, 18, 9
    da = sp.random(n, m, density=0.3, random_state=rng, dtype=np.float64)
    db = sp.random(m, k, density=0.3, random_state=rng, dtype=np.float64)
    A = st.csr_from_dense(jnp.asarray(da.toarray()))
    Bc = st.csc_from_dense(jnp.asarray(db.toarray()))
    plan = spgemm_prepare(A, Bc)
    C = spgemm_apply(plan, A, Bc)
    np.testing.assert_allclose(dense(C), (da @ db).toarray(), rtol=1e-12)
    # same pattern, fresh values: no re-prepare, jit-compiled apply
    import dataclasses as dc

    A2 = dc.replace(A, data=A.data * 3.0)
    B2 = dc.replace(Bc, data=Bc.data * -0.5)
    f = jax.jit(lambda p, a, b: spgemm_apply(p, a, b))
    C2 = f(plan, A2, B2)
    np.testing.assert_allclose(dense(C2), -1.5 * (da @ db).toarray(),
                               rtol=1e-12)


def test_spgemm_plan_cancellation_and_empty():
    from sparse_tpu import spgemm_apply, spgemm_prepare

    # cancellation keeps the stored slot (explicit zero), nnz counts 0
    A = st.csr_from_triples(1, 2, [(0, 0, 1.0), (0, 1, 1.0)])
    B = st.csc_from_triples(2, 1, [(0, 0, 1.0), (1, 0, -1.0)])
    plan = spgemm_prepare(A, B)
    C = spgemm_apply(plan, A, B)
    assert plan.nse_out == 1 and int(C.indptr[-1]) == 1
    np.testing.assert_array_equal(dense(C), [[0.0]])
    assert int(st.csr_nnz(C)) == 0
    # empty operand
    E = st.csr_from_triples(3, 4, [], dtype=np.float64)
    B4 = st.csr_from_triples(4, 2, [(0, 0, 1.0)], dtype=np.float64)
    plan_e = spgemm_prepare(E, B4)
    Ce = spgemm_apply(plan_e, E, B4)
    assert plan_e.nse_out == 0
    np.testing.assert_array_equal(dense(Ce), np.zeros((3, 2)))


def test_spgemm_plan_native_matches_numpy_path():
    # the native schedule and the NumPy fallback must produce identical plans
    from unittest import mock

    from sparse_tpu import spgemm_prepare

    rng = np.random.default_rng(33)
    da = sp.random(60, 45, density=0.15, random_state=rng, dtype=np.float64)
    db = sp.random(45, 70, density=0.15, random_state=rng, dtype=np.float64)
    A = st.csr_from_dense(jnp.asarray(da.toarray()))
    Bc = st.csc_from_dense(jnp.asarray(db.toarray()))
    for B in (st.csr_from_dense(jnp.asarray(db.toarray())), Bc):
        p_native = spgemm_prepare(A, B)
        with mock.patch("sparse_tpu.native.plansort._lib", None), \
             mock.patch("sparse_tpu.native.plansort._tried", True):
            p_np = spgemm_prepare(A, B)
        for f in ("a_pos", "b_pos", "seg", "indices", "indptr"):
            np.testing.assert_array_equal(
                np.asarray(getattr(p_native, f)), np.asarray(getattr(p_np, f))
            )


# -- block-routed SpGEMM dispatch ---------------------------------------------


def _block_dense(n, bsz, block_density, seed):
    """Matrix of fully dense bsz x bsz blocks at sparse block positions."""
    rng = np.random.default_rng(seed)
    nb = n // bsz
    mask = np.kron(
        (rng.random((nb, nb)) < block_density) | np.eye(nb, dtype=bool),
        np.ones((bsz, bsz), bool),
    )
    x = rng.standard_normal((n, n)) * mask
    # make every masked position stored AND nonzero so fill is exactly 1.0
    x = np.where(mask & (x == 0), 1.0, x)
    return x


def test_spgemm_route_picks_block_for_dense_blocks():
    """auto routing: the dense core while the dense footprint fits; the block path for
    big clustered (fully-dense-block) patterns; ESC for uniform random."""
    from sparse_tpu.ops.spgemm import _spgemm_route
    from sparse_tpu.utils.stats import csr_block_fill, detect_block_size

    n, bsz = 64, 2
    x = _block_dense(n, bsz, 0.3, seed=0)
    a = st.csr_from_dense(jnp.asarray(x))
    assert csr_block_fill(a, 2) == 1.0
    assert detect_block_size(a)[0] == 2
    # small: the dense core wins regardless of structure
    assert _spgemm_route(a, a)[0] == "mxu"
    # shrink the dense budget to emulate a matrix too big to densify, and the
    # routing floor to emulate production nnz
    import sparse_tpu.ops.spgemm as sg

    old = sg._BLOCK_ROUTE_MIN_NNZ
    sg._BLOCK_ROUTE_MIN_NNZ = 1
    try:
        route, got_bsz = _spgemm_route(a, a, mxu_budget=10)
        assert route == "block" and got_bsz == bsz
        # uniform random: no dense blocks -> scalar ESC core
        rng = np.random.default_rng(1)
        u = rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.1)
        au = st.csr_from_dense(jnp.asarray(u))
        assert _spgemm_route(au, au, mxu_budget=10)[0] == "esc"
        # mixed: blocked A with unblocked B -> ESC (both must be blocked)
        assert _spgemm_route(a, au, mxu_budget=10)[0] == "esc"
    finally:
        sg._BLOCK_ROUTE_MIN_NNZ = old


def test_spgemm_route_bsz32_and_partial_fill_boundary():
    """Largest block size wins (candidates now reach 32), and partial block
    fill — dense structure that ISN'T fully dense — correctly declines the
    block route (the scalar cores keep exact stored-structure semantics)."""
    import sparse_tpu.ops.spgemm as sg
    from sparse_tpu.ops.spgemm import _spgemm_route
    from sparse_tpu.utils.stats import csr_block_fill

    n, bsz = 256, 32
    x = _block_dense(n, bsz, 0.3, seed=2)
    a = st.csr_from_dense(jnp.asarray(x))
    assert csr_block_fill(a, 32) == 1.0
    old = sg._BLOCK_ROUTE_MIN_NNZ
    sg._BLOCK_ROUTE_MIN_NNZ = 1
    try:
        route, got = _spgemm_route(a, a, mxu_budget=10)
        assert (route, got) == ("block", 32)
        # knock out ~40% of stored entries inside the blocks: the blocks
        # are still *detectable* clusters but no longer fully dense, so the
        # dispatcher must decline (the boundary case)
        rng = np.random.default_rng(7)
        xp = x * (rng.random((n, n)) < 0.6)
        ap = st.csr_from_dense(jnp.asarray(xp))
        fill = csr_block_fill(ap, 32)
        assert 0.4 < fill < 0.8
        assert _spgemm_route(ap, ap, mxu_budget=10)[0] == "esc"
    finally:
        sg._BLOCK_ROUTE_MIN_NNZ = old


@pytest.mark.parametrize("bsz", [2, 4, 8, 16, 32])
def test_spgemm_block_route_xla_apply_and_grad(bsz):
    """The block route (re-block -> ``bsr_smsmm_prepare`` ->
    ``bsr_smsmm_apply`` -> scalar CSR) matches the dense product at every
    block size, and JAX's own gradient of the apply matches the dense
    gradient on A's stored blocks (reference semantics:
    compressed.fut:268-331)."""
    import jax

    from sparse_tpu.ops.spgemm import _spgemm_block

    n = 4 * bsz
    x = _block_dense(n, bsz, 0.4, seed=bsz)
    y = _block_dense(n, bsz, 0.4, seed=bsz + 1)
    a = st.csr_from_dense(jnp.asarray(x))
    b = st.csr_from_dense(jnp.asarray(y))
    c = _spgemm_block(a, b, bsz, compact=True)
    np.testing.assert_allclose(dense(c), x @ y, rtol=1e-10, atol=1e-10)

    ab, bb = st.csr_to_bsr(a, bsz), st.csr_to_bsr(b, bsz)
    plan = st.bsr_smsmm_prepare(ab, bb)
    w = np.random.default_rng(0).standard_normal((n, n))

    def loss(blocks):
        cb = st.bsr_smsmm_apply(plan, st.BSR(indices=ab.indices,
                                             blocks=blocks, n=ab.n,
                                             bsz=bsz), bb)
        return jnp.sum(st.bsr_todense(cb) * w)

    g = jax.grad(loss)(ab.blocks)
    # d/dA sum(W * (A @ B)) = W @ B^T, read back at A's stored blocks
    gd = w @ y.T
    nb = n // bsz
    idx = np.asarray(ab.indices)
    for slot, key in enumerate(idx):
        if key >= nb * nb:
            continue
        r, col = divmod(int(key), nb)
        np.testing.assert_allclose(
            np.asarray(g[slot]),
            gd[r * bsz:(r + 1) * bsz, col * bsz:(col + 1) * bsz],
            rtol=1e-9, atol=1e-9)


@pytest.mark.slow  # breadth: the block route is also covered by
# test_spgemm_block_route_xla_apply_and_grad and test_bsr's round-trip
def test_spgemm_block_method_matches_esc():
    """The block route produces the ESC core's exact stored structure and
    values (up to float summation order) under its full-fill precondition
    (reference semantics: compressed.fut:268-331)."""
    n, bsz = 48, 4
    x = _block_dense(n, bsz, 0.25, seed=3)
    y = _block_dense(n, bsz, 0.25, seed=4)
    a = st.csr_from_dense(jnp.asarray(x))
    b = st.csr_from_dense(jnp.asarray(y))
    c_esc = spgemm(a, b, method="esc")
    c_blk = spgemm(a, b, method="block")
    np.testing.assert_array_equal(np.asarray(c_blk.indptr),
                                  np.asarray(c_esc.indptr))
    np.testing.assert_array_equal(np.asarray(c_blk.indices),
                                  np.asarray(c_esc.indices))
    np.testing.assert_allclose(np.asarray(c_blk.data),
                               np.asarray(c_esc.data), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(dense(c_blk), x @ y, rtol=1e-9, atol=1e-9)
    # rejection of non-square operands (the bsz override shares the same
    # pipeline; re-running it at another bsz only re-pays compiles)
    with pytest.raises(ValueError, match="square"):
        rect = st.csr_from_dense(jnp.asarray(x[: n - 4]))
        spgemm(rect, b, method="block")

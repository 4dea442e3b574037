"""BSR format: conformance against the reference's test suite
(blocked_square_regular_test.fut) — golden vectors, algebraic identities, and
dense-oracle properties, at bsz=2 (reference config) and larger block
sizes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sparse_tpu import (
    bsr_add,
    bsr_diag,
    bsr_eye,
    bsr_from_coo,
    bsr_from_dense,
    bsr_make,
    bsr_mul,
    bsr_nnz,
    bsr_scale,
    bsr_smsmm,
    bsr_smvm,
    bsr_sub,
    bsr_to_coo,
    bsr_todense,
    bsr_transpose,
    bsr_zero,
    coo_compact,
    coo_make,
)

BSZ = 2


def dense(a):
    return np.asarray(bsr_todense(a))


def blkdiag_2(n):
    """Two 2x2 [[1,2],[3,4]] diagonal blocks (reference fixture `b`,
    blocked_square_regular_test.fut:95-96)."""
    blk = [[1.0, 2.0], [3.0, 4.0]]
    return bsr_make(n, BSZ, [(i, i, blk) for i in range(n // BSZ)])


def mk_blkdiag(nblk, bsz=BSZ):
    """Reference generator mk_blkdiag (blocked_square_regular_test.fut:
    234-237): diag blocks with entries sqrt(i+1) + 28*sin(a+i)."""
    blocks = []
    for i in range(nblk):
        a = np.arange(bsz * bsz, dtype=np.float64)
        blocks.append(
            (i, i, (np.sqrt(i + 1) + 28.0 * np.sin(a + i)).reshape(bsz, bsz))
        )
    return bsr_make(nblk * bsz, bsz, blocks)


# -- structure golden tests ----------------------------------------------------


@pytest.mark.parametrize("n", [0, 4, 8])
def test_eye(n):
    # blocked_square_regular_test.fut:55-63
    a = bsr_eye(n, BSZ, jnp.float64)
    np.testing.assert_array_equal(dense(a), np.eye(n))
    assert a.n == n


@pytest.mark.parametrize("n", [0, 4, 8])
def test_diag(n):
    # blocked_square_regular_test.fut:65-73
    v = np.arange(1.0, n + 1)
    np.testing.assert_array_equal(dense(bsr_diag(jnp.asarray(v), BSZ)), np.diag(v))


def test_transp():
    # blocked_square_regular_test.fut:75-93
    b = blkdiag_2(4)
    expect = np.array(
        [[1.0, 2, 0, 0], [3, 4, 0, 0], [0, 0, 1, 2], [0, 0, 3, 4]]
    )
    np.testing.assert_array_equal(dense(b), expect)
    np.testing.assert_array_equal(dense(bsr_transpose(b)), expect.T)
    v = np.arange(1.0, 9)
    d = bsr_diag(jnp.asarray(v), BSZ)
    np.testing.assert_array_equal(dense(bsr_transpose(d)), np.diag(v))


def test_make_sums_duplicates():
    a = bsr_make(2, 2, [(0, 0, [[1.0, 0], [0, 1]]), (0, 0, [[1.0, 2], [0, 0]])])
    np.testing.assert_array_equal(dense(a), [[2.0, 2], [0, 1]])


def test_make_bounds():
    with pytest.raises(ValueError):
        bsr_make(4, 2, [(2, 0, np.zeros((2, 2)))])
    with pytest.raises(ValueError):
        bsr_zero(5, 2)


# -- elementwise ops (reference test_op identities, :106-142) ------------------


def corner_block(n):
    nb = n // BSZ
    blk = np.arange(1.0, BSZ * BSZ + 1).reshape(BSZ, BSZ)
    return bsr_make(n, BSZ, [(nb - 1, 0, blk)])


def ref_diag_pattern(n):
    """Reference mk_diag_blk generator (blocked_square_regular_test.fut:
    98-104)."""
    nb = n // BSZ
    blocks = []
    for i in range(nb):
        blk = np.array(
            [
                [c + 1 + 2 * i + r * (c * (r % 2)) - r for c in range(BSZ)]
                for r in range(BSZ)
            ],
            np.float64,
        )
        blocks.append((i, i, blk))
    return bsr_make(n, BSZ, blocks)


@pytest.mark.parametrize("n", [
    2, 4,
    pytest.param(8, marks=pytest.mark.slow),  # breadth (budget r5)
])
@pytest.mark.parametrize("op", ["add", "sub_identity", "mul"])
def test_op_identities(n, op):
    c = corner_block(n)
    d = ref_diag_pattern(n)
    if op == "add":
        f = bsr_add
    elif op == "mul":
        f = bsr_mul
    else:
        # reference encodes sub via b + (b + (a - b)) == a + b symmetry
        def f(x, y):
            return bsr_add(y, bsr_add(y, bsr_sub(x, y)))

    np.testing.assert_allclose(dense(f(c, d)), dense(f(d, c)), rtol=1e-12)
    np.testing.assert_allclose(
        dense(f(bsr_transpose(c), bsr_transpose(d))),
        dense(bsr_transpose(f(c, d))),
        rtol=1e-12,
    )


@pytest.mark.parametrize("n,bsz", [
    (8, 2), (16, 4),
    pytest.param(16, 8, marks=pytest.mark.slow),  # breadth
])
def test_elementwise_oracle(n, bsz):
    rng = np.random.default_rng(n + bsz)
    xa = rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.4)
    xb = rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.4)
    a = bsr_from_dense(jnp.asarray(xa), bsz)
    b = bsr_from_dense(jnp.asarray(xb), bsz)
    np.testing.assert_allclose(dense(bsr_add(a, b)), xa + xb, rtol=1e-12, atol=0)
    np.testing.assert_allclose(dense(bsr_sub(a, b)), xa - xb, rtol=1e-12, atol=0)
    np.testing.assert_allclose(dense(bsr_scale(2.0, a)), 2 * xa, rtol=1e-12)
    # block-level Hadamard: only blocks present in BOTH patterns survive
    xa_blocks = xa.reshape(n // bsz, bsz, n // bsz, bsz)
    xb_blocks = xb.reshape(n // bsz, bsz, n // bsz, bsz)
    amask = np.any(xa_blocks != 0, axis=(1, 3), keepdims=True)
    bmask = np.any(xb_blocks != 0, axis=(1, 3), keepdims=True)
    expect = (xa_blocks * xb_blocks * amask * bmask).reshape(n, n)
    np.testing.assert_allclose(dense(bsr_mul(a, b)), expect, rtol=1e-12, atol=0)


# -- matmul -------------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 4, 8])
def test_smvm_smsmm_golden(n):
    # blocked_square_regular_test.fut:144-166
    c = corner_block(n)
    v = np.arange(n) + 2.0
    v[0] = 10.0
    k = bsr_diag(jnp.asarray(v), BSZ)
    np.testing.assert_allclose(
        dense(bsr_smsmm(c, k)), dense(c) @ np.diag(v), rtol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(bsr_smvm(c, jnp.asarray(v))), dense(c) @ v, rtol=1e-12
    )


@pytest.mark.parametrize("n,bsz,density", [
    (8, 2, 0.5),
    (16, 4, 0.3),
    pytest.param(32, 8, 0.2, marks=pytest.mark.slow),  # breadth
])
def test_matmul_oracle(n, bsz, density):
    rng = np.random.default_rng(int(n * bsz * density * 100))
    nb = n // bsz
    amask = np.kron(rng.random((nb, nb)) < density, np.ones((bsz, bsz)))
    bmask = np.kron(rng.random((nb, nb)) < density, np.ones((bsz, bsz)))
    xa = rng.standard_normal((n, n)) * amask
    xb = rng.standard_normal((n, n)) * bmask
    a = bsr_from_dense(jnp.asarray(xa), bsz)
    b = bsr_from_dense(jnp.asarray(xb), bsz)
    np.testing.assert_allclose(dense(bsr_smsmm(a, b)), xa @ xb, rtol=1e-10, atol=1e-10)
    v = rng.standard_normal(n)
    np.testing.assert_allclose(
        np.asarray(bsr_smvm(a, jnp.asarray(v))), xa @ v, rtol=1e-10, atol=1e-12
    )


def test_smsmm_jit_static_capacity():
    n, bsz = 8, 2
    rng = np.random.default_rng(0)
    xa = np.kron((rng.random((4, 4)) < 0.5), np.ones((2, 2))) * rng.standard_normal(
        (n, n)
    )
    a = bsr_from_dense(jnp.asarray(xa), bsz)
    from sparse_tpu import bsr_smsmm_core

    out = jax.jit(lambda x, y: bsr_todense(bsr_smsmm_core(x, y, 64)))(a, a)
    np.testing.assert_allclose(np.asarray(out), xa @ xa, rtol=1e-10, atol=1e-10)


# -- COO interchange -----------------------------------------------------------


@pytest.mark.parametrize(
    "n, rows, cols, vals, expect",
    [
        (4, [2], [1], [3.0], None),
        (4, [], [], [], None),
        (2, [0], [1], [3.0], None),
        (2, [0, 1], [1, 0], [3.0, 2.0], None),
        (4, [2, 0], [1, 2], [3.0, 1.0], None),
    ],
)
def test_from_coo(n, rows, cols, vals, expect):
    # blocked_square_regular_test.fut:351-362
    coo = coo_make((n, n), np.asarray(rows, np.int64), np.asarray(cols, np.int64),
                   np.asarray(vals, np.float64))
    m = bsr_from_coo(coo, BSZ)
    want = np.zeros((n, n))
    for r, c, v in zip(rows, cols, vals):
        want[r, c] += v
    np.testing.assert_array_equal(dense(m), want)


def test_coo_roundtrip():
    # blocked_square_regular_test.fut:364-371: row-major nonzeros, zeros dropped
    coo = coo_make((4, 4), [0, 2], [3, 1], np.asarray([-2.0, 3.0]))
    m = bsr_from_coo(coo, BSZ)
    back = coo_compact(bsr_to_coo(m))
    np.testing.assert_array_equal(np.asarray(back.row), [0, 2])
    np.testing.assert_array_equal(np.asarray(back.col), [3, 1])
    np.testing.assert_array_equal(np.asarray(back.data), [-2.0, 3.0])
    assert int(bsr_nnz(m)) == 2


def test_ops_under_jit():
    n, bsz = 8, 2
    rng = np.random.default_rng(4)
    xa = rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.5)
    a = bsr_from_dense(jnp.asarray(xa), bsz)
    v = jnp.asarray(rng.standard_normal(n))

    @jax.jit
    def f(a, v):
        return bsr_smvm(bsr_add(a, bsr_transpose(a)), v)

    np.testing.assert_allclose(
        np.asarray(f(a, v)), (xa + xa.T) @ np.asarray(v), rtol=1e-10
    )


def test_bsr_smsmm_plan_matches_and_updates():
    # pattern-reuse split: structure and values match bsr_smsmm; fresh
    # values reuse the plan under jit with no re-sort
    import dataclasses as dc

    from sparse_tpu import bsr_smsmm_apply, bsr_smsmm_prepare

    rng = np.random.default_rng(71)
    n, bsz = 24, 4
    nb = n // bsz
    amask = np.kron(rng.random((nb, nb)) < 0.4, np.ones((bsz, bsz)))
    bmask = np.kron(rng.random((nb, nb)) < 0.4, np.ones((bsz, bsz)))
    xa = rng.standard_normal((n, n)) * amask
    xb = rng.standard_normal((n, n)) * bmask
    a = bsr_from_dense(jnp.asarray(xa), bsz)
    b = bsr_from_dense(jnp.asarray(xb), bsz)
    plan = bsr_smsmm_prepare(a, b)
    c = bsr_smsmm_apply(plan, a, b)
    ref = bsr_smsmm(a, b)
    np.testing.assert_allclose(dense(c), xa @ xb, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(dense(c), dense(ref), rtol=1e-12)
    # stored structure matches the compacted eager product
    np.testing.assert_array_equal(
        np.sort(np.asarray(c.indices)), np.sort(np.asarray(ref.indices))
    )
    a2 = dc.replace(a, blocks=a.blocks * -2.0)
    c2 = jax.jit(bsr_smsmm_apply)(plan, a2, b)
    np.testing.assert_allclose(dense(c2), -2.0 * (xa @ xb), rtol=1e-10,
                               atol=1e-10)
    # empty operand
    z = bsr_from_dense(jnp.zeros((n, n)), bsz)
    pz = bsr_smsmm_prepare(z, b)
    assert pz.n_products == 0 and pz.nbz_out == 0
    cz = bsr_smsmm_apply(pz, z, b)
    np.testing.assert_array_equal(dense(cz), np.zeros((n, n)))


def test_csr_to_bsr_roundtrip_and_block_spgemm_routing():
    """csr_to_bsr re-blocks a scalar CSR exactly, and the blocked SpGEMM on
    the re-blocked operands matches the scalar product (the block route
    ``spgemm`` takes for clustered patterns)."""
    from sparse_tpu import csr_from_dense, csr_to_bsr, bsr_smsmm, spgemm

    rng = np.random.default_rng(42)
    n, bsz = 32, 4
    x = (rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.15)).astype(
        np.float64
    )
    a = csr_from_dense(jnp.asarray(x))
    ab = csr_to_bsr(a, bsz)
    np.testing.assert_allclose(np.asarray(ab.todense()), x, rtol=1e-12)
    # jit-compatible with a static capacity
    ab2 = jax.jit(
        lambda a: csr_to_bsr(a, bsz, nbz=a.indices.shape[0], compact=False)
    )(a)
    np.testing.assert_allclose(np.asarray(ab2.todense()), x, rtol=1e-12)
    # block product == scalar product
    c_blk = np.asarray(bsr_smsmm(ab, ab).todense())
    c_sca = np.asarray(spgemm(a, a).todense())
    np.testing.assert_allclose(c_blk, c_sca, rtol=1e-9, atol=1e-9)


def test_bsr_to_csr_keeps_stored_zeros():
    """bsr_to_csr stores EVERY position of every stored block (the block-
    routed SpGEMM's return bridge), unlike the reference-filtering
    bsr_to_coo (blocked_square_regular.fut:605-614)."""
    from sparse_tpu import bsr_make, bsr_to_coo, bsr_to_csr, csr_nnz

    blk = np.array([[1.0, 0.0], [0.0, 2.0]])
    a = bsr_make(6, 2, [(0, 1, blk), (2, 0, blk)])
    c = bsr_to_csr(a)
    # capacity holds all 8 positions; nnz counts only the 4 nonzeros
    indptr = np.asarray(c.indptr)
    assert int(indptr[-1]) == 8
    assert int(csr_nnz(c)) == 4
    np.testing.assert_allclose(np.asarray(c.todense()),
                               np.asarray(a.todense()), rtol=1e-12)
    # the filtering conversion stores only the 4 nonzeros
    coo = bsr_to_coo(a)
    assert int(np.sum(np.asarray(coo.row) < 6)) == 4
    # jit-compatible
    c2 = jax.jit(bsr_to_csr)(a)
    np.testing.assert_allclose(np.asarray(c2.todense()),
                               np.asarray(a.todense()), rtol=1e-12)

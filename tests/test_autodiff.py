"""Differentiability and vmap-ability of the core ops.

Pure-functional pytree formats mean JAX transforms compose for free — a
capability with no reference counterpart (Futhark has no AD in the
reference).  Gradients are checked against finite differences / analytic
forms."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sparse_tpu import (
    CSR,
    csr_from_dense,
    csr_smvm,
    spmm,
    tri_from_dense,
    tri_smm,
    tri_todense,
)
from sparse_tpu.ops.spmv import build_spmv_plan, csr_smvm_fast


def random_csr(n, m, density, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, m)) * (rng.random((n, m)) < density)
    return csr_from_dense(jnp.asarray(x)), x


def test_grad_wrt_vector():
    a, xa = random_csr(10, 12, 0.4, 0)
    v = jnp.asarray(np.random.default_rng(1).standard_normal(12))
    # d/dv sum(A v) = A^T 1
    g = jax.grad(lambda v: jnp.sum(csr_smvm(a, v)))(v)
    np.testing.assert_allclose(np.asarray(g), xa.T @ np.ones(10), rtol=1e-10)


def test_grad_wrt_sparse_values():
    a, xa = random_csr(8, 8, 0.5, 2)
    v = jnp.asarray(np.random.default_rng(2).standard_normal(8))

    def loss(data):
        return jnp.sum(csr_smvm(CSR(data, a.indices, a.indptr, a.shape), v) ** 2)

    g = np.asarray(jax.grad(loss)(a.data))
    # finite differences on a few entries
    d0 = np.asarray(a.data)
    for i in [0, len(d0) // 2, len(d0) - 1]:
        eps = 1e-6
        dp = d0.copy(); dp[i] += eps
        dm = d0.copy(); dm[i] -= eps
        fd = (loss(jnp.asarray(dp)) - loss(jnp.asarray(dm))) / (2 * eps)
        np.testing.assert_allclose(g[i], float(fd), rtol=1e-4, atol=1e-6)


def test_grad_through_spmm_and_fast_path():
    a, xa = random_csr(9, 7, 0.5, 3)
    b = jnp.asarray(np.random.default_rng(3).standard_normal((7, 4)))
    g = jax.grad(lambda b: jnp.sum(spmm(a, b)))(b)
    np.testing.assert_allclose(
        np.asarray(g), xa.T @ np.ones((9, 4)), rtol=1e-10
    )
    plan = build_spmv_plan(a)
    v = jnp.asarray(np.random.default_rng(4).standard_normal(7))
    g2 = jax.grad(lambda v: jnp.sum(csr_smvm_fast(a, v, plan)))(v)
    np.testing.assert_allclose(np.asarray(g2), xa.T @ np.ones(9), rtol=1e-10)


def test_grad_through_triangular_smm():
    n = 6
    rng = np.random.default_rng(5)
    xa = np.tril(rng.standard_normal((n, n)))
    xb = np.tril(rng.standard_normal((n, n)))

    def loss(data):
        import dataclasses

        a = dataclasses.replace(tri_from_dense(jnp.asarray(xa)), data=data)
        b = tri_from_dense(jnp.asarray(xb))
        return jnp.sum(tri_todense(tri_smm(a, b)) ** 2)

    a0 = tri_from_dense(jnp.asarray(xa))
    g = np.asarray(jax.grad(loss)(a0.data))
    eps = 1e-6
    d0 = np.asarray(a0.data)
    for i in [0, len(d0) - 1]:
        dp = d0.copy(); dp[i] += eps
        dm = d0.copy(); dm[i] -= eps
        fd = (loss(jnp.asarray(dp)) - loss(jnp.asarray(dm))) / (2 * eps)
        np.testing.assert_allclose(g[i], float(fd), rtol=1e-4, atol=1e-6)


def test_vmap_over_batched_values():
    # batch of matrices sharing one sparsity pattern: vmap over data
    a, xa = random_csr(6, 6, 0.6, 7)
    rng = np.random.default_rng(8)
    batch_data = jnp.asarray(
        rng.standard_normal((4, a.nse)) * (np.asarray(a.data) != 0)
    )
    v = jnp.asarray(rng.standard_normal(6))

    def one(data):
        return csr_smvm(CSR(data, a.indices, a.indptr, a.shape), v)

    out = jax.vmap(one)(batch_data)
    assert out.shape == (4, 6)
    dense_pattern = np.asarray(
        jax.vmap(lambda d: CSR(d, a.indices, a.indptr, a.shape).todense())(
            batch_data
        )
    )
    np.testing.assert_allclose(
        np.asarray(out),
        np.einsum("bnm,m->bn", dense_pattern, np.asarray(v)),
        rtol=1e-10,
    )


def test_jvp_linearity():
    a, xa = random_csr(5, 5, 0.6, 9)
    v = jnp.asarray(np.ones(5))
    tangent = jnp.asarray(np.arange(5.0))
    _, jv = jax.jvp(lambda v: csr_smvm(a, v), (v,), (tangent,))
    np.testing.assert_allclose(np.asarray(jv), xa @ np.arange(5.0), rtol=1e-10)


def test_grad_through_spgemm_apply():
    # the sort-free numeric SpGEMM pass is plain gather/multiply/segment-sum,
    # so gradients w.r.t. BOTH operands' values flow through the fixed plan
    import dataclasses as dc

    from sparse_tpu import spgemm_apply, spgemm_prepare

    a, xa = random_csr(6, 5, 0.5, 31)
    b, xb = random_csr(5, 7, 0.5, 32)
    plan = spgemm_prepare(a, b)

    def loss(da, db):
        c = spgemm_apply(plan, dc.replace(a, data=da), dc.replace(b, data=db))
        return jnp.sum(c.data ** 2)

    ga, gb = jax.grad(loss, argnums=(0, 1))(a.data, b.data)
    # analytic check via dense: L = ||A B||_F^2, dL/dA = 2 (A B) B^T at the
    # stored positions of A
    C = xa @ xb
    dA = 2.0 * C @ xb.T
    dB = 2.0 * xa.T @ C
    rows_a = np.repeat(np.arange(6), np.diff(np.asarray(a.indptr)))
    cols_a = np.asarray(a.indices)[: rows_a.size]
    np.testing.assert_allclose(
        np.asarray(ga)[: rows_a.size], dA[rows_a, cols_a], rtol=1e-10
    )
    rows_b = np.repeat(np.arange(5), np.diff(np.asarray(b.indptr)))
    cols_b = np.asarray(b.indices)[: rows_b.size]
    np.testing.assert_allclose(
        np.asarray(gb)[: rows_b.size], dB[rows_b, cols_b], rtol=1e-10
    )

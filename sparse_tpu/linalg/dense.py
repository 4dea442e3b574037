"""Dense within-block linear algebra: LU with partial pivoting, triangular
solves, and permutation vectors.

JAX equivalent of the external ``linalg``/``lup``/``perm`` packages the
reference's BSR module builds on (blocked_square_regular.fut:9-11, 169-172).
Everything here is jit-compatible with static shapes; the factorization loop
is a ``lax.fori_loop`` over columns so one compiled kernel serves any batch of
blocks under ``vmap``.

Permutation convention (mirrors the behavioral contract exercised by the
reference tests, blocked_square_regular_test.fut:239-258): a permutation is an
index vector ``p`` with *gather* semantics, ``permute(p, x) = x[p]``, and
``lup_dense(a)`` returns ``(LU, p)`` such that ``a[p] == L @ U`` where ``L``
is unit-lower (strict lower of LU) and ``U`` is the upper part of LU.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..ops.segmented import INDEX_DTYPE

__all__ = [
    "lup_dense",
    "lu_dense",
    "forsolve_dense",
    "backsolve_dense",
    "rowsolve_upper",
    "perm_id",
    "permute",
    "perm_compose",
    "perm_inverse",
    "perm_to_matrix",
]


# -- permutations --------------------------------------------------------------


def perm_id(n: int) -> jax.Array:
    """Identity permutation (the ``perm.id`` role)."""
    return jnp.arange(n, dtype=INDEX_DTYPE)


def permute(p: jax.Array, x: jax.Array) -> jax.Array:
    """Apply a permutation to the leading axis: ``permute(p, x)[i] = x[p[i]]``
    (the ``perm.permute`` role, used at blocked_square_regular.fut:437, 603)."""
    return x[p]


def perm_compose(p0: jax.Array, p1: jax.Array) -> jax.Array:
    """Concatenate permutations acting on consecutive disjoint ranges: ``p0``
    on ``[0, len(p0))`` and ``p1`` on the next ``len(p1)`` slots (the
    ``perm.add`` accumulation in the blocked LU loop,
    blocked_square_regular.fut:460)."""
    return jnp.concatenate([p0, p1 + p0.shape[0]]).astype(INDEX_DTYPE)


def perm_inverse(p: jax.Array) -> jax.Array:
    n = p.shape[0]
    return jnp.zeros((n,), INDEX_DTYPE).at[p].set(jnp.arange(n, dtype=INDEX_DTYPE))


def perm_to_matrix(p: jax.Array, dtype=jnp.float32) -> jax.Array:
    """Dense permutation matrix P with ``P @ x == permute(p, x)``."""
    n = p.shape[0]
    return jnp.zeros((n, n), dtype).at[jnp.arange(n), p].set(jnp.ones((), dtype))


# -- LU factorization ----------------------------------------------------------


def lup_dense(a: jax.Array) -> tuple[jax.Array, jax.Array]:
    """LU with partial (row) pivoting: returns ``(LU, p)`` with ``a[p] = L@U``.

    ``LU`` packs unit-lower ``L`` (strict lower, implicit unit diagonal) and
    ``U`` (upper incl. diagonal) in one matrix — the within-block
    factorization the blocked solver calls per diagonal block
    (``lup_mod.lup``, blocked_square_regular.fut:429-430).

    Column loop is a ``lax.fori_loop`` with masked rank-1 updates: static
    shapes, vmap/jit friendly.
    """
    a = jnp.asarray(a)
    n = a.shape[0]
    idx = jnp.arange(n, dtype=INDEX_DTYPE)

    def body(k, carry):
        lu, p = carry
        col = jnp.abs(lu[:, k])
        col = jnp.where(idx < k, -jnp.inf, col)
        piv = jnp.argmax(col).astype(INDEX_DTYPE)
        # swap rows k <-> piv (in both the matrix and the permutation)
        rk, rp = lu[k], lu[piv]
        lu = lu.at[k].set(rp).at[piv].set(rk)
        pk, pp = p[k], p[piv]
        p = p.at[k].set(pp).at[piv].set(pk)
        # eliminate below k; store multipliers in column k
        pivval = lu[k, k]
        below = idx > k
        safe_piv = jnp.where(pivval == 0, jnp.ones((), lu.dtype), pivval)
        factors = jnp.where(below, lu[:, k] / safe_piv, jnp.zeros((), lu.dtype))
        factors = jnp.where(
            (pivval == 0) & below & (lu[:, k] != 0),
            jnp.full((), jnp.inf, lu.dtype) * jnp.sign(lu[:, k]),
            factors,
        )
        # rank-1 update restricted to the trailing columns: columns < k of the
        # pivot row hold L multipliers, not U values
        urow = jnp.where(idx >= k, lu[k], jnp.zeros((), lu.dtype))
        lu = lu - jnp.where(below, factors, 0)[:, None] * urow[None, :]
        lu = lu.at[:, k].set(jnp.where(below, factors, lu[:, k]))
        return lu, p

    lu, p = jax.lax.fori_loop(0, n, body, (a, perm_id(n)))
    return lu, p


def lu_dense(a: jax.Array) -> jax.Array:
    """LU without pivoting (the ``lup_mod.lu`` role,
    blocked_square_regular.fut:516)."""
    a = jnp.asarray(a)
    n = a.shape[0]
    idx = jnp.arange(n, dtype=INDEX_DTYPE)

    def body(k, lu):
        pivval = lu[k, k]
        below = idx > k
        factors = jnp.where(below, lu[:, k] / pivval, jnp.zeros((), lu.dtype))
        urow = jnp.where(idx >= k, lu[k], jnp.zeros((), lu.dtype))
        lu = lu - jnp.where(below, factors, 0)[:, None] * urow[None, :]
        return lu.at[:, k].set(jnp.where(below, factors, lu[:, k]))

    return jax.lax.fori_loop(0, n, body, a)


# -- triangular solves ---------------------------------------------------------


def forsolve_dense(L: jax.Array, b: jax.Array) -> jax.Array:
    """Solve ``L x = b`` reading only the *strict* lower part of ``L`` with
    implicit unit diagonal (the ``lup_mod.forsolve`` contract used for
    ``X12 = L^-1 P A12``, blocked_square_regular.fut:436-439).  ``b`` may be a
    vector or a matrix of columns."""
    return jax.scipy.linalg.solve_triangular(L, b, lower=True, unit_diagonal=True)


def backsolve_dense(U: jax.Array, y: jax.Array) -> jax.Array:
    """Solve ``U x = y`` reading the upper part incl. diagonal (the
    ``lup_mod.backsolve`` contract)."""
    return jax.scipy.linalg.solve_triangular(U, y, lower=False)


def rowsolve_upper(U: jax.Array, y: jax.Array) -> jax.Array:
    """Solve ``x U = y`` for a row-system (``backsolve'`` in the reference,
    blocked_square_regular.fut:389-394) — i.e. ``x = y U^-1``.  Reads the
    upper part of ``U`` incl. diagonal; ``y`` may be a matrix of rows."""
    # x U = y  <=>  U^T x^T = y^T
    if y.ndim == 1:
        return jax.scipy.linalg.solve_triangular(U, y, lower=False, trans="T")
    return jax.scipy.linalg.solve_triangular(U, y.T, lower=False, trans="T").T

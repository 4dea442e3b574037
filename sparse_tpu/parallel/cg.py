"""Distributed iterative solvers on partitioned sparse matrices.

The framework's "training step" analogue: one step of conjugate gradient (or
power iteration) over a row-partitioned CSR, with the matrix and all vectors
sharded over the mesh and every reduction a compiled XLA collective.  This is
the end-to-end multi-chip pipeline the driver dry-runs (``__graft_entry__``)
and the weak-scaling benchmark exercises.

Every solver's matvec goes through :func:`~sparse_tpu.parallel.halo.dist_spmv`,
so ``a`` may be ANY partitioned type — ``PCSR`` (all-gather baseline) or
``HaloPCSR``/``HaloPCSROverlap`` (halo exchange).  Partition once with the
richest structure the pattern supports and the whole Krylov iteration
inherits that matvec.

No reference counterpart (the reference is single-device, SURVEY.md §2.3);
semantics are standard CG on SPD systems, validated against dense NumPy
solves in tests.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from .halo import dist_spmv
from .pcsr import PCSR

__all__ = ["cg_solve", "pcg_solve", "bicgstab_solve", "gmres_solve",
           "power_iteration_step", "estimate_lmax",
           "chebyshev_preconditioner"]


def _padded_len(a: PCSR) -> int:
    return a.rows_per_shard * a.n_shards


def cg_step(a: PCSR, mesh: Mesh, state):
    """One CG iteration; all vectors padded row-sharded, dots are global
    psums compiled by XLA from the sharded reductions."""
    x, r, p, rs = state
    ap = dist_spmv(a, p, mesh)
    denom = jnp.vdot(p, ap)
    alpha = rs / jnp.where(denom == 0, 1, denom)
    x = x + alpha * p
    r = r - alpha * ap
    rs_new = jnp.vdot(r, r)
    beta = rs_new / jnp.where(rs == 0, 1, rs)
    p = r + beta * p
    return x, r, p, rs_new


def cg_solve(a: PCSR, b: jax.Array, mesh: Mesh, *, iters: int = 50):
    """Solve ``A x = b`` (A square SPD, row-partitioned) by ``iters`` CG
    steps.  ``b`` must already be padded & sharded (see ``shard_vector``).
    Returns the padded row-sharded solution."""
    x0 = jnp.zeros_like(b)
    state = (x0, b, b, jnp.vdot(b, b))
    step = partial(cg_step, a, mesh)
    state = jax.lax.fori_loop(0, iters, lambda _, s: step(s), state)
    return state[0]


def _precond_apply(M, v: jax.Array) -> jax.Array:
    """Apply a preconditioner given as either the elementwise inverse
    diagonal (1-D array, Jacobi), batched inverse diagonal blocks (3-D
    array, block-Jacobi from ``solve.precond.block_jacobi_prepare``), or a
    callable ``M(v)`` (e.g. ``chebyshev_preconditioner``)."""
    if callable(M):
        return M(v)
    if M.ndim == 1:
        return M * v
    from ..solve.precond import block_jacobi_apply

    return block_jacobi_apply(M, v)


def pcg_solve(a: PCSR, b: jax.Array, inv_diag: jax.Array, mesh: Mesh,
              *, iters: int = 50):
    """Preconditioned CG: ``inv_diag`` is either the elementwise inverse of
    ``diag(A)`` padded & sharded like ``b`` (build from ``csr_diagonal`` +
    ``shard_vector``; pad slots must be 0 so padding stays inert), or the
    ``(nbk, bs, bs)`` inverse diagonal blocks from
    ``solve.precond.block_jacobi_prepare`` (prepare with
    ``padded_n = len(b)`` and a ``bs`` dividing the shard slab so GSPMD
    keeps the batched apply local)."""
    x0 = jnp.zeros_like(b)
    z0 = _precond_apply(inv_diag, b)
    state = (x0, b, z0, jnp.vdot(b, z0))

    def step(state):
        x, r, p, rz = state
        ap = dist_spmv(a, p, mesh)
        denom = jnp.vdot(p, ap)
        alpha = rz / jnp.where(denom == 0, 1, denom)
        x = x + alpha * p
        r = r - alpha * ap
        z = _precond_apply(inv_diag, r)
        rz_new = jnp.vdot(r, z)
        beta = rz_new / jnp.where(rz == 0, 1, rz)
        p = z + beta * p
        return x, r, p, rz_new

    state = jax.lax.fori_loop(0, iters, lambda _, s: step(s), state)
    return state[0]


def bicgstab_solve(a: PCSR, b: jax.Array, mesh: Mesh, *, iters: int = 50):
    """BiCGSTAB for general (non-symmetric) square systems, row-partitioned.

    Standard van-der-Vorst recurrence; two distributed SpMVs per iteration,
    all reductions compiled XLA collectives.  ``b`` padded & sharded like
    ``cg_solve``'s."""
    x0 = jnp.zeros_like(b)
    r0 = b
    state = (
        x0,
        r0,
        r0,  # p
        r0,  # r_hat (fixed shadow residual)
        jnp.vdot(r0, r0),  # rho
    )

    def safe_div(num, den):
        return num / jnp.where(den == 0, 1, den)

    def step(state):
        x, r, p, r_hat, rho = state
        v = dist_spmv(a, p, mesh)
        alpha = safe_div(rho, jnp.vdot(r_hat, v))
        s = r - alpha * v
        t = dist_spmv(a, s, mesh)
        omega = safe_div(jnp.vdot(t, s), jnp.vdot(t, t))
        x = x + alpha * p + omega * s
        r = s - omega * t
        rho_new = jnp.vdot(r_hat, r)
        beta = safe_div(rho_new, rho) * safe_div(alpha, omega)
        p = r + beta * (p - omega * v)
        return x, r, p, r_hat, rho_new

    state = jax.lax.fori_loop(0, iters, lambda _, s: step(s), state)
    return state[0]


def gmres_solve(a: PCSR, b: jax.Array, mesh: Mesh, *, inv_diag=None,
                restart: int = 20, iters: int = 5, tol: float = 0.0):
    """Restarted GMRES(restart) for general square systems, row-partitioned.

    The Krylov recurrence comes from ``jax.scipy.sparse.linalg.gmres`` (the
    idiomatic XLA formulation — batched Arnoldi, fixed shapes); this wrapper
    plugs in the distributed operator: matvecs are :func:`pcsr_spmv` on the
    mesh-sharded matrix, so GSPMD partitions the whole solve and the only
    cross-device traffic is the SpMV all-gather plus dot-product psums.

    ``inv_diag`` (optional) enables Jacobi preconditioning, same convention
    as :func:`pcg_solve` (padded, sharded, zeros in pad slots).  ``tol=0``
    runs the fixed iteration budget (jit-friendly: no early host sync).
    ``b`` padded & sharded like ``cg_solve``'s.  Returns the padded
    row-sharded solution."""
    from jax.scipy.sparse.linalg import gmres as _gmres

    mv = lambda v: dist_spmv(a, v, mesh)
    precond = (
        (lambda v: _precond_apply(inv_diag, v)) if inv_diag is not None else None
    )
    x, _ = _gmres(mv, b, tol=tol, atol=0.0, restart=restart, maxiter=iters,
                  M=precond, solve_method="batched")
    return x


def power_iteration_step(a: PCSR, v: jax.Array, mesh: Mesh):
    """One normalized power-iteration step: ``v <- A v / ||A v||``; returns
    (v_next, rayleigh_quotient_estimate)."""
    av = dist_spmv(a, v, mesh)
    norm = jnp.sqrt(jnp.vdot(av, av))
    lam = jnp.vdot(v, av)
    return av / jnp.where(norm == 0, 1, norm), lam


def estimate_lmax(a: PCSR, mesh: Mesh, *, iters: int = 30,
                  safety: float = 1.05) -> jax.Array:
    """Largest-eigenvalue estimate by power iteration (for
    :func:`chebyshev_preconditioner` bounds), scaled by ``safety`` so the
    Chebyshev interval covers the true spectrum."""
    L = a.rows_per_shard * a.n_shards
    dt = (a.data if hasattr(a, "data") else
          a.vals if hasattr(a, "vals") else a.int_data).dtype
    v0 = jnp.full((L,), 1.0 / np.sqrt(max(L, 1)), dt)

    def body(_, carry):
        v, _ = carry
        return power_iteration_step(a, v, mesh)

    _, lam = jax.lax.fori_loop(0, iters, body, (v0, jnp.zeros((), v0.dtype)))
    return lam * safety


def chebyshev_preconditioner(a: PCSR, mesh: Mesh, *, lmax, lmin=None,
                             degree: int = 8):
    """Polynomial (Chebyshev) preconditioner: returns a callable ``M(v)``
    approximating ``A^{-1} v`` with ``degree`` SpMVs and no solves — the
    accelerator-friendly preconditioner shape (pure matvec chains, no sequential
    triangular sweep).  ``A`` must be SPD with spectrum inside
    ``[lmin, lmax]`` (``lmin`` defaults to ``lmax / 30``; use
    :func:`estimate_lmax` for the bound).  The operator is a fixed
    polynomial in ``A``, hence symmetric — a valid CG preconditioner.
    Pass the result as ``pcg_solve``'s / ``gmres_solve``'s ``inv_diag``."""
    if lmin is None:
        lmin = lmax / 30.0
    d = (lmax + lmin) / 2.0
    c = (lmax - lmin) / 2.0

    def apply(v):
        z = jnp.zeros_like(v)
        r = v
        p = r
        alpha = 1.0 / d
        for i in range(degree):
            if i > 0:
                beta = (c * alpha / 2.0) ** 2 if i > 1 else 0.5 * (c * alpha) ** 2
                alpha = 1.0 / (d - beta / alpha)
                p = r + beta * p
            z = z + alpha * p
            r = r - alpha * dist_spmv(a, p, mesh)
        return z

    return apply

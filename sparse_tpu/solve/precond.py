"""Preconditioners for the iterative solvers.

Block-Jacobi is the batched step up from elementwise Jacobi: setup is
one scatter into batched dense diagonal blocks plus a batched inverse (dense
matmul work), and application is a batched (bs, bs) matvec — no sparse triangular
solve on the critical path, fully jit-compatible, and GSPMD partitions the
batched apply cleanly when blocks align with shard boundaries (choose ``bs``
dividing the padded rows-per-shard).

No reference counterpart (the reference has no iterative solvers); the
direct-solver analogue is the BSR LU stack (solve/bsr_lu.py).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..formats.csr import CSR
from ..ops.segmented import INDEX_DTYPE, row_ids_from_indptr

__all__ = ["block_jacobi_prepare", "block_jacobi_apply",
           "bsr_ilu0_preconditioner"]


@partial(jax.jit, static_argnames=("bs", "padded_n"))
def block_jacobi_prepare(a: CSR, bs: int, padded_n: int | None = None
                         ) -> jax.Array:
    """Inverses of the ``bs x bs`` diagonal blocks of a square CSR.

    Returns ``(padded_n // bs, bs, bs)`` with ``padded_n`` rounded up to a
    multiple of ``bs`` (default: the matrix size).  Blocks beyond ``n`` and
    zero diagonal entries are patched to identity, so padding slots pass
    through unchanged and a singular stored block cannot poison the solve.
    jit-compatible (value-dependent only through ``a.data``).
    """
    n, m = a.shape
    if n != m:
        raise ValueError(f"block_jacobi_prepare: square matrix required, got {a.shape}")
    L = padded_n if padded_n is not None else n
    L = -(-max(L, 1) // bs) * bs
    if L < n:
        raise ValueError(f"block_jacobi_prepare: padded_n {L} < n {n}")
    nbk = L // bs
    rows = row_ids_from_indptr(a.indptr, a.nse)
    cols = a.indices
    valid = rows < n
    in_diag = valid & (rows // bs == cols // bs)
    flat = jnp.where(
        in_diag,
        (rows // bs) * (bs * bs) + (rows % bs) * bs + (cols % bs),
        jnp.asarray(nbk * bs * bs, INDEX_DTYPE),
    )
    blocks = (
        jnp.zeros((nbk * bs * bs + 1,), a.dtype)
        .at[flat].add(a.data, mode="drop")[:-1]
        .reshape(nbk, bs, bs)
    )
    # patch zero diagonal entries (incl. all-padding blocks) to 1
    d = jnp.diagonal(blocks, axis1=1, axis2=2)
    blocks = blocks + jnp.eye(bs, dtype=a.dtype)[None] * (d == 0)[:, :, None]
    return jnp.linalg.inv(blocks)


def bsr_ilu0_preconditioner(a, padded_n: int | None = None):
    """Block ILU(0) preconditioner from the BSR LU stack: incomplete LU on
    the EXISTING block pattern (no fill, no pivoting — reference
    ``lu_nofill`` semantics, blocked_square_regular.fut:502-546), applied as
    one forward + one backward block-triangular sweep.

    Returns a callable ``M(v)`` for :func:`...parallel.cg.pcg_solve` /
    ``gmres_solve``; ``padded_n`` (>= n) matches the solver's padded vector
    length (pad slots pass through as zeros).  The sweeps are inherently
    sequential over block rows (one ``lax.fori_loop``), so this is the
    strong-but-serial end of the preconditioner ladder — prefer
    block-Jacobi/Chebyshev when iteration counts are already low.  ILU(0)
    of a non-SPD matrix is not symmetric: pair with GMRES/BiCGSTAB unless
    the system is SPD and well-behaved."""
    from .bsr_lu import bsr_lu_nofill, bsr_tri_plan, _tri_sweep

    LU = bsr_lu_nofill(a)
    fplan = bsr_tri_plan(LU, lower=True)
    bplan = bsr_tri_plan(LU, lower=False)
    n = a.n
    L = padded_n if padded_n is not None else n
    if L < n:
        raise ValueError(f"bsr_ilu0_preconditioner: padded_n {L} < n {n}")

    def apply(v):
        if v.shape != (L,):
            raise ValueError(
                f"bsr_ilu0_preconditioner: vector shape {v.shape} != ({L},)"
            )
        y = _tri_sweep(LU, v[:n], fplan)
        z = _tri_sweep(LU, y, bplan)
        if L == n:
            return z
        return jnp.concatenate([z, jnp.zeros((L - n,), z.dtype)])

    return apply


def block_jacobi_apply(inv_blocks: jax.Array, v: jax.Array) -> jax.Array:
    """Apply the block-Jacobi preconditioner: ``z = diag(B_i^{-1}) v``.

    ``v`` has length ``nbk * bs`` (the padded length the blocks were
    prepared for)."""
    nbk, bs, _ = inv_blocks.shape
    if v.shape != (nbk * bs,):
        raise ValueError(
            f"block_jacobi_apply: vector shape {v.shape} != ({nbk * bs},)"
        )
    return jnp.einsum("bij,bj->bi", inv_blocks, v.reshape(nbk, bs)).reshape(-1)

"""SpMM: sparse x dense multiplication (CSR times tall-skinny dense).

North-star addition (BASELINE.json config 3): generalises the reference's
``smvm`` (compressed.fut:134-146) and ``dmsmm`` (mono.fut:161-162) to
sparse-times-dense-matrix.  XLA path: row gather + segment-sum; block
matrices take ``formats.bell.bell_spmm`` (a Triton kernel on GPUs).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..formats.csr import CSC, CSR, _csc_as_csr_t
from .segmented import row_ids_from_indptr, segment_sum


def spmm(a: CSR, b: jax.Array) -> jax.Array:
    """C[n, k] = A[n, m] @ B[m, k] with A sparse CSR, B dense."""
    n, m = a.shape
    b = jnp.asarray(b)
    if b.ndim != 2 or b.shape[0] != m:
        raise ValueError(f"spmm: dense operand shape {b.shape} != ({m}, k)")
    k = b.shape[1]
    out_dtype = jnp.result_type(a.dtype, b.dtype)
    if a.nse == 0 or m == 0 or k == 0:
        return jnp.zeros((n, k), out_dtype)
    rows = row_ids_from_indptr(a.indptr, a.nse)
    gathered = b[a.indices]  # (nse, k); padding indices are 0, data 0
    prods = gathered * a.data[:, None]
    return segment_sum(prods, rows, n, indices_are_sorted=True)


def dsmm(b: jax.Array, a: CSC) -> jax.Array:
    """C[k, m] = B[k, n] @ A[n, m] with B dense, A sparse CSC.

    Dense-times-sparse through the transpose duality: ``B @ A = (A^T @
    B^T)^T`` where ``A^T`` is the CSC's storage viewed as CSR (free).
    Generalises the reference's ``vsmm`` (compressed.fut:223-224).
    """
    b = jnp.asarray(b)
    n, m = a.shape
    if b.ndim != 2 or b.shape[1] != n:
        raise ValueError(f"dsmm: dense operand shape {b.shape} != (k, {n})")
    return spmm(_csc_as_csr_t(a), b.T).T

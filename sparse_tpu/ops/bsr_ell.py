"""Blocked-ELL fast paths for BSR SpMV / SpMM.

Gathers pay a per-element cost, so the way to reach memory-bound
throughput is to make every gathered granule big: at block size ``bsz`` the
operand gathers move ``bsz``-wide chunks (SpMV) or ``bsz x k`` panels (SpMM)
and the matrix itself streams as dense blocks — scalar-gather cost drops by
``bsz^2``.  Combined with block-row ELL windows (like ``ops/spmv.py``) the
whole pipeline is gather -> batched block einsum -> windowed reduce, with no
scatter anywhere.

This is the speed-of-light SpMV path for matrices with natural block
structure (FEM / SuiteSparse bcsstk-style); for unstructured matrices use
``ops/spmv.py`` or re-block with ``bsr_from_coo``.

Semantics match ``bsr_smvm`` (reference smvm, blocked_square_regular.fut:
307-331) exactly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..formats.bsr import BSR
from .segmented import INDEX_DTYPE
from ..utils.precision import matmul_precision

__all__ = ["bsr_row_capacity", "bsr_smvm_ell", "bsr_spmm_ell"]


def bsr_row_capacity(a: BSR) -> int:
    """Max stored blocks in any block row (eager): the static ELL width."""
    idxs = np.asarray(a.indices)
    nb = a.nb
    valid = idxs < nb * nb
    if not valid.any():
        return 0
    rows = idxs[valid] // nb
    return int(np.bincount(rows, minlength=nb).max())


def _block_windows(a: BSR, Lb: int):
    """Dense (nb, Lb) windows over the sorted block arrays.

    Returns (block_vals (nb, Lb, bsz, bsz), col_ids (nb, Lb), mask)."""
    nb = a.nb
    # block-level row pointer from the sorted flattened indices
    row_ptr = jnp.searchsorted(
        a.indices, jnp.arange(nb + 1, dtype=INDEX_DTYPE) * nb
    ).astype(INDEX_DTYPE)
    starts = row_ptr[:-1]
    lens = row_ptr[1:] - starts
    offs = jnp.arange(Lb, dtype=INDEX_DTYPE)
    pos = starts[:, None] + offs[None, :]
    mask = offs[None, :] < lens[:, None]
    pos = jnp.minimum(pos, max(a.nbz - 1, 0))
    flat = pos.reshape(-1)
    bidx = jnp.where(mask, a.indices[flat].reshape(nb, Lb), 0)
    cols = jnp.where(mask, bidx % nb, 0).astype(INDEX_DTYPE)
    bsz = a.bsz
    blocks = a.blocks.reshape(a.nbz, bsz * bsz)[flat].reshape(nb, Lb, bsz, bsz)
    blocks = jnp.where(mask[:, :, None, None], blocks, 0)
    return blocks, cols, mask


def bsr_smvm_ell(a: BSR, v: jax.Array, Lb: int) -> jax.Array:
    """Scatter-free BSR SpMV.  ``Lb`` is a static bound >= the fullest block
    row (see :func:`bsr_row_capacity`); jit-compatible."""
    v = jnp.asarray(v)
    if v.shape != (a.n,):
        raise ValueError(f"bsr_smvm_ell: vector shape {v.shape} != ({a.n},)")
    out_dtype = jnp.result_type(a.dtype, v.dtype)
    if a.nbz == 0 or a.n == 0 or Lb == 0:
        return jnp.zeros((a.n,), out_dtype)
    blocks, cols, _ = _block_windows(a, Lb)
    vb = v.reshape(a.nb, a.bsz)[cols.reshape(-1)].reshape(a.nb, Lb, a.bsz)
    out = jnp.einsum("rlij,rlj->ri", blocks, vb,
                     precision=matmul_precision(blocks.dtype, vb.dtype))
    return out.reshape(a.n).astype(out_dtype)


def bsr_spmm_ell(a: BSR, b: jax.Array, Lb: int) -> jax.Array:
    """Scatter-free BSR SpMM (BSR x dense (n, k)): block-panel gathers feed
    a batched (bsz x bsz) @ (bsz x k) einsum."""
    b = jnp.asarray(b)
    if b.ndim != 2 or b.shape[0] != a.n:
        raise ValueError(f"bsr_spmm_ell: operand shape {b.shape} != ({a.n}, k)")
    k = b.shape[1]
    out_dtype = jnp.result_type(a.dtype, b.dtype)
    if a.nbz == 0 or a.n == 0 or Lb == 0 or k == 0:
        return jnp.zeros((a.n, k), out_dtype)
    blocks, cols, _ = _block_windows(a, Lb)
    panels = b.reshape(a.nb, a.bsz, k)[cols.reshape(-1)].reshape(
        a.nb, Lb, a.bsz, k
    )
    out = jnp.einsum("rlij,rljk->rik", blocks, panels,
                     precision=matmul_precision(blocks.dtype, panels.dtype))
    return out.reshape(a.n, k).astype(out_dtype)

"""Row-binned CSR SpMV/SpMM (the XLA rung of ``smvm_prepare``).

The reference's ``smvm`` engine is ``expand_outer_reduce`` — a flat gather +
segmented reduction (compressed.fut:134-146), which lowers to a
scatter-add.  The formulation here has no scatter in the reduction:

* **ELL-ification on the fly**: each row's entries are viewed as a dense
  ``(rows, L)`` window of the CSR arrays (``L`` = static row capacity), so
  the whole SpMV is gather -> multiply -> row-reduce, dense ops that XLA
  fuses into one pass per bin.
* **Row binning** (``SpmvPlan``): rows are bucketed by length into power-of-2
  capacity bins (one ELL sweep per bin), so a few long rows don't inflate the
  padding of the million short ones.  The plan is computed once per sparsity
  pattern (eager, host-side) and the apply path is fully jit-compatible with
  static shapes.

Both paths return bit-identical results to :func:`csr_smvm` up to float
summation order.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..formats.csr import CSR
from .segmented import INDEX_DTYPE
from ..utils.precision import matmul_precision

__all__ = [
    "csr_smvm_ell",
    "csr_spmm_ell",
    "row_capacity",
    "SpmvPlan",
    "build_spmv_plan",
    "csr_smvm_fast",
    "csr_spmm_fast",
]


def row_capacity(a: CSR) -> int:
    """Max stored entries in any row (eager host sync): the static ELL width."""
    indptr = np.asarray(a.indptr)
    if indptr.shape[0] <= 1:
        return 0
    return int(np.max(indptr[1:] - indptr[:-1]))


def _ell_windows(a: CSR, L: int, rows_sel=None):
    """(idx, val) dense (rows, L) windows of the CSR arrays; masked tails."""
    starts = a.indptr[:-1] if rows_sel is None else a.indptr[rows_sel]
    ends = a.indptr[1:] if rows_sel is None else a.indptr[rows_sel + 1]
    lens = (ends - starts).astype(INDEX_DTYPE)
    offs = jnp.arange(L, dtype=INDEX_DTYPE)
    pos = starts[:, None].astype(INDEX_DTYPE) + offs[None, :]
    mask = offs[None, :] < lens[:, None]
    pos = jnp.minimum(pos, max(a.nse - 1, 0))
    idx = jnp.where(mask, a.indices[pos], 0)
    val = jnp.where(mask, a.data[pos], 0)
    return idx, val


def csr_smvm_ell(a: CSR, v: jax.Array, L: int) -> jax.Array:
    """SpMV via on-the-fly ELL windows: no scatter, jit-compatible.

    ``L`` must be a static bound >= the longest row (see
    :func:`row_capacity`)."""
    n, m = a.shape
    v = jnp.asarray(v)
    if a.nse == 0 or m == 0 or L == 0:
        return jnp.zeros((n,), jnp.result_type(a.dtype, v.dtype))
    idx, val = _ell_windows(a, L)
    # flat 1-D gather then reshape
    g = v[idx.reshape(-1)].reshape(idx.shape)
    return jnp.sum(val * g, axis=1)


def csr_spmm_ell(a: CSR, b: jax.Array, L: int) -> jax.Array:
    """SpMM (CSR x dense (m, k)) via ELL windows: gather rows of ``b`` and
    contract the window axis."""
    n, m = a.shape
    b = jnp.asarray(b)
    k = b.shape[1]
    if a.nse == 0 or m == 0 or k == 0 or L == 0:
        return jnp.zeros((n, k), jnp.result_type(a.dtype, b.dtype))
    idx, val = _ell_windows(a, L)
    # flat row-gather: each gathered element is a contiguous k-wide row of b
    gathered = b[idx.reshape(-1)].reshape(*idx.shape, k)
    return jnp.einsum("nl,nlk->nk", val, gathered,
                      precision=matmul_precision(val.dtype, b.dtype))


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["perm"],
    meta_fields=["bin_sizes", "bin_caps", "n"],
)
@dataclasses.dataclass(frozen=True)
class SpmvPlan:
    """Row-binning plan: ``perm`` orders rows by length bin; bin ``i`` covers
    ``bin_sizes[i]`` rows with static ELL capacity ``bin_caps[i]``."""

    perm: jax.Array
    bin_sizes: tuple[int, ...]
    bin_caps: tuple[int, ...]
    n: int


def build_spmv_plan(a: CSR) -> SpmvPlan:
    """Bucket rows into power-of-2 length bins (eager, once per pattern)."""
    indptr = np.asarray(a.indptr)
    n = a.shape[0]
    lens = indptr[1:] - indptr[:-1]
    caps = np.zeros(n, np.int64)
    nz = lens > 0
    caps[nz] = 2 ** np.ceil(np.log2(lens[nz])).astype(np.int64)
    order = np.argsort(caps, kind="stable")
    sorted_caps = caps[order]
    uniq, counts = np.unique(sorted_caps, return_counts=True)
    keep = uniq > 0
    # rows with zero entries contribute nothing; skip their bin entirely
    skip = int(counts[~keep].sum())
    return SpmvPlan(
        perm=jnp.asarray(order[skip:], INDEX_DTYPE),
        bin_sizes=tuple(int(c) for c in counts[keep]),
        bin_caps=tuple(int(u) for u in uniq[keep]),
        n=n,
    )


def _apply_plan(a: CSR, operand, plan: SpmvPlan, kernel,
                row_chunk: int | None = None):
    """Run ``kernel(idx, val, operand)`` over every bin's ELL windows.

    With ``row_chunk`` set, each bin is processed in row chunks via
    ``lax.map`` so the materialized gather intermediate stays bounded at
    ``row_chunk * cap * width`` — required when ``rows * L * k`` would
    otherwise exceed memory (e.g. SpMM with large k)."""
    out_pieces = []
    start = 0
    for size, cap in zip(plan.bin_sizes, plan.bin_caps):
        rows_sel = jax.lax.slice_in_dim(plan.perm, start, start + size)
        if row_chunk is None or size <= row_chunk:
            idx, val = _ell_windows(a, cap, rows_sel=rows_sel)
            out_pieces.append(kernel(idx, val, operand))
        else:
            g = -(-size // row_chunk)
            pad = g * row_chunk - size
            # pad with repeats of the last row; sliced off below
            rows_pad = jnp.concatenate(
                [rows_sel, jnp.broadcast_to(rows_sel[-1:], (pad,))]
            ).reshape(g, row_chunk)

            def one(rs):
                idx, val = _ell_windows(a, cap, rows_sel=rs)
                return kernel(idx, val, operand)

            chunked = jax.lax.map(one, rows_pad)
            out_pieces.append(
                chunked.reshape((g * row_chunk,) + chunked.shape[2:])[:size]
            )
        start += size
    return jnp.concatenate(out_pieces) if out_pieces else None


def csr_smvm_fast(a: CSR, v: jax.Array, plan: SpmvPlan | None = None,
                  row_chunk: int | None = None) -> jax.Array:
    """Row-binned SpMV.  With a precomputed ``plan`` this is jit-compatible
    (pass the plan as a static/captured value); without one it is eager."""
    n, m = a.shape
    v = jnp.asarray(v)
    if v.shape != (m,):
        raise ValueError(f"csr_smvm_fast: vector shape {v.shape} != ({m},)")
    out_dtype = jnp.result_type(a.dtype, v.dtype)
    if plan is None:
        plan = build_spmv_plan(a)
    if not plan.bin_sizes or a.nse == 0 or m == 0:
        return jnp.zeros((n,), out_dtype)

    def kernel(idx, val, v):
        g = v[idx.reshape(-1)].reshape(idx.shape)
        return jnp.sum(val * g, axis=1)

    vals = _apply_plan(a, v, plan, kernel, row_chunk)
    out = jnp.zeros((n,), out_dtype)
    return out.at[plan.perm].set(vals)


def csr_spmm_fast(a: CSR, b: jax.Array, plan: SpmvPlan | None = None,
                  row_chunk: int | None = None) -> jax.Array:
    """Row-binned SpMM (CSR x dense (m, k)).  Set ``row_chunk`` to bound
    the gathered intermediate at ``row_chunk * L * k`` elements."""
    n, m = a.shape
    b = jnp.asarray(b)
    out_dtype = jnp.result_type(a.dtype, b.dtype)
    if plan is None:
        plan = build_spmv_plan(a)
    if not plan.bin_sizes or a.nse == 0 or m == 0 or b.shape[1] == 0:
        return jnp.zeros((n, b.shape[1]), out_dtype)

    def kernel(idx, val, b):
        g = b[idx.reshape(-1)].reshape(*idx.shape, b.shape[1])
        return jnp.einsum("nl,nlk->nk", val, g,
                          precision=matmul_precision(val.dtype, b.dtype))

    vals = _apply_plan(a, b, plan, kernel, row_chunk)
    out = jnp.zeros((n, b.shape[1]), out_dtype)
    return out.at[plan.perm].set(vals)

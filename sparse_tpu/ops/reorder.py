"""Bandwidth-reducing reordering (reverse Cuthill-McKee) and CSR permutation.

Locality helps every SpMV/SpMM formulation here: when each row's columns
land near the diagonal, operand gathers hit the same cache lines, and a
block-banded pattern converts to dense BELL blocks.  Real unstructured
matrices (FEM meshes, circuit graphs, sparse networks) usually HAVE that
locality — just not in their stored order.  RCM recovers it: a symmetric
permutation that clusters every row's columns around the diagonal.

The reference library has no reordering (it is format-local; nothing in
compressed.fut permutes).

Split in the house prepare/apply style (cf. ``ops/spgemm.spgemm_prepare``):
the symbolic pass (:func:`rcm_order`, :func:`permute_prepare`) runs once per
pattern on the host (native C++ core with a NumPy fallback, pinned
bit-identical by tests); the numeric pass (:func:`permute_apply`) is a pure
device gather, jit-compatible, reusable across value updates.

Usage (symmetric reorder around SpMV)::

    perm = rcm_order(a)                      # host, once per pattern
    plan = permute_prepare(a, perm, perm)    # host, once per pattern
    ap = permute_apply(plan, a)              # device gather; A' = P A P^T
    yp = ap @ x[perm]                        # banded SpMV
    y = unpermute_vector(yp, perm)           # y == a @ x
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..formats.csr import CSR
from ..native import plansort
from .segmented import INDEX_DTYPE

__all__ = [
    "rcm_order",
    "csr_bandwidth",
    "PermutePlan",
    "permute_prepare",
    "permute_apply",
    "csr_permute",
    "permute_vector",
    "unpermute_vector",
    "reorder_for_locality",
]


# -- RCM ordering ----------------------------------------------------------------


def rcm_order(a: CSR) -> np.ndarray:
    """Reverse Cuthill-McKee ordering of a square CSR's symmetrized pattern.

    Returns a host int64 permutation ``perm`` with ``perm[k]`` = the old
    index placed at new position k — the SciPy ``reverse_cuthill_mckee``
    convention: ``A[perm][:, perm]`` is (near-)banded.  Eager host symbolic
    pass (structure only; fetches ``indptr``/``indices``).  Native C++ core
    (``native/_plansort.cpp:rcm_order``) with a NumPy fallback pinned
    bit-identical by tests.
    """
    n, m = a.shape
    if n != m:
        raise ValueError(f"rcm_order: matrix must be square, got {a.shape}")
    if n == 0:
        return np.zeros(0, np.int64)
    indptr = np.asarray(a.indptr, np.int64)
    k = int(indptr[-1])
    cols = np.asarray(a.indices[:k], np.int64)
    perm = plansort.rcm_order(indptr, cols)
    if perm is None:
        perm = _rcm_numpy(indptr, cols, n)
    return perm


def _rcm_numpy(indptr: np.ndarray, cols: np.ndarray, n: int) -> np.ndarray:
    """Pure-NumPy RCM, the native core's semantic pin: symmetrize + dedup,
    BFS per component from the first unvisited minimum-degree node, frontier
    neighbours appended in ascending (degree, node id) order, whole order
    reversed."""
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    off = rows != cols  # self-loops contribute no edge
    r, c = rows[off], cols[off]
    keys = np.unique(
        np.concatenate([r * n + c, c * n + r]) if r.size else r
    )
    adj_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount((keys // n).astype(np.int64), minlength=n),
              out=adj_ptr[1:])
    adj = (keys % n).astype(np.int64)
    deg = np.diff(adj_ptr)

    visited = np.zeros(n, bool)
    perm = np.empty(n, np.int64)
    head = tail = 0
    while tail < n:
        cand = np.flatnonzero(~visited)
        seed = cand[np.argmin(deg[cand])]
        visited[seed] = True
        perm[tail] = seed
        tail += 1
        while head < tail:
            u = perm[head]
            head += 1
            nb = adj[adj_ptr[u]:adj_ptr[u + 1]]
            nb = nb[~visited[nb]]
            if nb.size:
                nb = nb[np.argsort(deg[nb], kind="stable")]
                visited[nb] = True
                perm[tail:tail + nb.size] = nb
                tail += nb.size
    return perm[::-1].copy()


def csr_bandwidth(a: CSR) -> int:
    """Maximum ``|i - j|`` over stored entries (eager host metric; 0 for an
    empty matrix).  The quantity RCM minimizes — drives kernel dispatch and
    the reorder tests."""
    n, _ = a.shape
    indptr = np.asarray(a.indptr, np.int64)
    k = int(indptr[-1])
    if k == 0:
        return 0
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    cols = np.asarray(a.indices[:k], np.int64)
    return int(np.abs(rows - cols).max())


# -- CSR permutation -------------------------------------------------------------


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["indptr", "indices", "src"],
    meta_fields=["shape", "capacity"],
)
@dataclasses.dataclass(frozen=True)
class PermutePlan:
    """Pattern-bound CSR permutation plan (from :func:`permute_prepare`).

    ``indptr``/``indices``: the permuted matrix's structure; ``src``: for
    each new storage position, the old storage position whose value lands
    there (identity on the padding tail, so padded capacities ride along).
    """

    indptr: jax.Array
    indices: jax.Array
    src: jax.Array
    shape: tuple[int, int]
    capacity: int


def _is_permutation(p: np.ndarray, n: int) -> bool:
    if n == 0:
        return True
    if p.min() < 0 or p.max() >= n:
        return False
    return bool(np.bincount(p, minlength=n).max() == 1)


def permute_prepare(a: CSR, rperm, cperm=None) -> PermutePlan:
    """Host symbolic pass: plan ``A[rperm][:, cperm]`` for a fixed pattern.

    ``rperm``/``cperm`` follow the SciPy convention (``perm[k]`` = old index
    at new position k); ``cperm=None`` leaves columns in place.  Eager
    (fetches structure); the returned plan drives :func:`permute_apply`,
    a pure device gather over values — rebuild only when the *pattern*
    changes, not the values.
    """
    n, m = a.shape
    rperm = np.asarray(rperm, np.int64)
    if rperm.shape != (n,) or not _is_permutation(rperm, n):
        raise ValueError("permute_prepare: rperm is not a permutation of rows")
    if cperm is None:
        inv_c = np.arange(m, dtype=np.int64)
    else:
        cperm = np.asarray(cperm, np.int64)
        if cperm.shape != (m,) or not _is_permutation(cperm, m):
            raise ValueError(
                "permute_prepare: cperm is not a permutation of columns"
            )
        inv_c = np.empty(m, np.int64)
        inv_c[cperm] = np.arange(m, dtype=np.int64)

    indptr = np.asarray(a.indptr, np.int64)
    k = int(indptr[-1])
    cap = a.nse
    cols = np.asarray(a.indices[:k], np.int64)

    counts = np.diff(indptr)
    new_counts = counts[rperm]
    new_indptr = np.zeros(n + 1, np.int64)
    np.cumsum(new_counts, out=new_indptr[1:])

    # old storage position feeding each new position (rows regrouped)
    starts_old = indptr[rperm]
    row_of = np.repeat(np.arange(n, dtype=np.int64), new_counts)
    src = (
        np.arange(k, dtype=np.int64)
        - np.repeat(new_indptr[:-1], new_counts)
        + np.repeat(starts_old, new_counts)
    )
    new_cols = inv_c[cols[src]]
    # within-row column sort: rows are grouped ascending, so one stable
    # argsort of the fused key orders every row at once
    order = plansort.argsort_u64(row_of * (m + 1) + new_cols)
    src = src[order]
    new_cols = new_cols[order]

    src_full = np.concatenate([src, np.arange(k, cap, dtype=np.int64)])
    ind_full = np.concatenate([new_cols, np.zeros(cap - k, np.int64)])
    return PermutePlan(
        indptr=jnp.asarray(new_indptr, INDEX_DTYPE),
        indices=jnp.asarray(ind_full, INDEX_DTYPE),
        src=jnp.asarray(src_full, INDEX_DTYPE),
        shape=(n, m),
        capacity=cap,
    )


def permute_apply(plan: PermutePlan, a: CSR) -> CSR:
    """Numeric pass: permuted CSR from a plan + current values.  One device
    gather; jit-compatible; ``a`` must carry the pattern the plan was built
    from (same shape/capacity — enforced; entry order assumed)."""
    if a.shape != plan.shape or a.nse != plan.capacity:
        raise ValueError(
            f"permute_apply: matrix {a.shape}/nse={a.nse} does not match "
            f"plan {plan.shape}/nse={plan.capacity}"
        )
    return CSR(
        data=a.data[plan.src],
        indices=plan.indices,
        indptr=plan.indptr,
        shape=plan.shape,
    )


def csr_permute(a: CSR, rperm, cperm=None) -> CSR:
    """``A[rperm][:, cperm]`` in one shot (prepare + apply).  Eager symbolic
    pass; use :func:`permute_prepare`/:func:`permute_apply` to amortize over
    value updates."""
    return permute_apply(permute_prepare(a, rperm, cperm), a)


def permute_vector(v: jax.Array, perm) -> jax.Array:
    """``(P v)[k] = v[perm[k]]`` — the operand-side companion of a symmetric
    reorder (jit-compatible gather)."""
    return jnp.asarray(v)[jnp.asarray(np.asarray(perm, np.int64))]


def unpermute_vector(v: jax.Array, perm) -> jax.Array:
    """Inverse of :func:`permute_vector`: scatter results back to original
    positions (jit-compatible)."""
    v = jnp.asarray(v)
    p = jnp.asarray(np.asarray(perm, np.int64))
    return jnp.zeros_like(v).at[p].set(v)


def reorder_for_locality(a: CSR) -> tuple[CSR, np.ndarray]:
    """Symmetric RCM reorder: returns ``(P A P^T, perm)``.  The permuted
    matrix is the one to build plans on (``smvm_prepare``, BELL
    conversion); solve in permuted space with ``permute_vector`` /
    :func:`unpermute_vector` at the boundary."""
    perm = rcm_order(a)
    return csr_permute(a, perm, perm), perm

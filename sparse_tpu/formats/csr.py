"""CSR / CSC compressed sparse matrices (the central format).

A re-design of the reference's ``mk_compressed`` functor
(compressed.fut:61-332):

* The representation is a pytree dataclass with **static stored capacity**
  ``nse``: ``data``/``indices`` have length ``nse``, ``indptr`` is an
  *exclusive* prefix of length n+1 (``indptr[n]`` = valid entry count).  The
  reference instead uses an inclusive offset array plus size-lifted arrays
  (compressed.fut:93-96); static capacity + padding is the XLA-compatible
  equivalent.
* Padding entries sit at the tail with ``indices == 0`` and ``data == 0`` so
  any gather-multiply contributes zero and any scatter adds zero.
* CSC is the same arrays reinterpreted: ``transpose`` is O(1) and free of
  data movement, exactly like the reference's duality (compressed.fut:185-226).
* ``smvm`` lowers to gather + segment-sum (the XLA reference path); the
  row-binned SpMV and the one-call dispatch live in ``sparse_tpu.ops``.

Semantics preserved from the reference:
  construction sums duplicate triples (compressed.fut:154-160); ``+``/``-``
  merge via COO concatenation so cancellations stay *stored* as explicit
  zeros; ``nnz`` counts only non-zero stored values (compressed.fut:162-164).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.segmented import (
    INDEX_DTYPE,
    cumsum_exclusive,
    row_ids_from_indptr,
    segment_sum,
)
from .coo import (
    COO,
    coo_concatenate,
    coo_from_dense,
    coo_from_triples,
    coo_normalize,
    coo_scale,
    coo_todense,
    coo_transpose,
)

__all__ = [
    "CSR",
    "CSC",
    "csr_empty",
    "csr_eye",
    "csr_diag",
    "csr_from_coo",
    "csr_from_dense",
    "csr_from_triples",
    "csr_to_coo",
    "csr_todense",
    "csr_smvm",
    "csr_scale",
    "csr_add",
    "csr_sub",
    "csr_nnz",
    "csr_transpose",
    "csc_empty",
    "csc_eye",
    "csc_diag",
    "csc_from_coo",
    "csc_from_triples",
    "csc_to_coo",
    "csc_todense",
    "csc_vsmm",
    "csc_scale",
    "csc_add",
    "csc_sub",
    "csc_nnz",
    "csc_transpose",
]


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["data", "indices", "indptr"],
    meta_fields=["shape"],
)
@dataclasses.dataclass(frozen=True)
class CSR:
    """Compressed sparse row matrix with static capacity.

    ``indptr``: [n+1] exclusive prefix; ``indices``: [nse] column ids;
    ``data``: [nse] values.  Rows are sorted; within a row columns are sorted
    and unique (guaranteed by construction through :func:`csr_from_coo`).
    """

    data: jax.Array
    indices: jax.Array
    indptr: jax.Array
    shape: tuple[int, int]

    @property
    def nse(self) -> int:
        return self.data.shape[0]

    @property
    def dtype(self):
        return self.data.dtype

    # operators -------------------------------------------------------------
    def __matmul__(self, other):
        if isinstance(other, CSC):
            from ..ops.spgemm import spgemm

            return spgemm(self, other)
        other = jnp.asarray(other)
        if other.ndim == 1:
            return csr_smvm(self, other)
        from ..ops.spmm import spmm

        return spmm(self, other)

    def __add__(self, other: "CSR") -> "CSR":
        return csr_add(self, other)

    def __sub__(self, other: "CSR") -> "CSR":
        return csr_sub(self, other)

    def __mul__(self, v) -> "CSR":
        return csr_scale(v, self)

    __rmul__ = __mul__

    @property
    def T(self) -> "CSC":
        return csr_transpose(self)

    def todense(self) -> jax.Array:
        return csr_todense(self)

    def tocoo(self) -> COO:
        return csr_to_coo(self)

    def nnz(self) -> jax.Array:
        return csr_nnz(self)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["data", "indices", "indptr"],
    meta_fields=["shape"],
)
@dataclasses.dataclass(frozen=True)
class CSC:
    """Compressed sparse column matrix of logical shape ``shape=(n, m)``.

    The arrays are exactly a CSR representation of the transpose (m x n):
    ``indptr`` has length m+1 (one slot per *column*), ``indices`` holds row
    ids.  This realizes the reference's O(1) transpose duality
    (compressed.fut:185-226).
    """

    data: jax.Array
    indices: jax.Array
    indptr: jax.Array
    shape: tuple[int, int]

    @property
    def nse(self) -> int:
        return self.data.shape[0]

    @property
    def dtype(self):
        return self.data.dtype

    def __add__(self, other: "CSC") -> "CSC":
        return csc_add(self, other)

    def __sub__(self, other: "CSC") -> "CSC":
        return csc_sub(self, other)

    def __mul__(self, v) -> "CSC":
        return csc_scale(v, self)

    __rmul__ = __mul__

    def __rmatmul__(self, v):
        v = jnp.asarray(v)
        if v.ndim == 1:
            return csc_vsmm(v, self)
        return NotImplemented

    @property
    def T(self) -> "CSR":
        return csc_transpose(self)

    def todense(self) -> jax.Array:
        return csc_todense(self)

    def tocoo(self) -> COO:
        return csc_to_coo(self)

    def nnz(self) -> jax.Array:
        return csc_nnz(self)


# -- transpose duality (O(1), no data movement) ------------------------------


def csr_transpose(a: CSR) -> CSC:
    """CSR(n, m) -> CSC(m, n), zero cost (reference compressed.fut:185-186)."""
    n, m = a.shape
    return CSC(data=a.data, indices=a.indices, indptr=a.indptr, shape=(m, n))


def csc_transpose(a: CSC) -> CSR:
    n, m = a.shape
    return CSR(data=a.data, indices=a.indices, indptr=a.indptr, shape=(m, n))


def _csc_as_csr_t(a: CSC) -> CSR:
    """View the CSC's storage as the CSR of its transpose."""
    return csc_transpose(a)


# -- constructors -------------------------------------------------------------


def csr_empty(n: int, m: int, nse: int = 0, dtype=jnp.float32) -> CSR:
    """The zero matrix (reference ``zero``, compressed.fut:98-103), with an
    optional pre-allocated capacity."""
    return CSR(
        data=jnp.zeros((nse,), dtype),
        indices=jnp.zeros((nse,), INDEX_DTYPE),
        indptr=jnp.zeros((n + 1,), INDEX_DTYPE),
        shape=(n, m),
    )


def csr_eye(n: int, m: int, dtype=jnp.float32) -> CSR:
    """Identity (reference ``eye``, compressed.fut:105-113)."""
    e = min(n, m)
    indptr = jnp.concatenate(
        [
            jnp.arange(e + 1, dtype=INDEX_DTYPE),
            jnp.full((n - e,), e, INDEX_DTYPE),
        ]
    )
    return CSR(
        data=jnp.ones((e,), dtype),
        indices=jnp.arange(e, dtype=INDEX_DTYPE),
        indptr=indptr,
        shape=(n, m),
    )


def csr_diag(v: jax.Array) -> CSR:
    """Diagonal matrix from a vector (reference ``diag``, compressed.fut:115)."""
    v = jnp.asarray(v)
    n = v.shape[0]
    return CSR(
        data=v,
        indices=jnp.arange(n, dtype=INDEX_DTYPE),
        indptr=jnp.arange(n + 1, dtype=INDEX_DTYPE),
        shape=(n, n),
    )


def csr_from_coo(a: COO) -> CSR:
    """Build CSR from (possibly unsorted, duplicated) COO: sort + sum
    duplicates + compress (reference ``sparse``, compressed.fut:154-160).
    jit-compatible; capacity = input capacity."""
    n, m = a.shape
    a = coo_normalize(a)
    nse = a.nse
    valid = a.row < n
    counts = segment_sum(valid.astype(INDEX_DTYPE), a.row, n)
    indptr = cumsum_exclusive(counts)
    indices = jnp.where(valid, a.col, 0).astype(INDEX_DTYPE)
    return CSR(data=a.data, indices=indices, indptr=indptr, shape=(n, m))


def csr_from_triples(n: int, m: int, triples, dtype=None) -> CSR:
    """Eager construction from python triples with host-side bounds checks
    (reference README.md:16-18 usage: ``sparse 2 3 [(0,0,2),(1,2,3)]``)."""
    return csr_from_coo(coo_from_triples(n, m, triples, dtype=dtype))


def csr_from_dense(x: jax.Array, nse: int | None = None) -> CSR:
    return csr_from_coo(coo_from_dense(x, nse=nse))


# -- conversions ---------------------------------------------------------------


def csr_to_coo(a: CSR) -> COO:
    """Recover COO triples (reference ``coo``, compressed.fut:166-177)."""
    n, m = a.shape
    rows = row_ids_from_indptr(a.indptr, a.nse)
    valid = rows < n
    cols = jnp.where(valid, a.indices, jnp.asarray(m, INDEX_DTYPE))
    return COO(row=rows, col=cols, data=a.data, shape=(n, m))


def csr_todense(a: CSR) -> jax.Array:
    """Dense conversion (reference ``dense``, compressed.fut:122-132)."""
    return coo_todense(csr_to_coo(a))


# -- core ops -------------------------------------------------------------------


def csr_smvm(a: CSR, v: jax.Array) -> jax.Array:
    """Sparse matrix-vector multiply: gather + segment-sum.

    XLA reference path for the reference's ``smvm``
    (``expand_outer_reduce``-based, compressed.fut:134-146).  The row-binned
    path in ``sparse_tpu.ops.spmv`` (``smvm_prepare``) is the production
    path; this one is the semantic baseline and the small-size fallback.
    """
    n, m = a.shape
    v = jnp.asarray(v)
    if v.shape != (m,):
        raise ValueError(f"smvm: vector shape {v.shape} != ({m},)")
    if a.nse == 0 or m == 0:
        return jnp.zeros((n,), jnp.result_type(a.dtype, v.dtype))
    rows = row_ids_from_indptr(a.indptr, a.nse)
    prods = a.data * v[a.indices]
    return segment_sum(prods, rows, n, indices_are_sorted=True)


def csr_scale(v, a: CSR) -> CSR:
    """Scale all elements (reference ``scale``, compressed.fut:148-152)."""
    return dataclasses.replace(a, data=a.data * v)


def csr_add(a: CSR, b: CSR) -> CSR:
    """Element-wise add by COO concatenation + rebuild: duplicate summation
    performs the addition (reference ``+``, compressed.fut:179-180).
    Capacity of the result = nse(a) + nse(b)."""
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {a.shape} vs {b.shape}")
    return csr_from_coo(coo_concatenate(csr_to_coo(a), csr_to_coo(b)))


def csr_sub(a: CSR, b: CSR) -> CSR:
    """Element-wise subtract (reference ``-``, compressed.fut:182-183)."""
    return csr_add(a, csr_scale(jnp.asarray(-1, b.dtype), b))


def csr_diagonal(a: CSR) -> jax.Array:
    """Extract the main diagonal as a dense vector (stored zeros included;
    absent entries are 0).  Basis for Jacobi preconditioning."""
    n, m = a.shape
    k = min(n, m)
    if a.nse == 0 or k == 0:
        return jnp.zeros((k,), a.dtype)
    rows = row_ids_from_indptr(a.indptr, a.nse)
    on_diag = (rows < n) & (a.indices == rows)
    contrib = jnp.where(on_diag, a.data, jnp.zeros((), a.dtype))
    return segment_sum(contrib, rows, n, indices_are_sorted=True)[:k]


def csr_nnz(a: CSR) -> jax.Array:
    """Number of stored values that are non-zero (compressed.fut:162-164)."""
    n, _ = a.shape
    rows = row_ids_from_indptr(a.indptr, a.nse)
    return jnp.sum((rows < n) & (a.data != 0)).astype(INDEX_DTYPE)


def csr_compact(a: CSR) -> CSR:
    """Eager: trim capacity to the exact valid entry count (host sync)."""
    k = int(a.indptr[-1])
    return CSR(
        data=a.data[:k], indices=a.indices[:k], indptr=a.indptr, shape=a.shape
    )


# -- CSC: delegation through the transpose duality ----------------------------
# (reference compressed.fut:189-227: every sc op delegates to sr with swapped
# dimensions)


def csc_empty(n: int, m: int, nse: int = 0, dtype=jnp.float32) -> CSC:
    return csr_transpose(csr_empty(m, n, nse, dtype))


def csc_eye(n: int, m: int, dtype=jnp.float32) -> CSC:
    return csr_transpose(csr_eye(m, n, dtype))


def csc_diag(v: jax.Array) -> CSC:
    return csr_transpose(csr_diag(v))


def csc_from_coo(a: COO) -> CSC:
    return csr_transpose(csr_from_coo(coo_transpose(a)))


def csc_from_triples(n: int, m: int, triples, dtype=None) -> CSC:
    swapped = [(c, r, v) for (r, c, v) in triples]
    return csr_transpose(csr_from_triples(m, n, swapped, dtype=dtype))


def csc_from_dense(x: jax.Array, nse: int | None = None) -> CSC:
    return csr_transpose(csr_from_dense(jnp.asarray(x).T, nse=nse))


def csc_to_coo(a: CSC) -> COO:
    return coo_transpose(csr_to_coo(_csc_as_csr_t(a)))


def csc_todense(a: CSC) -> jax.Array:
    return csr_todense(_csc_as_csr_t(a)).T


def csc_vsmm(v: jax.Array, a: CSC) -> jax.Array:
    """Vector-matrix multiply v . A (reference ``vsmm``, compressed.fut:223)."""
    return csr_smvm(_csc_as_csr_t(a), v)


def csc_scale(v, a: CSC) -> CSC:
    return dataclasses.replace(a, data=a.data * v)


def csc_add(a: CSC, b: CSC) -> CSC:
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {a.shape} vs {b.shape}")
    return csr_transpose(csr_add(_csc_as_csr_t(a), _csc_as_csr_t(b)))


def csc_sub(a: CSC, b: CSC) -> CSC:
    return csc_add(a, csc_scale(jnp.asarray(-1, b.dtype), b))


def csc_nnz(a: CSC) -> jax.Array:
    return csr_nnz(_csc_as_csr_t(a))

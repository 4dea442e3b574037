"""Mono sparse matrices: at most one stored element per row (MSR) or per
column (MSC).

A re-design of the reference's ``mk_mono`` functor (mono.fut:63-209).
The representation is *regular* (capacity = n, one slot per row), so unlike
CSR there is no padding protocol: empty rows hold ``(col 0, val 0)``
(mono.fut:119-129).  MSR SpMV is a pure gather-multiply (one FMA per row, no
reduction) -- the cheapest possible sparse format on a vector unit.

MSC delegates every op to MSR with swapped dimensions through the O(1)
transpose duality (mono.fut:166-204).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.segmented import INDEX_DTYPE, segment_sum
from .coo import COO, coo_from_triples, coo_normalize

__all__ = [
    "MSR",
    "MSC",
    "msr_empty",
    "msr_eye",
    "msr_diag",
    "msr_from_coo",
    "msr_from_triples",
    "msr_todense",
    "msr_to_coo",
    "msr_scale",
    "msr_add",
    "msr_sub",
    "msr_nnz",
    "msr_smvm",
    "msr_vsmm",
    "msr_dmsmm",
    "msr_transpose",
    "msc_empty",
    "msc_eye",
    "msc_diag",
    "msc_from_coo",
    "msc_from_triples",
    "msc_todense",
    "msc_to_coo",
    "msc_scale",
    "msc_add",
    "msc_sub",
    "msc_nnz",
    "msc_vsmm",
    "msc_transpose",
]


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["col_idx", "vals"],
    meta_fields=["shape"],
)
@dataclasses.dataclass(frozen=True)
class MSR:
    """Mono sparse row matrix: row i stores value ``vals[i]`` at column
    ``col_idx[i]`` (reference mono.fut:95)."""

    col_idx: jax.Array  # [n]
    vals: jax.Array  # [n]
    shape: tuple[int, int]

    @property
    def dtype(self):
        return self.vals.dtype

    def todense(self):
        return msr_todense(self)

    def nnz(self):
        return msr_nnz(self)

    @property
    def T(self) -> "MSC":
        return msr_transpose(self)

    def __add__(self, o):
        return msr_add(self, o)

    def __sub__(self, o):
        return msr_sub(self, o)

    def __mul__(self, v):
        return msr_scale(v, self)

    __rmul__ = __mul__

    def __matmul__(self, v):
        v = jnp.asarray(v)
        if v.ndim == 1:
            return msr_smvm(self, v)
        return NotImplemented

    def __rmatmul__(self, d):
        d = jnp.asarray(d)
        if d.ndim == 1:
            return msr_vsmm(d, self)
        if d.ndim == 2:
            return msr_dmsmm(d, self)
        return NotImplemented


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["col_idx", "vals"],
    meta_fields=["shape"],
)
@dataclasses.dataclass(frozen=True)
class MSC:
    """Mono sparse column matrix of logical shape (n, m): the arrays are an
    MSR of the transpose (reference mono.fut:203)."""

    col_idx: jax.Array  # [m] row index per column
    vals: jax.Array  # [m]
    shape: tuple[int, int]

    @property
    def dtype(self):
        return self.vals.dtype

    def todense(self):
        return msc_todense(self)

    def nnz(self):
        return msc_nnz(self)

    @property
    def T(self) -> "MSR":
        return msc_transpose(self)

    def __add__(self, o):
        return msc_add(self, o)

    def __sub__(self, o):
        return msc_sub(self, o)

    def __mul__(self, v):
        return msc_scale(v, self)

    __rmul__ = __mul__

    def __rmatmul__(self, v):
        v = jnp.asarray(v)
        if v.ndim == 1:
            return msc_vsmm(v, self)
        return NotImplemented


def _msc_as_msr_t(a: MSC) -> MSR:
    n, m = a.shape
    return MSR(col_idx=a.col_idx, vals=a.vals, shape=(m, n))


# -- constructors --------------------------------------------------------------


def msr_empty(n: int, m: int, dtype=jnp.float32) -> MSR:
    """Zero matrix (mono.fut:97-100)."""
    return MSR(
        col_idx=jnp.zeros((n,), INDEX_DTYPE),
        vals=jnp.zeros((n,), dtype),
        shape=(n, m),
    )


def msr_eye(n: int, m: int, dtype=jnp.float32) -> MSR:
    """Identity (mono.fut:102-105).  Note the reference stores a 1 in *every*
    row's slot with ``col_idx = iota n`` even when n > m; those columns would
    be out of range, so (matching the dense result, not the raw
    representation) we zero rows past min(n, m)."""
    e = min(n, m)
    rows = jnp.arange(n, dtype=INDEX_DTYPE)
    return MSR(
        col_idx=jnp.where(rows < e, rows, 0),
        vals=jnp.where(rows < e, jnp.ones((), dtype), jnp.zeros((), dtype)),
        shape=(n, m),
    )


def msr_diag(v: jax.Array) -> MSR:
    v = jnp.asarray(v)
    n = v.shape[0]
    return MSR(col_idx=jnp.arange(n, dtype=INDEX_DTYPE), vals=v, shape=(n, n))


def msr_from_coo(a: COO) -> MSR:
    """Build from COO; duplicates at identical (r, c) sum; a row with two
    distinct stored columns violates the mono invariant (the reference
    asserts, mono.fut:122-125).  jit path: the *last* normalized entry of a
    violating row wins; use :func:`msr_from_triples` for checked eager
    construction."""
    n, m = a.shape
    a = coo_normalize(a)
    valid = a.row < n
    tgt = jnp.where(valid, a.row, n)
    col_idx = jnp.zeros((n,), INDEX_DTYPE).at[tgt].set(a.col, mode="drop")
    vals = jnp.zeros((n,), a.dtype).at[tgt].set(a.data, mode="drop")
    return MSR(col_idx=col_idx, vals=vals, shape=(n, m))


def msr_from_triples(n: int, m: int, triples, dtype=None) -> MSR:
    triples = list(triples)
    coo = coo_from_triples(n, m, triples, dtype=dtype)
    rows = np.asarray(coo.row)
    cols = np.asarray(coo.col)
    # after duplicate-merge, each row may appear at most once (mono.fut:122-125)
    uniq = {(int(r), int(c)) for r, c in zip(rows, cols)}
    row_counts = {}
    for r, _ in uniq:
        row_counts[r] = row_counts.get(r, 0) + 1
    if any(v > 1 for v in row_counts.values()):
        raise ValueError("mono row matrix: more than one stored element in a row")
    return msr_from_coo(coo)


# -- conversions ----------------------------------------------------------------


def msr_todense(a: MSR) -> jax.Array:
    n, m = a.shape
    out = jnp.zeros((n, m), a.dtype)
    if n == 0 or m == 0:
        return out
    return out.at[jnp.arange(n), a.col_idx].set(a.vals, mode="drop")


def msr_to_coo(a: MSR) -> COO:
    """Stored-and-nonzero entries as COO (mono.fut:135-137 filters zeros).
    Zero slots become padding sentinels."""
    n, m = a.shape
    nonzero = a.vals != 0
    return COO(
        row=jnp.where(nonzero, jnp.arange(n, dtype=INDEX_DTYPE), n),
        col=jnp.where(nonzero, a.col_idx, m),
        data=jnp.where(nonzero, a.vals, jnp.zeros((), a.dtype)),
        shape=(n, m),
    )


# -- ops --------------------------------------------------------------------------


def msr_scale(v, a: MSR) -> MSR:
    return dataclasses.replace(a, vals=a.vals * v)


# When True, the structure equality check is also emitted as a traced
# ``checkify.check`` so jit users can functionalize it (wrap the caller in
# ``jax.experimental.checkify.checkify``) instead of it silently no-opping
# under tracing.  Toggle via :func:`debug_checks`.
_DEBUG_CHECKS = False


def debug_checks(enable: bool = True) -> None:
    """Enable/disable traced invariant checks on mono add/sub (SURVEY.md
    §5.3 debug mode).  With checks enabled, wrap jitted callers in
    ``checkify.checkify`` to surface violations; eager callers get a plain
    exception either way."""
    global _DEBUG_CHECKS
    _DEBUG_CHECKS = enable


def _check_same_structure(a: MSR, b: MSR):
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {a.shape} vs {b.shape}")
    ca, cb = a.col_idx, b.col_idx
    try:
        same = bool(np.array_equal(np.asarray(ca), np.asarray(cb)))
    except Exception:
        # traced: the concrete check is unavailable.  In debug mode emit a
        # functionalized check (reference hard-asserts this, mono.fut:141);
        # otherwise the caller owns the invariant (documented).
        if _DEBUG_CHECKS:
            from jax.experimental import checkify

            checkify.check(
                jnp.all(ca == cb),
                "mono add/sub requires identical stored structure "
                "(mono.fut:141)",
            )
        return
    if not same:
        raise ValueError(
            "mono add/sub requires identical stored structure (mono.fut:141)"
        )


def msr_add(a: MSR, b: MSR) -> MSR:
    """Element-wise add; requires identical col_idx (mono.fut:139-143)."""
    _check_same_structure(a, b)
    return dataclasses.replace(a, vals=a.vals + b.vals)


def msr_sub(a: MSR, b: MSR) -> MSR:
    _check_same_structure(a, b)
    return dataclasses.replace(a, vals=a.vals - b.vals)


def msr_nnz(a: MSR) -> jax.Array:
    return jnp.sum(a.vals != 0).astype(INDEX_DTYPE)


def msr_transpose(a: MSR) -> MSC:
    n, m = a.shape
    return MSC(col_idx=a.col_idx, vals=a.vals, shape=(m, n))


def msr_smvm(a: MSR, v: jax.Array) -> jax.Array:
    """y[i] = vals[i] * v[col_idx[i]]: one gather + one multiply per row
    (mono.fut:154-155).  Perfectly vectorizes on the VPU."""
    n, m = a.shape
    v = jnp.asarray(v)
    if v.shape != (m,):
        raise ValueError(f"smvm: vector shape {v.shape} != ({m},)")
    if n == 0 or m == 0:
        return jnp.zeros((n,), jnp.result_type(a.dtype, v.dtype))
    return a.vals * v[a.col_idx]


def msr_vsmm(v: jax.Array, a: MSR) -> jax.Array:
    """y[c] = sum over rows i with col_idx[i]==c of v[i]*vals[i]: scatter-add
    (mono.fut:157-159)."""
    n, m = a.shape
    v = jnp.asarray(v)
    if v.shape != (n,):
        raise ValueError(f"vsmm: vector shape {v.shape} != ({n},)")
    return segment_sum(v * a.vals, a.col_idx, m)


def msr_dmsmm(d: jax.Array, a: MSR) -> jax.Array:
    """C[i, c] = sum_k D[i, k] * S[k, c] for mono S: batched vsmm
    (mono.fut:161-162), realized as one segment-sum over columns."""
    d = jnp.asarray(d)
    k, m = a.shape
    if d.ndim != 2 or d.shape[1] != k:
        raise ValueError(f"dmsmm: dense shape {d.shape} != (n, {k})")
    prods = d * a.vals[None, :]  # (n, k)
    return segment_sum(prods.T, a.col_idx, m).T


# -- MSC delegation (mono.fut:166-204) -------------------------------------------


def msc_empty(n: int, m: int, dtype=jnp.float32) -> MSC:
    return msr_transpose(msr_empty(m, n, dtype))


def msc_eye(n: int, m: int, dtype=jnp.float32) -> MSC:
    return msr_transpose(msr_eye(m, n, dtype))


def msc_diag(v: jax.Array) -> MSC:
    return msr_transpose(msr_diag(v))


def msc_from_coo(a: COO) -> MSC:
    from .coo import coo_transpose

    return msr_transpose(msr_from_coo(coo_transpose(a)))


def msc_from_triples(n: int, m: int, triples, dtype=None) -> MSC:
    swapped = [(c, r, v) for (r, c, v) in triples]
    return msr_transpose(msr_from_triples(m, n, swapped, dtype=dtype))


def msc_todense(a: MSC) -> jax.Array:
    return msr_todense(_msc_as_msr_t(a)).T


def msc_to_coo(a: MSC) -> COO:
    from .coo import coo_transpose

    return coo_transpose(msr_to_coo(_msc_as_msr_t(a)))


def msc_scale(v, a: MSC) -> MSC:
    return dataclasses.replace(a, vals=a.vals * v)


def msc_add(a: MSC, b: MSC) -> MSC:
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {a.shape} vs {b.shape}")
    return msr_transpose(msr_add(_msc_as_msr_t(a), _msc_as_msr_t(b)))


def msc_sub(a: MSC, b: MSC) -> MSC:
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {a.shape} vs {b.shape}")
    return msr_transpose(msr_sub(_msc_as_msr_t(a), _msc_as_msr_t(b)))


def msc_nnz(a: MSC) -> jax.Array:
    return msr_nnz(_msc_as_msr_t(a))


def msc_transpose(a: MSC) -> MSR:
    n, m = a.shape
    return MSR(col_idx=a.col_idx, vals=a.vals, shape=(m, n))


def msc_vsmm(v: jax.Array, a: MSC) -> jax.Array:
    """v . A for MSC A = smvm of the underlying transpose (mono.fut:200-201)."""
    return msr_smvm(_msc_as_msr_t(a), v)

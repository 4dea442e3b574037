"""Packed trapezoidal matrices (lower/upper, possibly non-square).

A re-design of the reference's ``mk_trapezoidal`` functor
(trapezoidal.fut:220-235).  An ``n x m`` lower trapezoidal matrix (zero above
the diagonal) stores its possibly-nonzero elements packed row-major:

* the leading ``k = min(n, m)`` rows form a triangle (``k(k+1)/2`` slots),
* for tall matrices (``n > m``) the remaining ``n - m`` rows are full width
  ``m``,

total ``k(k+1)/2 + k * max(n-m, 0)`` slots (reference ``elements_lower``,
trapezoidal.fut:64-66).  An *upper* trapezoidal ``n x m`` matrix is stored as
the lower packing of its ``m x n`` transpose (reference ``rank_upper``,
trapezoidal.fut:175-184), making ``transpose`` O(1) — flip the flag
(trapezoidal.fut:224-231).

As with the triangular format, ``smm`` departs from the reference's
``expand_outer_reduce`` of packed gathers (trapezoidal.fut:133-145): we
densify, run one dense matmul, and re-pack.  Exact — the product of two lower
(upper) trapezoids is a lower (upper) trapezoid.  Above ``_TRAP_DENSE_MAX``
on any dimension, a blocked kernel multiplies (B, B) tiles gathered straight
from packed storage instead, so peak memory stays at packed size (the same
large-``n`` treatment ``tri_smm`` gets).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.segmented import INDEX_DTYPE
from .triangular import _unrank_rows
from ..utils.precision import matmul_precision

__all__ = [
    "Trapezoidal",
    "trap_elements",
    "trap_zero",
    "trap_eye",
    "trap_diag",
    "trap_from_dense",
    "trap_todense",
    "trap_idx",
    "trap_scale",
    "trap_add",
    "trap_sub",
    "trap_map",
    "trap_nnz",
    "trap_smm",
    "trap_transpose",
]


def trap_elements(n: int, m: int) -> int:
    """Packed size of an n x m lower trapezoid (reference ``elements_lower``,
    trapezoidal.fut:64-66)."""
    k = min(n, m)
    return k * (k + 1) // 2 + k * max(n - m, 0)


def _packed_coords(n: int, m: int) -> tuple[jax.Array, jax.Array]:
    """(rows, cols) of every packed slot of a lower n x m trapezoid, row-major
    (vectorized form of the reference decoders, trapezoidal.fut:74-87)."""
    k = min(n, m)
    e = k * (k + 1) // 2
    P = trap_elements(n, m)
    p = jnp.arange(P, dtype=INDEX_DTYPE)
    tri_rows = _unrank_rows(p)
    in_tri = p < e
    rows = jnp.where(in_tri, tri_rows, k + jnp.where(m > 0, (p - e) // max(m, 1), 0))
    cols = jnp.where(in_tri, p - tri_rows * (tri_rows + 1) // 2,
                     jnp.where(m > 0, (p - e) % max(m, 1), 0))
    return rows, cols


def _rank(n: int, m: int, i: jax.Array, j: jax.Array) -> jax.Array:
    """Packed slot of logical (i, j), i >= j assumed (reference ``rank_lower``,
    trapezoidal.fut:163-165)."""
    k = min(n, m)
    e = k * (k + 1) // 2
    return jnp.where(i < k, i * (i + 1) // 2 + j, e + (i - k) * m + j)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["data"],
    meta_fields=["n", "m", "lower"],
)
@dataclasses.dataclass(frozen=True)
class Trapezoidal:
    """Packed n x m trapezoidal matrix.

    ``lower=True``: ``data`` is the row-major lower packing of the matrix.
    ``lower=False`` (upper): ``data`` is the row-major lower packing of the
    ``m x n`` transpose.
    """

    data: jax.Array
    n: int
    m: int
    lower: bool

    @property
    def shape(self) -> tuple[int, int]:
        return (self.n, self.m)

    @property
    def dtype(self):
        return self.data.dtype

    def __add__(self, other: "Trapezoidal") -> "Trapezoidal":
        return trap_add(self, other)

    def __sub__(self, other: "Trapezoidal") -> "Trapezoidal":
        return trap_sub(self, other)

    def __mul__(self, v) -> "Trapezoidal":
        return trap_scale(v, self)

    __rmul__ = __mul__

    def __matmul__(self, other: "Trapezoidal") -> "Trapezoidal":
        return trap_smm(self, other)

    @property
    def T(self) -> "Trapezoidal":
        return trap_transpose(self)

    def todense(self) -> jax.Array:
        return trap_todense(self)

    def nnz(self) -> jax.Array:
        return trap_nnz(self)


def _storage_dims(n: int, m: int, lower: bool) -> tuple[int, int]:
    """Dims of the lower-packed storage: (n, m) for lower, (m, n) for upper."""
    return (n, m) if lower else (m, n)


# -- constructors -------------------------------------------------------------


def trap_zero(n: int, m: int, *, lower: bool = True, dtype=jnp.float32) -> Trapezoidal:
    """All-zero trapezoid (reference ``zero``, trapezoidal.fut:118-121)."""
    sn, sm = _storage_dims(n, m, lower)
    return Trapezoidal(
        data=jnp.zeros((trap_elements(sn, sm),), dtype), n=n, m=m, lower=lower
    )


def trap_eye(n: int, m: int, *, lower: bool = True, dtype=jnp.float32) -> Trapezoidal:
    """Ones on the diagonal (reference ``eye``, trapezoidal.fut:123-124)."""
    sn, sm = _storage_dims(n, m, lower)
    rows, cols = _packed_coords(sn, sm)
    return Trapezoidal(data=(rows == cols).astype(dtype), n=n, m=m, lower=lower)


def trap_diag(v: jax.Array, *, lower: bool = True) -> Trapezoidal:
    """Square diagonal matrix (reference ``diag``, trapezoidal.fut:126-128)."""
    v = jnp.asarray(v)
    n = v.shape[0]
    i = jnp.arange(n, dtype=INDEX_DTYPE)
    data = jnp.zeros((trap_elements(n, n),), v.dtype).at[_rank(n, n, i, i)].set(v)
    return Trapezoidal(data=data, n=n, m=n, lower=lower)


def trap_from_dense(x: jax.Array, *, lower: bool = True) -> Trapezoidal:
    """Pack the trapezoidal part of a dense matrix, ignoring the zero side
    (reference ``trapezoidal``, trapezoidal.fut:108-113)."""
    x = jnp.asarray(x)
    n, m = x.shape
    src = x if lower else x.T
    rows, cols = _packed_coords(*src.shape)
    return Trapezoidal(data=src[rows, cols], n=n, m=m, lower=lower)


# -- conversions ---------------------------------------------------------------


def trap_todense(a: Trapezoidal) -> jax.Array:
    """Unpack to dense (reference ``dense``, trapezoidal.fut:115-116)."""
    sn, sm = _storage_dims(a.n, a.m, a.lower)
    rows, cols = _packed_coords(sn, sm)
    out = jnp.zeros((sn, sm), a.dtype).at[rows, cols].set(a.data)
    return out if a.lower else out.T


def trap_idx(a: Trapezoidal, i, j) -> jax.Array:
    """Element at logical (i, j); zero on the zero side (reference ``idx``,
    trapezoidal.fut:105-106).  jit-compatible."""
    i = jnp.asarray(i, INDEX_DTYPE)
    j = jnp.asarray(j, INDEX_DTYPE)
    if not a.lower:
        i, j = j, i
    sn, sm = _storage_dims(a.n, a.m, a.lower)
    on_zero_side = j > i
    p = _rank(sn, sm, i, jnp.minimum(j, i))
    p = jnp.clip(p, 0, max(trap_elements(sn, sm) - 1, 0))
    if a.data.shape[0] == 0:
        return jnp.zeros((), a.dtype)
    return jnp.where(on_zero_side, jnp.zeros((), a.dtype), a.data[p])


# -- elementwise ops -----------------------------------------------------------


def trap_scale(v, a: Trapezoidal) -> Trapezoidal:
    """Reference ``scale``, trapezoidal.fut:130-131."""
    return dataclasses.replace(a, data=a.data * v)


def trap_add(a: Trapezoidal, b: Trapezoidal) -> Trapezoidal:
    """Element-wise addition (reference ``+``, trapezoidal.fut:147-150)."""
    _check_same(a, b, "add")
    return dataclasses.replace(a, data=a.data + b.data)


def trap_sub(a: Trapezoidal, b: Trapezoidal) -> Trapezoidal:
    """Element-wise subtraction (reference ``-``, trapezoidal.fut:152)."""
    _check_same(a, b, "sub")
    return dataclasses.replace(a, data=a.data - b.data)


def trap_map(f, a: Trapezoidal) -> Trapezoidal:
    """Map over stored elements (reference ``map``, trapezoidal.fut:158-159)."""
    return dataclasses.replace(a, data=f(a.data))


def trap_nnz(a: Trapezoidal) -> jax.Array:
    """Non-zero stored values (reference ``nnz``, trapezoidal.fut:154-156)."""
    return jnp.sum(a.data != 0).astype(INDEX_DTYPE)


def _check_same(a: Trapezoidal, b: Trapezoidal, op: str) -> None:
    if a.shape != b.shape:
        raise ValueError(f"trap_{op}: shape mismatch {a.shape} vs {b.shape}")
    if a.lower != b.lower:
        raise ValueError(f"trap_{op}: cannot mix lower and upper trapezoids")


# -- matmul --------------------------------------------------------------------


# same size policy as tri_smm (triangular.py): below the threshold one dense
# matmul wins outright; above it the blocked packed path keeps the packed
# format's memory edge.  The int32 cap bounds every packed index computed in
# the blocked kernel.
_TRAP_DENSE_MAX = 4096
_TRAP_BLOCK = 512


def _trap_block(data: jax.Array, n: int, m: int, bi, bj, B: int,
                out_dtype) -> jax.Array:
    """(B, B) dense block (rows bi*B.., cols bj*B..) of a lower-packed
    (n, m) trapezoid: one row-granule gather + region mask."""
    k = min(n, m)
    e = k * (k + 1) // 2
    r = bi * B + jnp.arange(B, dtype=INDEX_DTYPE)
    c = bj * B + jnp.arange(B, dtype=INDEX_DTYPE)
    off = jnp.where(r < k, r * (r + 1) // 2, e + (jnp.maximum(r, k) - k) * m)
    idx = off[:, None] + c[None, :]
    valid = (c[None, :] <= r[:, None]) & (c[None, :] < m) & (r[:, None] < n)
    vals = data[jnp.minimum(idx, data.shape[0] - 1)].astype(out_dtype)
    return jnp.where(valid, vals, jnp.zeros((), out_dtype))


def _trap_smm_blocked(ad: jax.Array, bd: jax.Array, n: int, m: int, k: int,
                      out_dtype, B: int) -> jax.Array:
    """Lower-packed (n,m) x lower-packed (m,k) -> lower-packed (n,k) without
    densifying: C_ij = sum_{t=j..min(i, mb-1)} A_it @ B_tj over B-sized
    blocks.  Peak memory is the packed output (as block tiles) + O(B^2);
    every multiply is a (B, B) dense matmul."""
    nb, mb, kb = -(-n // B), -(-m // B), -(-k // B)
    kkb = min(nb, kb)
    eb = kkb * (kkb + 1) // 2
    npairs = trap_elements(nb, kb)
    out = jnp.zeros((npairs, B, B), out_dtype)

    def pair_body(p, out):
        p = jnp.asarray(p, INDEX_DTYPE)
        tri_bi = _unrank_rows(p)
        in_tri = p < eb
        bi = jnp.where(in_tri, tri_bi, kkb + (p - eb) // max(kb, 1))
        bj = jnp.where(in_tri, p - tri_bi * (tri_bi + 1) // 2,
                       (p - eb) % max(kb, 1))

        def inner(bt, acc):
            ab = _trap_block(ad, n, m, bi, bt, B, out_dtype)
            bb = _trap_block(bd, m, k, bt, bj, B, out_dtype)
            return acc + jnp.matmul(ab, bb, preferred_element_type=out_dtype,
                                    precision=matmul_precision(out_dtype))

        acc = jax.lax.fori_loop(
            bj, jnp.minimum(bi + 1, mb), inner, jnp.zeros((B, B), out_dtype)
        )
        return out.at[p].set(acc)

    out = jax.lax.fori_loop(0, npairs, pair_body, out)

    # repack: output slot p = (r, c) lives in block pair (r//B, c//B) at
    # in-block offset (r%B, c%B) — one flat gather from the block tiles
    kk = min(n, k)
    e = kk * (kk + 1) // 2
    P = trap_elements(n, k)
    pos = jnp.arange(P, dtype=INDEX_DTYPE)
    tri_r = _unrank_rows(pos)
    in_tri = pos < e
    r = jnp.where(in_tri, tri_r, kk + (pos - e) // max(k, 1))
    c = jnp.where(in_tri, pos - tri_r * (tri_r + 1) // 2,
                  (pos - e) % max(k, 1))
    pr, pc = r // B, c // B
    pb = jnp.where(pr < kkb, pr * (pr + 1) // 2 + pc,
                   eb + (jnp.maximum(pr, kkb) - kkb) * kb + pc)
    flat = pb * (B * B) + (r % B) * B + (c % B)
    return out.reshape(-1)[flat]


def trap_smm(a: Trapezoidal, b: Trapezoidal) -> Trapezoidal:
    """Trapezoid x trapezoid multiply: (n,m) @ (m,k) -> (n,k) (reference
    ``smm``, trapezoidal.fut:133-145; upper duality at :231).

    For small sizes: densify -> dense matmul -> re-pack (exact because
    same-orientation trapezoid products stay trapezoidal).  Above
    ``_TRAP_DENSE_MAX`` on any dimension, a blocked kernel multiplies
    (512, 512) tiles gathered straight from packed storage, so the packed
    format's memory edge survives at scale; both paths are dense matmuls.
    """
    if a.lower != b.lower:
        raise ValueError("trap_smm: cannot mix lower and upper trapezoids")
    if a.m != b.n:
        raise ValueError(f"trap_smm: inner dims {a.shape} @ {b.shape}")
    out_dtype = jnp.result_type(a.dtype, b.dtype)
    n, m, k = a.n, a.m, b.m
    if max(n, m, k) > _TRAP_DENSE_MAX:
        imax = np.iinfo(np.int32).max
        if max(trap_elements(n, m), trap_elements(m, k),
               trap_elements(n, k)) > imax:
            raise ValueError(
                f"trap_smm: packed size of {a.shape} @ {b.shape} exceeds "
                "the int32 packed-index cap"
            )
        if a.lower:
            # both operands already in lower-packed storage with these dims
            data = _trap_smm_blocked(
                a.data.astype(out_dtype), b.data.astype(out_dtype),
                n, m, k, out_dtype, _TRAP_BLOCK,
            )
        else:
            # upper storage is the lower packing of the transpose;
            # (AB)^T = B^T A^T computes the upper product in lower space
            data = _trap_smm_blocked(
                b.data.astype(out_dtype), a.data.astype(out_dtype),
                k, m, n, out_dtype, _TRAP_BLOCK,
            )
        return Trapezoidal(data=data, n=n, m=k, lower=a.lower)
    da = trap_todense(a).astype(out_dtype)
    db = trap_todense(b).astype(out_dtype)
    dc = jnp.matmul(da, db, preferred_element_type=out_dtype,
                    precision=matmul_precision(out_dtype))
    return trap_from_dense(dc, lower=a.lower)


def trap_transpose(a: Trapezoidal) -> Trapezoidal:
    """O(1) transpose: (n,m) lower <-> (m,n) upper, zero data movement
    (reference trapezoidal.fut:224-231)."""
    return Trapezoidal(data=a.data, n=a.m, m=a.n, lower=not a.lower)

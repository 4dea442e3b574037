"""Packed triangular matrices (lower/upper).

A re-design of the reference's ``mk_triangular`` functor
(triangular.fut:195-208).  An ``n x n`` triangular matrix stores exactly the
``n(n+1)/2`` possibly-nonzero elements in a packed 1-D ``data`` vector.

Layout (matches the reference's dual ranking scheme, triangular.fut:138-165):

* A *lower* matrix is packed row-major: ``rank(i, j) = i(i+1)/2 + j``
  (triangular.fut:141-142).
* An *upper* matrix is stored as the packed-lower form of its transpose
  (equivalently: column-major packing, triangular.fut:153-165), so
  ``transpose`` is O(1) — just flip the orientation flag, zero data movement
  (triangular.fut:199, 203).

Departure: the reference computes ``smm`` with a per-output-slot
``expand_outer_reduce`` of packed gathers (triangular.fut:104-112).
``tri_smm`` never does per-element gathers.  For n <= 4096 it densifies
both operands, runs one dense matmul, and re-packs (exact: same-orientation triangle products stay
triangular) — a 2x transient memory cost that is the right trade at sizes
where the dense square still fits comfortably.  Above that,
``_tri_smm_blocked`` multiplies (block, block) tiles sliced straight from
packed storage under a ``fori_loop``, skipping the structurally-zero
k-range per tile pair, so the packed format's 2x memory edge survives at
scale and the hot loop is still dense matmul FLOPs.

All values are pytree dataclasses; every op is jit-compatible (shapes are
static functions of ``n``).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from ..ops.segmented import INDEX_DTYPE
from ..utils.precision import matmul_precision

__all__ = [
    "Triangular",
    "tri_elements",
    "tri_zero",
    "tri_eye",
    "tri_diag",
    "tri_from_dense",
    "tri_todense",
    "tri_idx",
    "tri_scale",
    "tri_add",
    "tri_sub",
    "tri_map",
    "tri_nnz",
    "tri_smm",
    "tri_transpose",
]


def tri_elements(n: int) -> int:
    """Packed size of an n x n triangle (reference ``elements``,
    triangular.fut:58-59)."""
    return (n * (n + 1)) // 2


def _unrank_rows(p: jax.Array) -> jax.Array:
    """Row index of packed position ``p`` in lower row-major packing.

    Closed-form square-root inversion of ``rank`` (the reference uses the same
    trick, triangular.fut:135-136), followed by an exact integer fix-up so the
    result is robust to float rounding at large ``p``.
    """
    pf = p.astype(jnp.float32)
    r = jnp.floor((jnp.sqrt(8.0 * pf + 1.0) - 1.0) / 2.0).astype(INDEX_DTYPE)
    # exact correction: r is the unique integer with r(r+1)/2 <= p < (r+1)(r+2)/2
    r = jnp.where((r + 1) * (r + 2) // 2 <= p, r + 1, r)
    r = jnp.where(r * (r + 1) // 2 > p, r - 1, r)
    return r


def _packed_coords(n: int) -> tuple[jax.Array, jax.Array]:
    """(rows, cols) of every packed slot, lower row-major order."""
    P = tri_elements(n)
    p = jnp.arange(P, dtype=INDEX_DTYPE)
    rows = _unrank_rows(p)
    cols = p - rows * (rows + 1) // 2
    return rows, cols


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["data"],
    meta_fields=["n", "lower"],
)
@dataclasses.dataclass(frozen=True)
class Triangular:
    """Packed n x n triangular matrix.

    ``data`` has static length ``n(n+1)/2``.  ``lower=True`` means ``data`` is
    the row-major packing of the matrix itself; ``lower=False`` means it is the
    row-major packing of the *transpose* (i.e. the matrix is upper triangular).
    """

    data: jax.Array
    n: int
    lower: bool

    @property
    def shape(self) -> tuple[int, int]:
        return (self.n, self.n)

    @property
    def dtype(self):
        return self.data.dtype

    # operators -------------------------------------------------------------
    def __add__(self, other: "Triangular") -> "Triangular":
        return tri_add(self, other)

    def __sub__(self, other: "Triangular") -> "Triangular":
        return tri_sub(self, other)

    def __mul__(self, v) -> "Triangular":
        return tri_scale(v, self)

    __rmul__ = __mul__

    def __matmul__(self, other: "Triangular") -> "Triangular":
        return tri_smm(self, other)

    @property
    def T(self) -> "Triangular":
        return tri_transpose(self)

    def todense(self) -> jax.Array:
        return tri_todense(self)

    def nnz(self) -> jax.Array:
        return tri_nnz(self)


# -- constructors -------------------------------------------------------------


def tri_zero(n: int, *, lower: bool = True, dtype=jnp.float32) -> Triangular:
    """All-zero triangle (reference ``zero``, triangular.fut:89-92)."""
    return Triangular(data=jnp.zeros((tri_elements(n),), dtype), n=n, lower=lower)


def tri_eye(n: int, *, lower: bool = True, dtype=jnp.float32) -> Triangular:
    """Identity (reference ``eye``, triangular.fut:94-95)."""
    rows, cols = _packed_coords(n)
    return Triangular(
        data=(rows == cols).astype(dtype), n=n, lower=lower
    )


def tri_diag(v: jax.Array, *, lower: bool = True) -> Triangular:
    """Diagonal matrix (reference ``diag``, triangular.fut:97-99)."""
    v = jnp.asarray(v)
    n = v.shape[0]
    i = jnp.arange(n, dtype=INDEX_DTYPE)
    data = jnp.zeros((tri_elements(n),), v.dtype).at[i * (i + 1) // 2 + i].set(v)
    return Triangular(data=data, n=n, lower=lower)


def tri_from_dense(x: jax.Array, *, lower: bool = True) -> Triangular:
    """Pack the triangular part of a dense matrix, ignoring the zero side
    (reference ``triangular``, triangular.fut:79-84)."""
    x = jnp.asarray(x)
    n, m = x.shape
    if n != m:
        raise ValueError(f"triangular matrices are square; got {x.shape}")
    src = x if lower else x.T
    rows, cols = _packed_coords(n)
    return Triangular(data=src[rows, cols], n=n, lower=lower)


# -- conversions ---------------------------------------------------------------


def tri_todense(a: Triangular) -> jax.Array:
    """Unpack to dense (reference ``dense``, triangular.fut:86-87)."""
    n = a.n
    rows, cols = _packed_coords(n)
    out = jnp.zeros((n, n), a.dtype).at[rows, cols].set(a.data)
    return out if a.lower else out.T


def tri_idx(a: Triangular, i, j) -> jax.Array:
    """Element at logical position (i, j); zero on the zero side
    (reference ``idx``, triangular.fut:76-77).  jit-compatible."""
    i = jnp.asarray(i, INDEX_DTYPE)
    j = jnp.asarray(j, INDEX_DTYPE)
    if not a.lower:
        i, j = j, i
    on_zero_side = j > i
    safe_j = jnp.minimum(j, i)
    p = i * (i + 1) // 2 + safe_j
    p = jnp.clip(p, 0, max(tri_elements(a.n) - 1, 0))
    if a.data.shape[0] == 0:
        return jnp.zeros((), a.dtype)
    return jnp.where(on_zero_side, jnp.zeros((), a.dtype), a.data[p])


# -- elementwise ops -----------------------------------------------------------


def tri_scale(v, a: Triangular) -> Triangular:
    """Scale all elements (reference ``scale``, triangular.fut:101-102)."""
    return dataclasses.replace(a, data=a.data * v)


def tri_add(a: Triangular, b: Triangular) -> Triangular:
    """Element-wise addition (reference ``+``, triangular.fut:114-119)."""
    _check_same(a, b, "add")
    return dataclasses.replace(a, data=a.data + b.data)


def tri_sub(a: Triangular, b: Triangular) -> Triangular:
    """Element-wise subtraction (reference ``-``, triangular.fut:121)."""
    _check_same(a, b, "sub")
    return dataclasses.replace(a, data=a.data - b.data)


def tri_map(f, a: Triangular) -> Triangular:
    """Map a scalar function over stored elements (reference ``map``,
    triangular.fut:127-129).  ``f`` must be vectorized (any jnp op is)."""
    return dataclasses.replace(a, data=f(a.data))


def tri_nnz(a: Triangular) -> jax.Array:
    """Number of stored values that are non-zero (reference ``nnz``,
    triangular.fut:124-125)."""
    return jnp.sum(a.data != 0).astype(INDEX_DTYPE)


def _check_same(a: Triangular, b: Triangular, op: str) -> None:
    if a.n != b.n:
        raise ValueError(f"tri_{op}: size mismatch {a.n} vs {b.n}")
    if a.lower != b.lower:
        raise ValueError(f"tri_{op}: cannot mix lower and upper triangles")


# -- matmul --------------------------------------------------------------------


# below this size, densify -> one dense matmul wins outright (2x transient
# memory, zero bookkeeping); above it the blocked packed path keeps the
# packed format's memory edge.  46340 caps the int32 packed-index math
# (n(n+1)/2 < 2^31), same guard as BSR's flattened block coords.
_TRI_DENSE_MAX = 4096
_TRI_BLOCK = 512
_TRI_N_MAX = 46340


def _tri_block(data: jax.Array, n: int, bi, bj, B: int,
               out_dtype) -> jax.Array:
    """(B, B) dense block (rows bi*B.., cols bj*B..) of a packed-lower
    matrix: one row-granule gather + triangle mask."""
    r = bi * B + jnp.arange(B, dtype=INDEX_DTYPE)
    c = bj * B + jnp.arange(B, dtype=INDEX_DTYPE)
    idx = (r * (r + 1) // 2)[:, None] + c[None, :]
    valid = (c[None, :] <= r[:, None]) & (r[:, None] < n)
    vals = data[jnp.minimum(idx, data.shape[0] - 1)].astype(out_dtype)
    return jnp.where(valid, vals, jnp.zeros((), out_dtype))


def _tri_smm_blocked(ad: jax.Array, bd: jax.Array, n: int, out_dtype,
                     B: int) -> jax.Array:
    """Packed-lower x packed-lower -> packed-lower without densifying:
    C_ij = sum_{k=j..i} A_ik @ B_kj over B-sized blocks.  Peak memory is the
    packed output (as block tiles) + O(B^2), preserving the format's 2x
    edge; every multiply is a (B, B) dense matmul."""
    nb = -(-n // B)
    npairs = nb * (nb + 1) // 2
    out = jnp.zeros((npairs, B, B), out_dtype)

    def pair_body(p, out):
        bi = _unrank_rows(jnp.asarray(p, INDEX_DTYPE))
        bj = p - bi * (bi + 1) // 2

        def inner(bk, acc):
            ab = _tri_block(ad, n, bi, bk, B, out_dtype)
            bb = _tri_block(bd, n, bk, bj, B, out_dtype)
            return acc + jnp.matmul(ab, bb, preferred_element_type=out_dtype,
                                    precision=matmul_precision(out_dtype))

        acc = jax.lax.fori_loop(
            bj, bi + 1, inner, jnp.zeros((B, B), out_dtype)
        )
        return out.at[p].set(acc)

    out = jax.lax.fori_loop(0, npairs, pair_body, out)

    # repack: packed slot p = (r, c) lives in block pair (r//B, c//B) at
    # in-block offset (r%B, c%B) — one flat gather from the block tiles
    P = tri_elements(n)
    pos = jnp.arange(P, dtype=INDEX_DTYPE)
    r = _unrank_rows(pos)
    c = pos - r * (r + 1) // 2
    pr, pc = r // B, c // B
    flat = (
        (pr * (pr + 1) // 2 + pc) * (B * B) + (r % B) * B + (c % B)
    )
    return out.reshape(-1)[flat]


def tri_smm(a: Triangular, b: Triangular) -> Triangular:
    """Triangular x triangular matrix multiply (reference ``smm``,
    triangular.fut:104-112 and the upper-via-transpose duality at :204).

    Algorithm: for n <= 4096, densify -> dense matmul -> re-pack
    (exact: the product of two same-orientation triangles has the same
    orientation).  Larger matrices switch to a blocked packed kernel that
    never materializes the dense square, so the packed format's 2x memory
    edge survives at scale; both paths are dense matmuls.
    """
    _check_same(a, b, "smm")
    out_dtype = jnp.result_type(a.dtype, b.dtype)
    n = a.n
    if n > _TRI_DENSE_MAX:
        if n > _TRI_N_MAX:
            raise ValueError(
                f"tri_smm: n={n} exceeds the int32 packed-index cap "
                f"{_TRI_N_MAX}"
            )
        # upper storage is the packed-lower of the transpose; (AB)^T = B^T A^T
        # means swapping operands computes the upper product in lower space
        ad, bd = (a.data, b.data) if a.lower else (b.data, a.data)
        data = _tri_smm_blocked(
            ad.astype(out_dtype), bd.astype(out_dtype), n, out_dtype,
            _TRI_BLOCK,
        )
        return Triangular(data=data, n=n, lower=a.lower)
    da = tri_todense(a).astype(out_dtype)
    db = tri_todense(b).astype(out_dtype)
    dc = jnp.matmul(da, db, preferred_element_type=out_dtype,
                    precision=matmul_precision(out_dtype))
    return tri_from_dense(dc, lower=a.lower)


def tri_transpose(a: Triangular) -> Triangular:
    """O(1) transpose: lower <-> upper by flipping the orientation flag
    (reference triangular.fut:199, 203)."""
    return dataclasses.replace(a, lower=not a.lower)

"""BSR: blocked square regular sparse matrices.

A re-design of the reference's ``blocked_square_regular`` functor
(blocked_square_regular.fut:156-639): an ``n x n`` matrix stored as a sparse
set of identically-sized dense ``bsz x bsz`` blocks, with ``bsz | n``.

Representation (vs reference type at blocked_square_regular.fut:179-183):

* ``indices``: [nbz] flattened block coordinates ``r * nb + c``
  (``nb = n/bsz`` blocks per dimension), **sorted ascending**, padding slots
  carry the sentinel ``nb*nb``; int32 while ``nb <= 46340`` (the library's
  index width), int64 beyond ("wide" mode — requires jax x64, mirrors the
  f64 support contract);
* ``blocks``: [nbz, bsz, bsz] values; padding blocks are all-zero.

Static capacity ``nbz`` + sentinel padding replaces the reference's
size-lifted arrays, so every op is jit/vmap/shard_map compatible.  Unlike the
reference (whose ``transp`` leaves indices unsorted and whose set ops re-sort
on demand, blocked_square_regular.fut:226-256), we maintain the sorted
invariant everywhere — one ``jax.lax.sort`` per structural op.

All block-level math is batched dense math (``einsum`` over the block axis,
or a flat elementwise formulation for bsz <= 8); reference-style
``bsz=2..4`` and larger blocks both work (tests use both).

The LU solver stack lives in ``sparse_tpu.solve``.
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
    expand,
    segment_sum,
)
from .coo import COO, coo_normalize
from ..utils.precision import matmul_precision

__all__ = [
    "BSR",
    "bsr_make",
    "bsr_zero",
    "bsr_eye",
    "bsr_diag",
    "bsr_from_dense",
    "bsr_todense",
    "bsr_transpose",
    "bsr_add",
    "bsr_sub",
    "bsr_mul",
    "bsr_scale",
    "bsr_smvm",
    "bsr_smsmm",
    "BsrSmsmmPlan",
    "bsr_smsmm_prepare",
    "bsr_smsmm_apply",
    "bsr_nnz",
    "bsr_to_coo",
    "bsr_to_csr",
    "bsr_from_coo",
    "csr_to_bsr",
    "bsr_compact",
]


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["indices", "blocks"],
    meta_fields=["n", "bsz"],
)
@dataclasses.dataclass(frozen=True)
class BSR:
    """Blocked square sparse matrix with static block capacity.

    Invariants: ``indices`` sorted ascending; valid entries are unique
    flattened block coords in ``[0, nb*nb)``; padding entries carry the
    sentinel ``nb*nb`` and all-zero blocks.
    """

    indices: jax.Array
    blocks: jax.Array
    n: int
    bsz: int

    @property
    def shape(self) -> tuple[int, int]:
        return (self.n, self.n)

    @property
    def nb(self) -> int:
        """Blocks per dimension (``n / bsz``)."""
        return self.n // self.bsz

    @property
    def nbz(self) -> int:
        """Stored block capacity."""
        return self.indices.shape[0]

    @property
    def sentinel(self) -> int:
        return self.nb * self.nb

    @property
    def dtype(self):
        return self.blocks.dtype

    def __add__(self, other: "BSR") -> "BSR":
        return bsr_add(self, other)

    def __sub__(self, other: "BSR") -> "BSR":
        return bsr_sub(self, other)

    def __mul__(self, v) -> "BSR":
        if isinstance(v, BSR):
            return bsr_mul(self, v)
        return bsr_scale(v, self)

    def __rmul__(self, v) -> "BSR":
        return bsr_scale(v, self)

    def __matmul__(self, other):
        if isinstance(other, BSR):
            return bsr_smsmm(self, other)
        other = jnp.asarray(other)
        if other.ndim == 1:
            return bsr_smvm(self, other)
        return NotImplemented

    @property
    def T(self) -> "BSR":
        return bsr_transpose(self)

    def todense(self) -> jax.Array:
        return bsr_todense(self)

    def nnz(self) -> jax.Array:
        return bsr_nnz(self)


BSR_MAX_NB = 46340
"""Largest blocks-per-dimension whose flattened coordinates r*nb+c fit
int32 (the library's index width).  Beyond it BSR switches to int64
("wide") indices, which requires jax x64 mode — same contract as f64
element support."""


def _bidx_dtype(nb: int):
    """Index dtype for flattened block coordinates ``r * nb + c``."""
    return INDEX_DTYPE if nb <= BSR_MAX_NB else jnp.int64


def _check_divides(n: int, bsz: int) -> None:
    # mirrors ERROR_block_size_must_divide_n (blocked_square_regular.fut:175,196)
    if n % bsz != 0:
        raise ValueError(f"block size {bsz} must divide n={n}")
    nb = n // bsz
    # wide flattened block coordinates need real int64 on device; without
    # x64 jax silently downcasts to int32 and coordinates would collide
    if nb > BSR_MAX_NB and not jax.config.jax_enable_x64:
        raise ValueError(
            f"{nb} = {n}/{bsz} blocks per dimension exceeds the int32 "
            f"block-coordinate range (46340); wide BSR indices require "
            f"jax x64 mode (jax.config.update('jax_enable_x64', True)), "
            f"or use a larger block size / shard the matrix "
            f"(sparse_tpu.parallel)"
        )


def _rc(a: BSR) -> tuple[jax.Array, jax.Array, jax.Array]:
    """(valid, block_row, block_col) with sentinels: row=nb, col=0 for padding."""
    nb = a.nb
    valid = a.indices < a.sentinel
    r = jnp.where(valid, a.indices // max(nb, 1), nb).astype(INDEX_DTYPE)
    c = jnp.where(valid, a.indices % max(nb, 1), 0).astype(INDEX_DTYPE)
    return valid, r, c


def _merge_blocks(n: int, bsz: int, idxs: jax.Array, blocks: jax.Array) -> BSR:
    """Sort block entries by flattened index, sum duplicates, pack valid
    entries at the front.  The engine behind ``add``/``transpose``/``smsmm``
    accumulation (role of the reference's sorted-set machinery,
    blocked_square_regular.fut:234-256, and its segmented block reduction at
    :349-359).  jit-compatible; capacity preserved."""
    nb = n // bsz
    sentinel = nb * nb
    nbz = idxs.shape[0]
    if nbz == 0:
        return BSR(indices=idxs, blocks=blocks, n=n, bsz=bsz)
    # small blocks reorder/scatter in a FLAT (nbz, bsz^2) layout
    flat = bsz <= 8
    vals = blocks.reshape(nbz, bsz * bsz) if flat else blocks
    order = jnp.argsort(idxs, stable=True)
    idxs = idxs[order]
    vals = vals[order]
    valid = idxs < sentinel
    is_head = jnp.concatenate(
        [jnp.ones((1,), bool), idxs[1:] != idxs[:-1]]
    ) & valid
    group = jnp.cumsum(is_head.astype(INDEX_DTYPE)) - 1
    target = jnp.where(valid, group, nbz)
    out_vals = jnp.zeros_like(vals).at[target].add(vals, mode="drop")
    out_idx = jnp.full((nbz,), sentinel, idxs.dtype).at[
        jnp.where(is_head, group, nbz)
    ].set(idxs, mode="drop")
    # zero any block in padding slots (slots never written stay zero)
    k = jnp.sum(is_head.astype(INDEX_DTYPE))
    pos = jnp.arange(nbz, dtype=INDEX_DTYPE)
    mask = (pos < k)[:, None] if flat else (pos < k)[:, None, None]
    out_vals = jnp.where(mask, out_vals, 0)
    if flat:
        out_vals = out_vals.reshape(nbz, bsz, bsz)
    return BSR(indices=out_idx, blocks=out_vals, n=n, bsz=bsz)


# -- constructors -------------------------------------------------------------


def bsr_zero(n: int, bsz: int, nbz: int = 0, dtype=jnp.float32) -> BSR:
    """Zero matrix with optional pre-allocated block capacity (reference
    ``zero``, blocked_square_regular.fut:189-193)."""
    _check_divides(n, bsz)
    nb = n // bsz
    return BSR(
        indices=jnp.full((nbz,), nb * nb, _bidx_dtype(nb)),
        blocks=jnp.zeros((nbz, bsz, bsz), dtype),
        n=n,
        bsz=bsz,
    )


def bsr_make(n: int, bsz: int, entries, dtype=None) -> BSR:
    """Eager construction from ``[(r, c, block), ...]`` block triples with
    host-side bounds checks (reference ``mk``, blocked_square_regular.fut:
    195-201).  Duplicate coordinates are summed."""
    _check_divides(n, bsz)
    nb = n // bsz
    entries = list(entries)
    if not entries:
        return bsr_zero(n, bsz, 0, dtype or jnp.float32)
    rs = np.asarray([e[0] for e in entries], np.int64)
    cs = np.asarray([e[1] for e in entries], np.int64)
    blks = np.stack([np.asarray(e[2]) for e in entries])
    if dtype is not None:
        blks = blks.astype(dtype)
    if blks.shape[1:] != (bsz, bsz):
        raise ValueError(f"blocks must be {bsz}x{bsz}; got {blks.shape[1:]}")
    if rs.size and (rs.min() < 0 or rs.max() >= nb or cs.min() < 0 or cs.max() >= nb):
        raise ValueError(f"block coordinate out of bounds for {nb}x{nb} blocks")
    idxs = jnp.asarray(rs * nb + cs, _bidx_dtype(nb))
    return _merge_blocks(n, bsz, idxs, jnp.asarray(blks))


def bsr_eye(n: int, bsz: int, dtype=jnp.float32) -> BSR:
    """Identity (reference ``eye``, blocked_square_regular.fut:208-210)."""
    _check_divides(n, bsz)
    nb = n // bsz
    i = jnp.arange(nb, dtype=_bidx_dtype(nb))
    blk = jnp.eye(bsz, dtype=dtype)
    return BSR(
        indices=i * nb + i,
        blocks=jnp.broadcast_to(blk, (nb, bsz, bsz)),
        n=n,
        bsz=bsz,
    )


def bsr_diag(v: jax.Array, bsz: int) -> BSR:
    """Diagonal matrix from a length-n vector (reference ``diag``,
    blocked_square_regular.fut:301-305)."""
    v = jnp.asarray(v)
    n = v.shape[0]
    _check_divides(n, bsz)
    nb = n // bsz
    i = jnp.arange(nb, dtype=_bidx_dtype(nb))
    vb = v.reshape(nb, bsz)
    blocks = vb[:, :, None] * jnp.eye(bsz, dtype=v.dtype)[None]
    return BSR(indices=i * nb + i, blocks=blocks, n=n, bsz=bsz)


def bsr_from_dense(x: jax.Array, bsz: int, nbz: int | None = None) -> BSR:
    """Extract non-zero blocks from a dense matrix.  Eager when ``nbz`` is
    None (concretizes the block count); pass a static capacity for jit."""
    x = jnp.asarray(x)
    n = x.shape[0]
    if x.shape != (n, n):
        raise ValueError(f"BSR matrices are square; got {x.shape}")
    _check_divides(n, bsz)
    nb = n // bsz
    xb = x.reshape(nb, bsz, nb, bsz).transpose(0, 2, 1, 3)  # (nb, nb, bsz, bsz)
    nz = jnp.any(xb != 0, axis=(2, 3)).reshape(-1)
    if nbz is None:
        nbz = int(jnp.sum(nz))  # host sync; eager only
    total = nb * nb
    order = jnp.argsort(~nz, stable=True)
    idx = order[:nbz] if nbz <= total else jnp.concatenate(
        [order, jnp.zeros((nbz - total,), order.dtype)]
    )
    taken_valid = (
        nz[idx]
        if nbz <= total
        else jnp.concatenate([nz[order], jnp.zeros((nbz - total,), bool)])
    )
    idxs = jnp.where(taken_valid, idx.astype(_bidx_dtype(nb)), total)
    blocks = jnp.where(
        taken_valid[:, None, None], xb.reshape(total, bsz, bsz)[idx], 0
    )
    return _merge_blocks(n, bsz, idxs, blocks)


# -- conversions ---------------------------------------------------------------


def bsr_todense(a: BSR) -> jax.Array:
    """Dense conversion (reference ``dense``, blocked_square_regular.fut:
    212-224)."""
    nb, bsz = a.nb, a.bsz
    dense_blocks = jnp.zeros((nb * nb + 1, bsz, bsz), a.dtype).at[a.indices].add(
        a.blocks, mode="drop"
    )[: nb * nb]
    return (
        dense_blocks.reshape(nb, nb, bsz, bsz)
        .transpose(0, 2, 1, 3)
        .reshape(a.n, a.n)
    )


def bsr_transpose(a: BSR) -> BSR:
    """Transpose: swap block coordinates and transpose each block (reference
    ``transp``, blocked_square_regular.fut:226-232); one sort restores the
    sorted-indices invariant the reference defers to consumers."""
    valid, r, c = _rc(a)
    idt = a.indices.dtype
    new_idx = jnp.where(valid, c.astype(idt) * a.nb + r, a.sentinel).astype(idt)
    return _merge_blocks(a.n, a.bsz, new_idx, jnp.swapaxes(a.blocks, 1, 2))


def bsr_to_coo(a: BSR) -> COO:
    """Scalar COO of all stored elements; zero values within blocks are
    marked as padding, matching the reference's filtering ``coo``
    (blocked_square_regular.fut:605-614).  Capacity = nbz * bsz^2."""
    nb, bsz, n = a.nb, a.bsz, a.n
    valid, r, c = _rc(a)
    i_loc = jnp.arange(bsz, dtype=INDEX_DTYPE)
    rows = (r[:, None, None] * bsz + i_loc[None, :, None]).astype(INDEX_DTYPE)
    cols = (c[:, None, None] * bsz + i_loc[None, None, :]).astype(INDEX_DTYPE)
    keep = valid[:, None, None] & (a.blocks != 0)
    rows = jnp.where(keep, rows, n).reshape(-1)
    cols = jnp.where(keep, cols, n).reshape(-1)
    data = jnp.where(keep, a.blocks, 0).reshape(-1)
    return coo_normalize(COO(row=rows, col=cols, data=data, shape=(n, n)))


def bsr_to_csr(a: BSR):
    """Scalar CSR storing EVERY position of every stored block — explicit
    zeros inside blocks stay stored (unlike :func:`bsr_to_coo`, which
    mirrors the reference's filtering ``coo``).

    This is the return bridge of the block-routed SpGEMM dispatch
    (ops/spgemm.py): when both operands have fully-dense stored blocks, the
    block product's stored structure at scalar granularity is exactly the
    reference's ``smsmm`` stored structure (every position of a stored C
    block is a realized product pair), so no filtering may happen here.
    jit-compatible; capacity = nbz * bsz^2."""
    from .csr import csr_from_coo

    nb, bsz, n = a.nb, a.bsz, a.n
    valid, r, c = _rc(a)
    i_loc = jnp.arange(bsz, dtype=INDEX_DTYPE)
    rows = (r[:, None, None] * bsz + i_loc[None, :, None]).astype(INDEX_DTYPE)
    cols = (c[:, None, None] * bsz + i_loc[None, None, :]).astype(INDEX_DTYPE)
    keep = jnp.broadcast_to(valid[:, None, None], a.blocks.shape)
    rows = jnp.where(keep, jnp.broadcast_to(rows, a.blocks.shape), n).reshape(-1)
    cols = jnp.where(keep, jnp.broadcast_to(cols, a.blocks.shape), n).reshape(-1)
    data = jnp.where(keep, a.blocks, 0).reshape(-1)
    return csr_from_coo(COO(row=rows, col=cols, data=data, shape=(n, n)))


def bsr_from_coo(a: COO, bsz: int, nbz: int | None = None) -> BSR:
    """Assemble blocks from scalar COO triples (reference ``from_coo``,
    blocked_square_regular.fut:616-637).  jit-compatible when ``nbz`` (block
    capacity) is given; defaults to one block per COO slot (upper bound)."""
    n, m = a.shape
    if n != m:
        raise ValueError(f"BSR matrices are square; got {a.shape}")
    _check_divides(n, bsz)
    nb = n // bsz
    sentinel = nb * nb
    a = coo_normalize(a)
    nse = a.nse
    if nbz is None:
        nbz = nse
    valid = a.row < n
    idt = _bidx_dtype(nb)
    h = jnp.where(
        valid, (a.row // bsz).astype(idt) * nb + (a.col // bsz), sentinel
    ).astype(idt)
    # group scalar entries by block: sorted h (coo sorted by (r,c) is NOT
    # sorted by block id), so sort by h first
    order = jnp.argsort(h, stable=True)
    h = h[order]
    row_l = jnp.where(valid, a.row % bsz, 0)[order].astype(INDEX_DTYPE)
    col_l = jnp.where(valid, a.col % bsz, 0)[order].astype(INDEX_DTYPE)
    data = a.data[order]
    is_head = jnp.concatenate([jnp.ones((1,), bool), h[1:] != h[:-1]]) & (
        h < sentinel
    )
    group = jnp.cumsum(is_head.astype(INDEX_DTYPE)) - 1
    group = jnp.where(h < sentinel, group, nbz)
    blocks = jnp.zeros((nbz, bsz, bsz), a.dtype).at[group, row_l, col_l].add(
        data, mode="drop"
    )
    idxs = jnp.full((nbz,), sentinel, idt).at[
        jnp.where(is_head, group, nbz)
    ].set(h, mode="drop")
    return BSR(indices=idxs, blocks=blocks, n=n, bsz=bsz)


def csr_to_bsr(a, bsz: int, nbz: int | None = None,
               compact: bool = True) -> BSR:
    """Re-block a scalar CSR matrix into bsz x bsz BSR storage.

    This is the routing bridge onto the block paths: blocked storage moves
    bsz^2-sized granules per gather and multiplies whole blocks instead of
    scalars.  For a matrix whose entries cluster
    (FEM / banded / RCM-reordered), block fill stays high and
    ``bsr_smsmm`` / ``bell_spmm`` run orders of magnitude faster than the
    scalar CSR SpGEMM — at low fill the bsz^2/fill storage blow-up loses;
    check ``utils.stats.matrix_stats`` first.  jit-compatible when ``nbz``
    is given (``compact=False``); eager by default."""
    if nbz is None:
        out = _csr_to_bsr_host(a, bsz)
        if not compact:
            # preserve the documented padded capacity (one slot per scalar
            # SLOT, including the CSR's padding slots — matching the device
            # path's csr_to_coo capacity) for callers that keep filling
            # blocks
            nse = int(a.data.shape[0])
            pad = nse - out.nbz
            if pad > 0:
                out = BSR(
                    indices=jnp.concatenate([
                        out.indices,
                        jnp.full((pad,), out.sentinel, out.indices.dtype),
                    ]),
                    blocks=jnp.concatenate([
                        out.blocks,
                        jnp.zeros((pad, bsz, bsz), out.blocks.dtype),
                    ]),
                    n=out.n,
                    bsz=bsz,
                )
        return out
    from .csr import csr_to_coo

    out = bsr_from_coo(csr_to_coo(a), bsz, nbz=nbz)
    return bsr_compact(out) if compact else out


def _csr_to_bsr_host(a, bsz: int) -> BSR:
    """Eager host-side re-blocking (NumPy): one host assembly + one upload
    instead of an eager device dispatch per normalize/sort/scatter stage.
    Identical structure: CSR entries are unique and
    (row, col)-sorted, so blocks group by a stable argsort of the flattened
    block id."""
    n, m = a.shape
    if n != m:
        raise ValueError(f"BSR matrices are square; got {a.shape}")
    _check_divides(n, bsz)
    nb = n // bsz
    indptr = np.asarray(a.indptr)
    k = int(indptr[-1]) if indptr.size else 0
    if k == 0:
        return bsr_zero(n, bsz, 0, a.dtype)
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))[:k]
    cols = np.asarray(a.indices)[:k].astype(np.int64)
    data = np.asarray(a.data)[:k]
    h = (rows // bsz) * nb + cols // bsz
    from ..native.plansort import argsort_u64

    order = argsort_u64(h.astype(np.uint64))
    h_s = h[order]
    heads = np.ones(k, bool)
    heads[1:] = h_s[1:] != h_s[:-1]
    group = np.cumsum(heads) - 1
    nbz_exact = int(group[-1]) + 1
    blocks = np.zeros((nbz_exact, bsz, bsz), data.dtype)
    blocks[group, (rows[order] % bsz), (cols[order] % bsz)] = data[order]
    return BSR(
        indices=jnp.asarray(h_s[heads], _bidx_dtype(nb)),
        blocks=jnp.asarray(blocks),
        n=n,
        bsz=bsz,
    )


def bsr_compact(a: BSR) -> BSR:
    """Eager: trim capacity to the exact valid block count (host sync)."""
    k = int(jnp.sum(a.indices < a.sentinel))
    return BSR(indices=a.indices[:k], blocks=a.blocks[:k], n=a.n, bsz=a.bsz)


# -- elementwise / structural ops ---------------------------------------------


def bsr_add(a: BSR, b: BSR) -> BSR:
    """Element-wise addition by block-set union (reference ``add``,
    blocked_square_regular.fut:258-275).  Capacity = nbz(a) + nbz(b)."""
    _check_compat(a, b, "add")
    return _merge_blocks(
        a.n,
        a.bsz,
        jnp.concatenate([a.indices, b.indices]),
        jnp.concatenate([a.blocks, b.blocks]),
    )


def bsr_sub(a: BSR, b: BSR) -> BSR:
    """Element-wise subtraction (reference ``sub``,
    blocked_square_regular.fut:277-278)."""
    return bsr_add(a, bsr_scale(jnp.asarray(-1, b.dtype), b))


def bsr_mul(a: BSR, b: BSR) -> BSR:
    """Element-wise (Hadamard) multiplication by block-set intersection
    (reference ``mul``, blocked_square_regular.fut:280-290).  Capacity =
    nbz(a)."""
    _check_compat(a, b, "mul")
    if a.nbz == 0 or b.nbz == 0:
        return bsr_zero(a.n, a.bsz, a.nbz, jnp.result_type(a.dtype, b.dtype))
    pos = jnp.searchsorted(b.indices, a.indices).astype(INDEX_DTYPE)
    pos = jnp.minimum(pos, b.nbz - 1)
    found = (b.indices[pos] == a.indices) & (a.indices < a.sentinel)
    idxs = jnp.where(found, a.indices, a.sentinel).astype(a.indices.dtype)
    blocks = jnp.where(found[:, None, None], a.blocks * b.blocks[pos], 0)
    return _merge_blocks(a.n, a.bsz, idxs, blocks)  # re-pack sentinels


def bsr_scale(v, a: BSR) -> BSR:
    """Scale all elements (reference ``scale``, blocked_square_regular.fut:
    292-296)."""
    return dataclasses.replace(a, blocks=a.blocks * v)


def bsr_nnz(a: BSR) -> jax.Array:
    """Count non-zero scalars inside valid blocks (consistent with the
    reference's zero-filtering ``coo``, blocked_square_regular.fut:614)."""
    valid, _, _ = _rc(a)
    return jnp.sum(jnp.where(valid[:, None, None], a.blocks != 0, False)).astype(
        INDEX_DTYPE
    )


def _check_compat(a: BSR, b: BSR, op: str) -> None:
    if a.n != b.n or a.bsz != b.bsz:
        raise ValueError(
            f"bsr_{op}: incompatible operands n={a.n}/{b.n} bsz={a.bsz}/{b.bsz}"
        )


# -- matmul -------------------------------------------------------------------


def _flat_block_products(fa, fb, bsz: int, out_dtype) -> jax.Array:
    """Batched block products in the FLAT (F, bsz^2) layout:
    ``prods[:, i*bsz+j] = sum_k fa[:, i*bsz+k] * fb[:, k*bsz+j]`` via a
    shared-k outer-product loop of repeat/tile elementwise FMAs.

    Used for bsz <= 8.  The k-sum accumulates in f32 for sub-f32 dtypes —
    matching the einsum's f32 accumulate + single final rounding — and the
    result is cast to ``out_dtype``."""
    acc = (jnp.float32 if jnp.issubdtype(out_dtype, jnp.floating)
           and jnp.finfo(out_dtype).bits < 32 else out_dtype)
    fa = fa.astype(acc)
    fb = fb.astype(acc)
    prods = sum(
        jnp.repeat(fa[:, k::bsz], bsz, axis=1)
        * jnp.tile(fb[:, k * bsz:(k + 1) * bsz], (1, bsz))
        for k in range(bsz)
    )
    return prods.astype(out_dtype)


def bsr_smvm(a: BSR, v: jax.Array) -> jax.Array:
    """Block sparse matrix-vector product: batched block matvec + block-row
    segment-sum (reference ``smvm``, blocked_square_regular.fut:307-331)."""
    v = jnp.asarray(v)
    if v.shape != (a.n,):
        raise ValueError(f"bsr_smvm: vector shape {v.shape} != ({a.n},)")
    out_dtype = jnp.result_type(a.dtype, v.dtype)
    nb, bsz = a.nb, a.bsz
    if a.nbz == 0 or a.n == 0:
        return jnp.zeros((a.n,), out_dtype)
    valid, r, c = _rc(a)
    vb = v.reshape(nb, bsz)[c]  # (nbz, bsz); padding c=0 but block is zero
    w = jnp.einsum("bij,bj->bi", a.blocks, vb,
                   precision=matmul_precision(a.dtype, vb.dtype)).astype(out_dtype)
    return segment_sum(w, r, nb).reshape(a.n)


def bsr_smsmm_core(a: BSR, b: BSR, expansion_nbz: int) -> BSR:
    """jit-compatible block SpGEMM core with static block-product capacity.

    Same ESC formulation as the scalar SpGEMM (ops/spgemm.py) lifted to
    blocks: expand actual block pairs (A block column == B block row), batch
    the bsz^3 products through one einsum, merge by target coordinate.
    Matches the reference ``smsmm`` semantics (blocked_square_regular.fut:
    336-363) with a different (pair-exact rather than intersect-per-pair)
    parallel decomposition.
    """
    _check_compat(a, b, "smsmm")
    n, bsz, nb = a.n, a.bsz, a.nb
    out_dtype = jnp.result_type(a.dtype, b.dtype)
    if expansion_nbz == 0 or a.nbz == 0 or b.nbz == 0:
        return bsr_zero(n, bsz, expansion_nbz, out_dtype)
    valid_a, a_r, a_c = _rc(a)
    valid_b, b_r, b_c = _rc(b)
    b_row_counts = segment_sum(valid_b.astype(INDEX_DTYPE), b_r, nb)
    b_row_ptr = cumsum_exclusive(b_row_counts)
    sizes = jnp.where(valid_a, b_row_counts[jnp.minimum(a_c, nb - 1)], 0).astype(
        INDEX_DTYPE
    )
    elem_ids, inner = expand(sizes, expansion_nbz)
    live = elem_ids < a.nbz
    e = jnp.where(live, elem_ids, 0)
    b_pos = b_row_ptr[jnp.minimum(a_c[e], nb - 1)].astype(INDEX_DTYPE) + inner
    b_pos = jnp.minimum(b_pos, max(b.nbz - 1, 0))
    if bsz <= 8:
        prods = _flat_block_products(
            a.blocks.reshape(a.nbz, -1)[e],
            b.blocks.reshape(b.nbz, -1)[b_pos],
            bsz, out_dtype,
        ).reshape(-1, bsz, bsz)
    else:
        prods = jnp.einsum(
            "fij,fjk->fik", a.blocks[e], b.blocks[b_pos],
            preferred_element_type=out_dtype,
            precision=matmul_precision(a.dtype, b.dtype),
        )
    idt = _bidx_dtype(nb)
    target = jnp.where(
        live & valid_a[e], a_r[e].astype(idt) * nb + b_c[b_pos], nb * nb
    ).astype(idt)
    prods = jnp.where((target < nb * nb)[:, None, None], prods, 0)
    return _merge_blocks(n, bsz, target, prods.astype(out_dtype))


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["a_pos", "b_pos", "seg", "indices"],
    meta_fields=["n", "bsz"],
)
@dataclasses.dataclass(frozen=True)
class BsrSmsmmPlan:
    """Pattern-static block-SpGEMM schedule from :func:`bsr_smsmm_prepare`
    (the block-level mirror of ``ops.spgemm.SpgemmPlan``): per block
    product, the storage positions of both factors and the (pre-sorted)
    output block slot; ``indices`` is the result's sorted block-coordinate
    array (capacity = exact stored block count)."""

    a_pos: jax.Array
    b_pos: jax.Array
    seg: jax.Array
    indices: jax.Array
    n: int
    bsz: int

    @property
    def nbz_out(self) -> int:
        return self.indices.shape[0]

    @property
    def n_products(self) -> int:
        return self.a_pos.shape[0]


def bsr_smsmm_prepare(a: BSR, b: BSR) -> BsrSmsmmPlan:
    """Symbolic block-SpGEMM pass (eager, host-side, once per pattern pair).

    Use with :func:`bsr_smsmm_apply` when the same block patterns multiply
    repeatedly with fresh values — the per-call sort disappears and the
    numeric pass is one batched einsum + a pre-sorted segment-sum."""
    _check_compat(a, b, "smsmm_prepare")
    nb = a.nb
    ai = np.asarray(a.indices).astype(np.int64)
    bi = np.asarray(b.indices).astype(np.int64)
    va = np.flatnonzero(ai < nb * nb)
    vb = np.flatnonzero(bi < nb * nb)
    a_r, a_c = ai[va] // nb, ai[va] % nb
    b_r, b_c = bi[vb] // nb, bi[vb] % nb
    # row-compress B's valid blocks (BSR indices are sorted, so vb is
    # already grouped by b_r)
    b_counts = np.bincount(b_r, minlength=nb)
    b_ptr = np.zeros(nb + 1, np.int64)
    np.cumsum(b_counts, out=b_ptr[1:])
    sizes = b_counts[a_c]
    F = int(sizes.sum())
    starts = np.cumsum(sizes) - sizes
    pa_ = np.repeat(np.arange(va.size, dtype=np.int64), sizes)
    inner = np.arange(F, dtype=np.int64) - starts[pa_]
    pb_ = b_ptr[a_c[pa_]] + inner
    target = a_r[pa_] * nb + b_c[pb_]
    from ..native.plansort import argsort_u64

    order = argsort_u64(target)
    t_o = target[order]
    head = np.ones(F, bool)
    head[1:] = t_o[1:] != t_o[:-1]
    seg = np.cumsum(head) - 1
    return BsrSmsmmPlan(
        a_pos=jnp.asarray(va[pa_[order]], INDEX_DTYPE),
        b_pos=jnp.asarray(vb[pb_[order]], INDEX_DTYPE),
        seg=jnp.asarray(seg, INDEX_DTYPE),
        indices=jnp.asarray(t_o[head] if F else np.zeros(0, np.int64),
                            _bidx_dtype(nb)),
        n=a.n,
        bsz=a.bsz,
    )


@jax.jit
def bsr_smsmm_apply(plan: BsrSmsmmPlan, a: BSR, b: BSR) -> BSR:
    """Numeric block-SpGEMM pass for the pattern pair captured in ``plan``
    (values may change, block structure must not).  jit-compatible,
    sort-free, deterministic.

    Small blocks (bsz <= 8) multiply in a FLAT (F, bsz^2) layout — a
    shared-k outer-product loop of repeat/tile elementwise FMAs; larger
    blocks gather (F, bsz, bsz) operand streams into one batched einsum.
    The gradient is JAX's own (every step is differentiable XLA)."""
    out_dtype = jnp.result_type(a.dtype, b.dtype)
    bsz = plan.bsz
    if plan.n_products == 0:
        blocks = jnp.zeros((plan.nbz_out, bsz, bsz), out_dtype)
    elif bsz <= 8:
        prods = _flat_block_products(
            a.blocks.reshape(a.nbz, -1)[plan.a_pos],
            b.blocks.reshape(b.nbz, -1)[plan.b_pos],
            bsz, out_dtype,
        )
        blocks = segment_sum(
            prods, plan.seg, plan.nbz_out, indices_are_sorted=True,
        ).reshape(-1, bsz, bsz)
    else:
        prods = jnp.einsum(
            "fij,fjk->fik", a.blocks[plan.a_pos], b.blocks[plan.b_pos],
            preferred_element_type=out_dtype,
            precision=matmul_precision(a.dtype, b.dtype),
        )
        blocks = segment_sum(
            prods.astype(out_dtype), plan.seg, plan.nbz_out,
            indices_are_sorted=True,
        )
    return BSR(indices=plan.indices, blocks=blocks, n=plan.n, bsz=bsz)


def bsr_smsmm(a: BSR, b: BSR, *, expansion_nbz: int | None = None,
              compact: bool = True) -> BSR:
    """Block sparse x sparse matmul (reference ``smsmm``,
    blocked_square_regular.fut:336-363).  With ``expansion_nbz=None`` the
    symbolic pair count runs eagerly (host sync); pass a static bound for
    full jit-compatibility."""
    if expansion_nbz is None:
        valid_a, _, a_c = _rc(a)
        valid_b, b_r, _ = _rc(b)
        counts = segment_sum(valid_b.astype(INDEX_DTYPE), b_r, max(a.nb, 1))
        f = int(
            jnp.sum(jnp.where(valid_a, counts[jnp.minimum(a_c, max(a.nb - 1, 0))], 0))
        )
        out = bsr_smsmm_core(a, b, f)
        return bsr_compact(out) if compact else out
    return bsr_smsmm_core(a, b, expansion_nbz)

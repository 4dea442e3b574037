"""BELL: blocked-ELL storage for block-sparse SpMV/SpMM.

Where BSR keeps a compressed list of blocks (``formats/bsr.py``), BELL lays
blocks out *pre-windowed* per block row: ``blocks[r, l]`` is the l-th stored
block of block row ``r`` (padded with zero blocks), with its block-column id
in ``cols[r, l]``.  SpMV/SpMM then touch the matrix purely by streaming —
no gather on the matrix side at all; the only gather is the operand chunk
``v[cols]`` at ``bsz`` granularity.

No reference counterpart (the reference's only block format is BSR,
blocked_square_regular.fut:179-183); semantics of ``bell_smvm`` match
``bsr_smvm`` exactly.  The padding cost is bounded by the block-row length
skew; convert from BSR once per pattern (``bell_from_bsr``).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.segmented import INDEX_DTYPE
from .bsr import BSR
from ..utils.precision import matmul_precision

__all__ = [
    "BELL",
    "bell_from_bsr",
    "bell_from_csr",
    "bell_smvm",
    "bell_spmm",
    "bell_spmm_xla",
    "bell_todense",
]


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["cols", "blocks"],
    meta_fields=["n", "bsz"],
)
@dataclasses.dataclass(frozen=True)
class BELL:
    """Blocked-ELL matrix: ``blocks``: [nb, Lb, bsz, bsz]; ``cols``: [nb, Lb]
    block-column ids (0 for padding slots, whose blocks are all-zero)."""

    cols: jax.Array
    blocks: jax.Array
    n: int
    bsz: int

    @property
    def nb(self) -> int:
        return self.n // self.bsz

    @property
    def Lb(self) -> int:
        return self.cols.shape[1]

    @property
    def dtype(self):
        return self.blocks.dtype

    def __matmul__(self, other):
        other = jnp.asarray(other)
        if other.ndim == 1:
            return bell_smvm(self, other)
        if other.ndim == 2:
            return bell_spmm(self, other)
        return NotImplemented

    def todense(self) -> jax.Array:
        return bell_todense(self)


def bell_from_bsr(a: BSR, Lb: int | None = None) -> BELL:
    """Lay a BSR out as blocked-ELL (eager, once per sparsity pattern)."""
    nb, bsz = a.nb, a.bsz
    idxs = np.asarray(a.indices)
    blocks = np.asarray(a.blocks)
    valid = idxs < nb * nb
    rs = (idxs[valid] // nb).astype(np.int64)
    cs = (idxs[valid] % nb).astype(np.int64)
    vals = blocks[valid]
    lens = np.bincount(rs, minlength=nb)
    if Lb is None:
        Lb = int(lens.max()) if lens.size else 0
    out_blocks = np.zeros((nb, Lb, bsz, bsz), blocks.dtype)
    out_cols = np.zeros((nb, Lb), np.int32)
    # entries are sorted by (r, c); slot position = rank within the row
    starts = np.zeros(nb + 1, np.int64)
    np.cumsum(lens, out=starts[1:])
    slot = np.arange(rs.size) - starts[rs]
    keep = slot < Lb
    out_blocks[rs[keep], slot[keep]] = vals[keep]
    out_cols[rs[keep], slot[keep]] = cs[keep]
    return BELL(cols=jnp.asarray(out_cols), blocks=jnp.asarray(out_blocks),
                n=a.n, bsz=bsz)


def bell_from_csr(a, bsz: int, Lb: int | None = None) -> BELL:
    """Re-block a CSR into blocked-ELL (eager).  Fills explicit zeros inside
    touched blocks; worthwhile whenever the pattern has block locality.
    Re-blocks on the host at the exact block count (a device assembly
    would reserve one bsz x bsz block per stored entry)."""
    from ..formats.bsr import csr_to_bsr

    return bell_from_bsr(csr_to_bsr(a, bsz), Lb=Lb)


def bell_smvm_hbm_bytes(a: BELL) -> int:
    """HBM bytes one :func:`bell_smvm` moves: the block stream + block col
    ids + one gathered bsz-chunk per slot + the output (the plan_bytes term
    of utils.stats.nnz_roofline)."""
    slots = a.nb * a.Lb
    return slots * (a.bsz * a.bsz * 4 + 4 + a.bsz * 4) + a.n * 4


def bell_smvm(a: BELL, v: jax.Array) -> jax.Array:
    """Scatter-free, matrix-gather-free SpMV: stream blocks, gather operand
    chunks, contract each block with its chunk (plain XLA)."""
    v = jnp.asarray(v)
    if v.shape != (a.n,):
        raise ValueError(f"bell_smvm: vector shape {v.shape} != ({a.n},)")
    out_dtype = jnp.result_type(a.dtype, v.dtype)
    if a.n == 0 or a.Lb == 0:
        return jnp.zeros((a.n,), out_dtype)
    vb = v.reshape(a.nb, a.bsz)[a.cols.reshape(-1)].reshape(
        a.nb, a.Lb, a.bsz
    )
    out = jnp.einsum("rlij,rlj->ri", a.blocks, vb,
                     precision=matmul_precision(a.dtype, vb.dtype))
    return out.reshape(a.n).astype(out_dtype)


def _spmm_route(a: BELL, k: int, stream_dtype,
                platform_name: str | None = None) -> str:
    """``"triton"`` when the platform runs the blocked-ELL kernel and the
    product is in its range (ops/pallas_bell.kernel_eligible), else
    ``"xla"``."""
    from ..backend import has_kernel

    if not has_kernel("bell_spmm", platform_name):
        return "xla"
    from ..ops.pallas_bell import kernel_eligible

    return "triton" if kernel_eligible(a, k, stream_dtype) else "xla"


def bell_spmm(a: BELL, b: jax.Array, *, compute_dtype=None,
              precision=None) -> jax.Array:
    """Blocked-ELL SpMM: batched (bsz x bsz) @ (bsz x k).

    On a platform whose capability table (``sparse_tpu.backend``) lists the
    ``bell_spmm`` kernel, products at bsz 16 or 32 with a float32 or
    bfloat16 stream run the Triton kernel (ops/pallas_bell.py), which
    never materializes the gathered operand panels; everything else takes
    the XLA gather-einsum :func:`bell_spmm_xla`.  ``compute_dtype=jnp.bfloat16`` streams
    matrix and operand at half width with accumulation in the output
    dtype.  float32 contractions default to full precision
    (utils/precision.py)."""
    b = jnp.asarray(b)
    if b.ndim != 2 or b.shape[0] != a.n:
        raise ValueError(f"bell_spmm: operand shape {b.shape} != ({a.n}, k)")
    k = b.shape[1]
    out_dtype = jnp.result_type(a.dtype, b.dtype)
    if a.n == 0 or a.Lb == 0 or k == 0:
        return jnp.zeros((a.n, k), out_dtype)
    if _spmm_route(a, k, compute_dtype or out_dtype) == "triton":
        from ..ops.pallas_bell import bell_spmm_triton

        return bell_spmm_triton(a, b, compute_dtype=compute_dtype,
                                precision=precision)
    return bell_spmm_xla(a, b, compute_dtype=compute_dtype,
                         precision=precision)


def bell_spmm_xla(a: BELL, b: jax.Array, *, compute_dtype=None,
                  precision=None) -> jax.Array:
    """The plain XLA formulation of :func:`bell_spmm` on every platform:
    gather the ``(nb, Lb, bsz, k)`` operand panels, then one einsum."""
    b = jnp.asarray(b)
    k = b.shape[1]
    out_dtype = jnp.result_type(a.dtype, b.dtype)
    if a.n == 0 or a.Lb == 0 or k == 0:
        return jnp.zeros((a.n, k), out_dtype)
    blocks = a.blocks if compute_dtype is None else a.blocks.astype(compute_dtype)
    panels = b.reshape(a.nb, a.bsz, k)[a.cols.reshape(-1)].reshape(
        a.nb, a.Lb, a.bsz, k
    )
    if compute_dtype is not None:
        panels = panels.astype(compute_dtype)
    out = jnp.einsum(
        "rlij,rljk->rik", blocks, panels,
        preferred_element_type=out_dtype,
        precision=(precision if precision is not None
                   else matmul_precision(blocks.dtype, panels.dtype)),
    )
    return out.reshape(a.n, k).astype(out_dtype)


def bell_todense(a: BELL) -> jax.Array:
    nb, bsz, Lb = a.nb, a.bsz, a.Lb
    out = jnp.zeros((nb, nb, bsz, bsz), a.dtype)
    r = jnp.repeat(jnp.arange(nb, dtype=INDEX_DTYPE), Lb)
    out = out.at[r, a.cols.reshape(-1)].add(
        a.blocks.reshape(nb * Lb, bsz, bsz)
    )
    return out.transpose(0, 2, 1, 3).reshape(a.n, a.n)

"""Blocked-ELL SpMM as one Pallas kernel through Triton (Hopper GPUs).

The XLA formulation of ``bell_spmm`` (formats/bell.py) gathers the operand
panels into a materialized ``(nb * Lb, bsz, k)`` intermediate, written once
and read once, before a batched contraction.  This kernel never builds it:
each program owns one block row and one ``tk``-wide column tile of the
output, loads its own block-column ids, and streams ``block @ panel``
through ``pl.dot`` with the sum kept in registers.  Operand panels come
straight from device memory (neighbouring block rows of a banded matrix
share panels, which the L2 cache serves).

Constraints of the route: Triton's dot needs every dimension >= 16, so the
kernel takes ``bsz`` in :data:`KERNEL_BSZ`; ``k`` is padded up to a
multiple of the column tile.  A float32 stream passes ``HIGHEST`` (IEEE
f32 products) unless a ``precision`` is given: on this route ``DEFAULT``
lowers to TF32.  ``compute_dtype=jnp.bfloat16`` streams both operands at
half width with float32 accumulation.

Derivatives: ``pallas_call`` has no transpose rule, so the kernel carries a
custom JVP whose tangent is the XLA formulation (``bell_spmm_xla``), linear
in the tangents of ``blocks`` and ``b``.  ``jax.jvp`` and ``jax.grad``
therefore run the kernel forward and XLA einsums for the tangent / its
transpose (``A^T g`` for the operand, one outer product per slot for the
blocks), the same derivatives the XLA path has.

``interpret=True`` runs the kernel in the Pallas interpreter (CPU tests);
the library itself only calls it compiled, from ``bell_spmm`` on a GPU.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.custom_derivatives import SymbolicZero
from jax.experimental import pallas as pl

from ..formats.bell import BELL, bell_spmm_xla

__all__ = ["KERNEL_BSZ", "bell_spmm_triton", "kernel_eligible"]

#: Block sizes the kernel takes (Triton's dot wants dimensions >= 16).
KERNEL_BSZ = (16, 32)

_INT32_MAX = 2**31 - 1


def _col_tile(k: int) -> int:
    """Output column tile: a power of two in [16, 128]."""
    t = 16
    while t < min(k, 128):
        t *= 2
    return t


def kernel_eligible(a: BELL, k: int, stream_dtype) -> bool:
    """Whether :func:`bell_spmm_triton` takes this product: bsz in
    :data:`KERNEL_BSZ`, a float32 or bfloat16 stream, and every operand
    addressable with 32-bit offsets (Triton's pointer arithmetic)."""
    kp = -(-k // _col_tile(k)) * _col_tile(k)
    return (
        a.bsz in KERNEL_BSZ
        and jnp.dtype(stream_dtype) in (jnp.dtype(jnp.float32),
                                        jnp.dtype(jnp.bfloat16))
        and a.nb * a.Lb * a.bsz * a.bsz <= _INT32_MAX
        and a.n * kp <= _INT32_MAX
    )


def _kernel(cols_ref, blk_ref, b_ref, o_ref, *, lb, bsz, tk, precision):
    r = pl.program_id(0)
    j = pl.program_id(1)

    def step(l, acc):
        s = r * lb + l
        panel = b_ref[pl.ds(cols_ref[s] * bsz, bsz), pl.ds(j * tk, tk)]
        return acc + pl.dot(blk_ref[s], panel, precision=precision)

    acc = jax.lax.fori_loop(0, lb, step, jnp.zeros((bsz, tk), jnp.float32))
    o_ref[...] = acc.astype(o_ref.dtype)


def bell_spmm_triton(a: BELL, b: jax.Array, *, compute_dtype=None,
                     precision=None, interpret: bool = False) -> jax.Array:
    """C[n, k] = A @ B with A blocked-ELL, as one Triton kernel.

    Padding slots (column 0, zero block) contribute nothing.  Callers go
    through ``formats.bell.bell_spmm``, which checks
    :func:`kernel_eligible` first.  Differentiable in ``a.blocks`` and
    ``b`` (forward and reverse mode) through the custom JVP above."""
    b = jnp.asarray(b)
    if b.ndim != 2 or b.shape[0] != a.n:
        raise ValueError(f"bell_spmm_triton: operand shape {b.shape} != "
                         f"({a.n}, k)")
    k = b.shape[1]
    out_dtype = jnp.result_type(a.dtype, b.dtype)
    if a.n == 0 or a.Lb == 0 or k == 0:
        return jnp.zeros((a.n, k), out_dtype)
    stream = jnp.dtype(compute_dtype or out_dtype)
    if not kernel_eligible(a, k, stream):
        raise ValueError(
            f"bell_spmm_triton: bsz={a.bsz}, k={k}, stream {stream} is "
            f"outside the kernel's range (bsz in {KERNEL_BSZ}, f32/bf16)")
    return _spmm(a.cols, a.blocks, b, a.n, a.bsz, compute_dtype, precision,
                 interpret)


@partial(jax.custom_jvp, nondiff_argnums=(3, 4, 5, 6, 7))
def _spmm(cols, blocks, b, n, bsz, compute_dtype, precision, interpret):
    out_dtype = jnp.result_type(blocks.dtype, b.dtype)
    stream = jnp.dtype(compute_dtype or out_dtype)
    if precision is None and stream == jnp.float32:
        precision = jax.lax.Precision.HIGHEST
    nb, lb = cols.shape
    k = b.shape[1]
    tk = _col_tile(k)
    kp = -(-k // tk) * tk
    bs = b.astype(stream)
    if kp != k:
        bs = jnp.pad(bs, ((0, 0), (0, kp - k)))
    out = pl.pallas_call(
        partial(_kernel, lb=lb, bsz=bsz, tk=tk, precision=precision),
        out_shape=jax.ShapeDtypeStruct((n, kp), out_dtype),
        grid=(nb, kp // tk),
        in_specs=[pl.no_block_spec] * 3,
        out_specs=pl.BlockSpec((bsz, tk), lambda r, j: (r, j)),
        backend="triton",
        interpret=interpret,
        name="bell_spmm_triton",
    )(cols.reshape(-1).astype(jnp.int32),
      blocks.astype(stream).reshape(nb * lb, bsz, bsz), bs)
    return out if kp == k else out[:, :k]


@partial(_spmm.defjvp, symbolic_zeros=True)
def _spmm_jvp(n, bsz, compute_dtype, precision, interpret, primals,
              tangents):
    cols, blocks, b = primals
    _, dblocks, db = tangents
    out = _spmm(cols, blocks, b, n, bsz, compute_dtype, precision, interpret)

    def xla(blk, bb):
        return bell_spmm_xla(BELL(cols=cols, blocks=blk, n=n, bsz=bsz), bb,
                             compute_dtype=compute_dtype, precision=precision)

    tan = jnp.zeros_like(out)
    if not isinstance(dblocks, SymbolicZero):
        tan = tan + xla(dblocks, b)
    if not isinstance(db, SymbolicZero):
        tan = tan + xla(blocks, db)
    return out, tan

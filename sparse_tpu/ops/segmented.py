"""Segmented-operation engines: the JAX equivalent of the reference's
``segmented`` package (diku-dk/segmented, used at e.g. reference
compressed.fut:129,146,176).

The reference builds every sparse op out of four primitives:

* ``segmented_reduce``  -> here :func:`segment_sum` (XLA scatter-add based)
* ``expand``            -> here :func:`expand` (static total size)
* ``expand_outer_reduce`` -> :func:`expand` + :func:`segment_sum`
* ``replicated_iota``   -> here :func:`repeated_iota`

All functions here are jit-compatible: every output shape is a static function
of input shapes plus explicitly-passed static totals.  Irregularity (dynamic
nnz) is handled by the *caller* via padding conventions, never by dynamic
shapes -- that is the key re-design for XLA.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Index dtype used throughout the library: 32-bit indices halve index
# traffic; matrices with >2**31 stored elements per shard are out of scope.
INDEX_DTYPE = jnp.int32


def asindex(x) -> jax.Array:
    return jnp.asarray(x, dtype=INDEX_DTYPE)


def segment_sum(
    data: jax.Array,
    segment_ids: jax.Array,
    num_segments: int,
    indices_are_sorted: bool = False,
) -> jax.Array:
    """Sum ``data`` into ``num_segments`` buckets keyed by ``segment_ids``.

    Out-of-range ids (e.g. the padding sentinel ``num_segments``) are dropped,
    mirroring XLA scatter semantics.  This is the engine behind SpMV/SpGEMM
    accumulation (reference: ``segmented_reduce``, compressed.fut:83).
    """
    return jax.ops.segment_sum(
        data,
        segment_ids,
        num_segments=num_segments,
        indices_are_sorted=indices_are_sorted,
    )


def row_ids_from_indptr(indptr: jax.Array, nse: int) -> jax.Array:
    """Expand a compressed row pointer into one row id per stored entry.

    ``indptr`` is an exclusive prefix (length n+1, ``indptr[0] == 0``,
    ``indptr[n]`` = number of valid entries).  Padding entries (positions >=
    ``indptr[n]``) get the out-of-range sentinel ``n`` so downstream
    segment-sums drop them.
    """
    n = indptr.shape[0] - 1
    if nse == 0:
        return jnp.zeros((0,), dtype=INDEX_DTYPE)
    pos = jnp.arange(nse, dtype=indptr.dtype)
    ids = jnp.searchsorted(indptr, pos, side="right").astype(INDEX_DTYPE) - 1
    return jnp.where(pos < indptr[n], ids, jnp.asarray(n, INDEX_DTYPE))


def repeated_iota(sizes: jax.Array, total: int) -> jax.Array:
    """``replicated_iota`` (reference compressed.fut:176): produce a vector of
    ``total`` segment ids ``[0,0,...,1,1,...]`` where element ``i`` repeats
    ``sizes[i]`` times.  ``total`` must be a static upper bound; slots beyond
    ``sum(sizes)`` are filled with the sentinel ``len(sizes)``.
    """
    k = sizes.shape[0]
    if total == 0:
        return jnp.zeros((0,), dtype=INDEX_DTYPE)
    offsets = jnp.cumsum(sizes.astype(INDEX_DTYPE)) - sizes.astype(INDEX_DTYPE)
    heads = jnp.zeros((total,), dtype=INDEX_DTYPE).at[offsets].add(
        jnp.ones((k,), dtype=INDEX_DTYPE), mode="drop"
    )
    ids = jnp.cumsum(heads) - 1
    valid_total = jnp.sum(sizes).astype(INDEX_DTYPE)
    pos = jnp.arange(total, dtype=INDEX_DTYPE)
    return jnp.where(pos < valid_total, ids, jnp.asarray(k, INDEX_DTYPE))


def expand(sizes: jax.Array, total: int) -> tuple[jax.Array, jax.Array]:
    """Flat irregular expansion (reference ``expand``, compressed.fut:129).

    Given per-element segment ``sizes``, returns ``(elem_ids, inner_ids)`` of
    length ``total`` such that output slot ``p`` corresponds to the
    ``inner_ids[p]``-th item of element ``elem_ids[p]``.  Slots beyond
    ``sum(sizes)`` carry the sentinel ``len(sizes)`` in ``elem_ids`` and 0 in
    ``inner_ids``; callers must mask or rely on sentinel-drop semantics.
    """
    k = sizes.shape[0]
    ids = repeated_iota(sizes, total)
    if total == 0:
        return ids, jnp.zeros((0,), dtype=INDEX_DTYPE)
    offsets = jnp.cumsum(sizes.astype(INDEX_DTYPE)) - sizes.astype(INDEX_DTYPE)
    safe_ids = jnp.minimum(ids, jnp.asarray(max(k - 1, 0), INDEX_DTYPE))
    pos = jnp.arange(total, dtype=INDEX_DTYPE)
    inner = jnp.where(ids < k, pos - offsets[safe_ids] if k else pos, 0)
    return ids, inner.astype(INDEX_DTYPE)


def cumsum_exclusive(x: jax.Array) -> jax.Array:
    """Exclusive prefix sum with the total appended: [0, x0, x0+x1, ...]."""
    return jnp.concatenate([jnp.zeros((1,), x.dtype), jnp.cumsum(x)])

"""Halo-exchange distributed SpMV: communicate only the operand entries each
partition actually reads.

``pcsr_spmv`` all-gathers the full dense operand (robust baseline, O(m) per
device).  For matrices with column locality (banded/FEM — the common case)
each row slab touches few remote columns; this module precomputes, once per
(pattern, mesh), exactly which entries each shard pair exchanges, and the
runtime step is a single ``all_to_all`` of the padded halo buffers followed
by a purely local SpMV whose column indices were *remapped at plan time*
into the received-halo layout.  Communication drops from O(m) to O(halo).

This is the sparse analogue of ring-attention's gather-overlap (SURVEY.md
§5.7): the plan is static data, the exchange is one XLA collective between
devices, and the local compute is a gather + segment-sum.  No reference
counterpart exists (the reference is single-device).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..formats.csr import CSR
from ..ops.segmented import row_ids_from_indptr, segment_sum
from .pcsr import put_sharded

__all__ = [
    "HaloPCSR",
    "halo_partition",
    "halo_spmv",
    "halo_spmm",
    "HaloPCSROverlap",
    "halo_partition_overlapped",
    "halo_spmv_overlapped",
    "halo_spmm_overlapped",
    "dist_spmv",
]


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["data", "indices", "indptr", "send_idx"],
    meta_fields=["shape", "axis", "rows_per_shard", "cols_per_shard", "halo"],
)
@dataclasses.dataclass(frozen=True)
class HaloPCSR:
    """Row-partitioned CSR with a precomputed halo-exchange plan.

    ``data``/``indices``/``indptr``: per-shard local CSR (leading device
    axis); ``indices`` are *remapped* into the halo buffer layout
    ``s * halo + rank`` (entry rank within the halo received from shard s).
    ``send_idx[d, t]``: positions within shard d's operand slab to send to
    shard t (padded with 0)."""

    data: jax.Array  # (D, nse_p)
    indices: jax.Array  # (D, nse_p) halo-space column ids
    indptr: jax.Array  # (D, rows_p + 1)
    send_idx: jax.Array  # (D, D, halo)
    shape: tuple[int, int]
    axis: str
    rows_per_shard: int
    cols_per_shard: int
    halo: int

    @property
    def n_shards(self) -> int:
        return self.indptr.shape[0]

    @property
    def comm_entries_per_device(self) -> int:
        """all_to_all payload per device, in operand entries (D * halo)."""
        return self.indptr.shape[0] * self.halo


def halo_partition(a: CSR, mesh: Mesh, axis: str = "shards") -> HaloPCSR:
    """Build the halo plan (eager, once per sparsity pattern + mesh)."""
    n, m = a.shape
    d = mesh.shape[axis]
    rows_p = -(-max(n, 1) // d)
    cols_p = -(-max(m, 1) // d)
    indptr = np.asarray(a.indptr)
    indices = np.asarray(a.indices)
    data = np.asarray(a.data)

    # per destination shard: needed global columns, grouped by source shard
    needed: list[list[np.ndarray]] = []  # needed[dst][src] = sorted local cols
    local_idx: list[np.ndarray] = []
    local_ptr: list[np.ndarray] = []
    local_dat: list[np.ndarray] = []
    halo = 1
    for dst in range(d):
        lo, hi = min(dst * rows_p, n), min((dst + 1) * rows_p, n)
        s, e = int(indptr[lo]), int(indptr[hi])
        cols = indices[s:e]
        uniq = np.unique(cols)
        by_src = [
            uniq[(uniq >= src * cols_p) & (uniq < (src + 1) * cols_p)] - src * cols_p
            for src in range(d)
        ]
        needed.append(by_src)
        halo = max(halo, max((b.size for b in by_src), default=0))
        ptr = np.zeros(rows_p + 1, np.int64)
        ptr[: hi - lo + 1] = indptr[lo : hi + 1] - indptr[lo]
        ptr[hi - lo + 1 :] = ptr[hi - lo]
        local_ptr.append(ptr)
        local_idx.append(cols.copy())
        local_dat.append(data[s:e])

    # second pass with the final halo width: build remapped indices + tables
    send = np.zeros((d, d, halo), np.int32)
    for dst in range(d):
        remap = np.zeros(m + 1, np.int64)
        for src in range(d):
            b = needed[dst][src]
            send[src, dst, : b.size] = b
            remap[src * cols_p + b] = src * halo + np.arange(b.size)
        local_idx[dst] = remap[local_idx[dst]]

    nse_p = max(max((x.size for x in local_idx), default=0), 1)
    idxs = np.zeros((d, nse_p), np.int32)
    vals = np.zeros((d, nse_p), data.dtype)
    for i in range(d):
        idxs[i, : local_idx[i].size] = local_idx[i]
        vals[i, : local_dat[i].size] = local_dat[i]
    ptrs = np.stack(local_ptr).astype(np.int32)
    return HaloPCSR(
        data=put_sharded(vals, mesh, axis),
        indices=put_sharded(idxs, mesh, axis),
        indptr=put_sharded(ptrs, mesh, axis),
        send_idx=put_sharded(send, mesh, axis),
        shape=(n, m),
        axis=axis,
        rows_per_shard=rows_p,
        cols_per_shard=cols_p,
        halo=halo,
    )


@partial(jax.jit, static_argnames=("mesh", "ax", "d", "H"))
def _halo_spmv_exec(data, indices, indptr, send_idx, v, *, mesh, ax, d, H):
    def body(data, indices, indptr, send_idx, v_local):
        # gather this shard's outgoing halo entries: row t = what we send to t
        # (v_local may carry trailing dims: (cols_p,) SpMV or (cols_p, k) SpMM)
        send_buf = v_local[send_idx[0]]  # (D, H[, k])
        # exchange: recv[s] = the entries shard s holds that we need
        recv = jax.lax.all_to_all(send_buf, ax, split_axis=0, concat_axis=0)
        v_halo = recv.reshape((d * H,) + v_local.shape[1:])
        data, indices, indptr = data[0], indices[0], indptr[0]
        rows_p = indptr.shape[0] - 1
        rows = row_ids_from_indptr(indptr, data.shape[0])
        prods = data.reshape(data.shape + (1,) * (v_local.ndim - 1)) * v_halo[indices]
        return segment_sum(prods, rows, rows_p, indices_are_sorted=True)[None]

    f = shard_map(
        body,
        mesh=mesh,
        in_specs=(P(ax), P(ax), P(ax), P(ax), P(ax)),
        out_specs=P(ax),
    )
    return f(data, indices, indptr, send_idx, v)


def halo_spmv(a: HaloPCSR, v: jax.Array, mesh: Mesh) -> jax.Array:
    """Distributed SpMV with halo exchange.  ``v`` sharded over the mesh axis
    padded to ``cols_per_shard * D`` (use ``shard_vector``); output is padded
    row-sharded.  Comm: one all_to_all of (D * halo) entries per device."""
    return _halo_spmv_exec(
        a.data, a.indices, a.indptr, a.send_idx, v,
        mesh=mesh, ax=a.axis, d=a.n_shards, H=a.halo,
    ).reshape(-1)


def halo_spmm(a: HaloPCSR, b: jax.Array, mesh: Mesh) -> jax.Array:
    """Distributed SpMM with halo exchange: ``b`` is ``(cols_per_shard * D,
    k)`` row-sharded (use ``shard_vector``); the all_to_all carries
    ``D * halo`` operand *rows* (k entries each) per device."""
    out = _halo_spmv_exec(
        a.data, a.indices, a.indptr, a.send_idx, b,
        mesh=mesh, ax=a.axis, d=a.n_shards, H=a.halo,
    )
    return out.reshape(-1, b.shape[1])


@partial(
    jax.tree_util.register_dataclass,
    data_fields=[
        "int_data", "int_idx", "int_rows",
        "fr_data", "fr_idx", "fr_rows", "send_idx",
    ],
    meta_fields=["shape", "axis", "rows_per_shard", "cols_per_shard", "halo"],
)
@dataclasses.dataclass(frozen=True)
class HaloPCSROverlap:
    """Row-partitioned CSR split for compute/comm overlap.

    Each shard's entries are split at plan time into *interior* entries
    (column inside the shard's own operand slab — indexed directly into
    ``v_local``) and *frontier* entries (remote columns — indexed into the
    received halo buffer ``src * halo + rank``).  Only frontier columns
    travel: the all_to_all is issued first, the interior partial SpMV runs
    while it is in flight (XLA's latency-hiding scheduler overlaps the
    async collective with the independent interior compute), and the
    frontier partial sum lands on top.  Unlike :class:`HaloPCSR`, a shard's
    own columns never round-trip through the exchange, so the collective
    payload is strictly the remote halo.
    """

    int_data: jax.Array  # (D, nse_int_p)
    int_idx: jax.Array   # (D, nse_int_p) local-slab column ids
    int_rows: jax.Array  # (D, nse_int_p) local row ids (rows_p = padding)
    fr_data: jax.Array   # (D, nse_fr_p)
    fr_idx: jax.Array    # (D, nse_fr_p) halo-space ids src * halo + rank
    fr_rows: jax.Array   # (D, nse_fr_p)
    send_idx: jax.Array  # (D, D, halo)
    shape: tuple[int, int]
    axis: str
    rows_per_shard: int
    cols_per_shard: int
    halo: int

    @property
    def n_shards(self) -> int:
        return self.int_data.shape[0]

    @property
    def comm_entries_per_device(self) -> int:
        """all_to_all payload per device, in operand entries."""
        return self.n_shards * self.halo


def halo_partition_overlapped(
    a: CSR, mesh: Mesh, axis: str = "shards"
) -> HaloPCSROverlap:
    """Build the interior/frontier split plan (eager, once per pattern+mesh)."""
    n, m = a.shape
    d = mesh.shape[axis]
    rows_p = -(-max(n, 1) // d)
    cols_p = -(-max(m, 1) // d)
    indptr = np.asarray(a.indptr)
    indices = np.asarray(a.indices)
    data = np.asarray(a.data)

    needed: list[list[np.ndarray]] = []
    per_int: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []
    per_fr: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []
    halo = 1
    for dst in range(d):
        lo, hi = min(dst * rows_p, n), min((dst + 1) * rows_p, n)
        s, e = int(indptr[lo]), int(indptr[hi])
        cols = indices[s:e]
        vals = data[s:e]
        rows = (
            np.searchsorted(indptr[lo : hi + 1], np.arange(s, e), side="right")
            - 1
        )
        own = (cols >= dst * cols_p) & (cols < (dst + 1) * cols_p)
        per_int.append((vals[own], cols[own] - dst * cols_p, rows[own]))
        rcols = cols[~own]
        per_fr.append((vals[~own], rcols, rows[~own]))
        uniq = np.unique(rcols)
        by_src = [
            np.zeros(0, np.int64) if src == dst
            else uniq[(uniq >= src * cols_p) & (uniq < (src + 1) * cols_p)]
            - src * cols_p
            for src in range(d)
        ]
        needed.append(by_src)
        halo = max(halo, max((b.size for b in by_src), default=0))

    send = np.zeros((d, d, halo), np.int32)
    fr_remapped: list[np.ndarray] = []
    for dst in range(d):
        remap = np.zeros(m + 1, np.int64)
        for src in range(d):
            b = needed[dst][src]
            send[src, dst, : b.size] = b
            remap[src * cols_p + b] = src * halo + np.arange(b.size)
        fr_remapped.append(remap[per_fr[dst][1]])

    def pad(parts, idx_parts, row_parts):
        cap = max(max((p.size for p in parts), default=0), 1)
        vals = np.zeros((d, cap), data.dtype)
        idxs = np.zeros((d, cap), np.int32)
        rows = np.full((d, cap), rows_p, np.int32)  # sentinel -> dropped
        for i in range(d):
            k = parts[i].size
            vals[i, :k] = parts[i]
            idxs[i, :k] = idx_parts[i]
            rows[i, :k] = row_parts[i]
        return vals, idxs, rows

    iv, ii, ir = pad(
        [p[0] for p in per_int], [p[1] for p in per_int],
        [p[2] for p in per_int],
    )
    fv, fi, fr = pad(
        [p[0] for p in per_fr], fr_remapped, [p[2] for p in per_fr],
    )
    put = lambda x: put_sharded(x, mesh, axis)
    return HaloPCSROverlap(
        int_data=put(iv), int_idx=put(ii), int_rows=put(ir),
        fr_data=put(fv), fr_idx=put(fi), fr_rows=put(fr),
        send_idx=put(send),
        shape=(n, m), axis=axis,
        rows_per_shard=rows_p, cols_per_shard=cols_p, halo=halo,
    )


@partial(jax.jit, static_argnames=("mesh", "ax", "d", "H", "rows_p"))
def _halo_spmv_overlapped_exec(
    iv, ii, ir, fv, fi, frw, send_idx, v, *, mesh, ax, d, H, rows_p
):
    def body(iv, ii, ir, fv, fi, frw, send_idx, v_local):
        send_buf = v_local[send_idx[0]]  # (D, H[, k])
        recv = jax.lax.all_to_all(send_buf, ax, split_axis=0, concat_axis=0)
        trail = (1,) * (v_local.ndim - 1)
        # interior partial: independent of recv -> overlaps the collective
        y = segment_sum(
            iv[0].reshape(iv[0].shape + trail) * v_local[ii[0]], ir[0], rows_p
        )
        v_halo = recv.reshape((d * H,) + v_local.shape[1:])
        y = y + segment_sum(
            fv[0].reshape(fv[0].shape + trail) * v_halo[fi[0]], frw[0], rows_p
        )
        return y[None]

    f = shard_map(
        body,
        mesh=mesh,
        in_specs=(P(ax),) * 8,
        out_specs=P(ax),
    )
    return f(iv, ii, ir, fv, fi, frw, send_idx, v)


def halo_spmv_overlapped(
    a: HaloPCSROverlap, v: jax.Array, mesh: Mesh
) -> jax.Array:
    """Distributed SpMV with the halo exchange overlapped with interior
    compute.  Same calling convention as :func:`halo_spmv`.  The interior
    partial sum has no data dependency on the collective, so XLA's
    latency-hiding scheduler can run the interior SpMV while the async
    all_to_all is in flight; the frontier partial sum closes the row
    totals afterwards."""
    return _halo_spmv_overlapped_exec(
        a.int_data, a.int_idx, a.int_rows,
        a.fr_data, a.fr_idx, a.fr_rows,
        a.send_idx, v,
        mesh=mesh, ax=a.axis, d=a.n_shards, H=a.halo,
        rows_p=a.rows_per_shard,
    ).reshape(-1)


def halo_spmm_overlapped(
    a: HaloPCSROverlap, b: jax.Array, mesh: Mesh
) -> jax.Array:
    """SpMM variant of :func:`halo_spmv_overlapped`: ``b`` is
    ``(cols_per_shard * D, k)`` row-sharded; the interior partial product
    overlaps the all_to_all of the ``D * halo`` frontier operand rows."""
    out = _halo_spmv_overlapped_exec(
        a.int_data, a.int_idx, a.int_rows,
        a.fr_data, a.fr_idx, a.fr_rows,
        a.send_idx, b,
        mesh=mesh, ax=a.axis, d=a.n_shards, H=a.halo,
        rows_p=a.rows_per_shard,
    )
    return out.reshape(-1, b.shape[1])


def dist_spmv(a, v: jax.Array, mesh: Mesh) -> jax.Array:
    """Distributed SpMV dispatch over the partitioned-matrix types.

    Accepts :class:`~sparse_tpu.parallel.pcsr.PCSR` (all-gather baseline),
    :class:`HaloPCSR` (halo all_to_all) or :class:`HaloPCSROverlap`
    (overlapped halo).  All share the padded row-sharded vector
    convention, so the distributed solvers (parallel/cg.py) take any of
    them: partition once with the structure the pattern supports."""
    from .pcsr import PCSR, pcsr_spmv

    if isinstance(a, HaloPCSROverlap):
        return halo_spmv_overlapped(a, v, mesh)
    if isinstance(a, HaloPCSR):
        return halo_spmv(a, v, mesh)
    if isinstance(a, PCSR):
        return pcsr_spmv(a, v, mesh)
    raise TypeError(f"dist_spmv: unsupported partitioned type {type(a)!r}")

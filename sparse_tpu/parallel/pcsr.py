"""Row-partitioned CSR over a 1-D device mesh: the multi-chip layer.

The reference has **no** distributed support of any kind (SURVEY.md §2.3);
this is the multi-device scaling layer the north star adds (BASELINE.md,
config 5): the sparse analogue of data/tensor parallelism is *row
partitioning* of the sparse operand with the dense operand sharded to match.

Design:

* ``PCSR`` carries one local CSR block per device, stacked on a leading
  device axis (``data``/``indices``: [D, nse_p]; ``indptr``: [D, rows_p+1])
  and placed with a ``NamedSharding`` over the mesh axis, so each device
  holds exactly its row slab in HBM.
* ``pcsr_spmv``/``pcsr_spmm`` run under ``shard_map``: the dense operand is
  sharded over the same axis; each device ``all_gather``\\ s the full operand
  between devices (all-gather compiled by XLA) and computes its local row slab.
  Outputs stay row-sharded — chaining ops never leaves the device.
* Rows and capacities are padded so every device does identical static-shape
  work (no stragglers at the XLA level; load balance is a partitioning-time
  concern).

The all-gather-everything operand exchange is the robust baseline; the
halo-index analysis (gather only the column segments a partition touches,
overlapped with local compute) is the planned refinement — see SURVEY.md §5.7.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..formats.csr import CSR, csr_smvm
from ..ops.segmented import INDEX_DTYPE, row_ids_from_indptr, segment_sum

__all__ = [
    "PCSR",
    "make_1d_mesh",
    "pcsr_from_csr",
    "pcsr_spmv",
    "pcsr_spmm",
    "pcsr_todense",
]


def make_1d_mesh(n_devices: int | None = None, axis: str = "shards") -> Mesh:
    """A 1-D mesh over the first ``n_devices`` devices."""
    devs = jax.devices()
    if n_devices is None:
        n_devices = len(devs)
    return Mesh(np.asarray(devs[:n_devices]), (axis,))


def put_sharded(x, mesh: Mesh, axis: str):
    """Shard a host-global array over ``mesh``'s ``axis`` (leading dim).

    Single-process: a plain ``device_put``.  Multi-process (after
    ``jax.distributed.initialize``): every process passes the same global
    host array and contributes only the leading-axis rows its local devices
    own via ``jax.make_array_from_process_local_data`` — this is what makes
    the whole ``parallel/`` layer run unchanged on multi-host meshes (DCN);
    exercised by tests/test_multiprocess.py on a 2-process CPU simulation.
    """
    sharding = NamedSharding(mesh, P(axis))
    x = jnp.asarray(x)
    if jax.process_count() == 1:
        return jax.device_put(x, sharding)
    xs = np.asarray(x)
    d = mesh.shape[axis]
    per = xs.shape[0] // d
    pid = jax.process_index()
    rows = [
        i for i, dev in enumerate(mesh.devices.reshape(-1))
        if dev.process_index == pid
    ]
    local = np.concatenate([xs[r * per : (r + 1) * per] for r in rows])
    return jax.make_array_from_process_local_data(sharding, local, xs.shape)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["data", "indices", "indptr"],
    meta_fields=["shape", "axis", "rows_per_shard"],
)
@dataclasses.dataclass(frozen=True)
class PCSR:
    """Row-partitioned CSR.  ``data``/``indices``: [D, nse_p]; ``indptr``:
    [D, rows_p+1] (local, exclusive prefix per shard).  Shard ``d`` owns
    global rows [d*rows_p, (d+1)*rows_p); rows beyond ``shape[0]`` are
    padding with empty rows."""

    data: jax.Array
    indices: jax.Array
    indptr: jax.Array
    shape: tuple[int, int]
    axis: str
    rows_per_shard: int

    @property
    def n_shards(self) -> int:
        return self.indptr.shape[0]

    @property
    def nse_per_shard(self) -> int:
        return self.data.shape[1]

    @property
    def dtype(self):
        return self.data.dtype


def pcsr_from_csr(a: CSR, mesh: Mesh, axis: str = "shards") -> PCSR:
    """Partition a CSR by contiguous row slabs over ``mesh`` (eager: one host
    pass sizes the per-shard capacity to the max slab nnz)."""
    n, m = a.shape
    d = mesh.shape[axis]
    rows_p = -(-max(n, 1) // d)
    indptr = np.asarray(a.indptr)
    indices = np.asarray(a.indices)
    data = np.asarray(a.data)
    nse_p = 0
    slabs = []
    for i in range(d):
        lo, hi = min(i * rows_p, n), min((i + 1) * rows_p, n)
        s, e = int(indptr[lo]), int(indptr[hi])
        local_ptr = np.zeros(rows_p + 1, np.int64)
        local_ptr[: hi - lo + 1] = indptr[lo : hi + 1] - indptr[lo]
        local_ptr[hi - lo + 1 :] = local_ptr[hi - lo]
        slabs.append((local_ptr, indices[s:e], data[s:e]))
        nse_p = max(nse_p, e - s)
    nse_p = max(nse_p, 1)
    ptrs = np.stack([s[0] for s in slabs]).astype(np.int32)
    idxs = np.zeros((d, nse_p), np.int32)
    vals = np.zeros((d, nse_p), data.dtype)
    for i, (_, ix, vl) in enumerate(slabs):
        idxs[i, : ix.size] = ix
        vals[i, : vl.size] = vl
    return PCSR(
        data=put_sharded(vals, mesh, axis),
        indices=put_sharded(idxs, mesh, axis),
        indptr=put_sharded(ptrs, mesh, axis),
        shape=(n, m),
        axis=axis,
        rows_per_shard=rows_p,
    )


def _local_spmv(data, indices, indptr, v):
    """SpMV of one local row slab against the full dense vector."""
    rows_p = indptr.shape[0] - 1
    nse_p = data.shape[0]
    rows = row_ids_from_indptr(indptr, nse_p)
    prods = data * v[indices]
    return segment_sum(prods, rows, rows_p, indices_are_sorted=True)


# shard_map pipelines are jitted at module level (statics: mesh + axis) so
# that eager user calls hit XLA's compile cache instead of dispatching every
# traced op individually — measured 20+ s/eager call on the 8-device CPU
# mesh without this, miliseconds with it.


@partial(jax.jit, static_argnames=("mesh", "ax"))
def _pcsr_spmv_exec(data, indices, indptr, v, *, mesh, ax):
    def body(data, indices, indptr, v_local):
        v_full = jax.lax.all_gather(v_local, ax, tiled=True)
        return _local_spmv(data[0], indices[0], indptr[0], v_full)[None]

    f = shard_map(
        body,
        mesh=mesh,
        in_specs=(P(ax), P(ax), P(ax), P(ax)),
        out_specs=P(ax),
    )
    return f(data, indices, indptr, v)


def pcsr_spmv(a: PCSR, v: jax.Array, mesh: Mesh) -> jax.Array:
    """Distributed SpMV: ``v`` sharded over the mesh axis; all-gather,
    local slab SpMV; output stays row-sharded.  Returns the padded
    (rows_p * D,) vector — slice to ``a.shape[0]`` for the logical result."""
    return _pcsr_spmv_exec(
        a.data, a.indices, a.indptr, v, mesh=mesh, ax=a.axis
    ).reshape(-1)


@partial(jax.jit, static_argnames=("mesh", "ax"))
def _pcsr_spmm_exec(data, indices, indptr, b, *, mesh, ax):
    def body(data, indices, indptr, b_local):
        b_full = jax.lax.all_gather(b_local, ax, tiled=True)
        data, indices, indptr = data[0], indices[0], indptr[0]
        rows_p = indptr.shape[0] - 1
        rows = row_ids_from_indptr(indptr, data.shape[0])
        prods = b_full[indices] * data[:, None]
        return segment_sum(prods, rows, rows_p, indices_are_sorted=True)[None]

    f = shard_map(
        body,
        mesh=mesh,
        in_specs=(P(ax), P(ax), P(ax), P(ax)),
        out_specs=P(ax),
    )
    return f(data, indices, indptr, b)


def pcsr_spmm(a: PCSR, b: jax.Array, mesh: Mesh) -> jax.Array:
    """Distributed SpMM (CSR x dense tall-skinny): ``b`` row-sharded; output
    row-sharded with padded leading dim rows_p * D."""
    out = _pcsr_spmm_exec(a.data, a.indices, a.indptr, b, mesh=mesh, ax=a.axis)
    return out.reshape(-1, b.shape[1])


def shard_vector(v: jax.Array, a: PCSR, mesh: Mesh) -> jax.Array:
    """Pad a global (dense-operand) vector/matrix along its leading axis to a
    multiple of the shard count and shard it over the mesh axis.  For square
    matrices this equals the row padding ``rows_p * D``, so solver iterates
    can feed outputs straight back in."""
    v = jnp.asarray(v)
    d = a.n_shards
    total = -(-v.shape[0] // d) * d
    pad = total - v.shape[0]
    if pad:
        v = jnp.concatenate([v, jnp.zeros((pad,) + v.shape[1:], v.dtype)])
    return put_sharded(v, mesh, a.axis)


def pcsr_todense(a: PCSR) -> jax.Array:
    """Gather to a dense (host-side check utility)."""
    n, m = a.shape
    out = np.zeros((a.n_shards * a.rows_per_shard, m), np.asarray(a.data).dtype)
    ptrs = np.asarray(a.indptr)
    idxs = np.asarray(a.indices)
    vals = np.asarray(a.data)
    for d in range(a.n_shards):
        for r in range(a.rows_per_shard):
            s, e = ptrs[d, r], ptrs[d, r + 1]
            np.add.at(out[d * a.rows_per_shard + r], idxs[d, s:e], vals[d, s:e])
    return jnp.asarray(out[:n])

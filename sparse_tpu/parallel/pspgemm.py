"""Distributed SpGEMM and transpose for row-partitioned CSR.

SURVEY.md §2.3(3): distributed SpGEMM via operand redistribution.  1-D
row-partition algebra: ``C_i = A_i @ B`` — each shard's output row slab needs
*all* of B, so the communication step is an all-gather of B's (padded,
per-shard) CSR arrays between devices; the compute step is the same jit ESC core as
single-device SpGEMM (``ops/spgemm.spgemm_products``), fed the gathered
storage through its generalized (starts, lengths) row interface so per-shard
padding gaps need no repacking.  Output stays row-partitioned — chained
multiplies never leave the devices.

``pcsr_transpose`` repartitions A^T by rows (= A by columns); the current
implementation is the eager host-side repartition (construction-time
operation); the device-side variant is the halo-style padded ``all_to_all``
of COO triples (parallel/halo.py demonstrates the plan machinery).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..formats.coo import COO
from ..formats.csr import CSR, csr_from_coo
from ..ops.segmented import INDEX_DTYPE
from ..ops.spgemm import spgemm_products
from .pcsr import PCSR, pcsr_from_csr, put_sharded

__all__ = [
    "pcsr_spgemm",
    "pcsr_transpose",
    "PSpGEMMPlan",
    "build_pspgemm_plan",
    "pcsr_spgemm_aa",
    "PTransposePlan",
    "build_transpose_plan",
    "pcsr_transpose_device",
]


def _local_csr(data, indices, indptr, rows_p, m):
    return CSR(data=data, indices=indices, indptr=indptr, shape=(rows_p, m))


def pcsr_spgemm(a: PCSR, b: PCSR, mesh: Mesh,
                expansion_nse: int | None = None) -> PCSR:
    """C = A @ B, both row-partitioned over the same mesh axis; returns C
    row-partitioned with per-shard capacity ``expansion_nse`` (computed
    eagerly as the max per-shard product count when None)."""
    n, m = a.shape
    m2, k = b.shape
    if m != m2:
        raise ValueError(f"pcsr_spgemm: inner dims {a.shape} @ {b.shape}")
    if a.axis != b.axis or a.n_shards != b.n_shards:
        raise ValueError("pcsr_spgemm: operands must share the mesh axis")
    ax = a.axis
    d = a.n_shards
    rows_p = a.rows_per_shard
    b_rows_p = b.rows_per_shard

    if expansion_nse is None:
        # symbolic sizing pass (host): per-shard product counts
        b_ptr = np.asarray(b.indptr)
        b_lens_global = np.concatenate(
            [b_ptr[s, 1:] - b_ptr[s, :-1] for s in range(d)]
        )[:m]
        a_ptr = np.asarray(a.indptr)
        a_idx = np.asarray(a.indices)
        f = 0
        for s in range(d):
            valid = a_ptr[s, -1]
            f = max(f, int(b_lens_global[a_idx[s, :valid]].sum()))
        expansion_nse = max(f, 1)

    cd, ci, cp = _pcsr_spgemm_exec(
        a.data, a.indices, a.indptr, b.data, b.indices, b.indptr,
        mesh=mesh, ax=ax, d=d, rows_p=rows_p, m=m, k=k,
        expansion_nse=expansion_nse,
    )
    return PCSR(
        data=cd,
        indices=ci,
        indptr=cp,
        shape=(n, k),
        axis=ax,
        rows_per_shard=rows_p,
    )


@partial(
    jax.jit,
    static_argnames=("mesh", "ax", "d", "rows_p", "m", "k", "expansion_nse"),
)
def _pcsr_spgemm_exec(a_data_g, a_idx_g, a_ptr_g, b_data_g, b_idx_g, b_ptr_g,
                      *, mesh, ax, d, rows_p, m, k, expansion_nse):
    # module-level jit: eager calls hit the compile cache (the shard_map
    # ESC pipeline dispatched op-by-op costs tens of seconds per call)
    def body(a_data, a_idx, a_ptr, b_data, b_idx, b_ptr):
        # gather B's padded shard storage: rows stay contiguous per shard
        bd = jax.lax.all_gather(b_data[0], ax)  # (D, nse_p)
        bi = jax.lax.all_gather(b_idx[0], ax)
        bp = jax.lax.all_gather(b_ptr[0], ax)  # (D, b_rows_p+1)
        nse_p = bd.shape[1]
        starts = (
            bp[:, :-1] + (jnp.arange(d, dtype=bp.dtype) * nse_p)[:, None]
        ).reshape(-1)[:m]
        lens = (bp[:, 1:] - bp[:, :-1]).reshape(-1)[:m].astype(INDEX_DTYPE)
        local_a = _local_csr(a_data[0], a_idx[0], a_ptr[0], rows_p, m)
        prods = spgemm_products(
            local_a, bd.reshape(-1), bi.reshape(-1), starts, lens, k,
            expansion_nse,
        )
        c = csr_from_coo(
            COO(row=prods.row, col=prods.col, data=prods.data, shape=(rows_p, k))
        )
        return c.data[None], c.indices[None], c.indptr[None]

    f = shard_map(
        body,
        mesh=mesh,
        in_specs=(P(ax),) * 6,
        out_specs=(P(ax), P(ax), P(ax)),
    )
    return f(a_data_g, a_idx_g, a_ptr_g, b_data_g, b_idx_g, b_ptr_g)


def pcsr_transpose(a: PCSR, mesh: Mesh) -> PCSR:
    """A^T row-partitioned.  Convenience wrapper: builds the all-to-all plan
    eagerly (host symbolic pass, once per pattern) and applies it on device
    — the data path is :func:`pcsr_transpose_device` (values-only
    all_to_all); for repeated transposes under jit, build the plan once with
    :func:`build_transpose_plan` and call the device variant directly."""
    return pcsr_transpose_device(a, mesh, build_transpose_plan(a, mesh))


# ---------------------------------------------------------------------------
# All-to-all redistribution variants (SURVEY.md §2.3-3).
#
# The all-gather formulation above moves O(nnz_B) per device.  When the
# patterns are static, both SpGEMM's operand motion and the transpose's
# repartition reduce to a *values-only* padded all_to_all: every index,
# placement and capacity is resolved on the host once per (pattern, mesh),
# and the runtime step is one collective of O(nnz/D) entries plus gathers.
# Rows a shard needs from itself never enter the collective — they are read
# straight out of local storage, so the exchange payload is strictly remote.
# ---------------------------------------------------------------------------

from ..ops.segmented import segment_sum  # noqa: F401  (re-export convenience)


def _shard_entries(p, s, n):
    """Valid (local_row, col, pos) triples of shard ``s`` of a PCSR."""
    ptr = np.asarray(p.indptr[s])
    idx = np.asarray(p.indices[s])
    cnt = int(ptr[-1])
    rows = np.searchsorted(ptr, np.arange(cnt), side="right") - 1
    return rows, idx[:cnt].astype(np.int64), np.arange(cnt)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["send_pos", "bi_gath", "starts", "lens"],
    meta_fields=["exch", "cap", "k"],
)
@dataclasses.dataclass(frozen=True)
class PSpGEMMPlan:
    """Static all-to-all plan for ``pcsr_spgemm_aa`` (one per pattern pair +
    mesh).  ``send_pos[s, t]``: positions in shard s's padded B storage to
    send to shard t; ``bi_gath[t, s]``: column ids carried by those slots
    (receiver side); ``starts``/``lens``: per-global-B-row offsets into the
    receiver's combined [recv | local] storage (0 length for rows the shard
    never multiplies).  ``exch`` is the padded per-pair entry count,
    ``cap`` the per-shard ESC expansion capacity."""

    send_pos: jax.Array  # (D, D, E) int32
    bi_gath: jax.Array   # (D, D, E) int32
    starts: jax.Array    # (D, m) int32
    lens: jax.Array      # (D, m) int32
    exch: int
    cap: int
    k: int

    @property
    def comm_entries_per_device(self) -> int:
        return self.send_pos.shape[1] * self.exch


def build_pspgemm_plan(a: PCSR, b: PCSR, mesh: Mesh) -> PSpGEMMPlan:
    """Host-side symbolic pass (eager, once per pattern pair + mesh)."""
    n, m = a.shape
    m2, k = b.shape
    if m != m2:
        raise ValueError(f"build_pspgemm_plan: inner dims {a.shape} @ {b.shape}")
    if a.axis != b.axis or a.n_shards != b.n_shards:
        raise ValueError("build_pspgemm_plan: operands must share the mesh axis")
    d = a.n_shards
    b_rows_p = b.rows_per_shard
    nse_b_p = b.nse_per_shard

    b_ptrs = [np.asarray(b.indptr[s]) for s in range(d)]
    b_lens_global = np.zeros(max(m, 1), np.int64)
    for s in range(d):
        lo = s * b_rows_p
        ln = b_ptrs[s][1:] - b_ptrs[s][:-1]
        hi = min(lo + b_rows_p, m)
        b_lens_global[lo:hi] = ln[: hi - lo]

    # per dst: needed global B rows (distinct columns of its A slab)
    need = []
    cap = 1
    for t in range(d):
        _, cols, _ = _shard_entries(a, t, n)
        need.append(np.unique(cols))
        cap = max(cap, int(b_lens_global[cols].sum()))

    # per (src, dst) pair: entry positions (src side) + column ids (dst side)
    pos_lists = [[None] * d for _ in range(d)]
    exch = 1
    for t in range(d):
        rows_t = need[t]
        for s in range(d):
            if s == t:
                continue
            rs = rows_t[(rows_t >= s * b_rows_p) & (rows_t < (s + 1) * b_rows_p)]
            lr = rs - s * b_rows_p
            ptr = b_ptrs[s]
            segs = [np.arange(ptr[r], ptr[r + 1]) for r in lr]
            pos = np.concatenate(segs) if segs else np.zeros(0, np.int64)
            pos_lists[s][t] = (pos, rs)
            exch = max(exch, pos.size)

    send_pos = np.zeros((d, d, exch), np.int32)
    bi_gath = np.zeros((d, d, exch), np.int32)
    starts = np.zeros((d, max(m, 1)), np.int32)
    lens = np.zeros((d, max(m, 1)), np.int32)
    for t in range(d):
        off = 0
        for s in range(d):
            if s == t:
                continue
            pos, rs = pos_lists[s][t]
            send_pos[s, t, : pos.size] = pos
            bi_gath[t, s, : pos.size] = np.asarray(b.indices[s])[pos]
            # receiver offsets: rows arrive concatenated in row order at
            # s * exch within the recv block
            o = s * exch
            for r in rs:
                ln = int(b_lens_global[r])
                starts[t, r] = o
                lens[t, r] = ln
                o += ln
        # self rows: read from local storage appended after the recv block
        rows_t = need[t]
        own = rows_t[(rows_t >= t * b_rows_p) & (rows_t < (t + 1) * b_rows_p)]
        for r in own:
            lr = r - t * b_rows_p
            starts[t, r] = d * exch + int(b_ptrs[t][lr])
            lens[t, r] = int(b_lens_global[r])

    put = lambda x: put_sharded(x, mesh, a.axis)
    return PSpGEMMPlan(
        send_pos=put(send_pos),
        bi_gath=put(bi_gath),
        starts=put(starts),
        lens=put(lens),
        exch=exch,
        cap=cap,
        k=k,
    )


def pcsr_spgemm_aa(a: PCSR, b: PCSR, mesh: Mesh, plan: PSpGEMMPlan) -> PCSR:
    """C = A @ B via values-only all-to-all of the needed B rows.

    Communication: ``plan.comm_entries_per_device`` B values per device —
    O(nnz_B / D) for balanced patterns with column locality — vs the
    all-gather formulation's O(nnz_B).  Fully jit-compatible given the plan.
    """
    n, m = a.shape
    _, k = b.shape
    ax = a.axis
    rows_p = a.rows_per_shard
    cd, ci, cp = _pcsr_spgemm_aa_exec(
        a.data, a.indices, a.indptr, b.data, b.indices,
        plan.send_pos, plan.bi_gath, plan.starts, plan.lens,
        mesh=mesh, ax=ax, rows_p=rows_p, m=m, k=k, cap=plan.cap,
    )
    return PCSR(
        data=cd, indices=ci, indptr=cp, shape=(n, k), axis=ax,
        rows_per_shard=rows_p,
    )


@partial(
    jax.jit, static_argnames=("mesh", "ax", "rows_p", "m", "k", "cap")
)
def _pcsr_spgemm_aa_exec(a_data_g, a_idx_g, a_ptr_g, b_data_g, b_idx_g,
                         send_pos_g, bi_gath_g, starts_g, lens_g,
                         *, mesh, ax, rows_p, m, k, cap):
    def body(a_data, a_idx, a_ptr, b_data, b_idx, send_pos, bi_gath,
             starts, lens):
        send_buf = b_data[0][send_pos[0]]  # (D, E)
        recv = jax.lax.all_to_all(send_buf, ax, split_axis=0, concat_axis=0)
        # combined storage: [exchanged remote rows | full local shard slab]
        bd = jnp.concatenate([recv.reshape(-1), b_data[0]])
        bi = jnp.concatenate(
            [bi_gath[0].reshape(-1), b_idx[0].astype(jnp.int32)]
        )
        local_a = _local_csr(a_data[0], a_idx[0], a_ptr[0], rows_p, m)
        prods = spgemm_products(
            local_a, bd, bi, starts[0], lens[0].astype(INDEX_DTYPE), k, cap
        )
        c = csr_from_coo(
            COO(row=prods.row, col=prods.col, data=prods.data,
                shape=(rows_p, k))
        )
        return c.data[None], c.indices[None], c.indptr[None]

    f = shard_map(
        body,
        mesh=mesh,
        in_specs=(P(ax),) * 9,
        out_specs=(P(ax), P(ax), P(ax)),
    )
    return f(
        a_data_g, a_idx_g, a_ptr_g, b_data_g, b_idx_g,
        send_pos_g, bi_gath_g, starts_g, lens_g,
    )


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["send_pos", "perm", "indices", "indptr"],
    meta_fields=["exch", "shape", "axis", "rows_per_shard"],
)
@dataclasses.dataclass(frozen=True)
class PTransposePlan:
    """Static all-to-all plan for :func:`pcsr_transpose_device`.

    ``send_pos[s, t]``: positions in shard s's padded value storage whose
    entries land on shard t of A^T; ``perm``: per-dst gather map from the
    combined [recv | local | 0] value storage into the output CSR slot
    order; ``indices``/``indptr``: the (static) structure of A^T's shards."""

    send_pos: jax.Array  # (D, D, E) int32
    perm: jax.Array      # (D, nse_pT) int32
    indices: jax.Array   # (D, nse_pT)
    indptr: jax.Array    # (D, rows_pT + 1)
    exch: int
    shape: tuple[int, int]
    axis: str
    rows_per_shard: int

    @property
    def comm_entries_per_device(self) -> int:
        """all_to_all payload per device (D pair slots x padded pair width):
        O(nnz/D) for row partitions whose entries stay near their own column
        slab (bands), degrading toward O(nnz) under dense coupling — pinned
        by tests/test_comm_volume.py alongside the halo and SpGEMM plans."""
        return self.send_pos.shape[1] * self.exch


def build_transpose_plan(a: PCSR, mesh: Mesh) -> PTransposePlan:
    """Host-side symbolic pass for the device transpose (once per pattern)."""
    n, m = a.shape
    d = a.n_shards
    rows_p = a.rows_per_shard
    nse_p = a.nse_per_shard
    rows_pT = -(-max(m, 1) // d)

    # classify every valid entry of every shard by destination
    ent = []  # per src: (local_pos, global_row, col, dst)
    for s in range(d):
        lr, cols, pos = _shard_entries(a, s, n)
        g = s * rows_p + lr
        dst = np.minimum(cols // rows_pT, d - 1)
        ent.append((pos, g, cols, dst))

    exch = 1
    pair_pos = [[None] * d for _ in range(d)]
    for s in range(d):
        pos, g, cols, dst = ent[s]
        for t in range(d):
            sel = dst == t
            if s == t:
                pair_pos[s][t] = (pos[sel], g[sel], cols[sel])
                continue
            pair_pos[s][t] = (pos[sel], g[sel], cols[sel])
            exch = max(exch, int(sel.sum()))

    send_pos = np.zeros((d, d, exch), np.int32)
    recs = [[] for _ in range(d)]  # per dst: (rowT, colT, storage_index)
    for s in range(d):
        for t in range(d):
            pos, g, cols, = pair_pos[s][t]
            if s == t:
                # local entries: storage index = D*E + local position
                base_idx = d * exch + pos
            else:
                send_pos[s, t, : pos.size] = pos
                base_idx = s * exch + np.arange(pos.size)
            recs[t].append(
                (cols - t * rows_pT, g, base_idx)
            )

    nse_pT = 1
    per_dst = []
    for t in range(d):
        rT = np.concatenate([r[0] for r in recs[t]])
        cT = np.concatenate([r[1] for r in recs[t]])
        si = np.concatenate([r[2] for r in recs[t]])
        order = np.lexsort((cT, rT))
        rT, cT, si = rT[order], cT[order], si[order]
        per_dst.append((rT, cT, si))
        nse_pT = max(nse_pT, rT.size)

    perm = np.full((d, nse_pT), d * exch + nse_p, np.int32)  # -> appended 0
    indices = np.zeros((d, nse_pT), np.int32)
    indptr = np.zeros((d, rows_pT + 1), np.int32)
    for t in range(d):
        rT, cT, si = per_dst[t]
        perm[t, : si.size] = si
        indices[t, : cT.size] = cT
        cnt = np.bincount(rT, minlength=rows_pT)
        indptr[t, 1:] = np.cumsum(cnt)

    put = lambda x: put_sharded(x, mesh, a.axis)
    return PTransposePlan(
        send_pos=put(send_pos),
        perm=put(perm),
        indices=put(indices),
        indptr=put(indptr),
        exch=exch,
        shape=(m, n),
        axis=a.axis,
        rows_per_shard=rows_pT,
    )


@partial(jax.jit, static_argnames=("mesh", "ax"))
def _pcsr_transpose_exec(a_data_g, send_pos_g, perm_g, *, mesh, ax):
    def body(a_data, send_pos, perm):
        send_buf = a_data[0][send_pos[0]]  # (D, E)
        recv = jax.lax.all_to_all(send_buf, ax, split_axis=0, concat_axis=0)
        flat = jnp.concatenate(
            [recv.reshape(-1), a_data[0], jnp.zeros((1,), a_data.dtype)]
        )
        return flat[perm[0]][None]

    f = shard_map(
        body, mesh=mesh, in_specs=(P(ax),) * 3, out_specs=P(ax),
    )
    return f(a_data_g, send_pos_g, perm_g)


def pcsr_transpose_device(a: PCSR, mesh: Mesh, plan: PTransposePlan) -> PCSR:
    """A^T row-partitioned, computed on device: one values-only all_to_all
    (O(nnz/D) per device) + one gather into the plan's static structure.
    jit-compatible; replaces the host-side rebuild."""
    ax = a.axis
    vals = _pcsr_transpose_exec(
        a.data, plan.send_pos, plan.perm, mesh=mesh, ax=ax
    )
    return PCSR(
        data=vals,
        indices=plan.indices,
        indptr=plan.indptr,
        shape=plan.shape,
        axis=ax,
        rows_per_shard=plan.rows_per_shard,
    )

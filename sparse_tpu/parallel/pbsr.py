"""Distributed block SpGEMM for block-row partitioned BSR.

The block-granular mirror of ``parallel/pspgemm.py`` (SURVEY.md §2.3-3):
C = A @ B with both operands partitioned by contiguous block-row slabs
over a 1-D mesh.  The communication step is a *values-only* padded
``all_to_all`` of exactly the remote B block rows each shard's A column
pattern touches (blocks a shard already owns never enter the collective);
the numeric step is the single-device prepared block apply run per shard
— flat (F, bsz^2) products for small blocks, a batched einsum above
(formats/bsr.py).

Everything index-shaped is resolved host-side once per (pattern pair,
mesh) in :func:`build_pbsr_smsmm_plan`; the runtime step is one gather +
one ``all_to_all`` + the apply, fully jit-compatible.

Reference semantics per shard: blocked_square_regular.fut:336-363.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..formats.bsr import BSR, _flat_block_products
from ..ops.segmented import INDEX_DTYPE, segment_sum
from ..utils.precision import matmul_precision
from .pcsr import put_sharded

__all__ = [
    "PBSR",
    "pbsr_from_bsr",
    "pbsr_to_bsr",
    "PBsrSmsmmPlan",
    "build_pbsr_smsmm_plan",
    "pbsr_smsmm",
]


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["indices", "blocks"],
    meta_fields=["n", "bsz", "axis", "rows_per_shard"],
)
@dataclasses.dataclass(frozen=True)
class PBSR:
    """Block-row partitioned BSR: ``indices``: [D, nbz_p] flattened
    ``r_local * nb + c`` block coords (c global, sorted, sentinel
    ``rows_per_shard * nb`` padding); ``blocks``: [D, nbz_p, bsz, bsz].
    Shard d owns global block rows [d*rows_p, (d+1)*rows_p)."""

    indices: jax.Array
    blocks: jax.Array
    n: int
    bsz: int
    axis: str
    rows_per_shard: int

    @property
    def n_shards(self) -> int:
        return self.indices.shape[0]

    @property
    def nb(self) -> int:
        return self.n // self.bsz

    @property
    def nbz_per_shard(self) -> int:
        return self.indices.shape[1]

    @property
    def dtype(self):
        return self.blocks.dtype


def pbsr_from_bsr(a: BSR, mesh: Mesh, axis: str = "shards") -> PBSR:
    """Partition a BSR by contiguous block-row slabs (eager host pass;
    per-shard capacity = max slab block count)."""
    nb, bsz = a.nb, a.bsz
    d = mesh.shape[axis]
    rb = -(-max(nb, 1) // d)
    idx = np.asarray(a.indices).astype(np.int64)
    valid = idx < nb * nb
    r = np.where(valid, idx // max(nb, 1), 0)
    shard_of = np.where(valid, r // rb, d)
    blocks = np.asarray(a.blocks)
    nbz_p = max(int(np.bincount(shard_of, minlength=d + 1)[:d].max()), 1) \
        if idx.size else 1
    out_idx = np.full((d, nbz_p), rb * nb, np.int64)
    out_blk = np.zeros((d, nbz_p, bsz, bsz), blocks.dtype)
    for s in range(d):
        take = np.flatnonzero(shard_of == s)  # sorted -> local order sorted
        li = idx[take] - (s * rb) * nb
        out_idx[s, : take.size] = li
        out_blk[s, : take.size] = blocks[take]
    idt = np.int32 if rb * nb <= np.iinfo(np.int32).max else np.int64
    return PBSR(
        indices=put_sharded(out_idx.astype(idt), mesh, axis),
        blocks=put_sharded(out_blk, mesh, axis),
        n=a.n,
        bsz=bsz,
        axis=axis,
        rows_per_shard=rb,
    )


def pbsr_to_bsr(a: PBSR) -> BSR:
    """Gather shards back into a single-device BSR (eager; tests/debug)."""
    from ..formats.bsr import _bidx_dtype, _merge_blocks

    d, rb, nb, bsz = a.n_shards, a.rows_per_shard, a.nb, a.bsz
    idx = np.asarray(a.indices).astype(np.int64)
    blocks = np.asarray(a.blocks)
    gi, gb = [], []
    for s in range(d):
        valid = idx[s] < rb * nb
        li = idx[s][valid]
        gi.append(li + (s * rb) * nb)
        gb.append(blocks[s][valid])
    gi = np.concatenate(gi) if gi else np.zeros(0, np.int64)
    gb = np.concatenate(gb) if gb else np.zeros((0, bsz, bsz), blocks.dtype)
    order = np.argsort(gi, kind="stable")
    return BSR(
        indices=jnp.asarray(gi[order], _bidx_dtype(nb)),
        blocks=jnp.asarray(gb[order]),
        n=a.n,
        bsz=bsz,
    )


def _shard_blocks(p: PBSR, s: int):
    """(local_row, global_col, storage_pos) of shard ``s``'s valid blocks."""
    nb, rb = p.nb, p.rows_per_shard
    idx = np.asarray(p.indices[s]).astype(np.int64)
    pos = np.flatnonzero(idx < rb * nb)
    return idx[pos] // nb, idx[pos] % nb, pos


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["send_pos", "a_pos", "b_pos", "seg", "out_indices"],
    meta_fields=["exch", "cap", "nbz_out", "n", "bsz", "axis",
                 "rows_per_shard"],
)
@dataclasses.dataclass(frozen=True)
class PBsrSmsmmPlan:
    """Static plan for :func:`pbsr_smsmm` (one per pattern pair + mesh).

    ``send_pos[s, t]``: block storage slots of shard s to send to shard t
    (slot ``nbz_p`` pads with the appended zero block); per shard,
    ``a_pos``/``b_pos``/``seg`` are the local numeric schedule against the
    combined [recv (D*E) | local (nbz_p) | zero] B storage, padded to the
    cross-shard product capacity ``cap`` with zero-block products aimed at
    the dropped segment ``nbz_out``; ``out_indices``: the result PBSR's
    block coordinates (sentinel padded to ``nbz_out`` slots)."""

    send_pos: jax.Array   # (D, D, E) int32
    a_pos: jax.Array      # (D, cap) int32
    b_pos: jax.Array      # (D, cap) int32
    seg: jax.Array        # (D, cap) int32
    out_indices: jax.Array  # (D, nbz_out)
    exch: int
    cap: int
    nbz_out: int
    n: int
    bsz: int
    axis: str
    rows_per_shard: int

    @property
    def comm_entries_per_device(self) -> int:
        """Exchanged VALUES per device (block count x bsz^2)."""
        return self.send_pos.shape[1] * self.exch * self.bsz * self.bsz


def _pbsr_symbolic(a: PBSR, b: PBSR):
    """Shared host-side symbolic pass: per-shard exchange lists + product
    schedules.  Returns ``(send_lists, scheds, exch, cap, nbz_out)`` —
    ``scheds[t] = (a_pos, b_pos, seg, out_idx)`` against the combined
    ``[recv (D*exch) | local (nbz_p_b) | zero]`` B storage."""
    if a.n != b.n or a.bsz != b.bsz:
        raise ValueError(
            f"build_pbsr_smsmm_plan: incompatible operands "
            f"n={a.n}/{b.n} bsz={a.bsz}/{b.bsz}"
        )
    if a.axis != b.axis or a.n_shards != b.n_shards \
            or a.rows_per_shard != b.rows_per_shard:
        raise ValueError(
            "build_pbsr_smsmm_plan: operands must share mesh axis and "
            "partition"
        )
    d, rb, nb, bsz = a.n_shards, a.rows_per_shard, a.nb, a.bsz
    nbz_p_b = b.nbz_per_shard

    b_rows = [None] * d  # per shard: dict global_row -> (cols, pos)
    for s in range(d):
        r_l, c, pos = _shard_blocks(b, s)
        rows = {}
        for rr in np.unique(r_l):
            m = r_l == rr
            rows[int(rr + s * rb)] = (c[m], pos[m])
        b_rows[s] = rows

    a_parts = [_shard_blocks(a, t) for t in range(d)]

    # per (src, dst): which of src's B rows dst needs, in row order
    send_lists = [[None] * d for _ in range(d)]
    exch = 1
    for t in range(d):
        need = np.unique(a_parts[t][1])  # global block cols of A slab t
        for s in range(d):
            if s == t:
                continue
            rs = [int(r) for r in need[(need >= s * rb) & (need < (s + 1) * rb)]
                  if int(r) in b_rows[s]]
            pos = np.concatenate([b_rows[s][r][1] for r in rs]) if rs else \
                np.zeros(0, np.int64)
            send_lists[s][t] = (rs, pos)
            exch = max(exch, pos.size)

    # per shard: combined-storage offset of every needed B row, then the
    # product schedule (sorted by output block coordinate)
    scheds = []
    cap = 1
    nbz_out = 1
    for t in range(d):
        row_at = {}
        for s in range(d):
            if s == t:
                continue
            rs, _ = send_lists[s][t]
            off = s * exch
            for r in rs:
                row_at[r] = off
                off += b_rows[s][r][1].size
        for r, (cols, pos) in b_rows[t].items():
            row_at[r] = None  # local: positions offset by d*exch directly
        a_r, a_c, a_posn = a_parts[t]
        ap, bp, tgt = [], [], []
        for i in range(a_r.size):
            r_out = int(a_r[i])
            c_mid = int(a_c[i])
            holder = c_mid // rb
            if holder == t:
                ent = b_rows[t].get(c_mid)
                if ent is None:
                    continue
                cols_m, pos_m = ent
                bpos = d * exch + pos_m
            else:
                if c_mid not in row_at or row_at[c_mid] is None:
                    continue
                cols_m, _ = b_rows[holder][c_mid]
                bpos = row_at[c_mid] + np.arange(cols_m.size)
            ap.append(np.full(cols_m.size, a_posn[i]))
            bp.append(np.asarray(bpos))
            tgt.append(int(r_out) * nb + cols_m)
        if ap:
            ap = np.concatenate(ap)
            bp = np.concatenate(bp)
            tgt = np.concatenate(tgt)
            order = np.argsort(tgt, kind="stable")
            ap, bp, tgt = ap[order], bp[order], tgt[order]
            heads = np.ones(tgt.size, bool)
            heads[1:] = tgt[1:] != tgt[:-1]
            seg = np.cumsum(heads) - 1
            out_idx = tgt[heads]
        else:
            ap = bp = seg = np.zeros(0, np.int64)
            out_idx = np.zeros(0, np.int64)
        scheds.append((ap, bp, seg, out_idx))
        cap = max(cap, ap.size)
        nbz_out = max(nbz_out, out_idx.size)
    return send_lists, scheds, exch, cap, nbz_out


def build_pbsr_smsmm_plan(a: PBSR, b: PBSR, mesh: Mesh) -> PBsrSmsmmPlan:
    """Host-side symbolic pass (eager, once per pattern pair + mesh)."""
    send_lists, scheds, exch, cap, nbz_out = _pbsr_symbolic(a, b)
    d, rb, nb, bsz = a.n_shards, a.rows_per_shard, a.nb, a.bsz
    nbz_p_b = b.nbz_per_shard
    nbz_p_a = a.nbz_per_shard
    send_pos = np.full((d, d, exch), nbz_p_b, np.int32)  # pad: zero slot
    a_pos = np.full((d, cap), nbz_p_a, np.int32)
    b_pos = np.full((d, cap), d * exch + nbz_p_b, np.int32)  # zero slot
    seg = np.full((d, cap), nbz_out, np.int32)  # dropped segment
    out_indices = np.full((d, nbz_out), rb * nb, np.int64)
    for t in range(d):
        for s in range(d):
            if s == t:
                continue
            _, pos = send_lists[s][t]
            send_pos[s, t, : pos.size] = pos
        ap, bp, sg, oi = scheds[t]
        a_pos[t, : ap.size] = ap
        b_pos[t, : bp.size] = bp
        seg[t, : sg.size] = sg
        out_indices[t, : oi.size] = oi

    idt = np.int32 if rb * nb <= np.iinfo(np.int32).max else np.int64
    put = lambda x: put_sharded(x, mesh, a.axis)
    return PBsrSmsmmPlan(
        send_pos=put(send_pos),
        a_pos=put(a_pos),
        b_pos=put(b_pos),
        seg=put(seg),
        out_indices=put(out_indices.astype(idt)),
        exch=exch,
        cap=cap,
        nbz_out=nbz_out,
        n=a.n,
        bsz=bsz,
        axis=a.axis,
        rows_per_shard=rb,
    )


def pbsr_smsmm(a: PBSR, b: PBSR, mesh: Mesh, plan: PBsrSmsmmPlan) -> PBSR:
    """C = A @ B via values-only all-to-all of the needed B block rows.

    Communication: ``plan.comm_entries_per_device`` values per device —
    O(nnz_B / D) for banded block patterns — vs O(nnz_B) for an
    all-gather.  jit-compatible given the plan; deterministic."""
    blocks = _pbsr_smsmm_exec(
        a.blocks, b.blocks, plan.send_pos, plan.a_pos, plan.b_pos, plan.seg,
        mesh=mesh, ax=a.axis, bsz=a.bsz, nbz_out=plan.nbz_out,
        dtype=jnp.result_type(a.dtype, b.dtype),
    )
    return PBSR(
        indices=plan.out_indices,
        blocks=blocks,
        n=a.n,
        bsz=a.bsz,
        axis=a.axis,
        rows_per_shard=a.rows_per_shard,
    )


@partial(jax.jit, static_argnames=("mesh", "ax", "bsz", "nbz_out", "dtype"))
def _pbsr_smsmm_exec(a_blocks_g, b_blocks_g, send_pos_g, a_pos_g, b_pos_g,
                     seg_g, *, mesh, ax, bsz, nbz_out, dtype):
    b2 = bsz * bsz

    def body(a_blocks, b_blocks, send_pos, a_pos, b_pos, seg):
        # flat (N, bsz^2) block storage for the gathers and the exchange
        fa = jnp.concatenate(
            [a_blocks[0].reshape(-1, b2), jnp.zeros((1, b2), dtype)])
        fb_loc = b_blocks[0].reshape(-1, b2)
        fb_send = jnp.concatenate([fb_loc, jnp.zeros((1, b2), dtype)])
        send_buf = fb_send[send_pos[0]]  # (D, E, b2)
        recv = jax.lax.all_to_all(send_buf, ax, split_axis=0, concat_axis=0)
        comb = jnp.concatenate(
            [recv.reshape(-1, b2), fb_loc, jnp.zeros((1, b2), dtype)])
        ga = fa[a_pos[0]].astype(dtype)
        gb = comb[b_pos[0]].astype(dtype)
        if bsz <= 8:
            prods = _flat_block_products(ga, gb, bsz, dtype)
        else:
            prods = jnp.einsum(
                "fij,fjk->fik",
                ga.reshape(-1, bsz, bsz), gb.reshape(-1, bsz, bsz),
                preferred_element_type=dtype,
                precision=matmul_precision(dtype, dtype),
            ).reshape(-1, b2)
        out = segment_sum(
            prods, seg[0].astype(INDEX_DTYPE), nbz_out,
            indices_are_sorted=True,
        )
        return out.reshape(1, nbz_out, bsz, bsz)

    f = shard_map(
        body,
        mesh=mesh,
        in_specs=(P(ax),) * 6,
        out_specs=P(ax),
    )
    return f(a_blocks_g, b_blocks_g, send_pos_g, a_pos_g, b_pos_g, seg_g)

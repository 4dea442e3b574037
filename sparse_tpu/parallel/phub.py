"""Distributed hub/tail SpMV: partition the power-law class across a mesh.

Power-law (webbase-class) graphs have no locality a halo could exploit: a
row slab's columns span the whole column space.  What the class does have
is a heavy-tailed degree distribution — a thin strip of hub columns
carries a disproportionate share of the entries.  This module
row-partitions the matrix and splits each shard's slab into hub and tail:

* hub entries are remapped into a shared compact space ordered by
  descending degree; the hub OPERAND — the H top-degree entries of ``v``,
  which every shard references — is assembled by ONE ``all_gather`` of
  each shard's owned hub entries: **O(H) comm per device**;
* the tail's column support is dense in m on this class (that is why
  locality layouts fail), so the tail all-gathers the full operand — the
  honest O(m) term this class cannot avoid.

Comm accounting per device: ``H + m`` operand entries (vs ``m`` for
plain ``pcsr_spmv``) — the O(H) hub term is pinned by
tests/test_comm_volume-style assertions in tests/test_phub.py.

No reference counterpart (single-device reference, SURVEY.md §2.3).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..formats.csr import CSR
from ..ops.segmented import segment_sum
from .pcsr import put_sharded

__all__ = ["PHubSplit", "phub_partition", "phub_spmv", "DEFAULT_HUB_COLS"]

#: Default hub-strip width (columns).
DEFAULT_HUB_COLS = 16384


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["hub_data", "hub_idx", "hub_rows", "tail_data", "tail_idx",
                 "tail_rows", "own_hub_idx"],
    meta_fields=["shape", "axis", "rows_per_shard", "cols_per_shard",
                 "hub_cols_per_shard", "n_hub"],
)
@dataclasses.dataclass(frozen=True)
class PHubSplit:
    """Row-partitioned hub/tail split.

    Per shard (leading device axis): hub entries in (data, compact-hub
    col, local row) triples and tail entries in (data, global col, local
    row) triples, both padded with sentinel rows; ``own_hub_idx[d]``: the
    positions within shard d's OPERAND slab of the hub entries it owns
    (padded with 0 — the all_gather assembles the shared hub operand in
    degree order)."""

    hub_data: jax.Array   # (D, nse_hub_p)
    hub_idx: jax.Array    # (D, nse_hub_p) compact hub ids
    hub_rows: jax.Array   # (D, nse_hub_p) local rows (rows_p = dropped)
    tail_data: jax.Array  # (D, nse_tail_p)
    tail_idx: jax.Array   # (D, nse_tail_p) global cols
    tail_rows: jax.Array  # (D, nse_tail_p)
    own_hub_idx: jax.Array  # (D, hub_cols_per_shard)
    shape: tuple[int, int]
    axis: str
    rows_per_shard: int
    cols_per_shard: int
    hub_cols_per_shard: int
    n_hub: int

    @property
    def n_shards(self) -> int:
        return self.hub_data.shape[0]

    @property
    def hub_comm_entries_per_device(self) -> int:
        """The O(H) hub-operand assembly payload per device."""
        return self.n_shards * self.hub_cols_per_shard


def phub_partition(a: CSR, mesh: Mesh, axis: str = "shards",
                   max_hub_cols: int | None = None) -> PHubSplit:
    """Eager host split (once per pattern + mesh): contiguous row slabs;
    hubs = the ``max_hub_cols`` highest-degree columns (default
    :data:`DEFAULT_HUB_COLS`), compact space ordered by descending
    degree."""
    n, m = a.shape
    d = mesh.shape[axis]
    rows_p = -(-max(n, 1) // d)
    cols_p = -(-max(m, 1) // d)
    indptr = np.asarray(a.indptr, np.int64)
    k = int(indptr[-1])
    cols = np.asarray(a.indices[:k], np.int64)
    data = np.asarray(a.data[:k])
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))

    H = min(max_hub_cols if max_hub_cols is not None else DEFAULT_HUB_COLS,
            m)
    deg = np.bincount(cols, minlength=m)
    hub_ids = np.argpartition(deg, m - H)[m - H:] if H < m else \
        np.arange(m, dtype=np.int64)
    hub_ids = hub_ids[np.argsort(-deg[hub_ids], kind="stable")]
    is_hub = np.zeros(m, bool)
    is_hub[hub_ids] = True

    # operand ownership: shard s owns global operand entries
    # [s*cols_p, (s+1)*cols_p); its owned hub entries, at their positions
    # within the slab, in global degree order
    owner = hub_ids // cols_p
    hub_pc = max(int(np.bincount(owner, minlength=d).max()), 1) if H else 1
    own = np.zeros((d, hub_pc), np.int64)
    # gather layout: all_gather concatenates shards in order, so the
    # shared hub operand is [shard0's owned hubs | shard1's | ...]; the
    # compact remap must match that layout
    gathered_pos = np.zeros(H, np.int64)
    fill = np.zeros(d, np.int64)
    for j, c in enumerate(hub_ids):
        s = int(owner[j])
        own[s, fill[s]] = c - s * cols_p
        gathered_pos[j] = s * hub_pc + fill[s]
        fill[s] += 1
    compact_g = np.zeros(m, np.int64)
    compact_g[hub_ids] = gathered_pos  # compact id -> gathered position

    sel = is_hub[cols]

    def pack(mask, idx_map):
        caps = []
        per = []
        for s in range(d):
            lo, hi = min(s * rows_p, n), min((s + 1) * rows_p, n)
            in_slab = (rows >= lo) & (rows < hi) & mask
            per.append((data[in_slab], idx_map[cols[in_slab]],
                        rows[in_slab] - lo))
            caps.append(per[-1][0].size)
        cap = max(max(caps), 1)
        dv = np.zeros((d, cap), data.dtype)
        iv = np.zeros((d, cap), np.int64)
        rv = np.full((d, cap), rows_p, np.int64)  # sentinel -> dropped
        for s, (dd, ii, rr) in enumerate(per):
            dv[s, : dd.size] = dd
            iv[s, : ii.size] = ii
            rv[s, : rr.size] = rr
        return dv, iv.astype(np.int32), rv.astype(np.int32)

    hd, hi, hr = pack(sel, compact_g)
    td, ti, tr = pack(~sel, np.arange(m, dtype=np.int64))
    put = lambda x: put_sharded(x, mesh, axis)
    return PHubSplit(
        hub_data=put(hd), hub_idx=put(hi), hub_rows=put(hr),
        tail_data=put(td), tail_idx=put(ti), tail_rows=put(tr),
        own_hub_idx=put(own.astype(np.int32)),
        shape=(n, m), axis=axis, rows_per_shard=rows_p,
        cols_per_shard=cols_p, hub_cols_per_shard=hub_pc, n_hub=H,
    )


@partial(jax.jit, static_argnames=("mesh", "ax", "rows_p"))
def _phub_spmv_exec(hd, hi, hr, td, ti, tr, own, v, *, mesh, ax, rows_p):
    def body(hd, hi, hr, td, ti, tr, own, v_local):
        # O(H) hub-operand assembly: each shard contributes its owned hub
        # entries; the concatenated result IS the shared hub operand
        v_hub = jax.lax.all_gather(
            v_local[own[0]], ax, tiled=True)  # (D * hub_pc,)
        y = segment_sum(hd[0] * v_hub[hi[0]], hr[0], rows_p)
        # the tail's support is dense in m on this class (that is why
        # locality layouts fail) — the honest O(m) term
        v_full = jax.lax.all_gather(v_local, ax, tiled=True)
        y = y + segment_sum(td[0] * v_full[ti[0]], tr[0], rows_p)
        return y[None]

    f = shard_map(
        body,
        mesh=mesh,
        in_specs=(P(ax),) * 8,
        out_specs=P(ax),
    )
    return f(hd, hi, hr, td, ti, tr, own, v)


def phub_spmv(a: PHubSplit, v: jax.Array, mesh: Mesh) -> jax.Array:
    """Distributed hub/tail SpMV; ``v`` sharded to ``cols_per_shard * D``
    (``shard_vector``), output padded row-sharded.  The hub mass rides the
    O(H) assembled operand; the per-shard compute is a gather +
    segment-sum for both parts."""
    return _phub_spmv_exec(
        a.hub_data, a.hub_idx, a.hub_rows,
        a.tail_data, a.tail_idx, a.tail_rows,
        a.own_hub_idx, v,
        mesh=mesh, ax=a.axis, rows_p=a.rows_per_shard,
    ).reshape(-1)

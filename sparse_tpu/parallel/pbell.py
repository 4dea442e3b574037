"""Block-row-partitioned blocked-ELL over a 1-D mesh: the distributed fast
path for block-structured matrices (BASELINE.md config 5 covers CSR *and*
BSR partitioning; this is the BSR-family variant, stored as BELL so each
shard runs the scatter-free blocked kernel locally).

Same communication structure as ``pcsr``: operand sharded over the mesh
axis, one all-gather inside ``shard_map``, outputs stay row-sharded.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..formats.bell import BELL
from .pcsr import put_sharded
from ..utils.precision import matmul_precision

__all__ = [
    "PBELL",
    "pbell_from_bell",
    "pbell_shard_vector",
    "pbell_smvm",
    "pbell_spmm",
]


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["cols", "blocks"],
    meta_fields=["n", "bsz", "axis", "rows_per_shard"],
)
@dataclasses.dataclass(frozen=True)
class PBELL:
    """Block-row partitioned BELL: ``blocks``: [D, rows_p, Lb, bsz, bsz];
    ``cols``: [D, rows_p, Lb] global block-column ids.  Shard d owns block
    rows [d*rows_p, (d+1)*rows_p); padding rows hold zero blocks."""

    cols: jax.Array
    blocks: jax.Array
    n: int
    bsz: int
    axis: str
    rows_per_shard: int

    @property
    def n_shards(self) -> int:
        return self.cols.shape[0]

    @property
    def Lb(self) -> int:
        return self.cols.shape[2]


def pbell_from_bell(a: BELL, mesh: Mesh, axis: str = "shards") -> PBELL:
    """Partition a BELL by contiguous block-row slabs (eager)."""
    d = mesh.shape[axis]
    nb = a.nb
    rows_p = -(-max(nb, 1) // d)
    cols = np.zeros((d, rows_p, a.Lb), np.int32)
    blocks = np.zeros((d, rows_p, a.Lb, a.bsz, a.bsz), np.asarray(a.blocks).dtype)
    ac = np.asarray(a.cols)
    ab = np.asarray(a.blocks)
    for i in range(d):
        lo, hi = min(i * rows_p, nb), min((i + 1) * rows_p, nb)
        cols[i, : hi - lo] = ac[lo:hi]
        blocks[i, : hi - lo] = ab[lo:hi]
    return PBELL(
        cols=put_sharded(cols, mesh, axis),
        blocks=put_sharded(blocks, mesh, axis),
        n=a.n,
        bsz=a.bsz,
        axis=axis,
        rows_per_shard=rows_p,
    )


def pbell_shard_vector(v: jax.Array, a: PBELL, mesh: Mesh) -> jax.Array:
    """Pad a dense operand's leading axis to ``rows_p * D * bsz`` and shard
    it over the mesh axis (block-row padding differs from the scalar-row
    padding of ``pcsr``'s ``shard_vector``)."""
    v = jnp.asarray(v)
    total = a.rows_per_shard * a.n_shards * a.bsz
    pad = total - v.shape[0]
    if pad:
        v = jnp.concatenate([v, jnp.zeros((pad,) + v.shape[1:], v.dtype)])
    return put_sharded(v, mesh, a.axis)


@partial(jax.jit, static_argnames=("mesh", "ax", "nb_pad", "rows_p", "Lb", "bsz"))
def _pbell_smvm_exec(cols_g, blocks_g, v, *, mesh, ax, nb_pad, rows_p, Lb, bsz):
    def body(cols, blocks, v_local):
        v_full = jax.lax.all_gather(v_local, ax, tiled=True)
        v2 = v_full.reshape(nb_pad, bsz)
        c = cols[0]  # (rows_p, Lb)
        vb = v2[c.reshape(-1)].reshape(rows_p, Lb, bsz)
        out = jnp.einsum("rlij,rlj->ri", blocks[0], vb,
                         precision=matmul_precision(blocks.dtype, vb.dtype))
        return out.reshape(1, rows_p * bsz)

    f = shard_map(
        body,
        mesh=mesh,
        in_specs=(P(ax), P(ax), P(ax)),
        out_specs=P(ax),
    )
    return f(cols_g, blocks_g, v)


def pbell_smvm(a: PBELL, v: jax.Array, mesh: Mesh) -> jax.Array:
    """Distributed blocked SpMV: ``v`` padded to ``rows_p*D*bsz`` and sharded
    (see ``shard_vector``); output stays row-sharded with the same padding."""
    return _pbell_smvm_exec(
        a.cols, a.blocks, v, mesh=mesh, ax=a.axis,
        nb_pad=a.rows_per_shard * a.n_shards, rows_p=a.rows_per_shard,
        Lb=a.Lb, bsz=a.bsz,
    ).reshape(-1)


@partial(jax.jit, static_argnames=("mesh", "ax", "nb_pad", "rows_p", "Lb", "bsz"))
def _pbell_spmm_exec(cols_g, blocks_g, b, *, mesh, ax, nb_pad, rows_p, Lb, bsz):
    def body(cols, blocks, b_local):
        b_full = jax.lax.all_gather(b_local, ax, tiled=True)
        k = b_full.shape[1]
        b3 = b_full.reshape(nb_pad, bsz, k)
        c = cols[0]
        panels = b3[c.reshape(-1)].reshape(rows_p, Lb, bsz, k)
        out = jnp.einsum("rlij,rljk->rik", blocks[0], panels,
                         precision=matmul_precision(blocks.dtype, panels.dtype))
        return out.reshape(1, rows_p * bsz, k)

    f = shard_map(
        body,
        mesh=mesh,
        in_specs=(P(ax), P(ax), P(ax)),
        out_specs=P(ax),
    )
    return f(cols_g, blocks_g, b)


def pbell_spmm(a: PBELL, b: jax.Array, mesh: Mesh) -> jax.Array:
    """Distributed blocked SpMM; ``b`` row-sharded with the same padding."""
    out = _pbell_spmm_exec(
        a.cols, a.blocks, b, mesh=mesh, ax=a.axis,
        nb_pad=a.rows_per_shard * a.n_shards, rows_p=a.rows_per_shard,
        Lb=a.Lb, bsz=a.bsz,
    )
    return out.reshape(-1, b.shape[1])

"""The distributed matvec paths and CG through ``dist_spmv``, on a 4-device
virtual CPU mesh (the card layout the multi-device path targets).

Oracle style follows the house rules (dense references, cross-path
agreement); no reference counterpart exists (single-device reference,
SURVEY.md §2.3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sparse_tpu import csr_from_dense
from sparse_tpu.formats.bsr import BSR, bsr_todense
from sparse_tpu.ops.segmented import INDEX_DTYPE
from sparse_tpu.parallel import (
    build_pbsr_smsmm_plan,
    cg_solve,
    dist_spmv,
    halo_partition,
    halo_partition_overlapped,
    make_1d_mesh,
    pbsr_from_bsr,
    pbsr_smsmm,
    pbsr_to_bsr,
    pcsr_from_csr,
)
from sparse_tpu.parallel.pcsr import shard_vector

PARTITIONS = {
    "pcsr": pcsr_from_csr,
    "halo": halo_partition,
    "halo_overlap": halo_partition_overlapped,
}


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 4, "expected virtual CPU devices"
    return make_1d_mesh(4)


def banded_csr(n, seed, bw=12, per_row=6, rows=None):
    rng = np.random.default_rng(seed)
    x = np.zeros((n, n), np.float32)
    for i in range(n if rows is None else rows):
        js = np.clip(i + rng.integers(-bw, bw + 1, size=per_row), 0, n - 1)
        x[i, js] = rng.standard_normal(js.size)
    return csr_from_dense(jnp.asarray(x)), x


@pytest.mark.parametrize("kind", sorted(PARTITIONS))
@pytest.mark.parametrize("shape", ["banded", "skewed"])
def test_dist_spmv_matches_oracle(mesh, kind, shape):
    # "skewed": entries only in the first quarter of the rows, so three of
    # four shards hold no entries at all
    n = 200
    a, x = banded_csr(n, seed=0, rows=None if shape == "banded" else n // 4)
    pa = pcsr_from_csr(a, mesh)
    part = PARTITIONS[kind](a, mesh)
    v = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    vsh = shard_vector(jnp.asarray(v), pa, mesh)
    got = np.asarray(dist_spmv(part, vsh, mesh))[:n]
    np.testing.assert_allclose(got, x @ v, rtol=1e-5, atol=1e-5)
    if kind != "pcsr":
        # the halo payload never exceeds the all-gather volume
        assert part.comm_entries_per_device <= 4 * (-(-n // 4))


@pytest.mark.parametrize("kind", sorted(PARTITIONS))
def test_cg_through_dist_spmv_fast_path(mesh, kind):
    """The solvers accept any partitioned type via dist_spmv; CG over each
    matches the dense solve."""
    n = 96
    rng = np.random.default_rng(5)
    x = rng.standard_normal((n, n)).astype(np.float32) * (
        rng.random((n, n)) < 0.2
    )
    spd = (x @ x.T + n * np.eye(n)).astype(np.float32)
    a = csr_from_dense(jnp.asarray(spd))
    pa = pcsr_from_csr(a, mesh)
    b_np = rng.standard_normal(n).astype(np.float32)
    b = shard_vector(jnp.asarray(b_np), pa, mesh)
    x_fast = np.asarray(cg_solve(PARTITIONS[kind](a, mesh), b, mesh,
                                 iters=25))[:n]
    np.testing.assert_allclose(
        x_fast, np.linalg.solve(spd.astype(np.float64), b_np), rtol=2e-3,
        atol=2e-3,
    )
    # dispatch errors loudly on unsupported types
    with pytest.raises(TypeError, match="dist_spmv"):
        dist_spmv(object(), b, mesh)


def _random_pbsr_pair(nb, bsz, density, seed):
    rng = np.random.default_rng(seed)
    mats = []
    for _ in range(2):
        rr, cc = np.nonzero(rng.random((nb, nb)) < density)
        mats.append(BSR(
            indices=jnp.asarray(rr * nb + cc, INDEX_DTYPE),
            blocks=jnp.asarray(
                rng.standard_normal((rr.size, bsz, bsz)).astype(np.float32)),
            n=nb * bsz,
            bsz=bsz,
        ))
    return mats


@pytest.mark.parametrize("bsz", [2, 8, 32])
def test_pbsr_smsmm_matches(mesh, bsz):
    a, b = _random_pbsr_pair(nb=16, bsz=bsz, density=0.25, seed=bsz)
    pa, pb = pbsr_from_bsr(a, mesh), pbsr_from_bsr(b, mesh)
    plan = build_pbsr_smsmm_plan(pa, pb, mesh)
    c = bsr_todense(pbsr_to_bsr(pbsr_smsmm(pa, pb, mesh, plan)))
    oracle = np.asarray(bsr_todense(a)) @ np.asarray(bsr_todense(b))
    np.testing.assert_allclose(np.asarray(c), oracle, rtol=1e-4, atol=1e-4)
    # values-only exchange: payload bounded by the all-gather volume
    tot_blocks = int(np.asarray(pb.indices).size)
    assert plan.comm_entries_per_device <= tot_blocks * bsz * bsz

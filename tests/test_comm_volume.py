"""Communication-volume bounds for the distributed plans (SURVEY.md §2.3).

CPU weak-scaling times on an oversubscribed host are noise, so the
*scaling claims* of the distributed layer are
asserted structurally instead: each plan exposes its all_to_all payload
(``comm_entries_per_device``), and these tests pin the O(halo) / O(nnz/D)
bounds on a banded pattern against the O(m) all-gather / O(nnz_B)
replication baselines — and check that a dense-coupled pattern degrades
toward the baseline, i.e. the metric measures coupling, not array sizes.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from sparse_tpu import CSR, csr_from_dense
from sparse_tpu.parallel import (
    halo_partition,
    halo_partition_overlapped,
    make_1d_mesh,
    pcsr_from_csr,
)
from sparse_tpu.parallel.pspgemm import (
    build_pspgemm_plan,
    build_transpose_plan,
)

D = 8


@pytest.fixture(autouse=True)
def _needs_devices():
    """Decided per test (never at import time, so xdist workers collect
    the same tests)."""
    if len(jax.devices()) < D:
        pytest.skip(f"needs {D} virtual devices")


def _banded(n, half_width, seed=0, per_row=8):
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n, dtype=np.int64), per_row)
    cols = np.clip(rows + rng.integers(-half_width, half_width + 1, rows.size),
                   0, n - 1)
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    keep = np.ones(rows.size, bool)
    keep[1:] = (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1])
    rows, cols = rows[keep], cols[keep]
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=indptr[1:])
    vals = rng.standard_normal(rows.size).astype(np.float32)
    return CSR(
        data=jnp.asarray(vals),
        indices=jnp.asarray(cols.astype(np.int32)),
        indptr=jnp.asarray(indptr.astype(np.int32)),
        shape=(n, n),
    )


def _dense_coupled(n, seed=1, density=0.4):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, n)) * (rng.random((n, n)) < density)).astype(
        np.float32
    )
    return csr_from_dense(jnp.asarray(x))


def test_halo_comm_is_o_halo_not_o_m():
    """Banded half-width w: each shard's remote frontier is <= 2w columns,
    so the all_to_all payload D*halo must sit far below the all-gather
    baseline of m entries per device (pcsr_spmv's robust path)."""
    n, w = 1024, 16
    a = _banded(n, w)
    mesh = make_1d_mesh(D)
    plan = halo_partition_overlapped(a, mesh)
    # frontier columns of a row slab lie within w of its boundary rows
    assert plan.halo <= 2 * w + 2
    assert plan.comm_entries_per_device <= D * (2 * w + 2)
    assert plan.comm_entries_per_device < n // 2  # far below all-gather O(m)

    # non-overlapped plan: payload additionally carries the shard's own
    # slab round-trip, still O(w) per pair on a band
    full = halo_partition(a, mesh)
    assert full.comm_entries_per_device <= D * (full.cols_per_shard)
    assert full.halo <= full.cols_per_shard


def test_halo_comm_degrades_with_coupling():
    """A dense-coupled pattern must report (near-)baseline communication:
    the metric reflects the pattern, not the partition bookkeeping."""
    n = 512
    banded = halo_partition_overlapped(_banded(n, 8), make_1d_mesh(D))
    dense = halo_partition_overlapped(_dense_coupled(n), make_1d_mesh(D))
    # dense coupling: each shard needs essentially every remote column
    assert dense.comm_entries_per_device > (D - 1) * dense.cols_per_shard // 2
    # and the banded plan is at least 4x cheaper
    assert banded.comm_entries_per_device * 4 < dense.comm_entries_per_device


def test_pspgemm_comm_is_o_needed_rows_not_o_nnz_b():
    """Distributed SpGEMM ships only the B rows each shard's A slab names
    (padded per pair): on a band that is O(slab + 2w) rows per device,
    far below replicating B's nnz everywhere (the all-gather baseline)."""
    n, w = 1024, 16
    a = _banded(n, w, seed=3)
    mesh = make_1d_mesh(D)
    pa = pcsr_from_csr(a, mesh)
    plan = build_pspgemm_plan(pa, pa, mesh)
    nnz_b = int(np.asarray(a.indptr)[-1])
    assert plan.comm_entries_per_device < nnz_b // 2
    # banded slabs name only neighbour rows: the padded per-pair width is
    # bounded by the widest pair's remote need (<= slab rows + 2w entries)
    rows_per_shard = -(-n // D)
    per_pair_bound = (rows_per_shard + 2 * w + 2) * 9  # max B row len = 9
    assert plan.exch <= per_pair_bound

    # dense coupling degrades toward replication
    ad = _dense_coupled(512, seed=4)
    pad = pcsr_from_csr(ad, make_1d_mesh(D))
    pland = build_pspgemm_plan(pad, pad, make_1d_mesh(D))
    nnz_bd = int(np.asarray(ad.indptr)[-1])
    assert pland.comm_entries_per_device > nnz_bd // 4


def test_ptranspose_comm_is_o_nnz_over_d_not_o_nnz():
    """The device transpose ships each entry's VALUE to the shard owning its
    column — on a band, a row slab's columns stay within w of the slab, so
    only ~2w boundary rows' entries cross shards: the padded payload must sit
    far below replicating A (the host-rebuild / all-gather baseline of nnz
    entries per device).  Ref: SURVEY.md §2.3-3."""
    n, w, per_row = 1024, 4, 8
    a = _banded(n, w, seed=5, per_row=per_row)
    mesh = make_1d_mesh(D)
    pa = pcsr_from_csr(a, mesh)
    plan = build_transpose_plan(pa, mesh)
    nnz = int(np.asarray(a.indptr)[-1])
    # per-pair width: only rows within w of a slab boundary can own entries
    # whose column lands on the neighbouring shard
    assert plan.exch <= (2 * w + 2) * per_row
    assert plan.comm_entries_per_device < nnz // 4

    # dense coupling: every entry crosses with probability (D-1)/D, so the
    # payload approaches the per-shard storage ceiling nnz/D x D pair slots
    # (each entry ships exactly once — the transpose baseline is replicating
    # A at nnz per device, which even dense coupling beats by ~D)
    ad = _dense_coupled(512, seed=6)
    pad = pcsr_from_csr(ad, make_1d_mesh(D))
    pland = build_transpose_plan(pad, make_1d_mesh(D))
    nnz_d = int(np.asarray(ad.indptr)[-1])
    assert pland.comm_entries_per_device > nnz_d // 10  # ~nnz/D, padded
    # and the banded plan is far cheaper relative to its nnz
    banded_frac = plan.comm_entries_per_device / nnz
    dense_frac = pland.comm_entries_per_device / nnz_d
    assert banded_frac * 4 < dense_frac

"""Wide (int64) BSR block coordinates: nb beyond the int32 range.

A 400k-row matrix at bsz=2 has nb = 200k block rows, so flattened block
coordinates r*nb+c overflow int32 (the round-3/4 routing guard refused
such matrices).  With jax x64 (enabled in conftest), BSR transparently
switches its ``indices`` to int64; every op must keep working and the
SpGEMM dispatchers may route.  Reference semantics unchanged
(blocked_square_regular.fut:179-183, 336-363).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

import sparse_tpu as st
from sparse_tpu.formats.bsr import BSR_MAX_NB, _bidx_dtype

BSZ = 2
NB = 50_000  # > BSR_MAX_NB = 46340
N = NB * BSZ


def wide_bsr(seed=0, nblk=12):
    """A few blocks scattered across a wide coordinate space, including
    coordinates whose flattened value exceeds 2**31."""
    rng = np.random.default_rng(seed)
    r = np.sort(rng.choice(NB, nblk, replace=False))
    c = (r + rng.integers(-3, 4, nblk)) % NB
    blocks = rng.standard_normal((nblk, BSZ, BSZ))
    entries = [(int(ri), int(ci), blocks[i]) for i, (ri, ci) in
               enumerate(zip(r, c))]
    return st.bsr_make(N, BSZ, entries, dtype=jnp.float64), entries


def test_dtype_switches_wide():
    assert _bidx_dtype(BSR_MAX_NB) == jnp.int32
    assert _bidx_dtype(BSR_MAX_NB + 1) == jnp.int64
    a, _ = wide_bsr()
    assert a.indices.dtype == jnp.int64
    assert int(jnp.max(jnp.where(a.indices < a.sentinel, a.indices, 0))) \
        > 2**31  # actually exercises the wide range


def test_smvm_matches_manual():
    a, entries = wide_bsr()
    v = np.random.default_rng(1).standard_normal(N)
    ref = np.zeros(N)
    for r, c, blk in entries:
        ref[r * BSZ:(r + 1) * BSZ] += np.asarray(blk) @ v[c * BSZ:(c + 1) * BSZ]
    got = np.asarray(st.bsr_smvm(a, jnp.asarray(v)))
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)


def test_transpose_roundtrip_and_add():
    a, entries = wide_bsr()
    att = st.bsr_transpose(st.bsr_transpose(a))
    assert np.array_equal(np.asarray(att.indices), np.asarray(a.indices))
    np.testing.assert_allclose(np.asarray(att.blocks), np.asarray(a.blocks))
    s = st.bsr_add(a, a)
    v = np.random.default_rng(2).standard_normal(N)
    np.testing.assert_allclose(
        np.asarray(st.bsr_smvm(s, jnp.asarray(v))),
        2 * np.asarray(st.bsr_smvm(a, jnp.asarray(v))),
        rtol=1e-12,
    )
    m = st.bsr_mul(a, a)
    assert m.indices.dtype == jnp.int64
    np.testing.assert_allclose(
        np.asarray(m.blocks), np.asarray(a.blocks) ** 2, rtol=1e-12
    )


def test_smsmm_prepared_and_pallas():
    # A @ A^T guarantees some products exist (diagonal of the product)
    a, _ = wide_bsr(seed=3, nblk=10)
    b = st.bsr_transpose(a)
    plan = st.bsr_smsmm_prepare(a, b)
    assert plan.indices.dtype == jnp.int64
    assert plan.n_products > 0
    c = st.bsr_smsmm_apply(plan, a, b)
    # oracle: scipy on the scalar view
    import scipy.sparse as sp

    def to_scipy(m):
        coo = st.bsr_to_coo(m)
        keep = np.asarray(coo.row) < m.n
        return sp.coo_matrix(
            (np.asarray(coo.data)[keep],
             (np.asarray(coo.row)[keep], np.asarray(coo.col)[keep])),
            shape=(m.n, m.n),
        ).tocsr()
    ref = to_scipy(a) @ to_scipy(b)
    got = to_scipy(c)
    assert abs(got - ref).max() < 1e-10


def test_from_coo_to_csr_roundtrip():
    a, entries = wide_bsr(seed=4)
    coo = st.bsr_to_coo(a)
    back = st.bsr_from_coo(coo, BSZ)
    v = np.random.default_rng(5).standard_normal(N)
    np.testing.assert_allclose(
        np.asarray(st.bsr_smvm(back, jnp.asarray(v))),
        np.asarray(st.bsr_smvm(a, jnp.asarray(v))),
        rtol=1e-12,
    )
    csr = st.bsr_to_csr(a)
    got = np.asarray(csr @ jnp.asarray(v))
    np.testing.assert_allclose(
        got, np.asarray(st.bsr_smvm(a, jnp.asarray(v))), rtol=1e-12
    )


def test_spgemm_auto_routes_wide():
    # clustered scalar CSR beyond the int32 block range must take the
    # block route now that wide indices exist (both patterns fully dense
    # 2x2 blocks, nnz above the route floor)
    from sparse_tpu.ops.spgemm import _spgemm_route

    rng = np.random.default_rng(6)
    nb_used = 1200  # 4800 nnz >= _BLOCK_ROUTE_MIN_NNZ
    r = np.sort(rng.choice(NB, nb_used, replace=False))
    rows = np.repeat(r * BSZ, 2 * BSZ) + np.tile([0, 0, 1, 1], nb_used)
    cols = np.repeat(r * BSZ, 2 * BSZ) + np.tile([0, 1, 0, 1], nb_used)
    data = rng.standard_normal(rows.size)
    import scipy.sparse as sp

    A = sp.coo_matrix((data, (rows, cols)), shape=(N, N)).tocsr()
    a = st.CSR(
        data=jnp.asarray(A.data),
        indices=jnp.asarray(A.indices.astype(np.int32)),
        indptr=jnp.asarray(A.indptr.astype(np.int32)),
        shape=(N, N),
    )
    method, bsz = _spgemm_route(a, a)
    assert method == "block" and bsz == BSZ
    c = st.spgemm(a, a, method="auto")
    ref = A @ A
    got = sp.csr_matrix(
        (np.asarray(c.data), np.asarray(c.indices), np.asarray(c.indptr)),
        shape=(N, N),
    )
    assert abs(got - ref).max() < 1e-10


def test_bell_from_wide_bsr():
    # BELL stores per-axis block-column ids (no flattened coordinate), so
    # the SpMV fast path must work beyond the int32 nb range too
    from sparse_tpu.formats.bell import bell_from_bsr, bell_smvm

    a, entries = wide_bsr(seed=9, nblk=8)
    bell = bell_from_bsr(a)
    v = np.random.default_rng(10).standard_normal(N)
    ref = np.zeros(N)
    for r, c, blk in entries:
        ref[r * BSZ:(r + 1) * BSZ] += np.asarray(blk) @ v[c * BSZ:(c + 1) * BSZ]
    np.testing.assert_allclose(
        np.asarray(bell_smvm(bell, jnp.asarray(v))), ref, rtol=1e-12,
        atol=1e-12,
    )


def test_narrow_unaffected():
    # matrices within the int32 range keep int32 indices
    a = st.bsr_eye(64, 8)
    assert a.indices.dtype == jnp.int32
    m = st.bsr_make(64, 8, [(0, 1, np.ones((8, 8))), (3, 2, np.eye(8))])
    assert m.indices.dtype == jnp.int32

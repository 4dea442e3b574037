"""One-call SpMV dispatch (ops/dispatch.py): the ladder picks the right
rung per structure class, and every rung's apply matches SciPy."""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

import sparse_tpu as st
from sparse_tpu.ops.dispatch import smvm_prepare

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "benchmarks"))
import gen_fixtures  # noqa: E402


def _block_matrix(nb, bsz, seed, per_row=3):
    """Square matrix of dense bsz x bsz blocks, a few per block row."""
    rng = np.random.default_rng(seed)
    mask = np.zeros((nb, nb), bool)
    for r in range(nb):
        mask[r, rng.choice(nb, size=min(per_row, nb), replace=False)] = True
    x = rng.standard_normal((nb * bsz, nb * bsz)) * np.kron(
        mask, np.ones((bsz, bsz)))
    return sp.csr_matrix(x.astype(np.float32))


def _band(n, hw, seed):
    rng = np.random.default_rng(seed)
    return sp.diags([rng.standard_normal(n - abs(o)).astype(np.float32)
                     for o in range(-hw, hw + 1)],
                    list(range(-hw, hw + 1)), format="csr")


def _empty_rows(seed):
    s = sp.random(96, 96, density=0.06, random_state=seed, format="lil",
                  dtype=np.float32)
    s[10:20, :] = 0
    return s.tocsr()


ZOO = {
    "band": lambda: _band(300, 4, 0),
    "fem_poisson": lambda: gen_fixtures.poisson_fem(600, seed=0),
    "fem_elasticity": lambda: gen_fixtures.elasticity_fem(300, seed=1),
    "powerlaw": lambda: gen_fixtures.powerlaw_graph(400, m=4, seed=2),
    "rectangular": lambda: sp.random(80, 130, density=0.05, random_state=3,
                                     format="csr", dtype=np.float32),
    "empty_rows": lambda: _empty_rows(4),
    "blocks_bsz8": lambda: _block_matrix(12, 8, seed=5),
    "blocks_bsz16": lambda: _block_matrix(6, 16, seed=6),
    "blocks_bsz32": lambda: _block_matrix(4, 32, seed=7),
}
_BELL = {"blocks_bsz8", "blocks_bsz16", "blocks_bsz32"}


def _to_csr(s):
    s = sp.csr_matrix(s)
    s.sum_duplicates()
    return st.CSR(data=jnp.asarray(s.data), indices=jnp.asarray(s.indices),
                  indptr=jnp.asarray(s.indptr.astype(np.int64)),
                  shape=s.shape)


@pytest.mark.parametrize("name", sorted(ZOO))
@pytest.mark.parametrize("prefer", [None, "bell", "xla"])
def test_smvm_prepare_zoo_matches_scipy(name, prefer):
    s = ZOO[name]()
    dtype = np.float64 if jax.config.jax_enable_x64 else np.float32
    s = sp.csr_matrix(s, dtype=dtype)
    plan = smvm_prepare(_to_csr(s), prefer=prefer)
    want_kind = "bell" if (name in _BELL and prefer != "xla") else "xla"
    assert plan.kind == want_kind
    v = np.random.default_rng(1).standard_normal(s.shape[1]).astype(dtype)
    y = np.asarray(jax.jit(lambda p, v: p.apply(v))(plan, jnp.asarray(v)))
    want = s @ v
    assert y.shape == (s.shape[0],)
    np.testing.assert_allclose(y, want, rtol=1e-10,
                               atol=1e-10 * np.abs(want).max())


def test_dispatch_bell():
    s = _block_matrix(12, 8, seed=4)
    plan = smvm_prepare(_to_csr(s), verbose=True)
    assert plan.kind == "bell" and plan.state[0].bsz == 8
    v = np.random.default_rng(1).standard_normal(s.shape[1]).astype(np.float32)
    np.testing.assert_allclose(np.asarray(plan.apply(jnp.asarray(v))),
                               s @ v, rtol=2e-4, atol=2e-4)


def test_dispatch_refresh():
    """plan.refresh rebinds values on the value-free XLA rung; the BELL
    rung refuses with guidance; a wrong-length value array is refused."""
    s = _band(160, 3, seed=11)
    a = _to_csr(s)
    px = smvm_prepare(a, prefer="xla")
    v = np.random.default_rng(2).standard_normal(160)
    y2 = np.asarray(px.refresh(a.data * 2.0).apply(jnp.asarray(v)))
    np.testing.assert_allclose(y2, (s * 2.0) @ v, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="data shape"):
        px.refresh(a.data[:-1])
    pb = smvm_prepare(_to_csr(_block_matrix(6, 8, seed=1)))
    assert pb.kind == "bell"
    with pytest.raises(NotImplementedError, match="re-run smvm_prepare"):
        pb.refresh(pb.state[0].blocks.reshape(-1))


def test_dispatch_rejects_unknown_rung():
    with pytest.raises(ValueError, match="unknown rung"):
        smvm_prepare(_to_csr(_band(10, 1, 0)), prefer="segtile")

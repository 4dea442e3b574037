"""Blocked-ELL (BELL) format vs BSR/dense oracles."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sparse_tpu import bsr_from_dense
from sparse_tpu.formats.bell import bell_from_bsr, bell_smvm, bell_spmm, bell_todense


def random_bsr(n, bsz, density, seed):
    rng = np.random.default_rng(seed)
    nb = n // bsz
    mask = np.kron(rng.random((nb, nb)) < density, np.ones((bsz, bsz)))
    x = rng.standard_normal((n, n)) * mask
    return bsr_from_dense(jnp.asarray(x), bsz), x


@pytest.mark.parametrize("n,bsz,density", [(16, 2, 0.6), (32, 8, 0.3), (64, 4, 0.15)])
def test_bell_roundtrip_and_smvm(n, bsz, density):
    a, xa = random_bsr(n, bsz, density, seed=n)
    e = bell_from_bsr(a)
    np.testing.assert_allclose(np.asarray(bell_todense(e)), xa, rtol=1e-12)
    v = jnp.asarray(np.random.default_rng(1).standard_normal(n))
    np.testing.assert_allclose(
        np.asarray(bell_smvm(e, v)), xa @ np.asarray(v), rtol=1e-10, atol=1e-12
    )
    # widened capacity is harmless
    e2 = bell_from_bsr(a, Lb=e.Lb + 2)
    np.testing.assert_allclose(
        np.asarray(bell_smvm(e2, v)), xa @ np.asarray(v), rtol=1e-10, atol=1e-12
    )


@pytest.mark.parametrize("k", [1, 16, 64])
def test_bell_spmm(k):
    a, xa = random_bsr(32, 4, 0.4, seed=k)
    e = bell_from_bsr(a)
    b = jnp.asarray(np.random.default_rng(k).standard_normal((32, k)))
    np.testing.assert_allclose(
        np.asarray(bell_spmm(e, b)), xa @ np.asarray(b), rtol=1e-10, atol=1e-12
    )


def test_bell_under_jit_and_operator():
    a, xa = random_bsr(24, 4, 0.5, seed=3)
    e = bell_from_bsr(a)
    v = jnp.asarray(np.random.default_rng(3).standard_normal(24))
    f = jax.jit(lambda e, v: e @ v)
    np.testing.assert_allclose(np.asarray(f(e, v)), xa @ np.asarray(v), rtol=1e-10)


def test_bell_empty():
    a, _ = random_bsr(8, 2, 0.0, seed=0)
    e = bell_from_bsr(a)
    assert e.Lb == 0
    assert np.all(np.asarray(bell_smvm(e, jnp.ones(8))) == 0)


def test_bell_from_csr_reblock():
    from sparse_tpu import csr_from_dense
    from sparse_tpu.formats.bell import bell_from_csr

    rng = np.random.default_rng(11)
    n = 24
    x = rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.2)
    a = csr_from_dense(jnp.asarray(x))
    e = bell_from_csr(a, bsz=4)
    np.testing.assert_allclose(np.asarray(bell_todense(e)), x, rtol=1e-12)
    v = jnp.asarray(rng.standard_normal(n))
    np.testing.assert_allclose(
        np.asarray(bell_smvm(e, v)), x @ np.asarray(v), rtol=1e-10, atol=1e-12
    )


@pytest.mark.parametrize("n,bsz,density", [(32, 4, 0.4), (64, 8, 0.2)])
def test_bell_smvm_jit_argument(n, bsz, density):
    """bell_smvm is the single production BELL SpMV path; the BELL itself
    is a pytree usable as a jit argument."""
    a, xa = random_bsr(n, bsz, density, seed=7 * n)
    e = bell_from_bsr(a)
    v = jnp.asarray(np.random.default_rng(3).standard_normal(n))
    ref = np.asarray(bell_smvm(e, v))
    got = jax.jit(bell_smvm)(e, v)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=1e-12)
    np.testing.assert_allclose(ref, xa @ np.asarray(v), rtol=1e-10, atol=1e-12)

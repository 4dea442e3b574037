"""Triton blocked-ELL SpMM kernel: interpreter mode on the CPU, compiled on
the card (``-m gpu``), and ``bell_spmm``'s choice of kernel."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sparse_tpu import bsr_from_dense
from sparse_tpu.formats.bell import (
    BELL,
    _spmm_route,
    bell_from_bsr,
    bell_spmm,
    bell_spmm_xla,
)
from sparse_tpu.ops.pallas_bell import (
    KERNEL_BSZ,
    bell_spmm_triton,
    kernel_eligible,
)


def random_bell(nb, bsz, density, seed, empty_rows=()):
    """Random block pattern (some block rows emptied) as BELL + dense."""
    rng = np.random.default_rng(seed)
    mask = rng.random((nb, nb)) < density
    mask[np.arange(nb), np.arange(nb)] = True
    for r in empty_rows:
        mask[r] = False
    x = (rng.standard_normal((nb * bsz, nb * bsz))
         * np.kron(mask, np.ones((bsz, bsz)))).astype(np.float32)
    return bell_from_bsr(bsr_from_dense(jnp.asarray(x), bsz)), x


def _operand(n, k, seed):
    return np.random.default_rng(seed).standard_normal((n, k)).astype(
        np.float32)


def _normwise(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("bsz", KERNEL_BSZ)
@pytest.mark.parametrize("k", [16, 64, 128, 100])
@pytest.mark.parametrize("stream", ["f32", "bf16"])
def test_triton_kernel_interpret_matches(bsz, k, stream):
    a, x = random_bell(5, bsz, 0.4, seed=bsz + k, empty_rows=(2,))
    b = _operand(a.n, k, seed=k)
    cdt = jnp.bfloat16 if stream == "bf16" else None
    got = np.asarray(bell_spmm_triton(a, jnp.asarray(b), compute_dtype=cdt,
                                      interpret=True))
    assert got.shape == (a.n, k) and got.dtype == np.float32
    want = x.astype(np.float64) @ b.astype(np.float64)
    # f32 stream: f32 products, float32 summation order; bf16 stream: 8-bit
    # mantissas on both operands (~2^-8 relative per product)
    assert _normwise(got, want) < (1e-5 if stream == "f32" else 1e-2)
    np.testing.assert_array_equal(got[2 * bsz:3 * bsz], 0.0)  # empty row


@pytest.mark.parametrize("bsz", KERNEL_BSZ)
def test_triton_kernel_padding_slots_inert(bsz):
    # padding slots point at column 0 with zero blocks: they load a real
    # panel and must add nothing
    nb = 4
    blocks = np.zeros((nb, 3, bsz, bsz), np.float32)
    cols = np.zeros((nb, 3), np.int32)
    rng = np.random.default_rng(0)
    for r in range(nb):
        blocks[r, 0] = rng.standard_normal((bsz, bsz))
        cols[r, 0] = (r + 1) % nb
    a = BELL(cols=jnp.asarray(cols), blocks=jnp.asarray(blocks),
             n=nb * bsz, bsz=bsz)
    b = _operand(a.n, 32, seed=1)
    got = np.asarray(bell_spmm_triton(a, jnp.asarray(b), interpret=True))
    want = np.asarray(bell_spmm_xla(a, jnp.asarray(b)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _loss(spmm, a, w, cdt=None):
    """``sum(w * spmm(A, b))`` as a function of (A's blocks, b)."""
    return lambda blocks, b: jnp.sum(w * spmm(
        BELL(cols=a.cols, blocks=blocks, n=a.n, bsz=a.bsz), b,
        compute_dtype=cdt))


@pytest.mark.parametrize("bsz", KERNEL_BSZ)
@pytest.mark.parametrize("stream", ["f32", "bf16"])
def test_triton_kernel_interpret_grad_matches_xla(bsz, stream):
    # pallas_call has no transpose rule: reverse mode goes through the
    # kernel's custom JVP, whose tangent is the XLA formulation
    a, x = random_bell(4, bsz, 0.5, seed=bsz, empty_rows=(1,))
    b = jnp.asarray(_operand(a.n, 16, seed=7))
    w = jnp.asarray(_operand(a.n, 16, seed=8))
    cdt = jnp.bfloat16 if stream == "bf16" else None
    kernel = partial(bell_spmm_triton, interpret=True)
    got = jax.grad(_loss(kernel, a, w, cdt), argnums=(0, 1))(a.blocks, b)
    want = jax.grad(_loss(bell_spmm_xla, a, w, cdt), argnums=(0, 1))(
        a.blocks, b)
    for g, r in zip(got, want):
        assert g.shape == r.shape and g.dtype == r.dtype
        np.testing.assert_allclose(np.asarray(g), np.asarray(r), rtol=1e-6,
                                   atol=1e-6)
    if stream == "f32":  # d/db sum(w * A b) = A^T w
        np.testing.assert_allclose(np.asarray(got[1]),
                                   x.T.astype(np.float64) @ np.asarray(w),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("wrt", ["blocks", "b", "both"])
def test_triton_kernel_interpret_jvp_matches_xla(wrt):
    a, _ = random_bell(4, 16, 0.5, seed=11)
    b = jnp.asarray(_operand(a.n, 32, seed=12))
    rng = np.random.default_rng(13)
    dblocks = (jnp.asarray(rng.standard_normal(a.blocks.shape), jnp.float32)
               if wrt != "b" else jnp.zeros_like(a.blocks))
    db = (jnp.asarray(rng.standard_normal(b.shape), jnp.float32)
          if wrt != "blocks" else jnp.zeros_like(b))

    def run(spmm):
        def f(blocks, b):
            return spmm(BELL(cols=a.cols, blocks=blocks, n=a.n, bsz=a.bsz), b)
        if wrt == "blocks":
            return jax.jvp(lambda blk: f(blk, b), (a.blocks,), (dblocks,))
        if wrt == "b":
            return jax.jvp(lambda bb: f(a.blocks, bb), (b,), (db,))
        return jax.jvp(f, (a.blocks, b), (dblocks, db))

    (y, t) = run(partial(bell_spmm_triton, interpret=True))
    (y_ref, t_ref) = run(bell_spmm_xla)
    np.testing.assert_allclose(np.asarray(y), np.asarray(y_ref), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(t), np.asarray(t_ref), rtol=1e-5,
                               atol=1e-5)


def test_triton_kernel_rejects_out_of_range():
    a, _ = random_bell(4, 8, 0.5, seed=0)
    with pytest.raises(ValueError, match="outside the kernel's range"):
        bell_spmm_triton(a, jnp.ones((a.n, 16), jnp.float32), interpret=True)
    with pytest.raises(ValueError, match="operand shape"):
        bell_spmm_triton(a, jnp.ones((a.n + 1, 16), jnp.float32))


@pytest.mark.parametrize(
    "platform,bsz,dtype,want",
    [("gpu", 32, jnp.float32, "triton"), ("gpu", 16, jnp.bfloat16, "triton"),
     ("gpu", 8, jnp.float32, "xla"), ("gpu", 64, jnp.float32, "xla"),
     ("gpu", 32, jnp.float64, "xla"), ("cpu", 32, jnp.float32, "xla"),
     ("cpu", 16, jnp.bfloat16, "xla")],
)
def test_bell_spmm_route_by_platform_and_bsz(platform, bsz, dtype, want):
    a, _ = random_bell(2, bsz, 1.0, seed=3)
    assert _spmm_route(a, 128, dtype, platform) == want
    assert kernel_eligible(a, 128, dtype) == (
        bsz in KERNEL_BSZ and dtype in (jnp.float32, jnp.bfloat16))


@pytest.mark.parametrize("platform,want", [("gpu", True), ("cpu", False),
                                           ("rocm", False)])
def test_capability_table(platform, want):
    from sparse_tpu.backend import has_kernel

    assert has_kernel("bell_spmm", platform) is want
    assert not has_kernel("no_such_kernel", platform)


def test_bell_spmm_on_cpu_takes_xla(monkeypatch):
    import sparse_tpu.ops.pallas_bell as pb

    def boom(*a, **k):
        raise AssertionError("kernel called off the GPU")

    monkeypatch.setattr(pb, "bell_spmm_triton", boom)
    a, x = random_bell(4, 16, 0.5, seed=4)
    b = _operand(a.n, 16, seed=4)
    got = np.asarray(bell_spmm(a, jnp.asarray(b)))
    np.testing.assert_allclose(got, x @ b, rtol=2e-5, atol=2e-5)


# -- on the card ---------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("bsz", KERNEL_BSZ)
@pytest.mark.parametrize("k", [16, 128, 100])
def test_triton_kernel_compiled_f32_is_full_precision(gpu, bsz, k):
    """Compiled kernel at f32: the error against an f64 reference is at
    float32 level (TF32 products would leave ~1e-3)."""
    a, x = random_bell(64, bsz, 0.08, seed=bsz * k)
    b = _operand(a.n, k, seed=k)
    got = np.asarray(jax.jit(bell_spmm)(a, jnp.asarray(b)))
    assert _spmm_route(a, k, jnp.float32) == "triton"
    want = x.astype(np.float64) @ b.astype(np.float64)
    assert _normwise(got, want) < 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("bsz", KERNEL_BSZ)
def test_triton_kernel_compiled_bf16_matches_xla(gpu, bsz):
    a, _ = random_bell(64, bsz, 0.08, seed=bsz)
    b = jnp.asarray(_operand(a.n, 64, seed=2))
    got = np.asarray(bell_spmm_triton(a, b, compute_dtype=jnp.bfloat16))
    want = np.asarray(bell_spmm_xla(a, b, compute_dtype=jnp.bfloat16))
    assert _normwise(got, want) < 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("bsz", KERNEL_BSZ)
def test_bell_spmm_compiled_grad_matches_xla(gpu, bsz):
    """``jax.grad`` through the routed ``bell_spmm`` (the kernel forward,
    XLA einsums backward) against the XLA path and ``A^T w``."""
    a, x = random_bell(64, bsz, 0.08, seed=bsz + 1)
    assert _spmm_route(a, 64, jnp.float32) == "triton"
    b = jnp.asarray(_operand(a.n, 64, seed=3))
    w = jnp.asarray(_operand(a.n, 64, seed=4))
    got = jax.jit(jax.grad(_loss(bell_spmm, a, w), argnums=(0, 1)))(
        a.blocks, b)
    want = jax.jit(jax.grad(_loss(bell_spmm_xla, a, w), argnums=(0, 1)))(
        a.blocks, b)
    for g, r in zip(got, want):
        assert _normwise(np.asarray(g, np.float64),
                         np.asarray(r, np.float64)) < 1e-6
    ref = x.T.astype(np.float64) @ np.asarray(w, np.float64)
    assert _normwise(np.asarray(got[1], np.float64), ref) < 1e-5


@pytest.mark.gpu
def test_triton_kernel_compiled_tf32x3_preset(gpu):
    """The 3-pass TF32 preset lowers on the Triton route and stays close to
    float32 (a single TF32 pass would leave ~1e-3)."""
    a, x = random_bell(64, 32, 0.08, seed=5)
    b = _operand(a.n, 128, seed=5)
    got = np.asarray(bell_spmm_triton(
        a, jnp.asarray(b),
        precision=jax.lax.DotAlgorithmPreset.TF32_TF32_F32_X3))
    want = x.astype(np.float64) @ b.astype(np.float64)
    assert _normwise(got, want) < 1e-5

"""Solve a 2-D Poisson problem (5-point stencil) with distributed
Jacobi-preconditioned CG on a device mesh.

Run (CPU, virtual 8-device mesh):
  XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
      python examples/poisson_cg.py
"""

import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def build_poisson(k: int):
    """5-point stencil on a k x k grid as COO triples."""
    n = k * k
    rows, cols, vals = [], [], []
    for i in range(k):
        for j in range(k):
            p = i * k + j
            rows.append(p); cols.append(p); vals.append(4.0)
            for di, dj in ((-1, 0), (1, 0), (0, -1), (0, 1)):
                ii, jj = i + di, j + dj
                if 0 <= ii < k and 0 <= jj < k:
                    rows.append(p); cols.append(ii * k + jj); vals.append(-1.0)
    return n, np.asarray(rows), np.asarray(cols), np.asarray(vals)


def main():
    import jax
    import jax.numpy as jnp

    from sparse_tpu import coo_make, csr_diagonal, csr_from_coo
    from sparse_tpu.parallel import make_1d_mesh, pcg_solve, pcsr_from_csr
    from sparse_tpu.parallel.pcsr import shard_vector

    k = 32
    n, rows, cols, vals = build_poisson(k)
    a = csr_from_coo(coo_make((n, n), rows, cols, jnp.asarray(vals, jnp.float32)))
    mesh = make_1d_mesh()
    pa = pcsr_from_csr(a, mesh)

    rng = np.random.default_rng(0)
    x_true = rng.standard_normal(n).astype(np.float32)
    dense = np.zeros((n, n), np.float32)
    np.add.at(dense, (rows, cols), vals)
    b = dense @ x_true

    bv = shard_vector(jnp.asarray(b), pa, mesh)

    # preconditioner ladder at a fixed 60-iteration budget: elementwise
    # Jacobi, 4x4 block-Jacobi (batched inverses), and a degree-6
    # Chebyshev polynomial (pure matvecs)
    from sparse_tpu import block_jacobi_prepare
    from sparse_tpu.parallel import chebyshev_preconditioner, estimate_lmax

    inv_d = shard_vector(1.0 / csr_diagonal(a), pa, mesh)
    inv_blocks = block_jacobi_prepare(a, 4, padded_n=bv.shape[0])
    cheb = chebyshev_preconditioner(
        pa, mesh, lmax=float(estimate_lmax(pa, mesh)), degree=6
    )
    it = 60
    for name, M in (("jacobi", inv_d), ("block-jacobi(4)", inv_blocks),
                    ("chebyshev(6)", cheb)):
        x = jax.jit(lambda pa, bv, M=M: pcg_solve(pa, bv, M, mesh, iters=it))(
            pa, bv
        )
        err = np.linalg.norm(np.asarray(x)[:n] - x_true) / np.linalg.norm(
            x_true
        )
        print(f"grid {k}x{k} ({n} unknowns) on {len(jax.devices())} devices, "
              f"{it} iters, {name}: relative error {err:.2e}")

    x = jax.jit(lambda pa, bv: pcg_solve(pa, bv, cheb, mesh, iters=120))(
        pa, bv
    )
    err = np.linalg.norm(np.asarray(x)[:n] - x_true) / np.linalg.norm(x_true)
    assert err < 1e-4


if __name__ == "__main__":
    main()

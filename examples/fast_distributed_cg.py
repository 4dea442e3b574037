"""Distributed CG over a halo-exchange partition: partition once, solve.

`halo_partition` precomputes, once per (pattern, mesh), exactly which
operand entries each shard pair exchanges; every solver in
`parallel/cg.py` dispatches its matvec through `dist_spmv`, so the same
`cg_solve` call runs on a halo partition (one all_to_all of the halo per
iteration) or on the all-gather `PCSR` baseline.  Iterates stay in the
distributed layout throughout — no per-iteration permutes or gathers.

Run: XLA_FLAGS=--xla_force_host_platform_device_count=8 \
     JAX_PLATFORMS=cpu python examples/fast_distributed_cg.py
"""

import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main():
    import jax
    import jax.numpy as jnp

    from sparse_tpu import csr_from_dense
    from sparse_tpu.parallel import (
        cg_solve,
        halo_partition,
        make_1d_mesh,
        pcsr_from_csr,
    )
    from sparse_tpu.parallel.pcsr import shard_vector

    ndev = len(jax.devices())
    mesh = make_1d_mesh(ndev)
    print(f"mesh: {ndev} devices")

    # a banded SPD operator (FEM-like locality), n = 400
    rng = np.random.default_rng(0)
    n = 400
    x = np.zeros((n, n), np.float32)
    for i in range(n):
        js = np.clip(i + rng.integers(-10, 11, size=5), 0, n - 1)
        x[i, js] = rng.standard_normal(js.size) * 0.3
    spd = (x @ x.T + np.eye(n, dtype=np.float32) * 4.0)
    a = csr_from_dense(jnp.asarray(spd))
    b_np = rng.standard_normal(n).astype(np.float32)

    # partition ONCE: the halo plan exchanges only the entries each shard
    # reads from the others
    hp = halo_partition(a, mesh)
    print(f"halo/shard: {hp.halo} entries (vs {n} for an all-gather)")

    b = shard_vector(jnp.asarray(b_np), hp, mesh)
    xs = cg_solve(hp, b, mesh, iters=60)
    resid = spd @ np.asarray(xs)[:n] - b_np
    rel = np.linalg.norm(resid) / np.linalg.norm(b_np)
    print(f"CG(60) through the halo exchange: rel residual {rel:.2e}")
    assert rel < 1e-5

    # the same call on the all-gather baseline — same result; dist_spmv
    # dispatches on the partition type
    pa = pcsr_from_csr(a, mesh)
    xs2 = cg_solve(pa, b, mesh, iters=60)
    np.testing.assert_allclose(
        np.asarray(xs2)[:n], np.asarray(xs)[:n], rtol=2e-4, atol=2e-4
    )
    print("matches the all-gather PCSR solve")


if __name__ == "__main__":
    main()

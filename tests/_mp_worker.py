"""Worker for the multi-process distributed test (not a pytest module).

Each process owns 4 virtual CPU devices; ``jax.distributed.initialize``
joins them into one 8-device global mesh (the DCN/multi-controller path,
SURVEY.md §4 item 4).  The parallel layer's constructors go through
``put_sharded``, which feeds each process only its local shard rows, so the
exact same library code runs here as in the single-process mesh tests.

Usage: python _mp_worker.py <process_id> <num_processes> <port>
"""

import os
import sys

pid = int(sys.argv[1])
nproc = int(sys.argv[2])
port = sys.argv[3]

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=4"
).strip()

import jax  # noqa: E402

jax.distributed.initialize(
    coordinator_address=f"localhost:{port}",
    num_processes=nproc,
    process_id=pid,
)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from sparse_tpu import csr_from_dense  # noqa: E402
from sparse_tpu.parallel import (  # noqa: E402
    cg_solve,
    make_1d_mesh,
    pcsr_from_csr,
    pcsr_spmv,
)
from sparse_tpu.parallel.pcsr import shard_vector  # noqa: E402

assert jax.process_count() == nproc, jax.process_count()
assert len(jax.devices()) == 4 * nproc, jax.devices()

mesh = make_1d_mesh(4 * nproc)
rng = np.random.default_rng(0)
n = 32
x = rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.4)
spd = (x @ x.T + n * np.eye(n)).astype(np.float32)
a = pcsr_from_csr(csr_from_dense(jnp.asarray(spd)), mesh)
v = np.random.default_rng(1).standard_normal(n).astype(np.float32)
vs = shard_vector(jnp.asarray(v), a, mesh)


def check_local_shards(arr, ref, rtol=1e-4, atol=1e-4):
    for sh in arr.addressable_shards:
        lo = sh.index[0].start or 0
        got = np.asarray(sh.data).reshape(-1)
        want = np.zeros_like(got)
        k = max(0, min(ref.size - lo, got.size))
        want[:k] = ref[lo : lo + k]
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


y = jax.jit(lambda a, w: pcsr_spmv(a, w, mesh))(a, vs)
check_local_shards(y, spd @ v)

sol = cg_solve(a, vs, mesh, iters=60)
resid = pcsr_spmv(a, sol, mesh)
check_local_shards(resid, spd @ np.linalg.solve(spd, v), rtol=1e-2, atol=1e-2)

# distributed BLOCK SpGEMM over the same multi-controller mesh: the plan
# tables and shards all flow through put_sharded's process-local path
from sparse_tpu.formats.bsr import bsr_from_dense, bsr_todense  # noqa: E402
from sparse_tpu.parallel import (  # noqa: E402
    build_pbsr_smsmm_plan,
    pbsr_from_bsr,
    pbsr_smsmm,
)

bsz = 4
nb = n // bsz
bmask = np.kron(rng.random((nb, nb)) < 0.4, np.ones((bsz, bsz)))
bx = (bmask * rng.standard_normal((n, n))).astype(np.float32)
ab = bsr_from_dense(jnp.asarray(bx), bsz)
pab = pbsr_from_bsr(ab, mesh)
bplan = build_pbsr_smsmm_plan(pab, pab, mesh)
# no outer jit: pbsr_smsmm's exec is module-jitted, and an outer wrap
# would capture the plan as a closure constant (replicated output shards)
pc = pbsr_smsmm(pab, pab, mesh, bplan)
ref_blocks = bx @ bx
rb = pc.rows_per_shard
# value check: each local output shard's blocks against the dense oracle
for sh_i, sh_b in zip(pc.indices.addressable_shards,
                      pc.blocks.addressable_shards):
    s = sh_i.index[0].start or 0
    li = np.asarray(sh_i.data).reshape(-1)
    lb = np.asarray(sh_b.data).reshape(-1, bsz, bsz)
    for j, code in enumerate(li):
        if code >= rb * nb:
            continue
        r_l, c = int(code) // nb, int(code) % nb
        r_g = s * rb + r_l
        want = ref_blocks[r_g * bsz:(r_g + 1) * bsz, c * bsz:(c + 1) * bsz]
        np.testing.assert_allclose(lb[j], want, rtol=2e-4, atol=2e-4)

print(f"MP_OK {pid}", flush=True)

"""Extended benchmark suite on one GPU (one JSON line per metric; the
headline lives in /bench.py).

Run: python benchmarks/suite.py [--quick] [--only=<section>]

Covers BASELINE.md configs beyond the headline: a plain copy (always run
first), SpMV on the ``gen_fixtures`` matrices, CSR SpMV/SpMM on the
row-binned XLA path, blocked-ELL SpMV and a k-sweep of ``bell_spmm``
(32..256), SpGEMM (dense-accumulator, ESC, prepared, block), and
distributed SpMV over the visible devices.  All timings are
dependency-chained inside jit.  ``vs_baseline`` on bandwidth metrics is
the fraction of the card's published memory bandwidth
(``benchmarks/peaks.py``); ``share_of_copy`` divides by the copy measured
in the same process.  Exits non-zero unless JAX's default device is a GPU;
a failing section raises.
"""

from __future__ import annotations

import json
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "benchmarks"))

K_CHAIN = 5
#: The card's published memory bandwidth (GB/s); set by ``main``.
PEAK_GBPS = None
#: This card's plain-copy bandwidth (GB/s); set by ``bench_copy``.
COPY_GBPS = None


def timed_chain(step, v0, *operands, iters=3):
    """Seconds per application of ``step(v, *operands)``, dependency-chained.

    ``operands`` (the sparse matrix, plans, ...) are passed as jit
    *arguments*, so they are not embedded in the program as constants."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def run(v, *ops):
        # raw output fed back (no elementwise normalize): iterations stay
        # data-dependent, and all suite operators are 0.01-scaled so a
        # 5-step chain neither overflows nor denormalizes.  The normalize
        # pass cost ~2.5 ms/iter of protocol-only traffic at SpMM sizes.
        return jnp.sum(jax.lax.fori_loop(0, K_CHAIN, lambda _, v: step(v, *ops), v))

    float(run(v0, *operands))
    best = np.inf
    for _ in range(iters):
        t0 = time.perf_counter()
        float(run(v0, *operands))
        best = min(best, (time.perf_counter() - t0) / K_CHAIN)
    return best


def emit(metric, value, unit, vs=None, **extra):
    # 4 significant digits (fixed decimals would zero out rel-err metrics)
    rec = {"metric": metric, "value": float(f"{value:.4g}"), "unit": unit}
    if vs is not None:
        rec["vs_baseline"] = float(f"{vs:.4g}")
    rec.update({k: float(f"{v:.4g}") for k, v in extra.items()})
    print(json.dumps(rec), flush=True)


def bench_copy(quick):
    """``v <- v + 1`` over 1 GiB of float32: the bandwidth the card reaches
    in plain streaming.  Each chained step is ten passes (a read and a
    write each) kept apart by barriers, so the chain's entry copy of ``v``
    and its closing sum add ~3% to the time: the rate is a lower bound."""
    global COPY_GBPS
    import jax
    import jax.numpy as jnp

    def step(v):
        for _ in range(10):
            v = jax.lax.optimization_barrier(v + 1.0)
        return v

    x = jnp.ones(((64 if quick else 256) * 1024 * 1024,), jnp.float32)
    COPY_GBPS = 10 * 2 * x.nbytes / timed_chain(step, x) / 1e9
    emit("copy_bw", COPY_GBPS, "GB/s", COPY_GBPS / PEAK_GBPS)


def bench_spmv_fixtures(quick):
    """float32 SpMV on the ``gen_fixtures`` matrices (FEM Poisson 1M
    points, FEM elasticity 400k points, power-law 1M rows; a tenth with
    ``--quick``): the row-binned ``csr_smvm_fast`` (the ``smvm_prepare``
    XLA rung), a ``segment_sum`` CSR SpMV, and ``bell_smvm`` at the
    elasticity's natural 2x2 blocks.  GB/s count ``utils.stats.spmv_bytes``
    (what a CSR SpMV must move).  Each matrix is scaled to a max row sum of
    1 so the chain stays finite; each path is checked against SciPy."""
    import gen_fixtures
    import jax.numpy as jnp

    from sparse_tpu import CSR
    from sparse_tpu.formats.bell import bell_from_csr, bell_smvm
    from sparse_tpu.ops.segmented import row_ids_from_indptr, segment_sum
    from sparse_tpu.ops.spmv import build_spmv_plan, csr_smvm_fast
    from sparse_tpu.utils.stats import spmv_bytes

    def seg(v, a, rows):
        return segment_sum(a.data * v[a.indices], rows, a.shape[0],
                           indices_are_sorted=True)

    d = 10 if quick else 1
    fixtures = {
        "fem_poisson_1m": (gen_fixtures.poisson_fem(1_000_000 // d, seed=0),
                           None),
        "fem_elasticity_400k": (
            gen_fixtures.elasticity_fem(400_000 // d, seed=1), 2),
        "graph_powerlaw_1m": (
            gen_fixtures.powerlaw_graph(1_000_000 // d, m=16, seed=2), None),
    }
    for name, (s, bell_bsz) in fixtures.items():
        s = s.tocsr().astype(np.float32)
        s.sort_indices()
        s.data /= abs(s).sum(axis=1).max()
        a = CSR(data=jnp.asarray(s.data), indices=jnp.asarray(s.indices),
                indptr=jnp.asarray(s.indptr.astype(np.int32)), shape=s.shape)
        paths = {
            "csr_smvm_fast": (lambda v, a, p: csr_smvm_fast(a, v, p),
                              (a, build_spmv_plan(a))),
            "segment_sum": (seg, (a, row_ids_from_indptr(a.indptr, s.nnz))),
        }
        if bell_bsz:
            paths[f"bell_smvm_bsz{bell_bsz}"] = (
                lambda v, b: bell_smvm(b, v), (bell_from_csr(a, bell_bsz),))
        v0 = jnp.asarray(np.random.default_rng(0).standard_normal(
            s.shape[1]).astype(np.float32))
        v64 = np.asarray(v0, np.float64)
        ref, scale = s @ v64, abs(s) @ np.abs(v64)
        nbytes = spmv_bytes(a)
        for path, (step, ops) in paths.items():
            y = np.asarray(step(v0, *ops), np.float64)
            err = np.linalg.norm(y - ref) / np.linalg.norm(scale)
            if not err <= 1e-5:
                raise AssertionError(f"{name}/{path}: error {err:.3g}")
            t = timed_chain(step, v0, *ops)
            gbps = nbytes / t / 1e9
            emit(f"{name}_{path}_bw", gbps, "GB/s", gbps / PEAK_GBPS,
                 share_of_copy=gbps / COPY_GBPS, ms=t * 1e3)


def bench_csr(quick):
    import jax.numpy as jnp
    import scipy.sparse as sp

    from sparse_tpu import CSR
    from sparse_tpu.ops.spmv import build_spmv_plan, csr_smvm_fast, csr_spmm_fast
    from sparse_tpu.ops.segmented import INDEX_DTYPE

    rng = np.random.default_rng(0)
    n = m = 100_000 if quick else 200_000
    per_row = 32
    nnz = n * per_row
    cols = rng.integers(0, m, nnz, dtype=np.int32).reshape(n, per_row)
    cols.sort(axis=1)
    vals = (rng.standard_normal(nnz) * 0.01).astype(np.float32)
    indptr = np.arange(0, nnz + 1, per_row, dtype=np.int32)
    a = CSR(
        data=jnp.asarray(vals),
        indices=jnp.asarray(cols.reshape(-1)),
        indptr=jnp.asarray(indptr),
        shape=(n, m),
    )
    plan = build_spmv_plan(a)
    v0 = jnp.asarray(rng.standard_normal(m).astype(np.float32))
    t = timed_chain(lambda v, a, plan: csr_smvm_fast(a, v, plan), v0, a, plan)
    s = sp.csr_matrix((vals, cols.reshape(-1), indptr), shape=(n, m))
    x = np.asarray(v0)
    s @ x
    t0 = time.perf_counter()
    for _ in range(K_CHAIN):
        w = s @ x
        x = w / (np.abs(w).max() + 1.0)
    t_ref = (time.perf_counter() - t0) / K_CHAIN
    emit("csr_spmv_unstructured_nnzps", nnz / t / 1e9, "Gnnz/s", t_ref / t)

    k = 64
    b0 = jnp.asarray(rng.standard_normal((m, k)).astype(np.float32) * 0.01)
    t = timed_chain(lambda b, a, plan: csr_spmm_fast(a, b, plan), b0, a, plan)
    eff = (nnz * (4 + 4 + 4 * k) + n * k * 4) / t / 1e9
    emit(f"csr_spmm_k{k}_eff_bw", eff, "GB/s", eff / PEAK_GBPS)


def bench_bell(quick):
    import jax.numpy as jnp

    from sparse_tpu.formats.bell import (
        bell_from_bsr,
        bell_smvm,
        bell_smvm_hbm_bytes,
        bell_spmm,
    )
    from sparse_tpu.formats.bsr import BSR
    from sparse_tpu.ops.segmented import INDEX_DTYPE
    from sparse_tpu.utils.stats import blocked_min_bytes, nnz_roofline

    rng = np.random.default_rng(1)
    bsz, half = 32, 2
    nb = 7_800 if quick else 15_625
    n = nb * bsz
    rows, cols = [], []
    for off in range(-half, half + 1):
        r = np.arange(max(0, -off), min(nb, nb - off), dtype=np.int64)
        rows.append(r)
        cols.append(r + off)
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    # pooled values (drawing every element costs minutes of host RNG)
    pool = (rng.standard_normal(1021 * bsz * bsz).astype(np.float32) * 0.01)
    blocks = pool.reshape(1021, bsz, bsz)[np.arange(rows.size) % 1021]
    a = bell_from_bsr(
        BSR(
            indices=(rows * nb + cols).astype(INDEX_DTYPE),
            blocks=blocks,
            n=n,
            bsz=bsz,
        )
    )
    nnz = rows.size * bsz * bsz
    v0 = jnp.asarray(rng.standard_normal(n).astype(np.float32))
    t = timed_chain(lambda v, a: bell_smvm(a, v), v0, a)
    spmv_bytes = bell_smvm_hbm_bytes(a)
    emit("bell_spmv_block_banded_eff_bw", spmv_bytes / t / 1e9, "GB/s",
         spmv_bytes / t / 1e9 / PEAK_GBPS,
         share_of_copy=spmv_bytes / t / 1e9 / COPY_GBPS, ms=t * 1e3)
    rl = nnz_roofline(
        nnz, min_bytes=blocked_min_bytes(rows.size, bsz, n),
        hbm_gbps=PEAK_GBPS, plan_bytes=spmv_bytes, seconds=t,
    )
    emit("bell_spmv_frac_of_nnz_roofline", rl["frac_of_nnz_roofline"],
         "frac", rl["structural_frac"])

    # k-sweep (BASELINE config 3: SpMM k=32..256), production dispatch
    for k in (32, 64, 128, 256):
        b0 = jnp.asarray(rng.standard_normal((n, k)).astype(np.float32) * 0.01)
        t = timed_chain(lambda b, a: bell_spmm(a, b), b0, a)
        rl = nnz_roofline(
            nnz, k=k, min_bytes=blocked_min_bytes(rows.size, bsz, n, k),
            hbm_gbps=PEAK_GBPS, seconds=t,
        )
        emit(f"bell_spmm_k{k}_gflops", 2 * nnz * k / t / 1e9, "GFLOP/s")
        emit(f"bell_spmm_k{k}_frac_of_nnz_roofline",
             rl["frac_of_nnz_roofline"], "frac")


def bench_spgemm(quick):
    import jax.numpy as jnp

    from sparse_tpu import csr_from_dense, spgemm

    rng = np.random.default_rng(2)
    n = 1_000 if quick else 2_000
    x = (rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.01)).astype(
        np.float32
    )
    a = csr_from_dense(jnp.asarray(x))
    flops = 2.0 * float((x != 0).sum(0) @ (x != 0).sum(1))
    for method in ("mxu", "esc"):
        float(jnp.sum(spgemm(a, a, method=method).data))  # warm
        best = np.inf
        for _ in range(3):
            t0 = time.perf_counter()
            float(jnp.sum(spgemm(a, a, method=method).data))
            best = min(best, time.perf_counter() - t0)
        suffix = "" if method == "mxu" else "_esc"
        emit(f"spgemm_aa{suffix}_gflops", flops / best / 1e9, "GFLOP/s")


def bench_spgemm_prepared(quick):
    """Prepared SpGEMM (the solver idiom: one symbolic pass per pattern
    pair, many numeric passes as values change — FEM Jacobians, AMG Galerkin
    products).  Records the host prepare cost and the on-chip
    ``spgemm_apply`` numeric rate on the device (sort-free: two gathers + one pre-sorted
    segment-sum)."""
    import jax.numpy as jnp

    from sparse_tpu import CSR
    from sparse_tpu.ops.spgemm import spgemm_apply, spgemm_prepare

    rng = np.random.default_rng(5)
    n = 20_000 if quick else 50_000
    per_row = 10
    rows = np.repeat(np.arange(n, dtype=np.int64), per_row)
    cols = rng.integers(0, n, rows.size, dtype=np.int64)
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    keep = np.ones(rows.size, bool)
    keep[1:] = (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1])
    rows, cols = rows[keep], cols[keep]
    vals = (rng.standard_normal(rows.size) * 0.01).astype(np.float32)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=indptr[1:])
    a = CSR(
        data=jnp.asarray(vals),
        indices=jnp.asarray(cols.astype(np.int32)),
        indptr=jnp.asarray(indptr.astype(np.int32)),
        shape=(n, n),
    )
    t0 = time.perf_counter()
    plan = spgemm_prepare(a, a)
    emit("spgemm_prepare_seconds", time.perf_counter() - t0, "s")
    emit("spgemm_prepare_products", plan.n_products / 1e6, "M")

    def step(adata, plan, a):
        a2 = CSR(data=adata, indices=a.indices, indptr=a.indptr,
                 shape=a.shape)
        c = spgemm_apply(plan, a2, a2)
        # data-dependent feedback without changing magnitudes
        return adata * (1.0 + 1e-30 * jnp.sum(c.data))

    t = timed_chain(step, a.data, plan, a)
    emit("spgemm_apply_gflops", 2 * plan.n_products / t / 1e9, "GFLOP/s")
    emit("spgemm_apply_ms", t * 1e3, "ms")


def bench_bsr_spgemm(quick):
    """Block SpGEMM: the prepared XLA apply (``bsr_smsmm_apply``) gathers
    whole bsz x bsz blocks per product and contracts them in one batched
    einsum, plus the one-shot device path.  Reference semantics:
    blocked_square_regular.fut:336-363."""
    import jax.numpy as jnp

    from sparse_tpu.formats.bsr import (
        BSR, bsr_smsmm, bsr_smsmm_apply, bsr_smsmm_prepare,
    )
    from sparse_tpu.ops.segmented import INDEX_DTYPE

    rng = np.random.default_rng(9)
    bsz = 32

    def build(nb):
        per_row = 10
        rows = np.repeat(np.arange(nb, dtype=np.int64), per_row)
        cols = np.clip(rows + rng.integers(-50, 50, rows.size), 0, nb - 1)
        order = np.lexsort((cols, rows))
        rows, cols = rows[order], cols[order]
        keep = np.ones(rows.size, bool)
        keep[1:] = (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1])
        rows, cols = rows[keep], cols[keep]
        nbz = rows.size
        pool = rng.standard_normal((257, bsz, bsz)).astype(np.float32) * 0.01
        return BSR(
            indices=jnp.asarray(rows * nb + cols, INDEX_DTYPE),
            blocks=jnp.asarray(pool[np.arange(nbz) % 257]),
            n=nb * bsz,
            bsz=bsz,
        )

    def step(blocks, plan, a):
        a2 = BSR(indices=a.indices, blocks=blocks, n=a.n, bsz=a.bsz)
        c = bsr_smsmm_apply(plan, a2, a2)
        return blocks * (1.0 + 1e-30 * jnp.sum(c.blocks))

    a = build(2_000 if quick else 4_000)
    t0 = time.perf_counter()
    plan = bsr_smsmm_prepare(a, a)
    prep_s = time.perf_counter() - t0
    flops = 2.0 * plan.n_products * bsz**3
    t = timed_chain(step, a.blocks, plan, a)
    mem = bsr_smsmm_apply.lower(plan, a, a).compile().memory_analysis()
    emit("bsr_spgemm_prepare_seconds", prep_s, "s")
    emit("bsr_spgemm_products", plan.n_products / 1e6, "M blk")
    emit("bsr_spgemm_apply_gflops", flops / t / 1e9, "GFLOP/s")
    emit("bsr_spgemm_apply_temp_bytes", mem.temp_size_in_bytes / 1e9, "GB",
         argument_gb=mem.argument_size_in_bytes / 1e9)
    # device-memory traffic of the numeric pass: the apply materializes
    # three (n_products, bsz, bsz) streams (two gathered operands and the
    # products; memory_analysis shows them as temporaries), each written
    # once and read once, plus the output
    bytes_ = (6 * plan.n_products + plan.nbz_out) * bsz * bsz * 4
    emit("bsr_spgemm_apply_streamed_bw", bytes_ / t / 1e9, "GB/s",
         bytes_ / t / 1e9 / PEAK_GBPS,
         share_of_copy=bytes_ / t / 1e9 / COPY_GBPS, ms=t * 1e3)

    # one-shot (symbolic pass on device, sort included)
    import jax

    f = jax.jit(lambda a: jnp.sum(bsr_smsmm(a, a, expansion_nbz=plan.n_products,
                                            compact=False).blocks))
    float(f(a))
    best = np.inf
    for _ in range(3):
        t0 = time.perf_counter()
        float(f(a))
        best = min(best, time.perf_counter() - t0)
    emit("bsr_spgemm_oneshot_gflops", flops / best / 1e9, "GFLOP/s")


def bench_distributed():
    import jax

    if len(jax.devices()) < 2:
        return
    import jax.numpy as jnp

    from sparse_tpu import csr_from_dense
    from sparse_tpu.parallel import make_1d_mesh, pcsr_from_csr, pcsr_spmv
    from sparse_tpu.parallel.pcsr import shard_vector

    rng = np.random.default_rng(3)
    n = 4096
    x = (rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.02)).astype(
        np.float32
    )
    a = csr_from_dense(jnp.asarray(x))
    mesh = make_1d_mesh()
    pa = pcsr_from_csr(a, mesh)
    v0 = shard_vector(jnp.asarray(rng.standard_normal(n).astype(np.float32)), pa, mesh)
    t = timed_chain(lambda v, pa: pcsr_spmv(pa, v, mesh), v0, pa)
    emit(
        f"pcsr_spmv_{len(jax.devices())}dev_nnzps",
        float((x != 0).sum()) / t / 1e9,
        "Gnnz/s",
    )


def _banded_csr(n, per_row, half_width, seed):
    import jax.numpy as jnp

    from sparse_tpu import CSR

    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n, dtype=np.int64), per_row)
    cols = np.clip(rows + rng.integers(-half_width, half_width, rows.size),
                   0, n - 1)
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    keep = np.ones(rows.size, bool)
    keep[1:] = (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1])
    rows, cols = rows[keep], cols[keep]
    vals = (rng.standard_normal(rows.size) * 0.01).astype(np.float32)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=indptr[1:])
    return CSR(
        data=jnp.asarray(vals),
        indices=jnp.asarray(cols.astype(np.int32)),
        indptr=jnp.asarray(indptr.astype(np.int32)),
        shape=(n, n),
    ), rows.size


def bench_weak_scaling(quick):
    """BASELINE config 5: fixed rows/device, time pcsr_spmv at growing
    device counts; efficiency(d) = t(1) / t(d) (flat time = 1.0).

    Runs over the visible GPUs (1, 2, 4, ...)."""
    import jax

    ndev = len(jax.devices())
    if ndev < 2:
        return
    import jax.numpy as jnp

    from sparse_tpu.parallel import make_1d_mesh, pcsr_from_csr, pcsr_spmv
    from sparse_tpu.parallel.pcsr import shard_vector

    rows_per_dev = 16_384 if quick else 65_536
    per_row = 16
    t1 = None
    d = 1
    while d <= ndev:
        n = rows_per_dev * d
        a, nnz = _banded_csr(n, per_row, 2048, seed=100 + d)
        mesh = make_1d_mesh(d)
        pa = pcsr_from_csr(a, mesh)
        v0 = shard_vector(
            jnp.asarray(
                np.random.default_rng(d).standard_normal(n).astype(np.float32)
            ),
            pa, mesh,
        )
        t = timed_chain(lambda v, pa: pcsr_spmv(pa, v, mesh), v0, pa)
        if d == 1:
            t1 = t
        emit(
            f"pcsr_spmv_weak_{d}dev_nnzps", nnz / t / 1e9, "Gnnz/s",
            t1 / t,
        )
        d *= 2


def main(argv):
    global PEAK_GBPS
    from peaks import peak_for

    from sparse_tpu.utils.profiling import (
        card_info,
        require_gpu,
        use_compile_cache,
    )

    import jax

    # the elasticity fixture's 400k block rows need wide (int64) block
    # coordinates on the way to BELL
    jax.config.update("jax_enable_x64", True)
    quick = "--quick" in argv
    only = [a.split("=", 1)[1] for a in argv if a.startswith("--only=")]
    dev = require_gpu()
    use_compile_cache(ROOT)
    PEAK_GBPS = peak_for(dev["kind"]).hbm_gbps
    print(f"card: {card_info()}", flush=True)
    print(f"device: {json.dumps(dev)}", flush=True)
    bench_copy(quick)
    for section in (bench_spmv_fixtures, bench_csr, bench_bell, bench_spgemm,
                    bench_spgemm_prepared, bench_bsr_spgemm,
                    bench_distributed, bench_weak_scaling):
        if only and not any(o in section.__name__ for o in only):
            continue
        if section is bench_distributed:
            section()
        else:
            section(quick)


if __name__ == "__main__":
    main(sys.argv[1:])

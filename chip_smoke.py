"""Smoke run of the library's main path on one GPU, end to end.

Run from the repository root:

    python chip_smoke.py              # one GPU: every single-device phase
    python chip_smoke.py --chips 4    # four GPUs: the multi-device phases only

Each phase drives the public entry points at the sizes users run, compares
every result with a plain reference (SciPy, NumPy, or the same operation on
one device), and prints one JSON line with its seconds, its compile seconds
and ``peak_bytes_in_use``.  The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``,
printed only when every comparison passed.  Without a GPU the script exits
non-zero before any phase runs.

Phases (one GPU): device, fixture (README example), spmv
(``smvm_prepare`` -> ``plan.apply`` on FEM Poisson 1M points, FEM
elasticity 400k points, power-law 1M rows (the row-binned XLA rung) and
the benchmark's 32x32 block band, 500k rows (the BELL rung), at f32 and
f64), spmm (``bell_spmm`` at the benchmark's block band, 500k rows,
k=128, and ``jax.grad`` through it), spgemm
(``spgemm(method="auto")``: elasticity 400k on the block route, Poisson
250k on the scalar ESC route), lu (``bsr_lup`` + ``bsr_ols``), cg
(``cg_solve`` over ``halo_partition``/``dist_spmv`` on a 1-device mesh,
Poisson 1M).  With ``--chips 4``: halo CG, ``halo_spmv_overlapped``,
``phub_spmv``, ``pbsr_smsmm`` and ``pcsr_spgemm_aa`` on a 4-device mesh,
each against one device and SciPy.

Tolerances.  Every product is compared as
``||y - y_ref||_2 / || |A| |x| ||_2``: the magnitude scale that float
rounding grows with (it stays meaningful where rows cancel, as FEM rows
do).  The reference is computed in float64 from the same (rounded) inputs.
Bounds: 1e-12 at float64 (unit roundoff 1.1e-16 times row lengths up to a
few hundred), 1e-5 at float32 (unit roundoff 6e-8 times the same).  A TF32
product keeps 10 mantissa bits (roundoff ~5e-4), so the float32 bound also
shows that full float32 precision held inside every contraction, the
Triton kernel's included.  Solves are checked by residual: the LU solution
against ``scipy.linalg.lu_solve`` (relative error <= 1e-12, a
diagonally dominant system of condition < 4), CG by the relative residual
SciPy computes from the returned x, which must be within 2x of a NumPy CG
running the same recurrence for the same number of iterations (the
right-hand side is ``A x`` for a random x, see ``cg_rhs``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "benchmarks"))

F64_TOL = 1e-12
F32_TOL = 1e-5
CG_RESIDUAL_FACTOR = 2.0

#: Full sizes (the ``*_1m`` / ``*_400k`` classes of ROADMAP.md).
SIZES = dict(
    poisson_points=1_000_000,
    elasticity_points=400_000,
    powerlaw_n=1_000_000,
    powerlaw_m=16,
    band_nb=15_625,
    band_k=128,
    spgemm_poisson_points=250_000,
    lu_nb=300,
    lu_bsz=8,
    cg_iters=200,
)

_COMPILE_S = [0.0]


def _on_duration(event: str, duration: float, **_kw) -> None:
    if event.startswith("/jax/core/compile/"):
        _COMPILE_S[0] += duration


def _peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def check(name: str, err: float, tol: float, **extra) -> dict:
    """One comparison; NaN never passes."""
    err = float(err)
    return {"check": name, "err": err, "tol": tol, "ok": bool(err <= tol),
            **extra}


def scaled_err(y, y_ref, scale) -> float:
    """``||y - y_ref|| / ||scale||`` over all entries."""
    d = np.asarray(y, np.float64) - np.asarray(y_ref, np.float64)
    s = float(np.linalg.norm(np.asarray(scale, np.float64)))
    return float(np.linalg.norm(d)) / s if s else float(np.linalg.norm(d))


def tol_of(dtype) -> float:
    return F64_TOL if np.dtype(dtype) == np.float64 else F32_TOL


_FIXTURES: dict = {}


def fixture(name: str, **kw):
    """A ``benchmarks/gen_fixtures.py`` matrix (SciPy CSR, float64),
    generated once per process from its seed."""
    key = (name, tuple(sorted(kw.items())))
    if key not in _FIXTURES:
        import gen_fixtures

        s = getattr(gen_fixtures, name)(**kw).tocsr()
        s.sort_indices()
        _FIXTURES[key] = s
    return _FIXTURES[key]


def rounded(s, dtype):
    """``s`` with its values rounded to ``dtype``, held in float64."""
    return s.astype(dtype).astype(np.float64)


def to_csr(s, dtype):
    """Library CSR of a SciPy matrix, values in ``dtype``."""
    import jax.numpy as jnp

    from sparse_tpu import CSR

    s = s.tocsr()
    s.sort_indices()
    return CSR(data=jnp.asarray(s.data.astype(dtype)),
               indices=jnp.asarray(s.indices.astype(np.int32)),
               indptr=jnp.asarray(s.indptr.astype(np.int64)),
               shape=s.shape)


def csr_to_scipy(c):
    import scipy.sparse as sp

    indptr = np.asarray(c.indptr).astype(np.int64)
    k = int(indptr[-1])
    return sp.csr_matrix((np.asarray(c.data)[:k].astype(np.float64),
                          np.asarray(c.indices)[:k], indptr), shape=c.shape)


def structure(s):
    """The stored pattern of ``s`` with every value 1.0 (so a product of
    two has no cancellation: its pattern is every realized product)."""
    t = s.copy().tocsr()
    t.data = np.ones_like(t.data)
    return t


# -- single-device phases ------------------------------------------------------


def phase_device() -> dict:
    """The device facts printed before any number."""
    import jax

    from sparse_tpu.io import fastmm
    from sparse_tpu.native import plansort
    from sparse_tpu.utils.profiling import card_info, device_record

    rec = device_record()
    print(f"card: {card_info()}", flush=True)
    print(f"jax {jax.__version__}; device {json.dumps(rec)}; native cores: "
          f"fastmm={'built' if fastmm._load() else 'unavailable'}, "
          f"plansort={'built' if plansort._load() else 'unavailable'}",
          flush=True)
    return rec


def phase_fixture() -> list:
    """README example: ``csr_smvm`` of the 2x3 fixture at f64 is exactly
    ``[20, 90]``."""
    import jax.numpy as jnp

    from sparse_tpu import csr_from_triples, csr_smvm

    a = csr_from_triples(2, 3, [(0, 0, 2), (1, 2, 3)], dtype=jnp.float64)
    y = np.asarray(csr_smvm(a, jnp.asarray([10.0, 20.0, 30.0], jnp.float64)))
    exact = y.dtype == np.float64 and np.array_equal(y, [20.0, 90.0])
    return [check("readme_fixture_f64", 0.0 if exact else np.inf, 0.0,
                  got=y.tolist())]


def block_band(nb: int):
    """``bench.py``'s block band (32x32 blocks, 5-block band) at ``nb``
    block rows: ``(rows, cols, blocks, b, s)``, with ``s`` the same matrix
    as a SciPy BSR in float64 (the float32 values are exact in it)."""
    import scipy.sparse as sp

    import bench

    rows, cols, blocks, b = bench.build_block_band(nb=nb)
    bsz = blocks.shape[1]
    starts = np.zeros(nb + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=nb), out=starts[1:])
    s = sp.bsr_matrix((blocks.astype(np.float64), cols, starts),
                      shape=(nb * bsz, nb * bsz))
    return rows, cols, blocks, b, s


def phase_spmv(mats: dict, dtypes=(np.float32, np.float64), seed=0) -> list:
    """``smvm_prepare`` -> ``plan.apply`` per matrix and dtype, against
    SciPy in float64, and the ladder's rung against the one expected.
    ``mats``: name -> (SciPy matrix, expected rung)."""
    import jax
    import jax.numpy as jnp

    from sparse_tpu import smvm_prepare

    apply = jax.jit(lambda p, v: p.apply(v))
    rng = np.random.default_rng(seed)
    out = []
    for name, (s, want) in mats.items():
        v = rng.standard_normal(s.shape[1])
        for dt in dtypes:
            s_r = rounded(s, dt)
            v_r = v.astype(dt)
            t0 = time.perf_counter()
            plan = smvm_prepare(to_csr(s, dt))
            prep = time.perf_counter() - t0
            y = np.asarray(apply(plan, jnp.asarray(v_r)))
            ref = s_r @ v_r.astype(np.float64)
            scale = abs(s_r) @ np.abs(v_r.astype(np.float64))
            tag = f"{name}_{np.dtype(dt).name}"
            out.append(check(tag, scaled_err(y, ref, scale), tol_of(dt),
                             rung=plan.kind, nnz=int(s.nnz),
                             prepare_s=prep))
            out.append(check(f"{tag}_rung", 0.0 if plan.kind == want
                             else np.inf, 0.0, rung=plan.kind, want=want))
    return out


def phase_spmm(nb: int, k: int, expect_route: str | None = None,
               seed: int = 0) -> list:
    """``bell_spmm`` at f32 on the benchmark's block band, against one
    SciPy BSR product in float64; then ``jax.grad`` of
    ``sum(w * bell_spmm(A, b))`` w.r.t. the operand (``A^T w`` by SciPy)
    and the blocks (``w_r @ b_c^T`` per slot, NumPy in float64)."""
    import jax
    import jax.numpy as jnp

    from sparse_tpu.formats.bell import (
        BELL,
        _spmm_route,
        bell_from_bsr,
        bell_spmm,
    )
    from sparse_tpu.formats.bsr import BSR
    from sparse_tpu.ops.segmented import INDEX_DTYPE

    rows, cols, blocks, b, a64 = block_band(nb)
    b = np.ascontiguousarray(b[:, :k])
    bsz = blocks.shape[1]
    a = bell_from_bsr(BSR(indices=(rows * nb + cols).astype(INDEX_DTYPE),
                          blocks=blocks, n=nb * bsz, bsz=bsz))
    route = _spmm_route(a, k, jnp.float32)
    y = np.asarray(jax.jit(bell_spmm)(a, jnp.asarray(b)))
    b64 = b.astype(np.float64)
    out = [check("bell_spmm_f32", scaled_err(y, a64 @ b64,
                                             abs(a64) @ np.abs(b64)),
                 F32_TOL, route=route, nnz=int(rows.size * bsz * bsz), k=k)]
    if expect_route is not None:
        out.append(check("bell_spmm_route", 0.0 if route == expect_route
                         else np.inf, 0.0, route=route, want=expect_route))

    def loss(blocks, b, cols, w):
        return jnp.sum(w * bell_spmm(
            BELL(cols=cols, blocks=blocks, n=a.n, bsz=bsz), b))

    w = np.random.default_rng(seed).standard_normal(b.shape).astype(
        np.float32)
    dblocks, db = jax.jit(jax.grad(loss, argnums=(0, 1)))(
        a.blocks, jnp.asarray(b), a.cols, jnp.asarray(w))
    w64 = w.astype(np.float64)
    out.append(check("bell_spmm_grad_operand_f32",
                     scaled_err(db, a64.T @ w64, abs(a64).T @ np.abs(w64)),
                     F32_TOL))
    wr = w64.reshape(nb, 1, bsz, k)
    panels = b64.reshape(nb, bsz, k)[np.asarray(a.cols)].swapaxes(2, 3)
    out.append(check("bell_spmm_grad_blocks_f32",
                     scaled_err(dblocks, wr @ panels,
                                np.abs(wr) @ np.abs(panels)), F32_TOL))
    return out


def phase_spgemm(cases: dict) -> list:
    """``spgemm(A, A, method="auto")`` at f32: the route taken, the stored
    pattern (exactly every realized product), and the values against
    SciPy in float64.  ``cases``: name -> (SciPy matrix, expected route)."""
    from sparse_tpu import spgemm
    from sparse_tpu.ops.spgemm import _spgemm_route

    out = []
    for name, (s, want) in cases.items():
        a = to_csr(s, np.float32)
        route = _spgemm_route(a, a)[0]
        c = csr_to_scipy(spgemm(a, a))
        pat = structure(s) @ structure(s)
        pat.sort_indices()
        c.sort_indices()
        same = (np.array_equal(c.indptr, pat.indptr)
                and np.array_equal(c.indices, pat.indices))
        out.append(check(f"{name}_route", 0.0 if route == want else np.inf,
                         0.0, route=route, want=want))
        out.append(check(f"{name}_pattern", 0.0 if same else np.inf, 0.0,
                         nnz_out=int(c.nnz), nnz_want=int(pat.nnz)))
        s_r = rounded(s, np.float32)
        err = scaled_err((c - s_r @ s_r).data, 0.0,
                         (abs(s_r) @ abs(s_r)).data)
        out.append(check(f"{name}_values_float32", err, F32_TOL))
    return out


def lu_system(nb: int, bsz: int, seed: int = 0):
    """Block-banded (half band 2) SPD matrix with every diagonal twice its
    row's off-diagonal absolute sum (condition < 3), as a dense array."""
    rng = np.random.default_rng(seed)
    n = nb * bsz
    mask = np.zeros((nb, nb), bool)
    for off in range(-2, 3):
        mask |= np.eye(nb, k=off, dtype=bool)
    x = rng.standard_normal((n, n)) * np.kron(mask, np.ones((bsz, bsz)))
    x = (x + x.T) / 2
    np.fill_diagonal(x, 0.0)
    np.fill_diagonal(x, 2 * np.abs(x).sum(axis=1) + 1.0)
    return x


def phase_lu(nb: int, bsz: int, seed: int = 0) -> list:
    """``bsr_lup`` + ``bsr_ols`` at f64 against ``scipy.linalg``."""
    import jax.numpy as jnp
    import scipy.linalg as sla

    from sparse_tpu import bsr_from_dense, bsr_ols

    dense = lu_system(nb, bsz, seed)
    b = np.random.default_rng(seed + 1).standard_normal(dense.shape[0])
    x = np.asarray(bsr_ols(bsr_from_dense(jnp.asarray(dense), bsz),
                           jnp.asarray(b)))
    ref = sla.lu_solve(sla.lu_factor(dense), b)
    err = np.linalg.norm(x - ref) / np.linalg.norm(ref)
    return [check("bsr_ols_f64", err, F64_TOL, n=int(dense.shape[0]),
                  bsz=bsz)]


def cg_reference(s, b, iters: int) -> np.ndarray:
    """Plain NumPy/SciPy CG with the library's recurrence, from x0 = 0."""
    x = np.zeros_like(b)
    r = b.copy()
    p = r.copy()
    rs = r @ r
    for _ in range(iters):
        ap = s @ p
        denom = p @ ap
        alpha = rs / denom if denom else 0.0
        x += alpha * p
        r -= alpha * ap
        rs_new = r @ r
        p = r + (rs_new / rs if rs else 0.0) * p
        rs = rs_new
    return x


def relative_residual(s, x, b) -> float:
    return float(np.linalg.norm(b - s @ x) / np.linalg.norm(b))


def _cg_on_mesh(a, b, mesh, iters: int, partition):
    import jax
    import jax.numpy as jnp

    from sparse_tpu.parallel import cg_solve
    from sparse_tpu.parallel.pcsr import shard_vector

    part = partition(a, mesh)
    bs = shard_vector(jnp.asarray(b), part, mesh)
    solve = jax.jit(lambda part, b: cg_solve(part, b, mesh, iters=iters))
    return part, np.asarray(solve(part, bs))[: b.shape[0]]


def cg_rhs(s, seed: int = 0) -> np.ndarray:
    """``b = A x`` for a random x: the FEM fixtures carry a near-null mode
    (a 1e-8 shift pins the Neumann nullspace), and a right-hand side in
    A's range keeps CG off it."""
    return s @ np.random.default_rng(seed).standard_normal(s.shape[1])


def phase_cg(s, iters: int, seed: int = 0) -> list:
    """``cg_solve`` over ``halo_partition`` on a 1-device mesh (f64),
    checked by the SciPy residual of the returned x."""
    from sparse_tpu.parallel import halo_partition, make_1d_mesh

    b = cg_rhs(s, seed)
    _, x = _cg_on_mesh(to_csr(s, np.float64), b, make_1d_mesh(1), iters,
                       halo_partition)
    res = relative_residual(s, x, b)
    res_ref = relative_residual(s, cg_reference(s, b, iters), b)
    return [check("cg_halo_1dev_residual", res,
                  CG_RESIDUAL_FACTOR * res_ref, iters=iters,
                  numpy_cg_residual=res_ref)]


# -- the multi-device phase ----------------------------------------------------


def _spans(arr, n: int) -> bool:
    """Whether ``arr``'s shards sit on ``n`` distinct devices."""
    return len({sh.device for sh in arr.addressable_shards}) == n


def pcsr_to_scipy(p):
    """A row-partitioned CSR result gathered into one SciPy matrix."""
    import scipy.sparse as sp

    data, idx, ptr = (np.asarray(p.data), np.asarray(p.indices),
                      np.asarray(p.indptr).astype(np.int64))
    n, m = p.shape
    rows_p = p.rows_per_shard
    parts = []
    for d in range(ptr.shape[0]):
        lo, hi = d * rows_p, min((d + 1) * rows_p, n)
        if hi <= lo:
            continue
        k = int(ptr[d, hi - lo])
        parts.append(sp.csr_matrix(
            (data[d, :k].astype(np.float64), idx[d, :k], ptr[d, :hi - lo + 1]),
            shape=(hi - lo, m)))
    return sp.vstack(parts).tocsr()


def phase_multi(poisson, elasticity, powerlaw, n_dev: int, iters: int,
                seed: int = 0) -> list:
    """The multi-device paths on an ``n_dev`` mesh, each against the same
    operation on one device in this process and against SciPy (f64)."""
    import jax
    import jax.numpy as jnp

    from sparse_tpu import bsr_smsmm_apply, bsr_smsmm_prepare, bsr_to_csr
    from sparse_tpu import csr_to_bsr, smvm_prepare
    from sparse_tpu.parallel import (
        build_pbsr_smsmm_plan,
        build_pspgemm_plan,
        halo_partition,
        halo_partition_overlapped,
        halo_spmv_overlapped,
        make_1d_mesh,
        pbsr_from_bsr,
        pbsr_smsmm,
        pbsr_to_bsr,
        pcsr_from_csr,
        pcsr_spgemm_aa,
        phub_partition,
        phub_spmv,
    )
    from sparse_tpu.parallel.pcsr import shard_vector

    if len(jax.devices()) < n_dev:
        raise SystemExit(f"--chips {n_dev}: only {len(jax.devices())} "
                         "devices visible")
    mesh, mesh1 = make_1d_mesh(n_dev), make_1d_mesh(1)
    rng = np.random.default_rng(seed + 1)
    out = []

    # halo CG: n_dev devices vs one device vs SciPy's residual
    a = to_csr(poisson, np.float64)
    b = cg_rhs(poisson, seed)
    part, x = _cg_on_mesh(a, b, mesh, iters, halo_partition)
    _, x1 = _cg_on_mesh(a, b, mesh1, iters, halo_partition)
    out.append(check("halo_shards_span_devices",
                     0.0 if _spans(part.data, n_dev) else np.inf, 0.0))
    res, res1 = (relative_residual(poisson, x, b),
                 relative_residual(poisson, x1, b))
    res_ref = relative_residual(poisson, cg_reference(poisson, b, iters), b)
    out.append(check("cg_halo_residual", res, CG_RESIDUAL_FACTOR * res_ref,
                     iters=iters, numpy_cg_residual=res_ref))
    # same recurrence, another summation order: CG amplifies rounding
    # differences, so the two residuals agree within the same factor
    out.append(check("cg_halo_residual_vs_1dev", max(res / res1, res1 / res),
                     CG_RESIDUAL_FACTOR, residual_1dev=res1))

    def matvec_checks(name, s, part, fn):
        v = rng.standard_normal(s.shape[1])
        vs = shard_vector(jnp.asarray(v), part, mesh)
        y = np.asarray(jax.jit(lambda p, v: fn(p, v, mesh))(part, vs))
        y = y[: s.shape[0]]
        y1 = np.asarray(smvm_prepare(to_csr(s, np.float64)).apply(
            jnp.asarray(v)))
        scale = abs(s) @ np.abs(v)
        out.append(check(f"{name}_vs_scipy", scaled_err(y, s @ v, scale),
                         F64_TOL))
        out.append(check(f"{name}_vs_1dev", scaled_err(y, y1, scale),
                         F64_TOL))

    hp = halo_partition_overlapped(a, mesh)
    matvec_checks("halo_spmv_overlapped", poisson, hp, halo_spmv_overlapped)
    ph = phub_partition(to_csr(powerlaw, np.float64), mesh)
    out.append(check("phub_shards_span_devices",
                     0.0 if _spans(ph.tail_data, n_dev) else np.inf, 0.0))
    matvec_checks("phub_spmv", powerlaw, ph, phub_spmv)

    # pbsr_smsmm: elasticity at its natural 2x2 blocks
    ab = csr_to_bsr(to_csr(elasticity, np.float64), 2)
    pa = pbsr_from_bsr(ab, mesh)
    cb = pbsr_to_bsr(pbsr_smsmm(pa, pa, mesh,
                                build_pbsr_smsmm_plan(pa, pa, mesh)))
    c = csr_to_scipy(bsr_to_csr(cb))
    c1 = csr_to_scipy(bsr_to_csr(
        bsr_smsmm_apply(bsr_smsmm_prepare(ab, ab), ab, ab)))
    scale = (abs(elasticity) @ abs(elasticity)).data
    out.append(check("pbsr_smsmm_shards_span_devices",
                     0.0 if _spans(pa.blocks, n_dev) else np.inf, 0.0))
    out.append(check("pbsr_smsmm_vs_scipy", scaled_err(
        (c - elasticity @ elasticity).data, 0.0, scale), F64_TOL))
    out.append(check("pbsr_smsmm_vs_1dev", scaled_err((c - c1).data, 0.0,
                                                      scale), F64_TOL))

    # pcsr_spgemm_aa: Poisson A @ A, values-only row exchange
    pp = pcsr_from_csr(a, mesh)
    c = pcsr_to_scipy(pcsr_spgemm_aa(pp, pp, mesh,
                                     build_pspgemm_plan(pp, pp, mesh)))
    pat = structure(poisson) @ structure(poisson)
    pat.sort_indices()
    c.sort_indices()
    same = (np.array_equal(c.indptr, pat.indptr)
            and np.array_equal(c.indices, pat.indices))
    out.append(check("pcsr_spgemm_aa_pattern", 0.0 if same else np.inf, 0.0))
    out.append(check("pcsr_spgemm_aa_vs_scipy", scaled_err(
        (c - poisson @ poisson).data, 0.0,
        (abs(poisson) @ abs(poisson)).data), F64_TOL))
    return out


# -- driver ----------------------------------------------------------------------


def run_phase(name: str, fn, *args, **kw) -> bool:
    """Run one phase, print its line, return whether every check passed.
    Exceptions propagate: a phase that raises ends the run non-zero."""
    c0 = _COMPILE_S[0]
    t0 = time.perf_counter()
    checks = fn(*args, **kw)
    rec = {"phase": name, "ok": all(c["ok"] for c in checks),
           "seconds": time.perf_counter() - t0,
           "compile_s": _COMPILE_S[0] - c0,
           "peak_bytes_in_use": _peak_bytes(), "checks": checks}
    print(json.dumps(rec), flush=True)
    return rec["ok"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1,
                    help="4: run only the multi-device phases on 4 GPUs")
    args = ap.parse_args(argv)

    import jax

    from sparse_tpu.utils.profiling import use_compile_cache

    jax.config.update("jax_enable_x64", True)
    platform = jax.devices()[0].platform
    if platform != "gpu":
        print(f"no GPU: JAX's default device is {platform!r}; nothing run",
              file=sys.stderr)
        return 1
    jax.monitoring.register_event_duration_secs_listener(_on_duration)
    rec = phase_device()
    use_compile_cache(ROOT)
    t_start = time.perf_counter()
    z = SIZES
    poisson = fixture("poisson_fem", n_points=z["poisson_points"], seed=0)
    elasticity = fixture("elasticity_fem", n_points=z["elasticity_points"],
                         seed=1)
    powerlaw = fixture("powerlaw_graph", n=z["powerlaw_n"], m=z["powerlaw_m"],
                       seed=2)
    print(json.dumps({"setup": "fixtures (host, from seeds)",
                      "seconds": time.perf_counter() - t_start}), flush=True)
    if args.chips == 4:
        ok = run_phase("multi", phase_multi, poisson, elasticity, powerlaw,
                       n_dev=4, iters=z["cg_iters"])
    else:
        oks = [
            run_phase("fixture", phase_fixture),
            run_phase("spmv", phase_spmv, {
                "fem_poisson_1m": (poisson, "xla"),
                "fem_elasticity_400k": (elasticity, "xla"),
                "graph_powerlaw_1m": (powerlaw, "xla"),
                "block_band_500k": (block_band(z["band_nb"])[-1].tocsr(),
                                    "bell"),
            }),
            run_phase("spmm", phase_spmm, z["band_nb"], z["band_k"],
                      expect_route="triton"),
            run_phase("spgemm", phase_spgemm, {
                "fem_elasticity_400k": (elasticity, "block"),
                "fem_poisson_250k": (fixture(
                    "poisson_fem", n_points=z["spgemm_poisson_points"],
                    seed=0), "esc"),
            }),
            run_phase("lu", phase_lu, z["lu_nb"], z["lu_bsz"]),
            run_phase("cg", phase_cg, poisson, z["cg_iters"]),
        ]
        ok = all(oks)
    print(json.dumps({"total_seconds": time.perf_counter() - t_start,
                      "compile_s": _COMPILE_S[0]}), flush=True)
    if not ok:
        print("smoke FAILED: see the phases with \"ok\": false",
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": rec}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

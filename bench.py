"""Headline benchmark: blocked-ELL SpMM (``bell_spmm``) on one GPU.

Config (BASELINE.md config 3, sparse x dense tall-skinny): SpMM with k=128
against a synthetic FEM-style block-banded operator (bcsstk-shaped: dense
32x32 blocks on a 5-block band), 500k rows, ~80M nnz.  The measured op is
``bell_spmm`` as the library routes it on this device (``path`` in the
output); ``--compare`` also times the plain XLA formulation
(``bell_spmm_xla``) in the same process, and ``--dtype bf16`` streams both
operands at half width with float32 accumulation.

The script exits non-zero unless JAX's default device is a GPU.  It prints
the card's name and power limit, then ONE JSON line:
  {"metric": ..., "value": N, "unit": "GB/s", "vs_baseline": N, ...}

``value`` is the pattern-intrinsic traffic (blocks once, each operand row
once, output once: ``utils.stats.blocked_min_bytes``) over the measured
time, and ``roofline_frac`` divides it by the card's published bandwidth
(``benchmarks/peaks.py``).  ``vs_baseline`` is the speedup over one SciPy
BSR sparse x dense product on this host (BASELINE.md names the SciPy
re-execution of the reference's semantics as the baseline).

Timing is dependency-chained inside one jit (iterate B <- A B; the operator
is 0.01-scaled so a 5-step chain stays numerically tame), so nothing can be
hoisted and per-call dispatch stays out of the time.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

_T0 = time.time()
ROOT = Path(__file__).resolve().parent


def _mark(stage: str) -> None:
    """Stage timestamps on stderr, so a stall is attributable to a stage."""
    print(f"[bench {time.time() - _T0:7.1f}s] {stage}", file=sys.stderr,
          flush=True)


BSZ = 32
HALF_BAND = 2  # blocks each side of the diagonal
NB = 15_625  # block rows -> n = 500k
K = 128  # dense operand width
K_CHAIN = 5


def build_block_band(nb=NB, bsz=BSZ, half_band=HALF_BAND, seed=0):
    """FEM-style block-banded pattern: block row i holds blocks at columns
    [i-half_band, i+half_band] clamped to [0, nb).

    Values are drawn from a ~1M-sample normal pool and index-tiled up to the
    80M-element operand (sampling every element costs minutes of host RNG
    without changing what is measured).  The pool period (a prime) is
    coprime to the block count, so no two adjacent block rows repeat the
    same block."""
    rng = np.random.default_rng(seed)
    rows = []
    cols = []
    for off in range(-half_band, half_band + 1):
        r = np.arange(max(0, -off), min(nb, nb - off), dtype=np.int64)
        rows.append(r)
        cols.append(r + off)
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    pool = (rng.standard_normal(1021 * bsz * bsz).astype(np.float32) * 0.01)
    pool = pool.reshape(1021, bsz, bsz)
    blocks = pool[np.arange(rows.size) % 1021]
    bpool = (rng.standard_normal(8191 * K).astype(np.float32) * 0.01)
    bpool = bpool.reshape(8191, K)
    b = bpool[np.arange(nb * bsz) % 8191]
    return rows, cols, blocks, b


def scipy_time(rows, cols, blocks, b, iters=2):
    """Best seconds of one SciPy BSR sparse x dense product, after a
    warm-up product."""
    import scipy.sparse as sp

    nb = int(rows.max()) + 1
    bsz = blocks.shape[1]
    indptr = np.zeros(nb + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=nb), out=indptr[1:])
    a = sp.bsr_matrix((blocks, cols, indptr), shape=(nb * bsz, nb * bsz))
    a @ b  # warm
    best = np.inf
    for _ in range(iters):
        t0 = time.perf_counter()
        a @ b
        best = min(best, time.perf_counter() - t0)
    return best


def device_bell(rows, cols, nb, bsz=BSZ):
    """The BELL layout built on the device: the pattern (cols, slot
    validity) on the host, the values from a device-side normal pool with
    the same distribution as :func:`build_block_band`'s."""
    import jax
    import jax.numpy as jnp

    from sparse_tpu.formats.bell import BELL
    from sparse_tpu.ops.segmented import INDEX_DTYPE

    lens = np.bincount(rows, minlength=nb)
    Lb = int(lens.max())
    starts = np.zeros(nb + 1, np.int64)
    np.cumsum(lens, out=starts[1:])
    slot = np.arange(rows.size) - starts[rows]
    cols_np = np.zeros((nb, Lb), np.int32)
    cols_np[rows, slot] = cols
    slot_valid = np.arange(Lb)[None, :] < lens[:, None]
    pool = jax.random.normal(jax.random.PRNGKey(0), (1021, bsz, bsz),
                             jnp.float32) * 0.01
    idx = jnp.asarray((np.arange(nb * Lb) % 1021).astype(np.int32))
    blocks = (pool[idx].reshape(nb, Lb, bsz, bsz)
              * jnp.asarray(slot_valid, jnp.float32)[:, :, None, None])
    return BELL(cols=jnp.asarray(cols_np, INDEX_DTYPE), blocks=blocks,
                n=nb * bsz, bsz=bsz)


def chain_time(spmm, a, b, iters=3):
    """Best seconds per product of a ``K_CHAIN``-step chain B <- A B."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def chain(a, b):
        return jnp.sum(jax.lax.fori_loop(0, K_CHAIN,
                                         lambda _, b: spmm(a, b), b))

    float(chain(a, b))  # compile + first run
    best = np.inf
    for _ in range(iters):
        t0 = time.perf_counter()
        float(chain(a, b))
        best = min(best, time.perf_counter() - t0)
    return best / K_CHAIN


def gpu_times(rows, cols, nb=NB, k=K, compute_dtype=None, compare=False,
              iters=3):
    """``{path: seconds per product}`` for ``bell_spmm`` as routed (key =
    the route taken) and, with ``compare``, the XLA formulation."""
    import jax
    import jax.numpy as jnp

    from sparse_tpu.formats.bell import _spmm_route, bell_spmm, bell_spmm_xla

    a = device_bell(rows, cols, nb)
    b = jax.random.normal(jax.random.PRNGKey(1), (nb * BSZ, k),
                          jnp.float32) * 0.01
    _mark("bell layout on device")
    route = _spmm_route(a, k, compute_dtype or jnp.float32)
    out = {route: chain_time(
        lambda a, b: bell_spmm(a, b, compute_dtype=compute_dtype), a, b,
        iters)}
    _mark(f"timed bell_spmm ({route})")
    if compare and route != "xla":
        out["xla"] = chain_time(
            lambda a, b: bell_spmm_xla(a, b, compute_dtype=compute_dtype),
            a, b, iters)
        _mark("timed bell_spmm_xla")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--compare", action="store_true",
                    help="also time the plain XLA formulation")
    ap.add_argument("--dtype", choices=("f32", "bf16"), default="f32",
                    help="operand stream dtype (accumulation is float32)")
    args = ap.parse_args(argv)

    import jax.numpy as jnp

    from sparse_tpu.utils.profiling import (
        card_info,
        require_gpu,
        use_compile_cache,
    )
    from sparse_tpu.utils.stats import blocked_min_bytes, nnz_roofline

    dev = require_gpu()
    use_compile_cache(ROOT)
    sys.path.insert(0, str(ROOT / "benchmarks"))
    from peaks import peak_for

    peak = peak_for(dev["kind"])
    print(f"card: {card_info()}")
    print(f"device: {json.dumps(dev)}")
    rows, cols, blocks, b = build_block_band()
    _mark("matrix built (host)")
    t_ref = scipy_time(rows, cols, blocks, b)
    _mark(f"scipy baseline done ({t_ref * 1000:.1f} ms)")
    cdt = jnp.bfloat16 if args.dtype == "bf16" else None
    times = gpu_times(rows, cols, compute_dtype=cdt, compare=args.compare)
    nbz = rows.size
    n = NB * BSZ
    nnz = nbz * BSZ * BSZ
    vb = 2 if args.dtype == "bf16" else 4
    min_bytes = blocked_min_bytes(nbz, BSZ, n, K, value_bytes=vb)
    recs = []
    for path, t in times.items():
        rl = nnz_roofline(nnz, k=K, min_bytes=min_bytes,
                          hbm_gbps=peak.hbm_gbps, seconds=t)
        recs.append({
            "metric": f"bell_spmm_k{K}_{args.dtype}_block_banded_500k",
            "path": path,
            "value": min_bytes / t / 1e9,
            "unit": "GB/s",
            "vs_baseline": t_ref / t,
            "roofline_frac": rl["frac_of_nnz_roofline"],
            "gflops": 2 * nnz * K / t / 1e9,
            "frac_of_f32_peak": (2 * nnz * K / t / 1e12 / peak.f32_tflops
                                 if args.dtype == "f32" else None),
            "ms_per_spmm": t * 1e3,
            "device": dev,
        })
    for rec in recs[1:]:
        print(json.dumps(rec))
    print(json.dumps(recs[0]))


if __name__ == "__main__":
    main()

"""Observability: per-matrix structure stats and roofline accounting.

The reference's only introspection is ``nnz`` (SURVEY.md §5.5); our build adds
structured per-op stats (nnz, row-length distribution, imbalance) and
achieved-vs-roofline bandwidth reporting, since the performance target is %
of the memory-bound roofline (BASELINE.md)."""

from __future__ import annotations

import dataclasses

import numpy as np

from ..formats.csr import CSR

__all__ = ["matrix_stats", "spmv_bytes", "roofline_report",
           "bell_stats", "BellStats", "csr_block_fill", "detect_block_size",
           "csr_min_bytes", "blocked_min_bytes", "nnz_roofline"]


@dataclasses.dataclass(frozen=True)
class MatrixStats:
    shape: tuple[int, int]
    nse: int
    nnz: int
    row_min: int
    row_max: int
    row_mean: float
    row_imbalance: float  # max / mean row length (1.0 = perfectly balanced)

    def __str__(self) -> str:
        return (
            f"{self.shape[0]}x{self.shape[1]}: nnz={self.nnz} (capacity {self.nse}), "
            f"rows [{self.row_min}, {self.row_max}] mean {self.row_mean:.1f}, "
            f"imbalance {self.row_imbalance:.2f}x"
        )


def matrix_stats(a: CSR) -> MatrixStats:
    """Host-side structural summary of a CSR matrix."""
    indptr = np.asarray(a.indptr)
    lens = indptr[1:] - indptr[:-1]
    data = np.asarray(a.data)
    valid = int(indptr[-1])
    mean = float(lens.mean()) if lens.size else 0.0
    return MatrixStats(
        shape=a.shape,
        nse=a.nse,
        nnz=int(np.count_nonzero(data[:valid])),
        row_min=int(lens.min()) if lens.size else 0,
        row_max=int(lens.max()) if lens.size else 0,
        row_mean=mean,
        row_imbalance=float(lens.max() / mean) if mean > 0 else 1.0,
    )


def spmv_bytes(a: CSR, k: int = 1, value_bytes: int | None = None) -> int:
    """Device-memory traffic of one SpMV/SpMM: values + column indices + one
    gathered operand row per stored entry + row pointers + output."""
    vb = value_bytes or np.dtype(np.asarray(a.data).dtype).itemsize
    nse = int(np.asarray(a.indptr)[-1])
    n, m = a.shape
    return nse * (vb + 4 + vb * k) + (n + 1) * 4 + n * k * vb


def roofline_report(a: CSR, seconds: float, k: int = 1,
                    hbm_gbps: float | None = None) -> dict:
    """Achieved effective bandwidth (and roofline fraction when the card's
    memory bandwidth is supplied) for a measured SpMV/SpMM time."""
    b = spmv_bytes(a, k)
    gbps = b / seconds / 1e9
    nse = int(np.asarray(a.indptr)[-1])
    out = {
        "bytes": b,
        "effective_gbps": gbps,
        "nnz_per_s": nse * k / seconds,
    }
    if hbm_gbps:
        out["roofline_fraction"] = gbps / hbm_gbps
    return out


def csr_min_bytes(a: CSR, k: int = 1) -> int:
    """Pattern-INTRINSIC minimum device-memory bytes of one SpMV/SpMM:
    every stored value read once, every DISTINCT operand entry read once
    (column reuse is creditable — a perfect kernel serves it from cache),
    every output entry written once.  Index/metadata traffic is EXCLUDED:
    it is plan-dependent (BELL encodes structure at 4 B per block, CSR
    gathers pay 4 B/nnz) and belongs to the *plan* term of
    :func:`nnz_roofline`.  This is the denominator of
    the BASELINE "%% of memory-roofline nnz/s" target: no kernel for this
    pattern can move fewer bytes."""
    vb = np.dtype(np.asarray(a.data).dtype).itemsize
    indptr = np.asarray(a.indptr)
    nse = int(indptr[-1]) if indptr.size else 0
    uniq = int(np.unique(np.asarray(a.indices)[:nse]).size)
    n, _ = a.shape
    return nse * vb + uniq * k * vb + n * k * vb


def blocked_min_bytes(stored_blocks: int, bsz: int, n: int, k: int = 1,
                      value_bytes: int = 4,
                      operand_entries: int | None = None) -> int:
    """Pattern-intrinsic minimum bytes for a blocked (BSR/BELL) SpMV/SpMM:
    stored block values once, each distinct operand entry once
    (``operand_entries`` defaults to ``n * k`` — every column touched, true
    for bands), output once.  Same exclusions as :func:`csr_min_bytes`."""
    if operand_entries is None:
        operand_entries = n * k
    return (stored_blocks * bsz * bsz * value_bytes
            + operand_entries * value_bytes + n * k * value_bytes)


def nnz_roofline(nnz: int, k: int = 1, *, min_bytes: int,
                 hbm_gbps: float,
                 plan_bytes: int | None = None,
                 seconds: float | None = None) -> dict:
    """The nnz/s roofline model (BASELINE config 2/3's target metric).

    ``min_bytes`` (:func:`csr_min_bytes` / :func:`blocked_min_bytes`) sets
    the pattern-intrinsic ceiling at the card's memory bandwidth
    ``hbm_gbps`` (GB/s, from the benchmark's peak table or a copy measured
    in the same run): ``ceiling_gnnzps = hbm_gbps * nnz * k / min_bytes``.
    ``plan_bytes`` (the traffic a specific plan actually moves) adds
    ``plan_ceiling_gnnzps`` and ``structural_frac = plan_ceiling /
    ceiling``: the fraction of the pattern roofline THIS plan can reach
    even at perfect execution.  With ``seconds``: ``achieved_gnnzps``,
    ``frac_of_nnz_roofline`` (vs the intrinsic ceiling) and
    ``frac_of_plan_ceiling`` (vs the plan's own bound)."""
    eff = nnz * k
    t_intr = min_bytes / (hbm_gbps * 1e9)
    out = {
        "min_bytes": int(min_bytes),
        "min_bytes_per_nnz": min_bytes / max(eff, 1),
        "ceiling_gnnzps": eff / t_intr / 1e9 if t_intr else float("inf"),
    }
    t_plan = None
    if plan_bytes is not None:
        t_plan = plan_bytes / (hbm_gbps * 1e9)
        out["plan_ceiling_gnnzps"] = eff / t_plan / 1e9 if t_plan else float("inf")
        out["structural_frac"] = t_intr / t_plan if t_plan else 1.0
    if seconds:
        out["achieved_gnnzps"] = eff / seconds / 1e9
        out["frac_of_nnz_roofline"] = t_intr / seconds
        if t_plan:
            out["frac_of_plan_ceiling"] = t_plan / seconds
    return out


def csr_block_fill(a: CSR, bsz: int) -> float:
    """Stored-entry density of the bsz x bsz blocks a CSR pattern touches
    (host-side, one O(nnz log nnz) pass): nnz / (touched_blocks * bsz^2).

    1.0 means every touched block is fully stored — re-blocking to BSR/BELL
    at this bsz costs ZERO storage blow-up and (for SpGEMM) preserves the
    reference's exact stored-structure semantics; low values mean the
    bsz^2/fill blow-up would eat the block paths' granule win.  Operates
    on the stored pattern (explicit zeros count as stored, matching
    compressed.fut:162-164's storage notion)."""
    n, m = a.shape
    if bsz <= 0 or n % bsz or m % bsz:
        return 0.0
    indptr = np.asarray(a.indptr)
    nnz = int(indptr[-1])
    if nnz == 0:
        return 0.0
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    cols = np.asarray(a.indices)[:nnz].astype(np.int64)
    nbc = m // bsz
    key = (rows // bsz) * nbc + (cols // bsz)
    # distinct stored positions are guaranteed by CSR normalization, so the
    # distinct-block count is exact
    from ..native.plansort import argsort_u64

    ks = key[argsort_u64(key.astype(np.uint64))]
    blocks = 1 + int(np.count_nonzero(ks[1:] != ks[:-1]))
    return nnz / (blocks * bsz * bsz)


def detect_block_size(a: CSR, candidates=(8, 4, 2),
                      min_fill: float = 1.0) -> tuple[int, float]:
    """Largest candidate block size whose block fill reaches ``min_fill``,
    as ``(bsz, fill)``; ``(1, 1.0)`` when none qualifies (scalar storage).

    With the default ``min_fill=1.0`` this finds *natural* block structure
    (vector-valued FEM: 2x2/3x3 dofs per mesh node) where re-blocking is
    free and exact; the dispatchers use it to route clustered matrices onto
    the block SpGEMM / BELL paths automatically."""
    for bsz in sorted(set(candidates), reverse=True):
        if bsz < 2:
            continue
        f = csr_block_fill(a, bsz)
        if f >= min_fill:
            return bsz, f
    return 1, 1.0


@dataclasses.dataclass(frozen=True)
class BellStats:
    shape: tuple[int, int]
    nb: int
    bsz: int
    Lb: int
    stored_blocks: int
    nnz: int
    slot_fill: float   # stored blocks / (nb * Lb) — ELL padding overhead
    block_fill: float  # nonzero values / stored block elements

    def __str__(self) -> str:
        return (
            f"BELL {self.shape[0]}x{self.shape[1]} bsz={self.bsz} Lb={self.Lb}: "
            f"{self.stored_blocks} blocks (slot fill {self.slot_fill:.2f}), "
            f"nnz={self.nnz} (block fill {self.block_fill:.2f})"
        )


def bell_stats(a) -> BellStats:
    """Host-side structural summary of a blocked-ELL matrix: the two fill
    ratios that set its SpMV/SpMM efficiency (ELL slot padding from row-
    length skew, and in-block density from the re-blocking)."""
    blocks = np.asarray(a.blocks)
    stored = np.any(blocks != 0, axis=(2, 3))
    nstored = int(stored.sum())
    nnz = int(np.count_nonzero(blocks))
    slots = max(a.nb * a.Lb, 1)
    return BellStats(
        shape=(a.n, a.n),
        nb=a.nb,
        bsz=a.bsz,
        Lb=a.Lb,
        stored_blocks=nstored,
        nnz=nnz,
        slot_fill=nstored / slots,
        block_fill=nnz / max(nstored * a.bsz * a.bsz, 1),
    )

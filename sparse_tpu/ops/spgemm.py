"""SpGEMM: sparse x sparse matrix multiplication.

Semantics follow the reference's ``smsmm : sr[n][m] -> sc[m][k] -> sr[n][k]``
(compressed.fut:268-331): exact product with duplicate summation, stored
zeros preserved (cancellation produces explicit stored zeros, which ``nnz``
does not count).

The *algorithm* is deliberately different (per SURVEY.md §3.2 the reference's
all-targets expansion is Θ((nnzA·k + nnzB·n)·log) and was chosen for Futhark's
flat parallelism): we use the ESC (expand-sort-compress) row-wise Gustavson
formulation, which expands only *actual* multiply pairs — Θ(F log F) where F
= number of scalar products = sum over A entries of the matching B row length.

Static-shape protocol: the expansion size F is data-dependent, so the
jit-compatible core takes it as a static capacity.  The convenience wrapper
computes it eagerly (one host sync), mirroring how real sparse libraries do a
symbolic pass before the numeric pass.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..formats.coo import COO
from ..formats.csr import (
    CSC,
    CSR,
    _csc_as_csr_t,
    csr_empty,
    csr_from_coo,
    csr_to_coo,
)
from ..utils.precision import matmul_precision
from .segmented import (
    INDEX_DTYPE,
    cumsum_exclusive,
    expand,
    row_ids_from_indptr,
    segment_sum,
)


def _csc_to_csr(b: CSC) -> CSR:
    """Re-compress a CSC by rows (one device sort of nse entries)."""
    # The CSC's storage is the CSR of b^T; re-sorting its COO with axes
    # swapped yields the row-compressed form of b.
    t = _csc_as_csr_t(b)  # CSR of b^T, shape (k, m)
    coo_t = csr_to_coo(t)
    n_t, m_t = coo_t.shape
    pad = coo_t.row >= n_t
    swapped = COO(
        row=jnp.where(pad, jnp.asarray(m_t, INDEX_DTYPE), coo_t.col),
        col=jnp.where(pad, jnp.asarray(n_t, INDEX_DTYPE), coo_t.row),
        data=coo_t.data,
        shape=(m_t, n_t),
    )
    return csr_from_coo(swapped)


def spgemm_flops(a: CSR, b_rows: CSR) -> jax.Array:
    """Number of scalar products in A @ B (the expansion size F).

    This is the symbolic pass; eager callers concretize it to size the
    jit-compatible numeric pass.
    """
    sizes = _expansion_sizes(a, b_rows)
    return jnp.sum(sizes)


def _expansion_sizes(a: CSR, b_rows: CSR) -> jax.Array:
    """Per-A-entry count of partner entries in the matching B row."""
    n, m = a.shape
    if a.nse == 0:
        return jnp.zeros((0,), INDEX_DTYPE)
    a_rows = row_ids_from_indptr(a.indptr, a.nse)
    valid = a_rows < n
    b_row_len = (b_rows.indptr[1:] - b_rows.indptr[:-1]).astype(INDEX_DTYPE)
    safe_s = jnp.where(valid, a.indices, 0)
    if m == 0:
        return jnp.zeros((a.nse,), INDEX_DTYPE)
    return jnp.where(valid, b_row_len[safe_s], 0).astype(INDEX_DTYPE)


def spgemm_products(a: CSR, b_data, b_indices, b_starts, b_lens, k: int,
                    expansion_nse: int) -> COO:
    """ESC product expansion against a *generalized* row-compressed B given
    as (data, indices, per-row starts, per-row lengths) — rows need only be
    internally contiguous, which lets multi-shard gathered storage with
    per-shard padding gaps feed the same core (parallel/pspgemm.py).

    Returns the raw product COO (duplicates unmerged) with capacity
    ``expansion_nse``."""
    n, m = a.shape
    out_dtype = jnp.result_type(a.dtype, b_data.dtype)
    a_rows = row_ids_from_indptr(a.indptr, a.nse)
    valid = a_rows < n
    safe_s = jnp.where(valid, a.indices, 0)
    sizes = jnp.where(valid, b_lens[jnp.minimum(safe_s, max(m - 1, 0))], 0).astype(
        INDEX_DTYPE
    )
    elem_ids, inner_ids = expand(sizes, expansion_nse)
    live = elem_ids < a.nse
    e = jnp.where(live, elem_ids, 0)

    r = a_rows[e]  # target row (may be sentinel n for A padding)
    s = a.indices[e]  # shared index
    va = a.data[e]

    nse_b = b_data.shape[0]
    b_pos = b_starts[jnp.minimum(s, max(m - 1, 0))].astype(INDEX_DTYPE) + inner_ids
    b_pos = jnp.minimum(b_pos, max(nse_b - 1, 0))
    c = b_indices[b_pos]
    vb = b_data[b_pos]

    row = jnp.where(live & (r < n), r, jnp.asarray(n, INDEX_DTYPE))
    col = jnp.where(live & (r < n), c, jnp.asarray(k, INDEX_DTYPE))
    val = jnp.where(live & (r < n), va * vb, jnp.zeros((), out_dtype))
    return COO(row=row, col=col, data=val.astype(out_dtype), shape=(n, k))


# -- dense-accumulator path (``method="mxu"``, a historical name) ------------
#
# At moderate dimensions the ESC path is dominated not by arithmetic but by
# the lax.sort that merges duplicate (row, col) products — a sort a dense
# matrix product makes unnecessary.  Densify both operands (values AND a
# stored-entry indicator), do two dense matmuls (value product + pattern
# count), then compact the count>0 mask straight into row-major CSR with one
# cumsum.  The "wasted" dense FLOPs run at matrix-unit rates, which at
# n,m,k ≲ 4k is far cheaper than sorting F product pairs.  Semantics match
# the ESC path (compressed.fut:268-331): an output entry is *stored* iff some
# stored A entry meets a stored B entry (even when values cancel or are zero).

_MXU_DENSE_ELEMS = 64 * 1024 * 1024
"""Auto-dispatch budget: total dense elements (n*m + m*k + n*k) the dense
path may materialize (~768 MB at f32 across the three temporaries)."""


def _dense_values(a: CSR) -> jax.Array:
    """Dense [n, m] values (duplicates summed, padding dropped)."""
    n, m = a.shape
    rows = row_ids_from_indptr(a.indptr, a.nse)
    flat = jnp.where(rows < n, rows * m + a.indices, n * m).astype(INDEX_DTYPE)
    return jnp.zeros((n * m + 1,), a.dtype).at[flat].add(a.data)[:-1].reshape(n, m)


def _dense_pattern(a: CSR) -> jax.Array:
    """Dense [n, m] stored-entry indicator (1.0 where at least one stored
    entry, including explicit zeros; 0.0 elsewhere)."""
    n, m = a.shape
    rows = row_ids_from_indptr(a.indptr, a.nse)
    flat = jnp.where(rows < n, rows * m + a.indices, n * m).astype(INDEX_DTYPE)
    return (
        jnp.zeros((n * m + 1,), jnp.float32).at[flat].max(1.0)[:-1].reshape(n, m)
    )


def _pattern_mask(a: CSR, b: CSR) -> jax.Array:
    """Boolean [n, k] mask of stored output entries of A @ B.

    The count matmul is exact at default precision: every product is
    1.0*1.0 (exact in bf16 and TF32) and accumulates in f32, so the result
    is exactly the integer pair count for counts < 2**24 — and the mask
    only asks count > 0."""
    return jnp.matmul(_dense_pattern(a), _dense_pattern(b)) > 0.5


def _csr_from_dense_mask(vals: jax.Array, mask: jax.Array, cap: int) -> CSR:
    """Compact a dense value matrix + stored mask into CSR (capacity ``cap``)
    with a single cumsum — no sort.  If the true stored count exceeds ``cap``
    the result is truncated in row-major order (indptr clamped)."""
    n, k = vals.shape
    fm = mask.reshape(-1)
    pos = jnp.cumsum(fm.astype(INDEX_DTYPE)) - 1
    total = pos[-1] + 1
    flat_ids = jnp.arange(n * k, dtype=INDEX_DTYPE)
    tgt = jnp.where(fm, jnp.minimum(pos, cap), cap)
    packed = jnp.zeros((cap + 1,), INDEX_DTYPE).at[tgt].set(flat_ids)[:cap]
    live = jnp.arange(cap, dtype=INDEX_DTYPE) < jnp.minimum(total, cap)
    indices = jnp.where(live, packed % k, 0).astype(INDEX_DTYPE)
    data = jnp.where(live, vals.reshape(-1)[packed], jnp.zeros((), vals.dtype))
    indptr = jnp.minimum(
        cumsum_exclusive(jnp.sum(mask, axis=1, dtype=INDEX_DTYPE)), cap
    )
    return CSR(data=data, indices=indices, indptr=indptr, shape=(n, k))


@jax.jit
def spgemm_mxu_nse(a: CSR, b: CSR) -> jax.Array:
    """Stored-entry count of A @ B via the pattern matmul (the dense
    path's symbolic pass; eager callers concretize it to size the numeric pass)."""
    n, m = a.shape
    _, k = b.shape
    if a.nse == 0 or b.nse == 0 or n == 0 or m == 0 or k == 0:
        return jnp.zeros((), INDEX_DTYPE)
    return jnp.sum(_pattern_mask(a, b), dtype=INDEX_DTYPE)


@partial(jax.jit, static_argnames=("out_nse",))
def spgemm_mxu_csr_csr(a: CSR, b: CSR, out_nse: int) -> CSR:
    """jit-compatible dense-accumulator SpGEMM core: C = A @ B, both
    row-compressed.

    ``out_nse`` is the static result capacity (>= the true stored count, see
    :func:`spgemm_mxu_nse`; short capacities truncate row-major).  Caveat vs
    the ESC path: the dense value matmul touches *unstored* positions as 0.0,
    so non-finite stored values (inf/nan) can propagate to output entries the
    pair-wise ESC path leaves untouched.  Finite data is bit-compatible up to
    summation order."""
    n, m = a.shape
    m2, k = b.shape
    if m != m2:
        raise ValueError(f"spgemm: inner dims {a.shape} @ {b.shape}")
    out_dtype = jnp.result_type(a.dtype, b.dtype)
    if out_nse == 0 or a.nse == 0 or b.nse == 0 or n == 0 or m == 0 or k == 0:
        return csr_empty(n, k, out_nse, out_dtype)
    av = _dense_values(a).astype(out_dtype)
    bv = _dense_values(b).astype(out_dtype)
    cv = jnp.matmul(av, bv, precision=matmul_precision(av.dtype, bv.dtype))
    return _csr_from_dense_mask(cv.astype(out_dtype), _pattern_mask(a, b), out_nse)


def _mxu_eligible(a: CSR, b: CSR, budget: int = _MXU_DENSE_ELEMS) -> bool:
    n, m = a.shape
    _, k = b.shape
    dense_elems = n * m + m * k + n * k
    return (
        jnp.issubdtype(jnp.result_type(a.dtype, b.dtype), jnp.inexact)
        and dense_elems <= budget
        and max(n * m, m * k, n * k) < 2**31  # int32 flat indices
    )


_BLOCK_ROUTE_CANDIDATES = (32, 16, 8, 4, 2)
_BLOCK_ROUTE_MIN_NNZ = 4096
"""Below this stored-entry count the ESC core's sort is already sub-ms; the
two re-blocking sorts + block product would only add latency."""


def _spgemm_route(a: CSR, b_rows: CSR,
                  mxu_budget: int | None = None) -> tuple[str, int]:
    """Pick the SpGEMM core for ``method="auto"``: ``("mxu"|"block"|"esc",
    bsz)`` (bsz only meaningful for the block route).

    The dense-accumulator core stays preferred while its dense footprint
    fits — below that size its sort-free compaction needs no sort at all.
    Above it, ``bsr_smsmm_apply`` gathers whole bsz x bsz blocks per
    product instead of scalars.  The block route is taken only when
    BOTH stored patterns have *fully dense* natural blocks
    (``csr_block_fill == 1.0``): then re-blocking costs zero storage
    blow-up and the block product's stored structure at scalar granularity
    is exactly the reference's ``smsmm`` structure (compressed.fut:268-331)
    — every scalar position of a stored C block is a realized product pair.
    Matrices without that structure (uniform random) keep the scalar cores.
    """
    n, m = a.shape
    _, k = b_rows.shape
    if _mxu_eligible(a, b_rows,
                     _MXU_DENSE_ELEMS if mxu_budget is None else mxu_budget):
        return "mxu", 0
    if n == m == k and n > 0:
        nnz_a = int(np.asarray(a.indptr)[-1])
        nnz_b = int(np.asarray(b_rows.indptr)[-1])
        if min(nnz_a, nnz_b) >= _BLOCK_ROUTE_MIN_NNZ:
            import jax

            from ..formats.bsr import BSR_MAX_NB
            from ..utils.stats import csr_block_fill

            for bsz in _BLOCK_ROUTE_CANDIDATES:
                # beyond the int32 block-coordinate range BSR needs wide
                # (int64) indices, which require jax x64 mode
                if n % bsz or (n // bsz > BSR_MAX_NB
                               and not jax.config.jax_enable_x64):
                    continue
                if (csr_block_fill(a, bsz) == 1.0
                        and csr_block_fill(b_rows, bsz) == 1.0):
                    return "block", bsz
    return "esc", 0


def _spgemm_block(a: CSR, b_rows: CSR, bsz: int, compact: bool) -> CSR:
    """Block-routed SpGEMM: re-block both operands, multiply through the
    prepared block apply (``bsr_smsmm_prepare`` + ``bsr_smsmm_apply``), and
    return to scalar CSR keeping every stored block position (exact
    reference structure under the full-fill routing precondition).

    The route is eager anyway (host-synced stats), so the host symbolic
    pass stands in for the one-shot device expand-sort."""
    from ..formats.bsr import (
        bsr_smsmm_apply,
        bsr_smsmm_prepare,
        bsr_to_csr,
        csr_to_bsr,
    )

    ab = csr_to_bsr(a, bsz, compact=True)
    bb = csr_to_bsr(b_rows, bsz, compact=True)
    out = bsr_to_csr(bsr_smsmm_apply(bsr_smsmm_prepare(ab, bb), ab, bb))
    if compact:
        from ..formats.csr import csr_compact

        out = csr_compact(out)
    return out


@partial(jax.jit, static_argnames=("expansion_nse",))
def spgemm_csr_csr(a: CSR, b: CSR, expansion_nse: int) -> CSR:
    """jit-compatible ESC SpGEMM core: C = A @ B, both row-compressed.

    ``expansion_nse`` must be a static bound >= the true number of scalar
    products (see :func:`spgemm_flops`).  The result CSR has capacity
    ``expansion_nse`` with unique (row, col) entries packed at the front.
    Jitted at module level so eager calls hit the compile cache instead of
    dispatching the expand-sort-compress pipeline op-by-op.
    """
    n, m = a.shape
    m2, k = b.shape
    if m != m2:
        raise ValueError(f"spgemm: inner dims {a.shape} @ {b.shape}")
    out_dtype = jnp.result_type(a.dtype, b.dtype)
    if expansion_nse == 0 or a.nse == 0 or b.nse == 0:
        from ..formats.csr import csr_empty

        return csr_empty(n, k, expansion_nse, out_dtype)

    prods = spgemm_products(
        a,
        b.data,
        b.indices,
        b.indptr[:-1],
        (b.indptr[1:] - b.indptr[:-1]).astype(INDEX_DTYPE),
        k,
        expansion_nse,
    )
    return csr_from_coo(prods)


# -- symbolic/numeric split ----------------------------------------------------
#
# The sort in the ESC core is a *pattern* computation: which products exist
# and which output slot each lands in depends only on the two sparsity
# patterns.  Solvers that re-multiply the same patterns with fresh values
# (FEM Jacobians, AMG Galerkin triple products, graph contractions) should
# pay it once.  spgemm_prepare runs the symbolic pass eagerly (host numpy);
# spgemm_apply is the jit-compatible numeric pass: two gathers, a multiply,
# and one pre-sorted segment-sum — no sort, deterministic summation order.


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["a_pos", "b_pos", "seg", "indices", "indptr"],
    meta_fields=["shape"],
)
@dataclasses.dataclass(frozen=True)
class SpgemmPlan:
    """Pattern-static SpGEMM schedule from :func:`spgemm_prepare`.

    ``a_pos``/``b_pos``: storage positions of each scalar product's factors
    (``b_pos`` indexes the *prepared* operand's storage — for a CSC operand
    the column-to-row permutation is already composed in); ``seg``: the
    output slot of each product, non-decreasing; ``indices``/``indptr``: the
    result's CSR structure (capacity = exact stored count, explicit zeros
    included per reference semantics, compressed.fut:162-164)."""

    a_pos: jax.Array
    b_pos: jax.Array
    seg: jax.Array
    indices: jax.Array
    indptr: jax.Array
    shape: tuple[int, int]

    @property
    def nse_out(self) -> int:
        return self.indices.shape[0]

    @property
    def n_products(self) -> int:
        return self.a_pos.shape[0]


def spgemm_prepare(a: CSR, b) -> SpgemmPlan:
    """Symbolic SpGEMM pass (eager, host-side, once per pattern pair).

    Accepts B as CSR or CSC (the reference's ``smsmm`` takes CSC,
    compressed.fut:268); the plan binds to the ORIGINAL storage order, so
    :func:`spgemm_apply` never re-sorts values."""
    import numpy as np

    n, m = a.shape
    if isinstance(b, CSC):
        t = _csc_as_csr_t(b)  # CSR of b^T: storage order = b's storage order
        k = b.shape[1]
        bt_indptr = np.asarray(t.indptr)
        bt_indices = np.asarray(t.indices)
        nb_valid = int(bt_indptr[-1])
        # b^T entry (row=c, col=s) at position p  <->  b entry (s, c) at p
        b_rows_of = bt_indices[:nb_valid]  # B row (shared index s) per pos
        b_cols_of = np.repeat(
            np.arange(k, dtype=np.int64), np.diff(bt_indptr)
        )  # B col per pos
        from ..native.plansort import argsort_u64 as _argsort_u64

        perm = _argsort_u64(b_rows_of)  # row-compress B (stable)
        src_pos = perm  # prepared order -> original storage position
        b_idx_rows = b_rows_of[perm]
        b_idx_cols = b_cols_of[perm]
    elif isinstance(b, CSR):
        if b.shape[0] != m:
            raise ValueError(f"spgemm: inner dims {a.shape} @ {b.shape}")
        k = b.shape[1]
        b_indptr = np.asarray(b.indptr)
        b_indices = np.asarray(b.indices)
        nb_valid = int(b_indptr[-1])
        src_pos = np.arange(nb_valid, dtype=np.int64)
        b_idx_rows = np.repeat(
            np.arange(m, dtype=np.int64), np.diff(b_indptr)
        )
        b_idx_cols = b_indices[:nb_valid].astype(np.int64)
    else:
        raise TypeError(f"spgemm_prepare: expected CSR/CSC operand, got {type(b)}")

    b_starts = np.zeros(m + 1, np.int64)
    np.cumsum(np.bincount(b_idx_rows, minlength=m), out=b_starts[1:])
    b_lens = np.diff(b_starts)

    a_indptr = np.asarray(a.indptr).astype(np.int64)
    a_indices = np.asarray(a.indices)
    na_valid = int(a_indptr[-1])
    s = a_indices[:na_valid].astype(np.int64)
    sizes = b_lens[s] if m else np.zeros(na_valid, np.int64)
    F = int(sizes.sum())

    # native one-pass enumeration + radix sort + dedup (NumPy fallback is
    # result-identical; pinned by tests)
    from ..native.plansort import argsort_u64, spgemm_schedule

    native = spgemm_schedule(a_indptr, s, b_starts, b_idx_cols, src_pos,
                             k, F) if F else None
    if native is not None:
        a_pos_o, b_pos_o, seg, out_rows, out_indices = native
        nse_out = out_rows.size
    else:
        a_rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(a_indptr))
        starts = np.cumsum(sizes) - sizes
        prod_a = np.repeat(np.arange(na_valid, dtype=np.int64), sizes)
        inner = np.arange(F, dtype=np.int64) - starts[prod_a]
        prod_b = b_starts[s[prod_a]] + inner

        row = a_rows[prod_a]
        col = b_idx_cols[prod_b]
        order = argsort_u64(row * (k + 1) + col)
        row_o, col_o = row[order], col[order]
        head = np.ones(F, bool)
        head[1:] = (row_o[1:] != row_o[:-1]) | (col_o[1:] != col_o[:-1])
        seg = np.cumsum(head) - 1
        nse_out = int(seg[-1]) + 1 if F else 0
        out_indices = col_o[head] if F else np.zeros(0, np.int64)
        out_rows = row_o[head] if F else np.zeros(0, np.int64)
        a_pos_o = prod_a[order] if F else np.zeros(0, np.int64)
        b_pos_o = src_pos[prod_b[order]] if F else np.zeros(0, np.int64)
        if F == 0:
            seg = np.zeros(0, np.int64)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(out_rows, minlength=n), out=indptr[1:])
    return SpgemmPlan(
        a_pos=jnp.asarray(a_pos_o, INDEX_DTYPE),
        b_pos=jnp.asarray(b_pos_o, INDEX_DTYPE),
        seg=jnp.asarray(seg, INDEX_DTYPE),
        indices=jnp.asarray(out_indices, INDEX_DTYPE),
        indptr=jnp.asarray(indptr, INDEX_DTYPE),
        shape=(n, k),
    )


@jax.jit
def spgemm_apply(plan: SpgemmPlan, a: CSR, b) -> CSR:
    """Numeric SpGEMM pass: C = A @ B for the pattern pair captured in
    ``plan`` (values may have changed; structure must not).  jit-compatible,
    sort-free, deterministic; B must be the same format (CSR or CSC) it was
    prepared as — only its ``data`` array is read."""
    b_data = b.data
    out_dtype = jnp.result_type(a.dtype, b_data.dtype)
    if plan.n_products == 0:
        data = jnp.zeros((plan.nse_out,), out_dtype)
    else:
        prods = a.data[plan.a_pos] * b_data[plan.b_pos]
        data = segment_sum(
            prods.astype(out_dtype), plan.seg, plan.nse_out,
            indices_are_sorted=True,
        )
    return CSR(data=data, indices=plan.indices, indptr=plan.indptr,
               shape=plan.shape)


def spgemm(
    a: CSR,
    b,
    *,
    expansion_nse: int | None = None,
    compact: bool = True,
    method: str = "auto",
    block_bsz: int | None = None,
) -> CSR:
    """C = A @ B for sparse A (CSR) and sparse B (CSC or CSR).

    Matches the reference's ``smsmm`` contract (CSR x CSC -> CSR,
    compressed.fut:268-331).  With ``expansion_nse=None`` the symbolic pass
    runs eagerly (host sync) to size the numeric pass exactly; pass a static
    bound to stay fully jit-compatible (the ESC core, with result capacity
    ``expansion_nse``).  ``compact`` (eager only) trims the result capacity
    to the exact stored-entry count.

    ``method``: ``"auto"`` (default) picks per :func:`_spgemm_route` — the
    sort-free dense-accumulator core for float matrices whose dense
    footprint fits the budget (``_MXU_DENSE_ELEMS``); the **block route**
    (``csr_to_bsr`` -> ``bsr_smsmm`` -> ``bsr_to_csr``) when both stored
    patterns have fully dense natural bsz x bsz blocks at a detected bsz in
    32/16/8/4/2; else the ESC
    expand-sort-compress core.  ``"mxu"`` / ``"esc"`` / ``"block"`` force a
    core (``"block"`` detects bsz, or pass ``block_bsz``; it requires
    square operands and, for exact reference structure, full block fill —
    at partial fill its result stores every position of each touched
    block).  All routes produce the reference's stored structure under
    their stated preconditions; values agree up to float summation order.
    """
    b_rows = _csc_to_csr(b) if isinstance(b, CSC) else b
    if not isinstance(b_rows, CSR):
        raise TypeError(f"spgemm: expected CSR/CSC operand, got {type(b)}")
    if method not in ("auto", "mxu", "esc", "block"):
        raise ValueError(f"spgemm: unknown method {method!r}")
    if expansion_nse is not None:
        return spgemm_csr_csr(a, b_rows, expansion_nse)
    if method == "auto":
        method, bsz = _spgemm_route(a, b_rows)
    elif method == "block":
        n, m = a.shape
        _, k = b_rows.shape
        if not (n == m == k):
            raise ValueError(
                f"spgemm(method='block'): operands must be square, got "
                f"{a.shape} @ {b_rows.shape}"
            )
        if block_bsz is not None:
            bsz = block_bsz
        else:
            from ..utils.stats import detect_block_size

            bsz, _ = detect_block_size(a, _BLOCK_ROUTE_CANDIDATES)
            if bsz < 2:
                raise ValueError(
                    "spgemm(method='block'): no dense natural block size "
                    "detected; pass block_bsz= explicitly"
                )
    if method == "block":
        return _spgemm_block(a, b_rows, bsz, compact)
    if method == "mxu":
        nse = int(spgemm_mxu_nse(a, b_rows))  # host sync (symbolic pass)
        return spgemm_mxu_csr_csr(a, b_rows, nse)
    f = int(spgemm_flops(a, b_rows))  # host sync (symbolic pass)
    out = spgemm_csr_csr(a, b_rows, f)
    if compact:
        from ..formats.csr import csr_compact

        out = csr_compact(out)
    return out

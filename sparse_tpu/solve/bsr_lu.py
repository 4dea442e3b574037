"""Block-sparse LU factorization and direct solver for BSR matrices.

A re-design of the reference's solver stack
(blocked_square_regular.fut:366-603): right-looking block LU with
block-limited partial pivoting, symbolic fill-in analysis, factor extraction,
block triangular solves, and the direct solver ``ols``.

Design: the *sparsity pattern is static data* — symbolic analysis (fill-in
discovery, per-step block plans) runs host-side in NumPy once per pattern,
exactly like real sparse direct solvers separate symbolic and numeric phases.
The numeric phase then executes on device with static gather/scatter index
plans: per block column, one dense ``lup_dense`` of the diagonal block, one
batched triangular solve for the column/row panels (vmap), and one
batched Schur-complement einsum.  The sequential critical path over block
columns (inherent to right-looking LU, see SURVEY.md §3.3) stays as a host
loop over ``nb`` steps; all heavy math per step is batched device work.

Contract preserved (blocked_square_regular.fut:87-140): ``lup a`` returns
``(LU, p)`` with ``permute(p, dense(a)) == dense(lower LU @ upper LU)``;
``lower`` is strict-lower + unit diagonal; ``upper`` includes the diagonal;
``forsolve`` reads only the strict lower part (implicit unit diagonal);
``backsolve`` reads the upper part and divides by the diagonal; ``ols`` is
``backsolve . forsolve . permute . lup``.  Pivoting is limited to within a
block, like the reference.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..formats.bsr import BSR, bsr_add, bsr_eye, bsr_make, bsr_zero
from ..linalg.dense import (
    backsolve_dense,
    forsolve_dense,
    lu_dense,
    lup_dense,
    perm_id,
    rowsolve_upper,
)
from ..ops.segmented import INDEX_DTYPE
from ..utils.precision import matmul_precision

__all__ = [
    "bsr_lu_find_fills",
    "bsr_lup_nofill",
    "bsr_lup",
    "bsr_lu_nofill",
    "bsr_lu",
    "bsr_lower",
    "bsr_upper",
    "bsr_forsolve",
    "bsr_backsolve",
    "bsr_tri_plan",
    "TriSolvePlan",
    "bsr_factorize",
    "BSRFactorization",
    "bsr_ols",
    "LuNumericPlan",
    "bsr_lu_numeric_prepare",
    "bsr_lu_numeric_apply",
]


def _host_pattern(a: BSR) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(positions, rows, cols) of valid blocks, host-side."""
    idxs = np.asarray(a.indices)
    nb = a.nb
    valid = idxs < nb * nb
    pos = np.nonzero(valid)[0]
    return pos, idxs[pos] // nb, idxs[pos] % nb


def bsr_lu_find_fills(a: BSR) -> np.ndarray:
    """Symbolic fill-in positions for LU, as an array of (block_row,
    block_col) pairs in discovery order (reference ``lu_find_fills``,
    blocked_square_regular.fut:366-380).

    Host-side sequential sweep over block columns — this is the symbolic
    phase of a sparse direct solver and runs once per sparsity pattern.
    """
    nb = a.nb
    _, rs, cs = _host_pattern(a)
    pattern = set(zip(rs.tolist(), cs.tolist()))
    acc: list[tuple[int, int]] = []
    live = set(pattern)
    for i in range(nb):
        row_i = sorted(c for (r, c) in live if r == i and c > i)
        col_i = sorted(r for (r, c) in live if c == i and r > i)
        fills = [
            (r, c) for r in col_i for c in row_i if (r, c) not in live
        ]
        live = {(r, c) for (r, c) in live if r > i and c > i}
        live.update(fills)
        acc.extend(fills)
    return np.asarray(acc, np.int64).reshape(-1, 2)


def _diag_pos(pos, rs, cs, i: int) -> int:
    hits = pos[(rs == i) & (cs == i)]
    # mirrors ERROR_diagonal_block_must_be_nonempty (blocked:176, 429)
    if hits.size != 1:
        raise ValueError(
            f"LU: diagonal block ({i},{i}) must be present exactly once "
            f"(found {hits.size}); add fill blocks or use bsr_lup"
        )
    return int(hits[0])


def _lu_plan(a: BSR):
    """Padded per-step index plans for the jitted numeric phase.

    All per-step block lists (column panel, row panel, Schur pairs,
    left-of-diagonal) are padded to their max width with a *scratch slot*
    at index ``nbz`` holding a zero block: gathers from it read zeros,
    updates to it are discarded by construction, so padded lanes are
    algebraically inert inside the compiled step."""
    nb = a.nb
    pos, rs, cs = _host_pattern(a)
    scratch = a.nbz
    flat = {(int(r), int(c)): int(h) for h, r, c in zip(pos, rs, cs)}
    diag = np.empty(nb, np.int32)
    l21, l12, lpairs, lleft = [], [], [], []
    for i in range(nb):
        diag[i] = _diag_pos(pos, rs, cs, i)
        h21 = pos[(rs > i) & (cs == i)]
        h12 = pos[(rs == i) & (cs > i)]
        r21 = rs[np.searchsorted(pos, h21)]
        c12 = cs[np.searchsorted(pos, h12)]
        pairs = [
            (int(h1), int(h2), flat[(int(r), int(c))])
            for h1, r in zip(h21, r21)
            for h2, c in zip(h12, c12)
            if (int(r), int(c)) in flat
        ]
        l21.append(h21)
        l12.append(h12)
        lpairs.append(pairs)
        lleft.append(pos[(rs == i) & (cs < i)])

    def pad2(lists, fill):
        w = max((len(x) for x in lists), default=0)
        out = np.full((nb, max(w, 1)), fill, np.int32)
        for i, x in enumerate(lists):
            out[i, : len(x)] = x
        return out

    p21 = pad2(l21, scratch)
    p12 = pad2(l12, scratch)
    pleft = pad2(lleft, scratch)
    ws = max((len(x) for x in lpairs), default=0)
    s1 = np.full((nb, max(ws, 1)), scratch, np.int32)
    s2 = s1.copy()
    st = s1.copy()
    for i, pairs in enumerate(lpairs):
        for j, (h1, h2, ht) in enumerate(pairs):
            s1[i, j], s2[i, j], st[i, j] = h1, h2, ht
    return (
        jnp.asarray(diag),
        jnp.asarray(p21),
        jnp.asarray(p12),
        jnp.asarray(s1),
        jnp.asarray(s2),
        jnp.asarray(st),
        jnp.asarray(pleft),
    )


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["diag", "p21", "p12", "s1", "s2", "st", "pleft"],
    meta_fields=["nb", "bsz"],
)
@dataclass(frozen=True)
class LuNumericPlan:
    """Static per-step index plan of the LU numeric phase (one row per
    block column; padded lanes point at the zero scratch slot).  Built once
    per sparsity pattern by :func:`bsr_lu_numeric_prepare`; the numeric
    phase (:func:`bsr_lu_numeric_apply`) is then fully jittable with the
    plan as an argument — re-factorize changed VALUES without re-running
    the host symbolic pass (the same prepare/apply idiom as the SpGEMM and
    triangular-solve plans)."""

    diag: jax.Array
    p21: jax.Array
    p12: jax.Array
    s1: jax.Array
    s2: jax.Array
    st: jax.Array
    pleft: jax.Array
    nb: int
    bsz: int


def bsr_lu_numeric_prepare(a: BSR) -> LuNumericPlan:
    """Host-side symbolic pass over the (fill-complete) pattern of ``a``
    (eager, once per pattern).  Pair with :func:`bsr_lu_numeric_apply`."""
    return LuNumericPlan(*_lu_plan(a), nb=a.nb, bsz=a.bsz)


def bsr_lu_numeric_apply(plan: LuNumericPlan, a: BSR,
                         pivot: bool = True) -> tuple[BSR, jax.Array]:
    """Numeric right-looking block LU over ``plan``'s pattern (values may
    change, pattern must not).  jit-compatible given the plan."""
    return _lu_steps(a, plan, pivot)


def _lu_numeric(a: BSR, pivot: bool) -> tuple[BSR, jax.Array]:
    """Right-looking block LU over a fixed pattern (no fill); numeric phase.

    Reference ``lup_nofill`` (blocked_square_regular.fut:414-464) and
    ``lu_nofill`` (:502-546).  The sparsity pattern is static, so the whole
    factorization compiles to ONE ``lax.fori_loop`` over block columns: per
    step, a dense ``lup_dense`` of the diagonal block, vmapped triangular
    solves of the padded column/row panels (batched), and one batched
    Schur einsum on the padded pair plan — fully on-device, no host sync.
    """
    return _lu_steps(a, bsr_lu_numeric_prepare(a), pivot)


def _lu_steps(a: BSR, plan: LuNumericPlan, pivot: bool) -> tuple[BSR, jax.Array]:
    nb, bsz = plan.nb, plan.bsz
    diag, p21, p12, s1, s2, st, pleft = (
        plan.diag, plan.p21, plan.p12, plan.s1, plan.s2, plan.st, plan.pleft
    )
    # scratch slot at index nbz: zero block, absorbs padded-lane updates
    blocks0 = jnp.concatenate(
        [a.blocks, jnp.zeros((1, bsz, bsz), a.blocks.dtype)]
    )

    def step(i, carry):
        blocks, perms = carry
        hd = diag[i]
        if pivot:
            lu_d, p = lup_dense(blocks[hd])
        else:
            lu_d = lu_dense(blocks[hd])
            p = perm_id(bsz)
        blocks = blocks.at[hd].set(lu_d)
        # X21 solves X @ U = A per block (reference backsolve' per row,
        # blocked:433-435); padded lanes solve the zero block -> zero
        h21 = p21[i]
        x21 = jax.vmap(lambda B: rowsolve_upper(lu_d, B))(blocks[h21])
        blocks = blocks.at[h21].set(x21)
        # X12 = L^-1 P A12 (blocked:436-439)
        h12 = p12[i]
        x12 = jax.vmap(lambda B: forsolve_dense(lu_d, B[p]))(blocks[h12])
        blocks = blocks.at[h12].set(x12)
        # Schur update D -= X21 @ X12 on existing targets only
        # ("ignore fillins", blocked:443-456)
        prods = jnp.einsum(
            "fij,fjk->fik", blocks[s1[i]], blocks[s2[i]],
            preferred_element_type=blocks.dtype,
            precision=matmul_precision(blocks.dtype),
        )
        blocks = blocks.at[st[i]].add(-prods)
        if pivot:
            # permute already-final L blocks left of the diagonal
            # (blocked:457-459)
            hl = pleft[i]
            blocks = blocks.at[hl].set(blocks[hl][:, p, :])
            perms = perms.at[i].set(i * bsz + p)
        return blocks, perms

    perms0 = jnp.broadcast_to(
        jnp.arange(bsz, dtype=INDEX_DTYPE)[None, :], (nb, bsz)
    ) + (jnp.arange(nb, dtype=INDEX_DTYPE) * bsz)[:, None]
    blocks, perms = jax.lax.fori_loop(0, nb, step, (blocks0, perms0))
    lu_mat = BSR(indices=a.indices, blocks=blocks[:-1], n=a.n, bsz=a.bsz)
    return lu_mat, perms.reshape(-1)


def bsr_lup_nofill(a: BSR) -> tuple[BSR, jax.Array]:
    """LU with block-limited partial pivoting over the existing pattern
    (reference ``lup_nofill``, blocked_square_regular.fut:414-464)."""
    return _lu_numeric(a, pivot=True)


def bsr_lu_nofill(a: BSR) -> BSR:
    """LU without pivoting over the existing pattern (reference
    ``lu_nofill``, blocked_square_regular.fut:502-546)."""
    return _lu_numeric(a, pivot=False)[0]


def _with_fills(a: BSR) -> BSR:
    fills = bsr_lu_find_fills(a)
    if fills.size == 0:
        return a
    zero_blk = np.zeros((a.bsz, a.bsz), np.asarray(a.blocks).dtype)
    x = bsr_make(a.n, a.bsz, [(int(r), int(c), zero_blk) for r, c in fills])
    return bsr_add(a, x)


def bsr_lup(a: BSR) -> tuple[BSR, jax.Array]:
    """Symbolic fill-in + pivoted numeric factorization (reference ``lup``,
    blocked_square_regular.fut:466-469)."""
    return bsr_lup_nofill(_with_fills(a))


def bsr_lu(a: BSR) -> BSR:
    """Fill-in + non-pivoting factorization (reference ``lu``,
    blocked_square_regular.fut:548-551)."""
    return bsr_lu_nofill(_with_fills(a))


# -- factor extraction ---------------------------------------------------------


def bsr_lower(a: BSR) -> BSR:
    """Strictly-lower part + unit diagonal (reference ``lower``,
    blocked_square_regular.fut:477-488)."""
    valid = a.indices < a.sentinel
    nb = a.nb
    r = a.indices // max(nb, 1)
    c = a.indices % max(nb, 1)
    keep = valid & (r >= c)
    idxs = jnp.where(keep, a.indices, a.sentinel).astype(INDEX_DTYPE)
    on_diag = keep & (r == c)
    strict = jnp.tril(jnp.ones((a.bsz, a.bsz), bool), -1)
    blocks = jnp.where(
        on_diag[:, None, None],
        jnp.where(strict[None], a.blocks, 0),
        jnp.where(keep[:, None, None], a.blocks, 0),
    )
    return bsr_add(bsr_eye(a.n, a.bsz, a.dtype), BSR(idxs, blocks, a.n, a.bsz))


def bsr_upper(a: BSR) -> BSR:
    """Upper part incl. diagonal (reference ``upper``,
    blocked_square_regular.fut:490-500)."""
    valid = a.indices < a.sentinel
    nb = a.nb
    r = a.indices // max(nb, 1)
    c = a.indices % max(nb, 1)
    keep = valid & (r <= c)
    idxs = jnp.where(keep, a.indices, a.sentinel).astype(INDEX_DTYPE)
    on_diag = keep & (r == c)
    upper = jnp.triu(jnp.ones((a.bsz, a.bsz), bool))
    blocks = jnp.where(
        on_diag[:, None, None],
        jnp.where(upper[None], a.blocks, 0),
        jnp.where(keep[:, None, None], a.blocks, 0),
    )
    from ..formats.bsr import _merge_blocks

    return _merge_blocks(a.n, a.bsz, idxs, blocks)


# -- block triangular solves ---------------------------------------------------


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["off_pos", "off_col", "diag_pos"],
    meta_fields=["lower"],
)
@dataclass(frozen=True)
class TriSolvePlan:
    """Static per-block-row index plan for a jittable triangular sweep.

    Built once per sparsity pattern (host-side, like ``_lu_plan``); the
    numeric sweep is then a single ``lax.fori_loop`` with no host syncs.
    Padded lanes point at a zero scratch block (position ``nbz``) and a zero
    scratch RHS row (block-row ``nb``), so they are algebraically inert.
    """

    off_pos: jax.Array  # (nb, W) block positions, pad = nbz (zero block)
    off_col: jax.Array  # (nb, W) their block-columns, pad = nb (zero row)
    diag_pos: jax.Array  # (nb,) diagonal position; forsolve pad = nbz
    lower: bool


def bsr_tri_plan(t: BSR, lower: bool) -> TriSolvePlan:
    """Build the :class:`TriSolvePlan` for ``t`` (eager; pattern must be
    concrete).  For ``lower=True`` an absent diagonal block means implicit
    identity (reference forsolve reads strict lower + unit diagonal,
    blocked_square_regular.fut:556-573); for ``lower=False`` a missing
    diagonal raises, mirroring ERROR_backsolve_diagonal_element_is_zero
    (blocked:597)."""
    nb = t.nb
    pos, rs, cs = _host_pattern(t)
    scratch = t.nbz
    offs, cols = [], []
    diag = np.full(nb, scratch, np.int32)
    for k in range(nb):
        sel = (rs == k) & ((cs < k) if lower else (cs > k))
        o = pos[sel]
        offs.append(o)
        cols.append(cs[np.searchsorted(pos, o)])
        hd = pos[(rs == k) & (cs == k)]
        if hd.size:
            diag[k] = hd[0]
        elif not lower:
            raise ValueError(f"backsolve: diagonal block ({k},{k}) missing")
    w = max((len(o) for o in offs), default=0)
    off_pos = np.full((nb, max(w, 1)), scratch, np.int32)
    off_col = np.full((nb, max(w, 1)), nb, np.int32)
    for k, (o, c) in enumerate(zip(offs, cols)):
        off_pos[k, : len(o)] = o
        off_col[k, : len(o)] = c
    return TriSolvePlan(
        off_pos=jnp.asarray(off_pos),
        off_col=jnp.asarray(off_col),
        diag_pos=jnp.asarray(diag),
        lower=lower,
    )


def _tri_sweep(t: BSR, b: jax.Array, plan: TriSolvePlan) -> jax.Array:
    """One ``lax.fori_loop`` over block rows: gather the already-solved
    neighbour rows (padded plan), one batched einsum, one dense triangular
    solve of the diagonal block.  Fully jittable; zero per-step host syncs."""
    b = jnp.asarray(b)
    nb, bsz = t.nb, t.bsz
    vec = b.ndim == 1
    kk = 1 if vec else b.shape[1]
    if nb == 0:
        return b
    # scratch block (zero) at position nbz; zero blocks act as identity under
    # the unit-diagonal forsolve convention
    ext = jnp.concatenate([t.blocks, jnp.zeros((1, bsz, bsz), t.blocks.dtype)])
    y0 = jnp.concatenate(
        [b.reshape(nb, bsz, kk).astype(ext.dtype),
         jnp.zeros((1, bsz, kk), ext.dtype)]
    )
    solve = forsolve_dense if plan.lower else backsolve_dense

    def step(s, y):
        k = s if plan.lower else nb - 1 - s
        contrib = jnp.einsum(
            "bij,bjk->ik", ext[plan.off_pos[k]], y[plan.off_col[k]],
            preferred_element_type=y.dtype,
            precision=matmul_precision(y.dtype),
        )
        rhs = solve(ext[plan.diag_pos[k]], y[k] - contrib)
        return y.at[k].set(rhs)

    y = jax.lax.fori_loop(0, nb, step, y0)[:nb]
    return y.reshape(t.n) if vec else y.reshape(t.n, kk)


def bsr_forsolve(L: BSR, b: jax.Array,
                 plan: TriSolvePlan | None = None) -> jax.Array:
    """Solve ``L x = b`` reading only the strict lower part of ``L`` with
    implicit unit diagonal (reference ``forsolve``,
    blocked_square_regular.fut:556-573).  Sequential over block rows (the
    inherent critical path) as one on-device ``lax.fori_loop``; ``b`` may be
    a vector (n,) or a matrix of right-hand sides (n, k).

    Pass ``plan=bsr_tri_plan(L, lower=True)`` to call under ``jit`` (plan
    construction needs the concrete pattern)."""
    if plan is None:
        plan = bsr_tri_plan(L, lower=True)
    return _tri_sweep(L, b, plan)


def bsr_backsolve(U: BSR, yv: jax.Array,
                  plan: TriSolvePlan | None = None) -> jax.Array:
    """Solve ``U x = y`` reading the upper part incl. diagonal (reference
    ``backsolve``, blocked_square_regular.fut:577-599).  A zero diagonal
    element yields inf/nan (the reference aborts via
    ERROR_backsolve_diagonal_element_is_zero, blocked:597); a missing
    diagonal block raises at plan-build time."""
    if plan is None:
        plan = bsr_tri_plan(U, lower=False)
    return _tri_sweep(U, yv, plan)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["lu", "p", "fplan", "bplan"],
    meta_fields=[],
)
@dataclass(frozen=True)
class BSRFactorization:
    """Reusable pivoted block-sparse LU factorization: factor once with
    :func:`bsr_factorize`, then :meth:`solve` many right-hand sides without
    re-factorizing (``ols`` splits into its two phases; reference
    blocked_square_regular.fut:601-603 recomputes the factorization per
    solve because Futhark has no mutable cache — we keep the carrier)."""

    lu: BSR
    p: jax.Array
    fplan: TriSolvePlan
    bplan: TriSolvePlan

    def solve(self, b: jax.Array) -> jax.Array:
        """Solve ``A x = b`` using the cached factors; jittable."""
        y = bsr_forsolve(self.lu, jnp.asarray(b)[self.p], self.fplan)
        return bsr_backsolve(self.lu, y, self.bplan)


def bsr_factorize(a: BSR) -> BSRFactorization:
    """Symbolic fill-in + pivoted numeric LU + triangular-solve plans, as a
    reusable carrier.  ``bsr_factorize(a).solve(b) == bsr_ols(a, b)``."""
    LU, p = bsr_lup(a)
    return BSRFactorization(
        lu=LU,
        p=p,
        fplan=bsr_tri_plan(LU, lower=True),
        bplan=bsr_tri_plan(LU, lower=False),
    )


def bsr_ols(a: BSR, b: jax.Array) -> jax.Array:
    """Direct solve of ``A x = b`` via pivoted block-sparse LU (reference
    ``ols``, blocked_square_regular.fut:601-603).  ``b`` may be (n,) or a
    multi-RHS matrix (n, k); use :func:`bsr_factorize` to factor once and
    solve many."""
    return bsr_factorize(a).solve(b)

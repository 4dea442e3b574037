"""One-call production SpMV: prepare once per pattern, apply per value set.

:func:`smvm_prepare` runs the (eager, host-side) structure analysis once
and returns a plan carrier whose :meth:`~SmvmAutoPlan.apply` is
jit-compatible.  The ladder has two rungs:

| structure | path |
|---|---|
| square, fully dense natural blocks at bsz >= 8 | BELL block storage (``formats/bell.py``) |
| anything else | row-binned XLA SpMV (``ops/spmv.py``) |

No reference counterpart (the reference has exactly one smvm,
compressed.fut:134-146 — semantics preserved by every path here).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from ..formats.csr import CSR

__all__ = ["SmvmAutoPlan", "smvm_prepare"]

_KINDS = ("bell", "xla")


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["state"],
    meta_fields=["kind", "shape"],
)
@dataclasses.dataclass(frozen=True)
class SmvmAutoPlan:
    """Prepared SpMV dispatch (from :func:`smvm_prepare`).

    ``kind``: ``"bell"`` or ``"xla"``; ``state`` is the path's own plan
    pytree.  ``apply`` matches ``csr_smvm`` up to float summation order."""

    state: tuple
    kind: str
    shape: tuple[int, int]

    def refresh(self, data: jax.Array) -> "SmvmAutoPlan":
        """Re-bind the plan to NEW values of the SAME pattern (``data`` =
        the updated CSR ``.data``) — the Newton / time-stepping idiom;
        jit-compatible given the plan.  Supported on the ``xla`` rung (its
        row-binned plan is value-free); the ``bell`` rung re-blocks values
        through host layouts, so re-run :func:`smvm_prepare` for it."""
        if self.kind != "xla":
            raise NotImplementedError(
                f"SmvmAutoPlan.refresh: the {self.kind!r} rung re-blocks "
                "values through host layouts — re-run smvm_prepare"
            )
        a, plan = self.state
        data = jnp.asarray(data)
        if data.shape != a.data.shape:
            raise ValueError(
                f"SmvmAutoPlan.refresh: data shape {data.shape} != the "
                f"pattern's {a.data.shape}")
        a2 = CSR(data=data, indices=a.indices, indptr=a.indptr, shape=a.shape)
        return dataclasses.replace(self, state=(a2, plan))

    def apply(self, v: jax.Array) -> jax.Array:
        """y = A v (jit-compatible)."""
        v = jnp.asarray(v)
        if self.kind == "bell":
            from ..formats.bell import bell_smvm

            (b,) = self.state
            return bell_smvm(b, v)
        from .spmv import csr_smvm_fast

        a, plan = self.state
        return csr_smvm_fast(a, v, plan)


def smvm_prepare(a: CSR, *, verbose: bool = False,
                 prefer: str | None = None) -> SmvmAutoPlan:
    """Eager, host-side structure analysis + plan build (once per
    pattern; value updates on the ``xla`` rung go through
    :meth:`SmvmAutoPlan.refresh`).

    Ladder: a square matrix whose stored pattern is fully dense natural
    blocks at bsz 32, 16 or 8 -> BELL block storage; otherwise the
    row-binned XLA path.  ``prefer`` pins a rung by name (``"bell"`` or
    ``"xla"``), overriding the structure heuristic but not the
    capability requirement (the bell rung needs a square matrix and a
    dense block size)."""
    from ..utils.stats import detect_block_size

    if prefer is not None and prefer not in _KINDS:
        raise ValueError(f"smvm_prepare: unknown rung {prefer!r} "
                         f"(expected one of {_KINDS})")
    n, m = a.shape
    log = (lambda s: print(f"smvm_prepare: {s}")) if verbose else (lambda s: None)

    if prefer in (None, "bell") and n == m:
        bsz, _ = detect_block_size(a, candidates=(32, 16, 8))
        if bsz >= 8:
            from ..formats.bell import bell_from_csr

            log(f"BELL block storage (bsz {bsz})")
            return SmvmAutoPlan(state=(bell_from_csr(a, bsz),), kind="bell",
                                shape=(n, m))

    from .spmv import build_spmv_plan

    log("row-binned XLA path")
    return SmvmAutoPlan(state=(a, build_spmv_plan(a)), kind="xla",
                        shape=(n, m))

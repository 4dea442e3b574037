"""The one place that decides which hand-written kernels a platform runs.

Every call site that could take a kernel asks :func:`has_kernel` instead
of testing ``jax.default_backend()`` itself.  A platform missing from
:data:`KERNELS` runs the plain XLA formulation of every operation.
Interpret mode is never chosen here: only tests ask for it, explicitly.
"""

from __future__ import annotations

import jax

__all__ = ["KERNELS", "has_kernel"]

#: Hand-written kernels by JAX platform name.  ``bell_spmm``: the Triton
#: blocked-ELL SpMM (ops/pallas_bell.py).
KERNELS: dict[str, frozenset[str]] = {
    "gpu": frozenset({"bell_spmm"}),
}


def has_kernel(name: str, platform_name: str | None = None) -> bool:
    """Whether ``platform_name`` (default: the platform of JAX's default
    device, ``"gpu"``, ``"cpu"``, ...) runs the hand-written kernel
    ``name``."""
    return name in KERNELS.get(platform_name or jax.default_backend(),
                               frozenset())

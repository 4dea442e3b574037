"""Precision policy: correct-by-default f32 contractions.

On an NVIDIA GPU a float32 ``dot_general`` at default precision may run in
TF32, which keeps 10 mantissa bits — about three decimal digits short of
f32.  A sparse *linear-algebra* library cannot silently ship that: the
reference's own test tolerances (P·A ≈ L·U at eps=6e-5,
blocked_square_regular_test.fut:250) are unreachable at TF32 on real
sizes.

Every matmul/einsum in the library therefore passes
``precision=matmul_precision(dtype)``: full f32 (``HIGHEST``) for f32
contractions, and the default for everything else (bf16 inputs multiply
exactly with f32 accumulation; f64 has no reduced mode).  The Triton
blocked-ELL kernel applies the same rule (ops/pallas_bell.py).  The
explicit mixed-precision path (``compute_dtype=jnp.bfloat16`` on
``bell_spmm``) is the supported way to trade digits for bandwidth.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["matmul_precision"]


def matmul_precision(*dtypes):
    """``jax.lax.Precision.HIGHEST`` when any operand dtype is float32,
    else None (hardware default)."""
    if any(jnp.dtype(d) == jnp.float32 for d in dtypes):
        return jax.lax.Precision.HIGHEST
    return None

"""Profiling helpers: jax.profiler tracing, chained op timing, and the
device facts every measurement prints beside its numbers.

SURVEY.md §5.1: the reference has no profiling hooks; ours are jax.profiler
traces plus roofline accounting (utils/stats.py).  ``timed_op`` chains
applications inside one jit so that loop-invariant work cannot be hoisted
and per-call dispatch does not enter the time.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import time
from pathlib import Path

import numpy as np

__all__ = ["trace", "timed_op", "card_info", "device_record",
           "require_gpu", "use_compile_cache"]


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a jax.profiler trace viewable in TensorBoard/Perfetto."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def timed_op(step, v0, *operands, iters: int = 10, reps: int = 3) -> float:
    """Seconds per application of ``step(v, *operands)`` (jit-able, with the
    output feedable back as ``v``), measured as ``iters`` dependency-chained
    applications inside one jit, best of ``reps``; the scalar fetch forces
    full execution.  Pass large arrays through ``operands`` (jit
    arguments) rather than closing over them, so they are not embedded in
    the compiled program as constants."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def run(v, *ops):
        def body(_, v):
            w = step(v, *ops)
            return w / (jnp.max(jnp.abs(w)) + 1.0)

        return jnp.sum(jax.lax.fori_loop(0, iters, body, v))

    float(run(v0, *operands))  # compile + first run
    best = np.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        float(run(v0, *operands))
        best = min(best, time.perf_counter() - t0)
    return best / iters


def card_info() -> str:
    """``name, power.limit`` of each card as nvidia-smi reports them (run
    in a child process that does not import JAX), or the reason it could
    not be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return out


def device_record() -> dict:
    """``{"platform", "kind", "count"}`` of the default JAX devices."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def require_gpu() -> dict:
    """:func:`device_record`, or ``SystemExit`` when JAX's default device
    is not a GPU: a measurement never falls back to another device."""
    rec = device_record()
    if rec["platform"] != "gpu":
        raise SystemExit(
            f"no GPU: JAX's default device is {rec['platform']!r} "
            f"({rec['kind']}); this measurement runs on a GPU only")
    return rec


def use_compile_cache(root: str | os.PathLike) -> str:
    """Point JAX's persistent compilation cache at ``$JAX_COMPILATION_CACHE_DIR``
    when it is set (JAX reads it itself), else at ``<root>/.jax_cache``.
    Returns the directory in use."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = str(Path(root).resolve() / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path

"""Published peak rates of the cards the benchmarks divide by, keyed by
``jax.devices()[0].device_kind``.

Source: NVIDIA H100 Tensor Core GPU data sheet, SXM5 part, at the full
700 W power limit: 80 GB HBM3 at 3.35 TB/s, 67 TFLOP/s float32 outside
the tensor cores.  A card set below 700 W cannot
hold its top clock under load; report its ``power.limit`` beside any share
of these peaks.

A device kind that is not in the table is an error, not a default.
"""

from __future__ import annotations

import dataclasses

__all__ = ["Peak", "PEAKS", "peak_for"]


@dataclasses.dataclass(frozen=True)
class Peak:
    hbm_gbps: float     # device-memory bandwidth, GB/s
    f32_tflops: float   # float32, CUDA cores
    source: str


_H100_SXM = Peak(hbm_gbps=3350.0, f32_tflops=67.0,
                 source="NVIDIA H100 Tensor Core GPU data sheet (SXM5)")

PEAKS: dict[str, Peak] = {
    "NVIDIA H100 80GB HBM3": _H100_SXM,
}


def peak_for(device_kind: str) -> Peak:
    """The published peaks of ``device_kind``; ``KeyError`` for a kind the
    table does not hold."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device kind {device_kind!r}; add the "
            f"card to benchmarks/peaks.py with its data-sheet source"
        ) from None

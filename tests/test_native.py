"""Native plan-construction core (sparse_tpu/native): edge cases and
fallback parity.  The heavier whole-plan equality checks live next to
their consumers (test_reorder.py, test_spgemm_spmm.py)."""

import numpy as np
import pytest

from sparse_tpu.native.plansort import argsort_u64, _load


def test_argsort_u64_matches_numpy_stable():
    rng = np.random.default_rng(0)
    for n, hi in [(0, 10), (1, 1), (1000, 5), (100_000, 1 << 40)]:
        k = rng.integers(0, hi, n).astype(np.uint64)
        got = argsort_u64(k)
        want = np.argsort(k, kind="stable")
        np.testing.assert_array_equal(got, want)  # stability included


def test_argsort_u64_rejects_negative():
    with pytest.raises(ValueError):
        argsort_u64(np.array([3, -1, 2], np.int64))


def test_argsort_u64_dtype_paths():
    # int32/int64 inputs cast; u64 passes through
    k32 = np.array([5, 1, 5, 0], np.int32)
    np.testing.assert_array_equal(argsort_u64(k32), [3, 1, 0, 2])
    k64 = np.array([2**40, 3, 2**40 - 1], np.int64)
    np.testing.assert_array_equal(argsort_u64(k64), [1, 2, 0])


def test_native_library_builds_here():
    # this environment ships g++; the fast path should be live (the NumPy
    # fallback is exercised separately via mock in the consumer tests)
    assert _load() is not None

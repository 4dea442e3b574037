"""chip_smoke.py's phases at tiny sizes on the CPU (the card runs them at
full size), its comparison helpers, and its refusal to run without a GPU."""

import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def _tiny():
    return (cs.fixture("poisson_fem", n_points=1200, seed=0),
            cs.fixture("elasticity_fem", n_points=600, seed=1),
            cs.fixture("powerlaw_graph", n=1200, m=4, seed=2))


def _all_ok(checks):
    assert checks and all(c["ok"] for c in checks), checks
    return checks


def test_main_refuses_without_gpu(capsys):
    assert cs.main([]) == 1
    assert capsys.readouterr().out == ""  # no result line, no phase line


def test_check_and_scaled_err():
    assert cs.check("x", 1e-13, 1e-12)["ok"]
    assert not cs.check("x", 1e-11, 1e-12)["ok"]
    assert not cs.check("x", float("nan"), 1.0)["ok"]
    y = np.array([1.0, 2.0])
    assert cs.scaled_err(y, y + [3.0, 4.0], [6.0, 8.0]) == pytest.approx(0.5)
    assert cs.tol_of(np.float32) == cs.F32_TOL
    assert cs.tol_of(np.float64) == cs.F64_TOL


def test_phase_fixture():
    _all_ok(cs.phase_fixture())


def test_phase_spmv_tiny():
    p, e, g = _tiny()
    band = cs.block_band(8)[-1].tocsr()  # 32x32 blocks -> the BELL rung
    checks = _all_ok(cs.phase_spmv({"p": (p, "xla"), "e": (e, "xla"),
                                    "g": (g, "xla"), "band": (band, "bell")}))
    rungs = {c["check"]: c["rung"] for c in checks}
    assert rungs["band_float32"] == rungs["band_float64"] == "bell"
    assert rungs["p_float64"] == "xla"
    assert len(checks) == 16  # 4 matrices x (f32, f64) x (values, rung)
    # the rung check fails when another rung is expected
    assert not all(c["ok"] for c in cs.phase_spmv({"band": (band, "xla")}))


def test_phase_spmm_tiny():
    # off the GPU bell_spmm takes XLA; the route check fails if asked for
    # the kernel
    checks = _all_ok(cs.phase_spmm(8, 16, expect_route="xla"))
    assert {"bell_spmm_grad_operand_f32",
            "bell_spmm_grad_blocks_f32"} <= {c["check"] for c in checks}
    assert not all(c["ok"] for c in cs.phase_spmm(8, 16,
                                                  expect_route="triton"))


@pytest.mark.parametrize("which", ["dense", "block", "esc"])
def test_phase_spgemm_tiny(which, monkeypatch):
    import sparse_tpu.ops.spgemm as sg

    p, e, _ = _tiny()
    if which != "dense":
        # shrink the dense-path budget so tiny matrices take the routes the
        # full-size ones take
        monkeypatch.setattr(sg, "_MXU_DENSE_ELEMS", 10)
        monkeypatch.setattr(sg, "_BLOCK_ROUTE_MIN_NNZ", 1)
    s = e if which == "block" else p
    want = "mxu" if which == "dense" else which
    _all_ok(cs.phase_spgemm({which: (s, want)}))


def test_phase_lu_tiny():
    _all_ok(cs.phase_lu(12, 4))


def test_lu_system_is_diagonally_dominant():
    x = cs.lu_system(6, 4)
    off = np.abs(x).sum(axis=1) - np.abs(np.diag(x))
    assert np.all(np.diag(x) > 2 * off - 1e-12)
    np.testing.assert_allclose(x, x.T)


def test_phase_cg_tiny():
    p, _, _ = _tiny()
    checks = _all_ok(cs.phase_cg(p, 40))
    assert checks[0]["err"] < 1.0  # CG made progress


def test_cg_reference_solves_small_spd():
    import scipy.sparse as sp

    a = sp.diags([np.full(49, -1.0), np.full(50, 4.0), np.full(49, -1.0)],
                 [-1, 0, 1], format="csr")
    b = cs.cg_rhs(a, seed=3)
    x = cs.cg_reference(a, b, 60)
    assert cs.relative_residual(a, x, b) < 1e-10


def test_phase_multi_on_four_virtual_devices():
    p, e, g = _tiny()
    checks = _all_ok(cs.phase_multi(p, e, g, n_dev=4, iters=40))
    names = {c["check"] for c in checks}
    assert {"halo_shards_span_devices", "pbsr_smsmm_vs_1dev",
            "pcsr_spgemm_aa_pattern", "phub_spmv_vs_scipy"} <= names

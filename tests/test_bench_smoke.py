"""Smoke-test the measurement artifacts on the CPU at tiny size: bench.py's
pieces, its refusal to run off the GPU, the peak table, and
__graft_entry__'s single-device entry."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "benchmarks"))


def test_bench_pipeline_tiny():
    import bench

    rows, cols, blocks, b = bench.build_block_band(nb=64)
    assert bench.scipy_time(rows, cols, blocks, b) > 0
    times = bench.gpu_times(rows, cols, nb=64, k=32, compare=True, iters=1)
    # off the GPU the route is XLA, and there is nothing to compare with
    assert list(times) == ["xla"] and times["xla"] > 0


def test_bench_refuses_cpu(capsys):
    import bench

    with pytest.raises(SystemExit, match="no GPU"):
        bench.main([])
    assert capsys.readouterr().out == ""  # no result line printed


@pytest.mark.parametrize("kind,hbm", [("NVIDIA H100 80GB HBM3", 3350.0)])
def test_peak_table_known_kind(kind, hbm):
    from peaks import peak_for

    p = peak_for(kind)
    assert p.hbm_gbps == hbm and p.f32_tflops == 67.0
    assert "data sheet" in p.source


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB", "NVIDIA H100 PCIe", ""])
def test_peak_table_unknown_kind_raises(kind):
    from peaks import peak_for

    with pytest.raises(KeyError, match="no published peaks"):
        peak_for(kind)


def test_device_record_and_compile_cache(monkeypatch, tmp_path):
    from sparse_tpu.utils.profiling import device_record, use_compile_cache

    rec = device_record()
    assert rec["platform"] == "cpu" and rec["count"] >= 1
    json.dumps(rec)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert use_compile_cache(ROOT) == str(tmp_path)


def test_entry_shapes():
    import __graft_entry__ as g

    fn, args = g.entry()
    out = fn(*args)
    assert out.shape == (512, 64)
    assert not np.any(np.isnan(np.asarray(out)))


@pytest.mark.parametrize("k", [16, 128])
def test_bench_direct_bell_construction_parity(k):
    # device_bell builds the BELL directly (pattern host-side, values
    # device-generated): band structure and kernel/XLA parity must hold
    import jax
    import jax.numpy as jnp

    import bench
    from sparse_tpu.formats.bell import bell_spmm_xla, bell_todense
    from sparse_tpu.ops.pallas_bell import bell_spmm_triton

    nb, bsz = 40, bench.BSZ
    rows, cols, _, _ = bench.build_block_band(nb=nb)
    a = bench.device_bell(rows, cols, nb)
    dense = np.asarray(bell_todense(a)).reshape(nb, bsz, nb, bsz)
    nzb = np.any(dense != 0, axis=(1, 3))
    expect = np.zeros((nb, nb), bool)
    for off in range(-2, 3):
        expect |= np.eye(nb, k=off, dtype=bool)
    np.testing.assert_array_equal(nzb, expect)
    bj = jax.random.normal(jax.random.PRNGKey(1), (nb * bsz, k),
                           jnp.float32) * 0.01
    got = bell_spmm_triton(a, bj, interpret=True)
    want = bell_spmm_xla(a, bj)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-5, atol=1e-7)


def test_suite_copy_and_fixture_spmv_sections(monkeypatch, capsys):
    # the suite's sections run off the GPU when called directly; main()
    # refuses
    import suite

    monkeypatch.setattr(suite, "PEAK_GBPS", 3350.0)
    suite.bench_copy(True)
    suite.bench_spmv_fixtures(True)
    recs = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    by = {r["metric"]: r for r in recs}
    assert by["copy_bw"]["value"] > 0 and suite.COPY_GBPS > 0
    for m in ("fem_poisson_1m_csr_smvm_fast_bw",
              "fem_elasticity_400k_bell_smvm_bsz2_bw",
              "graph_powerlaw_1m_segment_sum_bw"):
        assert by[m]["share_of_copy"] > 0 and by[m]["ms"] > 0
    with pytest.raises(SystemExit, match="no GPU"):
        suite.main([])

"""Multi-process (jax.distributed) correctness: 2 CPU processes x 4 virtual
devices = one 8-device global mesh over the multi-controller (DCN) path.

The single-process suite exercises in-process collectives; this spawns
real separate processes (CPU only) with ``jax.distributed.initialize`` so the process-
boundary code path (``put_sharded`` via ``make_array_from_process_local_
data``, cross-process collectives) has a test precedent (SURVEY.md §4
item 4 — the reference has none; this is a north-star addition).
"""

import os
import socket
import subprocess
import sys

import pytest


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_two_process_spmv_and_cg():
    port = _free_port()
    worker = os.path.join(os.path.dirname(__file__), "_mp_worker.py")
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # worker sets its own device count
    env["JAX_PLATFORMS"] = "cpu"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(i), "2", str(port)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            env=env,
        )
        for i in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("multi-process workers timed out:\n" + "\n".join(outs))
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out}"
        assert f"MP_OK {i}" in out, f"worker {i} no OK marker:\n{out}"

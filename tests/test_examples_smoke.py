"""Examples stay runnable: smoke-run a representative subset.

Each example script is user-facing documentation; this keeps them from
rotting as APIs evolve. Only the cheaper scripts run here (the full set
was exercised when added); each runs in a subprocess with the repo on
PYTHONPATH and must exit 0.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script, tmp_path, *args, timeout=900):
    env = dict(os.environ)
    # pin the subprocess to the CPU: the examples run on whatever
    # devices JAX finds, and the suite must not depend on a card
    extra = [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    env["PYTHONPATH"] = os.pathsep.join([REPO] + extra)
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", script),
         str(tmp_path), *args],
        env=env, capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, (
        f"{script} failed:\n{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
    return proc.stdout


@pytest.mark.parametrize("script", [
    "filterdata/filter_data_generation.py",
    "noise/noise_model.py",
    "trigger/longtrace_sharded.py",
    "trigger/event_builder.py",
    "trigger/coincidence_pipeline.py",
    "processing/mesh_pipelines.py",
])
def test_example_runs(script, tmp_path):
    # the mesh examples run on the machine's devices unless told to use
    # a virtual CPU mesh
    args = (("--cpu-mesh", "8") if script in (
        "trigger/longtrace_sharded.py", "processing/mesh_pipelines.py")
        else ())
    _run(script, tmp_path, *args)


def test_didv_example_recovers_physics(tmp_path):
    out = _run("iv_didv/didv_analysis.py", tmp_path)
    assert "loop gain" in out and "ALL" not in out  # printed diagnostics
    # β and loop gain recovered (the script prints true values alongside)
    for line in out.splitlines():
        if line.startswith("beta ="):
            beta = float(line.split("=")[1].split("±")[0])
            assert abs(beta - 2.0) < 0.2
        if line.startswith("loop gain ="):
            lg = float(line.split("=")[1].split("±")[0])
            assert abs(lg - 10.0) < 1.0

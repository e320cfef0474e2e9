"""The benchmark's process discipline: every device touch in bench.py is a
bounded, group-killable child, the parent never initializes a backend (so
each child is the only process on the card), and a run that finds no GPU
reports an error instead of a number."""

import importlib.util
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name, fname):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, fname)
    )
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    return m


def test_run_bounded_kills_the_whole_process_group():
    """A hung child that spawned a pipe-holding grandchild must still be
    reaped at the timeout: plain subprocess.run kills only the child and
    then blocks draining pipes the grandchild keeps open."""
    bench = _load("bench_gate_mod", "bench.py")
    cmd = [
        sys.executable,
        "-c",
        "import subprocess, sys, time\n"
        # grandchild inherits our stdout/stderr pipes and outlives the kill
        "subprocess.Popen([sys.executable, '-c', 'import time; time.sleep(600)'])\n"
        "time.sleep(600)\n",
    ]
    t0 = time.monotonic()
    rc, out, err = bench._run_bounded(cmd, 2.0)
    dt = time.monotonic() - t0
    assert rc == -9
    assert dt < 30.0, f"group kill took {dt:.1f}s"


def test_zero_line_is_a_parseable_primary_line():
    bench = _load("bench_gate_mod2", "bench.py")
    parsed = json.loads(bench._zero_line("boom"))
    assert parsed["metric"] == "physics_env_steps_per_sec"
    assert parsed["value"] == 0.0
    assert parsed["vs_baseline"] == 0.0
    assert parsed["error"] == "boom"


def test_bench_parent_never_initializes_a_backend():
    """Importing bench.py (what the parent process runs) creates no JAX
    client: a client would reserve card memory the children need."""
    runner = (
        "import bench, jax._src.xla_bridge as xb\n"
        "print('BACKENDS', sorted(xb._backends))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", runner], cwd=ROOT, capture_output=True,
        text=True, timeout=240,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "BACKENDS []" in proc.stdout, proc.stdout


def test_primary_refuses_a_non_gpu_platform():
    """On a host without a GPU the primary child prints its zero line with
    the reason, never a CPU timing under the GPU metric's name."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "bench.py"), "--primary"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["value"] == 0.0
    assert "no GPU" in line["error"]


def test_chip_smoke_refuses_a_host_without_a_gpu():
    """No GPU: nonzero exit and no result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo,
    the script exits nonzero and prints no result."""
    import shutil

    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, str(tmp_path / "chip_smoke.py")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=240,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout

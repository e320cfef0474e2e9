"""Driver entry points stay runnable: single-chip step + multi-chip dryrun
on the virtual CPU mesh."""

import pytest
import importlib.util
import os

import jax
import numpy as np


def _load():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "graft_entry", os.path.join(root, "__graft_entry__.py")
    )
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    return m


def test_entry_compiles_and_runs():
    m = _load()
    fn, args = m.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    state, rgb = out
    assert rgb.shape == (128, 256, 3)
    assert np.isfinite(np.asarray(rgb)).all()


def test_dryrun_multichip_8():
    m = _load()
    m.dryrun_multichip(8)


@pytest.mark.slow
def test_dryrun_multichip_bootstraps_without_conftest():
    """Reproduce the DRIVER environment: a fresh process that does NOT get
    conftest's 8 virtual CPU devices must still pass dryrun_multichip(8) by
    re-exec'ing itself with a virtual mesh (round-1 failure MULTICHIP_r01)."""
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    # strip any inherited virtual-device flags so the child sees 1 device
    env["XLA_FLAGS"] = " ".join(
        f
        for f in env.get("XLA_FLAGS", "").split()
        if "xla_force_host_platform_device_count" not in f
    )
    runner = (
        "import jax\n"
        # single-device CPU process (like a one-card host, without
        # touching a real card from the test suite)
        "jax.config.update('jax_platforms', 'cpu')\n"
        "import __graft_entry__ as g\n"
        "assert len(jax.devices()) < 8, 'expected a single-device process'\n"
        "g.dryrun_multichip(8)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", runner],
        env=env,
        cwd=root,
        capture_output=True,
        text=True,
        timeout=1800,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "dryrun_multichip ok" in proc.stdout

"""Multi-host mesh demo: the env-sharded RL rollout across processes.

Single host (default): builds the biggest mesh the local devices allow and
runs the sharded rollout — identical code path to multi-host.

Multi-host: launch one process per host with the standard JAX cluster env
(or explicit flags) and the SAME command on every host:

    JAX_COORDINATOR=host0:1234 NPROC=4 PROC_ID=<k> python scripts/multihost_demo.py

jax.distributed.initialize() stitches the hosts into one global device set;
the ('dp','sp') mesh then spans hosts.  Sharding layout rules (the
scaling-book recipe):

  * 'dp' (independent envs) is the OUTER axis: no per-step cross-env
    collectives except the psum'd telemetry scalars, so it is the axis to
    place across hosts — DCN sees one small psum per rollout, not data.
  * 'sp' (spatial halo exchange, scx.parallel.spatial) does one ppermute
    per neighbor per step, so it must stay INSIDE a host/pod slice where
    hops ride ICI.  make_mesh(dp, sp) orders the mesh so consecutive
    devices (same host) fill 'sp' first.
  * Checkpoint/restore of a sharded fleet: every process saves its local
    shard (scx.app.checkpoint works on the local slice), or gather to
    host 0 for single-file saves.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def maybe_init_distributed() -> bool:
    """Initialize jax.distributed from env when configured; else local."""
    import jax

    coord = os.environ.get("JAX_COORDINATOR")
    if not coord:
        return False
    jax.distributed.initialize(
        coordinator_address=coord,
        num_processes=int(os.environ["NPROC"]),
        process_id=int(os.environ["PROC_ID"]),
    )
    return True


def main():
    multi = maybe_init_distributed()
    import jax

    if not multi and jax.device_count() < 2:
        # one real device: bootstrap a virtual CPU mesh (same trick as
        # __graft_entry__.dryrun_multichip)
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + " --xla_force_host_platform_device_count=8"
        ).strip()
        jax.config.update("jax_platforms", "cpu")

    import numpy as np

    from scx.app.rlenv import CityRLEnv
    from scx.parallel.mesh import make_mesh

    n_dev = jax.device_count()
    mesh = make_mesh(dp=n_dev, sp=1)
    n_envs = 8 * n_dev
    print(
        f"process {jax.process_index()}/{jax.process_count()}: "
        f"{n_dev} devices, mesh dp={n_dev}, {n_envs} envs",
        flush=True,
    )
    env = CityRLEnv(n_envs=n_envs, capacity=96, obs_size=64, n_traffic=4)
    actions = np.tile(np.asarray([[0.6, 0.0, 0.05, 0.0]], np.float32), (n_envs, 1))
    (obs_means, rewards), stats = env.rollout_sharded(actions, length=5, mesh=mesh)
    print(
        f"rollout ok: alive={int(stats['alive'])} "
        f"reward_sum={float(stats['reward_sum']):.3f} "
        f"nan_rollbacks={int(stats['nan_rollbacks'])}",
        flush=True,
    )


if __name__ == "__main__":
    main()

"""Batched RL envs with REAL GLB world content at big-scene capacity:
512 entities per env of imported GLB buildings, cluster-kernel
observations, 1024 envs.

Scene: 512-capacity city envs whose procedural props bind imported GLB
building meshes (~130 tris each, scx.assets.glbgen through the real
importer) instead of unit cubes; observations render through the
env-batched cluster rasterizer (raster_gbuffer_batched cluster path).

Prints BENCH_JSON {metric, value, unit, vs_baseline}.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from scx.core.cache import enable_compile_cache

enable_compile_cache()

import numpy as np


def main():
    fast = os.environ.get("SCX_BENCH_FAST", "0") == "1"
    envs = int(os.environ.get("ENVS", "1024"))
    capacity = int(os.environ.get("CAP", "512"))
    obs = int(os.environ.get("OBS", "128"))
    length = int(os.environ.get("LEN", "6" if fast else "10"))

    from scx.app.rlenv import CityRLEnv
    from scx.assets.glbgen import building_pool_meshes

    meshes, slots = building_pool_meshes(8)
    n_tris = sum(t.shape[0] for _, t in meshes[2:])
    t0 = time.time()
    env = CityRLEnv(
        n_envs=envs,
        capacity=capacity,
        obs_size=obs,
        n_traffic=12,
        use_cluster_obs=os.environ.get("CLUSTER", "0") == "1",
        meshes=meshes,
        prop_mesh_ids=slots,
        draw_budget=int(os.environ.get("DRAWS", "256")),
        max_tris=int(os.environ.get("MAXTRIS", "12288")),
        # 16-row tiles: an 8-tile lattice keeps per-tile cluster lists
        # tight (64-row tiles = 2 giant tiles = no binning at all)
        obs_tile_h=int(os.environ.get("OBS_TILE", "16")),
        # NOTE: bake renders ALL statics (no draw-budget drop), so images
        # can differ from the budgeted path when visible > DRAWS
        static_bake=os.environ.get("RL_STATIC_BAKE", "1") == "1",  # A/B hook
    )
    print(
        f"built {envs} envs (cap {capacity}, {len(slots)} GLB buildings, "
        f"{n_tris} pool tris, max_tris {env.raster.max_tris}) "
        f"in {time.time()-t0:.1f}s",
        flush=True,
    )

    actions = np.tile(
        np.asarray([0.6, 0.0, 0.1, 0.0], np.float32), (envs, 1)
    )

    # compile + warm with the SAME length as the measurement: a different
    # scan length is a different program, and a compile must not land
    # inside the measured call
    import jax.numpy as jnp

    def force(x):
        # HOST READ: waits for the device
        return float(jnp.sum(jnp.asarray(x).astype(jnp.float32)))

    t0 = time.time()
    means, rews = env.rollout(actions, length=length)
    force(rews)
    print(f"compile+first rollout: {time.time()-t0:.1f}s", flush=True)
    # second untimed rollout so the converged chunker's (bigger) launch
    # lengths are compiled BEFORE the measured calls; do NOT reset
    # env._chunker, that forces the re-learn into the measurement
    means, rews = env.rollout(actions, length=length)
    force(rews)

    best = float("inf")
    for _ in range(2):
        t0 = time.time()
        means, rews = env.rollout(actions, length=length)
        force(rews)  # timed region ends with a host read
        best = min(best, time.time() - t0)
    dt = best
    rate = envs * length / dt
    print(
        f"{length} steps x {envs} envs in {dt:.2f}s -> {rate:.1f} env-steps/s",
        flush=True,
    )
    print("BENCH_JSON " + json.dumps({
        "metric": "rl_env_steps_per_sec_glb512",
        "value": round(rate, 1),
        "unit": "env_steps/s",
        "vs_baseline": round(rate / 1000.0, 3),
        "envs": envs,
        "capacity": capacity,
        "obs": obs,
        "pool_tris": int(n_tris),
    }), flush=True)


if __name__ == "__main__":
    main()

"""Raster kernels against the XLA reference, and the sub-tile sweep.

Two shapes:
  city  the bench_city_720p.py frame (1280x720, ~80k triangles, static
        bake) through the cluster kernel;
  rl    CityRLEnv(n_envs=4096, obs_size=128) observations through the
        triangle-binned kernel.

For each shape: the kernel alone (lists already binned) at every program
sub-tile x warp count of the sweep, and `rasterize_reference` (a lax.scan
over every triangle and every pixel) compiled by XLA. Prints one
BENCH_JSON line per measurement, each with the card's name and power
limit.

    python benchmarks/bench_raster_kernels.py [city] [rl]
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "benchmarks"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from scx.core.cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

SWEEP = [(16, 16, 4), (32, 32, 4), (16, 64, 4),
         (16, 16, 8), (32, 32, 8), (16, 64, 8)]
RL_ENVS = int(os.environ.get("RL_ENVS", "4096"))


def card():
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    )
    return out.stdout.strip()


def time_ms(fn, *args, reps=10):
    """Median wall time of fn(*args) in ms, each call waited for."""
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append((time.perf_counter() - t0) * 1e3)
    return sorted(ts)[len(ts) // 2]


def emit(**kw):
    kw["card"] = CARD
    print("BENCH_JSON " + json.dumps(kw), flush=True)


def city():
    import chip_smoke as cs
    from scx.ops import raster as ops
    from scx.ops import raster_clusters as rc
    from scx.render import pipeline as pipe

    c = cs.city_scene()
    setup, aabb, valid, _ = jax.jit(lambda vp: pipe.setup_frame_baked(
        c["baked"], c["no_dyn"], c["pool"], vp, c["params"], c["dyn_params"]
    ))(c["vp"])
    frame = c["params"].replace(max_tris=setup.shape[0])
    kc = frame.max_clusters_per_tile

    @jax.jit
    def lists(setup, aabb, valid):
        ca, cv, cz = rc.cluster_bounds(aabb, valid, frame.max_tris, setup)
        ca2, cv2, cz2, order, _ = rc.compact_clusters(ca, cv, cz)
        ids, counts = rc.bin_clusters(ca2, cv2, frame, kc, cl_zmin=cz2)
        return order[ids], counts, cz

    ids, counts, cz = lists(setup, aabb, valid)
    emit(shape="city", what="bin", ms=time_ms(lists, setup, aabb, valid),
         tris=int(setup.shape[0]), mean_clusters_per_tile=float(counts.mean()))
    for sh, sw, nw in SWEEP:
        p = frame.replace(sub_h=sh, sub_w=sw, num_warps=nw)
        k = jax.jit(lambda s, i, n, z, p=p: rc.rasterize_clusters(
            s, i, n, p, kc, cl_zmin=z)["depth"])
        emit(shape="city", what="kernel", sub=[sh, sw], num_warps=nw,
             ms=time_ms(k, setup, ids, counts, cz))
    ref = jax.jit(lambda s: ops.rasterize_reference(s, frame)["depth"])
    emit(shape="city", what="rasterize_reference",
         ms=time_ms(ref, setup, reps=3))


def rl():
    from scx.app.rlenv import CityRLEnv
    from scx.ops import raster as ops
    from scx.render import pipeline as pipe

    env = CityRLEnv(n_envs=RL_ENVS, obs_size=128)
    p0 = env.raster
    setup, aabb, valid = jax.jit(jax.vmap(env._render_one))(env.state)
    bins = jax.jit(lambda s, a, v: pipe.bin_triangles_batched(s, a, v, p0))
    binned, counts = bins(setup, aabb, valid)
    emit(shape="rl", what="bin", ms=time_ms(bins, setup, aabb, valid),
         envs=RL_ENVS, tris_per_env=int(setup.shape[1]),
         mean_tris_per_tile=float(counts.mean()))
    for sh, sw, nw in SWEEP:
        p = p0.replace(sub_h=sh, sub_w=sw, num_warps=nw)
        k = jax.jit(lambda b, n, p=p: ops.rasterize_tiles_batched(
            b, n, p)["depth"])
        emit(shape="rl", what="kernel", sub=[sh, sw], num_warps=nw,
             ms=time_ms(k, binned, counts))
    ref = jax.jit(jax.vmap(lambda s: ops.rasterize_reference(s, p0)["depth"]))
    emit(shape="rl", what="rasterize_reference",
         ms=time_ms(ref, setup, reps=3))


if __name__ == "__main__":
    if jax.default_backend() != "gpu":
        sys.exit("bench_raster_kernels: needs the GPU")
    CARD = card()
    for name in sys.argv[1:] or ["city", "rl"]:
        {"city": city, "rl": rl}[name]()

"""Stage attribution of the baked 720p city frame.

Chained-scan deltas over the exact stages of
render_frame_baked -> _raster_and_shade: setup / cluster bounds+compact /
bin / raster / shade. Prints each cumulative stage and the per-stage
deltas so the next roofline lever is chosen by data.

Usage: python scripts/profile_city.py [--iters 30] [--cpu]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmarks"))

import jax


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--grid", type=int, default=22)
    args = ap.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from scx.core.cache import enable_compile_cache

    enable_compile_cache()

    import jax.numpy as jnp
    import numpy as np
    from scx import render as rd
    from scx.render import pipeline as pipe
    from scx.render import staticbake as sb
    from scx.ops import raster_clusters as rc
    from scx.render.mesh import build_mesh_pool
    from scx.assets import textures as texmod
    from cityscene import build_city_mesh

    verts, tris = build_city_mesh(grid=args.grid, subdiv=4, ground=24, seed=7)
    print("city chunk:", len(tris), "tris", flush=True)
    pool = build_mesh_pool([(verts, tris)])
    KC = 256
    params = rd.RasterParams(width=1280, height=720, max_tris=131072,
                             max_clusters_per_tile=KC, min_area2=0.25,
                             interpret=args.cpu)
    draws = rd.DrawList(mesh_id=jnp.zeros((1,), jnp.int32),
                        material_id=jnp.zeros((1,), jnp.int32),
                        model=jnp.eye(4)[None], valid=jnp.ones((1,), bool))
    mats = pipe.Materials(texture_id=jnp.asarray([0], jnp.int32), tint=jnp.ones((1, 3)))
    base = texmod.checker_texture(128, cells=16)
    tex = pipe.MipTextures(quads=jnp.asarray(texmod.build_mip_quads(base))[None], size=128)

    t_s = -(-len(tris) // 128) * 128
    baked = jax.jit(lambda d: sb.bake_draws(d, pool, t_s, morton=False))(draws)
    no_dyn = rd.DrawList(mesh_id=jnp.zeros((1,), jnp.int32),
                         material_id=jnp.zeros((1,), jnp.int32),
                         model=jnp.eye(4)[None], valid=jnp.zeros((1,), bool))
    dyn_params = params.replace(max_tris=64, clip_extra=32)

    pad_s = (min(params.clip_extra, baked.shape[1] // 4) // 32) * 32
    params_static = params.replace(max_tris=baked.shape[1] + pad_s, clip_extra=pad_s)

    def vp_at(i):
        eye = jnp.asarray([7.0, 2.5, 4.0]) + jnp.asarray([1e-3, 0.0, 0.0]) * i
        return rd.camera_view_proj(eye, jnp.asarray([7.0, 2.0, -60.0]),
                                   jnp.asarray([0.0, 1.0, 0.0]), aspect=1280 / 720)

    def build_setup(vpi):
        s_setup, s_aabb, s_valid = sb.setup_static_from_bake(baked, vpi, params_static)
        d_setup, d_aabb, d_valid = pipe.setup_triangles(no_dyn, pool, vpi, dyn_params)
        setup = jnp.concatenate([s_setup, d_setup], axis=0)
        aabb = jnp.concatenate([s_aabb, d_aabb], axis=0)
        valid = jnp.concatenate([s_valid, d_valid], axis=0)
        return setup, aabb, valid, params.replace(max_tris=setup.shape[0])

    # ---- cumulative stages; each returns a small reduction to carry ----
    def st_setup(vpi):
        setup, aabb, valid, _ = build_setup(vpi)
        return setup[::64, 0].sum() + aabb[::64, 0].sum() + valid[::64].sum()

    def st_bounds(vpi):
        setup, aabb, valid, frame = build_setup(vpi)
        cl_aabb, cl_valid, cl_zmin = rc.cluster_bounds(aabb, valid, frame.max_tris, setup)
        c_aabb, c_valid, c_zmin, order, _ = rc.compact_clusters(cl_aabb, cl_valid, cl_zmin)
        return c_aabb[::16].sum() + order[::16].sum() + c_zmin[::16].sum()

    def st_bin(vpi):
        setup, aabb, valid, frame = build_setup(vpi)
        cl_aabb, cl_valid, cl_zmin = rc.cluster_bounds(aabb, valid, frame.max_tris, setup)
        c_aabb, c_valid, c_zmin, order, _ = rc.compact_clusters(cl_aabb, cl_valid, cl_zmin)
        cl_ids, cl_counts = rc.bin_clusters(c_aabb, c_valid, frame,
                                            frame.max_clusters_per_tile, cl_zmin=c_zmin)
        return cl_ids[::8, ::8].sum().astype(jnp.float32) + cl_counts.sum().astype(jnp.float32)

    def st_raster(vpi):
        setup, aabb, valid, frame = build_setup(vpi)
        cl_aabb, cl_valid, cl_zmin = rc.cluster_bounds(aabb, valid, frame.max_tris, setup)
        c_aabb, c_valid, c_zmin, order, _ = rc.compact_clusters(cl_aabb, cl_valid, cl_zmin)
        cl_ids, cl_counts = rc.bin_clusters(c_aabb, c_valid, frame,
                                            frame.max_clusters_per_tile, cl_zmin=c_zmin)
        cl_ids = order[cl_ids]
        g = rc.rasterize_clusters(setup, cl_ids, cl_counts, frame,
                                  frame.max_clusters_per_tile, cl_zmin=cl_zmin)
        return g["depth"][::64, ::64].sum()

    def st_full(vpi):
        rgb, _, _ = pipe.render_frame_baked(baked, no_dyn, pool, vpi, params,
                                            dyn_params, mats, tex)
        return rgb[::64, ::64].sum()

    stages = {"setup": st_setup, "bounds+compact": st_bounds, "bin": st_bin,
              "raster": st_raster, "full(+shade)": st_full}
    N = args.iters

    def chain(stage_fn):
        def body(c, i):
            return c + stage_fn(vp_at(i)), None
        return jax.lax.scan(body, jnp.float32(0), jnp.arange(N))[0]

    compiled = {}
    for name, fn in stages.items():
        t0 = time.time()
        f = jax.jit(lambda fn=fn: chain(fn)).lower().compile()
        jax.block_until_ready(f())
        compiled[name] = f
        print(f"compiled {name} in {time.time()-t0:.1f}s", flush=True)

    results = {}
    for name, f in compiled.items():
        t0 = time.time()
        jax.block_until_ready(f())
        results[name] = (time.time() - t0) / N * 1e3
        print(f"{name:>16}: {results[name]:7.2f} ms/frame", flush=True)

    keys = list(results)
    for a, b in zip(keys, keys[1:]):
        print(f"{b:>16}: {results[b]-results[a]:7.2f} ms (delta)", flush=True)


if __name__ == "__main__":
    main()

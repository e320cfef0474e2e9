"""Spatially-sharded render of ONE huge frame: 1280x2048 city chunk with
framebuffer rows split over the mesh's 'sp' axis (render_frame_rows).

This is the SP/CP analogue for rendering (SURVEY §2 parallelism item 6):
each chip runs the identical (cheap) geometry setup, then bins + rasters
only its strip of the tile lattice — zero cross-chip traffic except the
output gather. On the single-chip driver machine the mesh degenerates to
sp=1 (full frame on one chip = the scaling baseline, still through
shard_map); on a pod slice the same script shards rows for real.

Prints BENCH_JSON with full-frame FPS.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from scx.core.cache import enable_compile_cache

enable_compile_cache()

import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import PartitionSpec as P

from cityscene import build_city_mesh
from scx import render as rd
from scx.assets import textures as texmod
from scx.parallel.mesh import make_mesh
from scx.render import pipeline as pipe
from scx.render.mesh import build_mesh_pool


def main():
    W = int(os.environ.get("W", "1280"))
    H = int(os.environ.get("H", "2048"))
    verts, tris = build_city_mesh(grid=22, subdiv=4, ground=24, seed=7)
    print("city chunk:", len(tris), "tris", flush=True)
    pool = build_mesh_pool([(verts, tris)])

    n_dev = len(jax.devices())
    sp = int(os.environ.get("SP", str(n_dev)))
    mesh = make_mesh(dp=1, sp=sp)
    rows_per = H // sp
    assert rows_per % 64 == 0, "strip must be a multiple of tile_h (64)"
    n_iters = int(os.environ.get("ITERS", "20"))

    params = rd.RasterParams(
        width=W, height=H, max_tris=131072, max_clusters_per_tile=256,
        min_area2=0.25, interpret=jax.default_backend() == "cpu",
    )
    draws = rd.DrawList(
        mesh_id=jnp.zeros((1,), jnp.int32),
        material_id=jnp.zeros((1,), jnp.int32),
        model=jnp.eye(4)[None], valid=jnp.ones((1,), bool),
    )
    # high camera looking down the avenue so the tall frame is full of city
    vp = rd.camera_view_proj(
        jnp.asarray([7.0, 6.0, 14.0]), jnp.asarray([7.0, 0.0, -80.0]),
        jnp.asarray([0.0, 1.0, 0.0]), aspect=W / H,
    )
    mats = pipe.Materials(
        texture_id=jnp.asarray([0], jnp.int32), tint=jnp.ones((1, 3))
    )
    base = texmod.checker_texture(128, cells=16)
    tex = pipe.MipTextures(
        quads=jnp.asarray(texmod.build_mip_quads(base))[None], size=128
    )

    def local(d):
        row0 = jax.lax.axis_index("sp") * rows_per
        rgb, _, stats = pipe.render_frame_rows(
            d, pool, vp, params, row0, rows_per, mats, tex
        )
        return rgb, jax.tree.map(lambda x: jax.lax.pmax(x, "sp"), stats)

    fn = jax.jit(shard_map(
        local, mesh=mesh, in_specs=(P(),),
        out_specs=(P("sp", None, None), P()), check_vma=False,
    ))

    t0 = time.time()
    rgb, stats = fn(draws)
    float(jnp.sum(rgb))  # host read: waits for the device
    print("compile+first: %.1f s" % (time.time() - t0), flush=True)
    assert rgb.shape == (H, W, 3)
    print("max_occ:", int(stats["max_tile_occupancy"]),
          "overflow:", int(stats["tile_overflow"]), flush=True)

    # device-chained frames: camera nudge per frame defeats loop-invariant
    # hoisting without changing the work
    def local_chain(d):
        def body(c, i):
            eye = jnp.asarray([7.0, 6.0, 14.0]) + jnp.asarray([1e-3, 0.0, 0.0]) * i
            vpi = rd.camera_view_proj(
                eye, jnp.asarray([7.0, 0.0, -80.0]),
                jnp.asarray([0.0, 1.0, 0.0]), aspect=W / H,
            )
            row0 = jax.lax.axis_index("sp") * rows_per
            rgb, _, _ = pipe.render_frame_rows(
                d, pool, vpi, params, row0, rows_per, mats, tex
            )
            return c + rgb[::64, ::64].sum(), None
        return jax.lax.scan(body, jnp.float32(0), jnp.arange(n_iters))[0][None]

    chainf = jax.jit(shard_map(
        local_chain, mesh=mesh, in_specs=(P(),), out_specs=P("sp"),
        check_vma=False,
    ))
    float(jnp.sum(chainf(draws)))  # warm, forced by host read
    t0 = time.time()
    float(jnp.sum(chainf(draws)))  # timed region ends with a host read
    dt = (time.time() - t0) / n_iters
    print("chained frame: %.2f ms -> %.1f FPS (sp=%d, %d rows/chip)"
          % (dt * 1e3, 1 / dt, sp, rows_per), flush=True)
    print("BENCH_JSON " + json.dumps({
        "metric": f"city_{W}x{H}_sp_render_fps", "value": round(1 / dt, 1),
        "unit": "FPS", "vs_baseline": round((1 / dt) / 30.0, 3),
        "sp": sp,
    }), flush=True)

    arr = np.clip(np.asarray(rgb) * 255, 0, 255).astype(np.uint8)
    try:
        from PIL import Image

        out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "out")
        os.makedirs(out, exist_ok=True)
        Image.fromarray(arr).save(os.path.join(out, "city_tall.png"))
    except ImportError:
        pass


if __name__ == "__main__":
    main()

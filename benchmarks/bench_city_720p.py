"""BASELINE config #3: one dense city chunk (~100k tris), street-level camera."""
import time, sys
import os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax
from scx.core.cache import enable_compile_cache

enable_compile_cache()
import jax.numpy as jnp, numpy as np
from scx import render as rd
from scx.render import pipeline as pipe
from scx.ops import raster_clusters as rc
from scx.render.mesh import build_mesh_pool

# dense city-chunk mesh (~100k tris: 22x22 buildings, subdiv-4 facades)
from cityscene import build_city_mesh

verts, tris = build_city_mesh(grid=22, subdiv=4, ground=24, seed=7)
print("city chunk:", len(tris), "tris", len(verts), "verts", flush=True)

pool = build_mesh_pool([(verts, tris)])
KC = int(os.environ.get("KC", "256"))
TILE_H = int(os.environ.get("TILE_H", "64"))  # 720/64 pads to 12 rows
params = rd.RasterParams(width=1280, height=720, max_tris=131072,
                         max_clusters_per_tile=KC, min_area2=0.25,
                         tile_h=TILE_H, interpret=False)
draws = rd.DrawList(mesh_id=jnp.zeros((1,), jnp.int32), material_id=jnp.zeros((1,), jnp.int32),
                    model=jnp.eye(4)[None], valid=jnp.ones((1,), bool))
# street-level camera looking down an avenue
vp = rd.camera_view_proj(jnp.asarray([7.0, 2.5, 4.0]), jnp.asarray([7.0, 2.0, -60.0]),
                         jnp.asarray([0.0, 1.0, 0.0]), aspect=1280/720)
# mip-mapped texturing ON (the reference textures everything): one
# checkerboard albedo material
from scx.assets import textures as texmod
mats = pipe.Materials(texture_id=jnp.asarray([0], jnp.int32), tint=jnp.ones((1,3)))
base = texmod.checker_texture(128, cells=16)
tex = pipe.MipTextures(quads=jnp.asarray(texmod.build_mip_quads(base))[None], size=128)

# the frame is ONE fused jit of the public API (separate stage jits pay a
# per-call dispatch cost and block cross-stage fusion)
BAKE = os.environ.get("STATIC_BAKE", "1") == "1"  # static-bake A/B hook
if BAKE:
    from scx.render import staticbake as sb
    t_s = -(-len(tris) // 128) * 128
    baked = jax.jit(lambda d: sb.bake_draws(d, pool, t_s, morton=False))(draws)
    no_dyn = rd.DrawList(mesh_id=jnp.zeros((1,), jnp.int32),
                         material_id=jnp.zeros((1,), jnp.int32),
                         model=jnp.eye(4)[None], valid=jnp.zeros((1,), bool))
    dyn_params = params.replace(max_tris=64, clip_extra=32)
    def _frame(vpi):
        return pipe.render_frame_baked(baked, no_dyn, pool, vpi, params,
                                       dyn_params, mats, tex)
else:
    def _frame(vpi):
        return pipe.render_frame(draws, pool, vpi, params, mats, tex)
framef = jax.jit(lambda d: _frame(vp))

FAST = os.environ.get("SCX_BENCH_FAST", "0") == "1"  # driver budget mode

# timed regions end with a HOST READ of a device scalar
t0=time.time(); rgb, g, stats = framef(draws); _ = float(jnp.sum(rgb))
print("compile+first: %.1f s" % (time.time()-t0), flush=True)
print("covered:", int(np.asarray(g["covered"]).sum()),
      "max_occ:", int(stats["max_tile_occupancy"]),
      "overflow:", int(stats["tile_overflow"]), flush=True)
N=30
if not FAST:
    t0=time.time()
    for _ in range(N): rgb, g, stats = framef(draws)
    _ = float(jnp.sum(rgb))  # host read
    dt=(time.time()-t0)/N
    print("per-call frame: %.2f ms -> %.1f FPS" % (dt*1e3, 1/dt), flush=True)

# deployment shape: frames chained on device (the reference pipelines 2
# frames in flight, sc_vk.h:58; a device-resident loop doesn't pay the
# per-call dispatch). Camera nudges per frame so no work is
# loop-invariant; a tiny framebuffer reduction carries the dependency.
def chain(n):
    def body(c, i):
        eye = jnp.asarray([7.0, 2.5, 4.0]) + jnp.asarray([1e-3, 0., 0.]) * i
        vpi = rd.camera_view_proj(eye, jnp.asarray([7.0, 2.0, -60.0]),
                                  jnp.asarray([0.0, 1.0, 0.0]), aspect=1280/720)
        r, _, _ = _frame(vpi)
        return c + r[::64, ::64].sum(), None
    return jax.lax.scan(body, jnp.float32(0), jnp.arange(n))[0]
chainf = jax.jit(chain, static_argnums=0)
float(chainf(N))  # warmup forced by host read
t0=time.time(); float(chainf(N)); dt=(time.time()-t0)/N  # host read
print("chained frame: %.2f ms -> %.1f FPS" % (dt*1e3, 1/dt), flush=True)
import json
print("BENCH_JSON " + json.dumps({"metric": "city_720p_fps", "value": round(1/dt, 1),
                                  "unit": "FPS", "vs_baseline": round((1/dt)/60.0, 3)}), flush=True)
print("tris_in:", int(stats["tris_in"]), flush=True)
# save a frame for visual sanity, when PIL is installed
try:
    from PIL import Image
except ImportError:
    Image = None
if Image is not None:
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "out")
    os.makedirs(out, exist_ok=True)
    arr = np.clip(np.asarray(rgb)*255, 0, 255).astype(np.uint8)
    Image.fromarray(arr).save(os.path.join(out, "city_frame.png"))
    print("saved", os.path.join(out, "city_frame.png"), flush=True)

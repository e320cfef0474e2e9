import time, sys, os
import os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax
from scx.core.cache import enable_compile_cache

enable_compile_cache()
import jax.numpy as jnp, numpy as np
from scx import render as rd
from scx.render import pipeline as pipe
from scx.ops import raster_clusters as rc

pool = rd.build_mesh_pool()
KC = 256
params = rd.RasterParams(width=1280, height=720, max_tris=131072,
                         max_clusters_per_tile=KC, min_area2=1.0, interpret=False)
n = 10000
rng = np.random.RandomState(0)
models = np.zeros((n,4,4), np.float32)
models[:, 0,0] = rng.uniform(0.4,2.0,n); models[:, 1,1] = rng.uniform(0.5,6.0,n); models[:, 2,2] = rng.uniform(0.4,2.0,n)
models[:, 3,3] = 1
models[:, 0,3] = rng.uniform(-60,60,n); models[:, 1,3] = models[:,1,1]/2; models[:, 2,3] = rng.uniform(-120,-2,n)
# ground slab (the city block's street level) as draw 0
ground = np.eye(4, dtype=np.float32)
ground[0,0] = 400.0; ground[1,1] = 0.1; ground[2,2] = 400.0
ground[1,3] = -0.05; ground[2,3] = -60.0
models = np.concatenate([ground[None], models], axis=0)
n = n + 1
draws = rd.DrawList(mesh_id=jnp.full((n,), rd.MESH_CUBE, jnp.int32), material_id=jnp.zeros((n,), jnp.int32),
                    model=jnp.asarray(models), valid=jnp.ones((n,), bool))
vp = rd.camera_view_proj(jnp.asarray([0.0, 15.0, 10.0]), jnp.asarray([0.0, 0.0, -40.0]),
                         jnp.asarray([0.0, 1.0, 0.0]), aspect=1280/720)
yy, xx = np.mgrid[0:64, 0:64]
tex = jnp.asarray(np.stack([((yy+xx)%2).astype(np.float32)]*3, -1))[None]
mats = pipe.Materials(texture_id=jnp.asarray([-1], jnp.int32), tint=jnp.ones((1,3)))

# staged pipeline: separate jits avoid the cross-stage fusion compile blowup
geom = jax.jit(lambda d: pipe.setup_triangles(pipe.sort_draws_spatial(d, vp, params), pool, vp, params))
binf = jax.jit(lambda a, v, s: rc.bin_clusters(
    *rc.cluster_bounds(a, v, params.max_tris, s)[:2], params, KC))
zminf = jax.jit(lambda a, v, s: rc.cluster_bounds(a, v, params.max_tris, s)[2])
rast = jax.jit(lambda s, i, c, z: rc.rasterize_clusters(s, i, c, params, KC, cl_zmin=z))
shadef = jax.jit(lambda g: pipe.shade(g, mats, tex))

def frame(d):
    setup, aabb, valid = geom(d)
    ids, counts = binf(aabb, valid, setup)
    z = zminf(aabb, valid, setup)
    g = rast(setup, ids, counts, z)
    return shadef(g), g

t0=time.time(); rgb, g = frame(draws); jax.block_until_ready(rgb)
print("compile+first: %.1f s" % (time.time()-t0), flush=True)
print("covered:", int(np.asarray(g["covered"]).sum()), flush=True)
N=30
t0=time.time()
for _ in range(N): rgb, g = frame(draws)
jax.block_until_ready(rgb)
dt=(time.time()-t0)/N
print("frame: %.2f ms -> %.1f FPS" % (dt*1e3, 1/dt), flush=True)
for name, f, args in [("geom", geom, (draws,))]:
    t0=time.time()
    for _ in range(N): r=f(*args)
    jax.block_until_ready(r); print("%s: %.2f ms" % (name, (time.time()-t0)/N*1e3), flush=True)
setup, aabb, valid = geom(draws)
t0=time.time()
for _ in range(N): b=binf(aabb, valid, setup)
jax.block_until_ready(b); print("bin: %.2f ms" % ((time.time()-t0)/N*1e3), flush=True)
ids, counts = b
z = zminf(aabb, valid, setup)
t0=time.time()
for _ in range(N): g2=rast(setup, ids, counts, z)
jax.block_until_ready(g2); print("raster: %.2f ms" % ((time.time()-t0)/N*1e3), flush=True)
print("max_occ:", int(jnp.max(counts)), "sat tiles:", int(jnp.sum(counts >= KC)), flush=True)

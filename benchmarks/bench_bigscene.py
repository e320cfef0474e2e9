"""One HUGE composed scene stepped across the mesh 'sp' axis: FULL engine
semantics per strip — traffic AI agents on a lane graph, raycast vehicles,
rigid-body physics with ghost-halo exchange + ownership migration — plus
framebuffer row strips, all inside one shard_map (scx.parallel.bigscene
.make_bigscene_entity_step).

On the single-chip driver machine the mesh degenerates to sp=1 (the scaling
baseline, still through shard_map + the strip renderer); on a pod slice the
same script splits the entities and the rows for real.

Scene: S strips x (1 ground slab + boxes + kinematic traffic + physics
vehicles), 1280x768 frame. Prints BENCH_JSON with composed steps/s.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from scx.core.cache import enable_compile_cache

enable_compile_cache()

import jax.numpy as jnp
import numpy as np

from scx import physics as ph
from scx import render as rd
from scx.app.sandbox import SimParams, spawn_player_vehicle
from scx.core.config import EngineConfig, TrafficConfig
from scx.parallel import bigscene as bg
from scx.parallel.mesh import make_mesh
from scx.state import entity as st
from scx.traffic import lanes as tl

WIDTH = 64.0  # strip width == procedural sector size (lanes align)


def build_strip_state(k: int, n_local: int, n_boxes: int, n_traffic: int,
                      n_vehicles: int, builder) -> st.EntityState:
    """One strip's EntityState: slab + boxes + lane agents + vehicles."""
    rng = np.random.RandomState(100 + k)
    s = st.alloc_entity_state(n_local)
    x0 = k * WIDTH

    i = 0
    # ground slab
    s = s.replace(
        alive=s.alive.at[i].set(True),
        components=s.components.at[i].set(
            st.C_TRANSFORM | st.C_COLLIDER | st.C_RIGID_BODY
        ),
        transform=s.transform.replace(
            pos=s.transform.pos.at[i].set(
                jnp.asarray([x0 + WIDTH / 2, -0.55, WIDTH / 2])
            )
        ),
        body=s.body.replace(
            body_type=s.body.body_type.at[i].set(st.BODY_STATIC),
            half_extents=s.body.half_extents.at[i].set(
                jnp.asarray([WIDTH / 2, 0.05, WIDTH / 2])
            ),
            mass=s.body.mass.at[i].set(0.0),
        ),
    )
    i += 1

    # falling boxes
    nb = min(n_boxes, n_local - i)
    pos = np.stack(
        [
            x0 + rng.uniform(1, WIDTH - 1, nb),
            rng.uniform(0.5, 6.0, nb),
            rng.uniform(1, WIDTH - 1, nb),
        ],
        axis=-1,
    ).astype(np.float32)
    sl = slice(i, i + nb)
    s = s.replace(
        alive=s.alive.at[sl].set(True),
        components=s.components.at[sl].set(
            st.C_TRANSFORM | st.C_RENDER_MESH | st.C_COLLIDER | st.C_RIGID_BODY
        ),
        transform=s.transform.replace(pos=s.transform.pos.at[sl].set(pos)),
        render=s.render.replace(
            mesh_id=s.render.mesh_id.at[sl].set(0),
            material_id=s.render.material_id.at[sl].set(0),
        ),
        body=s.body.replace(
            body_type=s.body.body_type.at[sl].set(st.BODY_DYNAMIC),
        ),
    )
    i += nb

    # kinematic traffic agents on this strip's lanes
    segs = builder.sector_segments[(k, 0)]
    for j in range(min(n_traffic, n_local - i)):
        lane = segs[j % len(segs)]
        seg = builder.segments[lane]
        ls = (0.15 + 0.7 * (j / max(n_traffic - 1, 1))) * seg["length"]
        p = np.asarray(builder.nodes[seg["start"]]["pos"]) + np.asarray(
            seg["dir"]
        ) * ls
        s = s.replace(
            alive=s.alive.at[i].set(True),
            components=s.components.at[i].set(
                st.C_TRANSFORM | st.C_RENDER_MESH | st.C_TRAFFIC
            ),
            transform=s.transform.replace(
                pos=s.transform.pos.at[i].set(jnp.asarray(p, jnp.float32))
            ),
            render=s.render.replace(
                mesh_id=s.render.mesh_id.at[i].set(0),
                material_id=s.render.material_id.at[i].set(0),
            ),
            body=s.body.replace(body_type=s.body.body_type.at[i].set(st.BODY_NONE)),
            traffic=s.traffic.replace(
                mode=s.traffic.mode.at[i].set(st.TRAFFIC_KINEMATIC),
                lane_id=s.traffic.lane_id.at[i].set(lane),
                lane_s=s.traffic.lane_s.at[i].set(float(ls)),
                speed=s.traffic.speed.at[i].set(8.0),
            ),
        )
        i += 1

    # tier-A physics vehicles (player-grade raycast cars)
    for j in range(min(n_vehicles, n_local - i)):
        s = spawn_player_vehicle(
            s, i, pos=(x0 + 8.0 + 6.0 * j, 0.6, 10.0 + 9.0 * j)
        )
        s = s.replace(
            vehicle=s.vehicle.replace(
                input=s.vehicle.input.at[i].set(
                    jnp.asarray([0.5, 0.0, 0.1 * ((j % 3) - 1), 0.0])
                )
            )
        )
        i += 1
    return s


def main():
    n_dev = len(jax.devices())
    sp = int(os.environ.get("SP", str(n_dev)))
    n_local = int(os.environ.get("NL", "512"))   # entity capacity per strip
    n_boxes = int(os.environ.get("NB", "400"))
    n_traffic = int(os.environ.get("NT", "48"))
    n_vehicles = int(os.environ.get("NV", "8"))
    W = int(os.environ.get("FRAME_W", "1280"))
    H = int(os.environ.get("FRAME_H", "768"))
    mesh = make_mesh(dp=1, sp=sp)

    builder = tl.LaneGraphBuilder(max_nodes=64 * sp, max_segments=32 * sp)
    for k in range(sp):
        builder.build_procedural_for_sector(
            (k, 0), (k * WIDTH, 0.0, 0.0), ((k + 1) * WIDTH, 0.0, WIDTH)
        )
    lanes = builder.to_arrays()

    sharded = jax.tree.map(
        lambda *xs: jnp.stack(xs),
        *[
            build_strip_state(k, n_local, n_boxes, n_traffic, n_vehicles, builder)
            for k in range(sp)
        ],
    )
    # per-strip allocs duplicate uids across strips; the warm-start cache
    # keys on them, so make them globally unique
    sharded = bg.assign_global_uids(sharded)

    cfg = EngineConfig(traffic=TrafficConfig(front_ray_length=12.0))
    sim = SimParams(solver=ph.SolverParams(max_pairs=2048, iterations=6))
    raster = rd.RasterParams(
        width=W, height=H, max_tris=65536, max_clusters_per_tile=128,
        min_area2=0.25, interpret=jax.default_backend() == "cpu",
    )
    vp = rd.camera_view_proj(
        jnp.asarray([sp * WIDTH / 2, 36.0, 110.0]),
        jnp.asarray([sp * WIDTH / 2, 0.0, WIDTH / 2]),
        jnp.asarray([0.0, 1.0, 0.0]), aspect=W / H,
    )

    step1 = bg.make_bigscene_entity_step(
        mesh, cfg, sim, raster, x0=0.0, shard_width=WIDTH,
        halo=14.0, halo_cap=96, mig_cap=48, n_steps=1,
    )
    caches = bg.empty_shard_caches(mesh, sim.solver.max_pairs)
    t0 = time.time()
    out, caches, rgb, stats = step1(sharded, caches, lanes, vp)
    float(jnp.sum(rgb))  # host read: waits for the device
    print("compile+first: %.1f s" % (time.time() - t0), flush=True)
    print(
        "entities:", sp * n_local, "alive:", int(stats["alive"]),
        "overflow:", int(stats["tile_overflow"]),
        "pair_overflow:", int(stats["pair_overflow"]), flush=True,
    )

    # device-chained measurement: N composed sim+render steps inside one
    # shard_map scan
    N = int(os.environ.get("ITERS", "20"))
    chain = bg.make_bigscene_entity_step(
        mesh, cfg, sim, raster, x0=0.0, shard_width=WIDTH,
        halo=14.0, halo_cap=96, mig_cap=48, n_steps=N,
    )
    out2, caches2, rgb2, cstats = chain(out, caches, lanes, vp)
    float(jnp.sum(rgb2))  # compile + warm, forced by host read
    t0 = time.time()
    out2, caches2, rgb2, cstats = chain(out, caches, lanes, vp)
    float(jnp.sum(rgb2))  # timed region ends with a host read
    dt = (time.time() - t0) / N
    agents = sp * (n_traffic + n_vehicles)
    print(
        "step: %.2f ms -> %.1f steps/s (sp=%d, %d entities, %d agents, %dx%d)"
        % (dt * 1e3, 1 / dt, sp, sp * n_local, agents, W, H), flush=True,
    )
    print("BENCH_JSON " + json.dumps({
        "metric": "bigscene_composed_steps_per_sec",
        "value": round(1 / dt, 1), "unit": "steps/s",
        "vs_baseline": round((1 / dt) / 60.0, 3), "sp": sp,
        "entities": sp * n_local, "traffic": sp * n_traffic,
        "vehicles": sp * n_vehicles,
    }), flush=True)

    arr = np.clip(np.asarray(rgb2) * 255, 0, 255).astype(np.uint8)
    try:
        from PIL import Image

        out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "out")
        os.makedirs(out, exist_ok=True)
        Image.fromarray(arr).save(os.path.join(out, "bigscene.png"))
    except ImportError:
        pass


if __name__ == "__main__":
    main()

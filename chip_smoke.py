#!/usr/bin/env python
"""On-card smoke test of scx's main path, phase by phase, on one GPU.

    python chip_smoke.py            # phases 1-5 on one card
    python chip_smoke.py --multi    # the four-card phase only

Phases (each prints one JSON line with its checks and informational
times; any failed phase makes the run exit nonzero):

  1 device   JAX's default backend is the GPU.
  2 physics  bench.py's fleet (1024 envs x 64 bodies, max_pairs=128,
             6 iterations, box hint): a 240-step rollout without pair
             overflow and with finite state; 8 envs against the
             conventional core after 1 step; the same 8 envs against
             the identical planar step run on the CPU after 10 steps.
  3 city     the 1280x720 city frame with mips and static bake; the
             cluster raster kernel against rasterize_reference.
  4 rl       CityRLEnv(4096 envs, 128x128 RGB-D) 4-step rollout through
             the triangle-binned kernel, then 1024 envs x 512 capacity on
             the cluster kernel for 2 steps; 4 envs' G-buffers of each
             against rasterize_reference.
  5 engine   Sandbox(capacity=4096) for 3 streamed frames, and one
             __graft_entry__.entry() step.
  --multi    on a dp=2 x sp=2 mesh of four cards: rollout_sharded against
             the single-card rollout of the same envs, bigscene at sp=2
             and sp=4 against the global solve, render_frame_rows strips
             against the full frame, and one sharded PPO train step.

Every product on these paths runs at Precision.HIGHEST: float32 in full,
no TF32. The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
A host without a GPU, or a directory without the rest of the repo, exits
nonzero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "benchmarks"))
sys.path.insert(0, os.path.join(ROOT, "examples"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from scx.core.cache import enable_compile_cache  # noqa: E402

# raster comparisons: FMA contraction can move a pixel that sits exactly
# on an edge, so coverage/material may differ on a tiny share of pixels
MISMATCH_MAX = 5e-4   # share of pixels
DEPTH_ATOL = 1e-5
COLOR_ATOL = 1e-3

# sizes (a CPU rehearsal shrinks these; the card runs them as they are)
CITY = dict(grid=22, subdiv=4, ground=24, seed=7)
RL_BINNED = dict(n_envs=4096, obs_size=128)
RL_CLUSTER = dict(n_envs=1024, capacity=512, obs_size=128)
SANDBOX_CAPACITY = 4096
MULTI_ENVS = 64


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else ""


class PhaseFailed(AssertionError):
    pass


def check(cond, what):
    if not cond:
        raise PhaseFailed(what)


def finite(tree) -> bool:
    return all(
        bool(jnp.all(jnp.isfinite(x)))
        for x in jax.tree.leaves(tree)
        if jnp.issubdtype(jnp.asarray(x).dtype, jnp.floating)
    )


def timed(fn, *args):
    """(result, seconds) of fn(*args), waiting for the device."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


def compare_gbuffers(got, ref) -> dict:
    """Kernel G-buffer vs reference. Pixels where coverage, material or
    depth (beyond DEPTH_ATOL) disagree count as edge mismatches, held to
    MISMATCH_MAX of the frame; color must agree to COLOR_ATOL elsewhere."""
    g = {k: np.asarray(v) for k, v in got.items()}
    r = {k: np.asarray(v) for k, v in ref.items()}
    both = g["covered"] & r["covered"]
    dz = np.abs(g["depth"] - r["depth"])
    depth_out = both & (dz > DEPTH_ATOL)
    mism = (g["covered"] != r["covered"]) | (both & (g["mat"] != r["mat"]))
    mism |= depth_out
    ok = both & ~mism
    col = np.abs(g["color"] - r["color"]).max(axis=-1)
    res = {
        "pixels": int(mism.size),
        "covered": int(r["covered"].sum()),
        "coverage_mismatch": int((g["covered"] != r["covered"]).sum()),
        "material_mismatch": int((both & (g["mat"] != r["mat"])).sum()),
        "depth_outliers": int(depth_out.sum()),
        "mismatch_share": float(mism.mean()),
        "max_depth_err": float(dz[ok].max()) if ok.any() else 0.0,
        "max_color_err": float(col[ok].max()) if ok.any() else 0.0,
    }
    check(res["covered"] > 0, "reference frame is empty")
    check(res["mismatch_share"] <= MISMATCH_MAX,
          f"edge mismatch share {res['mismatch_share']:.2e} > {MISMATCH_MAX}")
    check(res["max_color_err"] <= COLOR_ATOL,
          f"color error {res['max_color_err']:.2e} > {COLOR_ATOL}")
    return res


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------

def phase_device():
    dev = jax.devices()[0]
    check(jax.default_backend() == "gpu", f"backend {jax.default_backend()}")
    return {"kind": dev.device_kind, "count": len(jax.devices())}


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------

def phase_physics():
    import bench
    from scx import physics as ph
    from scx.physics import planar as pp
    from scx.physics.solver import step_bodies_cached
    from scx.physics.warmstart import empty_contact_cache

    params = ph.SolverParams(max_pairs=128, iterations=6, shape_kinds=("box",))
    rigid = jax.jit(bench.build_batch, static_argnums=(0, 1))(
        bench.ENVS, bench.BODIES
    )
    batch = jax.jit(jax.vmap(pp.planar_from_rigid))(rigid)

    def caches(n):
        return jax.tree.map(
            lambda x: jnp.broadcast_to(x, (n,) + x.shape),
            pp.empty_planar_cache(params.max_pairs),
        )

    step = jax.vmap(lambda s, c: pp.step_planar_cached(s, params, c))

    def rollout(length):
        def run(b, c):
            def body(carry, _):
                b, c, ovf = carry
                b, c, st = step(b, c)
                return (b, c, jnp.maximum(ovf, jnp.max(st["pair_overflow"]))), None

            return jax.lax.scan(body, (b, c, jnp.int32(0)), None, length=length)[0]

        return jax.jit(run)

    roll240 = rollout(240)
    t0 = time.perf_counter()
    roll240 = roll240.lower(batch, caches(bench.ENVS)).compile()
    compile_s = time.perf_counter() - t0
    (b240, _, ovf), _ = timed(roll240, batch, caches(bench.ENVS))
    (b240, _, ovf), run_s = timed(roll240, batch, caches(bench.ENVS))
    check(int(ovf) == 0, f"pair overflow {int(ovf)}")
    check(finite(b240), "non-finite state after 240 steps")

    # 8 envs, 1 step: planar vs the conventional core
    r8 = jax.tree.map(lambda x: x[:8], rigid)
    p8 = jax.tree.map(lambda x: x[:8], batch)
    conv_cache = jax.tree.map(
        lambda x: jnp.broadcast_to(x, (8,) + x.shape),
        empty_contact_cache(params.max_pairs),
    )
    conv, _, conv_st = jax.jit(
        jax.vmap(lambda b, c: step_bodies_cached(b, params, c))
    )(r8, conv_cache)
    plan, _, plan_st = jax.jit(step)(p8, caches(8))
    pos_p = np.stack([np.asarray(plan.pos.x), np.asarray(plan.pos.y),
                      np.asarray(plan.pos.z)], -1)
    quat_p = np.stack([np.asarray(plan.quat.w), np.asarray(plan.quat.x),
                       np.asarray(plan.quat.y), np.asarray(plan.quat.z)], -1)
    conv_pos_err = float(np.abs(pos_p - np.asarray(conv.pos)).max())
    conv_quat_err = float(np.abs(quat_p - np.asarray(conv.quat)).max())
    # box scenes: same contact counts; poses within the trajectory
    # parity tolerance of tests/test_physics_planar.py (2e-3)
    check(np.array_equal(np.asarray(conv_st["contacts"]),
                         np.asarray(plan_st["contacts"])),
          "contact counts differ from the conventional core")
    check(conv_pos_err <= 2e-3, f"pos vs conventional {conv_pos_err:.2e}")
    check(conv_quat_err <= 2e-3, f"quat vs conventional {conv_quat_err:.2e}")

    # 8 envs, 10 steps: GPU vs the identical step on the CPU
    roll10 = rollout(10)
    (g10, _, _) = roll10(p8, caches(8))
    cpu = jax.devices("cpu")[0]
    (c10, _, _) = roll10(jax.device_put(p8, cpu), jax.device_put(caches(8), cpu))
    cpu_err = max(
        float(np.abs(np.asarray(getattr(g10.pos, a))
                     - np.asarray(getattr(c10.pos, a))).max())
        for a in "xyz"
    )
    check(cpu_err <= 1e-4, f"pos vs CPU after 10 steps {cpu_err:.2e} m")
    return {
        "envs": bench.ENVS, "bodies": bench.BODIES, "steps": 240,
        "pair_overflow": int(ovf),
        "vs_conventional_1step": {"max_pos_err": conv_pos_err,
                                  "max_quat_err": conv_quat_err},
        "vs_cpu_10steps": {"max_pos_err_m": cpu_err},
        "compile_s": compile_s,
        "rollout_s": run_s,
        "env_steps_per_s": bench.ENVS * 240 / run_s,
    }


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------

def city_scene():
    """The bench_city_720p.py scene: dense city chunk, street-level camera,
    mip-mapped checker albedo, static bake."""
    from cityscene import build_city_mesh

    from scx import render as rd
    from scx.assets import textures as texmod
    from scx.render import pipeline as pipe
    from scx.render import staticbake as sb
    from scx.render.mesh import build_mesh_pool

    verts, tris = build_city_mesh(**CITY)
    pool = build_mesh_pool([(verts, tris)])
    params = rd.RasterParams(width=1280, height=720, max_tris=131072,
                             max_clusters_per_tile=256, min_area2=0.25,
                             interpret=jax.default_backend() == "cpu")
    draws = rd.DrawList(
        mesh_id=jnp.zeros((1,), jnp.int32),
        material_id=jnp.zeros((1,), jnp.int32),
        model=jnp.eye(4)[None], valid=jnp.ones((1,), bool),
    )
    vp = rd.camera_view_proj(
        jnp.asarray([7.0, 2.5, 4.0]), jnp.asarray([7.0, 2.0, -60.0]),
        jnp.asarray([0.0, 1.0, 0.0]), aspect=1280 / 720,
    )
    mats = pipe.Materials(texture_id=jnp.asarray([0], jnp.int32),
                          tint=jnp.ones((1, 3)))
    base = texmod.checker_texture(128, cells=16)
    tex = pipe.MipTextures(
        quads=jnp.asarray(texmod.build_mip_quads(base))[None], size=128
    )
    t_s = -(-len(tris) // 128) * 128
    baked = jax.jit(lambda d: sb.bake_draws(d, pool, t_s, morton=False))(draws)
    no_dyn = rd.DrawList(
        mesh_id=jnp.zeros((1,), jnp.int32),
        material_id=jnp.zeros((1,), jnp.int32),
        model=jnp.eye(4)[None], valid=jnp.zeros((1,), bool),
    )
    dyn_params = params.replace(max_tris=64, clip_extra=32)
    return dict(pool=pool, params=params, dyn_params=dyn_params, vp=vp,
                mats=mats, tex=tex, baked=baked, no_dyn=no_dyn,
                n_tris=len(tris))


def phase_city():
    from scx.ops import raster as ops
    from scx.render import pipeline as pipe

    c = city_scene()
    setup_fn = jax.jit(lambda vp: pipe.setup_frame_baked(
        c["baked"], c["no_dyn"], c["pool"], vp, c["params"], c["dyn_params"]
    ))
    setup, aabb, valid, frame = setup_fn(c["vp"])
    frame = c["params"].replace(max_tris=setup.shape[0])
    raster = jax.jit(lambda s, a, v: pipe._raster_and_shade(
        s, a, v, frame, c["mats"], c["tex"]))
    (rgb, got, stats), first_s = timed(raster, setup, aabb, valid)
    (rgb, got, stats), frame_s = timed(raster, setup, aabb, valid)
    check(rgb.shape == (720, 1280, 3) and finite(rgb), "bad frame")
    ref_fn = jax.jit(lambda s: ops.rasterize_reference(s, frame))
    ref, ref_first_s = timed(ref_fn, setup)
    ref, ref_s = timed(ref_fn, setup)
    res = compare_gbuffers(got, ref)
    res.update({
        "tris": c["n_tris"], "tris_in": int(stats["tris_in"]),
        # full cluster lists and compaction drops show up in the
        # comparison above; reported here for the reader
        "full_tiles": int(stats["tile_overflow"]),
        "cluster_drop": int(stats["cluster_drop"]),
        "raster_shade_first_s": first_s, "raster_shade_ms": frame_s * 1e3,
        "reference_ms": ref_s * 1e3,
    })
    return res


# ---------------------------------------------------------------------------
# phase 4
# ---------------------------------------------------------------------------

def rl_compare(env, n=4):
    """4 envs' G-buffers: the env's kernel path vs rasterize_reference."""
    from scx.ops import raster as ops
    from scx.render.pipeline import raster_gbuffer_batched

    sub = jax.tree.map(lambda x: x[:n], env.state)
    setup, aabb, valid = jax.jit(jax.vmap(env._render_one))(sub)
    got, _ = jax.jit(
        lambda s, a, v: raster_gbuffer_batched(s, a, v, env.raster)
    )(setup, aabb, valid)
    ref_fn = jax.jit(lambda s: ops.rasterize_reference(s, env.raster))
    per = []
    for i in range(n):
        ref = ref_fn(setup[i])
        per.append(compare_gbuffers(jax.tree.map(lambda x: x[i], got), ref))
    return {
        "mismatch_share_max": max(p["mismatch_share"] for p in per),
        "max_color_err": max(p["max_color_err"] for p in per),
        "covered_min": min(p["covered"] for p in per),
    }


def rl_run(env, length):
    actions = np.tile(np.asarray([0.6, 0.0, 0.05, 0.0], np.float32),
                      (env.n_envs, 1))
    (obs, rew), first_s = timed(lambda: env.rollout(actions, length=length))
    check(finite((obs, rew)), "non-finite observations or rewards")
    check(env.last_info["nan_rollbacks"] == 0,
          f"{env.last_info['nan_rollbacks']} NaN rollbacks")
    (obs, rew), run_s = timed(lambda: env.rollout(actions, length=length))
    check(finite((obs, rew)), "non-finite observations or rewards")
    return {"envs": env.n_envs, "steps": length, "first_call_s": first_s,
            "rollout_s": run_s, "env_steps_per_s": env.n_envs * length / run_s}


def phase_rl():
    from scx.app.rlenv import CityRLEnv

    t0 = time.perf_counter()
    env = CityRLEnv(**RL_BINNED)
    build_s = time.perf_counter() - t0
    check(not env.raster.use_clusters, "expected the triangle-binned path")
    tri = rl_run(env, 4)
    tri["build_s"] = build_s
    tri["vs_reference"] = rl_compare(env)
    del env

    env = CityRLEnv(**RL_CLUSTER, use_cluster_obs=True)
    check(env.raster.use_clusters, "expected the cluster path")
    clu = rl_run(env, 2)
    clu["vs_reference"] = rl_compare(env)
    return {"binned_4096": tri, "cluster_1024x512": clu}


# ---------------------------------------------------------------------------
# phase 5
# ---------------------------------------------------------------------------

def phase_engine():
    import __graft_entry__ as g
    from scx.app import Sandbox

    sb = Sandbox(capacity=SANDBOX_CAPACITY)
    try:
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            rgb, tel = sb.frame(player_input=(0.8, 0.0, 0.0, 0.0))
            rgb = np.asarray(rgb)
            times.append(time.perf_counter() - t0)
            time.sleep(0.05)  # let the streaming workers land sectors
        check(np.isfinite(rgb).all(), "non-finite sandbox frame")
        check(rgb.shape == (sb.raster.height, sb.raster.width, 3), "frame shape")
        entities, sectors = int(tel.entities), int(tel.active_sectors)
    finally:
        sb.shutdown()
    fn, args = g.entry()
    (state, erg), entry_s = timed(jax.jit(fn), *args)
    check(finite(erg) and finite(state.transform.pos), "non-finite entry step")
    return {"sandbox_frame_s": times, "entities": entities,
            "active_sectors": sectors, "entry_first_call_s": entry_s}


# ---------------------------------------------------------------------------
# --multi (four cards)
# ---------------------------------------------------------------------------

def _strip_scene(n_strips, width=16.0):
    """Side-by-side ground slabs with boxes, some straddling strip
    boundaries, one launched across a boundary (migration)."""
    from scx import physics as ph

    pos, size, btype, vel = [], [], [], []
    for k in range(n_strips):
        pos.append([k * width + width / 2, -0.55, 0.0])
        size.append([width / 2, 0.05, 8.0])
        btype.append(ph.rigid.BODY_STATIC)
        vel.append([0.0, 0.0, 0.0])
    for k in range(n_strips):
        for j, x_off in enumerate([4.0, 9.0, width - 0.6]):
            if k == n_strips - 1 and j == 2:
                continue
            pos.append([k * width + x_off, 0.5 + 1.2 * j, 0.4 * j - 0.4])
            size.append([0.5, 0.5, 0.5])
            btype.append(ph.rigid.BODY_DYNAMIC)
            vel.append([0.0, 0.0, 0.0])
    pos.append([width * (n_strips // 2) - 2.0, 2.0, 3.0])
    size.append([0.4, 0.4, 0.4])
    btype.append(ph.rigid.BODY_DYNAMIC)
    vel.append([6.0, 0.0, 0.0])
    bodies = ph.make_bodies(
        jnp.asarray(pos, jnp.float32), size=jnp.asarray(size, jnp.float32),
        body_type=jnp.asarray(btype, jnp.int32),
    ).replace(vel=jnp.asarray(vel, jnp.float32))
    n_local = 24
    x = np.asarray(bodies.pos[:, 0])
    out = jax.tree.map(
        lambda a: np.zeros((n_strips, n_local) + a.shape[1:], a.dtype), bodies
    )
    fill = [0] * n_strips
    for i in range(len(pos)):
        k = min(int(x[i] // width), n_strips - 1)
        for dst, src in zip(jax.tree.leaves(out), jax.tree.leaves(bodies)):
            dst[k, fill[k]] = np.asarray(src[i])
        fill[k] += 1
    return bodies, jax.tree.map(jnp.asarray, out), width


def _bigscene_check(n_strips):
    from scx import physics as ph
    from scx import render as rd
    from scx.parallel import bigscene as bg
    from scx.parallel.mesh import make_mesh
    from scx.physics.warmstart import empty_contact_cache

    mesh = make_mesh(dp=1, sp=n_strips)
    params = ph.SolverParams(max_pairs=128, iterations=6)
    raster = rd.RasterParams(width=256, height=128, tile_h=32, tile_w=128,
                             max_tris=1024, max_clusters_per_tile=8,
                             interpret=jax.default_backend() == "cpu")
    bodies, sharded, width = _strip_scene(n_strips)
    vp = rd.camera_view_proj(
        jnp.asarray([n_strips * width / 2, 18.0, 26.0]),
        jnp.asarray([n_strips * width / 2, 0.0, 0.0]),
        jnp.asarray([0.0, 1.0, 0.0]), aspect=2.0,
    )
    step = bg.make_bigscene_step(mesh, params, raster, x0=0.0,
                                 shard_width=width, halo=3.0, halo_cap=16,
                                 mig_cap=8)
    out = sharded
    for _ in range(3):
        out, rgb, stats = step(out, vp)
    check(int(stats["halo_dropped"]) == 0, "halo dropped")
    check(int(stats["migration_dropped"]) == 0, "migration dropped")
    cache = empty_contact_cache(params.max_pairs)
    ref = bodies
    for _ in range(3):
        ref, cache, _ = ph.step_bodies_cached(ref, params, cache)

    def rows(pos, act):
        r = np.asarray(pos).reshape(-1, 3)[np.asarray(act).reshape(-1)]
        return r[np.lexsort(r.T)]

    got, want = rows(out.pos, out.active), rows(ref.pos, ref.active)
    check(got.shape == want.shape, "body count changed")
    err = float(np.abs(got - want).max())
    check(err <= 2e-3, f"sp={n_strips} vs global solve {err:.2e}")
    return {"max_pos_err": err, "finite_frame": finite(rgb)}


def phase_multi():
    from scx import render as rd
    from scx.app.rlenv import CityRLEnv
    from scx.parallel.mesh import make_mesh
    from scx.render import pipeline as pipe

    check(len(jax.devices()) >= 4, f"{len(jax.devices())} devices, need 4")
    mesh = make_mesh(dp=2, sp=2)
    res = {}

    # rollout_sharded vs the single-card rollout of the same envs
    acts = np.tile(np.asarray([0.6, 0.0, 0.05, 0.0], np.float32),
                   (MULTI_ENVS, 1))
    ref = CityRLEnv(n_envs=MULTI_ENVS, capacity=160, obs_size=64)
    obs_r, rew_r = ref.rollout(acts, length=3)
    env = CityRLEnv(n_envs=MULTI_ENVS, capacity=160, obs_size=64)
    (obs_s, rew_s), stats = env.rollout_sharded(acts, length=3, mesh=mesh)
    res["rollout_sharded"] = {
        "obs_max_err": float(np.abs(np.asarray(obs_s) - np.asarray(obs_r)).max()),
        "reward_max_err": float(np.abs(np.asarray(rew_s) - np.asarray(rew_r)).max()),
        "pos_max_err": float(np.abs(np.asarray(env.state.transform.pos)
                                    - np.asarray(ref.state.transform.pos)).max()),
    }
    check(int(stats["alive"]) == int(jnp.sum(ref.state.alive)), "alive psum")
    check(res["rollout_sharded"]["obs_max_err"] <= 1e-5, "sharded obs differ")
    check(res["rollout_sharded"]["pos_max_err"] <= 1e-4, "sharded state differs")

    # bigscene: spatial physics strips vs the global solve
    res["bigscene_sp2"] = _bigscene_check(2)
    res["bigscene_sp4"] = _bigscene_check(4)

    # render_frame_rows strips over 'sp' vs the full frame
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    c = city_scene()
    params = c["params"].replace(height=768)
    setup_d = pipe.DrawList(mesh_id=jnp.zeros((1,), jnp.int32),
                            material_id=jnp.zeros((1,), jnp.int32),
                            model=jnp.eye(4)[None], valid=jnp.ones((1,), bool))
    full, _, _ = jax.jit(lambda d: pipe.render_frame(
        d, c["pool"], c["vp"], params, c["mats"], c["tex"]))(setup_d)
    rows_per = params.height // 2

    def local(d):
        row0 = jax.lax.axis_index("sp") * rows_per
        rgb, _, _ = pipe.render_frame_rows(d, c["pool"], c["vp"], params, row0,
                                           rows_per, c["mats"], c["tex"])
        return rgb

    strips = jax.jit(shard_map(local, mesh=mesh, in_specs=(P(),),
                               out_specs=P("sp", None, None),
                               check_vma=False))(setup_d)
    err = np.abs(np.asarray(strips) - np.asarray(full)).max(axis=-1)
    res["render_rows"] = {"pixels_over_1e-3": int((err > 1e-3).sum()),
                          "share": float((err > 1e-3).mean())}
    check(res["render_rows"]["share"] <= MISMATCH_MAX, "strips != full frame")

    # one sharded PPO train step
    import optax
    from train_ppo import ac_apply, actor_critic, net_init

    from scx.rl import PPOConfig, make_ppo_train_step

    ppo_env = CityRLEnv(n_envs=MULTI_ENVS, capacity=96, obs_size=32,
                        n_traffic=4)
    net = net_init(jax.random.PRNGKey(0), 32)
    opt = optax.adam(1e-3)
    train_step, place = make_ppo_train_step(
        ppo_env, actor_critic, ac_apply, 4, opt,
        PPOConfig(epochs=1, minibatches=2), mesh=mesh,
    )
    *_, metrics = train_step(net, opt.init(net), place(ppo_env.state),
                             place(ppo_env.cache), jax.random.PRNGKey(1))
    metrics = {k: float(v) for k, v in metrics.items()}
    check(all(np.isfinite(v) for v in metrics.values()), "PPO not finite")
    res["ppo_loss"] = metrics["loss"]
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card phase")
    ap.add_argument("--phases", default="device,physics,city,rl,engine",
                    help="comma-separated one-card phases to run")
    args = ap.parse_args()

    if jax.default_backend() != "gpu":
        print(f"chip_smoke: no GPU (JAX backend is {jax.default_backend()!r})",
              file=sys.stderr)
        return 2
    enable_compile_cache()
    name = card()
    if args.multi:
        phases = [("multi", phase_multi)]
    else:
        phases = [(p, globals()["phase_" + p]) for p in args.phases.split(",")]
    failed = []
    for phase, fn in phases:
        t0 = time.perf_counter()
        try:
            out = {"phase": phase, "ok": True, "card": name, **fn()}
        except Exception as e:  # reported, and the run exits nonzero
            traceback.print_exc()
            failed.append(phase)
            out = {"phase": phase, "ok": False, "card": name,
                   "error": f"{type(e).__name__}: {e}"[:2000]}
        out["phase_s"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    print(f"card: {name}")
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

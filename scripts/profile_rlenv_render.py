"""Stage-level profile of the RL observation RENDER path.

Companion to scripts/profile_rlenv.py (which attributes the physics/AI
stages): times the obs pipeline cull -> emit_draws -> setup_triangles ->
bin -> rasterize as NESTED PREFIXES of device-chained lax.scans, then
prints per-stage deltas. Every stage folds its output back into the
carried state so XLA cannot hoist loop-invariant work.

Usage:
  python scripts/profile_rlenv_render.py [--envs 1024] [--iters 20]
      [--capacity 160] [--obs 128] [--clusters]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from scx.core.cache import enable_compile_cache

enable_compile_cache()

import jax.numpy as jnp


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--envs", type=int, default=1024)
    ap.add_argument("--capacity", type=int, default=160)
    ap.add_argument("--traffic", type=int, default=8)
    ap.add_argument("--obs", type=int, default=128)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--clusters", action="store_true",
                    help="profile the cluster obs path instead of tri binning")
    ap.add_argument("--bake", action="store_true",
                    help="profile the static-bake path (stage prefixes match "
                         "_render_one_baked: static project -> cull -> "
                         "dyn emit+setup -> bin -> raster)")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from scx.app.rlenv import CityRLEnv
    from scx.render.pipeline import (
        bin_triangles_batched,
        raster_gbuffer_batched,
        setup_triangles,
    )
    from scx.world.culling import cull_entities, emit_draws

    E, N = args.envs, args.iters
    t0 = time.time()
    env = CityRLEnv(
        n_envs=E,
        capacity=args.capacity,
        obs_size=args.obs,
        n_traffic=args.traffic,
        use_cluster_obs=args.clusters,
        static_bake=args.bake,
        interpret=args.cpu,
    )
    print(f"built {E} envs in {time.time()-t0:.1f}s "
          f"(max_tris={env.raster.max_tris}, clusters={args.clusters}, "
          f"bake={args.bake})", flush=True)
    batch = env.state
    params = env.raster
    player = env.player

    def perturb(s, i):
        # nudge the player pose so the camera/cull/setup work differs
        # per iteration (nothing is loop-invariant)
        dp = jnp.float32(1e-4) * (i % 5 - 2)
        pos = s.transform.pos.at[:, player, 0].add(dp)
        return s.replace(transform=s.transform.replace(pos=pos))

    # the PRODUCTION camera — stage attribution must time the same path
    cam_vp = env._camera_vp

    # --- nested prefixes of the render path (each chained over N) ------
    def fold(s, acc):
        """Carry a scalar back into the state so the stage can't hoist."""
        return s.replace(body=s.body.replace(
            vel=s.body.vel.at[:, 0, 0].add(acc * 0.0)))

    def chain_cull(b):
        def body(s, i):
            s = perturb(s, i)
            def one(st):
                vp = cam_vp(st)
                visible, mats = cull_entities(st, vp)
                return jnp.sum(visible.astype(jnp.float32)) + jnp.sum(mats)
            return fold(s, jax.vmap(one)(s)), None
        return jax.lax.scan(body, b, jnp.arange(N))[0]

    def chain_emit(b):
        def body(s, i):
            s = perturb(s, i)
            def one(st):
                vp = cam_vp(st)
                visible, mats = cull_entities(st, vp)
                draws = emit_draws(st, visible, mats, env.draw_budget)
                return jnp.sum(draws.model) + jnp.sum(
                    draws.valid.astype(jnp.float32))
            return fold(s, jax.vmap(one)(s)), None
        return jax.lax.scan(body, b, jnp.arange(N))[0]

    def chain_setup(b):
        def body(s, i):
            s = perturb(s, i)
            def one(st):
                vp = cam_vp(st)
                visible, mats = cull_entities(st, vp)
                draws = emit_draws(st, visible, mats, env.draw_budget)
                setup, aabb, valid = setup_triangles(draws, env.pool, vp, params)
                return jnp.sum(setup[:, 28]) + jnp.sum(aabb)
            return fold(s, jax.vmap(one)(s)), None
        return jax.lax.scan(body, b, jnp.arange(N))[0]

    def render_setup(s):
        """Production per-env setup for the selected path."""
        if args.bake:
            return jax.vmap(env._render_one_baked)(s, env.baked)
        return jax.vmap(env._render_one)(s)

    def chain_bin(b):
        # tri path only: binning separate from the kernel
        bin_params = env._params_bin if args.bake else params
        def body(s, i):
            s = perturb(s, i)
            setup, aabb, valid = render_setup(s)
            binned, counts = bin_triangles_batched(
                setup, aabb, valid, bin_params)
            return fold(s, jnp.sum(counts.astype(jnp.float32), axis=(1,))), None
        return jax.lax.scan(body, b, jnp.arange(N))[0]

    def chain_full(b):
        raster_params = env._params_bin if args.bake else params
        def body(s, i):
            s = perturb(s, i)
            setup, aabb, valid = render_setup(s)
            g, _ = raster_gbuffer_batched(setup, aabb, valid, raster_params)
            return fold(s, jnp.sum(g["depth"], axis=(1, 2))), None
        return jax.lax.scan(body, b, jnp.arange(N))[0]

    def chain_obs(b):
        # the exact production call (includes the rgb/depth concat)
        def body(s, i):
            s = perturb(s, i)
            obs = env._render_obs_batched(s, env.baked if args.bake else None)
            return fold(s, jnp.sum(obs, axis=(1, 2, 3))), None
        return jax.lax.scan(body, b, jnp.arange(N))[0]

    if args.bake:
        # static-bake path prefixes, matching _render_one_baked stage order
        from scx.render import staticbake as sb

        def chain_sproj(b):
            def body(s, i):
                s = perturb(s, i)
                def one(st, bk):
                    vp = cam_vp(st)
                    st_setup, st_aabb, _ = sb.setup_static_from_bake(
                        bk, vp, env._params_static)
                    return jnp.sum(st_setup[:, 28]) + jnp.sum(st_aabb)
                return fold(s, jax.vmap(one)(s, env.baked)), None
            return jax.lax.scan(body, b, jnp.arange(N))[0]

        def chain_bcull(b):
            def body(s, i):
                s = perturb(s, i)
                def one(st, bk):
                    vp = cam_vp(st)
                    st_setup, st_aabb, _ = sb.setup_static_from_bake(
                        bk, vp, env._params_static)
                    visible, mats = cull_entities(st, vp)
                    dyn = visible & ~sb.static_entity_mask(st)
                    return (jnp.sum(st_setup[:, 28]) + jnp.sum(st_aabb)
                            + jnp.sum(dyn.astype(jnp.float32)) + jnp.sum(mats))
                return fold(s, jax.vmap(one)(s, env.baked)), None
            return jax.lax.scan(body, b, jnp.arange(N))[0]

        def chain_bsetup(b):
            def body(s, i):
                s = perturb(s, i)
                setup, aabb, valid = render_setup(s)
                return fold(
                    s, jnp.sum(setup[:, :, 28], axis=1) + jnp.sum(
                        aabb, axis=(1, 2))), None
            return jax.lax.scan(body, b, jnp.arange(N))[0]

        stages = [
            ("sproj", chain_sproj),
            ("+cull", chain_bcull),
            ("+setup", chain_bsetup),
        ]
    else:
        stages = [
            ("cull", chain_cull),
            ("+emit", chain_emit),
            ("+setup", chain_setup),
        ]
    if not args.clusters:
        stages.append(("+bin", chain_bin))
    stages += [("+raster", chain_full), ("obs_full", chain_obs)]

    def force(out):
        # HOST READ of a device-computed scalar: waits for the device
        leaf = jax.tree_util.tree_leaves(out)[0]
        return float(jnp.sum(jnp.asarray(leaf).astype(jnp.float32)))

    compiled = []
    for name, fn in stages:
        jfn = jax.jit(fn)
        t0 = time.time()
        force(jfn(batch))
        print(f"compiled {name} in {time.time()-t0:.1f}s", flush=True)
        compiled.append((name, jfn))

    results = {}
    for name, fn in compiled:
        t0 = time.time()
        force(fn(batch))  # timed region ends with a host read
        dt_ms = (time.time() - t0) / N * 1e3
        results[name] = dt_ms
        print(f"{name:>10}: {dt_ms:8.2f} ms/fleet-step "
              f"({dt_ms/E*1e3:7.2f} us/env-step)", flush=True)

    order = [n for n, _ in compiled]
    for prev, cur in zip(order, order[1:]):
        print(f"{('d '+cur):>10}: {results[cur]-results[prev]:8.2f} ms (delta)")


if __name__ == "__main__":
    main()

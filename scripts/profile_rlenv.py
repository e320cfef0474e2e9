"""Stage-level profile of the RL fleet step.

Times each stage of the CityRLEnv tick as a device-chained lax.scan.
All stages compile first, then measurement, so no compile lands inside a
timing.

Usage:
  python scripts/profile_rlenv.py [--envs 1024] [--iters 20] [--trace DIR]
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
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--trace", type=str, default=None,
                    help="capture a jax.profiler trace of the physics scan")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from scx.app.rlenv import CityRLEnv
    from scx.physics.world import physics_sync_step, bodies_from_state
    from scx.physics.broadphase import broadphase_pairs
    from scx.physics.contacts import generate_contacts
    from scx.physics.solver import solve_velocity
    from scx.traffic.ai import traffic_ai_update
    from scx.state import entity as ent

    E = args.envs
    N = args.iters
    t0 = time.time()
    env = CityRLEnv(n_envs=E, capacity=args.capacity, obs_size=128, n_traffic=args.traffic)
    print(f"built {E} envs in {time.time()-t0:.1f}s", flush=True)
    batch, cache = env.state, env.cache
    solver, vparams = env.sim.solver, env.sim.vehicle
    dt = env.cfg.physics.fixed_dt
    lanes = env.lanes
    tcfg = env.cfg.traffic

    def perturb(s, i):
        # per-iteration nudge so no work is loop-invariant
        return s.replace(
            body=s.body.replace(
                vel=s.body.vel + jnp.float32(1e-6) * (i % 3 - 1)
            )
        )

    # --- chained stage definitions (each: scan over N, carry = state) ----
    def chain_physics(b, c):
        def body(carry, i):
            s, cc = carry
            s = jax.vmap(perturb, in_axes=(0, None))(s, i)
            s, cc, _ = jax.vmap(
                lambda x, y: physics_sync_step(x, solver, vparams, dt, y)
            )(s, cc)
            return (s, cc), None
        (b, c), _ = jax.lax.scan(body, (b, c), jnp.arange(N))
        return b, c

    def chain_ai(b):
        def body(s, i):
            s = jax.vmap(perturb, in_axes=(0, None))(s, i)
            def one(st):
                bodies = bodies_from_state(st)
                is_veh = (st.components & ent.C_VEHICLE) != 0
                return traffic_ai_update(st, lanes, bodies, is_veh, tcfg, dt)
            return jax.vmap(one)(s), None
        return jax.lax.scan(body, b, jnp.arange(N))[0]

    def chain_broadphase(b):
        def body(s, i):
            s = jax.vmap(perturb, in_axes=(0, None))(s, i)
            def one(st):
                bodies = bodies_from_state(st)
                ia, ib, val, n_cand = broadphase_pairs(bodies, solver.max_pairs)
                return n_cand + ia[0] + ib[0] + jnp.sum(val)
            acc = jax.vmap(one)(s)
            # carry the reduction through vel so the scan can't hoist
            s = s.replace(body=s.body.replace(
                vel=s.body.vel + (acc.astype(jnp.float32) * 0.0)[:, None, None]))
            return s, None
        return jax.lax.scan(body, b, jnp.arange(N))[0]

    def chain_contacts(b):
        def body(s, i):
            s = jax.vmap(perturb, in_axes=(0, None))(s, i)
            def one(st):
                bodies = bodies_from_state(st)
                ia, ib, val, _ = broadphase_pairs(bodies, solver.max_pairs)
                con = generate_contacts(bodies, ia, ib, val)
                return jnp.sum(con.depth) + jnp.sum(con.valid)
            acc = jax.vmap(one)(s)
            s = s.replace(body=s.body.replace(
                vel=s.body.vel + (acc * 0.0)[:, None, None]))
            return s, None
        return jax.lax.scan(body, b, jnp.arange(N))[0]

    def chain_solve(b):
        def body(s, i):
            s = jax.vmap(perturb, in_axes=(0, None))(s, i)
            def one(st):
                bodies = bodies_from_state(st)
                ia, ib, val, _ = broadphase_pairs(bodies, solver.max_pairs)
                con = generate_contacts(bodies, ia, ib, val)
                vel, omega, lam, cnt = solve_velocity(bodies, con, solver)
                return jnp.sum(vel) + jnp.sum(omega) + jnp.sum(lam)
            acc = jax.vmap(one)(s)
            s = s.replace(body=s.body.replace(
                vel=s.body.vel + (acc * 0.0)[:, None, None]))
            return s, None
        return jax.lax.scan(body, b, jnp.arange(N))[0]

    from scx.physics.rigid import integrate_positions, integrate_velocities
    from scx.physics.warmstart import gather_warm_impulses, store_impulses
    from scx.physics.world import vehicle_prestep, write_back

    def chain_vehicle(b):
        def body(s, i):
            s = jax.vmap(perturb, in_axes=(0, None))(s, i)
            def one(st):
                bodies = bodies_from_state(st)
                st, bodies, _ = vehicle_prestep(st, bodies, dt)
                return write_back(st, bodies)
            return jax.vmap(one)(s), None
        return jax.lax.scan(body, b, jnp.arange(N))[0]

    def chain_sync(b):
        # the contact-free remainder: state->bodies view, integrate,
        # write back (attribution for the veh+integ+ws bucket)
        def body(s, i):
            s = jax.vmap(perturb, in_axes=(0, None))(s, i)
            def one(st):
                bodies = bodies_from_state(st)
                bodies = integrate_velocities(bodies, dt, solver.gravity)
                bodies = integrate_positions(bodies, dt)
                return write_back(st, bodies)
            return jax.vmap(one)(s), None
        return jax.lax.scan(body, b, jnp.arange(N))[0]

    from scx.physics.solver import step_bodies_cached

    def chain_sbc(b, c):
        # step_bodies_cached alone (integrate + bp + contacts + warm gather
        # + solve + sleep + store + integrate positions) — the solver core
        # without vehicle_prestep / write_back, to attribute the
        # composition delta between physics_full and the stage sums
        def body(carry, i):
            s, cc = carry
            s = jax.vmap(perturb, in_axes=(0, None))(s, i)
            def one(st, cache1):
                bodies = bodies_from_state(st)
                bodies, cache1, _ = step_bodies_cached(bodies, solver, cache1)
                from scx.physics.world import write_back as wb
                return wb(st, bodies), cache1
            s, cc = jax.vmap(one)(s, cc)
            return (s, cc), None
        (b, c), _ = jax.lax.scan(body, (b, c), jnp.arange(N))
        return b, c

    def chain_physics_v9(b, c):
        # physics_sync_step at the RL env's actual vehicle-slot count
        # (min(24, n_traffic+1)+agents ~= 9-10 vs the 32-slot default the
        # physics_full chain pays)
        mv = min(24, args.traffic + 1) + 1
        def body(carry, i):
            s, cc = carry
            s = jax.vmap(perturb, in_axes=(0, None))(s, i)
            s, cc, _ = jax.vmap(
                lambda x, y: physics_sync_step(x, solver, vparams, dt, y, mv)
            )(s, cc)
            return (s, cc), None
        (b, c), _ = jax.lax.scan(body, (b, c), jnp.arange(N))
        return b, c

    def chain_warmstart(b, c):
        def body(carry, i):
            s, cc = carry
            s = jax.vmap(perturb, in_axes=(0, None))(s, i)
            def one(st, cache1):
                bodies = bodies_from_state(st)
                ia, ib, val, _ = broadphase_pairs(bodies, solver.max_pairs)
                from scx.physics.contacts import generate_contacts as gc
                con = gc(bodies, ia, ib, val)
                lam0 = gather_warm_impulses(cache1, ia, ib, val, con.cand, bodies.n)
                cache1 = store_impulses(
                    cache1, ia, ib, val, con.cand, lam0, con.valid, bodies.n
                )
                return jnp.sum(lam0), cache1
            acc, cc = jax.vmap(one)(s, cc)
            s = s.replace(body=s.body.replace(
                vel=s.body.vel + (acc * 0.0)[:, None, None]))
            return (s, cc), None
        (b, c), _ = jax.lax.scan(body, (b, c), jnp.arange(N))
        return b, c

    # --- prefix chains INSIDE step_bodies_cached (attribute the gap
    # between sbc_core and the isolated part stages; each adds one more
    # internal stage, folding every output into the carried vel) ---------
    from scx.physics.rigid import integrate_velocities as integ_v

    def _sbc_prefix(depth):
        def chain(b, c):
            def body(carry, i):
                s, cc = carry
                s = jax.vmap(perturb, in_axes=(0, None))(s, i)
                def one(st, cache1):
                    bodies = bodies_from_state(st)
                    bodies = integ_v(bodies, dt, solver.gravity)
                    ia, ib, val, n_cand = broadphase_pairs(
                        bodies, solver.max_pairs)
                    acc = (n_cand + jnp.sum(val)).astype(jnp.float32)
                    if depth >= 2:
                        con = generate_contacts(bodies, ia, ib, val)
                        acc = acc + jnp.sum(con.depth) + jnp.sum(con.valid)
                    if depth >= 3:
                        lam0 = gather_warm_impulses(
                            cache1, ia, ib, val, con.cand, bodies.n)
                        acc = acc + jnp.sum(lam0)
                    if depth >= 4:
                        vel, omega, lam, cnt = solve_velocity(
                            bodies, con, solver, lam0)
                        acc = acc + jnp.sum(vel) + jnp.sum(omega) + jnp.sum(lam)
                    if depth >= 5:
                        cache1 = store_impulses(
                            cache1, ia, ib, val, con.cand, lam, con.valid,
                            bodies.n)
                        acc = acc + jnp.sum(cache1.lam)
                    return acc, cache1
                acc, cc = jax.vmap(one)(s, cc)
                s = s.replace(body=s.body.replace(
                    vel=s.body.vel + (acc * 0.0)[:, None, None]))
                return (s, cc), None
            (b, c), _ = jax.lax.scan(body, (b, c), jnp.arange(N))
            return b, c
        return chain

    stages = {
        "physics_full": jax.jit(chain_physics),
        "physics_v9": jax.jit(chain_physics_v9),
        "sbc_core": jax.jit(chain_sbc),
        "sbc_p1_bp": jax.jit(_sbc_prefix(1)),
        "sbc_p2_con": jax.jit(_sbc_prefix(2)),
        "sbc_p3_warm": jax.jit(_sbc_prefix(3)),
        "sbc_p4_solve": jax.jit(_sbc_prefix(4)),
        "sbc_p5_store": jax.jit(_sbc_prefix(5)),
        "ai": jax.jit(chain_ai),
        "broadphase": jax.jit(chain_broadphase),
        "bp+contacts": jax.jit(chain_contacts),
        "bp+con+solve": jax.jit(chain_solve),
        "vehicle": jax.jit(chain_vehicle),
        "integ_sync": jax.jit(chain_sync),
        "bp+con+warm": jax.jit(chain_warmstart),
    }

    def force(out):
        # HOST READ of a device-computed scalar: waits for the device
        leaf = jax.tree_util.tree_leaves(out)[0]
        return float(jnp.sum(jnp.asarray(leaf).astype(jnp.float32)))

    # compile everything first
    compiled = {}
    takes_cache = {
        "physics_full", "physics_v9", "sbc_core", "bp+con+warm",
        "sbc_p1_bp", "sbc_p2_con", "sbc_p3_warm", "sbc_p4_solve",
        "sbc_p5_store",
    }
    for name, fn in stages.items():
        t0 = time.time()
        if name in takes_cache:
            out = fn(batch, cache)
        else:
            out = fn(batch)
        force(out)
        compiled[name] = fn
        print(f"compiled {name} in {time.time()-t0:.1f}s", flush=True)

    results = {}
    for name, fn in compiled.items():
        t0 = time.time()
        if name in takes_cache:
            out = fn(batch, cache)
        else:
            out = fn(batch)
        force(out)  # timed region ends with a host read
        dt_ms = (time.time() - t0) / N * 1e3
        results[name] = dt_ms
        print(f"{name:>14}: {dt_ms:8.2f} ms/fleet-step "
              f"({dt_ms/E*1e3:7.2f} us/env-step)", flush=True)

    # derived deltas
    if all(k in results for k in ("broadphase", "bp+contacts", "bp+con+solve")):
        print(f"{'contacts':>14}: {results['bp+contacts']-results['broadphase']:8.2f} ms (delta)")
        print(f"{'solve':>14}: {results['bp+con+solve']-results['bp+contacts']:8.2f} ms (delta)")
        print(f"{'veh+integ+ws':>14}: {results['physics_full']-results['bp+con+solve']:8.2f} ms (delta)")
    if all(k in results for k in ("bp+contacts", "bp+con+warm")):
        print(f"{'warmstart':>14}: {results['bp+con+warm']-results['bp+contacts']:8.2f} ms (delta)")
    if all(k in results for k in ("physics_full", "sbc_core")):
        print(f"{'veh_composed':>14}: {results['physics_full']-results['sbc_core']:8.2f} ms (delta: full - solver core)")
    if all(k in results for k in ("physics_full", "physics_v9")):
        print(f"{'v32_tax':>14}: {results['physics_full']-results['physics_v9']:8.2f} ms (delta: 32 veh slots vs env's)")

    if args.trace:
        from scx.telemetry import trace as tr
        tr.start_trace(args.trace)
        jax.block_until_ready(compiled["physics_full"](batch, cache))
        tr.stop_trace()
        print("trace written to", args.trace, flush=True)


if __name__ == "__main__":
    main()

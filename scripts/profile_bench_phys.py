"""Stage attribution of the HEADLINE bench step (bench.py config #2:
1024 envs x 64 bodies, max_pairs=256, 6 warm iterations).

Attributes the conventional-layout step's time with prefix chains inside
step_bodies_cached, each timed as a device-chained lax.scan ending in a
HOST READ.

Usage: python scripts/profile_bench_phys.py [--envs 1024] [--iters 10] [--cpu]
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
    ap.add_argument("--bodies", type=int, default=64)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    import bench
    from scx import physics as ph
    from scx.physics.broadphase import broadphase_pairs
    from scx.physics.contacts import generate_contacts
    from scx.physics.solver import solve_velocity
    from scx.physics.rigid import integrate_positions, integrate_velocities
    from scx.physics.warmstart import (
        empty_contact_cache, gather_warm_impulses, store_impulses,
    )

    E, NB, N = args.envs, args.bodies, args.iters
    params = ph.SolverParams(max_pairs=256, iterations=6)

    t0 = time.time()
    batch = bench.build_batch(E, NB)
    one_cache = empty_contact_cache(params.max_pairs)
    cache = jax.tree.map(lambda x: jnp.broadcast_to(x, (E,) + x.shape), one_cache)
    print(f"built {E}x{NB} batch in {time.time()-t0:.1f}s", flush=True)

    def perturb(b, i):
        return b.replace(vel=b.vel + jnp.float32(1e-6) * (i % 3 - 1))

    def chain_full(b, c):
        def body(carry, i):
            s, cc = carry
            s = perturb(s, i)
            s, cc, _ = jax.vmap(
                lambda x, y: ph.step_bodies_cached(x, params, y)
            )(s, cc)
            return (s, cc), None
        (b, c), _ = jax.lax.scan(body, (b, c), jnp.arange(N))
        return b, c

    def chain_integrate(b):
        def body(s, i):
            s = perturb(s, i)
            def one(st):
                st = integrate_velocities(st, params.dt, params.gravity)
                return integrate_positions(st, params.dt)
            return jax.vmap(one)(s), None
        return jax.lax.scan(body, b, jnp.arange(N))[0]

    def _prefix(depth):
        def chain(b, c):
            def body(carry, i):
                s, cc = carry
                s = perturb(s, i)
                def one(st, cache1):
                    st = integrate_velocities(st, params.dt, params.gravity)
                    ia, ib, val, n_cand = broadphase_pairs(st, params.max_pairs)
                    acc = (n_cand + jnp.sum(val)).astype(jnp.float32)
                    if depth >= 2:
                        con = generate_contacts(st, ia, ib, val)
                        acc = acc + jnp.sum(con.depth) + jnp.sum(con.valid)
                    if depth >= 3:
                        lam0 = gather_warm_impulses(
                            cache1, ia, ib, val, con.cand, st.n)
                        acc = acc + jnp.sum(lam0)
                    if depth >= 4:
                        vel, omega, lam, cnt = solve_velocity(
                            st, con, params, lam0)
                        acc = acc + jnp.sum(vel) + jnp.sum(omega) + jnp.sum(lam)
                    if depth >= 5:
                        cache1 = store_impulses(
                            cache1, ia, ib, val, con.cand, lam, con.valid, st.n)
                        acc = acc + jnp.sum(cache1.lam)
                    return acc, cache1
                acc, cc = jax.vmap(one)(s, cc)
                s = s.replace(vel=s.vel + (acc * 0.0)[:, None, None])
                return (s, cc), None
            (b, c), _ = jax.lax.scan(body, (b, c), jnp.arange(N))
            return b, c
        return chain

    stages = {
        "full_step": (jax.jit(chain_full), True),
        "integrate": (jax.jit(chain_integrate), False),
        "p1_bp": (jax.jit(_prefix(1)), True),
        "p2_con": (jax.jit(_prefix(2)), True),
        "p3_warm": (jax.jit(_prefix(3)), True),
        "p4_solve": (jax.jit(_prefix(4)), True),
        "p5_store": (jax.jit(_prefix(5)), True),
    }

    def force(out):
        leaf = jax.tree_util.tree_leaves(out)[0]
        return float(jnp.sum(jnp.asarray(leaf).astype(jnp.float32)))

    for name, (fn, tc) in stages.items():
        t0 = time.time()
        out = fn(batch, cache) if tc else fn(batch)
        force(out)
        print(f"compiled {name} in {time.time()-t0:.1f}s", flush=True)

    results = {}
    for name, (fn, tc) in stages.items():
        t0 = time.time()
        out = fn(batch, cache) if tc else fn(batch)
        force(out)
        dt_ms = (time.time() - t0) / N * 1e3
        results[name] = dt_ms
        print(f"{name:>12}: {dt_ms:8.2f} ms/fleet-step "
              f"({E/dt_ms*1e3:10.0f} env-steps/s)", flush=True)

    order = ["p1_bp", "p2_con", "p3_warm", "p4_solve", "p5_store"]
    prev = 0.0
    for k in order:
        if k in results:
            print(f"{'d '+k:>12}: {results[k]-prev:8.2f} ms (delta)")
            prev = results[k]


if __name__ == "__main__":
    main()

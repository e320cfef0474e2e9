"""A/B the planar physics fleet step vs the conventional layout at the
headline bench config (1024 envs x 64 bodies, max_pairs 256, 6 warm
iterations). Device-chained scans, each ending in a host read.

Usage: python scripts/profile_planar.py [--envs 1024] [--iters 20]
       [--skip-conv] [--pairs 256] [--cpu]
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
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--pairs", type=int, default=256)
    ap.add_argument("--skip-conv", action="store_true")
    ap.add_argument("--stages", action="store_true",
                    help="profile planar stage prefixes too")
    ap.add_argument("--box-kinds", action="store_true",
                    help="SolverParams(shape_kinds=('box',)) specialization")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    import bench
    from scx import physics as ph
    from scx.physics import planar as pp
    from scx.physics.warmstart import empty_contact_cache

    E, NB, N = args.envs, args.bodies, args.iters
    params = ph.SolverParams(
        max_pairs=args.pairs, iterations=6,
        shape_kinds=("box",) if args.box_kinds else ("box", "sphere", "capsule"),
    )

    t0 = time.time()
    batch = bench.build_batch(E, NB)
    pbatch = jax.vmap(pp.planar_from_rigid)(batch)
    caches = jax.tree.map(
        lambda x: jnp.broadcast_to(x, (E,) + x.shape),
        empty_contact_cache(params.max_pairs),
    )
    pcaches = jax.tree.map(
        lambda x: jnp.broadcast_to(x, (E,) + x.shape),
        pp.empty_planar_cache(params.max_pairs),
    )
    print(f"built {E}x{NB} batch in {time.time()-t0:.1f}s", flush=True)

    @jax.jit
    def chain_planar(b, c):
        def body(carry, _):
            s, cc = carry
            s, cc, _ = jax.vmap(
                lambda x, y: pp.step_planar_cached(x, params, y)
            )(s, cc)
            return (s, cc), None
        return jax.lax.scan(body, (b, c), None, length=N)[0]

    @jax.jit
    def chain_conv(b, c):
        def body(carry, _):
            s, cc = carry
            s, cc, _ = jax.vmap(
                lambda x, y: ph.step_bodies_cached(x, params, y)
            )(s, cc)
            return (s, cc), None
        return jax.lax.scan(body, (b, c), None, length=N)[0]

    def force_planar(out):
        return float(jnp.sum(out[0].pos.y))

    def force_conv(out):
        return float(jnp.sum(out[0].pos[..., 1]))

    # --- planar stage prefixes. HOIST-PROOF: every prefix integrates
    # positions too, so the scene keeps evolving and XLA cannot lift the
    # pos-dependent stages out of the scan (the trap that made the
    # conventional profiler's stage sums 4x under the full step) ---------
    def _prefix(depth):
        def one(s, cc):
            s = pp.planar_integrate_velocities(s, params.dt, params.gravity)
            ia, ib_, val, n_cand = pp.planar_broadphase(s, params.max_pairs)
            acc = (n_cand + jnp.sum(val)).astype(jnp.float32)
            if depth >= 2:
                con = pp.planar_contacts(s, ia, ib_, val, params.shape_kinds)
                acc = acc + jnp.sum(con.depth) + jnp.sum(con.valid)
            if depth >= 3:
                lam0 = pp.planar_gather_warm(cc, ia, ib_, val, con.cand)
                acc = acc + sum(jnp.sum(l) for l in lam0)
            if depth >= 4:
                vel, om, (ln, l1, l2), cnt = pp.planar_solve(
                    s, con, params, ia, ib_, lam0)
                s = s.replace(vel=vel, omega=om)
                acc = acc + jnp.sum(cnt)
            if depth >= 5:
                cc = pp.planar_store(cc, ia, ib_, val, con, ln, l1, l2)
                acc = acc + jnp.sum(cc.lam_n)
            s = s.replace(vel=s.vel * (1.0 + acc * 0.0))
            return pp.planar_integrate_positions(s, params.dt), cc

        def chain(b, c):
            def body(carry, _):
                s, cc = carry
                return jax.vmap(one)(s, cc), None
            return jax.lax.scan(body, (b, c), None, length=N)[0]
        return jax.jit(chain)

    runs = [("planar", chain_planar, (pbatch, pcaches), force_planar)]
    if args.stages:
        for d, nm in ((1, "p1_bp"), (2, "p2_con"), (3, "p3_warm"),
                      (4, "p4_solve"), (5, "p5_store")):
            runs.append((nm, _prefix(d), (pbatch, pcaches), force_planar))
    if not args.skip_conv:
        runs.append(("conv", chain_conv, (batch, caches), force_conv))

    compiled = {}
    for name, fn, arg, force in runs:
        t0 = time.time()
        out = fn(*arg)
        force(out)
        compiled[name] = (fn, out, force)
        print(f"compiled+first {name} in {time.time()-t0:.1f}s", flush=True)

    for name, (fn, warm, force) in compiled.items():
        t0 = time.time()
        out = fn(*warm)
        force(out)
        dt_ms = (time.time() - t0) / N * 1e3
        print(
            f"{name:>8}: {dt_ms:8.3f} ms/fleet-step "
            f"({E/dt_ms*1e3:12.0f} env-steps/s)",
            flush=True,
        )


if __name__ == "__main__":
    main()

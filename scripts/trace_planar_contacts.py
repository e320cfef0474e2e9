"""Capture a device trace of the planar narrowphase chain at 1024x64 and
print the top ops by self time.

Usage: python scripts/trace_planar_contacts.py [--envs 1024] [--out DIR]
"""

import argparse
import glob
import gzip
import json
import os
import sys
import time
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from scx.core.cache import enable_compile_cache

enable_compile_cache()

import jax.numpy as jnp


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--envs", type=int, default=1024)
    ap.add_argument("--bodies", type=int, default=64)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--pairs", type=int, default=256)
    ap.add_argument("--out", type=str, default="/tmp/planar_trace")
    ap.add_argument("--box-kinds", action="store_true")
    ap.add_argument("--stage", type=str, default="contacts",
                    choices=["contacts", "solve", "full", "step"])
    args = ap.parse_args()

    import bench
    from scx import physics as ph
    from scx.physics import planar as pp

    E, NB, N = args.envs, args.bodies, args.iters
    params = ph.SolverParams(
        max_pairs=args.pairs, iterations=6,
        shape_kinds=("box",) if args.box_kinds else ("box", "sphere", "capsule"),
    )
    batch = bench.build_batch(E, NB)
    pb = jax.vmap(pp.planar_from_rigid)(batch)
    pc = jax.tree.map(
        lambda x: jnp.broadcast_to(x, (E,) + x.shape),
        pp.empty_planar_cache(params.max_pairs),
    )

    def one(s, cc):
        if args.stage == "step":
            s, cc, st = pp.step_planar_cached(s, params, cc)
            acc = jnp.sum(st["contacts"]).astype(jnp.float32)
            return s.replace(vel=s.vel * (1.0 + acc * 0.0)), cc
        s = pp.planar_integrate_velocities(s, params.dt, params.gravity)
        ia, ib_, val, n_cand = pp.planar_broadphase(s, params.max_pairs)
        acc = (n_cand + jnp.sum(val)).astype(jnp.float32)
        if args.stage in ("contacts", "solve", "full"):
            con = pp.planar_contacts(s, ia, ib_, val, params.shape_kinds)
            acc = acc + jnp.sum(con.depth) + jnp.sum(con.valid)
        if args.stage in ("solve", "full"):
            lam0 = pp.planar_gather_warm(cc, ia, ib_, val, con.cand)
            vel, om, (ln, l1, l2), cnt = pp.planar_solve(
                s, con, params, ia, ib_, lam0)
            s = s.replace(vel=vel, omega=om)
            acc = acc + jnp.sum(cnt)
        if args.stage == "full":
            cc = pp.planar_store(cc, ia, ib_, val, con, ln, l1, l2)
        s = s.replace(vel=s.vel * (1.0 + acc * 0.0))
        return pp.planar_integrate_positions(s, params.dt), cc

    @jax.jit
    def chain(b, c):
        def body(carry, _):
            s, cc = carry
            return jax.vmap(one)(s, cc), None
        return jax.lax.scan(body, (b, c), None, length=N)[0]

    t0 = time.time()
    out = chain(pb, pc)
    print("compiled in", round(time.time() - t0, 1), flush=True)
    print("warm", float(jnp.sum(out[0].pos.y)), flush=True)

    t0 = time.time()
    out = chain(pb, pc)
    print("quiet run", float(jnp.sum(out[0].pos.y)),
          round((time.time() - t0) / N * 1e3, 2), "ms/step", flush=True)

    jax.profiler.start_trace(args.out)
    out = chain(pb, pc)
    float(jnp.sum(out[0].pos.y))
    jax.profiler.stop_trace()

    # parse the trace: sum durations per hlo op name on the device track
    files = sorted(glob.glob(
        os.path.join(args.out, "**", "*.trace.json.gz"), recursive=True))
    if not files:
        print("no trace files under", args.out)
        return
    with gzip.open(files[-1], "rt") as f:
        tr = json.load(f)
    events = tr.get("traceEvents", [])
    # find device pids (track names naming a device)
    pid_names = {}
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            pid_names[e["pid"]] = e["args"].get("name", "")
    dev_pids = {p for p, n in pid_names.items()
                if "/device" in n.lower() or "gpu" in n.lower()}
    tot = defaultdict(float)
    cnt = defaultdict(int)
    for e in events:
        if e.get("ph") == "X" and e.get("pid") in dev_pids:
            nm = e.get("name", "?")
            tot[nm] += e.get("dur", 0.0)
            cnt[nm] += 1
    rows = sorted(tot.items(), key=lambda kv: -kv[1])[:40]
    gtot = sum(tot.values())
    print(f"device pids: {sorted(dev_pids)} total {gtot/1e3:.1f} ms")
    for nm, d in rows:
        print(f"{d/1e3:9.2f} ms  x{cnt[nm]:<5d} {nm[:110]}")


if __name__ == "__main__":
    main()

"""Micro-A/B of per-pair body-row gather formulations at bench scale
(E=1024, N=64, P=128, W=14): the planar narrowphase's two row gathers
are HIGHEST-precision one-hot matmuls; this compares them with the
other forms.

Forms:
  onehot14 — current: [14, N] @ [N, P] batched, precision HIGHEST
  onehot_pad — rows padded to [128, N]
  rowgather — vmapped rows[ia] (batched row gather)
  onehot_hi — [14, N] @ [N, P] with precision HIGH

Chained scans with per-iteration index perturbation, host-read verified.
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
import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--envs", type=int, default=1024)
    ap.add_argument("--bodies", type=int, default=64)
    ap.add_argument("--pairs", type=int, default=128)
    ap.add_argument("--width", type=int, default=14)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    E, N, P, W, it = args.envs, args.bodies, args.pairs, args.width, args.iters
    rng = np.random.default_rng(0)
    rows = jnp.asarray(rng.standard_normal((E, W, N)), jnp.float32)
    ia = jnp.asarray(rng.integers(0, N, (E, P)), jnp.int32)

    HI = jax.lax.Precision.HIGH
    HIGHEST = jax.lax.Precision.HIGHEST

    def onehot(idx):
        return (
            jnp.arange(N, dtype=jnp.int32)[:, None] == idx[None, :]
        ).astype(jnp.float32)

    def f_onehot14(rows, ia):
        def one(r, i):
            return jnp.matmul(r, onehot(i), precision=HIGHEST)  # [W, P]
        return jax.vmap(one)(rows, ia)

    def f_onehot_pad(rows, ia):
        padded = jnp.concatenate(
            [rows, jnp.zeros((E, 128 - W, N), jnp.float32)], axis=1
        )
        def one(r, i):
            return jnp.matmul(r, onehot(i), precision=HIGHEST)
        return jax.vmap(one)(padded, ia)[:, :W]

    def f_onehot_hi(rows, ia):
        def one(r, i):
            return jnp.matmul(r, onehot(i), precision=HI)
        return jax.vmap(one)(rows, ia)

    def f_rowgather(rows, ia):
        rows_nw = jnp.swapaxes(rows, 1, 2)  # [E, N, W]
        def one(r, i):
            return r[i]  # [P, W]
        return jnp.swapaxes(jax.vmap(one)(rows_nw, ia), 1, 2)

    forms = {
        "onehot14": f_onehot14,
        "onehot_pad": f_onehot_pad,
        "onehot_hi": f_onehot_hi,
        "rowgather": f_rowgather,
    }

    # correctness vs direct indexing
    want = jax.vmap(lambda r, i: jnp.swapaxes(r, 0, 1)[i].T)(rows, ia)
    for name, f in forms.items():
        got = jax.jit(f)(rows, ia)
        err = float(jnp.max(jnp.abs(got - want)))
        print(f"{name}: max err {err:.2e}", flush=True)

    def chain(f):
        @jax.jit
        def run(rows, ia):
            def body(carry, k):
                r, i = carry
                i2 = (i + k) % N
                out = f(r, i2)
                # fold output back so nothing hoists
                r = r + 1e-12 * jnp.pad(
                    out[:, :, :1], ((0, 0), (0, r.shape[1] - out.shape[1]), (0, 0))
                ) * 0.0 + 1e-20 * jnp.sum(out)
                return (r, i), None
            (r, _), _ = jax.lax.scan(body, (rows, ia), jnp.arange(it, dtype=jnp.int32))
            return r
        return run

    compiled = {}
    for name, f in forms.items():
        t0 = time.time()
        out = chain(f)(rows, ia)
        float(jnp.sum(out))
        compiled[name] = chain(f)
        print(f"compiled {name} in {time.time()-t0:.1f}s", flush=True)

    for name, f in compiled.items():
        t0 = time.time()
        out = f(rows, ia)
        float(jnp.sum(out))
        dt = (time.time() - t0) / it * 1e3
        print(f"{name:>11}: {dt:7.3f} ms/gather", flush=True)


if __name__ == "__main__":
    main()

"""Cost-model microbenchmarks: the measured constants PERF.md builds on.

Measures, on the current backend, the primitive rates several scx design
choices rest on:

  * gather rows/s   — packed-row gathers ([T, W] rows by random index)
  * scatter rows/s  — row scatter-adds (the .at[idx].add pattern)
  * one-hot matmul  — the solver's gather/scatter replacement
  * top_k / argsort — the compaction primitives
  * elementwise     — fused column math (the "free" baseline)

Method: each op is timed as a device-chained
`lax.scan` with a per-iteration data perturbation (so XLA can't hoist it),
in ONE jit per op. Prints one BENCH_JSON line per op plus a summary line;
runs in ~2-4 min warm. Shapes default to the RL-fleet scale the design
rules were derived at; env overrides: ROWS, WIDTH, ITERS.
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


def _chain(op, state, iters):
    """Device-chained timing: scan `op` with a cheap perturbation feeding
    iteration i+1 from iteration i's result (nothing hoistable)."""

    def body(carry, _):
        return op(carry), None

    fn = jax.jit(lambda s: jax.lax.scan(body, s, None, length=iters)[0])
    out = fn(state)  # compile + warm
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    out = fn(state)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def main():
    fast = os.environ.get("SCX_BENCH_FAST", "0") == "1"
    rows = int(os.environ.get("ROWS", "262144"))  # 256k indices
    width = int(os.environ.get("WIDTH", "8"))  # packed row width
    n = int(os.environ.get("N", "524288"))  # table rows
    iters = int(os.environ.get("ITERS", "20" if fast else "50"))

    key = jax.random.PRNGKey(0)
    table = jax.random.normal(key, (n, width), jnp.float32)
    idx0 = jax.random.randint(key, (rows,), 0, n, jnp.int32)

    results = {}

    def emit(metric, value, unit, **extra):
        results[metric] = value
        print(
            "BENCH_JSON "
            + json.dumps(
                {"metric": metric, "value": round(value, 3), "unit": unit, **extra}
            ),
            flush=True,
        )

    # --- gather rows/s: out[i] = table[idx[i]] ----------------------------
    def g_op(carry):
        idx, acc = carry
        got = table[idx]  # [rows, width] row gather
        # perturb: derive next indices from the gathered data (dependency)
        idx = (idx + got[:, 0].astype(jnp.int32) % 7 + 1) % n
        return idx, acc + got[0, 0]

    dt = _chain(g_op, (idx0, jnp.float32(0)), iters)
    emit("gather_rows_per_sec", rows / dt, "rows/s", rows=rows, width=width)

    # --- scatter-add rows/s: acc.at[idx].add(rows) ------------------------
    vals = jax.random.normal(key, (rows, width), jnp.float32)

    def s_op(carry):
        idx, acc = carry
        acc = acc.at[idx].add(vals, mode="drop")
        idx = (idx + 13) % n
        return idx, acc

    dt = _chain(s_op, (idx0, jnp.zeros((n, width), jnp.float32)), iters)
    emit("scatter_rows_per_sec", rows / dt, "rows/s", rows=rows, width=width)

    # --- one-hot matmul (solver's scatter replacement): [C,N]@[N,6] -------
    # measured at BOTH precisions: the solver runs Precision.HIGHEST
    # (the default f32 matmul may run in reduced precision, too coarse
    # for contact impulses), so the HIGHEST number is the one its cost
    # model uses; the default-precision rate shows the headroom.
    c, nb = 1024, 256
    onehot = (
        (jax.random.randint(key, (c,), 0, nb)[:, None] == jnp.arange(nb)[None, :])
        .astype(jnp.float32)
    )
    vw0 = jax.random.normal(key, (nb, 6), jnp.float32)

    for prec_name, prec in (
        ("highest", jax.lax.Precision.HIGHEST),
        ("default", None),
    ):
        def m_op(vw, _p=prec):
            g = jnp.matmul(onehot, vw, precision=_p)  # gather-equivalent
            return vw + 1e-6 * jnp.matmul(onehot.T, g, precision=_p)

        dt = _chain(m_op, vw0, iters * 4)
        emit(
            f"onehot_mm_pair_per_sec_{prec_name}",
            1.0 / dt,
            "solves/s",
            c=c,
            n=nb,
        )

    # --- top_k over a big column (compaction primitive) -------------------
    col0 = jax.random.normal(key, (n,), jnp.float32)

    def t_op(col):
        v, _ = jax.lax.top_k(col, 256)
        return col * 0.9999 + v[0] * 1e-9

    dt = _chain(t_op, col0, iters)
    emit("topk256_per_sec", 1.0 / dt, "ops/s", n=n)

    # --- argsort over the same column (the hostile baseline) --------------
    def a_op(col):
        order = jnp.argsort(col)
        return col * 0.9999 + order[0].astype(jnp.float32) * 1e-9

    dt = _chain(a_op, col0, max(4, iters // 4))
    emit("argsort_per_sec", 1.0 / dt, "ops/s", n=n)

    # --- fused elementwise pass over [n, width] (VPU baseline) ------------
    def e_op(x):
        return x * 1.0001 + jnp.sin(x) * 1e-3

    dt = _chain(e_op, table, iters * 4)
    emit(
        "elementwise_gbytes_per_sec",
        table.size * 4 * 2 / dt / 1e9,
        "GB/s",
        n=n,
        width=width,
    )

    print(
        "BENCH_JSON "
        + json.dumps(
            {
                "metric": "microops_summary",
                "value": round(results.get("gather_rows_per_sec", 0) / 1e6, 1),
                "unit": "Mrows/s gather",
                "backend": jax.default_backend(),
            }
        ),
        flush=True,
    )


if __name__ == "__main__":
    main()

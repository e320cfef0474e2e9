#!/usr/bin/env python
"""Headline benchmark: batched physics env-steps/sec on one GPU.

BASELINE config #2: 1024 parallel scenes x 64 rigid bodies each (1 static
ground slab + 63 dynamic boxes), AABB broadphase + impulse solver, no
rendering.

Prints the primary JSON line {"metric", "value", "unit", "vs_baseline"}
IMMEDIATELY after the primary measurement (the driver must always capture
it, even if secondaries run long), then runs the secondary benchmarks
under one strict total wall budget and prints each as a separate
'BENCH_JSON {...}' line.

Process layout: the parent process never initializes a JAX backend.
The primary measurement and each secondary run in a child process of
their own, so each child is the only process on the card (a JAX process
reserves most of the card's memory when it starts), and a hung child is
killed with its whole process group.
"""

import json
import os
import time

import jax

from scx.core.cache import enable_compile_cache

enable_compile_cache()

ENVS = 1024
BODIES = 64
STEPS_PER_CALL = 240
MEASURE_CALLS = 5
ROUNDS = 5  # best-of
TARGET = 1_000_000.0

# Secondaries: hard budgets, so they can never starve the primary line.
SECONDARY_TOTAL_BUDGET_S = 1800.0  # wall for ALL secondaries
SECONDARY_SCRIPT_TIMEOUT_S = 700.0  # per-script cap

PRIMARY_TOTAL_BUDGET_S = 1200.0
PRIMARY_ATTEMPT_TIMEOUT_S = 600.0


def _run_bounded(cmd, timeout_s: float, env=None, cwd=None):
    """subprocess.run with a timeout that actually terminates: the child
    gets its own session and the WHOLE process group is SIGKILLed on
    timeout, so helper processes can't keep the pipes (and our wait) alive.
    Returns (returncode, stdout, stderr); rc -9 on timeout."""
    import signal
    import subprocess

    proc = subprocess.Popen(
        cmd,
        stdout=subprocess.PIPE,
        stderr=subprocess.PIPE,
        text=True,
        env=env,
        cwd=cwd,
        start_new_session=True,
    )
    try:
        out, err = proc.communicate(timeout=timeout_s)
        return proc.returncode, out or "", err or ""
    except subprocess.TimeoutExpired:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except Exception:
            proc.kill()
        out, err = proc.communicate()
        return -9, out or "", err or ""


def build_batch(envs: int, n: int):
    """Hash-seeded box piles, one per env (mirrors the reference's
    deterministic sector-prop generation pattern) -> RigidBodies [E, n]."""
    import jax.numpy as jnp

    from scx import physics as ph
    from scx.core import prng

    def one_env(env_idx):
        seed = prng.jhash_coord_seed(1337, env_idx, 0)

        def body_pos(i):
            s0 = prng.jmix32(seed + jnp.uint32(i) * jnp.uint32(0x9E3779B9))
            s1, rx = prng.jrand01(s0)
            s2, ry = prng.jrand01(s1)
            _, rz = prng.jrand01(s2)
            return jnp.stack(
                [
                    (rx - 0.5) * 16.0,
                    0.6 + ry * 6.0,
                    (rz - 0.5) * 16.0,
                ]
            )

        pos = jax.vmap(body_pos)(jnp.arange(n, dtype=jnp.uint32))
        pos = pos.at[0].set(jnp.asarray([0.0, -0.55, 0.0]))
        size = jnp.full((n, 3), 0.5).at[0].set(jnp.asarray([16.0, 0.05, 16.0]))
        body_type = (
            jnp.full((n,), ph.rigid.BODY_DYNAMIC, jnp.int32)
            .at[0]
            .set(ph.rigid.BODY_STATIC)
        )
        return ph.make_bodies(pos, size=size, body_type=body_type)

    return jax.vmap(one_env)(jnp.arange(envs, dtype=jnp.int32))


def _zero_line(error: str) -> str:
    """An honest parseable primary line when no measurement was possible."""
    return json.dumps(
        {
            "metric": "physics_env_steps_per_sec",
            "value": 0.0,
            "unit": "env_steps/s",
            "vs_baseline": 0.0,
            "error": error,
        }
    )


def _run_primary():
    """CHILD process body: measure the primary metric, print ONE JSON line.

    Refuses any platform but the GPU: a number from another device is not
    this metric. Every timed region ends in a host read of a
    device-computed scalar, which waits for the whole chained launch.

    Physics path: the plane-layout fleet step (scx.physics.planar), whose
    equivalence with the conventional core is pinned by
    tests/test_physics_planar.py.
    """
    import jax.numpy as jnp

    from scx import physics as ph
    from scx.physics import planar as pp

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(_zero_line(f"no GPU: JAX platform is {dev.platform!r}"),
              flush=True)
        return

    # production solver settings: 6 warm-started iterations (== cold-8
    # quality; see tests/test_physics_solver.py tower test). max_pairs is
    # right-sized to the scene: 64-body piles peak at 95 overlapping pairs
    # over 300 settling steps, and the run asserts pair_overflow == 0 on
    # every step. shape_kinds=("box",): the pile scenes are box-only
    # (1 slab + 63 boxes) — the narrowphase drops its capsule/sphere
    # generators
    params = ph.SolverParams(
        max_pairs=128, iterations=6, shape_kinds=("box",)
    )

    def make_rollout(length):
        def rollout(batch, caches, ovf_in):
            # ovf_in/ovf_out: running max of pair_overflow across EVERY
            # step of every chained call (pair count peaks mid-settling,
            # not at step 1 — a capacity drift must zero-line the bench,
            # not silently drop contacts)
            def step(carry, _):
                b, c, ovf = carry
                b, c, stats = jax.vmap(
                    lambda s, sc: pp.step_planar_cached(s, params, sc)
                )(b, c)
                ovf = jnp.maximum(ovf, jnp.max(stats["pair_overflow"]))
                return (b, c, ovf), None

            (out, caches, ovf_out), _ = jax.lax.scan(
                step, (batch, caches, ovf_in), None, length=length
            )
            return out, caches, ovf_out

        return jax.jit(rollout, donate_argnums=(0, 1))

    def force(out):
        """Host-read a device-computed scalar: waits for every chained
        launch that produced `out`."""
        return float(jnp.sum(out.pos.y))

    batch = jax.jit(jax.vmap(pp.planar_from_rigid))(build_batch(ENVS, BODIES))
    caches = jax.tree.map(
        lambda x: jnp.broadcast_to(x, (ENVS,) + x.shape),
        pp.empty_planar_cache(params.max_pairs),
    )

    ovf_acc = jnp.int32(0)
    roll_c = make_rollout(STEPS_PER_CALL).lower(batch, caches, ovf_acc).compile()
    batch, caches, ovf_acc = roll_c(batch, caches, ovf_acc)
    force(batch)  # warm-up launch outside the timing

    best_dt = float("inf")
    for _ in range(ROUNDS):
        t0 = time.perf_counter()
        for _ in range(MEASURE_CALLS):
            batch, caches, ovf_acc = roll_c(batch, caches, ovf_acc)
        force(batch)  # serial dependency: completes every chained call
        best_dt = min(best_dt, time.perf_counter() - t0)

    # max pair_overflow across EVERY step of the whole run (host read)
    total_ovf = int(ovf_acc)
    if total_ovf > 0:
        print(_zero_line(
            f"pair capacity overflow mid-rollout (max {total_ovf})"
        ), flush=True)
        return

    env_steps = ENVS * STEPS_PER_CALL * MEASURE_CALLS
    rate = env_steps / best_dt
    result = {
        "metric": "physics_env_steps_per_sec",
        "value": round(rate, 1),
        "unit": "env_steps/s",
        "vs_baseline": round(rate / TARGET, 3),
        "steps_per_call": STEPS_PER_CALL,
        "device": {
            "platform": dev.platform,
            "kind": dev.device_kind,
            "count": len(jax.devices()),
        },
    }
    print(json.dumps(result), flush=True)


def _primary_via_child() -> str:
    """PARENT: run the primary measurement in bounded child attempts and
    return the primary JSON line to print. The parent never initializes a
    backend, so the child is the only process on the card."""
    import sys

    deadline = time.monotonic() + PRIMARY_TOTAL_BUDGET_S
    last_err = "no primary attempt completed"
    attempt = 0
    while True:
        remaining = deadline - time.monotonic()
        if remaining < 120.0:
            break
        attempt += 1
        rc, out, err = _run_bounded(
            [sys.executable, os.path.abspath(__file__), "--primary"],
            min(PRIMARY_ATTEMPT_TIMEOUT_S, remaining),
        )
        if err.strip():
            print(
                f"# primary attempt {attempt} stderr tail: "
                + err.strip()[-800:],
                file=sys.stderr,
                flush=True,
            )
        parsed = None
        for ln in out.splitlines():
            ln = ln.strip()
            if ln.startswith("{") and '"metric"' in ln:
                try:
                    parsed = json.loads(ln)
                except json.JSONDecodeError:
                    continue
        if parsed and parsed.get("value", 0) > 0:
            return json.dumps(parsed)
        if parsed:
            # a refusal (no GPU, capacity overflow) will not change on retry
            return json.dumps(parsed)
        elif rc == -9:
            last_err = f"primary attempt {attempt} hung and was killed"
        else:
            last_err = f"primary attempt {attempt} exited rc={rc}"
    return _zero_line(last_err)


def main():
    # Print the primary line FIRST and flush: the driver's window may close
    # before the secondaries finish, and the headline must never be lost.
    print(_primary_via_child(), flush=True)
    for sec in _secondaries():
        print("BENCH_JSON " + json.dumps(sec), flush=True)


def _secondaries():
    """Render + RL benchmarks as subprocesses (one process on the card at a
    time), under one strict total wall budget so they can never starve the
    driver.
    A generator: each result is yielded (and printed by the caller) as soon
    as its script finishes, so a driver window closing mid-run still keeps
    every completed secondary. Skip with SCX_BENCH_SECONDARIES=0."""
    import sys

    if os.environ.get("SCX_BENCH_SECONDARIES", "1") == "0":
        return
    root = os.path.dirname(os.path.abspath(__file__))
    deadline = time.monotonic() + SECONDARY_TOTAL_BUDGET_S
    # 720p + RL first, spatial/bigscene only if budget remains
    for script in (
        "benchmarks/bench_city_720p.py",
        "benchmarks/bench_rlenv.py",
        "benchmarks/bench_rlenv_glb.py",
        "benchmarks/bench_bigscene.py",
        "benchmarks/bench_spatial_render.py",
    ):
        remaining = deadline - time.monotonic()
        if remaining <= 30.0:
            yield {"metric": script, "skipped": "total budget exhausted"}
            continue
        timeout = min(SECONDARY_SCRIPT_TIMEOUT_S, remaining)
        env = dict(os.environ)
        env.setdefault("SCX_BENCH_FAST", "1")  # scripts shrink warmups/rounds
        try:
            rc, out, err = _run_bounded(
                [sys.executable, os.path.join(root, script)],
                timeout,
                cwd=root,
                env=env,
            )
            got = False
            for line in out.splitlines():
                if line.startswith("BENCH_JSON "):
                    yield json.loads(line[len("BENCH_JSON "):])
                    got = True
            if not got:
                yield {
                    "metric": script,
                    "error": f"rc={rc}, no BENCH_JSON line",
                    # stderr tail makes failures diagnosable from the
                    # output alone
                    "stderr_tail": err.strip()[-600:],
                }
        except Exception as e:  # noqa: BLE001 — never break the primary line
            yield {"metric": script, "error": str(e)[:200]}


if __name__ == "__main__":
    import sys

    if "--primary" in sys.argv:
        _run_primary()
    else:
        main()

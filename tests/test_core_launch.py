"""Adaptive launch chunking (scx.core.launch) — launch-length bound.

A fixed chunk constant calibrated on a fast machine gives much longer
launches on a slow one. These tests simulate machines of various
speeds (including a 10x-slow one) and assert the controller never sizes
a launch whose simulated duration exceeds the hard bound.
"""

import pytest
import math

from scx.core.launch import AdaptiveChunker

WATCHDOG_S = 60.0


def simulate_rollout(per_env_step_s, n_envs, length, chunker=None):
    """Run the chunk loop against a simulated machine; returns the list of
    (steps, duration_s) launches."""
    ch = chunker or AdaptiveChunker()
    launches = []
    done = 0
    while done < length:
        steps = ch.chunk_steps(n_envs, length - done)
        dur = per_env_step_s * n_envs * steps
        ch.observe(n_envs, steps, dur)
        launches.append((steps, dur))
        done += steps
    assert done == length
    return launches


def test_first_launch_is_conservative():
    ch = AdaptiveChunker(init_env_steps=16384, first_launch_safety=2.0)
    # 4096 envs: pre-measurement chunk is 16384/(4096*2) = 2 steps
    assert ch.chunk_steps(4096, 1000) == 2


def test_slow_machine_never_trips_watchdog():
    # a machine 4x slower than the one the constant was calibrated on;
    # also try 10x. Calibration point: 4096
    # envs x 4 steps ~ 28s on the dev box => ~1.7e-6 s/env-step.
    for slowdown in (1.0, 4.0, 10.0):
        per = 1.7e-6 * slowdown
        launches = simulate_rollout(per, n_envs=4096, length=32)
        for steps, dur in launches:
            assert dur < WATCHDOG_S, (slowdown, steps, dur)


def test_fast_machine_grows_chunks():
    # a fast local chip: after the first measurement chunks jump to cover
    # the remaining work (capped by `remaining`, and always under target)
    launches = simulate_rollout(1e-7, n_envs=1024, length=4096)
    first_steps = launches[0][0]
    second_steps = launches[1][0]
    assert second_steps >= first_steps * 64, launches[:2]
    assert all(d <= AdaptiveChunker().target_s * 1.01 for _, d in launches)
    # and the whole rollout needs only a handful of launches
    assert len(launches) <= 16


def test_slowdown_mid_run_adopted_immediately():
    ch = AdaptiveChunker()
    n = 1024
    # machine starts fast -> big chunks
    for _ in range(4):
        s = ch.chunk_steps(n, 10_000)
        ch.observe(n, s, 1e-7 * n * s)
    big = ch.chunk_steps(n, 10_000)
    # machine suddenly 100x slower (e.g. a co-resident process)
    ch.observe(n, big, 1e-5 * n * big)
    nxt = ch.chunk_steps(n, 10_000)
    # next launch must be sized off the NEW slower estimate
    assert ch.predicted_s(n, nxt) <= ch.target_s * 1.01
    assert nxt < big


def test_chunks_are_powers_of_two():
    ch = AdaptiveChunker()
    n = 333
    for _ in range(12):
        s = ch.chunk_steps(n, 10_000)
        assert s & (s - 1) == 0, s  # power of two
        ch.observe(n, s, 3e-7 * n * s)


@pytest.mark.slow
def test_rlenv_rollout_uses_adaptive_chunks():
    """End-to-end: a tiny CityRLEnv rollout on the CPU backend goes
    through the adaptive path (chunk=None), covers the full length, and
    records launch observations."""
    from scx.app.rlenv import CityRLEnv

    env = CityRLEnv(n_envs=2, capacity=48, obs_size=32, n_traffic=2)
    obs_means, rewards = env.rollout(
        [[0.3, 0.0, 0.1, 0.0], [0.3, 0.0, 0.1, 0.0]], length=5
    )
    assert obs_means.shape == (5, 2)
    assert rewards.shape == (5, 2)
    assert env._chunker is not None
    assert sum(1 for _ in env._launched_lengths) >= 1

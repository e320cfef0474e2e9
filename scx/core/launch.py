"""Adaptive device-launch chunking.

Long rollouts are split into several launches of a device-chained scan,
so that no single launch runs longer than a target duration.

A fixed chunk constant calibrated on one machine is fragile: on a
slower machine the same constant gives longer launches. This controller
sizes each launch from MEASURED launch durations instead:

  * the first launch is conservative (a safety factor under the target),
  * every completed launch updates a per-env-step cost estimate,
  * slowdowns are adopted immediately (max-biased), speedups blend in
    gradually, so one slow launch can never be followed by an unsafe
    bigger one.

Mirrors the spirit of the reference's frame-time governor (fixed-step
accumulator clamps substeps, src/sandbox/src/main.cpp:267-308): bound
worst-case latency first, optimize throughput second.
"""

from __future__ import annotations


class AdaptiveChunker:
    """Sizes device launches (in steps) toward a wall-clock target.

    Parameters
    ----------
    target_s:  desired seconds per launch (default 20 — comfortably
               under the ~60 s watchdog even with 2x variance).
    hard_s:    never size a launch whose *predicted* duration exceeds
               this (acts as the watchdog guard band).
    init_env_steps: pre-measurement fallback budget (env_steps/launch);
               the round-1 calibrated constant is a fine first guess —
               it is further divided by `first_launch_safety`.
    """

    def __init__(
        self,
        target_s: float = 20.0,
        hard_s: float = 40.0,
        init_env_steps: int = 16384,
        first_launch_safety: float = 2.0,
    ):
        self.target_s = float(target_s)
        self.hard_s = float(hard_s)
        self.init_env_steps = int(init_env_steps)
        self.first_launch_safety = float(first_launch_safety)
        self.per_env_step_s: float | None = None  # measured cost estimate

    def chunk_steps(self, n_envs: int, remaining: int) -> int:
        """Steps for the next launch (>=1, <= remaining).

        Quantized to a power of two: launch length is a static (compiled)
        shape, and each distinct value costs a fresh XLA compile — minutes
        through a remote compile service. Powers of two bound the set of
        compiled programs to log2(max) while staying within 2x of the
        duration target."""
        if self.per_env_step_s is None:
            est = self.init_env_steps / (n_envs * self.first_launch_safety)
        else:
            # hard_s is the invariant even if a caller sets target_s above
            # it; with the defaults the target already dominates
            per_launch_s = min(self.target_s, self.hard_s)
            est = per_launch_s / (self.per_env_step_s * n_envs)
        est = max(1, min(int(remaining), int(est) if est >= 1.0 else 1))
        # largest power of two <= est (floor keeps the duration bound)
        return 1 << (est.bit_length() - 1)

    def observe(self, n_envs: int, steps: int, elapsed_s: float) -> None:
        """Record a completed launch. First observation may include compile
        time — still safe to adopt (it only makes the next chunk smaller)."""
        if elapsed_s <= 0.0 or steps <= 0:
            return
        per = elapsed_s / (float(steps) * float(n_envs))
        if self.per_env_step_s is None or per > self.per_env_step_s:
            # slower than believed: adopt immediately (safety first)
            self.per_env_step_s = per
        else:
            # faster than believed: blend in (avoid overreacting to one
            # lucky quiet-window measurement, CLAUDE.md quirk 10b)
            self.per_env_step_s = 0.5 * self.per_env_step_s + 0.5 * per

    def predicted_s(self, n_envs: int, steps: int) -> float | None:
        if self.per_env_step_s is None:
            return None
        return self.per_env_step_s * n_envs * steps

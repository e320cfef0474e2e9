"""Device-level tracing via jax.profiler — the device half of the
profiling story (reference: QPC scopes + top-5 snapshot, sc_time.cpp:52-122;
host-side scope parity lives in scx.core.timing).

The reference's scopes can only see host wall time.  Here the host loop
is a thin dispatcher and the truth lives in the device trace: XLA fusion
spans, Pallas kernel times, transfer gaps.  `start_trace`/`stop_trace`
capture a TensorBoard/Perfetto trace, and `annotate` brackets host spans
so scheduler systems show up alongside device activity.

Usage:
    from scx.telemetry import trace
    trace.start_trace("/tmp/scx_trace")
    for _ in range(30): sandbox.frame()
    trace.stop_trace()      # open in TensorBoard or ui.perfetto.dev
"""

from __future__ import annotations

import contextlib
import os

_active = False


def start_trace(logdir: str) -> None:
    """Begin a profiler capture (device + host annotations)."""
    global _active
    import jax

    os.makedirs(logdir, exist_ok=True)
    jax.profiler.start_trace(logdir)
    _active = True


def stop_trace() -> None:
    global _active
    import jax

    if _active:
        jax.profiler.stop_trace()
        _active = False


def tracing_active() -> bool:
    return _active


def annotate(name: str):
    """Host-span annotation visible in the captured trace; no-op (and
    near-zero cost) when no trace is active."""
    if not _active:
        return contextlib.nullcontext()
    import jax

    return jax.profiler.TraceAnnotation(name)


def profile_frames(sandbox, n_frames: int, logdir: str, **frame_kw):
    """Capture `n_frames` engine frames into `logdir` (convenience used by
    the viewer's --trace flag)."""
    start_trace(logdir)
    try:
        for _ in range(n_frames):
            sandbox.frame(**frame_kw)
    finally:
        stop_trace()
    return logdir

"""Tagged memory telemetry.

Mirror of the reference's memtrack (sc_memtrack.h:6-25, sc_memtrack.cpp:38-78):
per-tag atomic alloc/free/live counters plus a debug ring of the last 1024
allocation records.  The reference hooks its SC_NEW/SC_DELETE macros; here the
big allocations are explicit device arrays (entity state, mesh pools, texture
pools, framebuffers) and host buffers, so subsystems call `track`/`untrack`
(or `track_array`) at the points they materialize them.

Two extra sources the reference never had:
  - `device_memory_stats()`: the accelerator's own HBM counters
    (jax Device.memory_stats), the ground truth the tags approximate;
  - `host_rss_bytes()`: process RSS from /proc (Linux).
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass, field

# canonical tags (reference sc_memtrack.h:8-16 lists Core/Renderer/Physics/
# Streaming/Jobs/ImGui; device-side pools get their own)
TAG_CORE = "Core"
TAG_RENDERER = "Renderer"
TAG_PHYSICS = "Physics"
TAG_STREAMING = "Streaming"
TAG_JOBS = "Jobs"
TAG_STATE = "State"
TAG_ASSETS = "Assets"

RING_CAPACITY = 1024


@dataclass
class TagCounters:
    alloc_count: int = 0
    free_count: int = 0
    live_bytes: int = 0
    peak_bytes: int = 0


@dataclass
class AllocRecord:
    tag: str
    label: str
    nbytes: int


_lock = threading.Lock()
_tags: dict[str, TagCounters] = {}
_ring: deque[AllocRecord] = deque(maxlen=RING_CAPACITY)


def track(tag: str, nbytes: int, label: str = "") -> None:
    """Record an allocation of `nbytes` under `tag`."""
    with _lock:
        c = _tags.setdefault(tag, TagCounters())
        c.alloc_count += 1
        c.live_bytes += int(nbytes)
        c.peak_bytes = max(c.peak_bytes, c.live_bytes)
        _ring.append(AllocRecord(tag, label, int(nbytes)))


def untrack(tag: str, nbytes: int) -> None:
    """Record a free of `nbytes` under `tag`."""
    with _lock:
        c = _tags.setdefault(tag, TagCounters())
        c.free_count += 1
        c.live_bytes = max(0, c.live_bytes - int(nbytes))


def _nbytes_of(tree) -> int:
    import jax

    return sum(
        x.size * x.dtype.itemsize
        for x in jax.tree_util.tree_leaves(tree)
        if hasattr(x, "dtype")
    )


def track_array(tag: str, tree, label: str = "") -> int:
    """Track every array leaf of a pytree; returns total bytes."""
    n = _nbytes_of(tree)
    track(tag, n, label)
    return n


def untrack_array(tag: str, tree) -> int:
    n = _nbytes_of(tree)
    untrack(tag, n)
    return n


def retrack_array(tag: str, old_tree, new_tree, label: str = "") -> int:
    """Replace a tracked pytree (buffer rebuilt/reuploaded)."""
    if old_tree is not None:
        untrack_array(tag, old_tree)
    return track_array(tag, new_tree, label)


def snapshot() -> dict[str, TagCounters]:
    """Copy of the per-tag counters (memtrack_snapshot)."""
    with _lock:
        return {
            k: TagCounters(v.alloc_count, v.free_count, v.live_bytes, v.peak_bytes)
            for k, v in _tags.items()
        }


def recent_allocs(n: int = 16) -> list[AllocRecord]:
    """Tail of the debug ring (reference keeps the last 1024 records)."""
    with _lock:
        return list(_ring)[-n:]


def total_live_bytes() -> int:
    with _lock:
        return sum(c.live_bytes for c in _tags.values())


def reset() -> None:
    with _lock:
        _tags.clear()
        _ring.clear()


def device_memory_stats(device=None) -> dict:
    """The accelerator's own HBM counters, when the backend exposes them
    (bytes_in_use / peak_bytes_in_use / bytes_limit)."""
    import jax

    try:
        dev = device or jax.devices()[0]
        stats = dev.memory_stats()
        return dict(stats) if stats else {}
    except Exception:
        return {}


def host_rss_bytes() -> int:
    """Resident set size of this process (Linux /proc)."""
    try:
        with open("/proc/self/statm") as fh:
            pages = int(fh.read().split()[1])
        import os

        return pages * os.sysconf("SC_PAGE_SIZE")
    except Exception:
        return 0


def format_snapshot() -> str:
    """One-line-per-tag text block for the debug overlay."""
    snap = snapshot()
    lines = [
        f"  {tag:<10} live {c.live_bytes / 1048576.0:8.2f} MiB  "
        f"peak {c.peak_bytes / 1048576.0:8.2f}  allocs {c.alloc_count}/{c.free_count}"
        for tag, c in sorted(snap.items())
    ]
    dm = device_memory_stats()
    if dm.get("bytes_in_use") is not None:
        lines.append(
            f"  device HBM  {dm['bytes_in_use'] / 1048576.0:.1f} MiB in use"
            + (
                f" / {dm['bytes_limit'] / 1048576.0:.0f} limit"
                if dm.get("bytes_limit")
                else ""
            )
        )
    rss = host_rss_bytes()
    if rss:
        lines.append(f"  host RSS    {rss / 1048576.0:.1f} MiB")
    return "\n".join(lines)

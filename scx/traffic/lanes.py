"""Traffic lane graph: host builder + device arrays + vectorized queries.

The reference maintains a node/segment graph with quantized-position node
dedup and per-sector segment ownership (sc_traffic_lanes.h:13-30,
sc_traffic_lanes.cpp:65-155), generates a 4-lane cross per sector (two lanes
per axis offset +-laneWidth/2, :158-225), deactivates a sector's segments on
unload (:227-237), and answers nearest-lane / advance-along-lane queries
(:239-352).

Here the graph is built on the host (streaming already runs there) into
fixed-capacity numpy arrays and uploaded as a LaneArrays pytree; the agent
queries (nearest lane for every agent, look-ahead for every agent) are pure
jnp functions that vectorize over agents x segments in one pass.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np
from scx.core import struct

from scx.core import math3d as m3

INVALID_LANE = -1
MAX_CONNECTIONS = 4
DEFAULT_LANE_WIDTH = 3.5   # sc_traffic_lanes.h:93
DEFAULT_SPEED_LIMIT = 12.0  # sc_traffic_lanes.h:94


@struct.dataclass
class LaneArrays:
    """Device copy of the graph, fixed capacity (pad with inactive)."""

    node_pos: jax.Array      # [Ln,3]
    node_conn: jax.Array     # [Ln,MAX_CONNECTIONS] segment id or -1
    seg_start: jax.Array     # [Ls] node index
    seg_end: jax.Array       # [Ls]
    seg_dir: jax.Array       # [Ls,3]
    seg_len: jax.Array       # [Ls]
    seg_speed: jax.Array     # [Ls] speed limit at start node
    seg_active: jax.Array    # [Ls] bool


class LaneGraphBuilder:
    """Host-side graph builder mirroring TrafficLaneGraph."""

    def __init__(self, lane_width=DEFAULT_LANE_WIDTH, speed_limit=DEFAULT_SPEED_LIMIT,
                 max_nodes=1024, max_segments=1024):
        self.lane_width = lane_width
        self.speed_limit = speed_limit
        self.max_nodes = max_nodes
        self.max_segments = max_segments
        self.nodes: list[dict] = []
        self.segments: list[dict] = []
        self._lookup: dict[tuple, int] = {}
        self.sector_segments: dict[tuple, list[int]] = {}
        self.dirty = True

    @staticmethod
    def _quant(v, scale):
        s = v * scale
        return int(math.floor(s + (0.5 if s >= 0 else -0.5)))

    def _key(self, pos, dir):
        # pos quantized to 0.25m, dir to 1e-3 (sc_traffic_lanes.cpp:30-44)
        return (
            self._quant(pos[0], 4.0), self._quant(pos[1], 4.0), self._quant(pos[2], 4.0),
            self._quant(dir[0], 1000.0), self._quant(dir[1], 1000.0), self._quant(dir[2], 1000.0),
        )

    def add_node(self, pos, dir, speed_limit=None) -> int:
        key = self._key(pos, dir)
        if key in self._lookup:
            return self._lookup[key]
        idx = len(self.nodes)
        if idx >= self.max_nodes:
            raise RuntimeError("lane node capacity exceeded")
        self.nodes.append(
            dict(pos=tuple(pos), dir=tuple(dir),
                 speed=speed_limit if speed_limit is not None else self.speed_limit,
                 conn=[])
        )
        self._lookup[key] = idx
        self.dirty = True
        return idx

    def add_segment(self, start: int, end: int, dir, owner: tuple) -> int:
        a = np.asarray(self.nodes[start]["pos"])
        b = np.asarray(self.nodes[end]["pos"])
        d = b - a
        length = float(np.linalg.norm(d))
        if length > 1e-6:
            d = d / length
        else:
            d = np.asarray(dir, np.float64)
            d = d / max(np.linalg.norm(d), 1e-9)
        idx = len(self.segments)
        if idx >= self.max_segments:
            raise RuntimeError("lane segment capacity exceeded")
        self.segments.append(
            dict(start=start, end=end, dir=tuple(d), length=length,
                 owner=owner, active=True)
        )
        self.nodes[start]["conn"].append(idx)
        self.dirty = True
        return idx

    def build_procedural_for_sector(self, coord: tuple, bounds_min, bounds_max):
        """4-lane cross per sector (sc_traffic_lanes.cpp:158-225):
        reactivates previously-built segments on revisit."""
        existing = self.sector_segments.get(coord)
        if existing:
            for s in existing:
                self.segments[s]["active"] = True
            self.dirty = True
            return
        min_x, min_z = bounds_min[0], bounds_min[2]
        max_x, max_z = bounds_max[0], bounds_max[2]
        cx, cz = (min_x + max_x) * 0.5, (min_z + max_z) * 0.5
        off = self.lane_width * 0.5
        segs = []

        def road(p0, p1, d):
            n0 = self.add_node(p0, d)
            n1 = self.add_node(p1, d)
            segs.append(self.add_segment(n0, n1, d, coord))

        road((min_x, 0.0, cz - off), (max_x, 0.0, cz - off), (1.0, 0.0, 0.0))
        road((max_x, 0.0, cz + off), (min_x, 0.0, cz + off), (-1.0, 0.0, 0.0))
        road((cx + off, 0.0, min_z), (cx + off, 0.0, max_z), (0.0, 0.0, 1.0))
        road((cx - off, 0.0, max_z), (cx - off, 0.0, min_z), (0.0, 0.0, -1.0))
        self.sector_segments[coord] = segs

    def build_authored_for_sector(self, coord: tuple, polylines):
        """Register authored lane polylines (LANE chunks of a sector file):
        each polyline becomes a chain of segments; revisits reactivate."""
        existing = self.sector_segments.get(coord)
        if existing:
            for s in existing:
                self.segments[s]["active"] = True
            self.dirty = True
            return
        segs = []
        for points in polylines:
            prev = None
            for a, b in zip(points[:-1], points[1:]):
                d = np.asarray(b, np.float64) - np.asarray(a, np.float64)
                n = np.linalg.norm(d)
                if n < 1e-6:
                    continue
                d = (d / n).tolist()
                # share the corner node along the chain so advance-along-lane
                # can walk it (the dedup key includes direction, which would
                # otherwise split the corner into two nodes)
                n0 = prev if prev is not None else self.add_node(a, d)
                n1 = self.add_node(b, d)
                segs.append(self.add_segment(n0, n1, d, coord))
                prev = n1
        self.sector_segments[coord] = segs

    def to_snapshot(self) -> dict:
        """JSON-able snapshot of the WHOLE graph, deactivated segments
        included. Save-games must restore the graph verbatim rather than
        rebuild it per active sector: device state carries lane_id columns
        that index self.segments, and an incremental rebuild in a
        different activation order (or without since-unloaded sectors'
        segments occupying their indices) would silently remap them."""
        return {
            "nodes": [
                {
                    "pos": list(n["pos"]),
                    "dir": list(n["dir"]),
                    "speed": float(n["speed"]),
                    "conn": [int(c) for c in n["conn"]],
                }
                for n in self.nodes
            ],
            "segments": [
                {
                    "start": int(s["start"]),
                    "end": int(s["end"]),
                    "dir": list(s["dir"]),
                    "length": float(s["length"]),
                    "owner": list(s["owner"]) if s["owner"] else None,
                    "active": bool(s["active"]),
                }
                for s in self.segments
            ],
            "lookup": [[list(k), int(v)] for k, v in self._lookup.items()],
            "sector_segments": [
                [list(c), [int(i) for i in ids]]
                for c, ids in self.sector_segments.items()
            ],
        }

    def from_snapshot(self, snap: dict) -> None:
        """Inverse of to_snapshot — indices are preserved exactly."""
        self.nodes = [
            {
                "pos": tuple(n["pos"]),
                "dir": tuple(n["dir"]),
                "speed": n["speed"],
                "conn": list(n["conn"]),
            }
            for n in snap["nodes"]
        ]
        self.segments = [
            {
                "start": s["start"],
                "end": s["end"],
                "dir": tuple(s["dir"]),
                "length": s["length"],
                "owner": tuple(s["owner"]) if s["owner"] else None,
                "active": s["active"],
            }
            for s in snap["segments"]
        ]
        self._lookup = {tuple(k): v for k, v in snap["lookup"]}
        self.sector_segments = {
            tuple(c): list(ids) for c, ids in snap["sector_segments"]
        }
        self.dirty = True

    def remove_sector(self, coord: tuple):
        """Deactivate (not delete) the sector's segments (:227-237)."""
        for s in self.sector_segments.get(coord, []):
            self.segments[s]["active"] = False
        self.dirty = True

    def lanes_for_sector(self, coord: tuple) -> list[int]:
        return self.sector_segments.get(coord, [])

    def to_arrays(self) -> LaneArrays:
        ln, ls = self.max_nodes, self.max_segments
        node_pos = np.zeros((ln, 3), np.float32)
        node_conn = np.full((ln, MAX_CONNECTIONS), INVALID_LANE, np.int32)
        for i, n in enumerate(self.nodes):
            node_pos[i] = n["pos"]
            for j, c in enumerate(n["conn"][:MAX_CONNECTIONS]):
                node_conn[i, j] = c
        seg_start = np.zeros(ls, np.int32)
        seg_end = np.zeros(ls, np.int32)
        seg_dir = np.zeros((ls, 3), np.float32)
        seg_len = np.zeros(ls, np.float32)
        seg_speed = np.zeros(ls, np.float32)
        seg_active = np.zeros(ls, bool)
        for i, s in enumerate(self.segments):
            seg_start[i] = s["start"]
            seg_end[i] = s["end"]
            seg_dir[i] = s["dir"]
            seg_len[i] = s["length"]
            seg_speed[i] = self.nodes[s["start"]]["speed"]
            seg_active[i] = s["active"]
        self.dirty = False
        return LaneArrays(
            node_pos=jnp.asarray(node_pos),
            node_conn=jnp.asarray(node_conn),
            seg_start=jnp.asarray(seg_start),
            seg_end=jnp.asarray(seg_end),
            seg_dir=jnp.asarray(seg_dir),
            seg_len=jnp.asarray(seg_len),
            seg_speed=jnp.asarray(seg_speed),
            seg_active=jnp.asarray(seg_active),
        )


# ---------------------------------------------------------------------------
# Device queries (vectorize over agents via vmap or broadcasting)
# ---------------------------------------------------------------------------

def nearest_lane(lanes: LaneArrays, pos):
    """Closest point over all active segments (sc_traffic_lanes.cpp:239-279).

    pos: [3]; returns (lane_id, s, dist).  Column form: no [N,Ls,3]
    temporary with a 3-wide minor dim under an agents-vmap.
    """
    a = lanes.node_pos[lanes.seg_start]            # [Ls,3]
    ax, ay, az = a[:, 0], a[:, 1], a[:, 2]
    dx, dy, dz = lanes.seg_dir[:, 0], lanes.seg_dir[:, 1], lanes.seg_dir[:, 2]
    rx, ry, rz = pos[0] - ax, pos[1] - ay, pos[2] - az
    t = jnp.clip(rx * dx + ry * dy + rz * dz, 0.0, lanes.seg_len)
    ex, ey, ez = rx - dx * t, ry - dy * t, rz - dz * t
    dist = jnp.sqrt(ex * ex + ey * ey + ez * ez)
    dist = jnp.where(lanes.seg_active & (lanes.seg_len > 1e-5), dist, jnp.inf)
    best = jnp.argmin(dist)
    ok = jnp.isfinite(dist[best])
    return (
        jnp.where(ok, best.astype(jnp.int32), INVALID_LANE),
        jnp.where(ok, t[best], 0.0),
        dist[best],
    )


def adjacent_lane(
    lanes: LaneArrays,
    pos,
    fwd,
    cur_lane,
    min_dist: float = 1.5,
    max_dist: float = 5.5,
    min_dot: float = 0.85,
):
    """Nearest PARALLEL lane beside the agent — the lane-change target.

    Same column-form segment sweep as nearest_lane, restricted to active
    segments other than cur_lane whose direction agrees with the agent's
    heading (dot > min_dot) at a lateral distance inside [min_dist,
    max_dist].  Returns (lane_id, s, ok).
    """
    a = lanes.node_pos[lanes.seg_start]            # [Ls,3]
    ax, ay, az = a[:, 0], a[:, 1], a[:, 2]
    dx, dy, dz = lanes.seg_dir[:, 0], lanes.seg_dir[:, 1], lanes.seg_dir[:, 2]
    rx, ry, rz = pos[0] - ax, pos[1] - ay, pos[2] - az
    t = jnp.clip(rx * dx + ry * dy + rz * dz, 0.0, lanes.seg_len)
    ex, ey, ez = rx - dx * t, ry - dy * t, rz - dz * t
    dist = jnp.sqrt(ex * ex + ey * ey + ez * ez)
    par = dx * fwd[0] + dy * fwd[1] + dz * fwd[2]
    idx = jnp.arange(lanes.seg_len.shape[0], dtype=jnp.int32)
    valid = (
        lanes.seg_active
        & (lanes.seg_len > 1e-5)
        & (idx != cur_lane)
        & (par > min_dot)
        & (dist >= min_dist)
        & (dist <= max_dist)
    )
    score = jnp.where(valid, dist, jnp.inf)
    best = jnp.argmin(score)
    ok = jnp.isfinite(score[best])
    return (
        jnp.where(ok, best.astype(jnp.int32), INVALID_LANE),
        jnp.where(ok, t[best], 0.0),
        ok,
    )


def _choose_next(lanes: LaneArrays, dir, node_idx):
    """Best direction-dot continuation among the end node's connections
    (sc_traffic_lanes.cpp:139-155)."""
    conn = lanes.node_conn[node_idx]               # [MAX_CONNECTIONS]
    safe = jnp.maximum(conn, 0)
    dots = m3.dot(lanes.seg_dir[safe], dir[None, :])
    ok = (conn >= 0) & lanes.seg_active[safe]
    dots = jnp.where(ok, dots, -jnp.inf)
    k = jnp.argmax(dots)
    return jnp.where(jnp.isfinite(dots[k]), conn[k], INVALID_LANE)


def advance_along_lane(lanes: LaneArrays, lane_id, s, distance, max_hops: int = 8):
    """Walk the segment chain (sc_traffic_lanes.cpp:291-352).

    Returns (lane_id, s, pos, dir, ok). Fixed max_hops lax.scan, traceable.
    """
    # one packed row per segment: (active, len, end, dir.xyz) — each hop
    # fetches ONE row per agent instead of six element gathers
    seg_rows = jnp.stack(
        [
            lanes.seg_active.astype(jnp.float32),
            lanes.seg_len,
            lanes.seg_end.astype(jnp.float32),
            lanes.seg_dir[:, 0],
            lanes.seg_dir[:, 1],
            lanes.seg_dir[:, 2],
        ],
        axis=-1,
    )

    def hop(carry):
        cur, cs, remaining, done, ok, it = carry
        safe = jnp.maximum(cur, 0)
        row = seg_rows[safe]
        length = row[1]
        active = (cur >= 0) & (row[0] > 0.5) & (length > 1e-5)
        fail = ~done & ~active
        available = length - cs
        fits = remaining <= available

        # case: fits in current segment
        cs_new = jnp.where(fits, cs + remaining, 0.0)
        rem_new = jnp.where(fits, 0.0, remaining - available)

        # case: walk to next segment
        end_node = row[2].astype(jnp.int32)
        nxt = _choose_next(lanes, row[3:6], end_node)
        dead_end = ~fits & (nxt < 0)
        cur_new = jnp.where(fits | dead_end, cur, nxt)
        cs_new = jnp.where(dead_end, length, cs_new)

        newly_done = ~done & active & (fits | dead_end)
        done_new = done | newly_done | fail
        ok_new = ok & ~fail
        cs_out = jnp.where(done, cs, cs_new)
        cur_out = jnp.where(done, cur, cur_new)
        rem_out = jnp.where(done | newly_done, 0.0, rem_new)
        return (cur_out, cs_out, rem_out, done_new, ok_new, it + 1)

    def pending(carry):
        # while_loop instead of a fixed-hop scan: under the agent/env vmaps
        # JAX batches the loop to "iterate while ANY lane is pending", so
        # the fleet pays for the DEEPEST walk, not max_hops — most agents
        # finish in 1 hop.
        _, _, _, done, _, it = carry
        return (~done) & (it < max_hops)

    init = (
        jnp.asarray(lane_id, jnp.int32),
        jnp.asarray(s, jnp.float32),
        jnp.asarray(distance, jnp.float32),
        jnp.asarray(False),
        jnp.asarray(lane_id >= 0),
        jnp.int32(0),
    )
    cur, cs, rem, done, ok, _ = jax.lax.while_loop(pending, hop, init)
    ok = ok & done
    safe = jnp.maximum(cur, 0)
    a = lanes.node_pos[lanes.seg_start[safe]]
    d = lanes.seg_dir[safe]
    pos = a + d * cs
    return cur, cs, pos, d, ok


def look_ahead_point(lanes: LaneArrays, lane_id, s, distance):
    """getLookAheadPoint (sc_traffic_lanes.cpp:281-289)."""
    _, _, pos, d, ok = advance_along_lane(lanes, lane_id, s, distance)
    return pos, d, ok

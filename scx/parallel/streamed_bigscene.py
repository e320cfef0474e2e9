"""Sector streaming composed with spatial sharding: an UNBOUNDED streamed
world running across the mesh's 'sp' strips (VERDICT r3 item 5).

The reference's defining loop is a streamed open world
(sc_world_partition.cpp:799-966); this engine's defining capability is
one-huge-scene spatial sharding (scx.parallel.bigscene). This module makes
them meet:

  * ONE host streaming controller per strip (StripPartition — the stock
    WorldPartition state machine with a sector_filter so each sector is
    loaded by exactly its owning strip, and device writers that scatter
    into row k of the [S, N] sharded EntityState).
  * Per-strip slot space splits at `stream_rows`: rows [0, stream_rows)
    are HOST-managed (sector spawns/despawns, fixed-shape padded scatters);
    rows [stream_rows, N) are DEVICE-managed (dynamic agents, migration
    splices — make_bigscene_entity_step(mig_lo=stream_rows) keeps them
    disjoint, so a device migration can never race a host spawn into the
    same slot).
  * Streamed spawns get uids from a monotonic range ABOVE the S*N initial
    ids (assign_global_uids space): a freed slot's recycled row can never
    collide with a migrated entity still carrying that slot's original id,
    so the warm-start cache keys stay unique fleet-wide.

Per frame: every strip's partition.update() pumps its loads/activations/
despawns (host, amortized, budgeted — all the reference semantics), then
ONE sharded device step advances traffic AI + vehicles + physics with
halo exchange and migration (scx.parallel.bigscene).

Constraint: the strip domain must cover the streamed world — sector
ownership is by x-range (strip_of_sector), and a sector outside
[x0, x0 + S*shard_width) has no owner and is never loaded. Choose
x0/shard_width from the world bounds (the strips ARE the world).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from scx.core.config import StreamingBudgets, WorldPartitionConfig
from scx.state import entity as ent
from scx.world.streaming import WorldPartition


@jax.jit
def _spawn_strip_jit(state, k, slots, valid, cols):
    """spawn_entities semantics into row k of a [S,N] sharded state."""
    n = state.alive.shape[1]
    slots = jnp.where(valid, slots, n)  # out-of-range scatters drop
    state = state.replace(
        alive=state.alive.at[k, slots].set(True, mode="drop"),
    )
    for path, value in cols.items():
        parts = path.split(".")
        if len(parts) == 1:
            arr = getattr(state, parts[0])
            state = state.replace(
                **{parts[0]: arr.at[k, slots].set(value, mode="drop")}
            )
        else:
            group = getattr(state, parts[0])
            arr = getattr(group, parts[1])
            group = group.replace(
                **{parts[1]: arr.at[k, slots].set(value, mode="drop")}
            )
            state = state.replace(**{parts[0]: group})
    return state


@jax.jit
def _destroy_strip_jit(state, k, kill):
    """destroy_entities semantics on rows [0, len(kill)) of strip k
    (mirrors scx.state.entity.destroy_entities: clear alive+components,
    bump generation, zero velocities, body -> NONE)."""
    m = kill.shape[0]
    rows = jnp.arange(m)
    sel = lambda arr: arr[k, rows]
    put = lambda arr, v: arr.at[k, rows].set(v)
    state = state.replace(
        alive=put(state.alive, sel(state.alive) & ~kill),
        generation=put(
            state.generation, sel(state.generation) + kill.astype(jnp.uint32)
        ),
        components=put(
            state.components, jnp.where(kill, 0, sel(state.components))
        ),
        body=state.body.replace(
            body_type=put(
                state.body.body_type,
                jnp.where(kill, ent.BODY_NONE, sel(state.body.body_type)),
            ),
            vel=put(
                state.body.vel,
                jnp.where(kill[:, None], 0.0, sel(state.body.vel)),
            ),
            omega=put(
                state.body.omega,
                jnp.where(kill[:, None], 0.0, sel(state.body.omega)),
            ),
        ),
    )
    return state


class StripPartition(WorldPartition):
    """WorldPartition whose device writes land in row `strip` of a [S,N]
    sharded EntityState, restricted to rows [0, stream_rows).

    Slot bookkeeping (self._alive/_free) is LOCAL to the strip's streamed
    region; `capacity` passed to the base class is stream_rows."""

    def __init__(self, strip: int, uid_alloc, *args, **kw):
        super().__init__(*args, **kw)
        self.strip = strip
        self._uid_alloc = uid_alloc  # callable(n) -> np.ndarray of fresh uids

    def _spawn_on_device(self, state, sec, slots):
        batches = sec.staged
        sec.staged = None
        if batches is None or sum(n for n, _ in batches) != len(slots):
            batches = self._build_device_batches(sec.spawns, sec.coord)
        off = 0
        for n, cols in batches:
            pad = self.MAX_SPAWN_BATCH - n
            slots_arr = jnp.asarray(
                list(slots[off: off + n]) + [self.capacity] * pad, jnp.int32
            )
            valid = jnp.asarray([True] * n + [False] * pad)
            uids = np.zeros(self.MAX_SPAWN_BATCH, np.int32)
            uids[:n] = self._uid_alloc(n)
            cols = dict(cols)
            cols["uid"] = jnp.asarray(uids)
            state = _spawn_strip_jit(
                state, jnp.int32(self.strip), slots_arr, valid, cols
            )
            off += n
        return state

    def _destroy_on_device(self, state, kill):
        return _destroy_strip_jit(state, jnp.int32(self.strip), kill)


class StreamedBigScene:
    """Host controller for a streamed, spatially-sharded world.

    state: [S, N] sharded EntityState (build with alloc + reshape or
    per-strip stacks; uids are re-tagged globally unique here). Rows
    [0, stream_rows) of each strip belong to streaming; place dynamic
    agents in rows [stream_rows, N).
    """

    def __init__(
        self,
        mesh,
        state,
        config: WorldPartitionConfig,
        budgets: StreamingBudgets,
        x0: float,
        shard_width: float,
        stream_rows: int,
        world_root: str | None = None,
        asset_resolver=None,
    ):
        from scx.parallel.bigscene import assign_global_uids

        self.mesh = mesh
        self.n_shards = mesh.shape["sp"]
        self.x0 = float(x0)
        self.shard_width = float(shard_width)
        self.stream_rows = stream_rows
        self.capacity = state.alive.shape[1]
        assert stream_rows <= self.capacity
        self.state = assign_global_uids(state)
        self._next_uid = self.n_shards * self.capacity

        def alloc_uids(n: int) -> np.ndarray:
            out = np.arange(self._next_uid, self._next_uid + n, dtype=np.int32)
            self._next_uid += n
            return out

        ss = config.sector_size_meters
        self.partitions = []
        for k in range(self.n_shards):
            p = StripPartition(
                k, alloc_uids, config, budgets, stream_rows,
                world_root=world_root, asset_resolver=asset_resolver,
            )
            p.sector_filter = (
                lambda c, k=k: self.strip_of_sector(c, ss) == k
            )
            self.partitions.append(p)

    def strip_of_sector(self, coord, sector_size: float) -> int:
        """Owning strip by sector x-range midpoint; -1 when uncovered."""
        mid = (coord[0] + 0.5) * sector_size
        k = int(np.floor((mid - self.x0) / self.shard_width))
        return k if 0 <= k < self.n_shards else -1

    def update_streaming(self, camera_pos, camera_forward=(0.0, 0.0, 1.0)):
        """One host streaming tick across every strip (loads, budgeted
        activation scatters, amortized despawns)."""
        for p in self.partitions:
            self.state = p.update(self.state, camera_pos, camera_forward)
        return self.state

    @property
    def stats(self):
        return [p.stats for p in self.partitions]

    def active_sectors(self) -> set:
        return {
            c
            for p in self.partitions
            for c, s in p.sectors.items()
            if s.state.name == "ACTIVE"
        }

    def shutdown(self):
        for p in self.partitions:
            p.shutdown()

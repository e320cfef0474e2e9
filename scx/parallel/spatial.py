"""Spatial sharding of ONE huge physics scene: domain decomposition with
ghost-halo exchange and ownership migration over the mesh's 'sp' axis.

This is the sequence/context-parallel analogue for a world too big for one
chip (SURVEY §7: "a single huge scene would shard spatially with halo
exchange — ring-style neighbor comms").  The reference has no
equivalent (its answer to scale is LOD, §2.27); this is a first-class
extension of this engine.

Scheme (classic ghost-particle domain decomposition):
  * The world's x extent is cut into S strips; shard k owns bodies with
    x in [x0 + k*W, x0 + (k+1)*W).
  * Each step, every shard packs its bodies within `halo` of a boundary
    into a fixed-capacity ghost buffer and `ppermute`s it to that
    neighbor (one left hop + one right hop over ICI; open boundaries —
    edge shards receive zeros, which deactivate).
  * The local solve runs on [local + ghosts]; ghosts participate in
    broadphase/contacts so boundary collisions resolve, and because the
    solver is relaxed Jacobi (order-independent within an iteration) both
    owners compute the SAME impulses for a straddling pair — each applies
    them to its own side.  Ghost post-states are discarded.
  * Bodies that left the strip are packed the same way, ppermuted, and
    spliced into the receiver's free slots (fixed migration capacity;
    overflow is counted, never silent).

Capacities (halo_cap, mig_cap) are static — overflow drops the farthest
work and reports it in stats, mirroring the engine's budget philosophy.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from scx.physics.rigid import RigidBodies
from scx.physics.solver import SolverParams, step_bodies_cached
from scx.physics.warmstart import empty_contact_cache


def pack_rows(bodies, mask, cap: int, field: str = "active"):
    """Compact masked rows of a row-pytree into a fixed [cap] buffer
    (scatter-rank: one cumsum + one scatter, no sort).

    Works on any struct whose leaves are [N, ...] columns with a boolean
    activity column named `field` (RigidBodies.active, EntityState.alive).
    Returns (packed rows [cap] with the activity column false on empty
    slots, dropped count)."""
    n = mask.shape[0]
    mask = mask & getattr(bodies, field)
    rank = jnp.cumsum(mask.astype(jnp.int32)) - 1
    slot = jnp.where(mask, jnp.minimum(rank, cap), cap)
    src = (
        jnp.full((cap + 1,), -1, jnp.int32)
        .at[slot]
        .set(jnp.arange(n, dtype=jnp.int32), mode="drop")[:cap]
    )
    valid = src >= 0
    safe = jnp.maximum(src, 0)
    packed = jax.tree.map(lambda a: a[safe], bodies)
    packed = packed.replace(**{field: getattr(packed, field) & valid})
    total = jnp.sum(mask.astype(jnp.int32))
    dropped = jnp.maximum(total - cap, 0)
    return packed, dropped


def splice_rows(local, incoming, field: str = "active", free_mask=None):
    """Write incoming active rows into the first free local slots.

    free_mask (optional [N] bool) restricts which slots count as free —
    a streamed bigscene reserves rows [0, mig_lo) for host-managed sector
    spawns, so device migration must splice past them
    (scx.parallel.streamed_bigscene).

    Returns (local', dropped) — dropped counts incoming rows that found no
    free slot (capacity pressure, surfaced in stats)."""
    n = getattr(local, field).shape[0]
    m = getattr(incoming, field).shape[0]
    free = ~getattr(local, field)
    if free_mask is not None:
        free = free & free_mask
    # index of the k-th free slot, k < m (scatter-rank over free slots)
    frank = jnp.cumsum(free.astype(jnp.int32)) - 1
    fslot = jnp.where(free, jnp.minimum(frank, m), m)
    dest = (
        jnp.full((m + 1,), -1, jnp.int32)
        .at[fslot]
        .set(jnp.arange(n, dtype=jnp.int32), mode="drop")[:m]
    )
    ok = getattr(incoming, field) & (dest >= 0)
    target = jnp.where(ok, jnp.maximum(dest, 0), n)  # n == dropped sentinel

    def put(loc, inc):
        return loc.at[target].set(inc, mode="drop")

    out = jax.tree.map(put, local, incoming)
    # target==n rows fall off via mode="drop"; an inactive incoming row that
    # reached a free slot writes active=False, so the slot remains free.
    dropped = jnp.sum((getattr(incoming, field) & (dest < 0)).astype(jnp.int32))
    return out, dropped


def _neighbor_shift(tree, axis_name: str, direction: int, n_shards: int):
    """ppermute a pytree one hop along the ring; open boundary (edge shards
    receive zeros => .active False)."""
    if direction > 0:
        perm = [(i, i + 1) for i in range(n_shards - 1)]
    else:
        perm = [(i, i - 1) for i in range(1, n_shards)]
    return jax.tree.map(
        lambda x: jax.lax.ppermute(x, axis_name, perm), tree
    )


def make_spatial_step(
    params: SolverParams,
    n_shards: int,
    x0: float,
    shard_width: float,
    halo: float = 4.0,
    halo_cap: int = 32,
    mig_cap: int = 16,
    axis_name: str = "sp",
):
    """Build the per-shard step function (call INSIDE shard_map over
    `axis_name`).  f(local: RigidBodies[N]) -> (local', stats dict)."""

    def step(local: RigidBodies):
        k = jax.lax.axis_index(axis_name)
        x_lo = x0 + k.astype(jnp.float32) * shard_width
        x_hi = x_lo + shard_width
        x = local.pos[:, 0]
        has_left = k > 0
        has_right = k < n_shards - 1

        # --- halo exchange (ghosts) ---
        to_left, dl = pack_rows(local, (x < x_lo + halo) & has_left, halo_cap)
        to_right, dr = pack_rows(local, (x >= x_hi - halo) & has_right, halo_cap)
        from_right = _neighbor_shift(to_left, axis_name, -1, n_shards)
        from_left = _neighbor_shift(to_right, axis_name, +1, n_shards)

        combined = jax.tree.map(
            lambda a, b, c: jnp.concatenate([a, b, c], axis=0),
            local, from_left, from_right,
        )

        # --- local solve on [N + 2*halo_cap]; ghost post-state discarded ---
        n = local.active.shape[0]
        cache = empty_contact_cache(params.max_pairs)
        stepped, _, solve_stats = step_bodies_cached(combined, params, cache)
        local = jax.tree.map(lambda a: a[:n], stepped)

        # --- ownership migration ---
        x = local.pos[:, 0]
        mig_l_mask = (x < x_lo) & has_left
        mig_r_mask = (x >= x_hi) & has_right
        out_l, ml = pack_rows(local, mig_l_mask, mig_cap)
        out_r, mr = pack_rows(local, mig_r_mask, mig_cap)
        # deactivate migrated bodies locally (they now belong next door)
        local = local.replace(
            active=local.active & ~(mig_l_mask | mig_r_mask)
        )
        in_r = _neighbor_shift(out_l, axis_name, -1, n_shards)
        in_l = _neighbor_shift(out_r, axis_name, +1, n_shards)
        local, dm1 = splice_rows(local, in_l)
        local, dm2 = splice_rows(local, in_r)

        stats = {
            "active": jnp.sum(local.active.astype(jnp.int32)),
            "halo_dropped": dl + dr,
            "migrated": jnp.sum(out_l.active.astype(jnp.int32))
            + jnp.sum(out_r.active.astype(jnp.int32)),
            "migration_dropped": ml + mr + dm1 + dm2,
            "pair_overflow": solve_stats["pair_overflow"],
        }
        stats = jax.tree.map(lambda v: jax.lax.psum(v, axis_name), stats)
        return local, stats

    return step


def spatial_sharded_step(
    mesh,
    params: SolverParams,
    x0: float,
    shard_width: float,
    halo: float = 4.0,
    halo_cap: int = 32,
    mig_cap: int = 16,
):
    """jit-compiled shard_map wrapper: f(local_batch [S*N packed as [S,N]?])
    — takes the per-shard body set with leading axis sharded over 'sp'."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    n_shards = mesh.shape["sp"]
    step = make_spatial_step(
        params, n_shards, x0, shard_width, halo, halo_cap, mig_cap
    )

    def local_fn(bodies_slice):
        # bodies_slice leaves have leading dim 1 (the local shard) — squeeze
        b = jax.tree.map(lambda a: a[0], bodies_slice)
        b, stats = step(b)
        return jax.tree.map(lambda a: a[None], b), stats

    fn = shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(P("sp"),),
        out_specs=(P("sp"), P()),
        check_vma=False,
    )
    return jax.jit(fn)

"""ONE huge scene across the mesh: spatial physics strips + render strips,
both over the 'sp' axis — the full "sandbox tick too big for a chip" path.

Composition per step (all inside one shard_map, one jit):
  1. physics: each shard owns the bodies in its x-strip and advances them
     with ghost-halo exchange + ownership migration (scx.parallel.spatial —
     two ppermute ring hops over ICI).
  2. pose gather: body poses are tiny (a few KB/shard) next to framebuffer
     strips (MBs), so every shard all_gathers the fleet's poses and builds
     the full draw list.
  3. render: each shard rasterizes ONLY its strip of framebuffer rows
     (render_frame_rows — affine plane shift, no full-frame work) and the
     output image is materialized sharded over rows.

The reference's answer to big scenes is LOD degradation (§2.27); this is
this engine's answer — throw devices at it.  Collectives per frame: 4
ppermutes (halo + migration) + 1 all_gather.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from scx.core import math3d as m3
from scx.parallel.spatial import make_spatial_step
from scx.physics.solver import SolverParams
from scx.render.mesh import MESH_CUBE, build_mesh_pool
from scx.render.pipeline import DrawList, RasterParams, render_frame_rows


def gathered_draws(bodies_all_pos, bodies_all_quat, bodies_all_size,
                   bodies_all_active):
    """Fleet poses -> DrawList of scaled unit cubes (MESH_CUBE has half
    extent 0.5, so scale = full extents = 2*half_extents)."""
    model = jax.vmap(m3.mat4_trs_quat)(
        bodies_all_pos, bodies_all_quat, bodies_all_size * 2.0
    )
    n = bodies_all_pos.shape[0]
    return DrawList(
        mesh_id=jnp.full((n,), MESH_CUBE, jnp.int32),
        material_id=jnp.zeros((n,), jnp.int32),
        model=model,
        valid=bodies_all_active,
    )


def make_bigscene_step(
    mesh,
    params: SolverParams,
    raster: RasterParams,
    x0: float,
    shard_width: float,
    halo: float = 4.0,
    halo_cap: int = 32,
    mig_cap: int = 16,
    materials=None,
    textures=None,
):
    """Returns jitted f(bodies [S,N] sharded over 'sp', view_proj) ->
    (bodies', rgb [H,W,3] row-sharded over 'sp', stats)."""
    from jax import shard_map

    n_shards = mesh.shape["sp"]
    rows_per = raster.height // n_shards
    assert rows_per % raster.tile_h == 0, "strip rows must align to tile_h"
    pool = build_mesh_pool()
    spatial = make_spatial_step(
        params, n_shards, x0, shard_width, halo, halo_cap, mig_cap
    )

    def local(bodies_slice, vp):
        b = jax.tree.map(lambda a: a[0], bodies_slice)
        b, stats = spatial(b)

        pos = jax.lax.all_gather(b.pos, "sp").reshape(-1, 3)
        quat = jax.lax.all_gather(b.quat, "sp").reshape(-1, 4)
        size = jax.lax.all_gather(b.size, "sp").reshape(-1, 3)
        active = jax.lax.all_gather(b.active, "sp").reshape(-1)
        draws = gathered_draws(pos, quat, size, active)

        row0 = jax.lax.axis_index("sp") * rows_per
        rgb, _, rstats = render_frame_rows(
            draws, pool, vp, raster, row0, rows_per, materials, textures
        )
        stats = dict(stats)
        stats["tile_overflow"] = jax.lax.psum(rstats["tile_overflow"], "sp")
        # strip culling makes per-shard counts differ; report the max
        stats["tris_in"] = jax.lax.pmax(rstats["tris_in"], "sp")
        return jax.tree.map(lambda a: a[None], b), rgb, stats

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P("sp"), P()),
        out_specs=(P("sp"), P("sp", None, None), P()),
        check_vma=False,
    )
    return jax.jit(fn)


def entity_draws(pos, rot, scale, mesh_id, material_id, alive):
    """Gathered entity columns -> DrawList (render prep without the draw
    budget: the whole fleet is the budget here)."""
    model = jax.vmap(m3.mat4_trs_quat)(pos, rot, scale)
    return DrawList(
        mesh_id=jnp.maximum(mesh_id, 0),
        material_id=jnp.maximum(material_id, 0),
        model=model,
        valid=alive & (mesh_id >= 0),
    )


def make_bigscene_entity_step(
    mesh,
    cfg,
    sim,
    raster: RasterParams | None,
    x0: float,
    shard_width: float,
    halo: float = 24.0,
    halo_cap: int = 32,
    mig_cap: int = 16,
    n_steps: int = 1,
    mig_lo: int = 0,
):
    """FULL engine semantics in the spatially-sharded huge scene: traffic
    AI + vehicles (player included) + physics per x-strip, entity rows
    migrating between strips (VERDICT r2 item 4).

    Each shard owns an EntityState strip. Per fixed step, inside one
    shard_map:
      1. ghost halo exchange of whole entity ROWS (all component columns
         travel: a ghost vehicle re-runs its AI + wheel forces in the
         neighbor's frame, so straddling-pair impulses match the owner's —
         same relaxed-Jacobi argument as scx.parallel.spatial);
      2. traffic_ai_update then physics_sync_step on [local + ghosts]
         (the make_sim_tick system order, scx/app/sandbox.py:120-124),
         with a WARM-STARTED contact cache keyed by entity uid — the
         persistent identity travels with migrating/ghosted rows, so
         accumulated impulses survive the row churn that row-index keys
         would not (Bullet's persistent manifolds across the whole sharded
         scene, sc_physics.cpp:283-302);
      3. ownership migration via pack/splice of entity rows.
    `lanes` ride replicated (read-only, tiny). Exact equivalence with the
    single-chip step requires halo >= cfg.traffic.front_ray_length plus
    interaction range — the sensor ray must see everything it would see
    globally. Entity uids must be unique ACROSS shards (a global alloc +
    reshape gives this for free; per-strip allocs need assign_global_uids).

    Returns jitted f(state [S,N] over 'sp', cache [S,...] over 'sp',
    lanes, view_proj) -> (state', cache', rgb rows over 'sp' | None,
    stats). `cache` is a per-shard PlanarCache (stack empty_sync_cache
    S times, or reuse the returned one); thread it across calls for
    launch-to-launch warm starting. With raster=None the render stage is
    skipped (pure sim, e.g. equivalence tests on the physics+AI
    semantics).
    """
    from jax import shard_map

    from scx.parallel.spatial import pack_rows, splice_rows, _neighbor_shift
    from scx.physics.world import bodies_from_state, physics_sync_step
    from scx.state import entity as ent
    from scx.traffic.ai import traffic_ai_update

    tcfg = cfg.traffic
    dt = cfg.physics.fixed_dt
    n_shards = mesh.shape["sp"]
    if raster is not None:
        rows_per = raster.height // n_shards
        assert rows_per % raster.tile_h == 0, "strip rows must align to tile_h"
        pool = build_mesh_pool()

    def one_step(s, cache, lanes):
        k = jax.lax.axis_index("sp")
        x_lo = x0 + k.astype(jnp.float32) * shard_width
        x_hi = x_lo + shard_width
        x = s.transform.pos[:, 0]
        has_left = k > 0
        has_right = k < n_shards - 1

        # ghost selection is EXTENT-aware: a wide static (a ground slab
        # whose center is mid-strip) still reaches the boundary, and a
        # vehicle's wheel rays must find it from the neighbor's frame.
        # Conservative rotation-free radius = |half_extents|.
        r = jnp.where(
            (s.components & ent.C_COLLIDER) != 0,
            jnp.linalg.norm(s.body.half_extents, axis=-1),
            0.0,
        )
        to_left, dl = pack_rows(
            s, (x - r < x_lo + halo) & has_left, halo_cap, field="alive"
        )
        to_right, dr = pack_rows(
            s, (x + r >= x_hi - halo) & has_right, halo_cap, field="alive"
        )
        from_right = _neighbor_shift(to_left, "sp", -1, n_shards)
        from_left = _neighbor_shift(to_right, "sp", +1, n_shards)
        combined = jax.tree.map(
            lambda a, b, c: jnp.concatenate([a, b, c], axis=0),
            s, from_left, from_right,
        )

        bodies = bodies_from_state(combined)
        is_veh = (combined.components & ent.C_VEHICLE) != 0
        combined = traffic_ai_update(combined, lanes, bodies, is_veh, tcfg, dt)
        combined, cache, pstats = physics_sync_step(
            combined, sim.solver, sim.vehicle, dt, cache,
            key_id=combined.uid,
        )

        n = s.alive.shape[0]
        s = jax.tree.map(lambda a: a[:n], combined)

        x = s.transform.pos[:, 0]
        mig_l = (x < x_lo) & has_left & s.alive
        mig_r = (x >= x_hi) & has_right & s.alive
        out_l, ml = pack_rows(s, mig_l, mig_cap, field="alive")
        out_r, mr = pack_rows(s, mig_r, mig_cap, field="alive")
        s = s.replace(alive=s.alive & ~(mig_l | mig_r))
        in_r = _neighbor_shift(out_l, "sp", -1, n_shards)
        in_l = _neighbor_shift(out_r, "sp", +1, n_shards)
        # rows [0, mig_lo) are host-managed (streamed sector spawns);
        # migrating entities splice past them so a device write can never
        # race a queued host spawn into the same slot
        fm = (jnp.arange(n) >= mig_lo) if mig_lo else None
        s, d1 = splice_rows(s, in_l, field="alive", free_mask=fm)
        s, d2 = splice_rows(s, in_r, field="alive", free_mask=fm)

        stats = {
            "alive": jnp.sum(s.alive.astype(jnp.int32)),
            "halo_dropped": dl + dr,
            "migrated": jnp.sum(out_l.alive.astype(jnp.int32))
            + jnp.sum(out_r.alive.astype(jnp.int32)),
            "migration_dropped": ml + mr + d1 + d2,
            "pair_overflow": pstats["pair_overflow"],
        }
        return s, cache, stats

    def render_strip(s, vp):
        gather = lambda a: jax.lax.all_gather(a, "sp").reshape(
            (-1,) + a.shape[1:]
        )
        draws = entity_draws(
            gather(s.transform.pos), gather(s.transform.rot),
            gather(s.transform.scale), gather(s.render.mesh_id),
            gather(s.render.material_id), gather(s.alive),
        )
        row0 = jax.lax.axis_index("sp") * rows_per
        return render_frame_rows(draws, pool, vp, raster, row0, rows_per)

    def local(state_slice, cache_slice, lanes, vp):
        s = jax.tree.map(lambda a: a[0], state_slice)
        cache = jax.tree.map(lambda a: a[0], cache_slice)

        def body(carry, _):
            st, ca, _, _ = carry
            st, ca, stats = one_step(st, ca, lanes)
            if raster is not None:
                # render every chained step (composed sim+render cost);
                # decimated sum keeps the frame from being DCE'd
                rgb, _, _ = render_strip(st, vp)
                sink = rgb[::16, ::16].sum()
            else:
                sink = jnp.float32(0)
            return (st, ca, stats, sink), None

        s, cache, stats = one_step(s, cache, lanes)
        sink = jnp.float32(0)
        if n_steps > 1:
            (s, cache, stats, sink), _ = jax.lax.scan(
                body, (s, cache, stats, sink), None, length=n_steps - 1
            )
        stats = jax.tree.map(lambda v: jax.lax.psum(v, "sp"), stats)

        lift = lambda t: jax.tree.map(lambda a: a[None], t)
        if raster is None:
            return lift(s), lift(cache), stats

        rgb, _, rstats = render_strip(s, vp)
        stats["tile_overflow"] = jax.lax.psum(rstats["tile_overflow"], "sp")
        stats["rgb_sink"] = sink + rgb[::16, ::16].sum()
        return lift(s), lift(cache), rgb, stats

    if raster is None:
        fn = shard_map(
            local, mesh=mesh,
            in_specs=(P("sp"), P("sp"), P(), P()),
            out_specs=(P("sp"), P("sp"), P()),
            check_vma=False,
        )
    else:
        fn = shard_map(
            local, mesh=mesh,
            in_specs=(P("sp"), P("sp"), P(), P()),
            out_specs=(P("sp"), P("sp"), P("sp", None, None), P()),
            check_vma=False,
        )
    return jax.jit(fn)


def empty_shard_caches(mesh, max_pairs: int):
    """[S]-stacked empty PlanarCaches, one per 'sp' shard — the initial
    `cache` argument of make_bigscene_entity_step."""
    from scx.physics.world import empty_sync_cache

    s = mesh.shape["sp"]
    one = empty_sync_cache(max_pairs)
    return jax.tree.map(lambda a: jnp.broadcast_to(a, (s,) + a.shape), one)


def assign_global_uids(sharded_state):
    """Re-tag a [S,N] sharded EntityState with globally unique uids
    (shard*N + slot). A global alloc_entity_state + reshape already has
    unique uids; use this for states assembled per-strip."""
    s, n = sharded_state.alive.shape[:2]
    uid = jnp.arange(s * n, dtype=jnp.int32).reshape(s, n)
    return sharded_state.replace(uid=uid)


def make_bigscene_chain(mesh, params, raster, x0, shard_width, n_steps,
                        halo=4.0, halo_cap=32, mig_cap=16):
    """Device-chained variant: `n_steps` full sim+render steps inside ONE
    shard_map/jit (benchmarking: one launch for N steps). Returns
    f(bodies, vp) -> (bodies', last rgb, stats)."""
    from jax import shard_map

    n_shards = mesh.shape["sp"]
    rows_per = raster.height // n_shards
    pool = build_mesh_pool()
    spatial = make_spatial_step(
        params, n_shards, x0, shard_width, halo, halo_cap, mig_cap
    )

    def local(bodies_slice, vp):
        b0 = jax.tree.map(lambda a: a[0], bodies_slice)

        def body(b, _):
            b, stats = spatial(b)
            pos = jax.lax.all_gather(b.pos, "sp").reshape(-1, 3)
            quat = jax.lax.all_gather(b.quat, "sp").reshape(-1, 4)
            size = jax.lax.all_gather(b.size, "sp").reshape(-1, 3)
            active = jax.lax.all_gather(b.active, "sp").reshape(-1)
            draws = gathered_draws(pos, quat, size, active)
            row0 = jax.lax.axis_index("sp") * rows_per
            rgb, _, _ = render_frame_rows(
                draws, pool, vp, raster, row0, rows_per
            )
            return b, (rgb[::16, ::16].sum(), stats["active"])

        b, (sums, actives) = jax.lax.scan(body, b0, None, length=n_steps)
        stats = {"active": actives[-1], "rgb_sum": sums.sum()}
        return jax.tree.map(lambda a: a[None], b), stats

    fn = shard_map(
        local, mesh=mesh, in_specs=(P("sp"), P()),
        out_specs=(P("sp"), P()), check_vma=False,
    )
    return jax.jit(fn)

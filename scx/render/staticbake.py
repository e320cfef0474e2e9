"""Static-geometry bake: world-space triangle columns for never-moving props.

In the RL env (and any scene where most entities are static scenery), the
per-step triangle setup re-gathers every prop's mesh rows from the pool and
re-applies its model transform — work whose inputs never change after
reset. This module bakes the model transform ONCE into flat world-space
triangle columns; the per-step cost for static geometry drops to a single
viewProj projection (12 madds/vertex on [T] columns) feeding the shared
clip/plane back half (pipeline.setup_from_clip_cols).

Two further wins fall out:
  * per-entity frustum culling for statics disappears — off-screen
    triangles fail the on_screen/z tests in setup (the same set an
    entity-sphere cull would drop, since every triangle of an off-screen
    entity is off-screen);
  * the baked width can be sized to the ACTUAL alive static triangles (a
    few hundred in the RL env) instead of draw_budget x worst-case mesh,
    which shrinks every downstream binning/raster buffer.

Baked layout: one [26, T] f32 array per scene (column-major — [T, 26] rows
would tile-pad 26 -> 128 lanes, 5x memory):
  rows v*8+0..7 for vertex v in 0..2: wx, wy, wz, r, g, b, u, v
  row 24: material id (float; ids < 2^24 ride f32 exactly)
  row 25: live flag (1.0 / 0.0)

For the cluster rasterizer (64-consecutive-triangle meshlets) the bake can
Morton-order sources by world-space XZ once — camera-independent spatial
locality replacing the per-frame screen-space draw sort
(pipeline.sort_draws_spatial).

The reference has no analogue (the GPU re-transforms every vertex every
frame, sc_vk.cpp:1909 push-constant model matrix); here a streaming read
of baked columns replaces the per-triangle gather+transform.
"""

from __future__ import annotations

import jax.numpy as jnp

from scx.render.mesh import MeshPool
from scx.render.pipeline import DrawList, RasterParams, setup_from_clip_cols
from scx.state.entity import EntityState
from scx.world.culling import world_matrix_cols

N_BAKED_ROWS = 26


def static_entity_mask(state: EntityState):
    """Entities whose world transform can never change after reset:
    alive, renderable, static body, not a traffic agent. Must be the exact
    complement of the dynamic set the per-step draw path renders."""
    from scx.state import entity as ent

    return (
        state.alive
        & (state.render.mesh_id >= 0)
        & (state.body.body_type == ent.BODY_STATIC)
        & (state.traffic.mode == ent.TRAFFIC_NONE)
    )


def _interleave16(x):
    """Spread the low 16 bits of x with a 0 between each (Morton helper)."""
    x = x & 0xFFFF
    x = (x | (x << 8)) & 0x00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F
    x = (x | (x << 2)) & 0x33333333
    x = (x | (x << 1)) & 0x55555555
    return x


def _morton_xz_order(px, pz, mask):
    """Slot order by world-space XZ Morton code (masked-out slots last).

    Camera-independent cluster locality: 64-consecutive-triangle meshlets
    stay spatially tight for ANY view, so the bake never needs the
    per-frame screen-space draw sort."""
    qx = jnp.clip((px + 2048.0) * 8.0, 0, 65535).astype(jnp.int32)
    qz = jnp.clip((pz + 2048.0) * 8.0, 0, 65535).astype(jnp.int32)
    key = _interleave16(qx) | (_interleave16(qz) << 1)
    key = jnp.where(mask, key, jnp.int32(0x7FFFFFFF))
    return jnp.argsort(key)


def _bake_core(mid, mat, cols, mask, pool: MeshPool, max_tris: int):
    """Shared expansion + world transform -> [26, T] baked columns.

    mid/mat: [N] mesh + material ids; cols: 12 affine world-matrix columns
    ([N] each, world_matrix_cols layout); mask: [N] include flag. Source
    order is the array order (pre-sort for Morton). Triangles beyond
    `max_tris` drop."""
    n = mid.shape[0]
    mid = jnp.maximum(mid, 0)
    counts = jnp.where(mask, pool.mesh_tri_count[mid], 0)
    cum = jnp.cumsum(counts)
    total = cum[-1]
    starts = cum - counts

    e_idx = jnp.arange(max_tris, dtype=jnp.int32)
    marks = jnp.zeros(max_tris, jnp.int32).at[starts].add(1, mode="drop")
    draw_idx = jnp.clip(jnp.cumsum(marks) - 1, 0, n - 1)

    per_draw = jnp.stack(
        [
            starts.astype(jnp.float32),
            pool.mesh_first_tri[mid].astype(jnp.float32),
            mat.astype(jnp.float32),
        ]
        + list(cols),
        axis=-1,
    )  # [N, 15]
    drows = per_draw[draw_idx]  # [T,15] gather 1
    local = e_idx - drows[:, 0].astype(jnp.int32)
    tri_pool = drows[:, 1].astype(jnp.int32) + local
    live = e_idx < total

    trows = pool.tri_vert_rows[tri_pool]  # [T,24] gather 2
    m = [drows[:, 3 + i] for i in range(12)]  # m00..m23

    rows = []
    for v in range(3):
        x = trows[:, v * 8 + 0]
        y = trows[:, v * 8 + 1]
        z = trows[:, v * 8 + 2]
        rows.append(m[0] * x + m[1] * y + m[2] * z + m[3])
        rows.append(m[4] * x + m[5] * y + m[6] * z + m[7])
        rows.append(m[8] * x + m[9] * y + m[10] * z + m[11])
        for f in range(3, 8):
            rows.append(trows[:, v * 8 + f])
    rows.append(drows[:, 2])  # material
    rows.append(live.astype(jnp.float32))
    return jnp.stack(rows, axis=0)  # [26, T]


def bake_static_tris(
    state: EntityState, pool: MeshPool, max_tris: int, morton: bool = False
):
    """Bake the static entities' triangles from entity state -> [26, T].

    morton=False keeps slot order (matches the unbaked path's draw order,
    so tie-breaks agree bit-for-bit in the tri binner); morton=True orders
    sources by world XZ for cluster-path locality.
    """
    mask = static_entity_mask(state)
    mid = state.render.mesh_id
    mat = state.render.material_id
    cols = world_matrix_cols(state)
    if morton:
        order = _morton_xz_order(
            state.transform.pos[:, 0], state.transform.pos[:, 2], mask
        )
        mask = mask[order]
        mid = mid[order]
        mat = mat[order]
        cols = tuple(c[order] for c in cols)
    return _bake_core(mid, mat, cols, mask, pool, max_tris)


def bake_draws(
    draws: DrawList, pool: MeshPool, max_tris: int, morton: bool = True
):
    """Bake an explicit DrawList (editor documents, authored scenes,
    benches) -> [26, T] world-space columns."""
    mid = draws.mesh_id
    mat = draws.material_id
    model = draws.model
    cols = tuple(model[:, i, j] for i in range(3) for j in range(4))
    mask = draws.valid
    if morton:
        order = _morton_xz_order(model[:, 0, 3], model[:, 2, 3], mask)
        mask = mask[order]
        mid = mid[order]
        mat = mat[order]
        cols = tuple(c[order] for c in cols)
    return _bake_core(mid, mat, cols, mask, pool, max_tris)


def static_tri_total(state: EntityState, pool: MeshPool):
    """Exact triangle count the bake needs for `state` (host-callable)."""
    mask = static_entity_mask(state)
    mid = jnp.maximum(state.render.mesh_id, 0)
    return jnp.sum(jnp.where(mask, pool.mesh_tri_count[mid], 0))


def setup_static_from_bake(baked, view_proj, params: RasterParams):
    """Project baked world-space columns by ONE viewProj -> plane setup.

    params.max_tris must equal baked.shape[1] + params.effective_clip_extra
    (the clip-extra tail is appended here). Returns (setup, aabb, valid)
    exactly like pipeline.setup_triangles.
    """
    pad = params.effective_clip_extra
    t_s = baked.shape[1]
    assert params.max_tris == t_s + pad, (
        f"params.max_tris={params.max_tris} != baked {t_s} + clip pad {pad}"
    )

    def grow(col, fill=0.0):
        if pad == 0:
            return col
        return jnp.concatenate([col, jnp.full((pad,), fill, col.dtype)])

    vp = view_proj
    cx, cy, cz, cw, attrs = [], [], [], [], []
    for v in range(3):
        wx = baked[v * 8 + 0]
        wy = baked[v * 8 + 1]
        wz = baked[v * 8 + 2]
        cx.append(grow(vp[0, 0] * wx + vp[0, 1] * wy + vp[0, 2] * wz + vp[0, 3]))
        cy.append(grow(vp[1, 0] * wx + vp[1, 1] * wy + vp[1, 2] * wz + vp[1, 3]))
        cz.append(grow(vp[2, 0] * wx + vp[2, 1] * wy + vp[2, 2] * wz + vp[2, 3]))
        cw.append(
            grow(vp[3, 0] * wx + vp[3, 1] * wy + vp[3, 2] * wz + vp[3, 3], -1.0)
        )
        attrs.append([grow(baked[v * 8 + 3 + f]) for f in range(5)])

    live = jnp.concatenate(
        [baked[25] > 0.5, jnp.zeros((pad,), bool)]
    ) if pad else (baked[25] > 0.5)
    mat_ids = grow(baked[24]).astype(jnp.int32)
    return setup_from_clip_cols(cx, cy, cz, cw, attrs, live, mat_ids, params)

"""Frame pipeline: draw expansion -> clip transform -> bin -> raster -> shade.

The engine's replacement for the Vulkan draw path (reference
sc_vk.cpp:1711-1958 beginFrame: sort draws, bind pipelines, vkCmdDrawIndexed).
Here a frame is data, not commands:

  1. expand_draws: the draw list (meshId, materialId, model — the reference's
     DrawItem, sc_ecs.h:160-170) becomes a fixed-capacity triangle soup via a
     cumsum/searchsorted gather over the baked mesh pool.
  2. setup_triangles: model+viewProj transform (one matmul), near-plane
     and backface cull, viewport mapping, perspective-correct attribute
     premultiplication.
  3. bin_triangles / bin_clusters: per screen tile, the list of triangles
     (or 32-triangle clusters, scx.ops.raster_clusters) its AABB covers.
  4. rasterize (scx.ops.raster): Pallas kernel, one program per screen
     sub-tile -> G-buffer (depth + vertex color + uv + material id).
  5. shade: deferred texturing in XLA — material table lookup + bilinear
     atlas sample x vertex color (the reference's textured pipeline,
     assets/shaders/mesh_tex.frag) — gathers belong in XLA, not the kernel.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from scx.core import struct

from scx.core import math3d as m3
from scx.render.mesh import MeshPool

# setup-field layout (keep in sync with scx.ops.raster*): everything the
# kernels evaluate per pixel is a PLANE a*px + b*py + c — barycentrics,
# depth, 1/w and premultiplied attributes are all linear in screen space,
# so per-triangle work in the kernel is 2 madds per quantity.
F_L0 = 0         # +3 lambda0 plane (a, b, c); invalid tris get l0 == -1
F_L1 = 3         # +3 lambda1 plane (lambda2 = 1 - l0 - l1)
F_Z = 6          # +3 depth plane (NDC z, 0..1)
F_IW = 9         # +3 1/w plane
F_COL = 12       # +9 premultiplied rgb planes (3 channels x (a,b,c))
F_UV = 21        # +6 premultiplied uv planes
F_MAT = 27       # material id as float
F_VALID = 28     # > 0 when triangle live
F_ZMIN = 29      # min vertex depth (cluster binning reads this)
N_FIELDS = 32    # padded


@struct.dataclass
class DrawList:
    """The reference's per-frame DrawItem list (sc_ecs.h:160-170)."""

    mesh_id: jax.Array      # [D] i32
    material_id: jax.Array  # [D] i32
    model: jax.Array        # [D,4,4] f32
    valid: jax.Array        # [D] bool


@struct.dataclass
class RasterParams:
    width: int = struct.field(pytree_node=False, default=1280)
    height: int = struct.field(pytree_node=False, default=720)
    # binning tile: the screen region one triangle/cluster list covers.
    # Larger tiles mean fewer (tile, cluster) pairs to bin; the raster
    # kernel splits each tile into register-sized sub-tiles below.
    tile_h: int = struct.field(pytree_node=False, default=64)
    tile_w: int = struct.field(pytree_node=False, default=128)
    # raster program sub-tile (powers of two, fitted to divide the bin
    # tile) and Triton warps per program
    sub_h: int = struct.field(pytree_node=False, default=32)
    sub_w: int = struct.field(pytree_node=False, default=32)
    num_warps: int = struct.field(pytree_node=False, default=4)
    max_tris: int = struct.field(pytree_node=False, default=131072)
    max_tris_per_tile: int = struct.field(pytree_node=False, default=256)
    emission_factor: int = struct.field(pytree_node=False, default=4)
    cull_backface: bool = struct.field(pytree_node=False, default=True)
    min_area2 : float = struct.field(pytree_node=False, default=1e-6)
    interpret: bool = struct.field(pytree_node=False, default=False)
    # cluster path: 32-triangle meshlet binning (large frames)
    use_clusters: bool = struct.field(pytree_node=False, default=True)
    max_clusters_per_tile: int = struct.field(pytree_node=False, default=64)
    # front-to-back draw ordering feeds the kernel's hierarchical-z skip
    sort_draws: bool = struct.field(pytree_node=False, default=True)
    # reserved tail slots for near-plane clip outputs (quad second halves)
    clip_extra: int = struct.field(pytree_node=False, default=2048)
    near_z: float = struct.field(pytree_node=False, default=0.1)

    @property
    def tiles_x(self) -> int:
        return -(-self.width // self.tile_w)

    @property
    def tiles_y(self) -> int:
        return -(-self.height // self.tile_h)

    @property
    def n_tiles(self) -> int:
        return self.tiles_x * self.tiles_y

    @property
    def max_emissions(self) -> int:
        return self.emission_factor * self.max_tris

    @property
    def effective_clip_extra(self) -> int:
        # never reserve more than a quarter of the buffer (tiny test configs)
        return max(0, min(self.clip_extra, self.max_tris // 4))


def _interleave_bits10(x):
    """Spread the low 10 bits of x so there is a 0 between each (Morton)."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def sort_draws_spatial(draws: DrawList, view_proj, params) -> DrawList:
    """Order draws by screen-space Morton code of their projected origin.

    Cluster binning groups 64 CONSECUTIVE triangles; its efficiency rests on
    consecutive draws landing near each other on screen.  An unsorted
    instance list (streaming slot order) breaks that — one cluster then
    spans the frame and overlaps every tile.  Morton order restores spatial
    locality in one cheap 10k-element sort per frame.  (The reference sorts
    draws for bind coherence, sc_vk.cpp:1843-1864; here locality pays.)
    """
    origin_h = jnp.concatenate(
        [draws.model[:, 0:3, 3], jnp.ones((draws.model.shape[0], 1))], axis=1
    )
    clip = jnp.einsum("ij,tj->ti", view_proj, origin_h, precision=m3.PRECISION)
    w = jnp.maximum(clip[:, 3], 1e-3)
    sx = jnp.clip((clip[:, 0] / w * 0.5 + 0.5) * 1023.0, 0.0, 1023.0).astype(jnp.int32)
    sy = jnp.clip((clip[:, 1] / w * 0.5 + 0.5) * 1023.0, 0.0, 1023.0).astype(jnp.int32)
    behind = clip[:, 3] <= 1e-3
    morton = _interleave_bits10(sx) | (_interleave_bits10(sy) << 1)
    key = jnp.where(draws.valid & ~behind, morton, jnp.int32(0x7FFFFFFF))
    order = jnp.argsort(key)
    return DrawList(
        mesh_id=draws.mesh_id[order],
        material_id=draws.material_id[order],
        model=draws.model[order],
        valid=draws.valid[order],
    )


def expand_draws(draws: DrawList, pool: MeshPool, max_tris: int):
    """Flatten the draw list into per-triangle (draw_idx, tri_idx) pairs.

    Returns (tri_draw [T], tri_pool [T], live [T]) with T = max_tris; draws
    beyond capacity are dropped (the draw-budget semantics of the reference's
    maxDraws, sc_world_partition.h:311).
    """
    counts = jnp.where(draws.valid, pool.mesh_tri_count[draws.mesh_id], 0)
    cum = jnp.cumsum(counts)
    total = cum[-1]
    starts = cum - counts
    e = jnp.arange(max_tris, dtype=jnp.int32)
    # draw boundaries by scatter+cumsum (no searchsorted)
    marks = jnp.zeros(max_tris, jnp.int32).at[starts].add(1, mode="drop")
    draw_idx = jnp.minimum(jnp.cumsum(marks) - 1, counts.shape[0] - 1)
    draw_idx = jnp.maximum(draw_idx, 0)
    # one row-gather for the two per-draw columns (vs two element gathers)
    per_draw = jnp.stack(
        [starts, pool.mesh_first_tri[draws.mesh_id]], axis=-1
    )[draw_idx]
    local = e - per_draw[:, 0]
    live = e < total
    tri_pool = per_draw[:, 1] + local
    return draw_idx, tri_pool, live


def _near_clip_cols(cw, pos_cols, attr_cols, live, extra_cap: int, eps: float):
    """Vectorized near-plane (w > eps) polygon clipping — column form.

    cw: [w0, w1, w2] clip-w columns ([T] each); pos_cols: per-vertex lists of
    (x, y, z) columns; attr_cols: per-vertex lists of attribute columns.
    Everything stays a flat [T] array — no packed [T,3,4] tensors with tiny
    minor dims.

    Crossing triangles are clipped: the slot is replaced by the first
    clipped triangle; quad second-halves are recovered by binary search
    over the crossing-count prefix sum and returned as gathered extras.
    Attribute interpolation happens in clip space (linear there).  The
    reference gets this from the GPU for free; a software rasterizer that
    merely culls loses any ground plane the camera stands on.
    """
    t = live.shape[0]
    inside = [w > eps for w in cw]
    n_in = sum(i.astype(jnp.int32) for i in inside)

    keep = live & (n_in == 3)
    one_out = live & (n_in == 2)
    two_out = live & (n_in == 1)

    # canonical rotation: the "special" vertex first (the single outside
    # vertex for one_out; the single inside vertex for two_out)
    out_idx = jnp.where(~inside[0], 0, jnp.where(~inside[1], 1, 2))
    in_idx = jnp.where(inside[0], 0, jnp.where(inside[1], 1, 2))
    special = jnp.where(one_out, out_idx, in_idx)

    # per-vertex columns: verts[v] = list of all columns of vertex v
    n_pos = len(pos_cols[0])
    n_att = len(attr_cols[0])
    all_cols = [list(pos_cols[v]) + [cw[v]] + list(attr_cols[v]) for v in range(3)]
    nc = n_pos + 1 + n_att

    def rot(k):
        """Columns of canonical vertex u_k = v[(special+k) % 3]."""
        return [
            jnp.where(
                special == 0,
                all_cols[k % 3][c],
                jnp.where(
                    special == 1, all_cols[(k + 1) % 3][c], all_cols[(k + 2) % 3][c]
                ),
            )
            for c in range(nc)
        ]

    u0, u1, u2 = rot(0), rot(1), rot(2)
    iw0 = u0[n_pos]  # clip w sits after the position columns
    iw1 = u1[n_pos]
    iw2 = u2[n_pos]

    def isect(a_cols, b_cols, wa, wb):
        tt = (eps - wa) / jnp.where(jnp.abs(wb - wa) < 1e-12, 1e-12, wb - wa)
        tt = jnp.clip(tt, 0.0, 1.0)
        return [a + (b - a) * tt for a, b in zip(a_cols, b_cols)]

    i01 = isect(u0, u1, iw0, iw1)
    i20 = isect(u2, u0, iw2, iw0)

    # one_out (u0 outside): poly = [i01, u1, u2, i20] -> tri (i01,u1,u2)
    # replaces the slot, (i01,u2,i20) goes to the extras
    # two_out (u0 inside): tri (u0, i01, i20) replaces the slot
    def merge(v_slot, one_cols, two_cols, orig_cols):
        return [
            jnp.where(one_out, oc, jnp.where(two_out, tc, gc))
            for oc, tc, gc in zip(one_cols, two_cols, orig_cols)
        ]

    tri1 = [
        merge(0, i01, u0, all_cols[0]),
        merge(1, u1, i01, all_cols[1]),
        merge(2, u2, i20, all_cols[2]),
    ]
    live1 = keep | one_out | two_out

    # quad second-half sources by scatter-rank recovery (the k-th one_out
    # tri writes its index into slot k; no searchsorted)
    cum = jnp.cumsum(one_out.astype(jnp.int32))
    rank = jnp.where(one_out, cum - 1, extra_cap)  # non-crossing -> dropped
    srcs = (
        jnp.zeros(extra_cap + 1, jnp.int32)
        .at[jnp.minimum(rank, extra_cap)]
        .set(jnp.arange(t, dtype=jnp.int32), mode="drop")[:extra_cap]
    )
    have = jnp.arange(1, extra_cap + 1, dtype=jnp.int32) <= cum[-1]
    # gather all 3x9 extra columns as ONE row-gather of a packed matrix
    # (instead of 27 column gathers)
    tri2 = [i01, u2, i20]
    packed = jnp.stack([col for v in range(3) for col in tri2[v]], axis=-1)
    rows = packed[srcs]  # [extra_cap, 3*nc]
    extras = [
        [
            jnp.where(have, rows[:, v * nc + c], 0.0)
            for c in range(nc)
        ]
        for v in range(3)
    ]
    return tri1, live1, srcs, have, extras


def setup_triangles(
    draws: DrawList,
    pool: MeshPool,
    view_proj,
    params: RasterParams,
):
    """Build the [T, N_FIELDS] screen-space plane-setup buffer.

    Internally everything is flat [T] columns — no [T,3,k] tensors with
    tiny minor dims, which cost most under a vmapped env batch.
    """
    pad = params.effective_clip_extra
    usable = params.max_tris - pad
    t = params.max_tris
    d = draws.valid.shape[0]

    def grow(col, fill=0.0):
        return jnp.concatenate([col, jnp.full((pad,), fill, col.dtype)])

    # Gathers are the cost here (one memory transaction per gathered
    # index), so EVERY per-draw quantity a triangle needs packs
    # into ONE [D, 19] row (start, first_tri, material, mvp x16) gathered
    # once per triangle, and the pool pre-packs each triangle's three
    # vertex rows into ONE 24-wide row (MeshPool.tri_vert_rows): geometry
    # expansion is exactly TWO row gathers per triangle instead of
    # gathering per_draw, mvp rows and material ids separately.
    # Integer columns ride the f32 row exactly (values < 2^24).
    tri_counts = jnp.where(
        draws.valid, pool.mesh_tri_count[draws.mesh_id], 0
    )
    cum = jnp.cumsum(tri_counts)
    total = cum[-1]
    starts = cum - tri_counts
    e_idx = jnp.arange(usable, dtype=jnp.int32)
    # draw boundaries by scatter+cumsum (searchsorted is gather-bound)
    marks = jnp.zeros(usable, jnp.int32).at[starts].add(1, mode="drop")
    draw_idx = jnp.clip(jnp.cumsum(marks) - 1, 0, d - 1)

    mvp = jnp.einsum(
        "ij,djk->dik", view_proj, draws.model, precision=m3.PRECISION
    )
    per_draw = jnp.concatenate(
        [
            starts.astype(jnp.float32)[:, None],
            pool.mesh_first_tri[draws.mesh_id].astype(jnp.float32)[:, None],
            draws.material_id.astype(jnp.float32)[:, None],
            mvp.reshape(d, 16),
        ],
        axis=-1,
    )
    drows = per_draw[draw_idx]                           # [T,19] gather 1
    local = e_idx - drows[:, 0].astype(jnp.int32)
    tri_pool = drows[:, 1].astype(jnp.int32) + local
    live = e_idx < total

    trows = pool.tri_vert_rows[tri_pool]                 # [T,24] gather 2
    vcol = [[trows[:, v * 8 + f] for f in range(8)] for v in range(3)]
    mcol = [[drows[:, 3 + i * 4 + j] for j in range(4)] for i in range(4)]

    def clip_coord(i, v):
        p = vcol[v]
        return (
            mcol[i][0] * p[0] + mcol[i][1] * p[1] + mcol[i][2] * p[2] + mcol[i][3]
        )

    cx = [grow(clip_coord(0, v)) for v in range(3)]
    cy = [grow(clip_coord(1, v)) for v in range(3)]
    cz = [grow(clip_coord(2, v)) for v in range(3)]
    cw = [grow(clip_coord(3, v), fill=-1.0) for v in range(3)]
    attrs = [[grow(vcol[v][f]) for f in range(3, 8)] for v in range(3)]
    live = jnp.concatenate([live, jnp.zeros((pad,), bool)])
    mat_ids = grow(drows[:, 2]).astype(draws.material_id.dtype)

    return setup_from_clip_cols(cx, cy, cz, cw, attrs, live, mat_ids, params)


def setup_from_clip_cols(cx, cy, cz, cw, attrs, live, mat_ids, params):
    """Clip-space columns -> the [T, N_FIELDS] plane-setup buffer.

    The back half of setup_triangles, callable directly by any geometry
    source that already has clip-space vertex columns (cx/cy/cz/cw:
    [3][T] per-vertex lists, attrs: [3][5][T] r,g,b,u,v, live: [T] bool,
    mat_ids: [T] i32) — e.g. pre-baked world-space geometry projected by
    one viewProj multiply. Columns must already include the
    effective_clip_extra tail reserve (zeros, cw fill -1).
    """
    pad = params.effective_clip_extra
    t = params.max_tris

    # clip at (just inside) the real near plane so clipped vertices have
    # w ~ near_z and bounded screen coordinates (f32 edge functions lose the
    # depth test on +-100k-pixel triangles)
    clip_eps = params.near_z * 0.9
    pos_cols = [[cx[v], cy[v], cz[v]] for v in range(3)]
    tri1, live, ex_src, ex_have, extras = _near_clip_cols(
        cw, pos_cols, attrs, live, pad, clip_eps
    )
    if pad > 0:
        tail = slice(t - pad, t)
        for v in range(3):
            for c in range(len(tri1[v])):
                tri1[v][c] = tri1[v][c].at[tail].set(extras[v][c])
        live = live.at[tail].set(ex_have)
        mat_ids = mat_ids.at[tail].set(jnp.where(ex_have, mat_ids[ex_src], 0))

    # unpack: columns are (x, y, z, w, r, g, b, u, v)
    cx = [tri1[v][0] for v in range(3)]
    cy = [tri1[v][1] for v in range(3)]
    cz = [tri1[v][2] for v in range(3)]
    cw = [tri1[v][3] for v in range(3)]
    attr = [tri1[v][4:9] for v in range(3)]

    inv_w = [1.0 / jnp.where(jnp.abs(w) < 1e-9, 1e-9, w) for w in cw]
    sx = [(cx[v] * inv_w[v] * 0.5 + 0.5) * params.width for v in range(3)]
    sy = [(cy[v] * inv_w[v] * 0.5 + 0.5) * params.height for v in range(3)]
    zw = [cz[v] * inv_w[v] for v in range(3)]

    near_ok = (
        (cw[0] > clip_eps * 0.5) & (cw[1] > clip_eps * 0.5) & (cw[2] > clip_eps * 0.5)
    )

    # signed area; cull degenerate, backfacing and sub-pixel triangles.
    # Convention: CCW-outward meshes under the Vulkan Y-flip projection give
    # front faces NEGATIVE pixel-space area.
    area2 = (sx[1] - sx[0]) * (sy[2] - sy[0]) - (sy[1] - sy[0]) * (sx[2] - sx[0])
    if params.cull_backface:
        face_ok = area2 < -params.min_area2
    else:
        face_ok = jnp.abs(area2) > params.min_area2

    xmin = jnp.minimum(sx[0], jnp.minimum(sx[1], sx[2]))
    xmax = jnp.maximum(sx[0], jnp.maximum(sx[1], sx[2]))
    ymin = jnp.minimum(sy[0], jnp.minimum(sy[1], sy[2]))
    ymax = jnp.maximum(sy[0], jnp.maximum(sy[1], sy[2]))
    on_screen = (
        (xmax >= 0.0) & (xmin < params.width) & (ymax >= 0.0) & (ymin < params.height)
    )
    zmax_c = jnp.maximum(zw[0], jnp.maximum(zw[1], zw[2]))
    zmin_c = jnp.minimum(zw[0], jnp.minimum(zw[1], zw[2]))
    z_ok = (zmax_c >= 0.0) & (zmin_c <= 1.0)

    valid = live & near_ok & face_ok & on_screen & z_ok

    # ---- plane-equation conversion (all [T] columns) ----
    x0, x1, x2 = sx
    y0, y1, y2 = sy
    inv_area = jnp.where(jnp.abs(area2) < 1e-12, 0.0, 1.0 / area2)
    l0x = -(y2 - y1) * inv_area
    l0y = (x2 - x1) * inv_area
    l0c = ((y2 - y1) * x1 - (x2 - x1) * y1) * inv_area
    l1x = -(y0 - y2) * inv_area
    l1y = (x0 - x2) * inv_area
    l1c = ((y0 - y2) * x2 - (x0 - x2) * y2) * inv_area
    l0x = jnp.where(valid, l0x, 0.0)
    l0y = jnp.where(valid, l0y, 0.0)
    l0c = jnp.where(valid, l0c, -1.0)
    l1x = jnp.where(valid, l1x, 0.0)
    l1y = jnp.where(valid, l1y, 0.0)
    l1c = jnp.where(valid, l1c, 0.0)

    def plane(v0, v1, v2):
        d0 = v0 - v2
        d1 = v1 - v2
        return (
            l0x * d0 + l1x * d1,
            l0y * d0 + l1y * d1,
            l0c * d0 + l1c * d1 + v2,
        )

    planes = [l0x, l0y, l0c, l1x, l1y, l1c]
    planes += list(plane(*zw))
    planes += list(plane(*inv_w))
    # premultiplied attribute planes: rgb then uv
    for f in range(5):
        pm = [attr[v][f] * inv_w[v] for v in range(3)]
        planes += list(plane(*pm))
    mat = mat_ids.astype(jnp.float32)
    planes += [
        mat,
        valid.astype(jnp.float32),
        zmin_c,
        jnp.zeros_like(mat),
        jnp.zeros_like(mat),
    ]
    setup = jnp.stack(planes, axis=1)

    aabb = jnp.stack([xmin, ymin, xmax, ymax], axis=-1)
    return setup, aabb, valid


def bin_triangles(setup, aabb, valid, params: RasterParams):
    """Tile binning, sort-free: overlap matrix -> running rank -> per-tile
    index recovery by searchsorted over the rank rows.

    The k-th triangle of tile t is the first tri whose running overlap count
    for t reaches k+1 — a binary search over a monotone row.  One cumsum and
    K searches per tile replace a global emission sort.  Order within a tile
    = triangle index order, which is draw order — same as the reference's
    sorted submission semantics.

    Returns (binned [n_tiles, K, N_FIELDS], counts [n_tiles]).
    """
    ntx, nty = params.tiles_x, params.tiles_y
    n_tiles = params.n_tiles
    tx0 = jnp.clip(jnp.floor(aabb[:, 0] / params.tile_w), 0, ntx - 1).astype(jnp.int32)
    ty0 = jnp.clip(jnp.floor(aabb[:, 1] / params.tile_h), 0, nty - 1).astype(jnp.int32)
    tx1 = jnp.clip(jnp.floor(aabb[:, 2] / params.tile_w), 0, ntx - 1).astype(jnp.int32)
    ty1 = jnp.clip(jnp.floor(aabb[:, 3] / params.tile_h), 0, nty - 1).astype(jnp.int32)

    tiles = jnp.arange(n_tiles, dtype=jnp.int32)
    t_y = tiles // ntx
    t_x = tiles % ntx
    overlap = (
        valid[None, :]
        & (t_x[:, None] >= tx0[None, :])
        & (t_x[:, None] <= tx1[None, :])
        & (t_y[:, None] >= ty0[None, :])
        & (t_y[:, None] <= ty1[None, :])
    )
    rank = jnp.cumsum(overlap.astype(jnp.int32), axis=1)  # [tiles, T] monotone
    counts = rank[:, -1]

    # index recovery by scatter (no searchsorted):
    # each overlapping (tile, tri) writes tri into slot rank-1; ranks are
    # unique per tile so every slot has exactly one writer.
    k = params.max_tris_per_tile
    t = params.max_tris
    pos = jnp.where(overlap, rank - 1, k)  # non-overlapping -> dropped slot
    pos = jnp.minimum(pos, k)
    tile_rows = jnp.broadcast_to(
        jnp.arange(n_tiles, dtype=jnp.int32)[:, None], (n_tiles, t)
    )
    tri_cols = jnp.broadcast_to(jnp.arange(t, dtype=jnp.int32)[None, :], (n_tiles, t))
    tri_ids = (
        jnp.zeros((n_tiles, k + 1), jnp.int32)
        .at[tile_rows, pos]
        .set(tri_cols, mode="drop")[:, :k]
    )
    slot = jnp.arange(k, dtype=jnp.int32)
    in_range = slot[None, :] < counts[:, None]

    binned = setup[tri_ids]  # [tiles, K, F]
    binned = binned.at[:, :, F_VALID].set(
        jnp.where(in_range, binned[:, :, F_VALID], 0.0)
    )
    return binned, counts  # raw counts (may exceed K: overflow stat)


def bin_triangles_batched(setup, aabb, valid, params: RasterParams):
    """Env-batched tile binning: setup [E,T,F], aabb [E,T,4], valid [E,T]
    -> (binned [E,n_tiles,K,F], counts [E,n_tiles]).

    A `vmap` of `bin_triangles` lowers its rank-recovery scatter to a
    batched scatter; here the index recovery is a block-rank gather over
    the whole fleet instead (below)."""
    e, t = valid.shape
    ntx, nty = params.tiles_x, params.tiles_y
    n_tiles = params.n_tiles
    k = params.max_tris_per_tile

    tx0 = jnp.clip(jnp.floor(aabb[..., 0] / params.tile_w), 0, ntx - 1).astype(jnp.int32)
    ty0 = jnp.clip(jnp.floor(aabb[..., 1] / params.tile_h), 0, nty - 1).astype(jnp.int32)
    tx1 = jnp.clip(jnp.floor(aabb[..., 2] / params.tile_w), 0, ntx - 1).astype(jnp.int32)
    ty1 = jnp.clip(jnp.floor(aabb[..., 3] / params.tile_h), 0, nty - 1).astype(jnp.int32)

    tiles = jnp.arange(n_tiles, dtype=jnp.int32)
    t_y = tiles // ntx
    t_x = tiles - t_y * ntx
    overlap = (
        valid[:, None, :]
        & (t_x[None, :, None] >= tx0[:, None, :])
        & (t_x[None, :, None] <= tx1[:, None, :])
        & (t_y[None, :, None] >= ty0[:, None, :])
        & (t_y[None, :, None] <= ty1[:, None, :])
    )  # [E, tiles, T]
    rank = jnp.cumsum(overlap.astype(jnp.int32), axis=-1)
    counts = rank[..., -1]

    # index recovery by BLOCK-RANK: the k-th triangle of a tile is located
    # by (a) a [K, B] compare-sum over the per-128-lane-block exclusive
    # rank bases, then (b) ONE gathered 128-lane block word row + argmax.
    # The gather moves K rows per tile instead of scattering T elements.
    # Same output as bin_triangles, exact.
    r = e * n_tiles
    w = 128
    pad_t = (-t) % w
    word = (rank << 1) | overlap.astype(jnp.int32)       # rank + hit bit
    word = word.reshape(r, t)
    if pad_t:
        word = jnp.pad(word, ((0, 0), (0, pad_t)))
    b = (t + pad_t) // w
    word = word.reshape(r, b, w)
    base = word[:, :, -1] >> 1                            # inclusive end
    base = jnp.concatenate(
        [jnp.zeros((r, 1), jnp.int32), base[:, :-1]], axis=1
    )                                                     # exclusive [r, B]
    ks = jnp.arange(k, dtype=jnp.int32)
    b_k = (
        jnp.sum((base[:, None, :] <= ks[None, :, None]).astype(jnp.int32), axis=2)
        - 1
    )
    b_k = jnp.clip(b_k, 0, b - 1)                         # [r, K]
    rows = jnp.take_along_axis(word, b_k[:, :, None], axis=1)  # [r, K, W]
    hit = ((rows >> 1) == (ks + 1)[None, :, None]) & ((rows & 1) > 0)
    lane = jnp.argmax(hit, axis=2).astype(jnp.int32)
    flat_counts = counts.reshape(r)
    tri_ids = jnp.where(
        ks[None, :] < jnp.minimum(flat_counts, k)[:, None],
        b_k * w + lane,
        0,
    ).reshape(e, n_tiles, k)
    slot = jnp.arange(k, dtype=jnp.int32)
    in_range = slot[None, None, :] < counts[:, :, None]

    binned = jax.vmap(lambda s, i: s[i])(setup, tri_ids)  # [E,tiles,K,F]
    binned = binned.at[..., F_VALID].set(
        jnp.where(in_range, binned[..., F_VALID], 0.0)
    )
    return binned, counts


@struct.dataclass
class Materials:
    """Material table (AssetManager materials, sc_assets.cpp:321-364):
    albedo texture + flags; unlit color modulation."""

    texture_id: jax.Array  # [M] i32, -1 = vertex color only
    tint: jax.Array        # [M,3] f32


@struct.dataclass
class MipTextures:
    """Texture pool with packed mip chains: quads [NT, FLAT, 12] where FLAT
    packs square power-of-two levels base-first (scx.assets.textures.mip_layout)
    and each row holds the texel's clamped 2x2 bilinear footprint
    (textures.build_mip_quads).  The redundant footprint makes exact
    bilinear+mips ONE gather of a 12-wide row per pixel instead of four."""

    quads: jax.Array  # [NT, FLAT, 12] f32
    size: int = struct.field(pytree_node=False, default=128)
    # trilinear: lerp between the two nearest mip levels (one extra gather
    # per pixel) instead of snapping to the nearest level. The reference's
    # sampler exposes linear mipmapping + anisotropy (sc_assets.cpp:210-211)
    # though its textures ship a single level (sc_assets.cpp:606); nearest
    # is the bench default, trilinear the fidelity option.
    trilinear: bool = struct.field(pytree_node=False, default=False)
    # anisotropy: max taps along the major axis of the pixel's UV
    # footprint (the reference's maxAnisotropy sampler knob,
    # sc_assets.cpp:210-211). 1 = isotropic (default); >1 distributes up
    # to that many taps along the footprint's long axis with the mip
    # level chosen from the SHORT axis — grazing surfaces keep detail the
    # isotropic level would blur away. Costs up to `anisotropy` gathers
    # per pixel; opt-in fidelity knob like trilinear.
    anisotropy: int = struct.field(pytree_node=False, default=1)


def _uv_mip_level(uv, covered, base_size: int, n_levels: int):
    """Per-pixel mip level from screen-space UV finite differences.

    A hardware rasterizer gets duv/dxy from 2x2 quad shading for free;
    deferred shading here differences the uv G-buffer.  Using the MIN-
    magnitude of forward/backward differences per axis keeps
    triangle/material boundaries (where the difference is garbage) from
    blowing the level up — interiors are exact.
    """
    up = uv * base_size  # texel coords at level 0

    def min_abs_diff(a, axis):
        fwd = jnp.diff(a, axis=axis, append=jnp.take(a, jnp.array([-1]), axis=axis))
        bwd = jnp.diff(a, axis=axis, prepend=jnp.take(a, jnp.array([0]), axis=axis))
        # replicated-edge diffs are exactly 0 — fall back to the real side
        pick_f = (jnp.abs(fwd) < jnp.abs(bwd)) & (fwd != 0.0) | (bwd == 0.0)
        return jnp.where(pick_f, fwd, bwd)

    dx = min_abs_diff(up, 1)  # [H,W,2]
    dy = min_abs_diff(up, 0)
    rho2 = jnp.maximum(jnp.sum(dx * dx, -1), jnp.sum(dy * dy, -1))
    level = 0.5 * jnp.log2(jnp.maximum(rho2, 1.0))
    level = jnp.where(covered, level, 0.0)
    return jnp.clip(level, 0.0, float(n_levels - 1))


def _uv_footprint_aniso(uv, covered, base_size: int, n_levels: int,
                        max_aniso: int):
    """Anisotropic footprint: (level, major_step_uv, n_taps).

    level is chosen from the footprint's SHORT axis with the tap count
    absorbing the long axis (level = log2(rho_max / N), the standard
    EWA-style approximation); major_step_uv is the long-axis derivative
    in [0,1] uv units for spacing the taps."""
    up = uv * base_size

    def min_abs_diff(a, axis):
        fwd = jnp.diff(a, axis=axis, append=jnp.take(a, jnp.array([-1]), axis=axis))
        bwd = jnp.diff(a, axis=axis, prepend=jnp.take(a, jnp.array([0]), axis=axis))
        pick_f = (jnp.abs(fwd) < jnp.abs(bwd)) & (fwd != 0.0) | (bwd == 0.0)
        return jnp.where(pick_f, fwd, bwd)

    dx = min_abs_diff(up, 1)
    dy = min_abs_diff(up, 0)
    px2 = jnp.sum(dx * dx, -1)
    py2 = jnp.sum(dy * dy, -1)
    rho_max = jnp.sqrt(jnp.maximum(jnp.maximum(px2, py2), 1.0))
    rho_min = jnp.sqrt(jnp.maximum(jnp.minimum(px2, py2), 1.0))
    n_taps = jnp.clip(
        jnp.ceil(rho_max / rho_min), 1.0, float(max_aniso)
    )
    level = jnp.log2(rho_max / n_taps)
    level = jnp.where(covered, level, 0.0)
    level = jnp.clip(level, 0.0, float(n_levels - 1))
    dmaj = jnp.where((px2 >= py2)[..., None], dx, dy) / base_size  # uv units
    return level, dmaj, n_taps


def shade(gbuffer, materials: Materials | None, textures, background=(0.05, 0.07, 0.1)):
    """Deferred shading: texture sample x interpolated vertex color.

    gbuffer: dict with 'depth' [H,W], 'color' [H,W,3], 'uv' [H,W,2],
    'mat' [H,W] i32, 'covered' [H,W] bool.
    textures: [NT, TH, TW, 3] f32 texture array, or a MipTextures pool for
    mip-mapped sampling (None -> vertex color only).
    """
    color = gbuffer["color"]
    covered = gbuffer["covered"]
    if materials is not None and textures is not None:
        mat = jnp.clip(gbuffer["mat"], 0, materials.texture_id.shape[0] - 1)
        tex_id = materials.texture_id[mat]
        tint = materials.tint[mat]
        uv = gbuffer["uv"]
        if isinstance(textures, MipTextures):
            from scx.assets.textures import mip_layout

            nt = textures.quads.shape[0]
            safe_tex = jnp.clip(tex_id, 0, nt - 1)
            offsets, sizes = mip_layout(textures.size)
            off_t = jnp.asarray(offsets[:-1], jnp.int32)
            sz_t = jnp.asarray(sizes, jnp.int32)
            aniso = max(1, int(getattr(textures, "anisotropy", 1)))
            if aniso > 1:
                flevel, dmaj, n_taps = _uv_footprint_aniso(
                    uv, covered, textures.size, len(sizes), aniso
                )
            else:
                flevel = _uv_mip_level(uv, covered, textures.size, len(sizes))

            def sample_level(level, uvw):  # [H,W] i32 -> bilinear [H,W,3]
                sz = sz_t[level]                 # [H,W] i32
                szf = sz.astype(jnp.float32)
                base = off_t[level]
                u = uvw[..., 0] * szf - 0.5
                v = uvw[..., 1] * szf - 0.5
                ui = jnp.clip(jnp.floor(u).astype(jnp.int32), 0, sz - 1)
                vi = jnp.clip(jnp.floor(v).astype(jnp.int32), 0, sz - 1)
                fu = jnp.clip(u - ui.astype(jnp.float32), 0.0, 1.0)[..., None]
                fv = jnp.clip(v - vi.astype(jnp.float32), 0.0, 1.0)[..., None]
                quad = textures.quads[safe_tex, base + vi * sz + ui]  # [H,W,12]
                return (
                    quad[..., 0:3] * (1 - fu) * (1 - fv)
                    + quad[..., 3:6] * fu * (1 - fv)
                    + quad[..., 6:9] * (1 - fu) * fv
                    + quad[..., 9:12] * fu * fv
                )

            def sample_at(uv_at):
                # REPEAT addressing (the reference's samplers default to
                # repeat, sc_assets.cpp sampler create); derivatives use
                # the unwrapped uv so tiling doesn't poison the level
                uvw = uv_at - jnp.floor(uv_at)
                if textures.trilinear:
                    l0 = jnp.floor(flevel).astype(jnp.int32)
                    l1 = jnp.minimum(l0 + 1, len(sizes) - 1)
                    frac = (flevel - l0.astype(jnp.float32))[..., None]
                    return (
                        sample_level(l0, uvw) * (1 - frac)
                        + sample_level(l1, uvw) * frac
                    )
                # truncation matches the pre-trilinear behavior exactly
                return sample_level(flevel.astype(jnp.int32), uvw)

            if aniso > 1:
                # up to `aniso` taps spaced along the footprint's long
                # axis; tap i is live where i < n_taps (per-pixel count)
                acc = jnp.zeros(uv.shape[:-1] + (3,), jnp.float32)
                for i in range(aniso):
                    t = ((i + 0.5) / n_taps - 0.5)[..., None]
                    live = (i < n_taps)[..., None]
                    tap = sample_at(uv + dmaj * t)
                    acc = acc + jnp.where(live, tap, 0.0)
                bilinear = acc / n_taps[..., None]
            else:
                bilinear = sample_at(uv)
            textured = jnp.where((tex_id >= 0)[..., None], bilinear, 1.0)
            color = color * textured * tint
            bg = jnp.asarray(background)
            return jnp.where(covered[..., None], color, bg)
        else:
            nt, th, tw, _ = textures.shape
            safe_tex = jnp.clip(tex_id, 0, nt - 1)
            u = uv[..., 0] * tw - 0.5
            v = uv[..., 1] * th - 0.5
            u0 = jnp.floor(u)
            v0 = jnp.floor(v)
            fu = (u - u0)[..., None]
            fv = (v - v0)[..., None]

            def tap(du, dv):
                ui = jnp.clip(u0.astype(jnp.int32) + du, 0, tw - 1)
                vi = jnp.clip(v0.astype(jnp.int32) + dv, 0, th - 1)
                return textures[safe_tex, vi, ui]

        bilinear = (
            tap(0, 0) * (1 - fu) * (1 - fv)
            + tap(1, 0) * fu * (1 - fv)
            + tap(0, 1) * (1 - fu) * fv
            + tap(1, 1) * fu * fv
        )
        textured = jnp.where((tex_id >= 0)[..., None], bilinear, 1.0)
        color = color * textured * tint
    bg = jnp.asarray(background)
    return jnp.where(covered[..., None], color, bg)


def render_frame(
    draws: DrawList,
    pool: MeshPool,
    view_proj,
    params: RasterParams,
    materials: Materials | None = None,
    textures=None,
):
    """Full frame: returns (rgb [H,W,3], gbuffer dict, stats dict)."""
    if params.use_clusters and params.sort_draws:
        draws = sort_draws_spatial(draws, view_proj, params)
    setup, aabb, valid = setup_triangles(draws, pool, view_proj, params)
    return _raster_and_shade(setup, aabb, valid, params, materials, textures)


def setup_frame_baked(
    baked,
    dyn_draws: DrawList,
    pool: MeshPool,
    view_proj,
    params: RasterParams,
    dyn_params: RasterParams,
):
    """Setup buffer of a frame from pre-baked static geometry + a dynamic
    DrawList -> (setup, aabb, valid, frame_params).

    `baked` is scx.render.staticbake world-space columns ([26, T_s],
    Morton-ordered at bake time so cluster meshlets stay spatially tight
    without the per-frame screen-space draw sort); statics project by ONE
    viewProj multiply, only `dyn_draws` (vehicles, traffic, movers) pays
    the full gather+transform setup. `params` is the frame's RasterParams
    (its max_tris is overridden by the combined width, see frame_params);
    `dyn_params` sizes the dynamic setup buffer.
    """
    from scx.render import staticbake as sb

    # cluster grouping reshapes by 32 (raster_clusters.CLUSTER): keep every
    # concatenated component 32-aligned
    pad_s = (min(params.clip_extra, baked.shape[1] // 4) // 32) * 32
    assert baked.shape[1] % 32 == 0 and dyn_params.max_tris % 32 == 0
    params_static = params.replace(
        max_tris=baked.shape[1] + pad_s, clip_extra=pad_s
    )
    s_setup, s_aabb, s_valid = sb.setup_static_from_bake(
        baked, view_proj, params_static
    )
    if params.use_clusters and params.sort_draws:
        dyn_draws = sort_draws_spatial(dyn_draws, view_proj, dyn_params)
    d_setup, d_aabb, d_valid = setup_triangles(
        dyn_draws, pool, view_proj, dyn_params
    )
    setup = jnp.concatenate([s_setup, d_setup], axis=0)
    aabb = jnp.concatenate([s_aabb, d_aabb], axis=0)
    valid = jnp.concatenate([s_valid, d_valid], axis=0)
    return setup, aabb, valid, params.replace(max_tris=setup.shape[0])


def render_frame_baked(
    baked,
    dyn_draws: DrawList,
    pool: MeshPool,
    view_proj,
    params: RasterParams,
    dyn_params: RasterParams,
    materials: Materials | None = None,
    textures=None,
):
    """Full frame from pre-baked static geometry + a dynamic DrawList
    (see setup_frame_baked): returns (rgb [H,W,3], gbuffer, stats)."""
    setup, aabb, valid, frame = setup_frame_baked(
        baked, dyn_draws, pool, view_proj, params, dyn_params
    )
    return _raster_and_shade(setup, aabb, valid, frame, materials, textures)


# column indices of the (b, c) pairs of every affine screen plane in the
# setup buffer: value(x, y) = a*x + b*y + c  (lambda0/1, z, 1/w, rgb, uv)
_PLANE_OFFSETS = (F_L0, F_L1, F_Z, F_IW, F_COL, F_COL + 3, F_COL + 6,
                  F_UV, F_UV + 3)
_PLANE_B_COLS = tuple(o + 1 for o in _PLANE_OFFSETS)
_PLANE_C_COLS = tuple(o + 2 for o in _PLANE_OFFSETS)


def shift_setup_rows(setup, aabb, valid, row0, strip_rows: int):
    """Translate the screen-space setup down by `row0` pixels (y' = y-row0).

    Every interpolation plane is affine in y, so the translation is
    c' = c + b*row0 on nine (b, c) column pairs — the full-frame raster
    kernels then evaluate the strip [row0, row0+strip_rows) at local
    coordinates unchanged.  `row0` may be traced (lax.axis_index under
    shard_map).  Triangles fully outside the strip are invalidated (the
    binners clamp tile ranges, so an off-strip AABB would otherwise land
    in an edge tile and waste occupancy)."""
    y0 = jnp.asarray(row0, jnp.float32)
    b_cols = jnp.asarray(_PLANE_B_COLS, jnp.int32)
    c_cols = jnp.asarray(_PLANE_C_COLS, jnp.int32)
    setup = setup.at[:, c_cols].add(setup[:, b_cols] * y0)
    aabb = aabb - jnp.asarray([0.0, 1.0, 0.0, 1.0]) * y0
    valid = valid & (aabb[:, 3] >= 0.0) & (aabb[:, 1] < strip_rows)
    return setup, aabb, valid


def render_frame_rows(
    draws: DrawList,
    pool: MeshPool,
    view_proj,
    params: RasterParams,
    row0,
    strip_rows: int,
    materials: Materials | None = None,
    textures=None,
):
    """Spatially-sharded frame: rasterize ONLY rows [row0, row0+strip_rows).

    The 'sp'-axis renderer (one huge frame split across chips, SURVEY §2
    parallelism item 6): every shard runs the identical (cheap) geometry
    setup against the FULL viewport, then bins and rasters just its strip
    of the tile lattice via shift_setup_rows.  strip_rows must be a
    multiple of tile_h; `params` is the full-frame RasterParams."""
    import dataclasses as _dc

    strip = _dc.replace(params, height=strip_rows)
    if params.use_clusters and params.sort_draws:
        draws = sort_draws_spatial(draws, view_proj, params)
    setup, aabb, valid = setup_triangles(draws, pool, view_proj, params)
    setup, aabb, valid = shift_setup_rows(setup, aabb, valid, row0, strip_rows)
    return _raster_and_shade(setup, aabb, valid, strip, materials, textures)


def raster_gbuffer_batched(setup, aabb, valid, params):
    """Env-batched bin + rasterize -> (gbuffer, stats); setup [E, T, F].

    Cluster path (params.use_clusters): vmapped meshlet bounds/compaction/
    binning feed the env-batched cluster kernel (rasterize_clusters_batched)
    — binning cost scales with clusters (T/32) instead of triangles, which
    is what lets RL observations carry large GLB scenes. Triangle path
    otherwise (small scenes, small frames)."""
    from scx.ops import raster as raster_ops
    from scx.ops import raster_clusters as rc

    if params.use_clusters:
        kc = params.max_clusters_per_tile

        def prep(setup_e, aabb_e, valid_e):
            cl_aabb, cl_valid, cl_zmin = rc.cluster_bounds(
                aabb_e, valid_e, params.max_tris, setup_e
            )
            c_aabb, c_valid, c_zmin, order, dropped = rc.compact_clusters(
                cl_aabb, cl_valid, cl_zmin
            )
            zsort = c_zmin if params.sort_draws else None
            ids, counts = rc.bin_clusters(c_aabb, c_valid, params, kc, cl_zmin=zsort)
            return order[ids], counts, cl_zmin, dropped

        cl_ids, cl_counts, cl_zmin, dropped = jax.vmap(prep)(setup, aabb, valid)
        gbuffer = rc.rasterize_clusters_batched(
            setup, cl_ids, cl_counts, params, kc,
            cl_zmin=cl_zmin if params.sort_draws else None,
        )
        occupancy, cap = cl_counts, kc
        cluster_drop = jnp.sum(dropped)
    else:
        binned, counts = bin_triangles_batched(setup, aabb, valid, params)
        gbuffer = raster_ops.rasterize_tiles_batched(binned, counts, params)
        occupancy, cap = counts, params.max_tris_per_tile
        cluster_drop = jnp.int32(0)
    stats = {
        "tris_in": jnp.sum(valid.astype(jnp.int32)),
        "max_tile_occupancy": jnp.max(occupancy),
        "tile_overflow": jnp.sum((occupancy >= cap).astype(jnp.int32)),
        "cluster_drop": cluster_drop,
    }
    return gbuffer, stats


def _raster_and_shade(setup, aabb, valid, params, materials, textures):
    """Bin + rasterize + shade an already-built setup buffer."""
    from scx.ops import raster as raster_ops
    from scx.ops import raster_clusters as rc

    if params.use_clusters:
        cl_aabb, cl_valid, cl_zmin = rc.cluster_bounds(
            aabb, valid, params.max_tris, setup
        )
        c_aabb, c_valid, c_zmin, order, cl_dropped = rc.compact_clusters(
            cl_aabb, cl_valid, cl_zmin
        )
        zsort = c_zmin if params.sort_draws else None
        cl_ids, cl_counts = rc.bin_clusters(
            c_aabb, c_valid, params, params.max_clusters_per_tile,
            cl_zmin=zsort,
        )
        cl_ids = order[cl_ids]  # back to original cluster ids
        # the kernel's hierarchical-z exit is exact only on near-to-far lists
        gbuffer = rc.rasterize_clusters(
            setup, cl_ids, cl_counts, params, params.max_clusters_per_tile,
            cl_zmin=cl_zmin if params.sort_draws else None,
        )
        occupancy = cl_counts
        overflow_cap = params.max_clusters_per_tile
        cluster_drop = cl_dropped
    else:
        binned, counts = bin_triangles(setup, aabb, valid, params)
        gbuffer = raster_ops.rasterize_tiles(binned, params, counts)
        occupancy = counts
        overflow_cap = params.max_tris_per_tile
        cluster_drop = jnp.int32(0)
    rgb = shade(gbuffer, materials, textures)
    stats = {
        "tris_in": jnp.sum(valid.astype(jnp.int32)),
        "max_tile_occupancy": jnp.max(occupancy),
        "tile_overflow": jnp.sum((occupancy >= overflow_cap).astype(jnp.int32)),
        # live clusters truncated by compact_clusters' cap (c//2): geometry
        # loss if ever nonzero — counted, never silent
        "cluster_drop": cluster_drop,
    }
    return rgb, gbuffer, stats

"""On-device culling + draw-list emission.

The reference's CullingSystem runs a parallel-for sphere-vs-frustum test over
all entities (sc_world_partition.cpp:1240-1271) and RenderPrep emits
DrawItems for visible entities under a max-draws budget
(sc_world_partition.cpp:1286-1359).  Here both are single fused array ops —
the parallel-for IS the array.

Shape note: all per-entity matrix math runs in COLUMN form — one [N]
array per world-matrix entry instead of [N,4,4] tensors, whose tiny minor
dims make every access strided (quat_to_mat3's [N,3,3] likewise); with
12 affine columns the entity axis is the minor axis.  The [N,4,4] tensor is
assembled exactly once at the end (the DrawList/raster interface), not
threaded through the math.
"""

from __future__ import annotations

import jax.numpy as jnp

from scx.core import math3d as m3
from scx.render.pipeline import DrawList
from scx.state.entity import EntityState


def _local_trs_cols(state: EntityState):
    """12 affine world-matrix columns m[i][j] (row-major, column-vector
    convention: T @ R(q) @ S like m3.mat4_trs_quat) as [N] arrays."""
    t = state.transform
    px, py, pz = t.pos[:, 0], t.pos[:, 1], t.pos[:, 2]
    qw, qx, qy, qz = t.rot[:, 0], t.rot[:, 1], t.rot[:, 2], t.rot[:, 3]
    sx, sy, sz = t.scale[:, 0], t.scale[:, 1], t.scale[:, 2]
    xx, yy, zz = qx * qx, qy * qy, qz * qz
    xy, xz, yz = qx * qy, qx * qz, qy * qz
    wx, wy, wz = qw * qx, qw * qy, qw * qz
    return (
        (1 - 2 * (yy + zz)) * sx, 2 * (xy - wz) * sy, 2 * (xz + wy) * sz, px,
        2 * (xy + wz) * sx, (1 - 2 * (xx + zz)) * sy, 2 * (yz - wx) * sz, py,
        2 * (xz - wy) * sx, 2 * (yz + wx) * sy, (1 - 2 * (xx + yy)) * sz, pz,
    )


def _compose_cols(a, b):
    """Affine compose C = A @ B on 12-column tuples."""
    a00, a01, a02, a03, a10, a11, a12, a13, a20, a21, a22, a23 = a
    b00, b01, b02, b03, b10, b11, b12, b13, b20, b21, b22, b23 = b
    return (
        a00 * b00 + a01 * b10 + a02 * b20,
        a00 * b01 + a01 * b11 + a02 * b21,
        a00 * b02 + a01 * b12 + a02 * b22,
        a00 * b03 + a01 * b13 + a02 * b23 + a03,
        a10 * b00 + a11 * b10 + a12 * b20,
        a10 * b01 + a11 * b11 + a12 * b21,
        a10 * b02 + a11 * b12 + a12 * b22,
        a10 * b03 + a11 * b13 + a12 * b23 + a13,
        a20 * b00 + a21 * b10 + a22 * b20,
        a20 * b01 + a21 * b11 + a22 * b21,
        a20 * b02 + a21 * b12 + a22 * b22,
        a20 * b03 + a21 * b13 + a22 * b23 + a23,
    )


def world_matrix_cols(state: EntityState):
    """Per-entity world matrix as 12 affine columns (see module note).

    Hierarchy resolution by pointer jumping: K gather passes support chains
    of depth 2^K (the reference walks arbitrary depth with dirty flags,
    sc_ecs.cpp:118-211; city content is shallow, K=3 covers 8)."""
    cols = _local_trs_cols(state)
    anc = state.transform.parent  # 2^k-th ancestor (or -1)
    for _ in range(3):
        has = anc >= 0
        safe = jnp.maximum(anc, 0)
        parent = tuple(c[safe] for c in cols)
        composed = _compose_cols(parent, cols)
        cols = tuple(jnp.where(has, c2, c1) for c1, c2 in zip(cols, composed))
        anc = jnp.where(has, anc[safe], -1)  # ancestor doubling
    return cols


def assemble_mat4(cols):
    """12 affine columns -> [N,4,4] (the DrawList/raster interface)."""
    n = cols[0].shape[0]
    zero = jnp.zeros_like(cols[0])
    one = jnp.ones_like(cols[0])
    return jnp.stack(list(cols) + [zero, zero, zero, one], axis=-1).reshape(
        n, 4, 4
    )


def world_matrices(state: EntityState):
    """Per-entity world matrix from TRS (flat hierarchy fast path; parented
    transforms resolved by one gather pass per level)."""
    return assemble_mat4(world_matrix_cols(state))


def cull_entities(state: EntityState, view_proj, freeze_planes=None):
    """Visibility mask via world bounding sphere vs frustum
    (Gribb-Hartmann planes). freeze_planes: debug frozen-culling frustum
    (sc_world_partition.cpp:1227-1233)."""
    planes = (
        freeze_planes
        if freeze_planes is not None
        else m3.frustum_from_view_proj(view_proj)
    )
    cols = world_matrix_cols(state)
    (m00, m01, m02, m03, m10, m11, m12, m13, m20, m21, m22, m23) = cols

    # world bounding sphere in columns (sc_world_partition.cpp:1119-1144)
    bmin, bmax = state.render.aabb_min, state.render.aabb_max
    clx = 0.5 * (bmin[:, 0] + bmax[:, 0])
    cly = 0.5 * (bmin[:, 1] + bmax[:, 1])
    clz = 0.5 * (bmin[:, 2] + bmax[:, 2])
    ex = 0.5 * (bmax[:, 0] - bmin[:, 0])
    ey = 0.5 * (bmax[:, 1] - bmin[:, 1])
    ez = 0.5 * (bmax[:, 2] - bmin[:, 2])
    cwx = m00 * clx + m01 * cly + m02 * clz + m03
    cwy = m10 * clx + m11 * cly + m12 * clz + m13
    cwz = m20 * clx + m21 * cly + m22 * clz + m23
    # per-local-axis scale = basis column norms
    c0 = m00 * m00 + m10 * m10 + m20 * m20
    c1 = m01 * m01 + m11 * m11 + m21 * m21
    c2 = m02 * m02 + m12 * m12 + m22 * m22
    radius = jnp.sqrt(ex * ex * c0 + ey * ey * c1 + ez * ez * c2)

    vis = jnp.ones_like(cwx, dtype=bool)
    for k in range(6):  # static 6-plane loop, scalar coefficients
        p = planes[k]
        vis &= p[0] * cwx + p[1] * cwy + p[2] * cwz + p[3] >= -radius

    renderable = state.alive & (state.render.mesh_id >= 0)
    return vis & renderable, assemble_mat4(cols)


def emit_draws(state: EntityState, visible, mats, max_draws: int) -> DrawList:
    """Visible entities -> fixed-capacity DrawList (maxDraws budget,
    sc_world_partition.h:311). Deterministic lowest-slot-first selection."""
    n = state.capacity
    idx = jnp.arange(n, dtype=jnp.int32)
    key = jnp.where(visible, idx, n)
    order = jnp.sort(key)[:max_draws]
    ok = order < n
    sel = jnp.minimum(order, n - 1)
    return DrawList(
        mesh_id=jnp.where(ok, state.render.mesh_id[sel], 0),
        material_id=jnp.where(ok, state.render.material_id[sel], 0),
        model=mats[sel],
        valid=ok,
    )

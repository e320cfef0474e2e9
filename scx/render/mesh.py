"""Baked mesh pool: device-array replacement for the Vulkan vertex/index
buffers.

The reference creates GPU meshes through VkRenderer::createMesh with
MeshVertex{pos, color, uv} (sc_vk.h:27-32) and ships built-in triangle/cube
meshes with bounds (sc_vk.cpp:1196-1342).  Here all meshes live concatenated
in one vertex/triangle pool so a whole frame's geometry expansion is a single
gather — no per-mesh buffers, no binds.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from scx.core import struct

MESH_CUBE = 0
MESH_TRIANGLE = 1

VERT_F = 8  # pos(3) + color(3) + uv(2)


@struct.dataclass
class MeshPool:
    verts: jax.Array        # [V, 8] f32: pos xyz, color rgb, uv
    tris: jax.Array         # [T, 3] i32 pool-global vertex indices
    mesh_first_tri: jax.Array  # [M] i32
    mesh_tri_count: jax.Array  # [M] i32
    mesh_bounds_min: jax.Array # [M,3]
    mesh_bounds_max: jax.Array # [M,3]
    # per-TRIANGLE packed vertex rows [T, 24] (3 verts x 8 fields): the
    # frame setup gathers ONE row per triangle instead of tris + 3 vertex
    # rows (5 -> 2 gathers per expanded triangle, the largest render-prep
    # cost at RL fleet sizes)
    tri_vert_rows: jax.Array   # [T, 24] f32

    @property
    def num_meshes(self) -> int:
        return self.mesh_first_tri.shape[0]


def builtin_cube():
    """Unit cube (half extent 0.5) with per-face colors, 24 verts / 12 tris
    (the reference's built-in cube, sc_vk.cpp:1243-1342)."""
    faces = [
        # normal axis, sign, color
        (0, +1, (0.9, 0.3, 0.3)),
        (0, -1, (0.6, 0.2, 0.2)),
        (1, +1, (0.3, 0.9, 0.3)),
        (1, -1, (0.2, 0.6, 0.2)),
        (2, +1, (0.3, 0.3, 0.9)),
        (2, -1, (0.2, 0.2, 0.6)),
    ]
    verts = []
    tris = []
    for axis, sign, color in faces:
        u_axis = (axis + 1) % 3
        v_axis = (axis + 2) % 3
        base = len(verts)
        for du, dv, uu, vv in ((-1, -1, 0, 0), (1, -1, 1, 0), (1, 1, 1, 1), (-1, 1, 0, 1)):
            p = [0.0, 0.0, 0.0]
            p[axis] = 0.5 * sign
            p[u_axis] = 0.5 * du
            p[v_axis] = 0.5 * dv
            verts.append(p + list(color) + [float(uu), float(vv)])
        if sign > 0:
            tris += [[base, base + 1, base + 2], [base, base + 2, base + 3]]
        else:
            tris += [[base, base + 2, base + 1], [base, base + 3, base + 2]]
    return np.asarray(verts, np.float32), np.asarray(tris, np.int32)


def builtin_triangle():
    """RGB test triangle (sc_vk.cpp:1196-1215 analogue)."""
    verts = np.asarray(
        [
            [0.0, 0.5, 0.0, 1.0, 0.2, 0.2, 0.5, 1.0],
            [0.5, -0.5, 0.0, 0.2, 1.0, 0.2, 1.0, 0.0],
            [-0.5, -0.5, 0.0, 0.2, 0.2, 1.0, 0.0, 0.0],
        ],
        np.float32,
    )
    tris = np.asarray([[0, 1, 2]], np.int32)
    return verts, tris


def build_mesh_pool(meshes=None) -> MeshPool:
    """Concatenate (verts[Vi,8], tris[Ti,3]) pairs into one pool.

    Defaults to the built-in [cube, triangle] so MESH_CUBE/MESH_TRIANGLE ids
    line up with the streaming system's procedural content.
    """
    if meshes is None:
        meshes = [builtin_cube(), builtin_triangle()]
    all_v, all_t = [], []
    first, count, bmin, bmax = [], [], [], []
    v_off = 0
    t_off = 0
    for verts, tris in meshes:
        all_v.append(verts)
        all_t.append(tris + v_off)
        first.append(t_off)
        count.append(len(tris))
        bmin.append(verts[:, 0:3].min(axis=0))
        bmax.append(verts[:, 0:3].max(axis=0))
        v_off += len(verts)
        t_off += len(tris)
    verts_np = np.concatenate(all_v, axis=0)
    tris_np = np.concatenate(all_t, axis=0)
    pool = MeshPool(
        verts=jnp.asarray(verts_np),
        tris=jnp.asarray(tris_np),
        mesh_first_tri=jnp.asarray(first, jnp.int32),
        mesh_tri_count=jnp.asarray(count, jnp.int32),
        mesh_bounds_min=jnp.asarray(np.stack(bmin)),
        mesh_bounds_max=jnp.asarray(np.stack(bmax)),
        tri_vert_rows=jnp.asarray(
            verts_np[tris_np].reshape(len(tris_np), 24)
        ),
    )
    from scx.core import memtrack

    memtrack.track_array(
        memtrack.TAG_RENDERER, pool, f"MeshPool[{len(meshes)} meshes]"
    )
    return pool

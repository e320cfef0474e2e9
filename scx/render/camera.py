"""Camera: view-projection construction matching the reference CameraSystem.

The reference builds viewProj from the active camera's world transform +
perspective_rh_zo with Vulkan Y-flip (sc_ecs.cpp:213-272, sc_math.cpp:209-232).
"""

from __future__ import annotations

import jax.numpy as jnp
from scx.core import struct

from scx.core import math3d as m3


@struct.dataclass
class CameraParams:
    fov_y_deg: float = struct.field(pytree_node=False, default=60.0)
    near_z: float = struct.field(pytree_node=False, default=0.1)
    far_z: float = struct.field(pytree_node=False, default=1000.0)
    flip_y: bool = struct.field(pytree_node=False, default=True)


def camera_view_proj(
    eye, target, up, aspect, params: CameraParams = CameraParams(), fov_y_deg=None
):
    """fov_y_deg may be a traced scalar (dynamic FOV); defaults to params."""
    view = m3.mat4_look_at_rh(eye, target, up)
    fov = params.fov_y_deg if fov_y_deg is None else fov_y_deg
    proj = m3.mat4_perspective_rh_zo(
        jnp.radians(fov), aspect, params.near_z, params.far_z,
        flip_y=params.flip_y,
    )
    return m3.mat4_mul(proj, view)


def camera_view_proj_from_pose(pos, quat, aspect, params: CameraParams = CameraParams()):
    """viewProj from a camera world pose (camera looks down -Z of its frame,
    matching the reference's convention)."""
    r3 = m3.quat_to_mat3(quat)
    view = jnp.eye(4)
    rt = r3.T
    view = view.at[0:3, 0:3].set(rt)
    view = view.at[0:3, 3].set(-jnp.matmul(rt, pos, precision=m3.PRECISION))
    proj = m3.mat4_perspective_rh_zo(
        jnp.radians(params.fov_y_deg), aspect, params.near_z, params.far_z,
        flip_y=params.flip_y,
    )
    return m3.mat4_mul(proj, view)

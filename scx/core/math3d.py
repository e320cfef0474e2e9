"""3D math for the engine: vectors, quaternions, 4x4 matrices.

Conventions match the reference engine's observable behaviour
(reference: src/core/src/sc_math.cpp):
  * Matrices are (...,4,4) arrays acting on COLUMN vectors: v' = M @ v.
    (The reference stores column-major flat arrays; the math is identical.)
  * Euler rotation order XYZ composed as Rz @ Ry @ Rx (sc_math.cpp:100-128).
  * TRS = T @ R @ S (sc_math.cpp:130-142).
  * Right-handed, zero-to-one depth perspective with optional Y flip
    (Vulkan convention; sc_math.cpp:209-232).

Rigid-body orientation uses unit quaternions (w,x,y,z) rather than Euler
matrices — idiomatic for the batched physics integrator — with converters to
and from the reference's Euler representation.

All functions are jnp-traceable and broadcast over leading batch dims.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

EPSILON = 1e-6

# Default-precision f32 products may run in reduced precision (TF32 on
# the GPU's tensor cores); transform math and the one-hot gathers need
# true f32. Every product in the engine states this precision.
PRECISION = jax.lax.Precision.HIGHEST


# ---------------------------------------------------------------------------
# Vectors
# ---------------------------------------------------------------------------

def dot(a, b, axis=-1, keepdims=False):
    return jnp.sum(a * b, axis=axis, keepdims=keepdims)


def cross(a, b):
    return jnp.cross(a, b)


def norm(v, axis=-1, keepdims=False):
    return jnp.sqrt(jnp.maximum(dot(v, v, axis=axis, keepdims=keepdims), 0.0))


def normalize(v, axis=-1, eps=EPSILON):
    n = norm(v, axis=axis, keepdims=True)
    return v / jnp.maximum(n, eps)


def safe_normalize(v, fallback=None, axis=-1, eps=EPSILON):
    """Normalize; rows with ~zero length become `fallback` (default zeros)."""
    n = norm(v, axis=axis, keepdims=True)
    ok = n > eps
    unit = v / jnp.where(ok, n, 1.0)
    if fallback is None:
        fallback = jnp.zeros_like(v)
    return jnp.where(ok, unit, fallback)


# ---------------------------------------------------------------------------
# Quaternions (w, x, y, z)
# ---------------------------------------------------------------------------

def quat_identity(shape=()):
    q = jnp.zeros(shape + (4,))
    return q.at[..., 0].set(1.0)


def quat_mul(a, b):
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return jnp.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        axis=-1,
    )


def quat_conj(q):
    return q * jnp.asarray([1.0, -1.0, -1.0, -1.0], q.dtype)


def quat_normalize(q):
    return q / jnp.maximum(norm(q, keepdims=True), EPSILON)


def quat_rotate(q, v):
    """Rotate vector(s) v by unit quaternion(s) q."""
    qv = q[..., 1:4]
    w = q[..., 0:1]
    t = 2.0 * jnp.cross(qv, v)
    return v + w * t + jnp.cross(qv, t)


def quat_from_axis_angle(axis, angle):
    half = 0.5 * jnp.asarray(angle)
    s = jnp.sin(half)
    axis = jnp.asarray(axis)
    return jnp.concatenate(
        [jnp.cos(half)[..., None], axis * s[..., None]], axis=-1
    )


def quat_from_euler_xyz(rx, ry, rz):
    """Quaternion equal to the reference rotation Rz @ Ry @ Rx."""
    qx = quat_from_axis_angle(jnp.asarray([1.0, 0.0, 0.0]), rx)
    qy = quat_from_axis_angle(jnp.asarray([0.0, 1.0, 0.0]), ry)
    qz = quat_from_axis_angle(jnp.asarray([0.0, 0.0, 1.0]), rz)
    return quat_mul(qz, quat_mul(qy, qx))


def quat_to_mat3(q):
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = jnp.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        axis=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def quat_to_euler_xyz(q):
    """Inverse of quat_from_euler_xyz (Rz@Ry@Rx decomposition).

    Matches the reference's eulerFromQuat readback used for telemetry
    (sc_physics.cpp eulerFromQuat).
    """
    m = quat_to_mat3(q)
    # R = Rz Ry Rx  =>  m[0,2] = sin(ry) ... standard ZYX-from-matrix
    sy = jnp.clip(-m[..., 2, 0], -1.0, 1.0)
    ry = jnp.arcsin(sy)
    rx = jnp.arctan2(m[..., 2, 1], m[..., 2, 2])
    rz = jnp.arctan2(m[..., 1, 0], m[..., 0, 0])
    return jnp.stack([rx, ry, rz], axis=-1)


def quat_integrate(q, omega, dt):
    """Integrate unit quaternion by angular velocity omega (world frame)."""
    wq = jnp.concatenate([jnp.zeros_like(omega[..., :1]), omega], axis=-1)
    dq = 0.5 * quat_mul(wq, q)
    return quat_normalize(q + dq * dt)


# ---------------------------------------------------------------------------
# 4x4 matrices
# ---------------------------------------------------------------------------

def mat4_identity(shape=()):
    return jnp.broadcast_to(jnp.eye(4), shape + (4, 4))


def mat4_mul(a, b):
    return jnp.matmul(a, b, precision=PRECISION)


def mat4_translation(t):
    t = jnp.asarray(t)
    m = jnp.broadcast_to(jnp.eye(4, dtype=t.dtype), t.shape[:-1] + (4, 4))
    return m.at[..., 0:3, 3].set(t)


def mat4_scale(s):
    s = jnp.asarray(s)
    m = jnp.zeros(s.shape[:-1] + (4, 4), s.dtype)
    m = m.at[..., 0, 0].set(s[..., 0])
    m = m.at[..., 1, 1].set(s[..., 1])
    m = m.at[..., 2, 2].set(s[..., 2])
    return m.at[..., 3, 3].set(1.0)


def mat4_rotation_xyz(rot):
    """Euler XYZ rotation = Rz @ Ry @ Rx (reference sc_math.cpp:100-128)."""
    rot = jnp.asarray(rot)
    q = quat_from_euler_xyz(rot[..., 0], rot[..., 1], rot[..., 2])
    return mat4_from_mat3(quat_to_mat3(q))


def mat4_from_mat3(r3):
    shape = r3.shape[:-2]
    m = jnp.zeros(shape + (4, 4), r3.dtype)
    m = m.at[..., 0:3, 0:3].set(r3)
    return m.at[..., 3, 3].set(1.0)


def mat4_trs(pos, rot_euler, scale):
    """T @ R @ S (reference sc_math.cpp:130-142)."""
    return mat4_mul(mat4_translation(pos), mat4_mul(mat4_rotation_xyz(rot_euler), mat4_scale(scale)))


def mat4_trs_quat(pos, quat, scale):
    """T @ R(q) @ S — the quaternion-native fast path."""
    r3 = quat_to_mat3(quat)
    rs = r3 * scale[..., None, :]
    m = jnp.zeros(pos.shape[:-1] + (4, 4), pos.dtype)
    m = m.at[..., 0:3, 0:3].set(rs)
    m = m.at[..., 0:3, 3].set(pos)
    return m.at[..., 3, 3].set(1.0)


def mat4_inverse(m):
    return jnp.linalg.inv(m)


def mat4_inverse_rigid(m):
    """Fast inverse for rigid (rotation+translation, no scale) transforms."""
    r = m[..., 0:3, 0:3]
    t = m[..., 0:3, 3]
    rt = jnp.swapaxes(r, -1, -2)
    out = jnp.zeros_like(m)
    out = out.at[..., 0:3, 0:3].set(rt)
    out = out.at[..., 0:3, 3].set(-jnp.einsum("...ij,...j->...i", rt, t, precision=PRECISION))
    return out.at[..., 3, 3].set(1.0)


def mat4_perspective_rh_zo(fovy, aspect, z_near, z_far, flip_y=True):
    """Right-handed, depth 0..1, optional Vulkan Y flip (sc_math.cpp:209-232)."""
    f = 1.0 / jnp.tan(fovy * 0.5)
    m = jnp.zeros((4, 4))
    m = m.at[0, 0].set(f / aspect)
    m = m.at[1, 1].set(jnp.where(flip_y, -f, f))
    m = m.at[2, 2].set(z_far / (z_near - z_far))
    m = m.at[2, 3].set((z_far * z_near) / (z_near - z_far))
    return m.at[3, 2].set(-1.0)


def mat4_look_at_rh(eye, target, up):
    eye = jnp.asarray(eye, jnp.float32)
    fwd = normalize(jnp.asarray(target, jnp.float32) - eye)
    right = normalize(jnp.cross(fwd, jnp.asarray(up, jnp.float32)))
    true_up = jnp.cross(right, fwd)
    m = jnp.eye(4)
    m = m.at[0, 0:3].set(right)
    m = m.at[1, 0:3].set(true_up)
    m = m.at[2, 0:3].set(-fwd)
    m = m.at[0, 3].set(-dot(right, eye))
    m = m.at[1, 3].set(-dot(true_up, eye))
    m = m.at[2, 3].set(dot(fwd, eye))
    return m


def transform_point(m, p):
    """Apply (...,4,4) to (...,3) points (w=1), perspective divide skipped."""
    ph = jnp.concatenate([p, jnp.ones_like(p[..., :1])], axis=-1)
    out = jnp.einsum("...ij,...j->...i", m, ph, precision=PRECISION)
    return out[..., 0:3]


def transform_point_h(m, p):
    """Apply matrix and return full homogeneous (...,4)."""
    ph = jnp.concatenate([p, jnp.ones_like(p[..., :1])], axis=-1)
    return jnp.einsum("...ij,...j->...i", m, ph, precision=PRECISION)


def transform_dir(m, d):
    return jnp.einsum("...ij,...j->...i", m[..., 0:3, 0:3], d, precision=PRECISION)


# ---------------------------------------------------------------------------
# Frustum (Gribb-Hartmann plane extraction, reference
# sc_world_partition.cpp:1071-1103)
# ---------------------------------------------------------------------------

def frustum_from_view_proj(vp):
    """Six planes (nx,ny,nz,d), inward-facing, normalized, from viewProj.

    Row convention: vp acts on column vectors. Planes: left, right, bottom,
    top, near, far. A point p is inside when dot(n,p)+d >= 0 for all planes.
    """
    r0, r1, r2, r3 = vp[..., 0, :], vp[..., 1, :], vp[..., 2, :], vp[..., 3, :]
    planes = jnp.stack(
        [
            r3 + r0,  # left
            r3 - r0,  # right
            r3 + r1,  # bottom
            r3 - r1,  # top
            r2,       # near (z >= 0 in zero-to-one depth)
            r3 - r2,  # far
        ],
        axis=-2,
    )
    n = norm(planes[..., 0:3], keepdims=True)
    return planes / jnp.maximum(n, EPSILON)


def sphere_in_frustum(planes, center, radius):
    """True when the bounding sphere intersects the frustum
    (reference sc_world_partition.cpp:1105-1117)."""
    d = dot(planes[..., 0:3], center[..., None, :]) + planes[..., 3]
    return jnp.all(d >= -radius[..., None], axis=-1)


def world_bounding_sphere(aabb_min, aabb_max, world_mat):
    """World-space bounding sphere of a local AABB under an affine transform
    (reference sc_world_partition.cpp:1119-1144)."""
    center_l = 0.5 * (aabb_min + aabb_max)
    ext_l = 0.5 * (aabb_max - aabb_min)
    center_w = transform_point(world_mat, center_l)
    # row norms of the upper 3x3 give per-axis scale of the basis vectors
    basis = world_mat[..., 0:3, 0:3]
    sq = jnp.sum(basis * basis, axis=-1)  # (...,3) squared col-basis lengths? rows
    # scale of each local axis = column norms
    col_sq = jnp.sum(basis * basis, axis=-2)
    radius = norm(ext_l * jnp.sqrt(jnp.maximum(col_sq, 0.0)))
    del sq
    return center_w, radius

"""Rigid body SoA + integration.

This engine's replacement for the reference's Bullet wrapper
(reference: sc_physics.cpp:210-302 PhysicsWorld) — rigid state as flat arrays,
semi-implicit Euler integration, Bullet-compatible damping semantics
(vel *= (1-damping)^dt) and the same defaults (gravity -9.81, static bodies on
layer 2 / mask 1 by default per sc_physics.cpp:372-379).

Shapes (sc_physics.h:10-28): box (half extents), sphere (radius), capsule
(radius, half height of the cylindrical section), all Y-up in body frame.

All functions operate on one scene's arrays [N,...]; batching over scenes is
vmap/shard_map at the call site.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from scx.core import struct

from scx.core import math3d as m3

SHAPE_BOX = 0
SHAPE_SPHERE = 1
SHAPE_CAPSULE = 2

BODY_STATIC = 0
BODY_DYNAMIC = 1
BODY_KINEMATIC = 2


@struct.dataclass
class RigidBodies:
    """One scene of rigid bodies, fixed capacity N."""

    pos: jax.Array          # [N,3] COM position
    quat: jax.Array         # [N,4] orientation (w,x,y,z)
    vel: jax.Array          # [N,3] linear velocity
    omega: jax.Array        # [N,3] angular velocity (world)
    shape: jax.Array        # [N] i32 SHAPE_*
    size: jax.Array         # [N,3] box half-extents / (radius, half_height, _)
    inv_mass: jax.Array     # [N] 0 for static/kinematic
    inv_inertia: jax.Array  # [N,3] inverse body-frame diagonal inertia
    friction: jax.Array     # [N]
    restitution: jax.Array  # [N]
    lin_damping: jax.Array  # [N]
    ang_damping: jax.Array  # [N]
    layer: jax.Array        # [N] u32 collision layer bits
    mask: jax.Array         # [N] u32 collision mask
    active: jax.Array       # [N] bool — participates in sim
    shape_offset: jax.Array # [N,3] collider center relative to COM (body frame)
                            # — the COM-offset mechanism of sc_physics.cpp:168-189
    sleep_timer: jax.Array  # [N] f32 seconds below the deactivation thresholds
    trigger: jax.Array      # [N] bool — overlap events only, no collision
                            # response (sc_physics.cpp:372-379 trigger flag)

    @property
    def n(self) -> int:
        return self.pos.shape[0]


def shape_inertia_diag(shape, size, mass):
    """Body-frame diagonal inertia for box/sphere/capsule (standard formulas,
    matching what Bullet's calculateLocalInertia produces for these shapes)."""
    hx, hy, hz = size[..., 0], size[..., 1], size[..., 2]
    # box: m/3 * (hy^2+hz^2) etc (half-extent form of m/12 (h^2+d^2))
    box = (
        jnp.stack([hy * hy + hz * hz, hx * hx + hz * hz, hx * hx + hy * hy], -1)
        * (mass[..., None] / 3.0)
    )
    r = size[..., 0]
    sph = jnp.broadcast_to((0.4 * mass * r * r)[..., None], box.shape)
    # capsule (radius r, cylinder half-height h), axis = Y
    h = size[..., 1]
    m_ = mass
    # cylinder part + two hemispheres (standard closed form, small-term exact)
    cyl_m = m_ * (2 * h) / jnp.maximum(2 * h + 4.0 * r / 3.0, 1e-6)
    hemi_m = (m_ - cyl_m) * 0.5
    i_y = 0.5 * cyl_m * r * r + 2 * hemi_m * (0.4 * r * r)
    i_xz = (
        cyl_m * (r * r / 4.0 + h * h / 3.0)
        + 2 * hemi_m * (0.4 * r * r + h * h + 0.75 * h * r)
    )
    cap = jnp.stack([i_xz, i_y, i_xz], -1)
    shape_b = shape[..., None]
    return jnp.where(
        shape_b == SHAPE_BOX, box, jnp.where(shape_b == SHAPE_SPHERE, sph, cap)
    )


def make_bodies(
    pos,
    quat=None,
    vel=None,
    omega=None,
    shape=None,
    size=None,
    mass=None,
    body_type=None,
    friction=None,
    restitution=None,
    lin_damping=None,
    ang_damping=None,
    layer=None,
    mask=None,
    active=None,
    shape_offset=None,
    sleep_timer=None,
    trigger=None,
) -> RigidBodies:
    """Convenience constructor with reference defaults (sc_physics.h:37-45)."""
    n = pos.shape[0]
    f1 = lambda v: jnp.full((n,), v, jnp.float32)
    quat = m3.quat_identity((n,)) if quat is None else quat
    vel = jnp.zeros((n, 3)) if vel is None else vel
    omega = jnp.zeros((n, 3)) if omega is None else omega
    shape = jnp.zeros((n,), jnp.int32) if shape is None else shape
    size = jnp.full((n, 3), 0.5) if size is None else size
    mass = f1(1.0) if mass is None else mass
    body_type = (
        jnp.full((n,), BODY_DYNAMIC, jnp.int32) if body_type is None else body_type
    )
    dynamic = body_type == BODY_DYNAMIC
    inv_mass = jnp.where(dynamic & (mass > 0), 1.0 / jnp.maximum(mass, 1e-9), 0.0)
    inertia = shape_inertia_diag(shape, size, mass)
    inv_inertia = jnp.where(
        (dynamic & (mass > 0))[..., None], 1.0 / jnp.maximum(inertia, 1e-9), 0.0
    )
    # static bodies default to layer 2 mask 1 (sc_physics.cpp:372-379)
    default_layer = jnp.where(body_type == BODY_STATIC, 2, 1).astype(jnp.uint32)
    return RigidBodies(
        pos=pos.astype(jnp.float32),
        quat=quat.astype(jnp.float32),
        vel=vel.astype(jnp.float32),
        omega=omega.astype(jnp.float32),
        shape=shape.astype(jnp.int32),
        size=size.astype(jnp.float32),
        inv_mass=inv_mass.astype(jnp.float32),
        inv_inertia=inv_inertia.astype(jnp.float32),
        friction=f1(0.8) if friction is None else friction,
        restitution=f1(0.0) if restitution is None else restitution,
        lin_damping=f1(0.0) if lin_damping is None else lin_damping,
        ang_damping=f1(0.05) if ang_damping is None else ang_damping,
        layer=default_layer if layer is None else layer.astype(jnp.uint32),
        mask=(
            jnp.full((n,), 0xFFFFFFFF, jnp.uint32) if mask is None else mask.astype(jnp.uint32)
        ),
        active=jnp.ones((n,), jnp.bool_) if active is None else active,
        shape_offset=(
            jnp.zeros((n, 3), jnp.float32) if shape_offset is None else shape_offset.astype(jnp.float32)
        ),
        sleep_timer=(
            jnp.zeros((n,), jnp.float32) if sleep_timer is None else sleep_timer.astype(jnp.float32)
        ),
        trigger=(
            jnp.zeros((n,), jnp.bool_) if trigger is None else trigger.astype(jnp.bool_)
        ),
    )


def inv_inertia_world(bodies: RigidBodies):
    """World-frame inverse inertia tensor: R diag(I^-1) R^T, [N,3,3]."""
    r = m3.quat_to_mat3(bodies.quat)
    return jnp.einsum(
        "...ij,...j,...kj->...ik",
        r,
        bodies.inv_inertia,
        r,
        precision=m3.PRECISION,
    )


def shape_centers(bodies: RigidBodies):
    """World collider centers: pos + R @ shape_offset."""
    return bodies.pos + m3.quat_rotate(bodies.quat, bodies.shape_offset)


def body_aabbs(bodies: RigidBodies):
    """World AABBs per body (for the broadphase).

    Box: |R| @ half_extents; sphere: radius; capsule: rotated axis + radius.
    """
    r = m3.quat_to_mat3(bodies.quat)
    absr = jnp.abs(r)
    box_ext = jnp.einsum("...ij,...j->...i", absr, bodies.size, precision=m3.PRECISION)
    rad = bodies.size[..., 0]
    sph_ext = jnp.broadcast_to(rad[..., None], box_ext.shape)
    axis = jnp.abs(r[..., :, 1]) * bodies.size[..., 1:2]
    cap_ext = axis + rad[..., None]
    shape_b = bodies.shape[..., None]
    ext = jnp.where(
        shape_b == SHAPE_BOX,
        box_ext,
        jnp.where(shape_b == SHAPE_SPHERE, sph_ext, cap_ext),
    )
    center = shape_centers(bodies)
    return center - ext, center + ext


def integrate_velocities(bodies: RigidBodies, dt, gravity, ext_force=None, ext_torque=None):
    """Semi-implicit Euler velocity update + Bullet-style damping
    (vel *= (1-damping)^dt)."""
    dyn = ((bodies.inv_mass > 0) & bodies.active)[:, None]
    g = jnp.asarray([0.0, gravity, 0.0])
    vel = bodies.vel + jnp.where(dyn, g * dt, 0.0)
    omega = bodies.omega
    if ext_force is not None:
        vel = vel + jnp.where(dyn, ext_force * bodies.inv_mass[:, None] * dt, 0.0)
    if ext_torque is not None:
        iiw = inv_inertia_world(bodies)
        omega = omega + jnp.where(
            dyn,
            jnp.einsum("...ij,...j->...i", iiw, ext_torque, precision=m3.PRECISION) * dt,
            0.0,
        )
    lin_d = jnp.power(
        jnp.clip(1.0 - bodies.lin_damping, 0.0, 1.0), dt
    )[:, None]
    ang_d = jnp.power(
        jnp.clip(1.0 - bodies.ang_damping, 0.0, 1.0), dt
    )[:, None]
    return bodies.replace(vel=vel * lin_d, omega=omega * ang_d)


def integrate_positions(bodies: RigidBodies, dt):
    """x += v dt; q integrated from omega. Static/kinematic with zero vel
    stay put automatically."""
    moving = bodies.active & (
        (bodies.inv_mass > 0)
        | (jnp.sum(bodies.vel * bodies.vel + bodies.omega * bodies.omega, -1) > 0)
    )
    pos = bodies.pos + jnp.where(moving[:, None], bodies.vel * dt, 0.0)
    quat = m3.quat_integrate(bodies.quat, bodies.omega, dt)
    quat = jnp.where(moving[:, None], quat, bodies.quat)
    return bodies.replace(pos=pos, quat=quat)

"""Raycast vehicle — array port of the btRaycastVehicle semantics the
reference tunes against.

The reference wraps Bullet's raycast vehicle with specific constants and
update order that define the driving feel (sc_physics.cpp:845-968 wheel setup
+ control mapping incl. the handbrake 70% rear-slip reduction;
sc_vehicle.cpp:266-304 wheel placement from collider extents;
sc_vehicle.cpp:347-394 input smoothing / speed-based steer limit).  This
module reproduces that model as pure functions over the rigid-body arrays:

  * 4 wheel rays from chassis hardpoints along chassis -Y, length
    rest+radius, against the whole scene (closest hit, caster excluded);
  * suspension: spring (stiffness * compression * 1/cos(contact slope),
    clamped) minus damper (compression/relaxation split), scaled by chassis
    MASS like Bullet, applied as an impulse at the contact point;
  * tire friction: lateral bilateral-constraint impulse + longitudinal
    engine/brake impulse, clamped to the friction ellipse
    |F| <= frictionSlip * suspension_force * dt, rollInfluence scaling the
    lateral application height;
  * control mapping: front wheels steer+brake, rear wheels drive+brake+
    handbrake with slip reduction (sc_physics.cpp:943-966).

One call = one vehicle; vmap over the fleet.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from scx.core import struct

from scx.core import math3d as m3
from scx.physics.rigid import RigidBodies, inv_inertia_world
from scx.physics.queries import raycast


@struct.dataclass
class VehicleParams:
    """Static tuning (mirrors VehicleComponent, sc_ecs.h:113-134)."""

    mass: float = struct.field(pytree_node=False, default=1200.0)
    engine_force: float = struct.field(pytree_node=False, default=8000.0)
    max_speed: float = struct.field(pytree_node=False, default=45.0)
    brake_force: float = struct.field(pytree_node=False, default=12000.0)
    handbrake_force: float = struct.field(pytree_node=False, default=8000.0)
    max_steer: float = struct.field(pytree_node=False, default=0.55)
    steer_response: float = struct.field(pytree_node=False, default=6.0)
    susp_rest: float = struct.field(pytree_node=False, default=0.35)
    susp_stiffness: float = struct.field(pytree_node=False, default=20.0)
    damp_compression: float = struct.field(pytree_node=False, default=2.3)
    damp_relaxation: float = struct.field(pytree_node=False, default=4.4)
    wheel_radius: float = struct.field(pytree_node=False, default=0.35)
    wheel_width: float = struct.field(pytree_node=False, default=0.25)
    friction_slip: float = struct.field(pytree_node=False, default=1.2)
    roll_influence: float = struct.field(pytree_node=False, default=0.1)


@struct.dataclass
class VehicleTuning:
    """Per-vehicle tuning as traced scalars (or [V] columns before vmap).

    The reference tunes vehicles live per entity (updateVehicleTuning,
    sc_physics.cpp:970-1013 pushes VehicleComponent fields into the Bullet
    vehicle every frame).  Here the EntityState vehicle columns are the
    authoritative store; gather them per chassis with `tuning_gather` and
    vmap the result through `vehicle_forces`/`smooth_controls` — field
    names mirror `VehicleParams` so either works as `params`.
    """

    engine_force: jax.Array
    max_speed: jax.Array
    brake_force: jax.Array
    handbrake_force: jax.Array
    max_steer: jax.Array
    steer_response: jax.Array
    susp_rest: jax.Array
    susp_stiffness: jax.Array
    damp_compression: jax.Array
    damp_relaxation: jax.Array
    wheel_radius: jax.Array
    friction_slip: jax.Array
    roll_influence: jax.Array


def tuning_gather(vehicle_state, idx) -> VehicleTuning:
    """Gather the per-entity tuning columns at `idx` (any index shape)."""
    vs = vehicle_state
    return VehicleTuning(
        engine_force=vs.engine_force[idx],
        max_speed=vs.max_speed[idx],
        brake_force=vs.brake_force[idx],
        handbrake_force=vs.handbrake_force[idx],
        max_steer=vs.max_steer[idx],
        steer_response=vs.steer_response[idx],
        susp_rest=vs.susp_rest[idx],
        susp_stiffness=vs.susp_stiff[idx],
        damp_compression=vs.damp_comp[idx],
        damp_relaxation=vs.damp_relax[idx],
        wheel_radius=vs.wheel_radius[idx],
        friction_slip=vs.friction_slip[idx],
        roll_influence=vs.roll_influence[idx],
    )


def set_vehicle_tuning(state, idx, params: VehicleParams):
    """Write a VehicleParams preset into one entity's tuning columns —
    the live-tuning entry point (slider → updateVehicleTuning parity)."""
    vs = state.vehicle
    return state.replace(
        vehicle=vs.replace(
            mass=vs.mass.at[idx].set(params.mass),
            engine_force=vs.engine_force.at[idx].set(params.engine_force),
            max_speed=vs.max_speed.at[idx].set(params.max_speed),
            brake_force=vs.brake_force.at[idx].set(params.brake_force),
            handbrake_force=vs.handbrake_force.at[idx].set(params.handbrake_force),
            max_steer=vs.max_steer.at[idx].set(params.max_steer),
            steer_response=vs.steer_response.at[idx].set(params.steer_response),
            susp_rest=vs.susp_rest.at[idx].set(params.susp_rest),
            susp_stiff=vs.susp_stiff.at[idx].set(params.susp_stiffness),
            damp_comp=vs.damp_comp.at[idx].set(params.damp_compression),
            damp_relax=vs.damp_relax.at[idx].set(params.damp_relaxation),
            wheel_radius=vs.wheel_radius.at[idx].set(params.wheel_radius),
            friction_slip=vs.friction_slip.at[idx].set(params.friction_slip),
            roll_influence=vs.roll_influence.at[idx].set(params.roll_influence),
        )
    )


@struct.dataclass
class WheelConfig:
    """Per-wheel geometry, chassis-local relative to COM."""

    conn: jax.Array    # [4,3] connection points
    front: jax.Array   # [4] bool


def default_wheel_configs(
    half_extents,
    params: VehicleParams,
    traffic: bool = False,
    com_offset=(0.0, 0.0, 0.0),
):
    """Wheel hardpoints from collider extents (sc_vehicle.cpp:266-304),
    COM-relative with the reference's min clamps; com_offset is the
    visual-origin -> COM offset (VehicleComponent.centerOfMassOffset)."""
    hx = jnp.maximum(0.2, half_extents[0])
    hy = jnp.maximum(0.2, half_extents[1])
    hz = jnp.maximum(0.4, half_extents[2])
    wheel_x = hx - params.wheel_width * 0.5
    wheel_y = -hy + params.wheel_radius - (params.susp_rest if traffic else 0.0)
    front_z = hz - params.wheel_radius * 0.5
    rear_z = -hz + params.wheel_radius * 0.5
    com = jnp.asarray(com_offset)
    conn = jnp.asarray(
        [
            [-wheel_x, wheel_y, front_z],
            [wheel_x, wheel_y, front_z],
            [-wheel_x, wheel_y, rear_z],
            [wheel_x, wheel_y, rear_z],
        ]
    ) - com
    return WheelConfig(conn=conn, front=jnp.asarray([True, True, False, False]))


def smooth_exp(current, target, rate, dt):
    """Exponential input smoothing (sc_vehicle.cpp smoothExp)."""
    return current + (target - current) * (1.0 - jnp.exp(-rate * dt))


def smooth_controls(smoothed, raw, params: VehicleParams, speed_ms, dt):
    """Input shaping (sc_vehicle.cpp:365-394): exponential smoothing, squared
    response curves, speed-based steer limit, max-speed cutoffs.

    smoothed/raw: [...,4] = (throttle, brake, steer, handbrake).
    Returns (new_smoothed, engine_force, brake_force, steer_angle, hb_force).
    """
    tgt = jnp.stack(
        [
            jnp.clip(raw[..., 0], 0.0, 1.0),
            jnp.clip(raw[..., 1], 0.0, 1.0),
            jnp.clip(raw[..., 2], -1.0, 1.0),
            jnp.clip(raw[..., 3], 0.0, 1.0),
        ],
        -1,
    )
    rates = jnp.stack(
        [
            jnp.full_like(tgt[..., 0], 6.0),
            jnp.full_like(tgt[..., 0], 6.0),
            jnp.full_like(tgt[..., 0], jnp.maximum(1.0, params.steer_response)),
            jnp.full_like(tgt[..., 0], 10.0),
        ],
        -1,
    )
    sm = smooth_exp(smoothed, tgt, rates, dt)
    throttle = sm[..., 0] ** 2
    brake = sm[..., 1] ** 2
    handbrake = sm[..., 3] ** 2

    speed_ratio = jnp.clip(speed_ms / jnp.maximum(params.max_speed, 0.1), 0.0, 1.0)
    steer_limit = params.max_steer * (1.0 + (0.2 - 1.0) * speed_ratio)
    steer_angle = sm[..., 2] * steer_limit

    engine = throttle * params.engine_force
    brake_f = brake * params.brake_force
    over = speed_ms > params.max_speed
    engine = jnp.where(over, 0.0, engine)
    brake_f = jnp.where(
        speed_ms > params.max_speed * 1.05,
        jnp.maximum(brake_f, params.brake_force * 0.2),
        brake_f,
    )
    hb_force = handbrake * params.handbrake_force
    return sm, engine, brake_f, steer_angle, hb_force


@struct.dataclass
class WheelRuntime:
    susp_len: jax.Array       # [4]
    in_contact: jax.Array     # [4] bool
    contact_point: jax.Array  # [4,3]
    contact_normal: jax.Array # [4,3]
    wheel_pos: jax.Array      # [4,3] world wheel centers
    susp_force: jax.Array     # [4]
    fwd_impulse: jax.Array    # [4]
    side_impulse: jax.Array   # [4]


def vehicle_forces(
    bodies: RigidBodies,
    chassis: jax.Array,        # i32 body index
    wheels: WheelConfig,
    engine_force,
    brake_force,
    steer_angle,
    handbrake_force,
    params: VehicleParams,
    dt: float,
    iw_all=None,
):
    """One vehicle's suspension+tire impulses.

    Returns (d_vel, d_omega, WheelRuntime): chassis velocity deltas to be
    applied (scatter at call site so fleets can accumulate), and telemetry
    matching getVehicleTelemetry (sc_physics.cpp:1015-1058).

    iw_all: precomputed world inverse-inertia [N,3,3] — pass it when calling
    under vmap over a fleet, otherwise each lane recomputes the whole array.
    """
    pos = bodies.pos[chassis]
    quat = bodies.quat[chassis]
    vel = bodies.vel[chassis]
    omega = bodies.omega[chassis]
    inv_mass = bodies.inv_mass[chassis]
    chassis_mass = 1.0 / jnp.maximum(inv_mass, 1e-9)
    if iw_all is None:
        iw = inv_inertia_world(bodies)[chassis]
    elif iw_all.ndim == 2:
        iw = iw_all          # caller already gathered this chassis' [3,3]
    else:
        iw = iw_all[chassis]

    r3 = m3.quat_to_mat3(quat)
    down_w = -r3[:, 1]            # suspension direction (chassis -Y)
    up_w = r3[:, 1]

    # control mapping per wheel (sc_physics.cpp:925-968)
    hb_norm = jnp.where(
        handbrake_force > 0.0,
        jnp.minimum(1.0, handbrake_force / (handbrake_force + brake_force + 1.0)),
        0.0,
    )
    front = wheels.front
    w_steer = jnp.where(front, steer_angle, 0.0)
    w_engine = jnp.where(front, 0.0, engine_force)
    w_brake = jnp.where(front, brake_force, brake_force + handbrake_force)
    w_slip = jnp.where(
        front,
        params.friction_slip,
        params.friction_slip * (1.0 - hb_norm * 0.7),
    )

    rest = params.susp_rest
    radius = params.wheel_radius
    ray_len = rest + radius

    def per_wheel(conn, steer):
        hard = pos + jnp.matmul(r3, conn, precision=m3.PRECISION)
        # steering rotates the wheel basis about the suspension axis
        sq = m3.quat_from_axis_angle(up_w, steer)
        axle_w = m3.quat_rotate(
            sq, jnp.matmul(r3, jnp.asarray([-1.0, 0.0, 0.0]), precision=m3.PRECISION)
        )
        hit = raycast(bodies, hard, down_w, ray_len, exclude=chassis)
        return hard, axle_w, hit.t, hit.normal, hit.hit

    hard, axle_w, t, n, hit = jax.vmap(per_wheel)(wheels.conn, w_steer)
    in_contact = hit & (t <= ray_len)
    susp_len = jnp.clip(t - radius, 0.0, rest)
    susp_len = jnp.where(in_contact, susp_len, rest)
    contact = hard + down_w[None, :] * t[:, None]
    wheel_pos = hard + down_w[None, :] * susp_len[:, None]

    # --- suspension (btRaycastVehicle::updateSuspension semantics) ---
    denom = m3.dot(n, up_w[None, :])
    inv_proj = 1.0 / jnp.maximum(denom, 0.1)
    compression = rest - susp_len
    spring = params.susp_stiffness * compression * inv_proj

    r_c = contact - pos
    vel_at = vel[None, :] + jnp.cross(omega[None, :], r_c)
    proj_vel = m3.dot(n, vel_at)
    susp_rel_vel = proj_vel * inv_proj
    damp_rate = jnp.where(
        susp_rel_vel < 0.0, params.damp_compression, params.damp_relaxation
    )
    force = (spring - damp_rate * susp_rel_vel) * chassis_mass
    susp_force = jnp.where(in_contact, jnp.maximum(force, 0.0), 0.0)
    susp_impulse = n * (susp_force * dt)[:, None]

    # --- tire friction (updateFriction semantics) ---
    # project axle onto contact plane -> side dir; forward = cross(n, axle)
    axle_p = axle_w - n * m3.dot(axle_w, n, keepdims=True)
    side = m3.safe_normalize(axle_p, axle_w)
    fwd = jnp.cross(n, side)

    def eff_mass_at(d, r):
        ang = jnp.cross(
            jnp.einsum("ij,...j->...i", iw, jnp.cross(r, d), precision=m3.PRECISION), r
        )
        return 1.0 / jnp.maximum(inv_mass + m3.dot(d, ang), 1e-9)

    vel_c = vel[None, :] + jnp.cross(omega[None, :], r_c)
    v_side = m3.dot(vel_c, side)
    v_fwd = m3.dot(vel_c, fwd)

    side_imp = -v_side * jax.vmap(eff_mass_at)(side, r_c)

    drive_imp = w_engine * dt
    brake_max = w_brake * dt
    stop_imp = -v_fwd * jax.vmap(eff_mass_at)(fwd, r_c)
    brake_imp = jnp.clip(stop_imp, -brake_max, brake_max)
    fwd_imp = drive_imp + jnp.where(w_brake > 0.0, brake_imp, 0.0)

    max_imp = w_slip * susp_force * dt
    mag = jnp.sqrt(fwd_imp**2 + side_imp**2)
    scale = jnp.where(mag > max_imp, max_imp / jnp.maximum(mag, 1e-9), 1.0)
    fwd_imp = jnp.where(in_contact, fwd_imp * scale, 0.0)
    side_imp = jnp.where(in_contact, side_imp * scale, 0.0)

    # side impulse applied at reduced height (rollInfluence, sc_physics.cpp:881)
    chassis_y = m3.dot(r_c, up_w[None, :], keepdims=True)
    r_side = r_c + up_w[None, :] * (chassis_y * (params.roll_influence - 1.0))

    imp_total = susp_impulse + fwd[..., :] * fwd_imp[:, None]
    d_vel = jnp.sum(imp_total + side * side_imp[:, None], axis=0) * inv_mass
    torque = (
        jnp.cross(r_c, imp_total)
        + jnp.cross(r_side, side * side_imp[:, None])
    )
    d_omega = jnp.einsum(
        "ij,...j->...i", iw, jnp.sum(torque, axis=0), precision=m3.PRECISION
    )

    rt = WheelRuntime(
        susp_len=susp_len,
        in_contact=in_contact,
        contact_point=contact,
        contact_normal=n,
        wheel_pos=wheel_pos,
        susp_force=susp_force,
        fwd_impulse=fwd_imp,
        side_impulse=side_imp,
    )
    return d_vel, d_omega, rt


def vehicle_speed_ms(bodies: RigidBodies, chassis):
    """Signed forward speed (getCurrentSpeedKmHour/3.6 analogue,
    sc_physics.cpp:1036-1038)."""
    fwd = m3.quat_rotate(bodies.quat[chassis], jnp.asarray([0.0, 0.0, 1.0]))
    v = bodies.vel[chassis]
    return jnp.sign(m3.dot(v, fwd)) * m3.norm(v)

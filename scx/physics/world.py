"""Physics <-> entity-state bridge: the PhysicsSyncSystem equivalent.

The reference's PhysicsSyncSystem creates Bullet bodies for new
(RigidBody, Collider, Transform) entities, pushes kinematic targets, steps
the world and writes dynamic transforms back (sc_physics.cpp:1096-1190).
Here there is no body registry: entity slot == body slot, and the
"create/destroy" lifecycle is just the per-slot masks — a RigidBodies view
is assembled from the entity columns each step (free: XLA fuses it), stepped,
and written back.

Vehicles: entities with vehicle inputs get wheel-ray impulses applied before
the contact solve, mirroring VehicleSystemPreStep -> Bullet step ->
VehicleSystemPostStep ordering (sc_vehicle.cpp:165-434).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from scx.core import math3d as m3
from scx.physics.rigid import RigidBodies, shape_inertia_diag
from scx.physics.solver import SolverParams
from scx.physics.vehicle import (
    VehicleParams,
    WheelConfig,
    smooth_controls,
    tuning_gather,
    vehicle_forces,
    vehicle_speed_ms,
)
from scx.state.entity import (
    BODY_DYNAMIC,
    BODY_STATIC,
    C_VEHICLE,
    EntityState,
)

MAX_VEHICLES = 32  # fixed vehicle-slot capacity per scene


def empty_sync_cache(max_pairs: int):
    """The warm-start cache physics_sync_step threads across steps
    (plane-layout; scx.physics.planar.PlanarCache)."""
    from scx.physics.planar import empty_planar_cache

    return empty_planar_cache(max_pairs)


def bodies_from_state(state: EntityState) -> RigidBodies:
    """RigidBodies view over the entity columns (zero-copy in spirit —
    XLA fuses the element-wise assembly into the consumers)."""
    b = state.body
    active = state.alive & (b.body_type >= 0)
    dynamic = b.body_type == BODY_DYNAMIC
    inv_mass = jnp.where(active & dynamic & (b.mass > 0), 1.0 / jnp.maximum(b.mass, 1e-9), 0.0)
    inertia = shape_inertia_diag(b.shape, b.half_extents, b.mass)
    inv_inertia = jnp.where(
        (active & dynamic & (b.mass > 0))[:, None], 1.0 / jnp.maximum(inertia, 1e-9), 0.0
    )
    layer = jnp.where(
        b.body_type == BODY_STATIC, jnp.uint32(2), jnp.uint32(1)
    ) | b.layer * 0  # keep explicit layers when set
    layer = jnp.where(b.layer != 1, b.layer, layer)
    return RigidBodies(
        pos=state.transform.pos + m3.quat_rotate(state.transform.rot, b.com_offset),
        quat=state.transform.rot,
        vel=b.vel,
        omega=b.omega,
        shape=b.shape,
        size=b.half_extents,
        inv_mass=inv_mass,
        inv_inertia=inv_inertia,
        friction=b.friction,
        restitution=b.restitution,
        lin_damping=b.lin_damping,
        ang_damping=b.ang_damping,
        layer=layer,
        mask=b.mask,
        active=active,
        shape_offset=-b.com_offset,
        sleep_timer=b.sleep_timer,
        trigger=b.trigger,
    )


def write_back(state: EntityState, bodies: RigidBodies) -> EntityState:
    """Dynamic transforms from physics -> ECS with COM correction
    (the PhysicsSync/TrafficPhysicsSync writeback, sc_traffic_ai.cpp:494-585)."""
    dyn = bodies.active & (bodies.inv_mass > 0)
    visual_pos = bodies.pos - m3.quat_rotate(bodies.quat, state.body.com_offset)
    return state.replace(
        transform=state.transform.replace(
            pos=jnp.where(dyn[:, None], visual_pos, state.transform.pos),
            rot=jnp.where(dyn[:, None], bodies.quat, state.transform.rot),
        ),
        body=state.body.replace(
            vel=jnp.where(dyn[:, None], bodies.vel, state.body.vel),
            omega=jnp.where(dyn[:, None], bodies.omega, state.body.omega),
            sleep_timer=jnp.where(dyn, bodies.sleep_timer, state.body.sleep_timer),
        ),
    )


def vehicle_slots(state: EntityState, max_vehicles: int = MAX_VEHICLES):
    """Fixed-capacity list of vehicle entity indices (lowest-first).

    top_k on (n - idx) scores instead of a full batched sort: top_k of 32
    from a few hundred lanes is cheap."""
    n = state.capacity
    is_vehicle = state.alive & ((state.components & C_VEHICLE) != 0)
    idx = jnp.arange(n, dtype=jnp.int32)
    score = jnp.where(is_vehicle, n - idx, 0)  # highest score = lowest idx
    k = min(max_vehicles, n)
    vals, _ = jax.lax.top_k(score, k)
    slots = jnp.where(vals > 0, n - vals, n)
    if k < max_vehicles:
        slots = jnp.concatenate(
            [slots, jnp.full((max_vehicles - k,), n, slots.dtype)]
        )
    return slots, slots < n


def vehicle_prestep(
    state: EntityState, bodies: RigidBodies, dt, max_vehicles: int = MAX_VEHICLES
):
    """VehicleSystemPreStep equivalent on the compacted vehicle-slot set:
    smoothed controls, wheel-ray suspension/drive impulses into the body
    velocities, runtime columns written back (sc_vehicle.cpp:165-394).

    `max_vehicles` sizes the slot set (static): every wheel raycast scans
    all capacity boxes, so fleets with few vehicles (RL envs: traffic
    tier-A cap + player) right-size it instead of paying the 32-slot
    default. Returns (state, bodies, v_idx) — v_idx are the scatter
    targets (capacity = dropped lane) for downstream per-vehicle writes."""
    slots, valid = vehicle_slots(state, max_vehicles)
    from scx.physics.rigid import inv_inertia_world as _iiw

    # gather per-chassis inverse inertia BEFORE the vmap: a closed-over
    # [N,3,3] array indexed inside vmap lanes gets copy-materialized per
    # lane by XLA (42 GB at RL batch sizes)
    safe_slots = jnp.minimum(slots, state.capacity - 1)
    iw_chassis = _iiw(bodies)[safe_slots]
    tune = tuning_gather(state.vehicle, safe_slots)  # [V]-column pytree

    def one_vehicle(slot, ok, iw_c, tn):
        safe = jnp.minimum(slot, state.capacity - 1)  # gather index
        speed = vehicle_speed_ms(bodies, safe)
        sm, engine, brake, steer, hb = smooth_controls(
            state.vehicle.smoothed[safe], state.vehicle.input[safe], tn, speed, dt
        )
        wheels = WheelConfig(
            conn=state.vehicle.wheel_conn[safe],
            front=jnp.asarray([True, True, False, False]),
        )
        dv, dw, rt = vehicle_forces(
            bodies, safe, wheels, engine, brake, steer, hb, tn, dt,
            iw_all=iw_c,
        )
        z = jnp.where(ok, 1.0, 0.0)
        # scatter index: invalid slots write out of range (dropped), so they
        # can never collide with a real vehicle's update
        scatter = jnp.where(ok, safe, state.capacity)
        return scatter, dv * z, dw * z, sm, rt

    v_idx, v_dv, v_dw, v_sm, v_rt = jax.vmap(one_vehicle)(slots, valid, iw_chassis, tune)
    bodies = bodies.replace(
        vel=bodies.vel.at[v_idx].add(v_dv, mode="drop"),
        omega=bodies.omega.at[v_idx].add(v_dw, mode="drop"),
    )
    # persist smoothed controls + wheel runtime (invalid rows drop)
    state = state.replace(
        vehicle=state.vehicle.replace(
            smoothed=state.vehicle.smoothed.at[v_idx].set(v_sm, mode="drop"),
            susp_len=state.vehicle.susp_len.at[v_idx].set(v_rt.susp_len, mode="drop"),
            wheel_contact=state.vehicle.wheel_contact.at[v_idx].set(
                v_rt.in_contact, mode="drop"
            ),
        )
    )
    return state, bodies, v_idx


def physics_sync_step(
    state: EntityState,
    params: SolverParams,
    vparams: VehicleParams,
    dt,
    cache,
    max_vehicles: int = MAX_VEHICLES,
    key_id=None,
):
    """One fixed step: vehicle pre-step -> warm-started solver step ->
    write back. Returns (state, cache, stats).

    `cache` is the contact warm-start cache (scx.physics.warmstart),
    threaded across steps by the caller; `key_id` optionally keys it by a
    persistent identity column (e.g. state.uid) instead of row indices —
    required when rows reshuffle between steps (spatial-shard migration).
    `stats` surfaces pair/contact counts and capacity overflow. `vparams`
    supplies the static bits only (wheel_width for geometry helpers); the
    dynamic tuning each vehicle drives with comes from its own EntityState
    columns (per-entity live tuning, updateVehicleTuning parity —
    sc_physics.cpp:970-1013)."""
    del vparams  # per-entity tuning columns are authoritative
    from scx.physics.planar import (
        planar_from_rigid, rigid_from_planar, step_planar_cached,
    )

    bodies = bodies_from_state(state)
    state, bodies, v_idx = vehicle_prestep(state, bodies, dt, max_vehicles)

    # plane-layout solver core (scx.physics.planar: no 3-wide minor dims
    # on materialized arrays under an env vmap); the layout conversions
    # are [N]-level elementwise and fuse into the consumers.
    # `cache` is a PlanarCache (scx.physics.planar.empty_planar_cache).
    pb, cache, pstats = step_planar_cached(
        planar_from_rigid(bodies), params, cache, key_id
    )
    bodies = rigid_from_planar(pb)
    state = write_back(state, bodies)

    # record vehicle speeds into traffic.speed for the AI's P-control
    speeds = jax.vmap(lambda i: vehicle_speed_ms(bodies, jnp.minimum(i, state.capacity - 1)))(v_idx)
    tr_speed = state.traffic.speed.at[v_idx].set(speeds, mode="drop")
    state = state.replace(traffic=state.traffic.replace(speed=tr_speed))
    return state, cache, pstats

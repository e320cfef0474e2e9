"""Struct-of-arrays entity state — the functional mirror of the reference ECS.

The reference uses generational entity IDs + sparse-set component pools
(reference: sc_ecs.h:14-34, 199-277).  Here the same capability surface is a
fixed-capacity SoA pytree with an alive mask and per-slot generation counters:

  * create  -> claim the first free slot (masked argmin), bump nothing
  * destroy -> clear alive bit, bump generation (stale handles detectable)
  * ForEach<T...> -> masked vectorized ops over the whole arrays
  * component add/remove -> per-component presence masks

"Has component X" is a bitmask column instead of pool membership; iteration
order dependence of the reference's sparse sets is deliberately NOT reproduced
(systems here are whole-array data-parallel).

All arrays have leading dimension N (capacity). Batched scenes add a leading
ENV dim via vmap/shard_map — never stored here.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from scx.core import struct

# body types (sc_physics.h:30-35)
BODY_NONE = -1
BODY_STATIC = 0
BODY_DYNAMIC = 1
BODY_KINEMATIC = 2

# collider shapes (sc_physics.h:10-16)
SHAPE_BOX = 0
SHAPE_SPHERE = 1
SHAPE_CAPSULE = 2

# traffic sim modes (sc_traffic_common.h:11-16); NONE = not a traffic agent
TRAFFIC_NONE = -1
TRAFFIC_PHYSICS = 0
TRAFFIC_KINEMATIC = 1
TRAFFIC_ONRAILS = 2

# component presence bits (the reference's "pool membership")
C_TRANSFORM = 1 << 0
C_RENDER_MESH = 1 << 1
C_BOUNDS = 1 << 2
C_COLLIDER = 1 << 3
C_RIGID_BODY = 1 << 4
C_VEHICLE = 1 << 5
C_VEHICLE_INPUT = 1 << 6
C_PLAYER = 1 << 7
C_CAMERA = 1 << 8
C_WORLD_SECTOR = 1 << 9
C_TRAFFIC = 1 << 10


@struct.dataclass
class TransformState:
    """Transform component (sc_ecs.h:63-71) — quaternion-native."""

    pos: jax.Array        # [N,3] f32
    rot: jax.Array        # [N,4] f32 quaternion (w,x,y,z)
    scale: jax.Array      # [N,3] f32
    parent: jax.Array     # [N]   i32, -1 = root (hierarchy depth <= fixed K)


@struct.dataclass
class RenderState:
    """RenderMesh + Bounds (sc_ecs.h:107-111, sc_world_partition.h:292-301)."""

    mesh_id: jax.Array       # [N] i32 baked mesh slot
    material_id: jax.Array   # [N] i32 baked material slot
    aabb_min: jax.Array      # [N,3] f32 local bounds
    aabb_max: jax.Array      # [N,3] f32


@struct.dataclass
class BodyState:
    """Collider + RigidBody + dynamic state (sc_physics.h:19-45)."""

    body_type: jax.Array     # [N] i32 BODY_*
    shape: jax.Array         # [N] i32 SHAPE_*
    half_extents: jax.Array  # [N,3] f32 (box) / (radius, half_height, 0)
    layer: jax.Array         # [N] u32
    mask: jax.Array          # [N] u32
    trigger: jax.Array       # [N] bool
    mass: jax.Array          # [N] f32 (0 for static)
    friction: jax.Array      # [N] f32
    restitution: jax.Array   # [N] f32
    lin_damping: jax.Array   # [N] f32
    ang_damping: jax.Array   # [N] f32
    vel: jax.Array           # [N,3] f32
    omega: jax.Array         # [N,3] f32 world-frame angular velocity
    com_offset: jax.Array    # [N,3] f32 visual->COM offset (sc_physics.cpp:168-189)
    sleep_timer: jax.Array   # [N] f32 deactivation timer (Bullet sleeping)


@struct.dataclass
class TrafficState:
    """TrafficAgent + TrafficVehicle + TrafficSensors (sc_traffic_common.h:27-53)."""

    mode: jax.Array            # [N] i32 TRAFFIC_* (-1 = not traffic)
    lane_id: jax.Array         # [N] i32 (-1 invalid)
    lane_s: jax.Array          # [N] f32 arclength along lane
    target_speed: jax.Array    # [N] f32
    speed: jax.Array           # [N] f32 smoothed current speed (tier B/C)
    look_ahead: jax.Array      # [N] f32
    stuck_timer: jax.Array     # [N] f32
    sensor_hit_dist: jax.Array # [N] f32
    sensor_hit_type: jax.Array # [N] i32 TrafficHitType
    # lane-change cooldown: the reference declares the field but never
    # implements the behaviour (TrafficVehicle, sc_traffic_common.h:38-44);
    # here it gates the vectorized lane-change in scx.traffic.ai
    lane_cooldown: jax.Array   # [N] f32 seconds until next change allowed


@struct.dataclass
class VehicleState:
    """VehicleComponent + VehicleInput + runtime (sc_ecs.h:113-142)."""

    # tuning (per-entity so live tuning works like the reference's sliders)
    mass: jax.Array            # [N]
    engine_force: jax.Array    # [N]
    max_speed: jax.Array       # [N]
    brake_force: jax.Array     # [N]
    handbrake_force: jax.Array # [N]
    max_steer: jax.Array       # [N]
    steer_response: jax.Array  # [N]
    susp_rest: jax.Array       # [N]
    susp_stiff: jax.Array      # [N]
    damp_comp: jax.Array       # [N]
    damp_relax: jax.Array      # [N]
    wheel_radius: jax.Array    # [N]
    friction_slip: jax.Array   # [N]
    roll_influence: jax.Array  # [N]
    # raw input (throttle, brake, steer, handbrake) and smoothed controls
    input: jax.Array           # [N,4]
    smoothed: jax.Array        # [N,4]
    # per-wheel runtime: connection points local to chassis, susp length,
    # contact mask, wheel world pos filled by the vehicle system
    wheel_conn: jax.Array      # [N,4,3]
    susp_len: jax.Array        # [N,4]
    wheel_contact: jax.Array   # [N,4] bool
    wheel_omega: jax.Array     # [N,4] f32 roll speed (visual)


@struct.dataclass
class EntityState:
    """The world: every component column + entity bookkeeping."""

    alive: jax.Array        # [N] bool
    generation: jax.Array   # [N] u32
    # persistent identity: unlike (slot, generation) handles, uid travels
    # WITH the entity row through cross-shard migration/ghost packing
    # (scx/parallel/bigscene.py) — the warm-start cache keys on it. Defaults
    # to the slot index (identical to row keying in fixed single-chip
    # scenes); spatially-sharded scenes re-tag with globally unique ids
    # (scx.parallel.bigscene.assign_global_uids).
    uid: jax.Array          # [N] i32
    components: jax.Array   # [N] u32 bitmask of C_*
    sector: jax.Array       # [N,2] i32 owning sector coord
    name_hash: jax.Array    # [N] u64-as-2xu32? use u32 fnv fold — [N] u32
    transform: TransformState
    render: RenderState
    body: BodyState
    traffic: TrafficState
    vehicle: VehicleState

    @property
    def capacity(self) -> int:
        return self.alive.shape[-1]


def alloc_entity_state(capacity: int) -> EntityState:
    """Fresh, empty world with fixed capacity (entity reserve analogue,
    reference src/sandbox/src/main.cpp:63-64)."""
    from scx.core import memtrack

    n = capacity
    f3 = jnp.zeros((n, 3), jnp.float32)
    f1 = jnp.zeros((n,), jnp.float32)
    quat = jnp.zeros((n, 4), jnp.float32).at[:, 0].set(1.0)
    state = EntityState(
        alive=jnp.zeros((n,), jnp.bool_),
        generation=jnp.zeros((n,), jnp.uint32),
        uid=jnp.arange(n, dtype=jnp.int32),
        components=jnp.zeros((n,), jnp.uint32),
        sector=jnp.zeros((n, 2), jnp.int32),
        name_hash=jnp.zeros((n,), jnp.uint32),
        transform=TransformState(
            pos=f3,
            rot=quat,
            scale=jnp.ones((n, 3), jnp.float32),
            parent=jnp.full((n,), -1, jnp.int32),
        ),
        render=RenderState(
            mesh_id=jnp.full((n,), -1, jnp.int32),
            material_id=jnp.full((n,), -1, jnp.int32),
            aabb_min=jnp.full((n, 3), -0.5, jnp.float32),
            aabb_max=jnp.full((n, 3), 0.5, jnp.float32),
        ),
        body=BodyState(
            body_type=jnp.full((n,), BODY_NONE, jnp.int32),
            shape=jnp.full((n,), SHAPE_BOX, jnp.int32),
            half_extents=jnp.full((n, 3), 0.5, jnp.float32),
            layer=jnp.ones((n,), jnp.uint32),
            mask=jnp.full((n,), 0xFFFFFFFF, jnp.uint32),
            trigger=jnp.zeros((n,), jnp.bool_),
            mass=jnp.ones((n,), jnp.float32),
            friction=jnp.full((n,), 0.8, jnp.float32),
            restitution=jnp.zeros((n,), jnp.float32),
            lin_damping=f1,
            ang_damping=jnp.full((n,), 0.05, jnp.float32),
            vel=f3,
            omega=f3,
            com_offset=f3,
            sleep_timer=f1,
        ),
        traffic=TrafficState(
            mode=jnp.full((n,), TRAFFIC_NONE, jnp.int32),
            lane_id=jnp.full((n,), -1, jnp.int32),
            lane_s=f1,
            target_speed=f1,
            speed=f1,
            look_ahead=jnp.full((n,), 12.0, jnp.float32),
            stuck_timer=f1,
            sensor_hit_dist=f1,
            sensor_hit_type=jnp.zeros((n,), jnp.int32),
            lane_cooldown=jnp.zeros((n,), jnp.float32),
        ),
        vehicle=VehicleState(
            mass=jnp.full((n,), 1200.0, jnp.float32),
            engine_force=jnp.full((n,), 8000.0, jnp.float32),
            max_speed=jnp.full((n,), 45.0, jnp.float32),
            brake_force=jnp.full((n,), 12000.0, jnp.float32),
            handbrake_force=jnp.full((n,), 8000.0, jnp.float32),
            max_steer=jnp.full((n,), 0.55, jnp.float32),
            steer_response=jnp.full((n,), 6.0, jnp.float32),
            susp_rest=jnp.full((n,), 0.35, jnp.float32),
            susp_stiff=jnp.full((n,), 20.0, jnp.float32),
            damp_comp=jnp.full((n,), 2.3, jnp.float32),
            damp_relax=jnp.full((n,), 4.4, jnp.float32),
            wheel_radius=jnp.full((n,), 0.35, jnp.float32),
            friction_slip=jnp.full((n,), 1.2, jnp.float32),
            roll_influence=jnp.full((n,), 0.1, jnp.float32),
            input=jnp.zeros((n, 4), jnp.float32),
            smoothed=jnp.zeros((n, 4), jnp.float32),
            wheel_conn=jnp.zeros((n, 4, 3), jnp.float32),
            susp_len=jnp.full((n, 4), 0.35, jnp.float32),
            wheel_contact=jnp.zeros((n, 4), jnp.bool_),
            wheel_omega=jnp.zeros((n, 4), jnp.float32),
        ),
    )
    memtrack.track_array(
        memtrack.TAG_STATE, state, f"EntityState[{capacity}]"
    )
    return state


def entity_count(state: EntityState):
    return jnp.sum(state.alive.astype(jnp.int32))


def compact_free_slots(state: EntityState, k: int):
    """Indices of the first k free slots (padded with capacity when full).

    The functional analogue of EntityManager::create's free-list pop
    (sc_ecs.cpp:11-32): deterministic lowest-index-first allocation.
    """
    n = state.capacity
    free = ~state.alive
    # rank free slots by index: sort key = index where free, n where alive
    idx = jnp.arange(n, dtype=jnp.int32)
    key = jnp.where(free, idx, n)
    order = jnp.sort(key)[:k]
    return order  # entries == n mean "no slot available"


def spawn_entities(state: EntityState, slots, valid, **columns) -> EntityState:
    """Masked scatter-spawn: claim `slots` (where `valid`), set alive, write
    provided component columns.

    `columns` maps flat paths like "transform.pos" -> [k, ...] arrays;
    "components" may be supplied to set presence bits.
    """
    n = state.capacity
    slots = jnp.where(valid, slots, n)  # out-of-range scatters drop
    state = state.replace(
        alive=state.alive.at[slots].set(True, mode="drop"),
    )
    for path, value in columns.items():
        parts = path.split(".")
        if len(parts) == 1:
            arr = getattr(state, parts[0])
            state = state.replace(**{parts[0]: arr.at[slots].set(value, mode="drop")})
        else:
            group = getattr(state, parts[0])
            arr = getattr(group, parts[1])
            group = group.replace(**{parts[1]: arr.at[slots].set(value, mode="drop")})
            state = state.replace(**{parts[0]: group})
    return state


def destroy_entities(state: EntityState, kill_mask) -> EntityState:
    """Masked destroy: clears alive + components, bumps generation
    (the World::destroy across-pools analogue, sc_ecs.cpp:80-90)."""
    keep = state.alive & ~kill_mask
    bumped = state.generation + kill_mask.astype(jnp.uint32)
    return state.replace(
        alive=keep,
        generation=bumped,
        components=jnp.where(kill_mask, 0, state.components),
        body=state.body.replace(
            body_type=jnp.where(kill_mask, BODY_NONE, state.body.body_type),
            vel=jnp.where(kill_mask[:, None], 0.0, state.body.vel),
            omega=jnp.where(kill_mask[:, None], 0.0, state.body.omega),
        ),
        traffic=state.traffic.replace(
            mode=jnp.where(kill_mask, TRAFFIC_NONE, state.traffic.mode),
        ),
    )

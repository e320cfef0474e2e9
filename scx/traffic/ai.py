"""Traffic AI — vectorized port of the per-agent control laws.

The reference iterates agents, each doing: lane (re)acquisition, look-ahead
steering toward the lane point, speed from the lane limit x global
multiplier, a forward sensor raycast with obstacle braking proportional to
(safe - dist)/safe, then either P-control throttle/brake into VehicleInput
(Tier A Physics) or smoothed direct advance along the lane (Tier B/C)
(sc_traffic_ai.cpp:262-460).  Here every step is one masked array op over
ALL agents — the ForEach dissolves.

Stuck detection (speed < 0.2 while wanting > 2 m/s for > 1s,
sc_traffic_ai.cpp:396-424) is kept as a per-agent timer surfaced in
telemetry.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from scx.core import math3d as m3
from scx.core.config import TrafficConfig
from scx.physics.queries import raycast
from scx.physics.rigid import RigidBodies
from scx.state.entity import (
    EntityState,
    TRAFFIC_KINEMATIC,
    TRAFFIC_ONRAILS,
    TRAFFIC_PHYSICS,
)
from scx.traffic import lanes as ln

HIT_NONE = 0
HIT_SELF = 1
HIT_VEHICLE = 2
HIT_WORLD = 3


def wrap_angle(a):
    return jnp.arctan2(jnp.sin(a), jnp.cos(a))


def yaw_from_dir(d):
    """forward = (sin yaw, 0, cos yaw) => yaw = atan2(x, z)."""
    return jnp.arctan2(d[..., 0], d[..., 2])


def yaw_of_quat(q):
    fwd = m3.quat_rotate(q, jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), q.shape[:-1] + (3,)))
    return yaw_from_dir(fwd)


def traffic_ai_update(
    state: EntityState,
    lanes: ln.LaneArrays,
    bodies: RigidBodies | None,
    is_vehicle_body,          # [N] bool: body is a vehicle (for hit typing)
    cfg: TrafficConfig,
    dt,
) -> EntityState:
    tr = state.traffic
    n = state.capacity
    is_agent_col = state.alive & (tr.mode >= 0)

    # --- agent compaction: the control laws run on a fixed [A] agent set
    # instead of every capacity lane (the reference iterates agents, not
    # entities — sc_traffic_ai.cpp:262).  The LOD system caps live agents
    # at cfg.max_vehicles_total, so A = cap + margin loses nobody; lanes,
    # sensor rays and the clearance sweep shrink capacity/A-fold.
    # A == capacity keeps the identity layout.
    a_cap = min(n, int(cfg.max_vehicles_total) + 8)
    if a_cap < n:
        lane_idx = jnp.arange(n, dtype=jnp.int32)
        score = jnp.where(is_agent_col, n - lane_idx, 0)
        vals, _ = jax.lax.top_k(score, a_cap)
        slots = jnp.where(vals > 0, n - vals, n)
        slot_valid = slots < n
        safe = jnp.minimum(slots, n - 1)
    else:
        slots = safe = jnp.arange(n, dtype=jnp.int32)
        slot_valid = jnp.ones((n,), bool)
    a = a_cap

    g = lambda col: col[safe]
    pos = g(state.transform.pos)
    rot = g(state.transform.rot)
    old_lane = g(tr.lane_id)
    old_lane_s = g(tr.lane_s)
    old_speed = g(tr.speed)
    old_stuck = g(tr.stuck_timer)
    old_cooldown = g(tr.lane_cooldown)
    mode = jnp.where(slot_valid, g(tr.mode), -1)
    look_ahead = g(tr.look_ahead)
    max_steer_col = g(state.vehicle.max_steer)

    is_agent = slot_valid & g(is_agent_col)
    is_a = is_agent & (mode == TRAFFIC_PHYSICS)
    is_bc = is_agent & (mode != TRAFFIC_PHYSICS) & (mode >= 0)

    # lane (re)acquisition: invalid lanes always; tier A every step unless a
    # fresh lane change is in flight (the cooldown pins the chosen lane so
    # nearest-lane doesn't snap straight back) (sc_traffic_ai.cpp:264-271)
    q_lane, q_s, _ = jax.vmap(lambda p: ln.nearest_lane(lanes, p))(pos)
    need = is_agent & ((old_lane < 0) | (is_a & (old_cooldown <= 0.0)))
    lane_id = jnp.where(need, q_lane, old_lane)
    lane_s = jnp.where(need, q_s, old_lane_s)

    current_yaw = yaw_of_quat(rot)

    # forward sensor (sc_traffic_ai.cpp:301-347)
    fwd = jnp.stack(
        [jnp.sin(current_yaw), jnp.zeros_like(current_yaw), jnp.cos(current_yaw)], -1
    )
    if bodies is not None:
        origin = pos + fwd * 1.7 + jnp.asarray([0.0, 0.6, 0.0])

        def sense(o, f, self_idx, ray_len):
            return raycast(bodies, o, f, ray_len, query_mask=1, exclude=self_idx)

        hits = jax.vmap(sense)(
            origin, fwd, slots,
            jnp.full((a,), cfg.front_ray_length),
        )
        hit_dist = jnp.where(hits.hit, hits.t, cfg.front_ray_length)
        hit_body = hits.body
        hit_type = jnp.where(
            ~hits.hit,
            HIT_NONE,
            jnp.where(is_vehicle_body[jnp.maximum(hit_body, 0)], HIT_VEHICLE, HIT_WORLD),
        )
        obstacle_brake = jnp.where(
            hits.hit & (hit_dist < cfg.safe_distance),
            jnp.clip((cfg.safe_distance - hit_dist) / cfg.safe_distance, 0.0, 1.0),
            0.0,
        )
    else:
        hit_dist = jnp.full((a,), cfg.front_ray_length)
        hit_type = jnp.zeros((a,), jnp.int32)
        obstacle_brake = jnp.zeros((a,))

    # --- lane change: blocked behind a vehicle -> hop to the parallel
    # neighbour lane if its slot is clear (extension: the reference declares
    # the cooldown field but never implements it, sc_traffic_common.h:38-44)
    lane_cooldown = jnp.maximum(old_cooldown - dt, 0.0)
    if cfg.lane_change_enabled:
        alt_lane, alt_s, alt_ok = jax.vmap(
            lambda p, f, cl: ln.adjacent_lane(
                lanes, p, f, cl,
                min_dist=cfg.lane_change_min_dist,
                max_dist=cfg.lane_change_max_dist,
            )
        )(pos, fwd, lane_id)
        # clearance at the target point: nearest other agent must be beyond
        # the gap ([A,A] masked sweep over the compact agent set)
        safe_alt = jnp.maximum(alt_lane, 0)
        alt_pos = lanes.node_pos[lanes.seg_start[safe_alt]] + (
            lanes.seg_dir[safe_alt] * alt_s[:, None]
        )
        d2 = jnp.sum((alt_pos[:, None, :] - pos[None, :, :]) ** 2, axis=-1)
        other = is_agent[None, :] & (
            jnp.arange(a)[:, None] != jnp.arange(a)[None, :]
        )
        gap2 = jnp.min(jnp.where(other, d2, jnp.inf), axis=1)
        gap_ok = gap2 > cfg.lane_change_gap**2
        do_change = (
            is_agent
            & (lane_id >= 0)
            & (hit_type == HIT_VEHICLE)
            & (obstacle_brake > cfg.lane_change_min_block)
            & (lane_cooldown <= 0.0)
            & alt_ok
            & gap_ok
        )
        lane_id = jnp.where(do_change, alt_lane, lane_id)
        lane_s = jnp.where(do_change, alt_s, lane_s)
        lane_cooldown = jnp.where(do_change, cfg.lane_change_cooldown, lane_cooldown)

    # look-ahead steering target
    tgt_pos, _, tgt_ok = jax.vmap(
        lambda lid, s, d: ln.look_ahead_point(lanes, lid, s, d)
    )(lane_id, lane_s, look_ahead)
    to_tgt = (tgt_pos - pos) * jnp.asarray([1.0, 0.0, 1.0])
    desired_yaw = yaw_from_dir(m3.safe_normalize(to_tgt))
    max_steer = jnp.maximum(0.1, max_steer_col)
    steer = jnp.clip(wrap_angle(desired_yaw - current_yaw) / max_steer, -1.0, 1.0)

    safe_lane = jnp.maximum(lane_id, 0)
    desired_speed = jnp.maximum(
        lanes.seg_speed[safe_lane] * cfg.speed_multiplier, 0.0
    )
    desired_speed = jnp.where(tgt_ok & (lane_id >= 0), desired_speed, 0.0)

    # --- Tier A: P-control into VehicleInput (sc_traffic_ai.cpp:351-394) ---
    speed_a = old_speed  # vehicle post-step writes real speed here
    speed_err = desired_speed - speed_a
    denom = jnp.maximum(1.0, desired_speed)
    throttle = jnp.where(speed_err > 0.5, jnp.clip(speed_err / denom, 0.0, 1.0), 0.0)
    brake = jnp.where(speed_err < -0.5, jnp.clip(-speed_err / denom, 0.0, 1.0), 0.0)
    brake = jnp.maximum(brake, obstacle_brake)
    throttle = throttle * (1.0 - obstacle_brake)
    new_input = jnp.stack([throttle, brake, steer, jnp.zeros_like(steer)], -1)

    # stuck detection
    stuck_cond = is_a & (desired_speed > 2.0) & (speed_a < 0.2)
    stuck_timer = jnp.where(stuck_cond, old_stuck + dt, 0.0)

    # --- Tier B/C: smoothed advance along lane (sc_traffic_ai.cpp:434-460) ---
    desired_bc = desired_speed * (1.0 - obstacle_brake)
    sm_speed = old_speed + (desired_bc - old_speed) * (1.0 - jnp.exp(-2.5 * dt))
    travel = sm_speed * dt
    adv_lane, adv_s, adv_pos, adv_dir, adv_ok = jax.vmap(
        lambda lid, s, d: ln.advance_along_lane(lanes, lid, s, d)
    )(lane_id, lane_s, travel)
    move = is_bc & adv_ok
    # displacement clamp: after a lane change the lane point is ~a lane
    # width to the side; capping the per-step move makes the car glide over
    # (normal advance has |move| <= travel, so the cap never binds there)
    step_vec = jnp.stack(
        [adv_pos[:, 0] - pos[:, 0], jnp.zeros((a,)), adv_pos[:, 2] - pos[:, 2]], -1
    )
    step_len = jnp.sqrt(jnp.sum(step_vec * step_vec, -1))
    cap = travel + 3.0 * dt  # 3 m/s lateral convergence
    scale = jnp.minimum(1.0, cap / jnp.maximum(step_len, 1e-6))
    new_pos = pos + step_vec * scale[:, None]
    new_yaw = yaw_from_dir(adv_dir)
    yaw_quat = m3.quat_from_axis_angle(jnp.asarray([0.0, 1.0, 0.0]), new_yaw)
    lane_id = jnp.where(move, adv_lane, lane_id)
    lane_s = jnp.where(move, adv_s, lane_s)

    # kinematic (tier B) bodies carry their motion so contacts push other
    # bodies like the reference's kinematic btRigidBody motion states do
    is_kin = is_bc & (mode == TRAFFIC_KINEMATIC)
    kin_vel = adv_dir * sm_speed[:, None]

    # --- scatter the compact agent results back to their entity rows ---
    # (masked rows target the drop sentinel `n`, so non-selected writes
    # vanish exactly like the old jnp.where merges)
    def put(col, values, mask):
        tgt = jnp.where(mask, slots, n)
        return col.at[tgt].set(values, mode="drop")

    return state.replace(
        transform=state.transform.replace(
            pos=put(state.transform.pos, new_pos, move),
            rot=put(state.transform.rot, yaw_quat, move),
        ),
        body=state.body.replace(
            vel=put(state.body.vel, kin_vel, is_kin),
        ),
        vehicle=state.vehicle.replace(
            input=put(state.vehicle.input, new_input, is_a),
        ),
        traffic=tr.replace(
            lane_id=put(tr.lane_id, lane_id, is_agent),
            lane_s=put(tr.lane_s, lane_s, is_agent),
            target_speed=put(
                tr.target_speed,
                jnp.where(is_bc, sm_speed, desired_speed),
                is_agent,
            ),
            speed=put(tr.speed, jnp.where(is_bc, sm_speed, old_speed), is_agent),
            stuck_timer=put(tr.stuck_timer, stuck_timer, is_agent),
            sensor_hit_dist=put(tr.sensor_hit_dist, hit_dist, is_agent),
            sensor_hit_type=put(tr.sensor_hit_type, hit_type, is_agent),
            lane_cooldown=put(tr.lane_cooldown, lane_cooldown, is_agent),
        ),
    )

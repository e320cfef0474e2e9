"""The sandbox: full-engine composition — streaming city, traffic, player
vehicle, camera, render.

Mirror of the reference's sc_sandbox main (src/sandbox/src/main.cpp): same
system ordering (Input -> Simulation[streaming/spawner/LOD] ->
FixedUpdate[AI -> vehicle -> physics -> sync] -> RenderPrep[camera ->
cull -> draws] -> Render), same budgets, same fixed-step rules
(60 Hz, <=4 substeps).

Split of responsibilities (host vs device):
  * HOST: sector streaming, traffic spawning, asset residency, telemetry —
    everything with file IO or irregular allocation.
  * DEVICE (one jitted tick): traffic LOD + AI, vehicle forces, physics,
    camera, culling, draw emission, rasterization.

The jitted tick is compiled once; streaming writes entity slots in place so
no shape ever changes.
"""

from __future__ import annotations

import functools
import time

import jax
import jax.numpy as jnp
import numpy as np
from scx.core import struct

from scx.core import math3d as m3
from scx.core.config import EngineConfig
from scx.physics.solver import SolverParams
from scx.physics.vehicle import VehicleParams, default_wheel_configs
from scx.physics.world import bodies_from_state, physics_sync_step
from scx.render import RasterParams, render_frame
from scx.render.camera import CameraParams, camera_view_proj
from scx.render.mesh import build_mesh_pool
from scx.state import entity as ent
from scx.state.scheduler import FixedStepClock
from scx.telemetry import TelemetryHub
from scx.traffic.ai import traffic_ai_update
from scx.traffic.lanes import LaneGraphBuilder
from scx.traffic.lod import tier_counts, traffic_lod_update
from scx.traffic.spawner import TrafficSpawner, snapshot_agents
from scx.world.culling import cull_entities, emit_draws
from scx.world.streaming import WorldPartition
from scx.assets.residency import AssetManager
from scx.assets import textures as tx


@struct.dataclass
class SimParams:
    solver: SolverParams = struct.field(default_factory=SolverParams)
    vehicle: VehicleParams = struct.field(default_factory=VehicleParams)


def spawn_player_vehicle(state, slot: int, pos=(0.0, 0.6, 0.0)):
    """The demo player car: 1200 kg, 2x1x4 m chassis with COM offset
    (VehicleDemoSystem, sc_vehicle.cpp:436-501)."""
    vp = VehicleParams()
    half = jnp.asarray([1.0, 0.5, 2.0])
    com = jnp.asarray([0.0, -0.35, 0.0])
    wheels = default_wheel_configs(half, vp, com_offset=com)
    i = slot
    state = state.replace(
        alive=state.alive.at[i].set(True),
        components=state.components.at[i].set(
            ent.C_TRANSFORM | ent.C_RENDER_MESH | ent.C_BOUNDS | ent.C_COLLIDER
            | ent.C_RIGID_BODY | ent.C_VEHICLE | ent.C_VEHICLE_INPUT | ent.C_PLAYER
        ),
        transform=state.transform.replace(
            pos=state.transform.pos.at[i].set(jnp.asarray(pos)),
            scale=state.transform.scale.at[i].set(jnp.asarray([2.0, 1.0, 4.0])),
        ),
        render=state.render.replace(
            mesh_id=state.render.mesh_id.at[i].set(0),
            material_id=state.render.material_id.at[i].set(0),
        ),
        body=state.body.replace(
            body_type=state.body.body_type.at[i].set(ent.BODY_DYNAMIC),
            half_extents=state.body.half_extents.at[i].set(half),
            mass=state.body.mass.at[i].set(vp.mass),
            com_offset=state.body.com_offset.at[i].set(com),
            ang_damping=state.body.ang_damping.at[i].set(0.5),
        ),
        vehicle=state.vehicle.replace(
            wheel_conn=state.vehicle.wheel_conn.at[i].set(wheels.conn),
        ),
    )
    return state


def make_sim_tick(
    cfg: EngineConfig,
    sim: SimParams,
    max_substeps: int = 4,
    vehicle_reserve: int = 4,
):
    """The device tick: (state, cache, lanes, player_idx, input4, n_steps) ->
    (state, cache, despawn_mask, telemetry scalars).

    `cache` is the contact warm-start cache (scx.physics.warmstart
    .empty_sync_cache(sim.solver.max_pairs)), threaded across frames by
    the caller. Telemetry includes physics capacity overflow counters."""
    tcfg = cfg.traffic
    dt = cfg.physics.fixed_dt
    # vehicle-slot capacity: tier-A promotions are capped by the traffic
    # config; `vehicle_reserve` covers the player(s) and spares (every
    # wheel raycast scans all capacity boxes, so fleets with few vehicles
    # shouldn't pay the full 32-slot default). Multi-agent RL envs pass
    # a larger reserve (one slot per policy-controlled car).
    from scx.physics.world import MAX_VEHICLES

    max_vehicles = min(
        MAX_VEHICLES, int(tcfg.max_vehicles_physics) + int(vehicle_reserve)
    )

    def tick(state, cache, lanes, player_idx, player_input, n_steps):
        # player input -> vehicle input column (Input phase)
        state = state.replace(
            vehicle=state.vehicle.replace(
                input=state.vehicle.input.at[player_idx].set(player_input)
            )
        )
        player_pos = state.transform.pos[player_idx]
        pos_before = state.transform.pos  # health monitor baseline

        # Simulation phase: traffic LOD
        state, despawn = traffic_lod_update(state, player_pos, tcfg)

        # FixedUpdate xN (scan over static bound, masked)
        def fixed(carry, i):
            state, cache, acc = carry
            active = i < n_steps

            def run(s, c):
                bodies = bodies_from_state(s)
                is_veh = (s.components & ent.C_VEHICLE) != 0
                s = traffic_ai_update(s, lanes, bodies, is_veh, tcfg, dt)
                return physics_sync_step(
                    s, sim.solver, sim.vehicle, dt, c, max_vehicles
                )

            new_s, new_c, pstats = run(state, cache)
            sel = lambda a, b: jnp.where(jnp.reshape(active, (1,) * a.ndim), a, b)
            state = jax.tree.map(sel, new_s, state)
            cache = jax.tree.map(sel, new_c, cache)
            acc = jax.tree.map(
                lambda m, v: jnp.maximum(m, jnp.where(active, v, 0)), acc, pstats
            )
            return (state, cache, acc), None

        acc0 = {
            "pairs": jnp.int32(0),
            "pair_overflow": jnp.int32(0),
            "contacts": jnp.int32(0),
            "trigger_overlaps": jnp.int32(0),
        }
        (state, cache, acc), _ = jax.lax.scan(
            fixed, (state, cache, acc0), jnp.arange(max_substeps)
        )

        counts = dict(tier_counts(state))
        counts.update(acc)
        # state-health monitor — this engine's analogue of the reference's
        # visual/physics desync detector (sc_traffic_ai.cpp:573-583): with
        # one authoritative pose there is no desync to detect, but the
        # failure it CAUGHT (solver blow-ups) shows up as non-finite state
        # or teleport-scale displacement in one tick; surfaced as counters
        # and rate-limit-warned by the host (SURVEY §5.3).
        alive = state.alive
        pos = state.transform.pos
        vel = state.body.vel
        finite = (
            jnp.isfinite(pos).all(axis=-1)
            & jnp.isfinite(vel).all(axis=-1)
            & (jnp.abs(pos).max(axis=-1) < 1e6)
        )
        counts["invalid_state"] = jnp.sum((alive & ~finite).astype(jnp.int32))
        moved = jnp.sqrt(jnp.sum((pos - pos_before) ** 2, axis=-1))
        counts["teleports"] = jnp.sum(
            (alive & finite & (moved > 50.0)).astype(jnp.int32)
        )
        return state, cache, despawn, counts

    return tick


def chase_camera(state, player_idx, cam_state, dt, cfg: EngineConfig):
    """Spring-damper chase cam with occlusion pull-in and speed FOV
    (VehicleCameraSystem, sc_vehicle.cpp:527-649) — pure, device-side."""
    from scx.physics.world import bodies_from_state
    from scx.physics.queries import capsule_cast

    pos = state.transform.pos[player_idx]
    rot = state.transform.rot[player_idx]
    fwd = m3.quat_rotate(rot, jnp.asarray([0.0, 0.0, 1.0]))
    fwd = m3.safe_normalize(fwd * jnp.asarray([1.0, 0.0, 1.0]), jnp.asarray([0.0, 0.0, 1.0]))
    target = pos + jnp.asarray([0.0, 1.0, 0.0])

    desired = pos - fwd * 9.0 + jnp.asarray([0.0, 3.5, 0.0])
    # occlusion: swept capsule from the target toward the desired camera spot
    # pulls the camera in front of world geometry (sc_vehicle.cpp:595-625 —
    # the reference sweeps a capsule, sc_physics.cpp:740-810)
    bodies = bodies_from_state(state)
    to_cam = desired - target
    dist = m3.norm(to_cam)
    hit = capsule_cast(
        bodies, target, jnp.asarray([0.0, 1.0, 0.0]), 0.25, 0.3,
        m3.safe_normalize(to_cam, jnp.asarray([0.0, 0.0, -1.0])),
        dist, exclude=player_idx,
    )
    pulled = jnp.where(hit.hit, target + m3.safe_normalize(to_cam) * hit.t * 0.95, desired)

    stiff = 6.0
    cam_pos = cam_state + (pulled - cam_state) * (1.0 - jnp.exp(-stiff * dt))
    # dynamic FOV widens with speed (sc_vehicle.cpp:630-640)
    speed = m3.norm(state.body.vel[player_idx])
    fov = cfg.render.fov_y_deg + jnp.clip(speed / 45.0, 0.0, 1.0) * 12.0
    return cam_pos, target, fov


class Sandbox:
    """Composes the whole engine; one object = the reference's sc_sandbox."""

    def __init__(
        self,
        cfg: EngineConfig | None = None,
        capacity: int = 4096,
        raster: RasterParams | None = None,
        world_root: str | None = None,
        with_traffic: bool = True,
        # bake streamed static props to world-space triangle columns
        # (scx.render.staticbake), rebaked only on streaming activity;
        # per-frame geometry setup then covers just the dynamic handful.
        # Opt-in until measured on the card.
        static_bake: bool = False,
    ):
        self.cfg = cfg or EngineConfig()
        self.raster = raster or RasterParams(
            width=640, height=352, max_tris=32768, max_tris_per_tile=256,
            # compiled kernels need the GPU; CPU sessions get interpret mode
            interpret=jax.default_backend() == "cpu",
        )
        self.capacity = capacity
        self.state = ent.alloc_entity_state(capacity)
        self.partition = WorldPartition(
            self.cfg.world, self.cfg.streaming, capacity, world_root=world_root
        )
        self.lanes = LaneGraphBuilder(max_nodes=1024, max_segments=1024)
        self.spawner = TrafficSpawner(self.cfg.traffic, self.cfg.world) if with_traffic else None
        self.assets = AssetManager(self.cfg.residency)
        self.mesh_pool = build_mesh_pool()
        self.telemetry = TelemetryHub()
        self.clock = FixedStepClock(
            fixed_dt=self.cfg.physics.fixed_dt,
            max_substeps=self.cfg.physics.max_substeps,
        )

        # materials 0/1/2 = unlit/checker/test (streaming default resolver)
        chk = self.assets.add_texture_pixels("gen/checker", tx.checker_texture())
        tst = self.assets.add_texture_pixels("gen/test", tx.fallback_texture())
        self.assets.create_material("materials/unlit", albedo_texture=0)
        self.assets.create_material("materials/checker", albedo_texture=chk)
        self.assets.create_material("materials/test", albedo_texture=tst)

        # registry-driven GLB content for authored worlds: meshes bake into
        # the device pool, materials/textures register with the asset
        # manager (after the 3 builtin material slots so procedural ids
        # keep resolving to 0/1/2), streaming resolves registry ids first
        # (sc_world_partition.cpp:746-797)
        self.content = None
        if world_root is not None:
            from scx.assets.content import load_world_content

            self.content = load_world_content(world_root, self.assets)
        if self.content is not None:
            self.mesh_pool = build_mesh_pool(self.content.meshes)
            self.partition.asset_resolver = self.content.resolver(
                self.partition.asset_resolver
            )

        # player vehicle in the last slot (streaming fills from the bottom)
        self.player_slot = capacity - 1
        self.state = spawn_player_vehicle(self.state, self.player_slot)
        self.partition._alive[self.player_slot] = True
        self.partition._free.remove(self.player_slot)

        self.sim = SimParams(
            solver=SolverParams(
                gravity=self.cfg.physics.gravity,
                dt=self.cfg.physics.fixed_dt,
                iterations=self.cfg.physics.solver_iterations,
                max_pairs=256,
                # box-only content (props/buildings/chassis) — drops the
                # sphere/capsule narrowphase generators
                shape_kinds=("box",),
            ),
            vehicle=VehicleParams(),
        )
        from scx.physics.world import empty_sync_cache

        self._cache = empty_sync_cache(self.sim.solver.max_pairs)
        self._tick = jax.jit(make_sim_tick(self.cfg, self.sim))
        self._render = jax.jit(self._render_impl)
        self.static_bake = static_bake
        self._baked = None
        self._bake_dirty = True
        self._bake_tris = 0
        self._bake_fns: dict = {}
        if static_bake:
            # dynamic handful: traffic fleet + player + demo bodies; tris
            # beyond the cap drop with the budget semantics of the unbaked
            # path's max_tris (counted in tris_in, reference maxDraws)
            self._dyn_budget = self.cfg.traffic.max_vehicles_total + 16
            self._dyn_params = self.raster.replace(
                max_tris=16384, clip_extra=512
            )
            self._render_baked = jax.jit(self._render_baked_impl)
            from scx.render import staticbake as sbk

            # jit ONCE: a per-rebake lambda would retrace+compile every
            # time streaming dirties the bake (and a fresh compile poisons
            # co-resident timings, CLAUDE.md quirk 10b)
            self._bake_total_fn = jax.jit(
                lambda s: sbk.static_tri_total(s, self.mesh_pool)
            )
            self._rebake_count = 0
        from scx.render.debug_draw import DebugDraw, overlay_lines

        self.debug = DebugDraw(capacity=2048)
        self._overlay = jax.jit(overlay_lines)
        self._lane_arrays = None
        self.cam_pos = jnp.asarray([0.0, 5.0, -12.0])
        self.frame_no = 0
        self.paused = False  # physics pause toggle (sc_imgui.cpp:453-484)
        self._pending_lod_despawn = None
        self.scheduler = self._build_scheduler()

    def rebuild_tick(self):
        """Re-jit the device tick after a live config/sim-params change
        (the DebugConsole's equivalent of the reference's sliders mutating
        Bullet state directly — compile-time constants need a recompile)."""
        from scx.physics.world import empty_sync_cache

        self._tick = jax.jit(make_sim_tick(self.cfg, self.sim))
        # the warm-start cache is shaped by max_pairs; a live change (e.g.
        # 'set physics.max_pairs N') must resize it with the tick or the
        # next frame trips a shape mismatch
        if self._cache.key_a.shape[0] != self.sim.solver.max_pairs:
            self._cache = empty_sync_cache(self.sim.solver.max_pairs)

    def console(self):
        """Lazily-built live-tuning console (scx.app.debugui)."""
        if not hasattr(self, "_console"):
            from scx.app.debugui import DebugConsole

            self._console = DebugConsole(self)
        return self._console

    # ------------------------------------------------------------------
    def _build_scheduler(self):
        """Register the frame's systems in the reference's order and
        dependency structure (src/sandbox/src/main.cpp:241-265) — the
        composition is explicit and topologically checked even though the
        FixedUpdate block executes as one fused jit."""
        from scx.state.scheduler import Phase, Scheduler

        s = Scheduler()
        s.add_system("VehicleInput", Phase.INPUT, self._sys_player_input)
        s.add_system("VehicleStreamingPin", Phase.SIMULATION, self._sys_pin_player)
        s.add_system(
            "WorldStreaming", Phase.SIMULATION, self._sys_streaming,
            deps=("VehicleStreamingPin",),
        )
        s.add_system(
            "TrafficSpawner", Phase.SIMULATION, self._sys_traffic_spawner,
            deps=("WorldStreaming",),
        )
        s.add_system(
            "AssetResidency", Phase.SIMULATION, self._sys_assets,
            deps=("WorldStreaming",),
        )
        # TrafficLOD/TrafficAI/VehiclePreStep/PhysicsSync/TrafficPhysicsSync/
        # VehiclePostStep fuse into the jitted device tick (make_sim_tick)
        s.add_system("DeviceSimTick", Phase.FIXED_UPDATE, self._sys_device_tick)
        s.add_system("VehicleCamera", Phase.RENDER_PREP, self._sys_camera)
        s.add_system(
            "CullingAndRender", Phase.RENDER_PREP, self._sys_render,
            deps=("VehicleCamera",),
        )
        s.add_system("DebugTelemetry", Phase.RENDER, self._sys_telemetry)
        return s.finalize()

    def _render_impl(self, state, cam_pos, cam_target, fov_deg, materials, textures):
        vp = camera_view_proj(
            cam_pos,
            cam_target,
            jnp.asarray([0.0, 1.0, 0.0]),
            aspect=self.raster.width / self.raster.height,
            params=CameraParams(fov_y_deg=self.cfg.render.fov_y_deg),
            fov_y_deg=fov_deg,
        )
        visible, mats = cull_entities(state, vp)
        draws = emit_draws(state, visible, mats, self.cfg.streaming.max_draws)
        rgb, gbuf, stats = render_frame(
            draws, self.mesh_pool, vp, self.raster, materials, textures
        )
        stats["visible"] = jnp.sum(visible.astype(jnp.int32))
        return rgb, stats, gbuf["depth"], vp

    def _render_baked_impl(
        self, state, baked, cam_pos, cam_target, fov_deg, materials, textures
    ):
        """Static-bake render: scenery projects from pre-baked world-space
        columns (Morton-ordered at bake time for cluster locality); only
        the dynamic entities go through cull/emit/setup each frame."""
        from scx.render import staticbake as sbk
        from scx.render.pipeline import render_frame_baked

        vp = camera_view_proj(
            cam_pos,
            cam_target,
            jnp.asarray([0.0, 1.0, 0.0]),
            aspect=self.raster.width / self.raster.height,
            params=CameraParams(fov_y_deg=self.cfg.render.fov_y_deg),
            fov_y_deg=fov_deg,
        )
        visible, mats = cull_entities(state, vp)
        dyn = visible & ~sbk.static_entity_mask(state)
        draws = emit_draws(state, dyn, mats, self._dyn_budget)
        rgb, gbuf, stats = render_frame_baked(
            baked, draws, self.mesh_pool, vp, self.raster,
            self._dyn_params, materials, textures,
        )
        stats["visible"] = jnp.sum(visible.astype(jnp.int32))
        return rgb, stats, gbuf["depth"], vp

    def _rebake_static(self):
        """Re-bake after streaming changed the static set. The baked width
        grows in 4096-tri buckets so shape churn (= recompiles) only
        happens when the streamed world outgrows the current bucket."""
        from scx.render import staticbake as sbk

        total = int(self._bake_total_fn(self.state))
        bucket = max(4096, -(-total // 4096) * 4096)
        self._bake_tris = bucket
        if bucket not in self._bake_fns:
            self._bake_fns[bucket] = jax.jit(
                functools.partial(
                    sbk.bake_static_tris,
                    pool=self.mesh_pool, max_tris=bucket, morton=True,
                )
            )
        self._baked = self._bake_fns[bucket](self.state)
        self._bake_dirty = False
        self._rebake_count += 1

    # --- systems (reference names; run by the scheduler) ----------------
    def _sys_player_input(self, ctx):
        self._frame_input = jnp.asarray(ctx["player_input"], jnp.float32)

    def _sys_pin_player(self, ctx):
        """Pin the player's sector (VehicleStreamingPinSystem,
        sc_vehicle.cpp:503-525)."""
        self.partition.clear_pins()
        ppos = np.asarray(self.state.transform.pos[self.player_slot])
        self.partition.pin_sector(self.partition.world_to_sector(ppos))

    def _sys_streaming(self, ctx):
        t0 = time.perf_counter()
        if self._pending_lod_despawn is not None:
            slots = np.where(self._pending_lod_despawn)[0].tolist()
            if slots:
                sectors = np.asarray(self.state.sector[slots])
                self.partition._despawn_queue.extend(
                    (s, tuple(sec.tolist())) for s, sec in zip(slots, sectors)
                )
            self._pending_lod_despawn = None
        cam_np = np.asarray(self.cam_pos)
        self.state = self.partition.update(
            self.state, cam_np, np.asarray([0.0, 0.0, 1.0])
        )
        if (
            self.partition.stats.activations_this_frame
            or self.partition.stats.despawns_this_frame
        ):
            self._bake_dirty = True  # static set changed -> rebake lazily
        self.telemetry.current.stream_ms += (time.perf_counter() - t0) * 1e3

    def _sys_traffic_spawner(self, ctx):
        if self.spawner is None:
            return
        t0 = time.perf_counter()
        snap = snapshot_agents(self.state)
        player_np = snap["pos"][self.player_slot]
        self.state = self.spawner.update(
            self.state, self.partition, self.lanes, player_np, snap
        )
        if self.lanes.dirty or self._lane_arrays is None:
            self._lane_arrays = self.lanes.to_arrays()
        self.telemetry.current.stream_ms += (time.perf_counter() - t0) * 1e3

    def _sys_assets(self, ctx):
        self.assets.begin_frame()

    def _sys_device_tick(self, ctx):
        t0 = time.perf_counter()
        if self.paused:  # physics pause (DebugConsole; sc_imgui.cpp:453-462)
            return
        if self._lane_arrays is None:
            self._lane_arrays = self.lanes.to_arrays()
        self.state, self._cache, despawn, counts = self._tick(
            self.state,
            self._cache,
            self._lane_arrays,
            self.player_slot,
            self._frame_input,
            jnp.int32(ctx["n_steps"]),
        )
        self._pending_lod_despawn = np.asarray(despawn)
        self._tier_counts = counts
        self.telemetry.current.sim_ms = (time.perf_counter() - t0) * 1e3

    def _sys_camera(self, ctx):
        cam_pos, cam_target, fov = chase_camera(
            self.state, self.player_slot, self.cam_pos, ctx["frame_dt"], self.cfg
        )
        self.cam_pos = cam_pos
        self._cam_target = cam_target
        self._cam_fov = fov

    def _sys_render(self, ctx):
        t0 = time.perf_counter()
        textures = (
            self.assets.device_pool_mips()
            if self.cfg.render.use_mips
            else self.assets.device_pool()
        )
        if self.static_bake:
            if self._bake_dirty:
                self._rebake_static()
            self._frame_rgb, self._render_stats, depth, vp = self._render_baked(
                self.state, self._baked, self.cam_pos, self._cam_target,
                self._cam_fov, self.assets.device_materials(), textures,
            )
        else:
            self._frame_rgb, self._render_stats, depth, vp = self._render(
                self.state,
                self.cam_pos,
                self._cam_target,
                self._cam_fov,
                self.assets.device_materials(),
                textures,
            )
        # immediate-mode debug lines accumulated since last frame
        # (DebugDrawSystem runs after the scene pass, sc_imgui.cpp overlay)
        if self.debug.count:
            self._frame_rgb = self._overlay(
                self._frame_rgb, depth, vp, *self.debug.arrays()
            )
            self.debug.clear()
        self.telemetry.current.render_ms = (time.perf_counter() - t0) * 1e3

    def _sys_telemetry(self, ctx):
        t = self.telemetry.current
        # a paused first frame never ran the device tick (DebugConsole)
        counts = getattr(
            self, "_tier_counts",
            {"total": 0, "physics": 0, "kinematic": 0, "onrails": 0,
             "stuck": 0, "pair_overflow": 0, "contact_overflow": 0},
        )
        t.entities = self.partition.stats.entities
        t.active_sectors = self.partition.stats.active_sectors
        t.queued_sectors = self.partition.stats.queued
        t.loading_sectors = self.partition.stats.loading
        t.stream_activations = self.partition.stats.activations_this_frame
        t.stream_despawns = self.partition.stats.despawns_this_frame
        t.traffic_total = int(counts["total"])
        t.traffic_physics = int(counts["physics"])
        t.traffic_kinematic = int(counts["kinematic"])
        t.traffic_onrails = int(counts["onrails"])
        t.traffic_stuck = int(counts.get("stuck", 0))
        t.broadphase_pairs = int(counts.get("pairs", 0))
        t.pair_overflow = int(counts.get("pair_overflow", 0))
        t.contacts = int(counts.get("contacts", 0))
        t.invalid_state = int(counts.get("invalid_state", 0))
        t.teleports = int(counts.get("teleports", 0))
        # runtime invariant monitors with timed warn logs (the reference's
        # stuck-traffic + desync warns, sc_traffic_ai.cpp:396-424, 573-583)
        from scx.core.log import warn_rate_limited

        if t.traffic_stuck:
            warn_rate_limited(
                "traffic.stuck", 5.0,
                "traffic: %d agents stuck >1s", t.traffic_stuck,
            )
        if t.invalid_state:
            warn_rate_limited(
                "state.invalid", 2.0,
                "state health: %d entities with non-finite pos/vel",
                t.invalid_state,
            )
        if t.teleports:
            warn_rate_limited(
                "state.teleport", 2.0,
                "state health: %d entities moved >50m in one tick",
                t.teleports,
            )
        if t.pair_overflow:
            warn_rate_limited(
                "physics.pair_overflow", 5.0,
                "physics: broadphase dropped %d candidate pairs (max_pairs)",
                t.pair_overflow,
            )
        if self.spawner is not None:
            t.traffic_spawns = self.spawner.spawns_this_frame
        t.visible = int(self._render_stats["visible"])
        t.draws = int(self._render_stats["tris_in"])
        t.resident_textures = self.assets.stats.resident_textures
        t.resident_bytes = self.assets.stats.resident_bytes
        t.texture_evictions = self.assets.stats.evictions
        # host scope timings + job telemetry (sc_time.cpp:84-122 top-5 drain)
        from scx.core.timing import snapshot_top_scopes

        t.top_scopes = [(s.name, s.ms) for s in snapshot_top_scopes()]
        js = getattr(self, "_job_stats", None)
        if js is not None:
            t.jobs_dispatched = js.dispatched + js.async_jobs
            t.jobs_completed = js.completed
            t.jobs_busy_ms = js.busy_ms
        # tagged memory telemetry (reference memtrack, sc_memtrack.cpp:38-78)
        from scx.core import memtrack

        t.mem_tags = {k: c.live_bytes for k, c in memtrack.snapshot().items()}
        t.mem_live_bytes = sum(t.mem_tags.values())
        t.host_rss_bytes = memtrack.host_rss_bytes()
        if self.frame_no % 60 == 1:  # HBM stats query is a host<->device hop
            dm = memtrack.device_memory_stats()
            self._hbm_bytes = int(dm.get("bytes_in_use", 0))
        t.device_hbm_bytes = getattr(self, "_hbm_bytes", 0)

    def save_game(self, path: str) -> bool:
        """Runtime save-game: the whole device state pytree plus the host
        bookkeeping a resume needs (active sector set + per-sector entity
        slots in activation order, the verbatim lane graph, traffic agent
        registry, clock accumulator). The reference has NO runtime save —
        persistence there is only authored sector files (SURVEY §5.4) —
        so this is a beyond-parity capability the SoA design makes nearly
        free. Returns True on success.

        In-flight sector loads are not waited for; they simply re-request
        after a load_game (same semantics as a sector that was queued at
        save time). The contact warm-start cache saves to a sibling
        .cache.npz so a resumed solve continues bit-identically; if the
        solver capacity was retuned since the save, the cache silently
        restarts cold (it is only an accelerant).
        """
        from scx.app import checkpoint
        from scx.world.streaming import SectorState

        jax.block_until_ready(self.state.alive)
        sectors = []
        for coord, sec in self.partition.sectors.items():  # insertion order
            if sec.state != SectorState.ACTIVE:
                continue
            spawners = [
                {
                    "id": int(s.id),
                    "pos": [float(x) for x in s.transform.position],
                    "type": int(s.type),
                    "rate": float(s.rate),
                }
                for s in self.partition.authored_spawners.get(coord, [])
            ]
            sectors.append(
                {
                    "coord": list(coord),
                    "entity_slots": [int(i) for i in sec.entity_slots],
                    "lanes": [
                        [list(p) for p in lane]
                        for lane in self.partition.authored_lanes.get(coord, [])
                    ],
                    "spawners": spawners,
                }
            )
        extra = {
            "kind": "sandbox_save",
            "frame_no": int(self.frame_no),
            "player_slot": int(self.player_slot),
            "cam_pos": [float(x) for x in np.asarray(self.cam_pos)],
            "clock_accumulator": float(self.clock.accumulator),
            "partition_frame": int(self.partition.frame),
            "sectors": sectors,
            "lane_graph": self.lanes.to_snapshot(),
            "sector_agents": [
                [list(c), [int(s) for s in v]]
                for c, v in (self.spawner.sector_agents if self.spawner else {}).items()
            ],
            # host-held frame remnants: LOD demotions not yet queued and
            # the amortized despawn queue — dropping either would leak
            # entities after a resume
            "pending_lod_despawn": (
                None
                if self._pending_lod_despawn is None
                else np.where(self._pending_lod_despawn)[0].tolist()
            ),
            "despawn_queue": [
                [int(s), list(c)] for s, c in self.partition._despawn_queue
            ],
            "free_slots": [int(i) for i in self.partition._free],
        }
        ok = checkpoint.save_checkpoint(path, self.state, extra)
        if ok:
            checkpoint.save_aux_pytree(path + ".cache", self._cache)
        return ok

    def load_game(self, path: str) -> bool:
        """Restore a save_game into THIS sandbox (same capacity). Device
        state loads bitwise; host bookkeeping (streaming, lanes, traffic
        registry, clock) restores so the next frame continues the saved
        world: with streaming quiescent at save time and identical inputs,
        the post-load trajectory is bit-identical to the uninterrupted one
        (tests/test_app_sandbox.py::test_save_load_resume_bitwise)."""
        from scx.app import checkpoint
        from scx.physics.world import empty_sync_cache

        loaded = checkpoint.load_checkpoint(path)
        if loaded is None:
            return False
        state, extra = loaded
        if extra.get("kind") != "sandbox_save":
            return False
        if int(state.capacity) != int(self.capacity):
            return False
        self.state = jax.device_put(state)
        self.frame_no = int(extra["frame_no"])
        self.player_slot = int(extra["player_slot"])
        self.cam_pos = jnp.asarray(extra["cam_pos"])
        self.clock.accumulator = float(extra["clock_accumulator"])
        self.partition.frame = int(extra["partition_frame"])
        self.partition.restore(
            np.asarray(self.state.alive),
            extra["sectors"],
            free=extra.get("free_slots"),
        )
        self.lanes.from_snapshot(extra["lane_graph"])
        self._lane_arrays = self.lanes.to_arrays()
        if self.spawner is not None:
            self.spawner.sector_agents = {
                tuple(c): list(v) for c, v in extra.get("sector_agents", [])
            }
        self.partition._despawn_queue = [
            (int(s), tuple(c)) for s, c in extra.get("despawn_queue", [])
        ]
        pending = extra.get("pending_lod_despawn")
        if pending is None:
            self._pending_lod_despawn = None
        else:
            mask = np.zeros(self.capacity, bool)
            mask[np.asarray(pending, int)] = True
            self._pending_lod_despawn = mask
        fresh = empty_sync_cache(self.sim.solver.max_pairs)
        cached = checkpoint.load_aux_pytree(path + ".cache", fresh)
        if cached is None:
            # pre-planar save (round-3 ContactCache layout): convert so
            # old save-games still resume warm instead of cold-starting
            cached = checkpoint.load_legacy_contact_cache(
                path + ".cache", self.sim.solver.max_pairs
            )
        self._cache = jax.device_put(cached) if cached is not None else fresh
        self._bake_dirty = True  # restored static set needs a fresh bake
        return True

    def frame(self, frame_dt: float = 1.0 / 60.0, player_input=(0.0, 0.0, 0.0, 0.0)):
        """One engine frame through the scheduler; returns (rgb, telemetry)."""
        from scx.state.scheduler import Phase

        from scx.core.jobs import jobs
        from scx.core.timing import ScopedTimer
        from scx.telemetry import trace

        self.frame_no += 1
        self.telemetry.begin_frame(self.frame_no)
        self._job_stats = jobs().begin_frame()  # publish + reset (sc_jobs.cpp:150-200)
        n_steps = self.clock.advance(frame_dt)
        ctx = {
            "player_input": player_input,
            "frame_dt": frame_dt,
            "n_steps": n_steps,
        }
        for phase in (
            Phase.INPUT,
            Phase.SIMULATION,
            Phase.FIXED_UPDATE,
            Phase.RENDER_PREP,
            Phase.RENDER,
        ):
            for sysd in self.scheduler.phase_systems(phase):
                t0 = time.perf_counter()
                # every system runs under a named scope, like the scheduler's
                # auto-registered scopes (sc_scheduler.cpp:20); when a
                # jax.profiler trace is live the same span lands in it
                with ScopedTimer(f"System/{sysd.name}"), trace.annotate(
                    f"System/{sysd.name}"
                ):
                    sysd.fn(ctx)
                self.scheduler.stats_ms[sysd.name] = (
                    time.perf_counter() - t0
                ) * 1e3
        t = self.telemetry.end_frame()
        # in-framebuffer debug overlay (the reference's ImGui window,
        # sc_imgui.cpp:186-629) — stamps LAST frame's completed stats
        if self.cfg.render.overlay_text:
            from scx.render.debug_text import stamp_text, text_to_codes

            codes = text_to_codes(self.telemetry.format_overlay(), max_cols=96)
            self._frame_rgb = stamp_text(self._frame_rgb, codes)
        return self._frame_rgb, t

    def shutdown(self):
        self.partition.shutdown()

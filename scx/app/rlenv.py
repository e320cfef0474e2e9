"""Vectorized RL environment — BASELINE config #5: thousands of vmapped city
envs with scripted traffic, RGB-D observations per step.

Each env is an independent city scene (per-env procedural sector via the
hash-compatible generator, so env i is deterministic in (seed, i)): player
vehicle driven by continuous actions, OnRails traffic agents following the
lane graph, physics at a fixed dt, and a 128x128 (configurable) RGB-D render
through the batched Pallas rasterizer.

The whole step — physics, traffic, render — is ONE jitted function over the
batch; sharding the env axis over a mesh (scx.parallel) scales it across
chips.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from scx.core import struct

from scx.app.sandbox import SimParams, make_sim_tick, spawn_player_vehicle
from scx.physics.solver import SolverParams
from scx.core import math3d as m3
from scx.core.config import EngineConfig, WorldPartitionConfig
from scx.render import RasterParams
from scx.render.camera import CameraParams, camera_view_proj_from_pose
from scx.render.mesh import build_mesh_pool
from scx.render.pipeline import setup_triangles
from scx.state import entity as ent
from scx.traffic.lanes import LaneGraphBuilder
from scx.world import procgen
from scx.world.culling import cull_entities, emit_draws


def squash_raw_actions(raw):
    """Map an unbounded [..., 4] sample (e.g. a Gaussian policy's pre-tanh
    draw) onto THE action convention of this env: throttle, brake and
    handbrake in [0,1], steer in [-1,1]. The single home for the mapping —
    every policy (examples/train_reinforce.py, train_ppo.py) squashes
    through here so the convention cannot drift between them. Leading axes
    pass through (multi-agent policies squash [N, K, 4] the same way)."""
    t = jnp.tanh(raw)
    return jnp.stack(
        [
            (t[..., 0] + 1.0) * 0.5,
            (t[..., 1] + 1.0) * 0.5,
            t[..., 2],
            (t[..., 3] + 1.0) * 0.5,
        ],
        axis=-1,
    )


class CityRLEnv:
    """Batched sim-for-RL env. Actions: [N,4] (throttle, brake, steer,
    handbrake) — [N,K,4] with n_agents=K policy cars per env; observations:
    RGB-D [N,H,W,4] (obs_mode="rgbd") or per-agent state vectors
    (obs_mode="state", STATE_OBS_DIM floats)."""

    def __init__(
        self,
        n_envs: int,
        capacity: int = 160,
        obs_size: int = 128,
        n_traffic: int = 8,
        seed: int = 1337,
        substeps: int = 1,
        interpret: bool | None = None,
        # binning tile height of the obs frame (fewer, larger tiles mean
        # fewer per-tile list costs)
        obs_tile_h: int = 64,
        # obs raster path: per-tile triangle lists are tight when a frame
        # has few tiles, so the triangle-binned kernel is the default; the
        # cluster kernel is the opt-in for large frames and large scenes
        use_cluster_obs: bool | None = None,
        # world art: list of (verts [V,8], tris [T,3]) pool meshes (e.g.
        # GLB imports via scx.assets.gltf); defaults to the builtins.
        # prop_mesh_ids cycles these pool slots across the procedural props.
        meshes: list | None = None,
        prop_mesh_ids: list | None = None,
        draw_budget: int | None = None,
        # triangle-column budget override: the default formula (budget x
        # worst pool mesh) is the safe bound but wasteful for mixed
        # content — trailing draws past the budget drop, counted by the
        # reference's maxDraws semantics (expand_draws)
        max_tris: int | None = None,
        # near-clip quad reserve: obs cameras cross the near plane with a
        # handful of ground/nearby tris; the full 2048 default costs two
        # [E, extra]-row recovery gathers per step at fleet sizes
        obs_clip_extra: int = 512,
        # bake static props to world-space triangle columns at reset
        # (scx.render.staticbake): per-step setup for scenery becomes one
        # viewProj projection, per-entity culling runs only over the
        # dynamic handful, and the binned width shrinks to the ACTUAL
        # static triangle count instead of capacity x worst mesh.
        # Note: make_policy_rollout / make_trajectory_rollout capture the
        # baked columns as a closure const by default, which shard_map
        # replicates — for multi-chip use rollout_sharded (shards them) or
        # thread_baked=True; scx.rl.make_ppo_train_step(..., mesh=m)
        # threads the baked arg automatically (pass place(env.baked)).
        static_bake: bool = False,
        # observation mode: "rgbd" renders the agent-0 chase camera
        # ([N,H,W,4], the BASELINE config #5 shape); "state" returns
        # STATE_OBS_DIM floats per agent (self pose/velocity, lane
        # guidance, nearest mover, forward clearance ray) — no raster at
        # all, for algorithm prototyping and cheap multi-agent training.
        obs_mode: str = "rgbd",
        # policy-controlled cars per env. Agent 0 is THE player (chase
        # camera, back-compat [N,4] actions when n_agents == 1); extras
        # spawn staggered behind it. actions become [N, K, 4], rewards
        # [N, K] and rgbd obs [N, K, H, W, 4] when K > 1 (K chase cameras
        # folded into the batched raster's env axis — K-fold raster cost,
        # measured in benchmarks/bench_rlenv.py RL_AGENTS=K); obs_mode=
        # "state" gives per-agent vectors with no raster at all.
        n_agents: int = 1,
    ):
        self.n_envs = n_envs
        self.capacity = capacity
        from scx.core.config import TrafficConfig

        # tight agent cap: traffic_ai_update compacts its control laws to
        # [cap+8] agent rows instead of every capacity lane
        cfg = EngineConfig(
            traffic=TrafficConfig(
                max_vehicles_total=max(24, n_traffic + 4),
                # only n_traffic agents exist, so capping tier-A promotions
                # at n_traffic+1 is behavior-identical and right-sizes the
                # vehicle slot set (wheel raycasts scan all capacity boxes)
                max_vehicles_physics=min(24, n_traffic + 1),
            )
        )
        self.cfg = cfg
        self.pool = build_mesh_pool(meshes)
        self._prop_mesh_ids = prop_mesh_ids
        self.draw_budget = draw_budget if draw_budget is not None else capacity
        # right-size the triangle columns to the scene: draw budget x the
        # worst-case pool mesh (+20% clip headroom, /1024 granularity).
        # Setup/bin work scales with the column length, and at fleet sizes
        # the unused tail of a generous cap is the single largest
        # render-prep cost.
        tris_per_draw = int(np.asarray(self.pool.mesh_tri_count).max())
        t_need = (
            max_tris
            if max_tris is not None
            else int(self.draw_budget * tris_per_draw * 1.2)
        )
        self.raster = RasterParams(
            width=obs_size,
            height=obs_size,
            tile_h=min(obs_tile_h, obs_size),
            tile_w=128,
            max_tris=max(1024, -(-t_need // 1024) * 1024),
            max_tris_per_tile=128,
            use_clusters=(
                use_cluster_obs if use_cluster_obs is not None else False
            ),
            max_clusters_per_tile=128,
            clip_extra=obs_clip_extra,
            interpret=(
                interpret
                if interpret is not None
                else jax.default_backend() == "cpu"
            ),
        )
        # warm-started 6-iteration solve == cold-8 quality (tower test in
        # test_physics_solver.py; same setting as the sandbox and bench.py).
        # shape_kinds=("box",): every body the city content spawns (props,
        # buildings, vehicle chassis) is a box — the narrowphase drops its
        # sphere/capsule generators (~2x smaller SAT kernel body).
        self.sim = SimParams(
            solver=SolverParams(
                iterations=cfg.physics.solver_iterations,
                shape_kinds=("box",),
            )
        )
        if obs_mode not in ("rgbd", "state"):
            raise ValueError(f"obs_mode {obs_mode!r} not in ('rgbd','state')")
        if not 1 <= n_agents <= 8:
            raise ValueError("n_agents must be in 1..8")
        self.obs_mode = obs_mode
        self.n_agents = n_agents
        self._tick = make_sim_tick(
            cfg, self.sim, max_substeps=substeps,
            vehicle_reserve=3 + n_agents,
        )
        self.substeps = substeps
        self.seed = seed
        self.n_traffic = n_traffic
        self.player = capacity - 1
        # agent 0 == the player; extras fill descending slots (the merge in
        # _build_batch keeps template values there, so prop/traffic columns
        # can never land on an agent slot)
        self.agent_slots = jnp.asarray(
            [capacity - 1 - j for j in range(n_agents)], jnp.int32
        )

        # lanes shared across envs (every env uses sector (0,0)'s cross)
        lanes = LaneGraphBuilder(max_nodes=64, max_segments=32)
        lanes.build_procedural_for_sector((0, 0), (0.0, 0.0, 0.0), (64.0, 0.0, 64.0))
        self._lane_builder = lanes
        self.lanes = lanes.to_arrays()

        self._step_jit = jax.jit(self._step_impl)
        self._chunker = None  # AdaptiveChunker, built on first rollout
        self._launched_lengths: set = set()
        self._rollout_jit = None
        self._rollout_sharded_jit = None
        self._rollout_sharded_key = None
        self.static_bake = static_bake
        self.state = self._build_batch()
        self.baked = self._bake_static() if static_bake else None
        self.cache = self._build_cache()
        self.last_info = {"nan_rollbacks": 0, "pair_overflow": 0}

    def _bake_static(self):
        """Bake per-env static triangle columns + size the split raster
        params (static / dynamic / combined bin) — see scx.render.staticbake.
        """
        from scx.render import staticbake as sb

        # exact static triangle demand, max over envs (one tiny host sync
        # at reset), rounded to the 128-lane grid
        totals = jax.jit(
            jax.vmap(lambda s: sb.static_tri_total(s, self.pool))
        )(self.state)
        t_s = max(128, -(-int(jnp.max(totals)) // 128) * 128)
        # pads 32-aligned: the cluster obs path reshapes the combined
        # width by raster_clusters.CLUSTER (32)
        pad_s = (min(self.raster.clip_extra, t_s // 4) // 32) * 32
        self._params_static = self.raster.replace(
            max_tris=t_s + pad_s, clip_extra=pad_s
        )
        # dynamic handful: traffic + player (+margin), worst-case pool mesh
        tris_per_draw = int(np.asarray(self.pool.mesh_tri_count).max())
        self._dyn_budget = self.n_traffic + 5
        t_d = -(-int(self._dyn_budget * tris_per_draw * 1.2) // 128) * 128
        pad_d = (min(128, t_d // 4) // 32) * 32
        self._params_dyn = self.raster.replace(
            max_tris=t_d + pad_d, clip_extra=pad_d
        )
        self._params_bin = self.raster.replace(
            max_tris=t_s + pad_s + t_d + pad_d
        )
        return jax.jit(
            jax.vmap(
                lambda s: sb.bake_static_tris(s, self.pool, t_s)
            )
        )(self.state)

    def _build_cache(self):
        """Per-env contact warm-start caches (zeros)."""
        from scx.physics.world import empty_sync_cache

        one = empty_sync_cache(self.sim.solver.max_pairs)
        return jax.tree.map(
            lambda x: jnp.broadcast_to(x, (self.n_envs,) + x.shape), one
        )

    # ------------------------------------------------------------------
    def _build_env_np(self, env_idx: int) -> dict:
        """Numpy column overrides for one env (no device dispatches).

        The native procgen baker (native/sc_native.cpp, golden-equivalent to
        scx.world.procgen per tests/test_native.py) bakes the sector ~50x
        faster than the Python port — at BASELINE config #5 scale (4096
        envs) the Python build was the bottleneck (VERDICT r1 item 3)."""
        native_out = None
        try:
            from scx import native as scn

            native_out = scn.generate_sector_spawns(self.seed + env_idx, 0, 0)
        except Exception:
            native_out = None
        if native_out is not None:
            transforms, _kind = native_out
            pos_arr = transforms[:, 0:3]
            yaw_arr = transforms[:, 4]
            scale_arr = transforms[:, 6:9]
            k = len(transforms)
        else:
            cfg = WorldPartitionConfig(seed=self.seed + env_idx)
            recs = procgen.generate_sector_spawns(cfg, 0, 0)
            arrs = procgen.spawns_to_arrays(recs)
            pos_arr = arrs["pos"]
            yaw_arr = arrs["rot"][:, 1]
            scale_arr = arrs["scale"]
            k = len(recs)
        n = self.capacity
        cols = {
            "alive": np.zeros(n, bool),
            "pos": np.zeros((n, 3), np.float32),
            "rot": np.tile(np.asarray([1, 0, 0, 0], np.float32), (n, 1)),
            "scale": np.ones((n, 3), np.float32),
            "mesh": np.full(n, -1, np.int32),
            "mat": np.full(n, -1, np.int32),
            "body_type": np.full(n, ent.BODY_NONE, np.int32),
            "half": np.full((n, 3), 0.5, np.float32),
            "mode": np.full(n, ent.TRAFFIC_NONE, np.int32),
            "lane": np.full(n, -1, np.int32),
            "lane_s": np.zeros(n, np.float32),
        }
        cols["alive"][:k] = True
        cols["pos"][:k] = pos_arr
        cols["rot"][:k, 0] = np.cos(yaw_arr * 0.5)
        cols["rot"][:k, 2] = np.sin(yaw_arr * 0.5)
        cols["scale"][:k] = scale_arr
        if self._prop_mesh_ids is not None:
            ids = np.asarray(self._prop_mesh_ids, np.int32)
            cols["mesh"][:k] = ids[(np.arange(k) + env_idx) % len(ids)]
        else:
            cols["mesh"][:k] = 0
        cols["mat"][:k] = 0
        cols["body_type"][:k] = ent.BODY_STATIC
        cols["half"][:k] = scale_arr * 0.5

        segs = self._lane_builder.sector_segments[(0, 0)]
        for i in range(self.n_traffic):
            slot = k + i
            lane = segs[i % len(segs)]
            seg = self._lane_builder.segments[lane]
            s0 = (6.0 + 7.0 * i) % max(seg["length"], 1.0)
            p = np.asarray(self._lane_builder.nodes[seg["start"]]["pos"]) + (
                np.asarray(seg["dir"]) * s0
            )
            cols["alive"][slot] = True
            cols["pos"][slot] = [p[0], 0.35, p[2]]
            cols["scale"][slot] = [1.8, 1.2, 4.2]
            cols["half"][slot] = [0.9, 0.6, 2.1]
            cols["mesh"][slot] = 0
            cols["mat"][slot] = 0
            cols["mode"][slot] = ent.TRAFFIC_ONRAILS
            cols["lane"][slot] = lane
            cols["lane_s"][slot] = s0
        return cols

    def _build_batch(self):
        """Stack env columns in numpy, upload once, apply to a template.

        Per-env bakes are independent host work — parallel-for on the job
        system (a serial build of 1024 x 512-capacity envs costs minutes,
        over the driver's bench budget)."""
        from scx.core.jobs import jobs

        per_env: list = [None] * self.n_envs
        def bake(i):
            per_env[i] = self._build_env_np(i)
        jobs().dispatch(self.n_envs, 8, bake)
        stacked = {
            key: jnp.asarray(np.stack([c[key] for c in per_env]))
            for key in per_env[0]
        }
        template = ent.alloc_entity_state(self.capacity)
        # agent 0 at THE reference spawn (32, 16); extras on a 3-wide grid
        # around it. Every cell stays on the sector's ground slab (x,z in
        # [0,64] — at 7 m column gaps a single-file line of 8 would walk
        # off the slab at z<0 and fall through the world).
        agent_xz = [
            (32.0 + 4.0 * (((j + 1) % 3) - 1), 16.0 - 7.0 * ((j + 1) // 3))
            for j in range(self.n_agents)
        ]
        assert agent_xz[0] == (32.0, 16.0)
        for j, (ax, az) in enumerate(agent_xz):
            template = spawn_player_vehicle(
                template, self.capacity - 1 - j, pos=(ax, 0.6, az)
            )
        batch = jax.tree.map(
            lambda x: jnp.broadcast_to(x, (self.n_envs,) + x.shape), template
        )
        # the template is transient (discarded after broadcast): untrack it
        # so TAG_STATE live_bytes doesn't creep up with every env reset
        from scx.core import memtrack

        memtrack.untrack_array(memtrack.TAG_STATE, template)
        s = stacked

        # extra agents spawn at fixed grid cells that procedural content
        # knows nothing about: clear small static props from those cells
        # (the reference's player-exclusion-radius idea, sc_traffic_spawner
        # .cpp player exclusion) so a braked car is never shoved by an
        # overlapping prop at reset. Agent 0's cell is NOT cleared — the
        # n_agents == 1 scene stays bit-identical to the historical one.
        extra_xz = jnp.asarray(agent_xz[1:], jnp.float32).reshape(-1, 2)

        def merge(batch):
            alive_in = s["alive"]
            if extra_xz.shape[0]:
                d = jnp.abs(
                    s["pos"][:, :, None, (0, 2)] - extra_xz[None, None, :, :]
                )  # [N, C, K-1, 2]
                near = jnp.any((d[..., 0] < 4.0) & (d[..., 1] < 5.0), axis=-1)
                small = jnp.max(s["half"], axis=-1) < 4.0  # never the ground
                is_prop = (s["body_type"] == ent.BODY_STATIC) & (
                    s["mode"] == ent.TRAFFIC_NONE
                )
                alive_in = alive_in & ~(near & small & is_prop)
            # agent slots keep their template (vehicle) values: procedural
            # prop/traffic columns can never overwrite a policy car
            kp = jnp.arange(self.capacity) >= self.capacity - self.n_agents
            def sel(new, old):
                mask = jnp.reshape(kp, (1, -1) + (1,) * (old.ndim - 2))
                return jnp.where(mask, old, new)
            return batch.replace(
                alive=batch.alive | alive_in,
                transform=batch.transform.replace(
                    pos=sel(s["pos"], batch.transform.pos),
                    rot=sel(s["rot"], batch.transform.rot),
                    scale=sel(s["scale"], batch.transform.scale),
                ),
                render=batch.render.replace(
                    mesh_id=sel(s["mesh"], batch.render.mesh_id),
                    material_id=sel(s["mat"], batch.render.material_id),
                ),
                body=batch.body.replace(
                    body_type=sel(s["body_type"], batch.body.body_type),
                    half_extents=sel(s["half"], batch.body.half_extents),
                ),
                traffic=batch.traffic.replace(
                    mode=sel(s["mode"], batch.traffic.mode),
                    lane_id=sel(s["lane"], batch.traffic.lane_id),
                    lane_s=sel(s["lane_s"], batch.traffic.lane_s),
                ),
            )

        return jax.jit(merge)(batch)

    # ------------------------------------------------------------------
    def _camera_vp(self, state, slot=None):
        """Chase-view viewProj for one env (camera behind `slot`, default
        the player / agent 0)."""
        from scx.render.camera import camera_view_proj

        slot = self.player if slot is None else slot
        ppos = state.transform.pos[slot]
        prot = state.transform.rot[slot]
        fwd = m3.quat_rotate(prot, jnp.asarray([0.0, 0.0, 1.0]))
        fwd = m3.safe_normalize(
            fwd * jnp.asarray([1.0, 0.0, 1.0]), jnp.asarray([0.0, 0.0, 1.0])
        )
        cam_pos = ppos - fwd * 7.0 + jnp.asarray([0.0, 3.0, 0.0])
        return camera_view_proj(
            cam_pos,
            ppos + jnp.asarray([0.0, 1.0, 0.0]),
            jnp.asarray([0.0, 1.0, 0.0]),
            aspect=1.0,
            params=CameraParams(fov_y_deg=70.0),
        )

    def _render_one(self, state, slot=None):
        """Per-env triangle setup, full path (cull + emit + setup)."""
        vp = self._camera_vp(state, slot)
        visible, mats = cull_entities(state, vp)
        # max_tris was right-sized for the draw budget x worst pool mesh,
        # so no headroom is wasted (budget defaults to the capacity)
        draws = emit_draws(state, visible, mats, self.draw_budget)
        return setup_triangles(draws, self.pool, vp, self.raster)

    def _render_one_baked(self, state, baked, slot=None):
        """Per-env triangle setup, static-bake path: scenery projects from
        baked world-space columns (one viewProj multiply); only the dynamic
        handful (traffic + player) goes through cull/emit/setup. Triangle
        order (statics in slot order, then dynamics) matches _render_one's
        draw order, so binned output is identical up to fp association."""
        from scx.render import staticbake as sb

        vp = self._camera_vp(state, slot)
        s_setup, s_aabb, s_valid = sb.setup_static_from_bake(
            baked, vp, self._params_static
        )
        visible, mats = cull_entities(state, vp)
        dyn = visible & ~sb.static_entity_mask(state)
        draws = emit_draws(state, dyn, mats, self._dyn_budget)
        d_setup, d_aabb, d_valid = setup_triangles(
            draws, self.pool, vp, self._params_dyn
        )
        return (
            jnp.concatenate([s_setup, d_setup], axis=0),
            jnp.concatenate([s_aabb, d_aabb], axis=0),
            jnp.concatenate([s_valid, d_valid], axis=0),
        )

    def _render_obs_batched(self, batch, baked=None):
        """RGB-D observations for the whole batch: [N,H,W,4], or
        [N,K,H,W,4] with n_agents=K>1 (one chase camera per agent).

        Binning happens OUTSIDE the per-env vmap: its rank recovery is
        written for the whole fleet at once (bin_triangles_batched).
        raster_gbuffer_batched dispatches cluster vs triangle binning on
        raster.use_clusters (cluster kernel for big GLB scenes).

        Multi-agent folds the K cameras into the batched raster's env axis
        (setup is [N,K,T,...] -> [N*K,T,...]): the binner/kernel are
        env-batched already, so K views cost exactly K-fold the raster —
        no new code path. Geometry setup also runs per camera (culling is
        view-dependent).
        """
        from scx.render.pipeline import raster_gbuffer_batched

        k = self.n_agents
        if baked is not None:
            params = self._params_bin
            if k == 1:
                setup, aabb, valid = jax.vmap(self._render_one_baked)(
                    batch, baked
                )
            else:
                per_agent = lambda s, b: jax.vmap(
                    lambda slot: self._render_one_baked(s, b, slot)
                )(self.agent_slots)
                setup, aabb, valid = jax.vmap(per_agent)(batch, baked)
        else:
            params = self.raster
            if k == 1:
                setup, aabb, valid = jax.vmap(self._render_one)(batch)
            else:
                per_agent = lambda s: jax.vmap(
                    lambda slot: self._render_one(s, slot)
                )(self.agent_slots)
                setup, aabb, valid = jax.vmap(per_agent)(batch)
        if k > 1:  # fold [N,K,...] -> [N*K,...] for the env-batched raster
            fold = lambda a: a.reshape((-1,) + a.shape[2:])
            setup, aabb, valid = fold(setup), fold(aabb), fold(valid)
        g, _rstats = raster_gbuffer_batched(setup, aabb, valid, params)
        obs = jnp.concatenate([g["color"], g["depth"][..., None]], axis=-1)
        if k > 1:
            obs = obs.reshape((-1, k) + obs.shape[1:])
        return obs

    # per-agent state-observation layout (obs_mode="state"):
    #   0:3  world-frame velocity        9:11 look-ahead target (xz, rel)
    #   3:5  forward direction (xz)      11   lane-valid flag
    #   5    forward speed               12:14 nearest mover (xz, rel)
    #   6    yaw rate (omega_y)          14   nearest-mover distance (<=50)
    #   7:9  position (xz / 64)          15   forward clearance ray (<=20)
    STATE_OBS_DIM = 16
    _RAY_LEN = 20.0

    def _state_obs_one(self, state):
        """STATE_OBS_DIM floats per agent for ONE env -> [K, S].

        The guidance terms mirror what the traffic AI computes for its own
        agents (scx/traffic/ai.py: nearest_lane + look_ahead_point + the
        forward sensor ray, sc_traffic_ai.cpp:274-347) so a policy sees the
        same world the scripted agents act on."""
        from scx.physics.world import bodies_from_state
        from scx.physics.queries import raycast
        from scx.traffic import lanes as ln

        slots = self.agent_slots
        pos = state.transform.pos[slots]  # [K,3]
        rot = state.transform.rot[slots]
        vel = state.body.vel[slots]
        omega_y = state.body.omega[slots][:, 1]
        fwd = jax.vmap(
            lambda q: m3.quat_rotate(q, jnp.asarray([0.0, 0.0, 1.0]))
        )(rot)
        speed = jnp.sum(vel * fwd, axis=-1)

        # lane guidance (fresh query each obs: policy cars carry no lane state)
        q_lane, q_s, _ = jax.vmap(lambda p: ln.nearest_lane(self.lanes, p))(pos)
        tgt, _, tgt_ok = jax.vmap(
            lambda lid, s: ln.look_ahead_point(
                self.lanes, lid, s, jnp.float32(8.0)
            )
        )(q_lane, q_s)
        to_tgt = jnp.where(tgt_ok[:, None], (tgt - pos), 0.0)

        # nearest other moving body (traffic or another agent)
        moving = state.alive & (state.body.body_type != ent.BODY_STATIC)
        d2 = jnp.sum(
            (pos[:, None, :] - state.transform.pos[None, :, :]) ** 2, axis=-1
        )  # [K, C]
        is_self = slots[:, None] == jnp.arange(self.capacity)[None, :]
        d2 = jnp.where(moving[None, :] & ~is_self, d2, jnp.inf)
        j = jnp.argmin(d2, axis=-1)
        dmin = d2[jnp.arange(slots.shape[0]), j]
        has_mover = jnp.isfinite(dmin)  # all-static scene -> d2 all inf
        near_dist = jnp.where(
            has_mover, jnp.sqrt(jnp.where(has_mover, dmin, 0.0)), 50.0
        )
        near_dist = jnp.minimum(near_dist, 50.0)
        near_rel = jnp.where(
            has_mover[:, None], state.transform.pos[j] - pos, 0.0
        )

        # forward clearance (the AI's sensor ray, from the chassis nose)
        bodies = bodies_from_state(state)
        hits = jax.vmap(
            lambda o, f, s: raycast(
                bodies, o, f, jnp.float32(self._RAY_LEN), query_mask=1, exclude=s
            )
        )(pos + fwd * 2.2 + jnp.asarray([0.0, 0.3, 0.0]), fwd, slots)
        ray_dist = jnp.where(hits.hit, hits.t, self._RAY_LEN)

        return jnp.concatenate(
            [
                vel,
                fwd[:, (0, 2)],
                speed[:, None],
                omega_y[:, None],
                pos[:, (0, 2)] / 64.0,
                to_tgt[:, (0, 2)],
                tgt_ok[:, None].astype(jnp.float32),
                near_rel[:, (0, 2)],
                near_dist[:, None],
                ray_dist[:, None],
            ],
            axis=-1,
        )

    def _obs_batched(self, batch, baked=None):
        """Observations for the whole batch, dispatched on obs_mode:
        rgbd -> [N,H,W,4]; state -> [N, STATE_OBS_DIM] (n_agents == 1)
        or [N, K, STATE_OBS_DIM]."""
        if self.obs_mode == "state":
            obs = jax.vmap(self._state_obs_one)(batch)
            return obs[:, 0] if self.n_agents == 1 else obs
        return self._render_obs_batched(batch, baked)

    def _step_impl(self, batch, cache, actions, baked=None):
        def env_step(state, c, action):
            if self.n_agents > 1:
                # extra agents' inputs pre-scatter; the tick's own scatter
                # then writes agent 0 (the player) — one pass, no overlap
                state = state.replace(
                    vehicle=state.vehicle.replace(
                        input=state.vehicle.input.at[self.agent_slots[1:]].set(
                            action[1:]
                        )
                    )
                )
                action = action[0]
            state, c, _, counts = self._tick(
                state, c, self.lanes, self.player, action, jnp.int32(self.substeps)
            )
            return state, c, counts["pair_overflow"]

        new_batch, new_cache, overflow = jax.vmap(env_step)(batch, cache, actions)

        # NaN-state detection with rollback (SURVEY §5.3): a solver blow-up
        # in one env reverts that env to its pre-step state instead of
        # propagating silently through an RL fleet.
        def env_finite(s):
            return (
                jnp.all(jnp.isfinite(s.transform.pos))
                & jnp.all(jnp.isfinite(s.transform.rot))
                & jnp.all(jnp.isfinite(s.body.vel))
                & jnp.all(jnp.isfinite(s.body.omega))
            )

        # ok.shape[0] is the LOCAL env count (n_envs/dp inside shard_map)
        ok = jax.vmap(env_finite)(new_batch)
        keep = lambda n, o: jnp.where(
            jnp.reshape(ok, (ok.shape[0],) + (1,) * (n.ndim - 1)), n, o
        )
        batch = jax.tree.map(keep, new_batch, batch)
        cache = jax.tree.map(keep, new_cache, cache)
        info = {
            "nan_rollbacks": jnp.sum((~ok).astype(jnp.int32)),
            "pair_overflow": jnp.max(overflow),
        }
        obs = self._obs_batched(batch, baked)

        # reward: forward progress per agent (m per step); [N] when
        # n_agents == 1 (back-compat), else [N, K]
        if self.obs_mode == "state":
            # the state obs already carries per-agent forward speed
            # (column 5, same post-step batch) — don't recompute it
            fwd_speed = obs[..., 5]
        else:
            def agent_fwd(s):
                rot = s.transform.rot[self.agent_slots]
                vel = s.body.vel[self.agent_slots]
                fwd = jax.vmap(
                    lambda q: m3.quat_rotate(q, jnp.asarray([0.0, 0.0, 1.0]))
                )(rot)
                return jnp.sum(vel * fwd, axis=-1)  # [K]

            fwd_speed = jax.vmap(agent_fwd)(batch)
            if self.n_agents == 1:
                fwd_speed = fwd_speed[:, 0]
        reward = fwd_speed * (self.cfg.physics.fixed_dt * self.substeps)
        return batch, cache, obs, reward, info

    # ------------------------------------------------------------------
    def reset(self):
        self.state = self._build_batch()
        if self.static_bake:
            self.baked = self._bake_static()
        self.cache = self._build_cache()
        if self.obs_mode == "state":
            shape = (
                (self.n_envs, self.STATE_OBS_DIM)
                if self.n_agents == 1
                else (self.n_envs, self.n_agents, self.STATE_OBS_DIM)
            )
        elif self.n_agents == 1:
            shape = (self.n_envs, self.raster.height, self.raster.width, 4)
        else:
            shape = (
                self.n_envs, self.n_agents,
                self.raster.height, self.raster.width, 4,
            )
        return np.zeros(shape, np.float32)

    def step(self, actions):
        """actions [N,4] (or [N,K,4] when n_agents=K>1) ->
        (obs, reward [N] or [N,K]); obs per obs_mode (see __init__)."""
        self.state, self.cache, obs, reward, info = self._step_jit(
            self.state, self.cache, jnp.asarray(actions, jnp.float32),
            self.baked if self.static_bake else None,
        )
        self.last_info = {k: int(v) for k, v in info.items()}
        return obs, reward

    def _rollout_impl(self, batch, cache, actions, length, baked=None):
        def body(carry, _):
            b, c, nans = carry
            b, c, obs, rew, info = self._step_impl(b, c, actions, baked)
            # obs consumed on device (policy stand-in): per-env mean pool
            # (any obs_mode: reduce every non-env axis)
            return (b, c, nans + info["nan_rollbacks"]), (
                jnp.mean(obs.reshape(obs.shape[0], -1), axis=-1),
                rew,
            )

        (batch, cache, nans), aux = jax.lax.scan(
            body, (batch, cache, jnp.int32(0)), None, length=length
        )
        return batch, cache, nans, aux

    def make_policy_rollout(self, policy, length: int):
        """Pure policy-in-the-loop rollout for on-device RL training.

        `policy(params, obs, key) -> (actions, logp [N])` — obs/actions in
        this env's shapes (obs per obs_mode; actions [N,K,4] when
        n_agents=K>1)
        runs on the SAME chip inside the rollout scan — observations never
        cross the host link (the deployment shape BASELINE config #5 is
        for; `rollout` with fixed actions is just the benchmark harness).

        Returns a pure function
            (batch, cache, params, key) ->
                (batch, cache, (rewards [L,N], logps [L,N], obs_means [L,N]))
        that callers jit/grad themselves. It is differentiable w.r.t.
        `params` through the per-step policy application ONLY: actions are
        stop_gradient'ed into the sim (score-function/REINFORCE estimators
        need no path through physics or raster, and differentiating the
        whole engine step would store every intermediate of the frame).
        See examples/train_reinforce.py for the full training loop.

        One call is ONE device launch: keep `length * n_envs` under
        MAX_ENVSTEPS_PER_LAUNCH (the launch-length bound) and loop on the
        host for longer training rollouts —
        the pure-fn shape makes that loop a natural optimizer step.
        """

        baked = self.baked  # device-array const when static_bake is on

        def fn(batch, cache, params, key):
            obs0 = self._obs_batched(batch, baked)

            def body(carry, k):
                b, c, obs = carry
                actions, logp = policy(params, obs, k)
                b, c, obs2, rew, _info = self._step_impl(
                    b, c, jax.lax.stop_gradient(actions), baked
                )
                return (b, c, obs2), (
                    rew,
                    logp,
                    jnp.mean(obs2.reshape(obs2.shape[0], -1), axis=-1),
                )

            keys = jax.random.split(key, length)
            (batch, cache, _), aux = jax.lax.scan(
                body, (batch, cache, obs0), keys
            )
            return batch, cache, aux

        return fn

    def make_trajectory_rollout(
        self, actor_critic, length: int, thread_baked: bool = False
    ):
        """On-device trajectory collection for actor-critic methods (PPO).

        `actor_critic(params, obs, key) ->
            (actions [N,4], logp [N], value [N], store)`
        runs inside the rollout scan like `make_policy_rollout`'s policy;
        `store` is whatever pytree the UPDATE phase needs to recompute
        logp/value under new params (e.g. {'obs': pooled_obs, 'raw':
        pre-squash sample} — store encodings, not necessarily raw pixels:
        the caller controls the memory/length trade).

        Returns a pure non-differentiated collection function
            (batch, cache, params, key) -> (batch, cache, traj)
        with traj = {'store' [L,...], 'logp' [L,N], 'value' [L,N],
        'reward' [L,N], 'last_value' [N]} — last_value bootstraps GAE
        (scx.rl.gae). PPO's update epochs (scx.rl.make_ppo_train_step)
        differentiate through `apply(params, store)` instead, so the
        rollout itself never builds a grad tape over the engine step.

        Same launch-budget rule as make_policy_rollout: one call is ONE
        device launch — keep `length * n_envs` under
        MAX_ENVSTEPS_PER_LAUNCH (the launch-length bound) and loop on the
        host for longer collection horizons.

        thread_baked=True returns fn(batch, cache, params, key, baked)
        instead, taking the static-bake columns as an explicit
        (shardable) argument — required under shard_map, where a
        closure-captured per-env array is replicated, not sharded
        (scx.rl.make_ppo_train_step threads it automatically).
        """

        def impl(batch, cache, params, key, baked):
            obs0 = self._obs_batched(batch, baked)

            def body(carry, k):
                b, c, obs = carry
                actions, logp, value, store = actor_critic(params, obs, k)
                b, c, obs2, rew, _info = self._step_impl(
                    b, c, jax.lax.stop_gradient(actions), baked
                )
                return (b, c, obs2), (store, logp, value, rew)

            keys = jax.random.split(key, length + 1)
            (batch, cache, obs_last), (store, logp, value, rew) = jax.lax.scan(
                body, (batch, cache, obs0), keys[:length]
            )
            _, _, last_value, _ = actor_critic(params, obs_last, keys[length])
            traj = {
                "store": store,
                "logp": logp,
                "value": value,
                "reward": rew,
                "last_value": last_value,
            }
            return batch, cache, jax.lax.stop_gradient(traj)

        if thread_baked:
            return impl
        baked = self.baked  # device-array const when static_bake is on
        return lambda batch, cache, params, key: impl(
            batch, cache, params, key, baked
        )

    # pre-measurement launch budget (env-steps): the AdaptiveChunker
    # starts from this constant and then sizes launches from MEASURED
    # durations, bounding how long one launch runs. aux stays on device
    # between chunks so the host link only carries the tiny [chunk, N]
    # means per chunk.
    MAX_ENVSTEPS_PER_LAUNCH = 16384

    def rollout(self, actions, length: int = 10, chunk: int | None = None):
        """Device-chained rollout: `length` full steps (sim + traffic +
        render) scanned inside a jit, observations consumed on device.

        This is the deployment shape when the policy lives on the same
        device (obs never cross the host link); `step()` pays a host
        round-trip per call. Long rollouts are split into device launches
        sized by a measured-duration controller (scx.core.launch) toward
        a ~20 s/launch target; pass `chunk` to force a fixed size.
        Returns (obs_means [L,N], rewards [L,N]).
        """
        import time as _time

        from scx.core.launch import AdaptiveChunker

        if self._chunker is None:
            self._chunker = AdaptiveChunker(
                init_env_steps=self.MAX_ENVSTEPS_PER_LAUNCH
            )
        if self._rollout_jit is None:
            # donate the fleet state + warm-start caches: the rollout's
            # outputs alias its inputs (hundreds of MB at 4096 envs), so
            # donation saves one whole-pytree HBM copy per launch. Safe:
            # self.state/self.cache are reassigned from the outputs below
            # (donation is a no-op with a warning on the CPU test backend)
            self._rollout_jit = jax.jit(
                self._rollout_impl, static_argnums=3, donate_argnums=(0, 1)
            )
        actions = jnp.asarray(actions, jnp.float32)
        nan_parts = []  # kept on device: no host sync between launches
        auxes = []
        done = 0
        while done < length:
            if chunk is not None:
                step_n = min(chunk, length - done)
            else:
                step_n = self._chunker.chunk_steps(self.n_envs, length - done)
            first_compile = step_n not in self._launched_lengths
            t0 = _time.perf_counter()
            self.state, self.cache, nans, aux = self._rollout_jit(
                self.state, self.cache, actions, step_n, self.baked
            )
            done += step_n
            self._launched_lengths.add(step_n)
            if chunk is None and done < length and not first_compile:
                # measuring requires a sync; only pay it when another
                # launch follows (chunk boundaries are seconds apart).
                # First-compile launches are skipped: their wall time is
                # dominated by XLA compilation, not execution.
                jax.block_until_ready(nans)
                self._chunker.observe(
                    self.n_envs, step_n, _time.perf_counter() - t0
                )
            auxes.append(aux)
            nan_parts.append(nans)
        self.last_info = {
            "nan_rollbacks": int(sum(int(n) for n in nan_parts)),
            "pair_overflow": 0,
        }
        if len(auxes) == 1:
            return auxes[0]
        return jax.tree.map(lambda *xs: jnp.concatenate(xs, axis=0), *auxes)

    def rollout_sharded(self, actions, length: int = 10, mesh=None):
        """Multi-chip rollout: the env axis sharded over the mesh's 'dp'
        axis, the SAME device-chained scan as `rollout` running per shard
        inside shard_map, fleet telemetry reduced across chips with psum.

        This is the scale-out deployment shape (SURVEY §2 parallelism
        items 6-7): per-env computation is untouched, so results are
        bitwise equal to the unsharded `rollout` on the same envs; only
        placement and the psum'd stats involve the mesh (jax.lax.psum).
        Keep `length * n_envs/dp` under MAX_ENVSTEPS_PER_LAUNCH and loop
        on the host for longer rollouts (see `rollout`).
        Returns ((obs_means [L,N], rewards [L,N]), stats dict of global
        scalars).
        """
        from jax import shard_map
        from jax.sharding import NamedSharding, PartitionSpec as P

        from scx.parallel.mesh import make_mesh, shard_env_batch

        if mesh is None:
            mesh = make_mesh()
        dp = mesh.shape["dp"]
        if self.n_envs % dp:
            raise ValueError(f"n_envs {self.n_envs} not divisible by dp={dp}")
        key = (length, mesh)
        if self._rollout_sharded_key != key:
            def local(batch, cache, acts, baked):
                batch, cache, nans, (obs_means, rewards) = self._rollout_impl(
                    batch, cache, acts, length, baked
                )
                stats = {
                    "alive": jnp.sum(batch.alive.astype(jnp.int32)),
                    "reward_sum": jnp.sum(rewards),
                    "player_speed": jnp.sum(
                        jnp.linalg.norm(batch.body.vel[:, self.player], axis=-1)
                    ),
                    "nan_rollbacks": nans,
                }
                stats = jax.tree.map(lambda x: jax.lax.psum(x, "dp"), stats)
                return batch, cache, (obs_means, rewards), stats

            fn = shard_map(
                local,
                mesh=mesh,
                in_specs=(P("dp"), P("dp"), P("dp"), P("dp")),
                out_specs=(P("dp"), P("dp"), (P(None, "dp"), P(None, "dp")), P()),
                check_vma=False,
            )
            # donate state + caches (same aliasing argument as rollout's
            # jit; both are reassigned from the outputs below)
            self._rollout_sharded_jit = jax.jit(fn, donate_argnums=(0, 1))
            self._rollout_sharded_key = key
        self.state = shard_env_batch(self.state, mesh)
        self.cache = shard_env_batch(self.cache, mesh)
        if self.baked is not None:
            self.baked = shard_env_batch(self.baked, mesh)
        acts = jax.device_put(
            jnp.asarray(actions, jnp.float32), NamedSharding(mesh, P("dp"))
        )
        self.state, self.cache, aux, stats = self._rollout_sharded_jit(
            self.state, self.cache, acts, self.baked
        )
        return aux, stats

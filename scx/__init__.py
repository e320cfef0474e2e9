"""scx — a batched sim+render engine in JAX.

A ground-up JAX/XLA/Pallas rebuild of the capability surface of
SandboxCityEngine (reference: Skeletus/SC-GameEngine): flat ECS + scheduler,
rigid-body physics + raycast vehicles, sector-streamed open world, 3-tier
traffic simulation, and a tiled software rasterizer — redesigned as
struct-of-arrays state advanced by pure jitted functions, vmapped/sharded
over thousands of city scenes.

Layer map (mirrors reference AGENTS.md:27-44 Core -> Engine -> Sandbox):
  scx.core      -- math, PRNG (bit-compatible hashes), config, timing, logging
  scx.state     -- SoA entity state (functional ECS) + scheduler
  scx.ops       -- Pallas kernels (the rasterizer)
  scx.physics   -- rigid bodies, broadphase, impulse solver, queries, vehicles
  scx.world     -- sector formats, procedural gen, streaming, culling
  scx.traffic   -- lane graph, spawner, LOD tiers, AI
  scx.render    -- frame graph: camera, cull, raster, debug draw
  scx.assets    -- registry, GLB import, textures, residency
  scx.parallel  -- device mesh / sharding / collectives
  scx.telemetry -- snapshot stats & named scopes
  scx.tools     -- editor core (document, commands, picking)
  scx.app       -- sandbox composition (the integration "exe")
"""

__version__ = "0.1.0"

"""Spatially-sharded ('sp') rendering: render_frame_rows strips must equal
the full-frame render — per strip, and composed over a shard_map mesh.

The reference has no multi-GPU render; strips are this engine's answer to
one frame too big for a device (SURVEY §2 parallelism item 6)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from scx import render as rd
from scx.core import math3d as m3
from scx.render import pipeline as pipe


def _scene(params):
    pool = rd.build_mesh_pool()
    vp = rd.camera_view_proj(
        jnp.asarray([1.5, 1.2, 2.5]), jnp.asarray([0.0, 0.0, 0.0]),
        jnp.asarray([0.0, 1.0, 0.0]), aspect=params.width / params.height,
    )
    models = [
        m3.mat4_trs(
            jnp.asarray([dx, 0.0, dz]), jnp.asarray([0.0, a, 0.0]), jnp.ones(3)
        )
        for dx, dz, a in [(0.0, 0.0, 0.3), (1.2, -0.5, 0.9), (-1.0, 0.4, 0.0),
                          (0.4, 1.1, 1.7), (-0.6, -0.8, 2.4)]
    ]
    draws = rd.DrawList(
        mesh_id=jnp.full((5,), rd.MESH_CUBE, jnp.int32),
        material_id=jnp.arange(5, dtype=jnp.int32) % 3,
        model=jnp.stack(models),
        valid=jnp.ones((5,), bool),
    )
    return pool, vp, draws


@pytest.mark.parametrize("use_clusters", [True, False])
def test_strips_compose_to_full_frame(use_clusters):
    params = rd.RasterParams(
        width=128, height=64, tile_h=16, tile_w=128,
        max_tris=256, max_tris_per_tile=64, max_clusters_per_tile=4,
        use_clusters=use_clusters, interpret=True,
    )
    pool, vp, draws = _scene(params)
    full_rgb, full_g, _ = pipe.render_frame(draws, pool, vp, params)
    # the full frame itself is the reference rasterizer's G-buffer
    from scx.ops.raster import rasterize_reference

    d = pipe.sort_draws_spatial(draws, vp, params) if use_clusters else draws
    ref = rasterize_reference(pipe.setup_triangles(d, pool, vp, params)[0], params)
    np.testing.assert_allclose(
        np.asarray(full_g["depth"]), np.asarray(ref["depth"]), atol=1e-5
    )
    np.testing.assert_array_equal(
        np.asarray(full_g["mat"]), np.asarray(ref["mat"])
    )

    strip_rows = 16
    strips = []
    for row0 in range(0, params.height, strip_rows):
        rgb, g, _ = pipe.render_frame_rows(
            draws, pool, vp, params, row0, strip_rows
        )
        assert rgb.shape == (strip_rows, params.width, 3)
        strips.append(rgb)
    got = jnp.concatenate(strips, axis=0)
    np.testing.assert_allclose(np.asarray(got), np.asarray(full_rgb), atol=1e-5)


def test_strip_validity_mask_culls_offstrip_tris():
    params = rd.RasterParams(
        width=128, height=64, tile_h=16, tile_w=128,
        max_tris=256, max_tris_per_tile=64, interpret=True,
    )
    pool, vp, draws = _scene(params)
    setup, aabb, valid = pipe.setup_triangles(draws, pool, vp, params)
    # strip far below all geometry: everything culled, zero occupancy
    s2, a2, v2 = pipe.shift_setup_rows(setup, aabb, valid, 4096, 16)
    assert not bool(v2.any())


def test_sharded_rows_match_full_frame_over_mesh():
    """shard_map over 'sp': each device rasterizes its own strip only."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from scx.parallel.mesh import make_mesh

    params = rd.RasterParams(
        width=128, height=64, tile_h=8, tile_w=128,
        max_tris=256, max_tris_per_tile=64, interpret=True,
    )
    pool, vp, draws = _scene(params)
    full_rgb, _, _ = pipe.render_frame(draws, pool, vp, params)

    mesh = make_mesh(dp=1, sp=8)
    sp = mesh.shape["sp"]
    rows_per = params.height // sp

    def local(d):
        row0 = jax.lax.axis_index("sp") * rows_per
        rgb, _, _ = pipe.render_frame_rows(d, pool, vp, params, row0, rows_per)
        return rgb

    fn = shard_map(
        local, mesh=mesh, in_specs=(P(),), out_specs=P("sp", None, None),
        check_vma=False,
    )
    got = jax.jit(fn)(draws)
    assert got.shape == (params.height, params.width, 3)
    np.testing.assert_allclose(np.asarray(got), np.asarray(full_rgb), atol=1e-5)

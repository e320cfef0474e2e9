"""Rasterizer: reference-vs-kernel (Pallas interpret mode) equivalence,
depth test, perspective correctness, end-to-end cube frame, sub-tile
choice, padding and empty tiles."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from scx import render as rd
from scx.core import math3d as m3
from scx.ops import raster as ops
from scx.render import pipeline as pipe


def small_params(**kw):
    base = dict(
        width=256, height=64, tile_h=16, tile_w=128,
        max_tris=256, max_tris_per_tile=64, interpret=True,
    )
    base.update(kw)
    return rd.RasterParams(**base)


def ortho_vp(w=4.0, h=1.0):
    """Simple orthographic-ish viewProj mapping x in [-w/2,w/2] -> ndc."""
    m = jnp.zeros((4, 4))
    m = m.at[0, 0].set(2.0 / w)
    m = m.at[1, 1].set(2.0 / h)
    m = m.at[2, 2].set(-0.01)  # z -> small depth
    m = m.at[2, 3].set(0.5)
    return m.at[3, 3].set(1.0)


def tri_draws(models):
    d = len(models)
    return rd.DrawList(
        mesh_id=jnp.full((d,), rd.MESH_TRIANGLE, jnp.int32),
        material_id=jnp.arange(d, dtype=jnp.int32),
        model=jnp.stack(models),
        valid=jnp.ones((d,), bool),
    )


def test_single_triangle_coverage_and_color():
    pool = rd.build_mesh_pool()
    params = small_params()
    draws = tri_draws([jnp.eye(4)])
    setup, aabb, valid = pipe.setup_triangles(draws, pool, ortho_vp(), params)
    assert int(valid.sum()) == 1
    g = ops.rasterize_reference(setup, params)
    cov = np.asarray(g["covered"])
    assert cov.sum() > 100
    # covered region is centered horizontally
    ys, xs = np.where(cov)
    assert abs(xs.mean() - 128) < 4
    # interpolated color stays within vertex color hull
    cols = np.asarray(g["color"])[cov]
    assert cols.min() >= 0.19 and cols.max() <= 1.01


def test_depth_ordering():
    pool = rd.build_mesh_pool()
    params = small_params()
    near = m3.mat4_translation(jnp.asarray([0.0, 0.0, 10.0]))   # z=10 -> depth 0.4
    far = m3.mat4_translation(jnp.asarray([0.0, 0.0, -10.0]))   # z=-10 -> depth 0.6
    # draw far first, then near: near must win
    draws = tri_draws([far, near])
    setup, aabb, valid = pipe.setup_triangles(draws, pool, ortho_vp(), params)
    g = ops.rasterize_reference(setup, params)
    mats = np.asarray(g["mat"])[np.asarray(g["covered"])]
    assert (mats == 1).all()
    d = np.asarray(g["depth"])[np.asarray(g["covered"])]
    np.testing.assert_allclose(d, 0.4, atol=1e-3)


def test_pallas_matches_reference():
    pool = rd.build_mesh_pool()
    params = small_params()
    vp = rd.camera_view_proj(
        jnp.asarray([1.5, 1.2, 2.5]),
        jnp.asarray([0.0, 0.0, 0.0]),
        jnp.asarray([0.0, 1.0, 0.0]),
        aspect=256 / 64,
    )
    models = [
        m3.mat4_trs(
            jnp.asarray([dx, 0.0, dz]),
            jnp.asarray([0.0, a, 0.0]),
            jnp.ones(3),
        )
        for dx, dz, a in [(0.0, 0.0, 0.3), (1.2, -0.5, 0.9), (-1.0, 0.4, 0.0)]
    ]
    draws = rd.DrawList(
        mesh_id=jnp.full((3,), rd.MESH_CUBE, jnp.int32),
        material_id=jnp.arange(3, dtype=jnp.int32),
        model=jnp.stack(models),
        valid=jnp.ones((3,), bool),
    )
    setup, aabb, valid = pipe.setup_triangles(draws, pool, vp, params)
    ref = ops.rasterize_reference(setup, params)

    binned, counts = pipe.bin_triangles(setup, aabb, valid, params)
    got = ops.rasterize_tiles(binned, params)

    np.testing.assert_allclose(
        np.asarray(got["depth"]), np.asarray(ref["depth"]), atol=1e-5
    )
    np.testing.assert_array_equal(np.asarray(got["mat"]), np.asarray(ref["mat"]))
    np.testing.assert_allclose(
        np.asarray(got["color"]), np.asarray(ref["color"]), atol=1e-4
    )


def test_perspective_correct_uv():
    """A quad going into the distance: at the screen midpoint of the
    projected quad, perspective-correct v != 0.5 (screen-linear would be)."""
    pool = rd.build_mesh_pool()
    params = small_params()
    vp = rd.camera_view_proj(
        jnp.asarray([0.0, 0.5, 2.0]),
        jnp.asarray([0.0, 0.0, -3.0]),
        jnp.asarray([0.0, 1.0, 0.0]),
        aspect=256 / 64,
    )
    # cube stretched deep in z: its top face acts as the receding quad
    model = m3.mat4_trs(
        jnp.asarray([0.0, -0.5, -2.0]), jnp.zeros(3), jnp.asarray([1.0, 0.5, 8.0])
    )
    draws = rd.DrawList(
        mesh_id=jnp.asarray([rd.MESH_CUBE], jnp.int32),
        material_id=jnp.asarray([0], jnp.int32),
        model=model[None],
        valid=jnp.ones((1,), bool),
    )
    setup, aabb, valid = pipe.setup_triangles(draws, pool, vp, params)
    g = ops.rasterize_reference(setup, params)
    cov = np.asarray(g["covered"])
    assert cov.sum() > 200
    uv = np.asarray(g["uv"])
    ys, xs = np.where(cov)
    mid = uv[ys[len(ys) // 2], xs[len(xs) // 2]]
    assert np.isfinite(mid).all()


def test_render_frame_end_to_end_with_texture():
    pool = rd.build_mesh_pool()
    params = small_params()
    vp = rd.camera_view_proj(
        jnp.asarray([2.0, 2.0, 3.0]),
        jnp.asarray([0.0, 0.0, 0.0]),
        jnp.asarray([0.0, 1.0, 0.0]),
        aspect=256 / 64,
    )
    draws = rd.DrawList(
        mesh_id=jnp.asarray([rd.MESH_CUBE], jnp.int32),
        material_id=jnp.asarray([0], jnp.int32),
        model=jnp.eye(4)[None],
        valid=jnp.ones((1,), bool),
    )
    # checker texture, material 0 uses it
    yy, xx = np.mgrid[0:8, 0:8]
    checker = ((yy + xx) % 2).astype(np.float32)
    tex = jnp.asarray(np.stack([checker] * 3, -1))[None]
    mats = pipe.Materials(
        texture_id=jnp.asarray([0], jnp.int32), tint=jnp.ones((1, 3))
    )
    rgb, g, stats = rd.render_frame(draws, pool, vp, params, mats, tex)
    assert rgb.shape == (64, 256, 3)
    cov = np.asarray(g["covered"])
    assert cov.sum() > 100
    assert int(stats["tile_overflow"]) == 0
    # background where uncovered
    bgpix = np.asarray(rgb)[~cov]
    np.testing.assert_allclose(
        bgpix, np.broadcast_to([0.05, 0.07, 0.1], bgpix.shape), atol=1e-5
    )


def test_bin_triangles_batched_matches_vmap():
    """bin_triangles_batched (folded-scatter fast path) == vmapped
    bin_triangles for a random env batch."""
    import jax
    import numpy as np
    from scx.render.pipeline import (
        RasterParams, bin_triangles, bin_triangles_batched, N_FIELDS,
    )

    p = RasterParams(
        width=128, height=64, tile_h=16, tile_w=128,
        max_tris=64, max_tris_per_tile=16, interpret=True,
    )
    rng = np.random.default_rng(7)
    e, t = 5, 64
    setup = jnp.asarray(rng.normal(size=(e, t, N_FIELDS)).astype(np.float32))
    x0 = rng.uniform(0, 128, (e, t)).astype(np.float32)
    y0 = rng.uniform(0, 64, (e, t)).astype(np.float32)
    aabb = jnp.stack(
        [x0, y0, x0 + rng.uniform(0, 200, (e, t)), y0 + rng.uniform(0, 80, (e, t))],
        axis=-1,
    ).astype(jnp.float32)
    valid = jnp.asarray(rng.uniform(size=(e, t)) < 0.6)

    b_ref, c_ref = jax.vmap(lambda s, a, v: bin_triangles(s, a, v, p))(
        setup, aabb, valid
    )
    b_new, c_new = bin_triangles_batched(setup, aabb, valid, p)
    np.testing.assert_array_equal(np.asarray(c_ref), np.asarray(c_new))
    np.testing.assert_allclose(np.asarray(b_ref), np.asarray(b_new), rtol=0, atol=0)


def _cubes_setup(params, camera=(1.5, 1.2, 2.5)):
    pool = rd.build_mesh_pool()
    vp = rd.camera_view_proj(
        jnp.asarray(camera), jnp.asarray([0.0, 0.0, 0.0]),
        jnp.asarray([0.0, 1.0, 0.0]), aspect=params.width / params.height,
    )
    models = [
        m3.mat4_trs(
            jnp.asarray([dx, 0.0, dz]), jnp.asarray([0.0, a, 0.0]), jnp.ones(3)
        )
        for dx, dz, a in [(0.0, 0.0, 0.3), (1.2, -0.5, 0.9), (-1.0, 0.4, 0.0)]
    ]
    draws = rd.DrawList(
        mesh_id=jnp.full((3,), rd.MESH_CUBE, jnp.int32),
        material_id=jnp.arange(3, dtype=jnp.int32),
        model=jnp.stack(models),
        valid=jnp.ones((3,), bool),
    )
    return pipe.setup_triangles(draws, pool, vp, params)


def _kernel_gbuffer(setup, aabb, valid, params):
    """G-buffer through the kernel of params' list form."""
    _, g, _ = pipe._raster_and_shade(setup, aabb, valid, params, None, None)
    return g


def _assert_matches_reference(got, ref):
    np.testing.assert_allclose(
        np.asarray(got["depth"]), np.asarray(ref["depth"]), atol=1e-5
    )
    np.testing.assert_array_equal(np.asarray(got["mat"]), np.asarray(ref["mat"]))
    np.testing.assert_allclose(
        np.asarray(got["color"]), np.asarray(ref["color"]), atol=1e-4
    )
    np.testing.assert_allclose(
        np.asarray(got["uv"]), np.asarray(ref["uv"]), atol=1e-4
    )


@pytest.mark.parametrize("use_clusters", [False, True])
@pytest.mark.parametrize("sub", [(8, 16), (16, 16), (16, 64), (32, 32)])
def test_subtile_choice_matches_reference(sub, use_clusters):
    """Every program sub-tile gives the reference G-buffer."""
    params = small_params(
        tile_h=32, sub_h=sub[0], sub_w=sub[1], use_clusters=use_clusters,
        max_clusters_per_tile=8,
    )
    assert ops.sub_tile(params) == sub
    setup, aabb, valid = _cubes_setup(params)
    _assert_matches_reference(
        _kernel_gbuffer(setup, aabb, valid, params),
        ops.rasterize_reference(setup, params),
    )


@pytest.mark.parametrize("use_clusters", [False, True])
def test_odd_frame_size_is_padded(use_clusters):
    """A 200x72 frame pads to whole bin tiles and crops back exactly."""
    params = small_params(
        width=200, height=72, use_clusters=use_clusters,
        max_clusters_per_tile=8,
    )
    assert params.tiles_x * params.tile_w > 200
    assert params.tiles_y * params.tile_h > 72
    setup, aabb, valid = _cubes_setup(params)
    got = _kernel_gbuffer(setup, aabb, valid, params)
    assert got["depth"].shape == (72, 200)
    assert got["color"].shape == (72, 200, 3)
    assert bool(got["covered"].any())
    _assert_matches_reference(got, ops.rasterize_reference(setup, params))


@pytest.mark.parametrize("use_clusters", [False, True])
def test_empty_tiles_stay_background(use_clusters):
    """Tiles with an empty list (and a frame with no live triangle at all)
    give depth 1, zero attributes and no coverage."""
    params = small_params(use_clusters=use_clusters, max_clusters_per_tile=8)
    setup, aabb, valid = _cubes_setup(params)
    # the cubes leave the top tile row empty
    _, counts = pipe.bin_triangles(setup, aabb, valid, params)
    assert int(counts[0]) == 0 and int(counts.max()) > 0
    g = _kernel_gbuffer(setup, aabb, valid, params)
    _assert_matches_reference(g, ops.rasterize_reference(setup, params))
    dead = jnp.zeros_like(valid)
    g0 = _kernel_gbuffer(setup, aabb, dead, params)
    assert not bool(g0["covered"].any())
    np.testing.assert_array_equal(np.asarray(g0["depth"]), 1.0)
    np.testing.assert_array_equal(np.asarray(g0["color"]), 0.0)
    np.testing.assert_array_equal(np.asarray(g0["mat"]), 0)


@pytest.mark.parametrize(
    "tile,want,got",
    [((64, 128), (32, 32), (32, 32)), ((16, 128), (32, 32), (16, 32)),
     ((8, 64), (16, 64), (8, 64)), ((24, 96), (32, 64), (8, 32))],
)
def test_sub_tile_fits_bin_tile(tile, want, got):
    """The program sub-tile is the largest power of two <= the requested
    size that divides the bin tile."""
    params = rd.RasterParams(
        tile_h=tile[0], tile_w=tile[1], sub_h=want[0], sub_w=want[1]
    )
    assert ops.sub_tile(params) == got

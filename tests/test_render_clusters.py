"""Cluster-binned raster path: equivalence with the reference rasterizer."""

import jax.numpy as jnp
import numpy as np

from scx import render as rd
from scx.core import math3d as m3
from scx.ops import raster as ops
from scx.ops import raster_clusters as rc
from scx.render import pipeline as pipe


def test_cluster_path_matches_reference():
    pool = rd.build_mesh_pool()
    params = rd.RasterParams(
        width=256, height=64, tile_h=16, tile_w=128,
        max_tris=256, max_tris_per_tile=64, max_clusters_per_tile=4,
        interpret=True,
    )
    vp = rd.camera_view_proj(
        jnp.asarray([1.5, 1.2, 2.5]), jnp.asarray([0.0, 0.0, 0.0]),
        jnp.asarray([0.0, 1.0, 0.0]), aspect=256 / 64,
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
    setup, aabb, valid = pipe.setup_triangles(draws, pool, vp, params)
    ref = ops.rasterize_reference(setup, params)

    cl_aabb, cl_valid = rc.cluster_bounds(aabb, valid, params.max_tris)
    cl_ids, cl_counts = rc.bin_clusters(cl_aabb, cl_valid, params, 4)
    got = rc.rasterize_clusters(setup, cl_ids, cl_counts, params, 4)

    np.testing.assert_allclose(
        np.asarray(got["depth"]), np.asarray(ref["depth"]), atol=1e-5
    )
    np.testing.assert_array_equal(np.asarray(got["mat"]), np.asarray(ref["mat"]))
    np.testing.assert_allclose(
        np.asarray(got["color"]), np.asarray(ref["color"]), atol=1e-4
    )


def test_cluster_bounds_and_binning():
    params = rd.RasterParams(
        width=256, height=64, tile_h=16, tile_w=128, max_tris=128,
        interpret=True,
    )
    t = params.max_tris
    aabb = np.zeros((t, 4), np.float32)
    valid = np.zeros(t, bool)
    # cluster 0: tris around x in [0,100] -> tile column 0 only
    aabb[0] = [10, 5, 90, 12]
    valid[0] = True
    # cluster 1: tri at x in [200,250] -> column 1
    aabb[rc.CLUSTER] = [200, 30, 250, 31]
    valid[rc.CLUSTER] = True
    cl_aabb, cl_valid = rc.cluster_bounds(jnp.asarray(aabb), jnp.asarray(valid), t)
    assert cl_valid.tolist()[:2] == [True, True]
    assert not any(cl_valid.tolist()[2:])
    ids, counts = rc.bin_clusters(cl_aabb, cl_valid, params, 4)
    counts = np.asarray(counts).reshape(params.tiles_y, params.tiles_x)
    # tile (0,0) sees cluster 0; tile (0,1) wait x=200 -> tile col 1; y=30 -> row 1
    assert counts[0, 0] == 1
    assert counts[1, 1] == 1
    assert counts.sum() == 2


def test_cluster_batched_matches_single():
    """rasterize_clusters_batched == per-env rasterize_clusters (VERDICT r2
    item 3: the fast cluster path, env-batched for RL observations)."""
    import jax

    pool = rd.build_mesh_pool()
    params = rd.RasterParams(
        width=128, height=64, tile_h=16, tile_w=128,
        max_tris=256, max_tris_per_tile=64, max_clusters_per_tile=8,
        interpret=True,
    )
    vp = rd.camera_view_proj(
        jnp.asarray([1.5, 1.2, 2.5]), jnp.asarray([0.0, 0.0, 0.0]),
        jnp.asarray([0.0, 1.0, 0.0]), aspect=128 / 64,
    )

    def one_env(seed):
        rng = np.random.RandomState(seed)
        models = [
            m3.mat4_trs(
                jnp.asarray(rng.uniform(-1.5, 1.5, 3).astype(np.float32)),
                jnp.asarray([0.0, rng.uniform(0, 3), 0.0], jnp.float32),
                jnp.ones(3),
            )
            for _ in range(4)
        ]
        draws = rd.DrawList(
            mesh_id=jnp.full((4,), rd.MESH_CUBE, jnp.int32),
            material_id=jnp.arange(4, dtype=jnp.int32),
            model=jnp.stack(models),
            valid=jnp.asarray([True, True, seed % 2 == 0, True]),
        )
        return pipe.setup_triangles(draws, pool, vp, params)

    envs = [one_env(s) for s in range(3)]
    setup = jnp.stack([e[0] for e in envs])
    aabb = jnp.stack([e[1] for e in envs])
    valid = jnp.stack([e[2] for e in envs])

    got, stats = pipe.raster_gbuffer_batched(setup, aabb, valid, params)
    assert int(stats["cluster_drop"]) == 0

    for i in range(3):
        cl_aabb, cl_valid, cl_zmin = rc.cluster_bounds(
            aabb[i], valid[i], params.max_tris, setup[i]
        )
        c_aabb, c_valid, c_zmin, order, _ = rc.compact_clusters(
            cl_aabb, cl_valid, cl_zmin
        )
        ids, counts = rc.bin_clusters(
            c_aabb, c_valid, params, params.max_clusters_per_tile, cl_zmin=c_zmin
        )
        ref = rc.rasterize_clusters(
            setup[i], order[ids], counts, params,
            params.max_clusters_per_tile, cl_zmin=cl_zmin,
        )
        np.testing.assert_allclose(
            np.asarray(got["depth"][i]), np.asarray(ref["depth"]), atol=1e-5
        )
        np.testing.assert_array_equal(
            np.asarray(got["mat"][i]), np.asarray(ref["mat"])
        )
        np.testing.assert_allclose(
            np.asarray(got["color"][i]), np.asarray(ref["color"]), atol=1e-4
        )


def _cube_scene(params, n=3):
    pool = rd.build_mesh_pool()
    vp = rd.camera_view_proj(
        jnp.asarray([1.5, 1.2, 2.5]), jnp.asarray([0.0, 0.0, 0.0]),
        jnp.asarray([0.0, 1.0, 0.0]), aspect=params.width / params.height,
    )
    placements = [(0.0, 0.0, 0.3), (1.2, -0.5, 0.9), (-1.0, 0.4, 0.0),
                  (0.4, 1.1, 1.7)][:n]
    models = [
        m3.mat4_trs(
            jnp.asarray([dx, 0.0, dz]), jnp.asarray([0.0, a, 0.0]), jnp.ones(3)
        )
        for dx, dz, a in placements
    ]
    draws = rd.DrawList(
        mesh_id=jnp.full((n,), rd.MESH_CUBE, jnp.int32),
        material_id=jnp.arange(n, dtype=jnp.int32),
        model=jnp.stack(models),
        valid=jnp.ones((n,), bool),
    )
    return pipe.setup_triangles(draws, pool, vp, params)


def test_cluster_hz_exit_matches_full_walk():
    """The hierarchical-z exit on near-to-far lists is exact: identical to
    walking every listed cluster."""
    params = rd.RasterParams(
        width=256, height=64, tile_h=16, tile_w=128,
        max_tris=256, max_tris_per_tile=64, max_clusters_per_tile=4,
        interpret=True,
    )
    setup, aabb, valid = _cube_scene(params)
    cl_aabb, cl_valid, cl_zmin = rc.cluster_bounds(
        aabb, valid, params.max_tris, setup
    )
    cl_ids, cl_counts = rc.bin_clusters(cl_aabb, cl_valid, params, 4,
                                        cl_zmin=cl_zmin)
    full = rc.rasterize_clusters(setup, cl_ids, cl_counts, params, 4)
    got = rc.rasterize_clusters(setup, cl_ids, cl_counts, params, 4,
                                cl_zmin=cl_zmin)
    for k in ("depth", "color", "uv"):
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(full[k]))
    np.testing.assert_array_equal(np.asarray(got["mat"]), np.asarray(full["mat"]))

    # batched path, 2 envs
    e = 2
    bcast = lambda x: jnp.broadcast_to(x, (e,) + x.shape)
    gb = rc.rasterize_clusters_batched(
        bcast(setup), bcast(cl_ids), bcast(cl_counts), params, 4,
        cl_zmin=bcast(cl_zmin),
    )
    for i in range(e):
        np.testing.assert_array_equal(
            np.asarray(gb["depth"][i]), np.asarray(full["depth"])
        )
        np.testing.assert_array_equal(
            np.asarray(gb["mat"][i]), np.asarray(full["mat"])
        )


def test_cluster_batched_matches_reference_per_env():
    """Envs of one batch rasterize independently: each env's G-buffer from
    the batched cluster path matches rasterize_reference on its own setup
    (envs differ in geometry, so a mixed-up env offset shows)."""
    params = rd.RasterParams(
        width=128, height=32, tile_h=16, tile_w=128,
        max_tris=64, max_clusters_per_tile=4, interpret=True,
    )
    envs = [_cube_scene(params, n) for n in (1, 2, 1, 2)]
    setup = jnp.stack([x[0] for x in envs])
    aabb = jnp.stack([x[1] for x in envs])
    valid = jnp.stack([x[2] for x in envs])
    got, stats = pipe.raster_gbuffer_batched(setup, aabb, valid, params)
    assert int(stats["cluster_drop"]) == 0
    for i in range(len(envs)):
        ref = ops.rasterize_reference(setup[i], params)
        np.testing.assert_allclose(
            np.asarray(got["depth"][i]), np.asarray(ref["depth"]), atol=1e-5
        )
        np.testing.assert_array_equal(
            np.asarray(got["mat"][i]), np.asarray(ref["mat"])
        )

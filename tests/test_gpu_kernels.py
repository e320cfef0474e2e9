"""Compiled (not interpreted) raster kernels on the card against the
reference rasterizer. Marked `gpu`: they skip on a host without a CUDA
GPU, where the interpret-mode tests of the same kernels run instead."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from scx import render as rd
from scx.core import math3d as m3
from scx.ops import raster as ops
from scx.render import pipeline as pipe


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs a CUDA GPU (Triton kernels have no CPU build)")


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
        for dx, dz, a in [(0.0, 0.0, 0.3), (1.2, -0.5, 0.9), (-1.0, 0.4, 0.0)]
    ]
    draws = rd.DrawList(
        mesh_id=jnp.full((3,), rd.MESH_CUBE, jnp.int32),
        material_id=jnp.arange(3, dtype=jnp.int32),
        model=jnp.stack(models),
        valid=jnp.ones((3,), bool),
    )
    return pipe.setup_triangles(draws, pool, vp, params)


@pytest.mark.gpu
@pytest.mark.parametrize("use_clusters", [False, True])
def test_compiled_kernel_matches_reference(gpu, use_clusters):
    params = rd.RasterParams(
        width=256, height=64, tile_h=32, tile_w=128, max_tris=256,
        max_tris_per_tile=64, max_clusters_per_tile=8,
        use_clusters=use_clusters, interpret=False,
    )
    setup, aabb, valid = _scene(params)
    _, got, _ = jax.jit(
        lambda s, a, v: pipe._raster_and_shade(s, a, v, params, None, None)
    )(setup, aabb, valid)
    ref = jax.jit(lambda s: ops.rasterize_reference(s, params))(setup)
    both = np.asarray(got["covered"]) & np.asarray(ref["covered"])
    # FMA contraction may move a pixel that sits exactly on an edge
    mismatch = (np.asarray(got["covered"]) != np.asarray(ref["covered"])) | (
        both & (np.asarray(got["mat"]) != np.asarray(ref["mat"]))
    )
    assert mismatch.mean() <= 5e-4
    ok = both & ~mismatch
    np.testing.assert_allclose(
        np.asarray(got["depth"])[ok], np.asarray(ref["depth"])[ok], atol=1e-5
    )

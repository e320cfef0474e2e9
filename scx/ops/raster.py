"""Tiled software rasterizer — the engine's Vulkan replacement.

Pallas kernels through Triton: one program per screen sub-tile of
(sub_h, sub_w) pixels, sized to registers. The pipeline bins triangles
into screen tiles of (tile_h, tile_w) pixels; every program of a bin tile
walks that tile's list. Two list forms share one program body:

  * triangle-binned (this module): setup rows pre-gathered per tile into a
    padded [n_tiles, K, F] array, walked as one run of `count` rows;
  * cluster-binned (scx.ops.raster_clusters): per-tile lists of 32-triangle
    clusters, walked near-to-far with an exact hierarchical-z exit.

Per triangle: three edge/depth planes evaluated over the sub-tile's pixel
lattice, z-buffer test in RH zero-to-one depth (smaller = closer, matching
the reference's perspective, sc_math.cpp:209-232). Depth and the winning
setup row are loop carries held in registers. After the walk, each covered
pixel gathers its winner's attribute planes from the setup buffer (it sits
in L2) and interpolates them perspective-correctly — attribute math runs
once per pixel, not once per triangle.

Outputs a planar G-buffer: depth [H,W] and rgb/uv/material planes;
texturing happens afterwards in XLA (deferred shading).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from scx.render import pipeline as pipe

N_ATTR = 6  # r, g, b, u, v, mat


def sub_tile(params) -> tuple[int, int]:
    """Program sub-tile: the largest power-of-two size <= (sub_h, sub_w)
    that divides the bin tile (Triton blocks are powers of two)."""

    def fit(want, tile):
        s = 1
        while s * 2 <= want and tile % (s * 2) == 0:
            s *= 2
        return s

    return fit(params.sub_h, params.tile_h), fit(params.sub_w, params.tile_w)


def raster_program(tri_ref, n_items, item_rows, item_zmin, y0, x0, sub):
    """Shared per-program body. Walks items k < n_items; item k covers
    setup rows [item_rows(k)) = (start, stop) of `tri_ref` [rows, F].
    `item_zmin(k)` is the item's min depth (None: never exit early): with
    items ordered near-to-far, the first item whose zmin >= the sub-tile's
    max depth cannot win a pixel, and neither can any later one, so the
    walk ends there (exact). Returns (depth, attribute planes)."""
    py = jax.lax.broadcasted_iota(jnp.int32, sub, 0).astype(jnp.float32) + (
        y0.astype(jnp.float32) + 0.5
    )
    px = jax.lax.broadcasted_iota(jnp.int32, sub, 1).astype(jnp.float32) + (
        x0.astype(jnp.float32) + 0.5
    )

    def plane(row, base):
        return (
            tri_ref[row, base] * px
            + tri_ref[row, base + 1] * py
            + tri_ref[row, base + 2]
        )

    def tri_step(row, carry):
        depth, win = carry
        l0 = plane(row, pipe.F_L0)
        l1 = plane(row, pipe.F_L1)
        z = plane(row, pipe.F_Z)
        # strict '<': on equal depth the earlier triangle keeps the pixel
        hit = (l0 >= 0.0) & (l1 >= 0.0) & (l0 + l1 <= 1.0) & (z >= 0.0)
        hit &= z < depth
        return jnp.where(hit, z, depth), jnp.where(hit, row, win)

    def cond(carry):
        k, stop, _, _ = carry
        return (k < n_items) & jnp.logical_not(stop)

    def body(carry):
        k, _, depth, win = carry
        start, stop_row = item_rows(k)
        zmin = -jnp.inf if item_zmin is None else item_zmin(k)
        stop = zmin >= jnp.max(depth)
        stop_row = jnp.where(stop, start, stop_row)
        depth, win = jax.lax.fori_loop(start, stop_row, tri_step, (depth, win))
        return k + 1, stop, depth, win

    depth0 = jnp.ones(sub, jnp.float32)
    win0 = jnp.full(sub, -1, jnp.int32)
    _, _, depth, win = jax.lax.while_loop(
        cond, body, (jnp.int32(0), jnp.bool_(False), depth0, win0)
    )

    # winner attributes: one gather per plane coefficient per pixel
    covered = win >= 0
    row = jnp.maximum(win, 0)
    inv_iw = 1.0 / jnp.maximum(plane(row, pipe.F_IW), 1e-12)
    attrs = [
        plane(row, pipe.F_COL + 0) * inv_iw,
        plane(row, pipe.F_COL + 3) * inv_iw,
        plane(row, pipe.F_COL + 6) * inv_iw,
        plane(row, pipe.F_UV + 0) * inv_iw,
        plane(row, pipe.F_UV + 3) * inv_iw,
        tri_ref[row, pipe.F_MAT],
    ]
    return depth, [jnp.where(covered, a, 0.0) for a in attrs]


def raster_call(program, operands, n_envs, params):
    """pallas_call over (env, sub-tile row, sub-tile column) programs.

    `program(env, ty, tx, y0, x0, sub, *refs)` returns (depth, attrs) for
    the sub-tile at pixel (y0, x0) of env's frame, inside bin tile
    (ty, tx). Operands are whole arrays in device memory; each program
    loads its own list entries. Outputs are one [E*h_pad, w_pad] plane per
    G-buffer channel. Pallas folds the env axis into CUDA's x grid
    dimension, so fleet sizes past the 65,535 y/z limit launch as is."""
    sh, sw = sub = sub_tile(params)
    h_pad = params.tiles_y * params.tile_h
    w_pad = params.tiles_x * params.tile_w
    nsy, nsx = h_pad // sh, w_pad // sw
    n_in = len(operands)

    def kernel(*refs):
        env, sy, sx = pl.program_id(0), pl.program_id(1), pl.program_id(2)
        y0, x0 = sy * sh, sx * sw
        depth, attrs = program(
            env, y0 // params.tile_h, x0 // params.tile_w, y0, x0, sub,
            *refs[:n_in],
        )
        outs = refs[n_in:]
        outs[0][...] = depth
        for o, a in zip(outs[1:], attrs):
            o[...] = a

    plane_shape = jax.ShapeDtypeStruct((n_envs * h_pad, w_pad), jnp.float32)
    out_spec = pl.BlockSpec((sh, sw), lambda e, y, x: (e * nsy + y, x))
    planes = pl.pallas_call(
        kernel,
        grid=(n_envs, nsy, nsx),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)] * n_in,
        out_specs=[out_spec] * (1 + N_ATTR),
        out_shape=[plane_shape] * (1 + N_ATTR),
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=params.num_warps, num_stages=1
        ),
        interpret=params.interpret,
        name="raster",
    )(*operands)
    h, w = params.height, params.width
    depth, *attrs = (p.reshape(n_envs, h_pad, w_pad)[:, :h, :w] for p in planes)
    return {
        "depth": depth,
        "color": jnp.stack(attrs[0:3], axis=-1),
        "uv": jnp.stack(attrs[3:5], axis=-1),
        "mat": attrs[5].astype(jnp.int32),
        "covered": depth < 1.0,
    }


def rasterize_tiles_batched(binned, counts, params) -> dict:
    """Triangle-binned raster: binned [E, n_tiles, K, F], counts
    [E, n_tiles] -> G-buffer with a leading env dim. Each program walks
    its bin tile's `count` pre-gathered setup rows in index order."""
    e, n_tiles, k, _ = binned.shape
    counts = jnp.minimum(counts, k).astype(jnp.int32)

    def program(env, ty, tx, y0, x0, sub, cnt_ref, tri_ref):
        tile = env * n_tiles + ty * params.tiles_x + tx
        start = tile * k
        return raster_program(
            tri_ref, 1, lambda _: (start, start + cnt_ref[tile]), None,
            y0, x0, sub,
        )

    return raster_call(
        program,
        (counts.reshape(e * n_tiles), binned.reshape(e * n_tiles * k, -1)),
        e, params,
    )


def rasterize_tiles(binned, params, counts=None) -> dict:
    """binned: [n_tiles, K, N_FIELDS] -> G-buffer dict (depth/color/uv/mat).

    counts: [n_tiles] i32 per-tile occupancy (dynamic loop bound); defaults
    to the full K when not provided.
    """
    if counts is None:
        counts = jnp.full((binned.shape[0],), binned.shape[1], jnp.int32)
    g = rasterize_tiles_batched(binned[None], counts[None], params)
    return jax.tree.map(lambda x: x[0], g)


# ---------------------------------------------------------------------------
# Pure-XLA reference rasterizer (golden tests, tiny images)
# ---------------------------------------------------------------------------

def rasterize_reference(setup, params) -> dict:
    """Same math as the kernel, brute force over all pixels x triangles via
    lax.scan — O(T*H*W), for validation only."""
    h, w = params.height, params.width
    py = jnp.arange(h, dtype=jnp.float32)[:, None] + 0.5
    px = jnp.arange(w, dtype=jnp.float32)[None, :] + 0.5

    def tri_step(carry, s):
        depth, attrs = carry

        def ev(base):
            return s[base] * px + s[base + 1] * py + s[base + 2]

        l0 = ev(pipe.F_L0)
        l1 = ev(pipe.F_L1)
        cov = (l0 >= 0.0) & (l1 >= 0.0) & (l0 + l1 <= 1.0)
        z = ev(pipe.F_Z)
        mask = cov & (z < depth) & (z >= 0.0)
        inv_iw = 1.0 / jnp.maximum(ev(pipe.F_IW), 1e-12)

        new = jnp.stack(
            [
                ev(pipe.F_COL + 0) * inv_iw,
                ev(pipe.F_COL + 3) * inv_iw,
                ev(pipe.F_COL + 6) * inv_iw,
                ev(pipe.F_UV + 0) * inv_iw,
                ev(pipe.F_UV + 3) * inv_iw,
                jnp.broadcast_to(s[pipe.F_MAT], (h, w)),
            ]
        )
        depth = jnp.where(mask, z, depth)
        attrs = jnp.where(mask[None], new, attrs)
        return (depth, attrs), None

    depth0 = jnp.ones((h, w), jnp.float32)
    attrs0 = jnp.zeros((N_ATTR, h, w), jnp.float32)
    (depth, attrs), _ = jax.lax.scan(tri_step, (depth0, attrs0), setup)
    return {
        "depth": depth,
        "color": jnp.moveaxis(attrs[0:3], 0, -1),
        "uv": jnp.moveaxis(attrs[3:5], 0, -1),
        "mat": attrs[5].astype(jnp.int32),
        "covered": depth < 1.0,
    }

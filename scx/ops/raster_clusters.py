"""Cluster-binned rasterizer — the path for large frames.

Per-triangle tile lists need a compaction over every (tile, triangle)
pair, which at 100k triangles costs more than the raster itself.
Grouping 32 consecutive triangles of the expanded draw buffer into a
cluster (triangles of a draw are spatially coherent — the meshlet idea)
shrinks the binning domain 32x: a dense [tiles, clusters] overlap matrix
plus one top_k yields per-tile cluster lists, ordered near-to-far.

The kernel (scx.ops.raster's shared program body) walks each sub-tile's
cluster list: a listed cluster's 32 setup rows are read straight from the
[T, F] setup buffer, and the walk stops at the first cluster whose min
depth cannot beat the sub-tile's farthest pixel. Per-program work is
bounded by the tile's real cluster count.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from scx.ops import raster
from scx.render import pipeline as pipe

CLUSTER = 32  # triangles per cluster


def cluster_bounds(aabb, valid, max_tris: int, setup=None):
    """Per-cluster screen AABB + validity (+ min depth when setup given)."""
    c = max_tris // CLUSTER
    ab = aabb.reshape(c, CLUSTER, 4)
    v = valid.reshape(c, CLUSTER)
    big = jnp.float32(1e9)
    xmin = jnp.min(jnp.where(v, ab[:, :, 0], big), axis=1)
    ymin = jnp.min(jnp.where(v, ab[:, :, 1], big), axis=1)
    xmax = jnp.max(jnp.where(v, ab[:, :, 2], -big), axis=1)
    ymax = jnp.max(jnp.where(v, ab[:, :, 3], -big), axis=1)
    cl_valid = jnp.any(v, axis=1)
    bounds = jnp.stack([xmin, ymin, xmax, ymax], -1)
    if setup is None:
        return bounds, cl_valid
    tz = setup[:, pipe.F_ZMIN].reshape(c, CLUSTER)
    zmin = jnp.min(jnp.where(v, tz, big), axis=1)
    return bounds, cl_valid, zmin


def compact_clusters(cl_aabb, cl_valid, cl_zmin=None, cap: int | None = None):
    """Live-first stable compaction of the cluster arrays.

    The overlap matrix and top_k in bin_clusters scale with the CLUSTER
    CAPACITY (max_tris/CLUSTER), not the live count — at 131k max_tris
    that is 4096 columns for ~1200 live clusters.  One small argsort
    packs live clusters first (preserving draw order) so binning runs on
    a static cap of half the capacity.  Returns (aabb, valid, zmin,
    order, dropped) where order maps compact index -> original cluster id
    and dropped counts live clusters truncated past cap (overflow is
    counted, never silent — surface it in the frame stats)."""
    c = cl_valid.shape[0]
    if cap is None:
        cap = max(1, c // 2)
    idx = jnp.arange(c, dtype=jnp.int32)
    key = jnp.where(cl_valid, idx, c + idx)  # live first, draw order kept
    order = jnp.argsort(key)[:cap]
    aabb = cl_aabb[order]
    valid = cl_valid[order]  # dead clusters sort after live: tail is False
    zmin = None if cl_zmin is None else cl_zmin[order]
    dropped = jnp.maximum(jnp.sum(cl_valid.astype(jnp.int32)) - cap, 0)
    return aabb, valid, zmin, order, dropped


def bin_clusters(cl_aabb, cl_valid, params, max_clusters_per_tile: int,
                 cl_zmin=None):
    """Dense overlap + top_k -> per-tile cluster id lists.

    With cl_zmin given, each tile's list is ordered near-to-far (a tiny
    per-row sort) so the kernel's hierarchical-z skip converges after the
    first occluders — far cheaper than globally depth-sorting draws."""
    ntx, nty = params.tiles_x, params.tiles_y
    n_tiles = params.n_tiles
    c = cl_aabb.shape[0]
    tx0 = jnp.clip(jnp.floor(cl_aabb[:, 0] / params.tile_w), 0, ntx - 1).astype(jnp.int32)
    ty0 = jnp.clip(jnp.floor(cl_aabb[:, 1] / params.tile_h), 0, nty - 1).astype(jnp.int32)
    tx1 = jnp.clip(jnp.floor(cl_aabb[:, 2] / params.tile_w), 0, ntx - 1).astype(jnp.int32)
    ty1 = jnp.clip(jnp.floor(cl_aabb[:, 3] / params.tile_h), 0, nty - 1).astype(jnp.int32)
    tiles = jnp.arange(n_tiles, dtype=jnp.int32)
    t_y = tiles // ntx
    t_x = tiles % ntx
    ov = (
        cl_valid[None, :]
        & (t_x[:, None] >= tx0[None, :])
        & (t_x[:, None] <= tx1[None, :])
        & (t_y[:, None] >= ty0[None, :])
        & (t_y[:, None] <= ty1[None, :])
    )
    counts = jnp.sum(ov.astype(jnp.int32), axis=1)
    score = jnp.where(ov, c - jnp.arange(c, dtype=jnp.int32)[None, :], 0)
    k = min(max_clusters_per_tile, c)
    vals, idx = jax.lax.top_k(score, k)
    ids = jnp.where(vals > 0, idx, 0)
    if k < max_clusters_per_tile:
        pad = jnp.zeros((n_tiles, max_clusters_per_tile - k), jnp.int32)
        ids = jnp.concatenate([ids, pad], axis=1)
        vals = jnp.concatenate(
            [vals, jnp.zeros((n_tiles, max_clusters_per_tile - k), vals.dtype)], axis=1
        )
    counts = jnp.minimum(counts, max_clusters_per_tile)
    if cl_zmin is not None:
        slot = jnp.arange(max_clusters_per_tile, dtype=jnp.int32)[None, :]
        key = jnp.where(slot < counts[:, None], cl_zmin[ids], jnp.inf)
        order = jnp.argsort(key, axis=1)
        ids = jnp.take_along_axis(ids, order, axis=1)
    return ids.astype(jnp.int32), counts


def rasterize_clusters_batched(
    setup, cl_ids, cl_counts, params, max_clusters_per_tile: int,
    cl_zmin=None,
):
    """Env-batched cluster raster: setup [E,T,F], cl_ids [E,n_tiles,KC]
    (original cluster ids), cl_counts [E,n_tiles], cl_zmin [E,C] -> G-buffer
    dict with a leading env dim.

    cl_zmin: per-cluster min depth for the hierarchical-z exit; pass it
    only when each tile's list is ordered near-to-far (bin_clusters with
    cl_zmin). None walks every listed cluster."""
    e, t, _ = setup.shape
    n_tiles = params.n_tiles
    kc = max_clusters_per_tile
    c = t // CLUSTER
    counts = jnp.minimum(cl_counts, kc).astype(jnp.int32).reshape(e * n_tiles)
    ids = cl_ids.astype(jnp.int32).reshape(e * n_tiles, kc)

    def program(env, ty, tx, y0, x0, sub, cnt_ref, ids_ref, *rest):
        tile = env * n_tiles + ty * params.tiles_x + tx
        *zmin_ref, tri_ref = rest

        def rows(k):
            start = env * t + ids_ref[tile, k] * CLUSTER
            return start, start + CLUSTER

        zmin_at = None
        if zmin_ref:
            zmin_at = lambda k: zmin_ref[0][env * c + ids_ref[tile, k]]
        return raster.raster_program(
            tri_ref, cnt_ref[tile], rows, zmin_at, y0, x0, sub
        )

    zmin = ()
    if cl_zmin is not None:
        zmin = (cl_zmin.astype(jnp.float32).reshape(e * c),)
    return raster.raster_call(
        program, (counts, ids, *zmin, setup.reshape(e * t, -1)), e, params
    )


def rasterize_clusters(
    setup, cl_ids, cl_counts, params, max_clusters_per_tile: int, cl_zmin=None
):
    """setup [T, F] + per-tile cluster lists -> G-buffer dict (one scene)."""
    g = rasterize_clusters_batched(
        setup[None], cl_ids[None], cl_counts[None], params,
        max_clusters_per_tile,
        cl_zmin=None if cl_zmin is None else cl_zmin[None],
    )
    return jax.tree.map(lambda x: x[0], g)

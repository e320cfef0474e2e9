"""Broadphase: masked all-pairs AABB overlap with fixed-capacity compaction.

The reference uses Bullet's btDbvtBroadphase (dynamic BVH). Trees fit a
static-shape array program badly; for the target body counts per scene
(N <= a few hundred) the all-pairs overlap matrix IS the fast path: an [N,N]
boolean op is one fused elementwise pass, and turning it into a fixed-capacity pair
list is a single sort — no pointers, no host sync.

Layer/mask filtering matches Bullet's (aLayer & bMask) && (bLayer & aMask)
semantics (sc_physics.cpp:372-379 filter defaults).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from scx.physics.rigid import RigidBodies, body_aabbs

# N*N band in which pair compaction uses top_k instead of a rank scatter
# (tests patch these to force either path): top_k for mid-size scenes,
# the rank scatter at tiny N (64-body bench scenes, where it touches few
# elements) and at huge N^2. The band has not been re-measured on the GPU.
_TOPK_MIN = 1 << 13
_TOPK_LIMIT = 1 << 20


def broadphase_pairs(bodies: RigidBodies, max_pairs: int, margin: float = 0.02):
    """Returns (ia, ib, valid, n_candidates): up to `max_pairs` overlapping
    body pairs plus the TOTAL candidate count before the capacity cap —
    callers surface max(0, n_candidates - max_pairs) as pair overflow
    telemetry instead of silently losing contacts.

    Deterministic: pairs are ordered by flattened (i,j) index, i < j.
    Inactive bodies, static-static pairs and filtered layers are excluded.
    """
    n = bodies.n
    lo, hi = body_aabbs(bodies)
    lo = lo - margin
    hi = hi + margin

    # per-axis overlap on [N,N] matrices — an [N,N,3] temporary pads its
    # trailing dim to 128 lanes (42x) and dominates the step under an env
    # vmap; three column matrices stay dense
    def axis_overlap(k):
        l, h = lo[:, k], hi[:, k]
        return (l[:, None] <= h[None, :]) & (l[None, :] <= h[:, None])

    overlap = axis_overlap(0) & axis_overlap(1) & axis_overlap(2)

    dyn = bodies.inv_mass > 0
    either_dyn = dyn[:, None] | dyn[None, :]
    layer_ok = ((bodies.layer[:, None] & bodies.mask[None, :]) != 0) & (
        (bodies.layer[None, :] & bodies.mask[:, None]) != 0
    )
    act = bodies.active
    both_active = act[:, None] & act[None, :]

    # upper triangle as an iota mask on the flattened matrix (a triu-index
    # gather costs N^2/2 gathers)
    flat = jnp.arange(n * n, dtype=jnp.int32)
    flat_i = flat // n
    flat_j = flat - flat_i * n
    valid = (
        (overlap & either_dyn & layer_ok & both_active).reshape(n * n)
        & (flat_i < flat_j)
    )

    kflat, n_valid = compact_flat_indices(valid, max_pairs)
    ia = kflat // n
    ib = kflat - ia * n
    val = jnp.arange(max_pairs) < n_valid
    return ia, ib, val, n_valid


def compact_flat_indices(valid, max_pairs: int, force_blockrank: bool = False):
    """Fixed-capacity compaction of a flat boolean mask: returns
    (kflat [max_pairs] i32 — the flat indices of the first max_pairs True
    entries in ascending order, 0-filled past the count — and the total
    True count). Sort-free; shared by the pair-list and planar broadphases.

    force_blockrank: vmapped fleets MUST pass True — the small-m rank
    scatter below batches into one flat element scatter over the whole
    fleet. The heuristic m-gate is only valid for a SINGLE scene.
    """
    m = valid.shape[0]
    flat = jnp.arange(m, dtype=jnp.int32)
    n_valid = jnp.sum(valid.astype(jnp.int32))
    if force_blockrank or _TOPK_MIN <= m <= _TOPK_LIMIT:
        # sort-free compaction by BLOCK-RANK RECOVERY: the k-th valid flat
        # index is found by (a) lane-wise cumsum within 128-lane blocks,
        # (b) a tiny [cap, B] compare-sum locating k's block from the
        # exclusive block bases, (c) one packed row gather + argmax for the
        # lane. Replaces a top_k over the full [N^2] flat index; exact same
        # output order (ascending flat), no sort, no scatter.
        from scx.core import math3d as _m3

        w = 128
        pad = (-m) % w
        v = valid.astype(jnp.float32)
        if pad:
            v = jnp.concatenate([v, jnp.zeros((pad,), jnp.float32)])
        b = v.shape[0] // w
        v = v.reshape(b, w)
        # lane cumsum as ONE triangular matmul ([B, W] @ [W, W]; counts
        # <= W are exact in f32) instead of jnp.cumsum's reduce-window
        # chain. Not yet A/B'd on the GPU (ROADMAP speed item 4).
        lanes = jnp.arange(w, dtype=jnp.int32)
        tri = (lanes[:, None] <= lanes[None, :]).astype(jnp.float32)
        lane_cum = jnp.matmul(v, tri, precision=_m3.PRECISION)  # [B, W]
        blk = lane_cum[:, -1]                               # [B]
        base = jnp.cumsum(blk) - blk                        # exclusive [B]
        ks = jnp.arange(max_pairs, dtype=jnp.int32)
        b_k = (
            jnp.sum((base[None, :] <= ks[:, None]).astype(jnp.int32), axis=1)
            - 1
        )
        b_k = jnp.clip(b_k, 0, b - 1)
        # block-row fetch as a one-hot matmul, NOT packed[b_k]: row/element
        # gathers batch under vmap into [E*cap] row ops; the [cap, B] @
        # [B, 2W+1] one-hot (base rides along as an extra column) is ONE
        # batched GEMM — small ints, exact in f32
        packed = jnp.concatenate([lane_cum, v, base[:, None]], axis=1)
        oh = (
            jnp.arange(b, dtype=jnp.int32)[None, :] == b_k[:, None]
        ).astype(jnp.float32)                               # [cap, B]
        rows = jnp.matmul(oh, packed, precision=_m3.PRECISION).astype(
            jnp.int32
        )                                                   # [cap, 2W+1]
        lr = ks - rows[:, 2 * w]                            # rank in block
        hit = (rows[:, :w] == (lr + 1)[:, None]) & (rows[:, w:2 * w] > 0)
        lane = jnp.argmax(hit, axis=1).astype(jnp.int32)
        kflat = jnp.where(ks < n_valid, b_k * w + lane, 0)
    else:
        # huge single scenes: one rank scatter beats top_k over N^2 lanes.
        # the k-th valid pair writes its flat index into slot k (ranks are
        # unique, deterministic pair order preserved)
        rank = jnp.cumsum(valid.astype(jnp.int32))
        pos = jnp.where(valid, rank - 1, max_pairs)
        pos = jnp.minimum(pos, max_pairs)
        kflat = (
            jnp.zeros(max_pairs + 1, jnp.int32)
            .at[pos]
            .set(flat, mode="drop")[:max_pairs]
        )
    return kflat, n_valid

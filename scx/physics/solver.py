"""Batched impulse contact solver + full physics step.

Replaces Bullet's sequential-impulse solver (the reference steps
btDiscreteDynamicsWorld at fixed dt, sc_physics.cpp:283-302) with a
relaxed-Jacobi projected impulse solver: every iteration computes all contact
impulses in parallel from the current velocities and scatter-adds the result.
Sequential Gauss-Seidel is hostile to SIMD lanes; Jacobi with under-relaxation
converges to the same fixed point for these contact counts and keeps the whole
solve a handful of fused VPU passes per iteration.

Semantics matched to Bullet (not bitwise): Baumgarte stabilization (ERP-style
velocity bias), restitution with threshold, Coulomb friction clamped by the
accumulated normal impulse, multiplicative friction/restitution combiners,
damping as (1-d)^dt.

Everything is shape-static: fixed pair capacity, fixed contact capacity,
masked inactive lanes. vmap over the leading env axis gives batched scenes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from scx.core import struct

from scx.core import math3d as m3
from scx.physics.rigid import (
    RigidBodies,
    integrate_positions,
    integrate_velocities,
    inv_inertia_world,
)
from scx.physics.broadphase import broadphase_pairs
from scx.physics.contacts import generate_contacts, MAX_CONTACTS_PER_PAIR


@struct.dataclass
class SolverParams:
    gravity: float = struct.field(pytree_node=False, default=-9.81)
    dt: float = struct.field(pytree_node=False, default=1.0 / 60.0)
    iterations: int = struct.field(pytree_node=False, default=8)
    baumgarte: float = struct.field(pytree_node=False, default=0.2)
    slop: float = struct.field(pytree_node=False, default=0.005)
    restitution_threshold: float = struct.field(pytree_node=False, default=1.0)
    relaxation: float = struct.field(pytree_node=False, default=0.8)
    max_pairs: int = struct.field(pytree_node=False, default=128)
    warm_start: float = struct.field(pytree_node=False, default=0.85)
    # graph-colored Gauss-Seidel option: > 0 enables greedy pair coloring
    # with sequential color passes (Jacobi within a color) — Bullet's
    # sequential-impulse convergence for stiff stacks (sc_physics.cpp:
    # 283-302), batched. 0 keeps the pure relaxed-Jacobi path.
    colors: int = struct.field(pytree_node=False, default=0)
    # Bullet deactivation defaults (btRigidBody: 0.8 lin / 1.0 ang / 2 s)
    sleep_lin: float = struct.field(pytree_node=False, default=0.8)
    sleep_ang: float = struct.field(pytree_node=False, default=1.0)
    sleep_time: float = struct.field(pytree_node=False, default=2.0)
    # static hint: which collider shape types exist ANYWHERE in the
    # scene. ("box",) lets the planar narrowphase drop the capsule/sphere
    # candidate generators (same results on box-only scenes, ~half the
    # SAT kernel body — the headline fleet config). The default keeps
    # every generator; an incorrect narrower hint produces missing
    # contacts, so only set it from scene construction knowledge.
    shape_kinds: tuple = struct.field(
        pytree_node=False, default=("box", "sphere", "capsule")
    )


# contacts*bodies threshold below which the solve uses one-hot matmuls
# instead of row gathers/scatters (see solve_velocity; tests patch this to
# force either path)
_ONE_HOT_LIMIT = 1 << 20


def _greedy_pair_colors(pa, pb, valid, dyn, k_colors: int):
    """First-fit greedy coloring of the pair list: no two VALID pairs
    sharing a DYNAMIC body get the same color (static bodies never move,
    so pairs may share them freely). Deterministic sequential scan over
    the fixed-capacity list; if a pair needs more than k_colors it wraps
    into the last color (still convergent — the per-color relax rescales).

    Returns [P] i32 colors in [0, k_colors)."""
    k = k_colors
    cbits = jnp.arange(k, dtype=jnp.int32)

    def body(used, i):
        a, b = pa[i], pb[i]
        ua = jnp.where(dyn[a], used[a], 0)
        ub = jnp.where(dyn[b], used[b], 0)
        avail = ~(ua | ub)
        free = (avail >> cbits) & 1
        color = jnp.argmax(free).astype(jnp.int32)  # first free bit
        color = jnp.where(free[color] > 0, color, k - 1)
        mark = jnp.where(valid[i], jnp.int32(1) << color, 0)
        used = used.at[a].set(used[a] | jnp.where(dyn[a], mark, 0))
        used = used.at[b].set(used[b] | jnp.where(dyn[b], mark, 0))
        return used, color

    nb = dyn.shape[0]
    _, colors = jax.lax.scan(
        body, jnp.zeros((nb,), jnp.int32), jnp.arange(pa.shape[0])
    )
    return colors


def _orthonormal_tangents(n):
    """Two tangents per normal, branch-free (choose helper axis by |n.x|)."""
    helper = jnp.where(
        (jnp.abs(n[..., 0:1]) < 0.9),
        jnp.broadcast_to(jnp.asarray([1.0, 0.0, 0.0]), n.shape),
        jnp.broadcast_to(jnp.asarray([0.0, 1.0, 0.0]), n.shape),
    )
    t1 = m3.normalize(jnp.cross(n, helper))
    t2 = jnp.cross(n, t1)
    return t1, t2


def solve_velocity(bodies: RigidBodies, contacts, params: SolverParams, lam0=None):
    """Iterative velocity solve with optional warm start.

    lam0 [C,3]: accumulated (normal, tangent1, tangent2) impulses from the
    previous step's matching contacts. They are applied to the velocities up
    front (scaled by params.warm_start) and seed the accumulators, so the
    iterations only correct the residual — Bullet's accumulated-impulse warm
    start, batched.

    Returns (vel, omega, lam [C,3], contact_count_per_body [N]).
    """
    c_valid = contacts.valid
    ia, ib = contacts.ia, contacts.ib
    n = contacts.normal
    t1, t2 = _orthonormal_tangents(n)

    nb = bodies.n
    C = ia.shape[0]
    # generate_contacts emits contacts pair-blocked (ia = repeat(pair_ia, K),
    # contacts.py:281), so every per-contact body lookup can run at PAIR
    # granularity and broadcast to the K contacts: 4x fewer gather rows /
    # 4x smaller one-hot matrices, which is the solve's HBM bill.
    K = MAX_CONTACTS_PER_PAIR
    pair_blocked = C % K == 0 and C >= K
    if pair_blocked:
        P = C // K
        pia = ia.reshape(P, K)[:, 0]
        pib = ib.reshape(P, K)[:, 0]

    def from_pairs(x):
        """Broadcast a [P,...] pair row to its K contacts -> [C,...]."""
        return jnp.repeat(x, K, axis=0)

    iw = inv_inertia_world(bodies)
    # one packed row per body (inv_mass, pos, inv inertia world): each
    # endpoint costs ONE gathered row
    setup_rows = jnp.concatenate(
        [bodies.inv_mass[:, None], bodies.pos, iw.reshape(nb, 9)], axis=-1
    )
    if pair_blocked:
        rows_a = from_pairs(setup_rows[pia])
        rows_b = from_pairs(setup_rows[pib])
    else:
        rows_a = setup_rows[ia]
        rows_b = setup_rows[ib]
    im_a = rows_a[:, 0]
    im_b = rows_b[:, 0]
    iw_a = rows_a[:, 4:13].reshape(C, 3, 3)
    iw_b = rows_b[:, 4:13].reshape(C, 3, 3)
    r_a = contacts.point - rows_a[:, 1:4]
    r_b = contacts.point - rows_b[:, 1:4]

    def ang(iw_x, r, d):
        return jnp.einsum("...ij,...j->...i", iw_x, jnp.cross(r, d), precision=m3.PRECISION)

    def eff_mass(d, a_a, a_b):
        return (
            im_a
            + im_b
            + m3.dot(d, jnp.cross(a_a, r_a) + jnp.cross(a_b, r_b))
        )

    a_an, a_bn = ang(iw_a, r_a, n), ang(iw_b, r_b, n)
    a_a1, a_b1 = ang(iw_a, r_a, t1), ang(iw_b, r_b, t1)
    a_a2, a_b2 = ang(iw_a, r_a, t2), ang(iw_b, r_b, t2)
    kn = jnp.maximum(eff_mass(n, a_an, a_bn), 1e-9)
    k1 = jnp.maximum(eff_mass(t1, a_a1, a_b1), 1e-9)
    k2 = jnp.maximum(eff_mass(t2, a_a2, a_b2), 1e-9)

    # pack (vel, omega) into one [N,6] array: per iteration the pair
    # gathers/scatters are the memory cost (one transaction per index),
    # so one 6-wide row beats two 3-wide ones.
    #
    # For small scenes the gather/scatter becomes a ONE-HOT MATMUL
    # instead: A [C,N] has a 1 at (c, ia[c]) for valid contacts, so
    # A @ vw gathers and A.T @ upd scatter-adds. Under a vmapped env batch
    # XLA lowers batched row scatters poorly (same pathology as the render
    # binning, pipeline.py:489), while batched matmuls are native — the RL
    # fleet's solve stops being scatter-bound. Gated on
    # C*N so one huge scene (sandbox at 4096 capacity) keeps row ops.
    use_mm = C * nb <= _ONE_HOT_LIMIT
    if use_mm:
        ar_n = jnp.arange(nb, dtype=ia.dtype)
        if pair_blocked:
            pvalid = c_valid.reshape(P, K).any(axis=1)
            onehot_a = (
                (pia[:, None] == ar_n[None, :]) & pvalid[:, None]
            ).astype(jnp.float32)
            onehot_b = (
                (pib[:, None] == ar_n[None, :]) & pvalid[:, None]
            ).astype(jnp.float32)
        else:
            onehot_a = (
                (ia[:, None] == ar_n[None, :]) & c_valid[:, None]
            ).astype(jnp.float32)
            onehot_b = (
                (ib[:, None] == ar_n[None, :]) & c_valid[:, None]
            ).astype(jnp.float32)

    def _mm(x, y):
        return jnp.matmul(x, y, precision=m3.PRECISION)

    def rel_vel_packed(vw):
        if use_mm:
            a = _mm(onehot_a, vw)
            b = _mm(onehot_b, vw)
        elif pair_blocked:
            a = vw[pia]
            b = vw[pib]
        else:
            a = vw[ia]
            b = vw[ib]
        if pair_blocked:
            a = from_pairs(a)
            b = from_pairs(b)
        va = a[:, 0:3] + jnp.cross(a[:, 3:6], r_a)
        vb = b[:, 0:3] + jnp.cross(b[:, 3:6], r_b)
        return va - vb

    def apply_packed(vw, upd_a, upd_b):
        # invalid contacts carry zero updates (deltas are c_valid-masked),
        # so pair-summing before the scatter/matmul is exact
        if pair_blocked:
            upd_a = upd_a.reshape(P, K, 6).sum(axis=1)
            upd_b = upd_b.reshape(P, K, 6).sum(axis=1)
            if use_mm:
                return vw + _mm(onehot_a.T, upd_a) - _mm(onehot_b.T, upd_b)
            vw = vw.at[pia].add(upd_a, mode="drop")
            vw = vw.at[pib].add(-upd_b, mode="drop")
            return vw
        if use_mm:
            return vw + _mm(onehot_a.T, upd_a) - _mm(onehot_b.T, upd_b)
        vw = vw.at[ia].add(upd_a, mode="drop")
        vw = vw.at[ib].add(-upd_b, mode="drop")
        return vw

    # restitution uses pre-solve normal velocity
    v0 = rel_vel_packed(jnp.concatenate([bodies.vel, bodies.omega], axis=-1))
    vn0 = m3.dot(v0, n)
    bounce = -contacts.restitution * jnp.where(
        vn0 < -params.restitution_threshold, vn0, 0.0
    )
    bias = (params.baumgarte / params.dt) * jnp.maximum(
        contacts.depth - params.slop, 0.0
    )
    target = jnp.maximum(bounce, bias)  # desired separating normal velocity

    # Jacobi step scaling: a body touched by k contacts receives k impulses
    # per iteration computed from the same stale velocity, which overshoots
    # by ~k and can oscillate. Scale each contact's step by 1/max(k_a, k_b):
    # the projected fixed point is unchanged, convergence becomes monotone.
    if pair_blocked:
        w = c_valid.reshape(P, K).sum(axis=1).astype(jnp.float32)  # [P]
        if use_mm:
            cnt = jnp.matmul(w, onehot_a, precision=m3.PRECISION) + jnp.matmul(
                w, onehot_b, precision=m3.PRECISION
            )
        else:
            cnt = jnp.zeros((nb,), jnp.float32)
            cnt = cnt.at[pia].add(w, mode="drop")
            cnt = cnt.at[pib].add(w, mode="drop")
        cnt_a = from_pairs(cnt[pia])
        cnt_b = from_pairs(cnt[pib])
    elif use_mm:
        cnt = onehot_a.sum(axis=0) + onehot_b.sum(axis=0)
        cnt_a, cnt_b = cnt[ia], cnt[ib]
    else:
        cnt = jnp.zeros((nb,), jnp.float32)
        cnt = cnt.at[ia].add(c_valid.astype(jnp.float32), mode="drop")
        cnt = cnt.at[ib].add(c_valid.astype(jnp.float32), mode="drop")
        cnt_a, cnt_b = cnt[ia], cnt[ib]
    touch_a = jnp.where(im_a > 0, cnt_a, 1.0)
    touch_b = jnp.where(im_b > 0, cnt_b, 1.0)
    relax = params.relaxation / jnp.maximum(jnp.maximum(touch_a, touch_b), 1.0)

    def masked_pass(vw, ln, l1, l2, active, relax_arr):
        """One projected-impulse sweep over the contacts in `active`
        (Jacobi within the set), returning updated accumulators + vw."""
        v = rel_vel_packed(vw)  # friction uses pre-normal-update vel
        vn = m3.dot(v, n)

        d_ln = (target - vn) / kn * relax_arr
        ln_new = jnp.maximum(ln + d_ln, 0.0)
        d_ln = jnp.where(active, ln_new - ln, 0.0)
        ln_new = ln + d_ln

        max_f = contacts.friction * ln_new
        vt1 = m3.dot(v, t1)
        vt2 = m3.dot(v, t2)
        d_l1 = -vt1 / k1 * relax_arr
        d_l2 = -vt2 / k2 * relax_arr
        l1_new = jnp.clip(l1 + d_l1, -max_f, max_f)
        l2_new = jnp.clip(l2 + d_l2, -max_f, max_f)
        d_l1 = jnp.where(active, l1_new - l1, 0.0)
        d_l2 = jnp.where(active, l2_new - l2, 0.0)
        l1_new = l1 + d_l1
        l2_new = l2 + d_l2

        imp = d_ln[:, None] * n + d_l1[:, None] * t1 + d_l2[:, None] * t2
        dw_a = a_an * d_ln[:, None] + a_a1 * d_l1[:, None] + a_a2 * d_l2[:, None]
        dw_b = a_bn * d_ln[:, None] + a_b1 * d_l1[:, None] + a_b2 * d_l2[:, None]

        upd_a = jnp.concatenate([imp * im_a[:, None], dw_a], axis=-1)
        upd_b = jnp.concatenate([imp * im_b[:, None], dw_b], axis=-1)
        vw = apply_packed(vw, upd_a, upd_b)
        return vw, ln_new, l1_new, l2_new

    n_colors = params.colors
    if n_colors > 0 and pair_blocked:
        # graph-colored Gauss-Seidel: pairs of a color are body-disjoint,
        # so each color pass sees the velocities the previous pass wrote —
        # sequential-impulse convergence with batched inner math.
        pvalid = c_valid.reshape(P, K).any(axis=1)
        dyn = bodies.inv_mass > 0
        pcolors = _greedy_pair_colors(pia, pib, pvalid, dyn, n_colors)
        ccolors = from_pairs(pcolors)
        color_masks = [c_valid & (ccolors == c) for c in range(n_colors)]
        # per-color relax: within a color each dynamic body is touched by
        # ONE pair (up to K manifold contacts applied Jacobi-style), except
        # in the overflow color — recount per color
        color_relax = []
        for c in range(n_colors):
            w_c = color_masks[c].reshape(P, K).sum(axis=1).astype(jnp.float32)
            cnt_c = jnp.zeros((nb,), jnp.float32)
            cnt_c = cnt_c.at[pia].add(w_c, mode="drop")
            cnt_c = cnt_c.at[pib].add(w_c, mode="drop")
            ta = jnp.where(im_a > 0, from_pairs(cnt_c[pia]), 1.0)
            tb = jnp.where(im_b > 0, from_pairs(cnt_c[pib]), 1.0)
            color_relax.append(
                params.relaxation / jnp.maximum(jnp.maximum(ta, tb), 1.0)
            )

        def iteration(carry, _):
            vw, ln, l1, l2 = carry
            for c in range(n_colors):
                vw, ln, l1, l2 = masked_pass(
                    vw, ln, l1, l2, color_masks[c], color_relax[c]
                )
            return (vw, ln, l1, l2), None
    else:
        def iteration(carry, _):
            vw, ln, l1, l2 = carry
            vw, ln, l1, l2 = masked_pass(vw, ln, l1, l2, c_valid, relax)
            return (vw, ln, l1, l2), None

    zeros_c = jnp.zeros_like(kn)
    vw0 = jnp.concatenate([bodies.vel, bodies.omega], axis=-1)
    if lam0 is None:
        ln0 = l10 = l20 = zeros_c
    else:
        w = params.warm_start
        ln0 = jnp.where(c_valid, jnp.maximum(lam0[:, 0] * w, 0.0), 0.0)
        max_f0 = contacts.friction * ln0
        l10 = jnp.clip(jnp.where(c_valid, lam0[:, 1] * w, 0.0), -max_f0, max_f0)
        l20 = jnp.clip(jnp.where(c_valid, lam0[:, 2] * w, 0.0), -max_f0, max_f0)
        imp = ln0[:, None] * n + l10[:, None] * t1 + l20[:, None] * t2
        dw_a = a_an * ln0[:, None] + a_a1 * l10[:, None] + a_a2 * l20[:, None]
        dw_b = a_bn * ln0[:, None] + a_b1 * l10[:, None] + a_b2 * l20[:, None]
        upd_a = jnp.concatenate([imp * im_a[:, None], dw_a], axis=-1)
        upd_b = jnp.concatenate([imp * im_b[:, None], dw_b], axis=-1)
        vw0 = apply_packed(vw0, upd_a, upd_b)
    (vw, ln, l1, l2), _ = jax.lax.scan(
        iteration,
        (vw0, ln0, l10, l20),
        None,
        length=params.iterations,
    )
    del nb
    lam = jnp.stack([ln, l1, l2], axis=-1)
    return vw[:, 0:3], vw[:, 3:6], lam, cnt


def step_bodies_cached(bodies: RigidBodies, params: SolverParams, cache,
                       key_id=None):
    """One fixed physics step with warm starting and sleeping:
    integrate forces -> contacts -> warm-started solve -> sleep -> move.

    cache: ContactCache from the previous step (scx.physics.warmstart).
    key_id: optional [N] i32 persistent per-body identity — cache keys use
    it instead of row indices, so warm impulses survive row reshuffling
    (spatial-shard migration + ghost churn, scx/parallel/bigscene.py).
    Returns (bodies, cache, stats) where stats surfaces capacity overflow
    (pair_overflow > 0 means the scene is dropping contacts — raise
    max_pairs) and contact counts. Pure and shape-static; vmap over scenes,
    lax.scan over substeps with (bodies, cache) as carry.
    """
    from scx.physics.warmstart import gather_warm_impulses, store_impulses

    bodies = integrate_velocities(bodies, params.dt, params.gravity)
    ia, ib, pair_valid, n_cand = broadphase_pairs(bodies, params.max_pairs)
    contacts = generate_contacts(bodies, ia, ib, pair_valid)
    lam0 = gather_warm_impulses(
        cache, ia, ib, pair_valid, contacts.cand, bodies.n, key_id
    )
    vel, omega, lam, cnt = solve_velocity(bodies, contacts, params, lam0)

    # sleeping (Bullet deactivation semantics): a supported body whose
    # velocities stay under the thresholds for sleep_time gets its residual
    # jitter snapped to zero; losing support (cnt == 0) lets gravity build
    # real velocity again, which resets the timer past the threshold.
    dyn = (bodies.inv_mass > 0) & bodies.active
    low = (jnp.sum(vel * vel, -1) < params.sleep_lin**2) & (
        jnp.sum(omega * omega, -1) < params.sleep_ang**2
    )
    timer = jnp.where(dyn & low, bodies.sleep_timer + params.dt, 0.0)
    asleep = (timer > params.sleep_time) & (cnt > 0)
    vel = jnp.where(asleep[:, None], 0.0, vel)
    omega = jnp.where(asleep[:, None], 0.0, omega)
    bodies = bodies.replace(vel=vel, omega=omega, sleep_timer=timer)

    cache = store_impulses(
        cache, ia, ib, pair_valid, contacts.cand, lam, contacts.valid,
        bodies.n, key_id,
    )
    stats = {
        "pairs": jnp.sum(pair_valid.astype(jnp.int32)),
        "pair_overflow": jnp.maximum(n_cand - params.max_pairs, 0),
        "contacts": jnp.sum(contacts.valid.astype(jnp.int32)),
        "trigger_overlaps": jnp.sum(contacts.trigger_overlap.astype(jnp.int32)),
    }
    return integrate_positions(bodies, params.dt), cache, stats


def step_bodies(bodies: RigidBodies, params: SolverParams) -> RigidBodies:
    """One fixed physics step with a cold cache (convenience/tests).

    Loops should use step_bodies_cached — warm starting carries accumulated
    impulses across steps (stability + fewer iterations).
    """
    from scx.physics.warmstart import empty_contact_cache

    bodies, _, _ = step_bodies_cached(
        bodies, params, empty_contact_cache(params.max_pairs)
    )
    return bodies

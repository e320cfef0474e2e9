"""Plane-layout rigid-body physics — the fleet hot path.

Same semantics as the conventional path (rigid.py / broadphase.py /
contacts.py / boxbox.py / solver.py — Bullet-matched box/sphere/capsule
SAT manifolds, warm-started relaxed-Jacobi impulse solve, sleeping;
reference: sc_physics.cpp:210-302), re-laid-out so that NOTHING
materialized carries a tiny trailing dim:

  * vectors/quats are component planes (scx.physics.planes.V3/Q4) — [N]
    per scene, [E, N] under vmap;
  * per-pair data is [P] planes, per-contact data [K, P] planes;
  * every gather/scatter is an orientation-aware one-hot matmul
    ([rows, N] @ [N, P] — the small packed dim leads, the large dim
    is the minor one).

Why: the conventional layout materializes [E, P, 10, 3] SAT candidates
and [E, C, 3] solver constants whose 3-wide minor dim wastes most of
every memory transaction, and the solver re-reads them every iteration.
Plane layout keeps each quantity a dense [E, X] plane; the same formulas
in the same order otherwise.

vmap over the leading axis for env fleets; lax.scan over steps with
(PlanarBodies, PlanarCache) as carry.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from scx.core import struct

from scx.core import math3d as m3
from scx.physics import planes as pl
from scx.physics.planes import V3, Q4
from scx.physics.broadphase import compact_flat_indices
from scx.physics.contacts import MAX_CONTACTS_PER_PAIR
from scx.physics.rigid import (
    BODY_DYNAMIC,
    BODY_STATIC,
    SHAPE_BOX,
    SHAPE_CAPSULE,
    SHAPE_SPHERE,
    RigidBodies,
)
from scx.physics.solver import SolverParams

_FACE_BIAS_REL = 0.95  # == boxbox._FACE_BIAS_REL
_EPS = 1e-7
_K = MAX_CONTACTS_PER_PAIR  # 4
_N_CAND = 10


@struct.dataclass
class PlanarBodies:
    """One scene of rigid bodies in plane layout, fixed capacity N."""

    pos: V3        # of [N]
    quat: Q4       # of [N]
    vel: V3
    omega: V3
    size: V3
    inv_inertia: V3
    shape_offset: V3
    shape: jax.Array       # [N] i32
    inv_mass: jax.Array    # [N] f32
    friction: jax.Array
    restitution: jax.Array
    lin_damping: jax.Array
    ang_damping: jax.Array
    sleep_timer: jax.Array
    layer: jax.Array       # [N] u32
    mask: jax.Array        # [N] u32
    active: jax.Array      # [N] bool
    trigger: jax.Array     # [N] bool

    @property
    def n(self) -> int:
        return self.shape.shape[-1]


def _v3_of(a) -> V3:
    return V3(a[..., 0], a[..., 1], a[..., 2])


def _q4_of(a) -> Q4:
    return Q4(a[..., 0], a[..., 1], a[..., 2], a[..., 3])


def planar_from_rigid(b: RigidBodies) -> PlanarBodies:
    """Layout conversion (one scene; vmap for batches)."""
    return PlanarBodies(
        pos=_v3_of(b.pos),
        quat=_q4_of(b.quat),
        vel=_v3_of(b.vel),
        omega=_v3_of(b.omega),
        size=_v3_of(b.size),
        inv_inertia=_v3_of(b.inv_inertia),
        shape_offset=_v3_of(b.shape_offset),
        shape=b.shape,
        inv_mass=b.inv_mass,
        friction=b.friction,
        restitution=b.restitution,
        lin_damping=b.lin_damping,
        ang_damping=b.ang_damping,
        sleep_timer=b.sleep_timer,
        layer=b.layer,
        mask=b.mask,
        active=b.active,
        trigger=b.trigger,
    )


def rigid_from_planar(p: PlanarBodies) -> RigidBodies:
    st3 = lambda v: jnp.stack([v.x, v.y, v.z], axis=-1)
    return RigidBodies(
        pos=st3(p.pos),
        quat=jnp.stack([p.quat.w, p.quat.x, p.quat.y, p.quat.z], axis=-1),
        vel=st3(p.vel),
        omega=st3(p.omega),
        shape=p.shape,
        size=st3(p.size),
        inv_mass=p.inv_mass,
        inv_inertia=st3(p.inv_inertia),
        friction=p.friction,
        restitution=p.restitution,
        lin_damping=p.lin_damping,
        ang_damping=p.ang_damping,
        layer=p.layer,
        mask=p.mask,
        active=p.active,
        shape_offset=st3(p.shape_offset),
        sleep_timer=p.sleep_timer,
        trigger=p.trigger,
    )


# ---------------------------------------------------------------------------
# integration (rigid.py:201-236 in plane form)
# ---------------------------------------------------------------------------

def _inv_inertia_world(b: PlanarBodies):
    """World inverse inertia R diag(ii) R^T as a nested 3x3 tuple of planes."""
    r = pl.q_to_mat(b.quat)
    ii = b.inv_inertia
    iiv = (ii.x, ii.y, ii.z)
    return tuple(
        tuple(
            sum(r[i][k] * iiv[k] * r[j][k] for k in range(3)) for j in range(3)
        )
        for i in range(3)
    )


def planar_integrate_velocities(b: PlanarBodies, dt, gravity) -> PlanarBodies:
    dyn = (b.inv_mass > 0) & b.active
    # f32 product on device (NOT a python f64 product) — bitwise parity
    # with rigid.integrate_velocities' g * dt
    g_dt = jnp.float32(gravity) * jnp.float32(dt)
    vel = V3(
        b.vel.x,
        b.vel.y + jnp.where(dyn, g_dt, 0.0),
        b.vel.z,
    )
    lin_d = jnp.power(jnp.clip(1.0 - b.lin_damping, 0.0, 1.0), dt)
    ang_d = jnp.power(jnp.clip(1.0 - b.ang_damping, 0.0, 1.0), dt)
    return b.replace(vel=vel * lin_d, omega=b.omega * ang_d)


def planar_integrate_positions(b: PlanarBodies, dt) -> PlanarBodies:
    moving = b.active & (
        (b.inv_mass > 0)
        | (pl.vdot(b.vel, b.vel) + pl.vdot(b.omega, b.omega) > 0)
    )
    pos = pl.vwhere(moving, b.pos + b.vel * dt, b.pos)
    qn = pl.qintegrate(b.quat, b.omega, dt)
    quat = Q4(
        jnp.where(moving, qn.w, b.quat.w),
        jnp.where(moving, qn.x, b.quat.x),
        jnp.where(moving, qn.y, b.quat.y),
        jnp.where(moving, qn.z, b.quat.z),
    )
    return b.replace(pos=pos, quat=quat)


# ---------------------------------------------------------------------------
# broadphase (broadphase.py in plane form; same pair order/filters)
# ---------------------------------------------------------------------------

def _shape_centers(b: PlanarBodies) -> V3:
    return b.pos + pl.qrot(b.quat, b.shape_offset)


def planar_broadphase(b: PlanarBodies, max_pairs: int, margin: float = 0.02):
    """Returns (ia, ib, valid, n_candidates) — identical to
    broadphase_pairs (broadphase.py:29) on the converted scene."""
    n = b.n
    r = pl.q_to_mat(b.quat)
    absr = pl.mabs(r)
    box_ext = pl.mvec(absr, b.size)
    rad = b.size.x
    sph_ext = V3(rad, rad, rad)
    cap_ext = pl.vabs(pl.mcol(r, 1)) * b.size.y + V3(rad, rad, rad)
    is_box = b.shape == SHAPE_BOX
    is_sph = b.shape == SHAPE_SPHERE
    ext = pl.vwhere(is_box, box_ext, pl.vwhere(is_sph, sph_ext, cap_ext))
    center = _shape_centers(b)
    lo = center - ext - margin
    hi = center + ext + margin

    def axis_overlap(l, h):
        return (l[:, None] <= h[None, :]) & (l[None, :] <= h[:, None])

    overlap = (
        axis_overlap(lo.x, hi.x)
        & axis_overlap(lo.y, hi.y)
        & axis_overlap(lo.z, hi.z)
    )
    dyn = b.inv_mass > 0
    either_dyn = dyn[:, None] | dyn[None, :]
    layer_ok = ((b.layer[:, None] & b.mask[None, :]) != 0) & (
        (b.layer[None, :] & b.mask[:, None]) != 0
    )
    both_active = b.active[:, None] & b.active[None, :]
    flat = jnp.arange(n * n, dtype=jnp.int32)
    flat_i = flat // n
    flat_j = flat - flat_i * n
    valid = (
        (overlap & either_dyn & layer_ok & both_active).reshape(n * n)
        & (flat_i < flat_j)
    )
    # force the block-rank compaction: planar scenes are vmapped fleets,
    # where the small-m rank scatter batches into one flat scatter
    kflat, n_valid = compact_flat_indices(valid, max_pairs, force_blockrank=True)
    ia = kflat // n
    ib = kflat - ia * n
    val = jnp.arange(max_pairs) < n_valid
    return ia, ib, val, n_valid


# ---------------------------------------------------------------------------
# one-hot gather/scatter plumbing
# ---------------------------------------------------------------------------

def _onehot(idx, n, valid=None):
    """[n, P] f32 with a 1 at (idx[p], p) — gathers as rows @ onehot."""
    oh = jnp.arange(n, dtype=idx.dtype)[:, None] == idx[None, :]
    if valid is not None:
        oh = oh & valid[None, :]
    return oh.astype(jnp.float32)


def _mm(a, b):
    # exact one-hot gathers need true f32 passes (CLAUDE.md quirk 2)
    return jnp.matmul(a, b, precision=m3.PRECISION)


def _bar(tree):
    """Materialization barrier. XLA fusions have no temporaries — a node
    feeding k consumers inside one fusion is RECOMPUTED k times — and the
    narrowphase's deeply-shared SAT chain otherwise fuses into one kernel
    that recomputes the shared intermediates for every consumer. Forcing
    them to materialize cuts the duplication; each plane is ~1 MB at
    1024x64, so the extra memory round-trips are cheap by comparison."""
    return jax.lax.optimization_barrier(tree)


# ---------------------------------------------------------------------------
# box-box SAT manifold (boxbox.py in plane form — same formulas/ordering)
# ---------------------------------------------------------------------------

def _argmin3(v: V3):
    """First-occurrence argmin over the 3 components (== jnp.argmin)."""
    i01 = jnp.where(v.x <= v.y, 0, 1)
    v01 = jnp.minimum(v.x, v.y)
    idx = jnp.where(v01 <= v.z, i01, 2)
    return idx.astype(jnp.int32), jnp.minimum(v01, v.z)


def _argmax3_abs(v: V3):
    a = pl.vabs(v)
    i01 = jnp.where(a.x >= a.y, 0, 1)
    v01 = jnp.maximum(a.x, a.y)
    idx = jnp.where(v01 >= a.z, i01, 2)
    return idx.astype(jnp.int32)


def _sign_nz(x, fallback=None):
    """sign(where(x == 0, fallback or 1, x)) — the boxbox convention."""
    fb = 1.0 if fallback is None else fallback
    return jnp.sign(jnp.where(x == 0.0, fb, x))


def _cross_unit(i: int, v: V3) -> V3:
    """e_i x v for a STATIC axis index."""
    if i == 0:
        return V3(jnp.zeros_like(v.x), -v.z, v.y)
    if i == 1:
        return V3(v.z, jnp.zeros_like(v.x), -v.x)
    return V3(-v.y, v.x, jnp.zeros_like(v.x))


def _face_candidates(h_ref: V3, h_inc: V3, r_inc, t_inc: V3, axis_i, sign_s):
    """boxbox._face_candidates in plane form: 4 (point V3, depth) in the
    ref frame. axis_i / sign_s are traced planes."""
    e_i = pl.vonehot(axis_i, sign_s)
    n_out = e_i * sign_s

    n_in_inc = pl.mtvec(r_inc, n_out)
    j = _argmax3_abs(n_in_inc)
    e_j = pl.vonehot(j, sign_s)
    nj = pl.vcomp(n_in_inc, j)
    sign_j = -_sign_nz(nj)

    e_k = pl.vonehot((j + 1) % 3, sign_s)
    e_l = pl.vonehot((j + 2) % 3, sign_s)
    hk = pl.vdot(h_inc, e_k)
    hl = pl.vdot(h_inc, e_l)
    center = e_j * (sign_j * pl.vdot(h_inc, e_j))
    signs = ((1.0, 1.0), (1.0, -1.0), (-1.0, 1.0), (-1.0, -1.0))
    verts = [
        pl.mvec(r_inc, center + e_k * (s0 * hk) + e_l * (s1 * hl)) + t_inc
        for (s0, s1) in signs
    ]

    one = V3(
        jnp.ones_like(sign_s), jnp.ones_like(sign_s), jnp.ones_like(sign_s)
    )
    not_i = one - e_i
    lims = h_ref * not_i + e_i * 1e9
    clamped = [pl.vclip(v, -lims, lims) for v in verts]

    n_inc_ref = pl.mvec(r_inc, e_j) * sign_j
    d_plane = pl.vdot(n_inc_ref, verts[0])
    ni = pl.vdot(n_inc_ref, e_i)
    safe_ni = jnp.where(
        jnp.abs(ni) < 0.05, _sign_nz(ni, fallback=-sign_s) * 0.05, ni
    )
    h_i = pl.vdot(h_ref, e_i)
    # shared by all 4 verts — materialize or the fusion recomputes 4x
    (clamped, not_i, e_i, n_inc_ref, d_plane, safe_ni, h_i, sign_s) = _bar(
        (clamped, not_i, e_i, n_inc_ref, d_plane, safe_ni, h_i, sign_s)
    )

    pts, deps = [], []
    for c in clamped:
        rest = pl.vdot(c * not_i, n_inc_ref)
        xi = (d_plane - rest) / safe_ni
        pts.append(c * not_i + e_i * xi)
        deps.append(h_i - sign_s * xi)
    return pts, deps


def _edge_candidate(h_a: V3, h_b: V3, r, t: V3, ei, ej, normal_a: V3):
    """boxbox._edge_candidate in plane form: 2 points (A frame) + depth
    penalties. ei/ej are traced axis planes."""
    e_i = pl.vonehot(ei, t.x)
    e_j_b = pl.vonehot(ej, t.x)
    d_a = e_i
    d_b = pl.mvec(r, e_j_b)

    sgn_a = V3(_sign_nz(normal_a.x), _sign_nz(normal_a.y), _sign_nz(normal_a.z))
    one = V3(jnp.ones_like(t.x), jnp.ones_like(t.x), jnp.ones_like(t.x))
    c_a = sgn_a * h_a * (one - e_i)
    n_b = pl.mtvec(r, -normal_a)
    sgn_b = V3(_sign_nz(n_b.x), _sign_nz(n_b.y), _sign_nz(n_b.z))
    c_b = pl.mvec(r, sgn_b * h_b * (one - e_j_b)) + t

    he_a = pl.vdot(h_a, e_i)
    he_b = pl.vdot(h_b, e_j_b)
    r0 = c_b - c_a
    bb = pl.vdot(d_a, d_b)
    denom = jnp.maximum(1.0 - bb * bb, 1e-9)
    da_r0 = pl.vdot(d_a, r0)
    db_r0 = pl.vdot(d_b, r0)
    s = jnp.clip((da_r0 - bb * db_r0) / denom, -he_a, he_a)
    u = jnp.clip((da_r0 * bb - db_r0) / denom, -he_b, he_b)
    p_a = c_a + d_a * s
    p_b = c_b + d_b * u
    p0 = (p_a + p_b) * 0.5

    s_proj_lo = da_r0 - he_b * bb
    s_proj_hi = da_r0 + he_b * bb
    s_lo = jnp.clip(jnp.minimum(s_proj_lo, s_proj_hi), -he_a, he_a)
    s_hi = jnp.clip(jnp.maximum(s_proj_lo, s_proj_hi), -he_a, he_a)
    s2 = jnp.where(jnp.abs(s_hi - s) > jnp.abs(s_lo - s), s_hi, s_lo)
    u2 = jnp.clip(pl.vdot(d_b, (c_a + d_a * s2) - c_b), -he_b, he_b)
    p_a2 = c_a + d_a * s2
    p_b2 = c_b + d_b * u2
    p1 = (p_a2 + p_b2) * 0.5
    d0 = pl.vnorm(p_a - p_b)
    d1 = pl.vnorm(p_a2 - p_b2)
    z = jnp.zeros_like(d0)
    return [p0, p1], [z, d1 - d0]


def _box_box(pos_a, quat_a, h_a, pos_b, quat_b, h_b):
    """boxbox.box_box_contacts in plane form: 10 candidates, each
    (point V3 world, normal V3 world B->A, depth, valid)."""
    ra = pl.q_to_mat(quat_a)
    rb = pl.q_to_mat(quat_b)
    r = pl.mtm(ra, rb)
    t = pl.mtvec(ra, pos_b - pos_a)
    ra, rb, r, t = _bar((ra, rb, r, t))

    absr = pl.mabs(r, _EPS)
    ov_face_a = h_a + pl.mvec(absr, h_b) - pl.vabs(t)
    t_b = pl.mtvec(r, t)
    ov_face_b = h_b + pl.mtvec(absr, h_a) - pl.vabs(t_b)

    # 9 edge cross axes (static double loop)
    axes_n = [[None] * 3 for _ in range(3)]
    ov_edge = [[None] * 3 for _ in range(3)]
    for i in range(3):
        for j in range(3):
            ax = _cross_unit(i, pl.mcol(r, j))
            ln = jnp.sqrt(jnp.maximum(pl.vdot(ax, ax), _EPS * _EPS))
            an = ax * (1.0 / ln)
            proj_a = pl.vdot(pl.vabs(an), h_a)
            an_b = pl.mtvec(r, an)
            proj_b = pl.vdot(pl.vabs(an_b), h_b)
            dist_e = jnp.abs(pl.vdot(an, t))
            ov = proj_a + proj_b - dist_e
            ov_edge[i][j] = jnp.where(ln < 1e-4, jnp.inf, ov)
            axes_n[i][j] = an

    axes_n, ov_edge, ov_face_a, ov_face_b = _bar(
        (axes_n, ov_edge, ov_face_a, ov_face_b)
    )
    min_edge_all = ov_edge[0][0]
    for i in range(3):
        for j in range(3):
            min_edge_all = jnp.minimum(min_edge_all, ov_edge[i][j])
    separated = (
        (pl.vhmin(ov_face_a) < 0.0)
        | (pl.vhmin(ov_face_b) < 0.0)
        | (min_edge_all < 0.0)
    )

    best_fa, min_fa = _argmin3(ov_face_a)
    best_fb, min_fb = _argmin3(ov_face_b)
    # first-occurrence argmin over the 9 flat edge overlaps
    bi = jnp.zeros_like(best_fa)
    bj = jnp.zeros_like(best_fa)
    min_e = ov_edge[0][0]
    for i in range(3):
        for j in range(3):
            if i == 0 and j == 0:
                continue
            better = ov_edge[i][j] < min_e
            bi = jnp.where(better, i, bi)
            bj = jnp.where(better, j, bj)
            min_e = jnp.minimum(min_e, ov_edge[i][j])

    min_face = jnp.minimum(min_fa, min_fb)
    use_edge = min_e < min_face * _FACE_BIAS_REL - 1e-4
    use_face_b = (~use_edge) & (min_fb < min_fa * _FACE_BIAS_REL - 1e-4)
    use_face_a = (~use_edge) & (~use_face_b)

    # ref face on A
    sign_a = _sign_nz(pl.vcomp(t, best_fa))
    pts_fa, dep_fa = _face_candidates(h_a, h_b, r, t, best_fa, sign_a)
    pts_fa_w = [pos_a + pl.mvec(ra, p) for p in pts_fa]
    n_fa_w = -(pl.mcol_dyn(ra, best_fa) * sign_a)
    pts_fa_w, dep_fa, n_fa_w = _bar((pts_fa_w, dep_fa, n_fa_w))

    # ref face on B (roles swapped)
    r_t = pl.mT(r)
    t2 = -pl.mvec(r_t, t)
    sign_b = _sign_nz(pl.vcomp(t2, best_fb))
    pts_fb, dep_fb = _face_candidates(h_b, h_a, r_t, t2, best_fb, sign_b)
    pts_fb_w = [pos_b + pl.mvec(rb, p) for p in pts_fb]
    n_fb_w = pl.mcol_dyn(rb, best_fb) * sign_b
    pts_fb_w, dep_fb, n_fb_w = _bar((pts_fb_w, dep_fb, n_fb_w))

    # edge-edge: select axes_n[bi][bj] (9-way static select)
    axis_e = axes_n[0][0]
    for i in range(3):
        for j in range(3):
            if i == 0 and j == 0:
                continue
            sel = (bi == i) & (bj == j)
            axis_e = pl.vwhere(sel, axes_n[i][j], axis_e)
    axis_e = axis_e * _sign_nz(pl.vdot(axis_e, t))
    pt_e, pen_e = _edge_candidate(h_a, h_b, r, t, bi, bj, axis_e)
    pt_e_w = [pos_a + pl.mvec(ra, p) for p in pt_e]
    n_e_w = -pl.mvec(ra, axis_e)
    dep_e = [min_e - pen_e[0], min_e - pen_e[1]]
    pt_e_w, n_e_w, dep_e = _bar((pt_e_w, n_e_w, dep_e))

    cands = []
    for v in range(4):
        cands.append((pts_fa_w[v], n_fa_w, dep_fa[v], use_face_a))
    for v in range(4):
        cands.append((pts_fb_w[v], n_fb_w, dep_fb[v], use_face_b))
    for v in range(2):
        cands.append((pt_e_w[v], n_e_w, dep_e[v], use_edge))
    return [
        (p, nm, d, case & (d > 0.0) & ~separated) for (p, nm, d, case) in cands
    ]


# ---------------------------------------------------------------------------
# capsule/sphere narrowphase (contacts.py in plane form)
# ---------------------------------------------------------------------------

def _box_sdf_local(p: V3, h: V3):
    q = pl.vabs(p) - h
    z = jnp.zeros_like(q.x)
    outside = pl.vmax(q, V3(z, z, z))
    dist_out = pl.vnorm(outside)
    max_q = pl.vhmax(q)
    dist = jnp.where(max_q > 0.0, dist_out, max_q)
    n_out = pl.vsafe_normalize(outside)
    # inside normal: one-hot of argmax(q) — first occurrence like jnp.argmax
    i01 = jnp.where(q.x >= q.y, 0, 1)
    v01 = jnp.maximum(q.x, q.y)
    axis = jnp.where(v01 >= q.z, i01, 2)
    n_in = pl.vonehot(axis, p.x)
    sgn = V3(_sign_nz(p.x), _sign_nz(p.y), _sign_nz(p.z))
    n_local = pl.vwhere(max_q > 0.0, n_out, n_in) * sgn
    return dist, n_local


def _sphere_box(center: V3, radius, pos_b: V3, quat_b: Q4, h_b: V3):
    local = pl.qrot_inv(quat_b, center - pos_b)
    dist, n_local = _box_sdf_local(local, h_b)
    n_world = pl.qrot(quat_b, n_local)
    depth = radius - dist
    point = center - n_world * jnp.minimum(dist, radius)
    return point, n_world, depth, depth > 0.0


def _segment_of_capsule(pos: V3, quat: Q4, size: V3):
    axis = pl.qrot(quat, pl.V3(
        jnp.zeros_like(pos.x), jnp.ones_like(pos.x), jnp.zeros_like(pos.x)
    ))
    hh = size.y
    return pos - axis * hh, pos + axis * hh


def _closest_pt_segment(a0: V3, a1: V3, p: V3):
    d = a1 - a0
    t = jnp.clip(
        pl.vdot(p - a0, d) / jnp.maximum(pl.vdot(d, d), 1e-9), 0.0, 1.0
    )
    return a0 + d * t


def _capsule_capsule(pos_a, quat_a, size_a, pos_b, quat_b, size_b):
    a0, a1 = _segment_of_capsule(pos_a, quat_a, size_a)
    b0, b1 = _segment_of_capsule(pos_b, quat_b, size_b)
    d1 = a1 - a0
    d2 = b1 - b0
    r0 = a0 - b0
    a = pl.vdot(d1, d1)
    e = pl.vdot(d2, d2)
    f = pl.vdot(d2, r0)
    c = pl.vdot(d1, r0)
    bb = pl.vdot(d1, d2)
    denom = a * e - bb * bb
    s = jnp.where(
        denom > 1e-9,
        jnp.clip((bb * f - c * e) / jnp.maximum(denom, 1e-9), 0.0, 1.0),
        0.0,
    )
    t = jnp.where(
        e > 1e-9, jnp.clip((bb * s + f) / jnp.maximum(e, 1e-9), 0.0, 1.0), 0.0
    )
    s = jnp.where(
        a > 1e-9, jnp.clip((bb * t - c) / jnp.maximum(a, 1e-9), 0.0, 1.0), 0.0
    )
    pa = a0 + d1 * s
    pb = b0 + d2 * t
    delta = pa - pb
    dist = pl.vnorm(delta)
    ra, rb = size_a.x, size_b.x
    depth = ra + rb - dist
    up = V3(
        jnp.zeros_like(dist), jnp.ones_like(dist), jnp.zeros_like(dist)
    )
    n = pl.vsafe_normalize(delta, up)
    point = pb + n * rb
    return point, n, depth, depth > 0.0


def _capsule_box(pos_a, quat_a, size_a, pos_b, quat_b, h_b):
    """contacts._capsule_box in plane form: 5 probes."""
    a0, a1 = _segment_of_capsule(pos_a, quat_a, size_a)
    r = size_a.x
    mid = _closest_pt_segment(a0, a1, pos_b)

    l0 = pl.qrot_inv(quat_b, a0 - pos_b)
    l1 = pl.qrot_inv(quat_b, a1 - pos_b)
    d = l1 - l0
    lim = h_b + V3(r, r, r)
    safe_d = V3(
        jnp.where(jnp.abs(d.x) < 1e-9, 1e-9, d.x),
        jnp.where(jnp.abs(d.y) < 1e-9, 1e-9, d.y),
        jnp.where(jnp.abs(d.z) < 1e-9, 1e-9, d.z),
    )
    ta = (-lim - l0) * V3(1.0 / safe_d.x, 1.0 / safe_d.y, 1.0 / safe_d.z)
    tb = (lim - l0) * V3(1.0 / safe_d.x, 1.0 / safe_d.y, 1.0 / safe_d.z)
    t0 = jnp.clip(pl.vhmax(pl.vmin(ta, tb)), 0.0, 1.0)
    t1 = jnp.clip(pl.vhmin(pl.vmax(ta, tb)), 0.0, 1.0)
    c0 = a0 + (a1 - a0) * t0
    c1 = a0 + (a1 - a0) * t1
    a0, a1, mid, c0, c1 = _bar((a0, a1, mid, c0, c1))

    is_sphere = size_a.y <= 1e-5
    out = []
    for idx, c in enumerate([a0, a1, mid, c0, c1]):
        p, n, dep, v = _sphere_box(c, r, pos_b, quat_b, h_b)
        if idx != 2:  # degenerate capsule (sphere): keep only the mid probe
            v = v & ~is_sphere
        out.append((p, n, dep, v))
    return _bar(out)


_ALL_KINDS = ("box", "sphere", "capsule")


def _pair_candidates(
    pos_a, quat_a, shape_a, size_a, pos_b, quat_b, shape_b, size_b,
    kinds=_ALL_KINDS,
):
    """contacts._pair_candidates in plane form: list of _N_CAND
    (point, normal B->A, depth, valid) plane records.

    kinds: static hint of which shape types exist ANYWHERE in the scene
    (SolverParams.shape_kinds). ("box",) drops the capsule/sphere
    candidate generators and the 4-way select — the box-only headline
    fleet's narrowphase roughly halves."""
    if tuple(kinds) == ("box",):
        return _box_box(pos_a, quat_a, size_a, pos_b, quat_b, size_b)
    cap_a = V3(size_a.x, jnp.where(shape_a == SHAPE_SPHERE, 0.0, size_a.y), size_a.z)
    cap_b = V3(size_b.x, jnp.where(shape_b == SHAPE_SPHERE, 0.0, size_b.y), size_b.z)
    is_box_a = shape_a == SHAPE_BOX
    is_box_b = shape_b == SHAPE_BOX

    bb_c = _box_box(pos_a, quat_a, size_a, pos_b, quat_b, size_b)
    cc_p, cc_n, cc_d, cc_v = _capsule_capsule(
        pos_a, quat_a, cap_a, pos_b, quat_b, cap_b
    )
    cb_c = _capsule_box(pos_a, quat_a, cap_a, pos_b, quat_b, size_b)
    bc_raw = _capsule_box(pos_b, quat_b, cap_b, pos_a, quat_a, size_a)
    bc_c = [(p, -n, d, v) for (p, n, d, v) in bc_raw]

    bb = is_box_a & is_box_b
    cc = (~is_box_a) & (~is_box_b)
    a_cap_b_box = (~is_box_a) & is_box_b

    z = jnp.zeros_like(pos_a.x)
    invalid = (V3(z, z, z), V3(z, z, z), z - 1.0, jnp.zeros_like(z, bool))
    cc_list = [(cc_p, cc_n, cc_d, cc_v)] + [invalid] * 9
    cb_list = list(cb_c) + [invalid] * 5
    bc_list = list(bc_c) + [invalid] * 5

    def sel4(s, quads):
        bbq, ccq, cbq, bcq = quads
        pt = pl.vwhere(bb, bbq[0], pl.vwhere(cc, ccq[0], pl.vwhere(a_cap_b_box, cbq[0], bcq[0])))
        nm = pl.vwhere(bb, bbq[1], pl.vwhere(cc, ccq[1], pl.vwhere(a_cap_b_box, cbq[1], bcq[1])))
        dp = jnp.where(bb, bbq[2], jnp.where(cc, ccq[2], jnp.where(a_cap_b_box, cbq[2], bcq[2])))
        vd = jnp.where(bb, bbq[3], jnp.where(cc, ccq[3], jnp.where(a_cap_b_box, cbq[3], bcq[3])))
        return pt, nm, dp, vd

    return [
        sel4(s, (bb_c[s], cc_list[s], cb_list[s], bc_list[s]))
        for s in range(_N_CAND)
    ]


# ---------------------------------------------------------------------------
# contact generation (contacts.generate_contacts in plane form)
# ---------------------------------------------------------------------------

@struct.dataclass
class PlanarContacts:
    """Per-pair contact planes: [K, P] per-contact, [P] per-pair."""

    point: V3              # of [K, P]
    normal: V3             # of [K, P]
    depth: jax.Array       # [K, P]
    valid: jax.Array       # [K, P] bool
    cand: jax.Array        # [K, P] i32 candidate slot (warm-start key)
    friction: jax.Array    # [P] combined
    restitution: jax.Array # [P] combined
    trigger_overlap: jax.Array  # [K, P] bool — geometrically valid but
                                # trigger-flagged (event, not constraint)
    pair_valid: jax.Array       # [P] bool (broadphase validity)


def _sat_core(ga, gb, pvf, kinds=_ALL_KINDS):
    """SAT narrowphase + top-K selection from gathered pair rows.

    ga/gb [14, P] f32 (rows past 14 are ignored); pvf [P] f32 broadphase
    validity. Returns a 12-tuple of plain arrays (see _sat_ref).

    Top-K is jnp.stack + argmax: selecting from live candidate expressions
    instead makes XLA duplicate the whole SAT graph into every select.
    """
    pair_valid = pvf > 0.5

    def unpack(g):
        return (
            V3(g[..., 0, :], g[..., 1, :], g[..., 2, :]),
            Q4(g[..., 3, :], g[..., 4, :], g[..., 5, :], g[..., 6, :]),
            g[..., 7, :].astype(jnp.int32),
            V3(g[..., 8, :], g[..., 9, :], g[..., 10, :]),
            g[..., 11, :], g[..., 12, :], g[..., 13, :],
        )

    pos_a, quat_a, shape_a, size_a, fr_a, re_a, tg_a = unpack(ga)
    pos_b, quat_b, shape_b, size_b, fr_b, re_b, tg_b = unpack(gb)

    cands = _pair_candidates(
        pos_a, quat_a, shape_a, size_a, pos_b, quat_b, shape_b, size_b,
        kinds,
    )
    neg_inf = jnp.float32(-jnp.inf)
    sel_pt, sel_nm, sel_dp, sel_vd, sel_id = [], [], [], [], []
    # top-K deepest == the conventional path's lax.top_k over 10
    # (argmax picks the first occurrence of the max)
    dp_s = jnp.stack([c[2] for c in cands])                # [10, ...]
    vd_s = jnp.stack([c[3] for c in cands])
    ptx = jnp.stack([c[0].x for c in cands])
    pty = jnp.stack([c[0].y for c in cands])
    ptz = jnp.stack([c[0].z for c in cands])
    nmx = jnp.stack([c[1].x for c in cands])
    nmy = jnp.stack([c[1].y for c in cands])
    nmz = jnp.stack([c[1].z for c in cands])
    score = jnp.where(vd_s & pair_valid[None], dp_s, neg_inf)
    slot_ids = jnp.arange(_N_CAND, dtype=jnp.int32).reshape(
        (_N_CAND,) + (1,) * (score.ndim - 1)
    )
    for _k in range(_K):
        best = jnp.max(score, axis=0)
        bidx = jnp.argmax(score, axis=0).astype(jnp.int32)
        oh = slot_ids == bidx[None]
        pick = lambda s: jnp.sum(jnp.where(oh, s, 0.0), axis=0)
        sel_pt.append(V3(pick(ptx), pick(pty), pick(ptz)))
        sel_nm.append(V3(pick(nmx), pick(nmy), pick(nmz)))
        sel_dp.append(pick(dp_s))
        sel_vd.append(jnp.isfinite(best) & (best > 0.0))
        sel_id.append(bidx)
        score = jnp.where(oh, neg_inf, score)

    return (
        [p.x for p in sel_pt], [p.y for p in sel_pt], [p.z for p in sel_pt],
        [p.x for p in sel_nm], [p.y for p in sel_nm], [p.z for p in sel_nm],
        sel_dp,
        [v.astype(jnp.float32) for v in sel_vd],
        sel_id,
        fr_a * fr_b,
        re_a * re_b,
        ((tg_a > 0.0) | (tg_b > 0.0)).astype(jnp.float32),
    )


def _sat_ref(ga, gb, pvf, kinds=_ALL_KINDS):
    """Per-scene SAT: stacks the per-contact lists to [K, P] arrays."""
    out = _sat_core(ga, gb, pvf, kinds=kinds)
    stK = lambda xs: jnp.stack(xs, axis=0)
    return tuple(stK(o) if isinstance(o, list) else o for o in out)


def _sat_inputs(b: PlanarBodies, ia, ib, pair_valid):
    """Gather the per-pair SAT operand planes: ga/gb [14, P], pvf [P]."""
    n = b.n
    centers = _shape_centers(b)
    rows = jnp.stack(
        [
            centers.x, centers.y, centers.z,
            b.quat.w, b.quat.x, b.quat.y, b.quat.z,
            b.shape.astype(jnp.float32),
            b.size.x, b.size.y, b.size.z,
            b.friction, b.restitution,
            b.trigger.astype(jnp.float32),
        ],
        axis=0,
    )  # [14, N] — small dim leads, lanes = N
    oh_a = _onehot(ia, n)
    oh_b = _onehot(ib, n)
    ga = _mm(rows, oh_a)  # [14, P]
    gb = _mm(rows, oh_b)
    return ga, gb, pair_valid.astype(jnp.float32)


def planar_contacts(b: PlanarBodies, ia, ib, pair_valid,
                    kinds=_ALL_KINDS) -> PlanarContacts:
    ga, gb, pvf = _sat_inputs(b, ia, ib, pair_valid)

    (ptx, pty, ptz, nmx, nmy, nmz, dp, vdf, cid, fr, re, tgf) = _sat_ref(
        ga, gb, pvf, kinds=tuple(kinds)
    )
    valid_raw = vdf > 0.5
    is_trigger = tgf > 0.5
    return PlanarContacts(
        point=V3(ptx, pty, ptz),
        normal=V3(nmx, nmy, nmz),
        depth=dp,
        valid=valid_raw & ~is_trigger[None],
        cand=cid,
        friction=fr,
        restitution=re,
        trigger_overlap=valid_raw & is_trigger[None],
        pair_valid=pair_valid,
    )


# ---------------------------------------------------------------------------
# warm-start cache (warmstart.py in plane form; same keying semantics)
# ---------------------------------------------------------------------------

_EMPTY = jnp.int32(-1)


@struct.dataclass
class PlanarCache:
    """Per-scene warm-start cache, plane layout [P] / [K, P]."""

    key_a: jax.Array  # [P] i32 (-1 empty)
    key_b: jax.Array  # [P] i32
    cand: jax.Array   # [K, P] i32 (-1 none)
    lam_n: jax.Array  # [K, P] f32 accumulated normal impulse
    lam_1: jax.Array  # [K, P]
    lam_2: jax.Array  # [K, P]


def empty_planar_cache(max_pairs: int, k: int = _K) -> PlanarCache:
    return PlanarCache(
        key_a=jnp.full((max_pairs,), _EMPTY, jnp.int32),
        key_b=jnp.full((max_pairs,), _EMPTY, jnp.int32),
        cand=jnp.full((k, max_pairs), -1, jnp.int32),
        lam_n=jnp.zeros((k, max_pairs), jnp.float32),
        lam_1=jnp.zeros((k, max_pairs), jnp.float32),
        lam_2=jnp.zeros((k, max_pairs), jnp.float32),
    )


def _pair_keys(ia, ib, pair_valid, key_id):
    if key_id is None:
        ka, kb = ia, ib
    else:
        # direct i32 row lookup — a one-hot f32 matmul would round uids
        # past 2^24 (bigscene keys by persistent entity uid); [P]-from-[N]
        # gathers are noise at warm-start call counts
        ka, kb = key_id[ia], key_id[ib]
    ka = jnp.where(pair_valid, ka, _EMPTY).astype(jnp.int32)
    kb = jnp.where(pair_valid, kb, _EMPTY).astype(jnp.int32)
    return ka, kb


def planar_gather_warm(cache: PlanarCache, ia, ib, pair_valid, cand,
                       key_id=None):
    """lam0 planes (ln, l1, l2) [K, P] — warmstart.gather_warm_impulses."""
    ka, kb = _pair_keys(ia, ib, pair_valid, key_id)
    onehot = (
        (ka[:, None] == cache.key_a[None, :])
        & (kb[:, None] == cache.key_b[None, :])
        & pair_valid[:, None]
        & (cache.key_a != _EMPTY)[None, :]
    ).astype(jnp.float32)  # [P_new, P_old]
    # previous pair data gathered by the match: [rows, P_old] @ [P_old, P]
    prev = _mm(
        jnp.concatenate(
            [
                (cache.cand + 1).astype(jnp.float32),
                cache.lam_n, cache.lam_1, cache.lam_2,
            ],
            axis=0,
        ),  # [4K, P_old]
        onehot.T,
    )  # [4K, P]
    k = _K
    prev_cand = prev[:k].astype(jnp.int32) - 1   # [K, P]
    prev_ln, prev_l1, prev_l2 = prev[k:2*k], prev[2*k:3*k], prev[3*k:4*k]
    # re-associate by candidate slot: cur [K,P] vs prev [K,P]
    ln = jnp.zeros_like(prev_ln)
    l1 = jnp.zeros_like(prev_l1)
    l2 = jnp.zeros_like(prev_l2)
    for t in range(k):
        m = (cand == prev_cand[t][None, :]) & (prev_cand[t] >= 0)[None, :]
        mf = m.astype(jnp.float32)
        ln = ln + mf * prev_ln[t][None, :]
        l1 = l1 + mf * prev_l1[t][None, :]
        l2 = l2 + mf * prev_l2[t][None, :]
    return ln, l1, l2


def planar_store(cache: PlanarCache, ia, ib, pair_valid, con: PlanarContacts,
                 ln, l1, l2, key_id=None) -> PlanarCache:
    ka, kb = _pair_keys(ia, ib, pair_valid, key_id)
    cv = con.valid
    return cache.replace(
        key_a=ka,
        key_b=kb,
        cand=jnp.where(cv, con.cand, -1).astype(jnp.int32),
        lam_n=jnp.where(cv, ln, 0.0),
        lam_1=jnp.where(cv, l1, 0.0),
        lam_2=jnp.where(cv, l2, 0.0),
    )


# ---------------------------------------------------------------------------
# velocity solve (solver.solve_velocity in plane form)
# ---------------------------------------------------------------------------

def _tangents(n: V3):
    """solver._orthonormal_tangents in plane form."""
    use_x = jnp.abs(n.x) < 0.9
    helper = V3(
        jnp.where(use_x, 1.0, 0.0),
        jnp.where(use_x, 0.0, 1.0),
        jnp.zeros_like(n.x),
    )
    t1 = pl.vnormalize(pl.vcross(n, helper))
    t2 = pl.vcross(n, t1)
    return t1, t2


def _mm_nt(a, b):
    """a @ b^T without materializing the transpose: contracts a's last
    dim with b's last dim."""
    return jax.lax.dot_general(
        a, b, dimension_numbers=(((1,), (1,)), ((), ())),
        precision=m3.PRECISION, preferred_element_type=jnp.float32,
    )


def _iter_loop(q, oh_a, oh_b, vw0, iterations: int):
    """The relaxed-Jacobi sweep loop over explicit quantity arrays.

    q: dict of iteration-invariant operands — V3-of-[..., K, P] planes
    for n/t1/t2/a_*/r_*, [..., K, P] for kn/k1/k2/target/cvalid/ln0/l10/
    l20, [..., P] or [..., 1, P] for im_a/im_b/relax/fr. oh_a/oh_b
    [..., N, P] f32 one-hots, vw0 [..., 6, N]. Returns (vw, ln, l1, l2).
    Shared verbatim by the staged solve and the fused middle so both
    paths stay formula-identical."""
    n, t1, t2 = q["n"], q["t1"], q["t2"]
    a_an, a_bn = q["a_an"], q["a_bn"]
    a_a1, a_b1 = q["a_a1"], q["a_b1"]
    a_a2, a_b2 = q["a_a2"], q["a_b2"]
    r_a, r_b = q["r_a"], q["r_b"]
    kn, k1, k2 = q["kn"], q["k1"], q["k2"]
    target = q["target"]
    ln, l1, l2 = q["ln0"], q["l10"], q["l20"]
    im_a, im_b = q["im_a"], q["im_b"]
    relax, fr = q["relax"], q["fr"]
    cv = q["cvalid"] > 0.5
    # both sides in ONE dot per direction: gather [.., 6, N] @
    # [.., N, 2P], scatter [.., 6, 2P] x [.., N, 2P] contracted over 2P
    oh2 = jnp.concatenate([oh_a, oh_b], axis=-1)
    p_cap = oh_a.shape[-1]

    def one_pass(vw, ln, l1, l2):
        g = _mm(vw, oh2)                      # [..., 6, 2P]
        sa_ = lambda i: g[..., i:i + 1, :p_cap]
        sb_ = lambda i: g[..., i:i + 1, p_cap:]
        va = V3(sa_(0), sa_(1), sa_(2))
        wa = V3(sa_(3), sa_(4), sa_(5))
        vb = V3(sb_(0), sb_(1), sb_(2))
        wb = V3(sb_(3), sb_(4), sb_(5))
        v = (va + pl.vcross(wa, r_a)) - (vb + pl.vcross(wb, r_b))

        vn = pl.vdot(v, n)
        d_ln = (target - vn) / kn * relax
        ln_new = jnp.maximum(ln + d_ln, 0.0)
        d_ln = jnp.where(cv, ln_new - ln, 0.0)
        ln_new = ln + d_ln

        max_f = fr * ln_new
        vt1 = pl.vdot(v, t1)
        vt2 = pl.vdot(v, t2)
        d_l1 = -vt1 / k1 * relax
        d_l2 = -vt2 / k2 * relax
        l1_new = jnp.clip(l1 + d_l1, -max_f, max_f)
        l2_new = jnp.clip(l2 + d_l2, -max_f, max_f)
        d_l1 = jnp.where(cv, l1_new - l1, 0.0)
        d_l2 = jnp.where(cv, l2_new - l2, 0.0)
        l1_new = l1 + d_l1
        l2_new = l2 + d_l2

        imp = n * d_ln + t1 * d_l1 + t2 * d_l2
        dw_a = a_an * d_ln + a_a1 * d_l1 + a_a2 * d_l2
        dw_b = a_bn * d_ln + a_b1 * d_l1 + a_b2 * d_l2
        lin_a, lin_b = imp * im_a, imp * im_b

        def ksum(x):                            # [..., K, P] -> [..., 1, P]
            return jnp.sum(x, axis=-2, keepdims=True)

        upd = jnp.concatenate(
            [
                jnp.concatenate([ksum(la), -ksum(lb)], axis=-1)
                for la, lb in (
                    (lin_a.x, lin_b.x), (lin_a.y, lin_b.y),
                    (lin_a.z, lin_b.z),
                    (dw_a.x, dw_b.x), (dw_a.y, dw_b.y), (dw_a.z, dw_b.z),
                )
            ],
            axis=-2,
        )                                       # [..., 6, 2P]
        vw = vw + _mm_nt(upd, oh2)
        return vw, ln_new, l1_new, l2_new

    vw = vw0
    for _ in range(iterations):
        vw, ln, l1, l2 = one_pass(vw, ln, l1, l2)
    return vw, ln, l1, l2


def planar_solve(b: PlanarBodies, con: PlanarContacts, params: SolverParams,
                 ia, ib, lam0=None):
    """Returns (vel V3 [N], omega V3 [N], (ln,l1,l2) [K,P], cnt [N])."""
    nb = b.n
    c_valid = con.valid
    n = con.normal
    t1, t2 = _tangents(n)
    pvalid = jnp.any(c_valid, axis=0)

    iw = _inv_inertia_world(b)
    # packed per-body setup rows: inv_mass, pos, iw (9) -> [13, N]
    setup = jnp.stack(
        [b.inv_mass, b.pos.x, b.pos.y, b.pos.z]
        + [iw[i][j] for i in range(3) for j in range(3)],
        axis=0,
    )
    oh_a = _onehot(ia, nb)          # [N, P] f32 (unmasked: parity with
    oh_b = _onehot(ib, nb)          # the conventional row gather)
    sa = _mm(setup, oh_a)           # [13, P]
    sb = _mm(setup, oh_b)

    def unpack(s):
        im = s[0]
        pos = V3(s[1], s[2], s[3])
        iw_p = tuple(tuple(s[4 + 3 * i + j] for j in range(3)) for i in range(3))
        return im, pos, iw_p

    im_a, pos_a, iw_a = unpack(sa)
    im_b, pos_b, iw_b = unpack(sb)
    r_a = con.point - pos_a          # V3 of [K, P] (broadcast [P] -> [K, P])
    r_b = con.point - pos_b
    r_a, r_b = _bar((r_a, r_b))

    def ang(iw_x, r, d):
        return pl.mvec(iw_x, pl.vcross(r, d))

    def eff_mass(d, a_a, a_b):
        return (
            im_a + im_b
            + pl.vdot(d, pl.vcross(a_a, r_a) + pl.vcross(a_b, r_b))
        )

    a_an, a_bn = ang(iw_a, r_a, n), ang(iw_b, r_b, n)
    a_a1, a_b1 = ang(iw_a, r_a, t1), ang(iw_b, r_b, t1)
    a_a2, a_b2 = ang(iw_a, r_a, t2), ang(iw_b, r_b, t2)
    kn = jnp.maximum(eff_mass(n, a_an, a_bn), 1e-9)
    k1 = jnp.maximum(eff_mass(t1, a_a1, a_b1), 1e-9)
    k2 = jnp.maximum(eff_mass(t2, a_a2, a_b2), 1e-9)
    (n, t1, t2, a_an, a_bn, a_a1, a_b1, a_a2, a_b2, kn, k1, k2) = _bar(
        (n, t1, t2, a_an, a_bn, a_a1, a_b1, a_a2, a_b2, kn, k1, k2)
    )

    # velocities as one [6, N] stack; pair sides via ONE [6, N] @ [N, 2P]
    oh2 = jnp.concatenate([oh_a, oh_b], axis=1)  # [N, 2P]
    p_cap = ia.shape[0]

    def vw_stack(vel: V3, om: V3):
        return jnp.stack([vel.x, vel.y, vel.z, om.x, om.y, om.z], axis=0)

    def rel_vel(vw):
        g = _mm(vw, oh2)  # [6, 2P]
        va = V3(g[0, :p_cap], g[1, :p_cap], g[2, :p_cap])
        wa = V3(g[3, :p_cap], g[4, :p_cap], g[5, :p_cap])
        vb = V3(g[0, p_cap:], g[1, p_cap:], g[2, p_cap:])
        wb = V3(g[3, p_cap:], g[4, p_cap:], g[5, p_cap:])
        # per-contact: v + w x r (V3 [P] broadcast against [K, P])
        return (va + pl.vcross(wa, r_a)) - (vb + pl.vcross(wb, r_b))

    def apply_upd(vw, lin_a: V3, ang_a: V3, lin_b: V3, ang_b: V3):
        # sum the K contacts of each pair, then ONE [6, 2P] @ [2P, N]
        upd = jnp.stack(
            [
                jnp.concatenate(
                    [jnp.sum(la, axis=0), -jnp.sum(lb, axis=0)], axis=0
                )
                for la, lb in (
                    (lin_a.x, lin_b.x), (lin_a.y, lin_b.y), (lin_a.z, lin_b.z),
                    (ang_a.x, ang_b.x), (ang_a.y, ang_b.y), (ang_a.z, ang_b.z),
                )
            ],
            axis=0,
        )  # [6, 2P]
        return vw + _mm(upd, oh2.T)

    vw0 = vw_stack(b.vel, b.omega)
    v0 = rel_vel(vw0)
    vn0 = pl.vdot(v0, n)
    bounce = -con.restitution[None, :] * jnp.where(
        vn0 < -params.restitution_threshold, vn0, 0.0
    )
    bias = (params.baumgarte / params.dt) * jnp.maximum(
        con.depth - params.slop, 0.0
    )
    target = jnp.maximum(bounce, bias)

    # Jacobi relaxation 1/max(touch_a, touch_b) (solver.py:256-282)
    w = jnp.sum(c_valid.astype(jnp.float32), axis=0) * pvalid  # [P]
    cnt = _mm(w[None, :], oh_a.T)[0] + _mm(w[None, :], oh_b.T)[0]  # [N]
    gcnt = _mm(cnt[None, :], oh2)[0]  # [2P]
    cnt_a, cnt_b = gcnt[:p_cap], gcnt[p_cap:]
    touch_a = jnp.where(im_a > 0, cnt_a, 1.0)
    touch_b = jnp.where(im_b > 0, cnt_b, 1.0)
    relax = (
        params.relaxation / jnp.maximum(jnp.maximum(touch_a, touch_b), 1.0)
    )[None, :]

    fr = con.friction[None, :]

    if lam0 is None:
        z = jnp.zeros_like(kn)
        ln0, l10, l20 = z, z, z
    else:
        ws = params.warm_start
        ln0 = jnp.where(c_valid, jnp.maximum(lam0[0] * ws, 0.0), 0.0)
        max_f0 = fr * ln0
        l10 = jnp.clip(jnp.where(c_valid, lam0[1] * ws, 0.0), -max_f0, max_f0)
        l20 = jnp.clip(jnp.where(c_valid, lam0[2] * ws, 0.0), -max_f0, max_f0)
        imp = n * ln0 + t1 * l10 + t2 * l20
        dw_a = a_an * ln0 + a_a1 * l10 + a_a2 * l20
        dw_b = a_bn * ln0 + a_b1 * l10 + a_b2 * l20
        vw0 = apply_upd(vw0, imp * im_a, dw_a, imp * im_b, dw_b)

    quantities = {
        "n": n, "t1": t1, "t2": t2, "a_an": a_an, "a_bn": a_bn,
        "a_a1": a_a1, "a_b1": a_b1, "a_a2": a_a2, "a_b2": a_b2,
        "r_a": r_a, "r_b": r_b,
        "kn": kn, "k1": k1, "k2": k2, "target": target,
        "cvalid": c_valid.astype(jnp.float32),
        "ln0": ln0, "l10": l10, "l20": l20,
        "im_a": im_a, "im_b": im_b, "relax": relax, "fr": fr,
    }
    vw, ln, l1, l2 = _iter_loop(
        quantities, oh_a, oh_b, vw0, params.iterations
    )
    vel = V3(vw[0], vw[1], vw[2])
    omega = V3(vw[3], vw[4], vw[5])
    return vel, omega, (ln, l1, l2), cnt


# ---------------------------------------------------------------------------
# fused middle: SAT narrowphase + warm-start gather + velocity solve as ONE
# function of packed operands
# ---------------------------------------------------------------------------
# The staged path (planar_contacts -> planar_gather_warm -> planar_solve)
# builds the same quantities through separate helpers. The fused core runs
# the same formulas in the same order from 21 packed body rows, so the
# per-pair gathers happen once per step.

# rows layout for _middle_core ([S=21, N] per scene):
#   0:14  the SAT operand rows of _sat_inputs (centers, quat, shape, size,
#         friction, restitution, trigger)
#   14    inv_mass
#   15:18 pos
#   18:21 inv_inertia
_MID_ROWS = 21


def _warm_prev(cache: PlanarCache, ka, kb, pair_valid):
    """The key-matched previous pair record (planar_gather_warm's match +
    gather, without the slot re-association): [4K, P] — cand+1 rows then
    lam_n/lam_1/lam_2 rows."""
    onehot = (
        (ka[:, None] == cache.key_a[None, :])
        & (kb[:, None] == cache.key_b[None, :])
        & pair_valid[:, None]
        & (cache.key_a != _EMPTY)[None, :]
    ).astype(jnp.float32)  # [P_new, P_old]
    return _mm(
        jnp.concatenate(
            [
                (cache.cand + 1).astype(jnp.float32),
                cache.lam_n, cache.lam_1, cache.lam_2,
            ],
            axis=0,
        ),
        onehot.T,
    )  # [4K, P]


def _middle_core(rows, ia, ib, pvf, prev, vw0,
                 params: SolverParams, kinds=_ALL_KINDS):
    """Contacts + warm gather + solve from packed operands for one scene
    (vmap over scenes). Formula-identical to the staged path: the SAT
    core, warm re-association and _iter_loop are shared code; the solve
    setup below mirrors planar_solve line for line (gathering quat/ii and
    computing the world inverse inertia at pair granularity is elementwise-
    identical to gathering the per-body result).

    rows [21, N] (_MID_ROWS layout), ia/ib [P] i32, pvf [P] f32, prev
    [4K, P] f32 — the key-matched previous pair record from _warm_prev
    (cand+1 rows then lam rows), vw0 [6, N].
    Returns (vwc [7, N] — vel/omega rows + contact-count row,
    lam [12, P], candf, validf, trigf [K, P] f32)."""
    f32 = jnp.float32
    nb = rows.shape[-1]
    p_cap = ia.shape[-1]
    pair_valid = pvf > 0.5

    # one-hots (values identical to _onehot: iota == idx)
    iota_n = jax.lax.broadcasted_iota(jnp.int32, (nb, 1), 0)
    oh_a = (iota_n == ia[..., None, :]).astype(f32)   # [.., N, P]
    oh_b = (iota_n == ib[..., None, :]).astype(f32)

    ga = _mm(rows, oh_a)                              # [.., 21, P]
    gb = _mm(rows, oh_b)

    # --- SAT narrowphase (shared core; extra rows past 14 are ignored) --
    (ptx, pty, ptz, nmx, nmy, nmz, dp, vd, cid, _fr, _re, _tg) = _sat_core(
        ga, gb, pvf, kinds=kinds
    )
    stk = lambda xs: jnp.stack(xs, axis=-2)            # K-list -> [.., K, P]
    point = V3(stk(ptx), stk(pty), stk(ptz))
    n = V3(stk(nmx), stk(nmy), stk(nmz))
    depth = stk(dp)
    valid_raw = stk(vd) > 0.5
    cand = stk(cid)                                    # [.., K, P] i32
    # pair-level combines as [.., 1, P] keepdim slices (same values as
    # _sat_core's fr/re/tg, shaped for K-broadcast without expand_dims)
    fr = ga[..., 11:12, :] * gb[..., 11:12, :]
    re = ga[..., 12:13, :] * gb[..., 12:13, :]
    trig = (ga[..., 13:14, :] > 0.0) | (gb[..., 13:14, :] > 0.0)
    c_valid = valid_raw & ~trig
    trig_ov = valid_raw & trig

    # --- warm-start slot re-association (planar_gather_warm tail) -------
    k = _K
    prev_cand = prev[..., :k, :].astype(jnp.int32) - 1
    prev_ln = prev[..., k:2 * k, :]
    prev_l1 = prev[..., 2 * k:3 * k, :]
    prev_l2 = prev[..., 3 * k:4 * k, :]
    ln0g = jnp.zeros_like(depth)
    l10g = jnp.zeros_like(depth)
    l20g = jnp.zeros_like(depth)
    for t in range(k):
        pc_t = prev_cand[..., t:t + 1, :]              # [.., 1, P]
        mf = ((cand == pc_t) & (pc_t >= 0)).astype(f32)
        ln0g = ln0g + mf * prev_ln[..., t:t + 1, :]
        l10g = l10g + mf * prev_l1[..., t:t + 1, :]
        l20g = l20g + mf * prev_l2[..., t:t + 1, :]

    # --- solve setup (planar_solve in generic form) ---------------------
    t1, t2 = _tangents(n)
    pvalid = jnp.any(c_valid, axis=-2, keepdims=True)  # [.., 1, P]

    def side(g):
        im = g[..., 14:15, :]
        pos = V3(g[..., 15:16, :], g[..., 16:17, :], g[..., 17:18, :])
        quat = Q4(g[..., 3:4, :], g[..., 4:5, :], g[..., 5:6, :],
                  g[..., 6:7, :])
        ii = V3(g[..., 18:19, :], g[..., 19:20, :], g[..., 20:21, :])
        r = pl.q_to_mat(quat)
        iiv = (ii.x, ii.y, ii.z)
        iw = tuple(
            tuple(
                sum(r[i][c] * iiv[c] * r[j][c] for c in range(3))
                for j in range(3)
            )
            for i in range(3)
        )
        return im, pos, iw

    im_a, pos_a, iw_a = side(ga)
    im_b, pos_b, iw_b = side(gb)
    r_a = point - pos_a                                # [.., K, P]
    r_b = point - pos_b
    r_a, r_b = _bar((r_a, r_b))

    def ang(iw_x, r, d):
        return pl.mvec(iw_x, pl.vcross(r, d))

    def eff_mass(d, a_a, a_b):
        return (
            im_a + im_b
            + pl.vdot(d, pl.vcross(a_a, r_a) + pl.vcross(a_b, r_b))
        )

    a_an, a_bn = ang(iw_a, r_a, n), ang(iw_b, r_b, n)
    a_a1, a_b1 = ang(iw_a, r_a, t1), ang(iw_b, r_b, t1)
    a_a2, a_b2 = ang(iw_a, r_a, t2), ang(iw_b, r_b, t2)
    kn = jnp.maximum(eff_mass(n, a_an, a_bn), 1e-9)
    k1 = jnp.maximum(eff_mass(t1, a_a1, a_b1), 1e-9)
    k2 = jnp.maximum(eff_mass(t2, a_a2, a_b2), 1e-9)
    (n, t1, t2, a_an, a_bn, a_a1, a_b1, a_a2, a_b2, kn, k1, k2) = _bar(
        (n, t1, t2, a_an, a_bn, a_a1, a_b1, a_a2, a_b2, kn, k1, k2)
    )

    oh2 = jnp.concatenate([oh_a, oh_b], axis=-1)       # [.., N, 2P]

    def rel_vel(vw):
        g = _mm(vw, oh2)                              # [.., 6, 2P]
        sa_ = lambda i: g[..., i:i + 1, :p_cap]
        sb_ = lambda i: g[..., i:i + 1, p_cap:]
        va = V3(sa_(0), sa_(1), sa_(2))
        wa = V3(sa_(3), sa_(4), sa_(5))
        vb = V3(sb_(0), sb_(1), sb_(2))
        wb = V3(sb_(3), sb_(4), sb_(5))
        return (va + pl.vcross(wa, r_a)) - (vb + pl.vcross(wb, r_b))

    v0 = rel_vel(vw0)
    vn0 = pl.vdot(v0, n)
    bounce = -re * jnp.where(vn0 < -params.restitution_threshold, vn0, 0.0)
    bias = (params.baumgarte / params.dt) * jnp.maximum(
        depth - params.slop, 0.0
    )
    target = jnp.maximum(bounce, bias)

    # Jacobi relaxation 1/max(touch_a, touch_b)
    w = jnp.sum(c_valid.astype(f32), axis=-2, keepdims=True) * pvalid
    cnt1 = _mm_nt(w, oh_a) + _mm_nt(w, oh_b)         # [.., 1, N]
    gcnt = _mm(cnt1, oh2)                             # [.., 1, 2P]
    cnt_a = gcnt[..., :, :p_cap]
    cnt_b = gcnt[..., :, p_cap:]
    touch_a = jnp.where(im_a > 0, cnt_a, 1.0)
    touch_b = jnp.where(im_b > 0, cnt_b, 1.0)
    relax = params.relaxation / jnp.maximum(
        jnp.maximum(touch_a, touch_b), 1.0
    )

    # warm-start clamp + pre-application
    ws = params.warm_start
    ln0 = jnp.where(c_valid, jnp.maximum(ln0g * ws, 0.0), 0.0)
    max_f0 = fr * ln0
    l10 = jnp.clip(jnp.where(c_valid, l10g * ws, 0.0), -max_f0, max_f0)
    l20 = jnp.clip(jnp.where(c_valid, l20g * ws, 0.0), -max_f0, max_f0)
    imp = n * ln0 + t1 * l10 + t2 * l20
    dw_a = a_an * ln0 + a_a1 * l10 + a_a2 * l20
    dw_b = a_bn * ln0 + a_b1 * l10 + a_b2 * l20
    lin_a, lin_b = imp * im_a, imp * im_b

    def ksum(x):
        return jnp.sum(x, axis=-2, keepdims=True)

    upd = jnp.concatenate(
        [
            jnp.concatenate([ksum(la), -ksum(lb)], axis=-1)
            for la, lb in (
                (lin_a.x, lin_b.x), (lin_a.y, lin_b.y), (lin_a.z, lin_b.z),
                (dw_a.x, dw_b.x), (dw_a.y, dw_b.y), (dw_a.z, dw_b.z),
            )
        ],
        axis=-2,
    )                                                  # [.., 6, 2P]
    vw0 = vw0 + _mm_nt(upd, oh2)

    q = {
        "n": n, "t1": t1, "t2": t2, "a_an": a_an, "a_bn": a_bn,
        "a_a1": a_a1, "a_b1": a_b1, "a_a2": a_a2, "a_b2": a_b2,
        "r_a": r_a, "r_b": r_b,
        "kn": kn, "k1": k1, "k2": k2, "target": target,
        "cvalid": c_valid.astype(f32),
        "ln0": ln0, "l10": l10, "l20": l20,
        "im_a": im_a, "im_b": im_b, "relax": relax, "fr": fr,
    }
    vw, ln, l1, l2 = _iter_loop(q, oh_a, oh_b, vw0, params.iterations)

    vwc = jnp.concatenate([vw, cnt1], axis=-2)         # [.., 7, N]
    lam = jnp.concatenate([ln, l1, l2], axis=-2)       # [.., 12, P]
    kb_ = jnp.broadcast_to
    shape_kp = depth.shape
    return (
        vwc, lam, cand.astype(f32),
        c_valid.astype(f32),
        kb_(trig_ov, shape_kp).astype(f32),
    )


def _middle_rows(b: PlanarBodies):
    """Pack the _MID_ROWS operand planes ([21, N]; leading dims vmap)."""
    centers = _shape_centers(b)
    return jnp.stack(
        [
            centers.x, centers.y, centers.z,
            b.quat.w, b.quat.x, b.quat.y, b.quat.z,
            b.shape.astype(jnp.float32),
            b.size.x, b.size.y, b.size.z,
            b.friction, b.restitution,
            b.trigger.astype(jnp.float32),
            b.inv_mass,
            b.pos.x, b.pos.y, b.pos.z,
            b.inv_inertia.x, b.inv_inertia.y, b.inv_inertia.z,
        ],
        axis=-2,
    )


# ---------------------------------------------------------------------------
# full step (solver.step_bodies_cached in plane form)
# ---------------------------------------------------------------------------

def step_planar_cached(b: PlanarBodies, params: SolverParams,
                       cache: PlanarCache, key_id=None):
    """One fixed physics step: integrate -> broadphase -> contacts ->
    warm-started solve -> sleep -> integrate positions. Pure and
    shape-static; vmap over scenes; scan over substeps with
    (bodies, cache) carry. Returns (bodies, cache, stats).

    The middle (contacts + warm gather + solve) is _middle_core; under
    vmap XLA batches it over the fleet."""
    b = planar_integrate_velocities(b, params.dt, params.gravity)
    ia, ib, pair_valid, n_cand = planar_broadphase(b, params.max_pairs)
    ka, kb = _pair_keys(ia, ib, pair_valid, key_id)
    rows = _middle_rows(b)
    vw0 = jnp.stack(
        [b.vel.x, b.vel.y, b.vel.z, b.omega.x, b.omega.y, b.omega.z],
        axis=-2,
    )
    prev = _warm_prev(cache, ka, kb, pair_valid)
    vwc, lam, candf, validf, trigf = _middle_core(
        rows, ia, ib, pair_valid.astype(jnp.float32), prev, vw0,
        params, tuple(params.shape_kinds),
    )
    vel = V3(vwc[..., 0, :], vwc[..., 1, :], vwc[..., 2, :])
    omega = V3(vwc[..., 3, :], vwc[..., 4, :], vwc[..., 5, :])
    cnt = vwc[..., 6, :]
    ln = lam[..., :_K, :]
    l1 = lam[..., _K:2 * _K, :]
    l2 = lam[..., 2 * _K:, :]
    cand = candf.astype(jnp.int32)
    c_valid = validf > 0.5

    dyn = (b.inv_mass > 0) & b.active
    low = (pl.vdot(vel, vel) < params.sleep_lin**2) & (
        pl.vdot(omega, omega) < params.sleep_ang**2
    )
    timer = jnp.where(dyn & low, b.sleep_timer + params.dt, 0.0)
    asleep = (timer > params.sleep_time) & (cnt > 0)
    zero = jnp.zeros_like(vel.x)
    vel = pl.vwhere(asleep, V3(zero, zero, zero), vel)
    omega = pl.vwhere(asleep, V3(zero, zero, zero), omega)
    b = b.replace(vel=vel, omega=omega, sleep_timer=timer)

    cache = cache.replace(
        key_a=ka,
        key_b=kb,
        cand=jnp.where(c_valid, cand, -1).astype(jnp.int32),
        lam_n=jnp.where(c_valid, ln, 0.0),
        lam_1=jnp.where(c_valid, l1, 0.0),
        lam_2=jnp.where(c_valid, l2, 0.0),
    )
    stats = {
        "pairs": jnp.sum(pair_valid.astype(jnp.int32)),
        "pair_overflow": jnp.maximum(n_cand - params.max_pairs, 0),
        "contacts": jnp.sum(validf > 0.5),
        "trigger_overlaps": jnp.sum(trigf > 0.5),
    }
    return planar_integrate_positions(b, params.dt), cache, stats

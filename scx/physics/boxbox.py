"""Box-box SAT contact manifold, branch-free and fixed-shape.

The textbook separating-axis test (6 face axes + 9 edge cross axes, with
ODE-style face preference bias) followed by incident-face clamping: the four
vertices of the incident face are clamped into the reference face rectangle
and their penetration re-evaluated on the incident plane.  For axis-aligned
stacking — the common case in the reference's city scenes — the clamp is
exactly the standard polygon clip; for tilted boxes it is a close
approximation that preserves the 4-point manifold.

Edge-edge minimum axes produce a contact PAIR: the closest points of the two
extremal edges plus a second sample at the far end of the mutual overlap
interval (collapses to one point for genuinely crossing edges; spans the
contact line for near-parallel edges — the manifold Bullet accumulates
across frames).

Everything returns fixed-size candidate arrays [10]: 4 (ref face on A) +
4 (ref face on B) + 2 (edge case), with only the winning case valid — shaped
for vmap over broadphase pairs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from scx.core import math3d as m3

_FACE_BIAS_REL = 0.95  # edge axis must beat faces by 5% to be chosen (ODE fudge)
_EPS = 1e-7


def _face_candidates(h_ref, h_inc, r_inc, t_inc, axis_i, sign_s):
    """Contacts with the reference face on the 'ref' box (local frame of ref).

    h_ref: ref half extents; h_inc: incident half extents; r_inc: rotation
    incident->ref; t_inc: incident center in ref frame; axis_i: ref face axis
    (int array 0..2); sign_s: +-1, side of the face.

    Returns (points[4,3] in ref frame, depth[4]).
    """
    e_i = jax.nn.one_hot(axis_i, 3)
    n_out = e_i * sign_s  # ref face outward normal (toward incident box)

    # incident face on the other box: axis with most anti-parallel normal
    # n_out in incident frame
    n_in_inc = jnp.einsum("ji,j->i", r_inc, n_out, precision=m3.PRECISION)
    j = jnp.argmax(jnp.abs(n_in_inc))
    e_j = jax.nn.one_hot(j, 3)
    sign_j = -jnp.sign(jnp.where(n_in_inc[j] == 0, 1.0, n_in_inc[j]))

    # the two spanning axes of the incident face
    k_axes = jnp.stack([(j + 1) % 3, (j + 2) % 3])
    e_k = jax.nn.one_hot(k_axes[0], 3)
    e_l = jax.nn.one_hot(k_axes[1], 3)
    hk = jnp.sum(h_inc * e_k)
    hl = jnp.sum(h_inc * e_l)
    center = sign_j * jnp.sum(h_inc * e_j) * e_j
    signs = jnp.asarray([[1.0, 1.0], [1.0, -1.0], [-1.0, 1.0], [-1.0, -1.0]])
    verts_inc = center + signs[:, 0:1] * hk * e_k + signs[:, 1:2] * hl * e_l
    # ref frame [4,3]
    verts = jnp.einsum("ij,vj->vi", r_inc, verts_inc, precision=m3.PRECISION) + t_inc

    # clamp into the reference face rectangle on the two non-i axes
    lims = h_ref * (1.0 - e_i) + 1e9 * e_i
    clamped = jnp.clip(verts, -lims, lims)

    # re-evaluate the i coordinate on the incident face plane
    # incident normal in ref
    n_inc_ref = jnp.einsum("ij,j->i", r_inc, e_j, precision=m3.PRECISION) * sign_j
    d_plane = jnp.einsum("i,i->", n_inc_ref, verts[0], precision=m3.PRECISION)
    ni = jnp.sum(n_inc_ref * e_i)
    safe_ni = jnp.where(jnp.abs(ni) < 0.05, jnp.sign(jnp.where(ni == 0, -sign_s, ni)) * 0.05, ni)
    rest = jnp.einsum(
        "vi,i->v", clamped * (1.0 - e_i), n_inc_ref, precision=m3.PRECISION
    )
    xi = (d_plane - rest) / safe_ni
    pts = clamped * (1.0 - e_i) + xi[:, None] * e_i

    h_i = jnp.sum(h_ref * e_i)
    depth = h_i - sign_s * xi
    # clamp contact point onto the ref surface region (points stay on incident
    # plane; pulling them to the face plane changes little for shallow pen)
    return pts, depth


def _edge_candidate(h_a, h_b, r, t, axis_pair, normal_a):
    """Edge-edge contact pair; axis_pair=(i,j), normal_a = unit axis in A
    frame pointing A->B. Returns points[2,3] in the A frame: the closest
    points of the two clamped edges, PLUS a second sample at the far end of
    the mutual overlap interval. For genuinely crossing edges the two
    coincide (one effective contact); for near-parallel edges they span the
    contact line — the 2-point manifold Bullet accumulates across frames
    from its persistent btPersistentManifold (sc_physics.cpp relies on
    Bullet's box-box edge handling)."""
    i, j = axis_pair[0], axis_pair[1]
    e_i = jax.nn.one_hot(i, 3)
    e_j_b = jax.nn.one_hot(j, 3)
    d_a = e_i
    d_b = jnp.einsum("ij,j->i", r, e_j_b, precision=m3.PRECISION)

    # corner of A's edge: maximize along +normal_a on axes != i
    sgn_a = jnp.sign(jnp.where(normal_a == 0, 1.0, normal_a))
    c_a = sgn_a * h_a * (1.0 - e_i)
    # corner of B's edge: maximize along -normal_a (in B frame) on axes != j
    n_b = jnp.einsum("ji,j->i", r, -normal_a, precision=m3.PRECISION)
    sgn_b = jnp.sign(jnp.where(n_b == 0, 1.0, n_b))
    c_b_local = sgn_b * h_b * (1.0 - e_j_b)
    c_b = jnp.einsum("ij,j->i", r, c_b_local, precision=m3.PRECISION) + t

    # closest points of the two infinite lines, clamped to edge extents
    he_a = jnp.sum(h_a * e_i)
    he_b = jnp.sum(h_b * e_j_b)
    r0 = c_b - c_a
    a = 1.0
    e = 1.0
    dot = lambda x, y: jnp.dot(x, y, precision=m3.PRECISION)
    b = dot(d_a, d_b)
    denom = jnp.maximum(a * e - b * b, 1e-9)
    s = jnp.clip((dot(d_a, r0) * e - b * dot(d_b, r0)) / denom, -he_a, he_a)
    u = jnp.clip((dot(d_a, r0) * b - a * dot(d_b, r0)) / denom, -he_b, he_b)
    p_a = c_a + d_a * s
    p_b = c_b + d_b * u
    p0 = 0.5 * (p_a + p_b)

    # second sample: B's edge endpoints projected onto A's edge give the
    # mutual overlap interval [s_lo, s_hi]; take whichever end is farther
    # from s (for crossing edges both collapse to s and p1 == p0)
    u_ends = jnp.asarray([-he_b, he_b])
    s_proj = dot(d_a, r0) + u_ends * b  # closest s for each B endpoint
    s_lo = jnp.clip(jnp.min(s_proj), -he_a, he_a)
    s_hi = jnp.clip(jnp.max(s_proj), -he_a, he_a)
    s2 = jnp.where(jnp.abs(s_hi - s) > jnp.abs(s_lo - s), s_hi, s_lo)
    u2 = jnp.clip(dot(d_b, (c_a + d_a * s2) - c_b), -he_b, he_b)
    p_a2 = c_a + d_a * s2
    p_b2 = c_b + d_b * u2
    p1 = 0.5 * (p_a2 + p_b2)
    # depth penalty of the second sample: how much farther apart the pair is
    # than the closest pair (zero for parallel or crossing edges)
    d0 = jnp.linalg.norm(p_a - p_b)
    d1 = jnp.linalg.norm(p_a2 - p_b2)
    return jnp.stack([p0, p1]), jnp.asarray([0.0, 1.0]) * (d1 - d0)


def box_box_contacts(pos_a, quat_a, h_a, pos_b, quat_b, h_b):
    """SAT manifold for one OBB pair.

    Returns (points[10,3] world, normals[10,3] world B->A, depth[10],
    valid[10]).
    """
    ra = m3.quat_to_mat3(quat_a)
    rb = m3.quat_to_mat3(quat_b)
    r = jnp.einsum("ji,jk->ik", ra, rb, precision=m3.PRECISION)  # B -> A rotation
    # B center in A frame
    t = jnp.einsum("ji,j->i", ra, pos_b - pos_a, precision=m3.PRECISION)

    absr = jnp.abs(r) + _EPS

    # --- face axes of A (A frame unit axes) ---
    # overlap_i = h_a_i + sum_j h_b_j |R_ij| - |t_i|
    proj_b_on_a = jnp.einsum("ij,j->i", absr, h_b, precision=m3.PRECISION)
    ov_face_a = h_a + proj_b_on_a - jnp.abs(t)  # [3]

    # --- face axes of B ---
    proj_a_on_b = jnp.einsum("ij,i->j", absr, h_a, precision=m3.PRECISION)
    t_b = jnp.einsum("ij,i->j", r, t, precision=m3.PRECISION)  # t in B frame = R^T t
    ov_face_b = h_b + proj_a_on_b - jnp.abs(t_b)  # [3]

    # --- edge axes cross(e_i, R e_j), 9 of them ---
    e_a = jnp.eye(3)
    axes = jnp.cross(e_a[:, None, :], r.T[None, :, :])  # [3,3,3] i,j
    axes_len = jnp.sqrt(jnp.maximum(jnp.sum(axes * axes, -1), _EPS * _EPS))
    axes_n = axes / axes_len[..., None]
    # projection of a box onto axis L = sum_k h_k |L_k| (each box's frame)
    proj_a = jnp.einsum("ijk,k->ij", jnp.abs(axes_n), h_a, precision=m3.PRECISION)
    # axis in B frame
    axes_in_b = jnp.einsum("lk,ijl->ijk", r, axes_n, precision=m3.PRECISION)
    proj_b = jnp.einsum("ijk,k->ij", jnp.abs(axes_in_b), h_b, precision=m3.PRECISION)
    dist_e = jnp.abs(jnp.einsum("ijk,k->ij", axes_n, t, precision=m3.PRECISION))
    ov_edge = proj_a + proj_b - dist_e  # [3,3]
    degenerate = axes_len < 1e-4
    ov_edge = jnp.where(degenerate, jnp.inf, ov_edge)

    separated = (
        (jnp.min(ov_face_a) < 0.0)
        | (jnp.min(ov_face_b) < 0.0)
        | (jnp.min(ov_edge) < 0.0)
    )

    best_fa = jnp.argmin(ov_face_a)
    best_fb = jnp.argmin(ov_face_b)
    min_fa = ov_face_a[best_fa]
    min_fb = ov_face_b[best_fb]
    flat_e = ov_edge.reshape(-1)
    best_e = jnp.argmin(flat_e)
    min_e = flat_e[best_e]

    min_face = jnp.minimum(min_fa, min_fb)
    use_edge = min_e < min_face * _FACE_BIAS_REL - 1e-4
    use_face_b = (~use_edge) & (min_fb < min_fa * _FACE_BIAS_REL - 1e-4)
    use_face_a = (~use_edge) & (~use_face_b)

    # --- candidates: ref face on A ---
    sign_a = jnp.sign(jnp.where(t[best_fa] == 0, 1.0, t[best_fa]))
    pts_fa, dep_fa = _face_candidates(h_a, h_b, r, t, best_fa, sign_a)
    pts_fa_w = pos_a + jnp.einsum("ij,vj->vi", ra, pts_fa, precision=m3.PRECISION)
    n_fa_w = -(ra[:, best_fa] * sign_a)  # B->A world

    # --- candidates: ref face on B (roles swapped) ---
    r_t = r.T
    t2 = -jnp.einsum("ij,j->i", r_t, t, precision=m3.PRECISION)
    sign_b = jnp.sign(jnp.where(t2[best_fb] == 0, 1.0, t2[best_fb]))
    pts_fb, dep_fb = _face_candidates(h_b, h_a, r_t, t2, best_fb, sign_b)
    pts_fb_w = pos_b + jnp.einsum("ij,vj->vi", rb, pts_fb, precision=m3.PRECISION)
    n_fb_w = rb[:, best_fb] * sign_b  # outward from B toward A = B->A

    # --- candidate: edge-edge ---
    ei = best_e // 3
    ej = best_e % 3
    axis_e = axes_n[ei, ej]
    # orient axis from A toward B
    along = jnp.dot(axis_e, t, precision=m3.PRECISION)
    axis_e = axis_e * jnp.sign(jnp.where(along == 0, 1.0, along))
    pt_e, pen_e = _edge_candidate(h_a, h_b, r, t, jnp.stack([ei, ej]), axis_e)
    pt_e_w = pos_a + jnp.einsum("ij,vj->vi", ra, pt_e, precision=m3.PRECISION)  # [2,3]
    n_e_w = -jnp.einsum("ij,j->i", ra, axis_e, precision=m3.PRECISION)  # B->A
    dep_e = min_e - pen_e  # [2]

    points = jnp.concatenate([pts_fa_w, pts_fb_w, pt_e_w], axis=0)  # [10,3]
    normals = jnp.concatenate(
        [
            jnp.broadcast_to(n_fa_w, (4, 3)),
            jnp.broadcast_to(n_fb_w, (4, 3)),
            jnp.broadcast_to(n_e_w, (2, 3)),
        ],
        axis=0,
    )
    depths = jnp.concatenate([dep_fa, dep_fb, dep_e])
    case_mask = jnp.concatenate(
        [
            jnp.broadcast_to(use_face_a, (4,)),
            jnp.broadcast_to(use_face_b, (4,)),
            jnp.broadcast_to(use_edge, (2,)),
        ]
    )
    valid = case_mask & (depths > 0.0) & ~separated
    return points, normals, depths, valid

"""Narrowphase contact generation — fixed-capacity, fully vectorized.

Replaces Bullet's dispatcher/manifold machinery (reference wraps
btDiscreteDynamicsWorld, sc_physics.cpp:210-302) with a branch-free scheme
built for vmap:

  * every shape is canonicalized to BOX or CAPSULE (sphere == capsule with
    zero half-height), leaving 3 pair kinds: box-box, box-capsule,
    capsule-capsule;
  * each broadphase pair yields up to 10 candidate points (box-box face
    clips both ways + edge pair; clipped segment probes otherwise), reduced
    to the 4 deepest (Bullet's manifold cap is 4 points too);
  * contact normal points from body B toward body A; depth >= 0 means
    penetration.

Friction combines multiplicatively and restitution multiplicatively,
matching Bullet's combiner defaults.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from scx.core import struct

from scx.core import math3d as m3
from scx.physics.boxbox import box_box_contacts
from scx.physics.rigid import RigidBodies, SHAPE_BOX, SHAPE_SPHERE, SHAPE_CAPSULE

MAX_CONTACTS_PER_PAIR = 4
_N_CAND = 10


@struct.dataclass
class Contacts:
    """Flat contact list [C]: C = max_pairs * MAX_CONTACTS_PER_PAIR."""

    ia: jax.Array       # [C] i32 body A
    ib: jax.Array       # [C] i32 body B
    point: jax.Array    # [C,3] world contact point
    normal: jax.Array   # [C,3] world normal, B -> A
    depth: jax.Array    # [C] penetration depth (>=0)
    valid: jax.Array    # [C] bool
    friction: jax.Array     # [C] combined
    restitution: jax.Array  # [C] combined
    cand: jax.Array     # [C] i32 candidate slot within the pair (warm-start key)
    trigger_overlap: jax.Array  # [C] bool — overlapping but trigger-flagged
                                # (reported, never solved; sc_physics.cpp:372-379)


def trigger_overlap_mask(contacts: "Contacts", n: int):
    """Per-body trigger-event mask [N]: True where a body participates in a
    trigger overlap this step (the gameplay-facing event surface)."""
    m = jnp.zeros((n,), jnp.int32)
    ev = contacts.trigger_overlap.astype(jnp.int32)
    m = m.at[contacts.ia].max(ev, mode="drop")
    m = m.at[contacts.ib].max(ev, mode="drop")
    return m > 0


def _box_sdf_local(p, h):
    """Signed distance + outward normal of point p to box with half-extents h
    (box local frame). Negative distance = inside."""
    q = jnp.abs(p) - h
    outside = jnp.maximum(q, 0.0)
    dist_out = m3.norm(outside)
    max_q = jnp.max(q, axis=-1)
    dist = jnp.where(max_q > 0.0, dist_out, max_q)
    # normal: outside -> normalized positive part; inside -> axis of max q
    n_out = m3.safe_normalize(outside)
    axis = jnp.argmax(q, axis=-1)
    n_in = jax.nn.one_hot(axis, 3, dtype=p.dtype)
    n_local = jnp.where((max_q > 0.0)[..., None], n_out, n_in) * jnp.sign(
        jnp.where(p == 0.0, 1.0, jnp.sign(p))
    )
    return dist, n_local


def _to_local(q, pos, p):
    return m3.quat_rotate(m3.quat_conj(q), p - pos)


def _from_local_dir(q, d):
    return m3.quat_rotate(q, d)


def _segment_of_capsule(pos, quat, size):
    """Capsule core segment endpoints (world). size=(radius, half_height,_)."""
    axis = m3.quat_rotate(quat, jnp.asarray([0.0, 1.0, 0.0]))
    hh = size[1]
    return pos - axis * hh, pos + axis * hh


def _closest_pt_segment(a0, a1, p):
    d = a1 - a0
    t = jnp.clip(
        m3.dot(p - a0, d) / jnp.maximum(m3.dot(d, d), 1e-9), 0.0, 1.0
    )
    return a0 + d * t


def _closest_segment_segment(p0, p1, q0, q1):
    """Closest points between segments (standard clamped algorithm)."""
    d1 = p1 - p0
    d2 = q1 - q0
    r = p0 - q0
    a = m3.dot(d1, d1)
    e = m3.dot(d2, d2)
    f = m3.dot(d2, r)
    c = m3.dot(d1, r)
    b = m3.dot(d1, d2)
    denom = a * e - b * b
    s = jnp.where(denom > 1e-9, jnp.clip((b * f - c * e) / jnp.maximum(denom, 1e-9), 0.0, 1.0), 0.0)
    t = jnp.where(e > 1e-9, jnp.clip((b * s + f) / jnp.maximum(e, 1e-9), 0.0, 1.0), 0.0)
    # re-clamp s for clamped t
    s = jnp.where(a > 1e-9, jnp.clip((b * t - c) / jnp.maximum(a, 1e-9), 0.0, 1.0), 0.0)
    return p0 + d1 * s, q0 + d2 * t


def _capsule_capsule(pos_a, quat_a, size_a, pos_b, quat_b, size_b):
    a0, a1 = _segment_of_capsule(pos_a, quat_a, size_a)
    b0, b1 = _segment_of_capsule(pos_b, quat_b, size_b)
    pa, pb = _closest_segment_segment(a0, a1, b0, b1)
    delta = pa - pb
    dist = m3.norm(delta)
    ra, rb = size_a[0], size_b[0]
    depth = ra + rb - dist
    n = m3.safe_normalize(delta, jnp.asarray([0.0, 1.0, 0.0]))
    point = pb + n * rb  # surface of B
    return point, n, depth, depth > 0.0


def _sphere_box(center, radius, pos_b, quat_b, h_b):
    """Sphere (world center) vs OBB: single candidate."""
    local = _to_local(quat_b, pos_b, center)
    dist, n_local = _box_sdf_local(local, h_b)
    n_world = _from_local_dir(quat_b, n_local)
    depth = radius - dist
    point = center - n_world * jnp.minimum(dist, radius)
    return point, n_world, depth, depth > 0.0


def _capsule_box(pos_a, quat_a, size_a, pos_b, quat_b, h_b):
    """Capsule A vs box B: 5 sphere probes — the two segment endpoints, the
    point closest to the box center, and the two ends of the segment CLIPPED
    to the radius-expanded box slabs. The clipped pair gives the proper
    2-point manifold for a capsule lying across a box face (segment-face
    clipping; Bullet reaches the same via its GJK manifold accumulation)."""
    a0, a1 = _segment_of_capsule(pos_a, quat_a, size_a)
    r = size_a[0]
    mid = _closest_pt_segment(a0, a1, pos_b)

    # clip the segment (box local frame) to the expanded slabs |x_k| <= h+r
    l0 = _to_local(quat_b, pos_b, a0)
    l1 = _to_local(quat_b, pos_b, a1)
    d = l1 - l0
    lim = h_b + r
    safe_d = jnp.where(jnp.abs(d) < 1e-9, 1e-9, d)
    ta = (-lim - l0) / safe_d
    tb = (lim - l0) / safe_d
    t0 = jnp.clip(jnp.max(jnp.minimum(ta, tb)), 0.0, 1.0)
    t1 = jnp.clip(jnp.min(jnp.maximum(ta, tb)), 0.0, 1.0)
    c0 = a0 + (a1 - a0) * t0
    c1 = a0 + (a1 - a0) * t1

    pts = jnp.stack([a0, a1, mid, c0, c1])
    p, n, dep, v = jax.vmap(lambda c: _sphere_box(c, r, pos_b, quat_b, h_b))(pts)
    # degenerate capsule (a sphere): all probes coincide with mid — keep only mid
    is_sphere = size_a[1] <= 1e-5
    keep = jnp.asarray([False, False, True, False, False])
    v = v & jnp.where(is_sphere, keep, jnp.ones((5,), bool))
    return p, n, dep, v


def _pair_candidates(pos_a, quat_a, shape_a, size_a, pos_b, quat_b, shape_b, size_b):
    """All candidate contacts for one pair; returns [_N_CAND] records with
    normals pointing B -> A."""
    # canonical sizes
    h_a, h_b = size_a, size_b
    cap_a = jnp.where(shape_a == SHAPE_SPHERE, size_a.at[1].set(0.0), size_a)
    cap_b = jnp.where(shape_b == SHAPE_SPHERE, size_b.at[1].set(0.0), size_b)
    is_box_a = shape_a == SHAPE_BOX
    is_box_b = shape_b == SHAPE_BOX

    z3 = jnp.zeros((_N_CAND, 3))
    pt = z3
    nm = z3
    dp = jnp.full((_N_CAND,), -1.0)
    vd = jnp.zeros((_N_CAND,), bool)

    # box-box: SAT manifold (scx.physics.boxbox)
    bb_pt, bb_nm, bb_dp, bb_vd = box_box_contacts(
        pos_a, quat_a, h_a, pos_b, quat_b, h_b
    )

    # capsule-capsule (single)
    cc_pt, cc_nm, cc_dp, cc_vd = _capsule_capsule(
        pos_a, quat_a, cap_a, pos_b, quat_b, cap_b
    )

    # box(B) - capsule(A): probes give normal out of box B = B->A
    cbx_p, cbx_n, cbx_d, cbx_v = _capsule_box(pos_a, quat_a, cap_a, pos_b, quat_b, h_b)
    # box(A) - capsule(B): flip normal to keep B->A
    bxc_p, bxc_n, bxc_d, bxc_v = _capsule_box(pos_b, quat_b, cap_b, pos_a, quat_a, h_a)
    bxc_n = -bxc_n

    def put(pt, nm, dp, vd, new_p, new_n, new_d, new_v):
        k = new_d.shape[0]
        return (
            pt.at[:k].set(new_p),
            nm.at[:k].set(new_n),
            dp.at[:k].set(new_d),
            vd.at[:k].set(new_v),
        )

    # select by pair kind
    bb = is_box_a & is_box_b
    cc = (~is_box_a) & (~is_box_b)
    a_cap_b_box = (~is_box_a) & is_box_b
    a_box_b_cap = is_box_a & (~is_box_b)

    # build each variant at full capacity then select
    v_bb = put(pt, nm, dp, vd, bb_pt, bb_nm, bb_dp, bb_vd)
    v_cc = put(pt, nm, dp, vd, cc_pt[None], cc_nm[None], cc_dp[None], cc_vd[None])
    v_cb = put(pt, nm, dp, vd, cbx_p, cbx_n, cbx_d, cbx_v)
    v_bc = put(pt, nm, dp, vd, bxc_p, bxc_n, bxc_d, bxc_v)

    def sel(i):
        return jnp.where(
            bb,
            v_bb[i],
            jnp.where(cc, v_cc[i], jnp.where(a_cap_b_box, v_cb[i], v_bc[i])),
        )

    del a_box_b_cap
    return sel(0), sel(1), sel(2), sel(3)


def generate_contacts(
    bodies: RigidBodies, ia, ib, pair_valid, max_contacts_per_pair: int = MAX_CONTACTS_PER_PAIR
) -> Contacts:
    """Contacts for each broadphase pair, top-K deepest per pair, flattened."""
    from scx.physics.rigid import shape_centers

    # one packed row per body — each endpoint costs ONE gathered row
    # instead of eight element gathers
    centers = shape_centers(bodies)
    rows = jnp.concatenate(
        [
            centers,
            bodies.quat,
            bodies.shape.astype(jnp.float32)[:, None],
            bodies.size,
            bodies.friction[:, None],
            bodies.restitution[:, None],
            bodies.trigger.astype(jnp.float32)[:, None],
        ],
        axis=-1,
    )  # [N, 3+4+1+3+1+1+1]
    ra, rb = rows[ia], rows[ib]

    def unpack(r):
        return r[:, 0:3], r[:, 3:7], r[:, 7].astype(jnp.int32), r[:, 8:11]

    pt, nm, dp, vd = jax.vmap(_pair_candidates)(
        *unpack(ra), *unpack(rb)
    )  # [P,_N_CAND,...]

    vd = vd & pair_valid[:, None]
    score = jnp.where(vd, dp, -jnp.inf)
    k = max_contacts_per_pair
    top_score, top_idx = jax.lax.top_k(score, k)  # [P,k]
    take = jax.vmap(lambda a, i: a[i])
    point = take(pt, top_idx)
    normal = take(nm, top_idx)
    depth = take(dp, top_idx)
    valid = jnp.isfinite(top_score) & (top_score > 0.0)

    p = ia.shape[0]
    flat = lambda x: x.reshape((p * k,) + x.shape[2:])
    ia_f = jnp.repeat(ia, k)
    ib_f = jnp.repeat(ib, k)
    # multiplicative combiners from the already-gathered rows (cols 11, 12)
    fr = jnp.repeat(ra[:, 11] * rb[:, 11], k)
    re = jnp.repeat(ra[:, 12] * rb[:, 12], k)
    # trigger pairs: overlap is an event, not a constraint (col 13)
    is_trigger = jnp.repeat((ra[:, 13] > 0.0) | (rb[:, 13] > 0.0), k)
    valid_f = flat(valid)
    return Contacts(
        ia=ia_f,
        ib=ib_f,
        point=flat(point),
        normal=flat(normal),
        depth=flat(depth),
        valid=valid_f & ~is_trigger,
        friction=fr,
        restitution=re,
        cand=flat(top_idx).astype(jnp.int32),
        trigger_overlap=valid_f & is_trigger,
    )

"""Scene queries: raycast and swept-sphere, fully vectorized.

Mirrors the reference's PhysicsWorld::raycast / sweepCapsule surface
(reference: sc_physics.cpp:740-810): closest hit over all bodies with
layer/mask filtering and an optional excluded body (the caster itself).

Implementation is brute-force over the body arrays — for N <= a few hundred
bodies this is one fused VPU pass and beats any tree. Rays broadcast, so
vmapping a [R,3] bundle of rays costs one pass too (traffic sensors cast all
their rays at once).

Shape note: all per-body math runs in COLUMN form — [N] arrays per
x/y/z component instead of [N,3] vectors.  A trailing dim of 3 makes
every access a strided one, and under the outer vmaps that stack here
(wheel x vehicle x env) that cost multiplies.  With columns the body axis
is the minor axis.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from scx.core import struct

from scx.core import math3d as m3
from scx.physics.rigid import RigidBodies, SHAPE_BOX, SHAPE_SPHERE, SHAPE_CAPSULE

_BIG = 1e30


@struct.dataclass
class RayHit:
    hit: jax.Array     # [] bool
    t: jax.Array       # [] f32 distance along ray
    body: jax.Array    # [] i32 body index (-1 if none)
    point: jax.Array   # [3]
    normal: jax.Array  # [3]


def _rot_cols(qw, qx, qy, qz, vx, vy, vz):
    """Rotate column vectors (vx,vy,vz) by quaternions (w,x,y,z) —
    v' = v + w*t + q.xyz x t with t = 2 (q.xyz x v), all scalar columns."""
    tx = 2.0 * (qy * vz - qz * vy)
    ty = 2.0 * (qz * vx - qx * vz)
    tz = 2.0 * (qx * vy - qy * vx)
    rx = vx + qw * tx + (qy * tz - qz * ty)
    ry = vy + qw * ty + (qz * tx - qx * tz)
    rz = vz + qw * tz + (qx * ty - qy * tx)
    return rx, ry, rz


def _ray_sphere_cols(ox, oy, oz, dx, dy, dz, cx, cy, cz, r):
    """Columns: ray vs sphere centers; returns (t, nx, ny, nz)."""
    ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
    b = ocx * dx + ocy * dy + ocz * dz
    c = ocx * ocx + ocy * ocy + ocz * ocz - r * r
    disc = b * b - c
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    t = -b - sq
    hit = (disc >= 0.0) & (t >= 0.0)
    t = jnp.where(hit, t, _BIG)
    px, py, pz = ox + dx * t - cx, oy + dy * t - cy, oz + dz * t - cz
    inv = 1.0 / jnp.sqrt(jnp.maximum(px * px + py * py + pz * pz, 1e-12))
    return t, px * inv, py * inv, pz * inv


def _safe_inv(d):
    return 1.0 / jnp.where(jnp.abs(d) < 1e-9, jnp.where(d < 0, -1e-9, 1e-9), d)


def _ray_box_local_cols(ox, oy, oz, dx, dy, dz, hx, hy, hz):
    """Slab test in box local frames; returns (t, local normal columns)."""
    ix, iy, iz = _safe_inv(dx), _safe_inv(dy), _safe_inv(dz)
    t1x, t2x = (-hx - ox) * ix, (hx - ox) * ix
    t1y, t2y = (-hy - oy) * iy, (hy - oy) * iy
    t1z, t2z = (-hz - oz) * iz, (hz - oz) * iz
    tminx, tmaxx = jnp.minimum(t1x, t2x), jnp.maximum(t1x, t2x)
    tminy, tmaxy = jnp.minimum(t1y, t2y), jnp.maximum(t1y, t2y)
    tminz, tmaxz = jnp.minimum(t1z, t2z), jnp.maximum(t1z, t2z)
    tmin = jnp.maximum(tminx, jnp.maximum(tminy, tminz))
    tmax = jnp.minimum(tmaxx, jnp.minimum(tmaxy, tmaxz))
    hit = tmax >= jnp.maximum(tmin, 0.0)
    t = jnp.where(tmin >= 0.0, tmin, tmax)  # inside the box -> exit point
    t = jnp.where(hit, t, _BIG)
    # entry axis = the slab achieving tmin (x wins ties like argmax did)
    on_x = tminx == tmin
    on_y = ~on_x & (tminy == tmin)
    on_z = ~on_x & ~on_y
    nx = jnp.where(on_x, -jnp.sign(dx), 0.0)
    ny = jnp.where(on_y, -jnp.sign(dy), 0.0)
    nz = jnp.where(on_z, -jnp.sign(dz), 0.0)
    return t, nx, ny, nz


def _ray_capsule_local_cols(ox, oy, oz, dx, dy, dz, r, hh):
    """Ray vs Y-axis capsules in local frames: cylinder quadratic + cap
    spheres; returns (t, local normal columns)."""
    a = dx * dx + dz * dz
    b = ox * dx + oz * dz
    c = ox * ox + oz * oz - r * r
    disc = b * b - a * c
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    t_cyl = (-b - sq) / jnp.where(jnp.abs(a) < 1e-12, 1e-12, a)
    y_at = oy + t_cyl * dy
    cyl_ok = (disc >= 0.0) & (t_cyl >= 0.0) & (jnp.abs(y_at) <= hh) & (a > 1e-12)
    t_cyl = jnp.where(cyl_ok, t_cyl, _BIG)
    cnx, cnz = ox + dx * t_cyl, oz + dz * t_cyl
    inv = 1.0 / jnp.sqrt(jnp.maximum(cnx * cnx + cnz * cnz, 1e-12))
    n_cyl = (cnx * inv, jnp.zeros_like(cnx), cnz * inv)

    zero = jnp.zeros_like(oy)
    t_top, tnx, tny, tnz = _ray_sphere_cols(
        ox, oy, oz, dx, dy, dz, zero, zero + hh, zero, r
    )
    t_bot, bnx, bny, bnz = _ray_sphere_cols(
        ox, oy, oz, dx, dy, dz, zero, zero - hh, zero, r
    )
    t, (nx, ny, nz) = t_cyl, n_cyl
    better = t_top < t
    nx, ny, nz = (
        jnp.where(better, tnx, nx),
        jnp.where(better, tny, ny),
        jnp.where(better, tnz, nz),
    )
    t = jnp.where(better, t_top, t)
    better = t_bot < t
    nx, ny, nz = (
        jnp.where(better, bnx, nx),
        jnp.where(better, bny, ny),
        jnp.where(better, bnz, nz),
    )
    t = jnp.where(better, t_bot, t)
    return t, nx, ny, nz


def raycast(
    bodies: RigidBodies,
    origin,
    direction,
    max_t,
    query_mask: int | jax.Array = 0xFFFFFFFF,
    exclude: int | jax.Array = -1,
    inflate: float = 0.0,
) -> RayHit:
    """Closest-hit raycast against every active body.

    query_mask filters by body layer ((layer & query_mask) != 0); `exclude`
    skips one body index (the caster). `inflate` turns this into a
    swept-sphere of that radius (sphere_cast).
    """
    o = jnp.asarray(origin, jnp.float32)
    d = m3.normalize(jnp.asarray(direction, jnp.float32))

    from scx.physics.rigid import shape_centers

    centers = shape_centers(bodies)
    cx, cy, cz = centers[:, 0], centers[:, 1], centers[:, 2]
    qw, qx, qy, qz = (
        bodies.quat[:, 0], bodies.quat[:, 1], bodies.quat[:, 2], bodies.quat[:, 3]
    )
    sx, sy, sz = bodies.size[:, 0], bodies.size[:, 1], bodies.size[:, 2]

    # ray into each body's local frame (conjugate rotation = negate q.xyz)
    olx, oly, olz = _rot_cols(qw, -qx, -qy, -qz, o[0] - cx, o[1] - cy, o[2] - cz)
    dlx, dly, dlz = _rot_cols(
        qw, -qx, -qy, -qz,
        jnp.broadcast_to(d[0], cx.shape),
        jnp.broadcast_to(d[1], cx.shape),
        jnp.broadcast_to(d[2], cx.shape),
    )

    t_box, bnx, bny, bnz = _ray_box_local_cols(
        olx, oly, olz, dlx, dly, dlz, sx + inflate, sy + inflate, sz + inflate
    )
    t_cap, knx, kny, knz = _ray_capsule_local_cols(
        olx, oly, olz, dlx, dly, dlz, sx + inflate, sy
    )
    t_sph, snx, sny, snz = _ray_sphere_cols(
        jnp.broadcast_to(o[0], cx.shape),
        jnp.broadcast_to(o[1], cx.shape),
        jnp.broadcast_to(o[2], cx.shape),
        d[0], d[1], d[2], cx, cy, cz, sx + inflate,
    )

    is_box = bodies.shape == SHAPE_BOX
    is_sph = bodies.shape == SHAPE_SPHERE
    t = jnp.where(is_box, t_box, jnp.where(is_sph, t_sph, t_cap))
    # box/capsule normals are local -> rotate to world; sphere already world
    lnx = jnp.where(is_box, bnx, knx)
    lny = jnp.where(is_box, bny, kny)
    lnz = jnp.where(is_box, bnz, knz)
    wnx, wny, wnz = _rot_cols(qw, qx, qy, qz, lnx, lny, lnz)
    nx = jnp.where(is_sph, snx, wnx)
    ny = jnp.where(is_sph, sny, wny)
    nz = jnp.where(is_sph, snz, wnz)

    qm = jnp.asarray(query_mask, jnp.uint32)
    ok = (
        bodies.active
        & ((bodies.layer & qm) != 0)
        & (jnp.arange(bodies.n) != exclude)
        & (t <= max_t)
    )
    t = jnp.where(ok, t, _BIG)
    idx = jnp.argmin(t)
    best_t = t[idx]
    hit = best_t < _BIG
    return RayHit(
        hit=hit,
        t=jnp.where(hit, best_t, max_t),
        body=jnp.where(hit, idx.astype(jnp.int32), -1),
        point=o + d * jnp.where(hit, best_t, max_t),
        normal=jnp.where(
            hit,
            jnp.stack([nx[idx], ny[idx], nz[idx]]),
            jnp.asarray([0.0, 1.0, 0.0]),
        ),
    )


def sphere_cast(bodies, origin, direction, max_t, radius, **kw) -> RayHit:
    """Swept sphere = raycast against Minkowski-inflated shapes
    (box corners squared off — the reference's capsule sweep is similarly
    approximate for its use cases: camera occlusion, character probes)."""
    return raycast(bodies, origin, direction, max_t, inflate=radius, **kw)


def capsule_cast(
    bodies,
    origin,
    axis,
    half_height,
    radius,
    direction,
    max_t,
    stations: int = 5,
    **kw,
) -> RayHit:
    """Swept capsule — PhysicsWorld::sweepCapsule parity
    (sc_physics.cpp:740-810: Bullet convexSweepTest of a btCapsuleShape).

    Fixed-shape approximation: `stations` parallel swept spheres along the
    capsule core segment (origin + axis*s, s in [-hh, hh]), closest hit
    wins. Exact for face hits and sphere-like contacts; worst-case error at
    a corner is half the station spacing. All stations cast in one vmapped
    column pass, so cost is `stations` fused passes, not a loop.
    """
    up = m3.safe_normalize(jnp.asarray(axis, jnp.float32), jnp.asarray([0.0, 1.0, 0.0]))
    o = jnp.asarray(origin, jnp.float32)
    s = jnp.linspace(-1.0, 1.0, stations) * half_height

    hits = jax.vmap(
        lambda si: raycast(bodies, o + up * si, direction, max_t, inflate=radius, **kw)
    )(s)
    t = jnp.where(hits.hit, hits.t, _BIG)
    best = jnp.argmin(t)
    pick = lambda x: jax.tree.map(lambda a: a[best], x)
    return RayHit(
        hit=jnp.any(hits.hit),
        t=hits.t[best],
        body=hits.body[best],
        point=pick(hits.point),
        normal=pick(hits.normal),
    )

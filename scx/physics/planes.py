"""Plane-form 3D math: vectors/quaternions as tuples of component planes.

Why this exists: the conventional [..., 3] vector layout gives every
materialized array a 3-wide minor dimension, which wastes most of each
memory transaction, and under a vmapped env batch the solver re-reads its
[E, C, 3] constants every iteration. Storing each COMPONENT as its own
plane ([N] per scene -> [E, N] under vmap) keeps every materialized array
dense; the formulas below are the same as scx.core.math3d, just written
per component.

V3/Q4 are NamedTuples (native pytrees) whose fields are same-shaped planes
of ANY shape — [N], [P], [K, P], scalars — so the helpers broadcast exactly
like jnp does. 3x3 matrices are nested 3-tuples of planes.

Everything here is elementwise; orientation-aware matmuls (one-hot
gathers/scatters) live with their callers in scx.physics.planar.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

EPS = 1e-6


class V3(NamedTuple):
    x: jnp.ndarray
    y: jnp.ndarray
    z: jnp.ndarray

    def __add__(self, o):
        if isinstance(o, V3):
            return V3(self.x + o.x, self.y + o.y, self.z + o.z)
        return V3(self.x + o, self.y + o, self.z + o)

    def __sub__(self, o):
        if isinstance(o, V3):
            return V3(self.x - o.x, self.y - o.y, self.z - o.z)
        return V3(self.x - o, self.y - o, self.z - o)

    def __mul__(self, s):
        if isinstance(s, V3):
            return V3(self.x * s.x, self.y * s.y, self.z * s.z)
        return V3(self.x * s, self.y * s, self.z * s)

    __rmul__ = __mul__

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)


class Q4(NamedTuple):
    w: jnp.ndarray
    x: jnp.ndarray
    y: jnp.ndarray
    z: jnp.ndarray


def v3(x, y, z) -> V3:
    return V3(jnp.asarray(x), jnp.asarray(y), jnp.asarray(z))


def vsplat(v, like) -> V3:
    """Constant (x,y,z) broadcast to the shape of `like` (a plane)."""
    return V3(
        jnp.full_like(like, v[0]),
        jnp.full_like(like, v[1]),
        jnp.full_like(like, v[2]),
    )


def vdot(a: V3, b: V3):
    return a.x * b.x + a.y * b.y + a.z * b.z


def vcross(a: V3, b: V3) -> V3:
    return V3(
        a.y * b.z - a.z * b.y,
        a.z * b.x - a.x * b.z,
        a.x * b.y - a.y * b.x,
    )


def vnorm(a: V3):
    return jnp.sqrt(jnp.maximum(vdot(a, a), 0.0))


def vnormalize(a: V3, eps=EPS) -> V3:
    n = jnp.maximum(vnorm(a), eps)
    return V3(a.x / n, a.y / n, a.z / n)


def vsafe_normalize(a: V3, fallback: V3 = None, eps=EPS) -> V3:
    n = vnorm(a)
    ok = n > eps
    d = jnp.where(ok, n, 1.0)
    unit = V3(a.x / d, a.y / d, a.z / d)
    if fallback is None:
        fallback = V3(
            jnp.zeros_like(a.x), jnp.zeros_like(a.y), jnp.zeros_like(a.z)
        )
    return vwhere(ok, unit, fallback)


def vwhere(m, a: V3, b: V3) -> V3:
    return V3(
        jnp.where(m, a.x, b.x), jnp.where(m, a.y, b.y), jnp.where(m, a.z, b.z)
    )


def vabs(a: V3) -> V3:
    return V3(jnp.abs(a.x), jnp.abs(a.y), jnp.abs(a.z))


def vmin(a: V3, b: V3) -> V3:
    return V3(
        jnp.minimum(a.x, b.x), jnp.minimum(a.y, b.y), jnp.minimum(a.z, b.z)
    )


def vmax(a: V3, b: V3) -> V3:
    return V3(
        jnp.maximum(a.x, b.x), jnp.maximum(a.y, b.y), jnp.maximum(a.z, b.z)
    )


def vclip(a: V3, lo: V3, hi: V3) -> V3:
    return V3(
        jnp.clip(a.x, lo.x, hi.x),
        jnp.clip(a.y, lo.y, hi.y),
        jnp.clip(a.z, lo.z, hi.z),
    )


def vhmax(a: V3):
    """max over the 3 components (elementwise over planes)."""
    return jnp.maximum(a.x, jnp.maximum(a.y, a.z))


def vhmin(a: V3):
    return jnp.minimum(a.x, jnp.minimum(a.y, a.z))


def vcomp(a: V3, i):
    """Component by TRACED index i in {0,1,2} (branch-free select)."""
    return jnp.where(i == 0, a.x, jnp.where(i == 1, a.y, a.z))


def vonehot(i, like) -> V3:
    """Unit axis e_i for traced index plane i (0/1/2)."""
    one = jnp.ones_like(like)
    zero = jnp.zeros_like(like)
    return V3(
        jnp.where(i == 0, one, zero),
        jnp.where(i == 1, one, zero),
        jnp.where(i == 2, one, zero),
    )


def vstack_py(vs):
    """[V3, ...] -> list usable in python loops (no jnp.stack — keeps planes)."""
    return list(vs)


# --- quaternions (w,x,y,z), formulas == scx.core.math3d -------------------

def qconj(q: Q4) -> Q4:
    return Q4(q.w, -q.x, -q.y, -q.z)


def qmul(a: Q4, b: Q4) -> Q4:
    return Q4(
        a.w * b.w - a.x * b.x - a.y * b.y - a.z * b.z,
        a.w * b.x + a.x * b.w + a.y * b.z - a.z * b.y,
        a.w * b.y - a.x * b.z + a.y * b.w + a.z * b.x,
        a.w * b.z + a.x * b.y - a.y * b.x + a.z * b.w,
    )


def qnormalize(q: Q4) -> Q4:
    n = jnp.maximum(
        jnp.sqrt(q.w * q.w + q.x * q.x + q.y * q.y + q.z * q.z), EPS
    )
    return Q4(q.w / n, q.x / n, q.y / n, q.z / n)


def qrot(q: Q4, v: V3) -> V3:
    """v + 2 w (qv x v) + 2 qv x (qv x v) — same as math3d.quat_rotate."""
    qv = V3(q.x, q.y, q.z)
    t = vcross(qv, v) * 2.0
    return v + t * q.w + vcross(qv, t)


def qrot_inv(q: Q4, v: V3) -> V3:
    return qrot(qconj(q), v)


def qintegrate(q: Q4, omega: V3, dt) -> Q4:
    """q += 0.5 (0, omega) * q dt, renormalized (math3d.quat_integrate)."""
    dq = qmul(Q4(jnp.zeros_like(omega.x), omega.x, omega.y, omega.z), q)
    return qnormalize(
        Q4(
            q.w + 0.5 * dq.w * dt,
            q.x + 0.5 * dq.x * dt,
            q.y + 0.5 * dq.y * dt,
            q.z + 0.5 * dq.z * dt,
        )
    )


def q_to_mat(q: Q4):
    """Rotation matrix as nested 3-tuples of planes: m[i][j]."""
    w, x, y, z = q.w, q.x, q.y, q.z
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return (
        (1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)),
        (2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)),
        (2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)),
    )


# --- 3x3 matrices as nested tuples of planes -------------------------------

def mvec(m, v: V3) -> V3:
    """m @ v (rows of m dotted with v)."""
    return V3(
        m[0][0] * v.x + m[0][1] * v.y + m[0][2] * v.z,
        m[1][0] * v.x + m[1][1] * v.y + m[1][2] * v.z,
        m[2][0] * v.x + m[2][1] * v.y + m[2][2] * v.z,
    )


def mtvec(m, v: V3) -> V3:
    """m^T @ v."""
    return V3(
        m[0][0] * v.x + m[1][0] * v.y + m[2][0] * v.z,
        m[0][1] * v.x + m[1][1] * v.y + m[2][1] * v.z,
        m[0][2] * v.x + m[1][2] * v.y + m[2][2] * v.z,
    )


def mtm(a, b):
    """a^T @ b (both nested tuples) -> nested tuple."""
    return tuple(
        tuple(
            a[0][i] * b[0][j] + a[1][i] * b[1][j] + a[2][i] * b[2][j]
            for j in range(3)
        )
        for i in range(3)
    )


def mT(m):
    return tuple(tuple(m[j][i] for j in range(3)) for i in range(3))


def mabs(m, eps=0.0):
    return tuple(tuple(jnp.abs(m[i][j]) + eps for j in range(3)) for i in range(3))


def mrow(m, i) -> V3:
    return V3(m[i][0], m[i][1], m[i][2])


def mcol(m, j) -> V3:
    return V3(m[0][j], m[1][j], m[2][j])


def mrow_dyn(m, i) -> V3:
    """Row by traced index plane i."""
    r0, r1, r2 = mrow(m, 0), mrow(m, 1), mrow(m, 2)
    return vwhere(i == 0, r0, vwhere(i == 1, r1, r2))


def mcol_dyn(m, j) -> V3:
    c0, c1, c2 = mcol(m, 0), mcol(m, 1), mcol(m, 2)
    return vwhere(j == 0, c0, vwhere(j == 1, c1, c2))

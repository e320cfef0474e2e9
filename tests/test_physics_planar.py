"""Planar (plane-layout) physics path vs the conventional per-scene path.

The planar path re-implements the identical formulas in component-plane
layout (scx/physics/planar.py); these tests pin exact agreement where the
math is discrete (broadphase pair lists, contact candidate selection,
warm-start keys) and tight numeric agreement for the solve/trajectories.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from scx import physics as ph
from scx.core import prng
from scx.physics import planar as pp
from scx.physics.broadphase import broadphase_pairs
from scx.physics.contacts import MAX_CONTACTS_PER_PAIR, generate_contacts
from scx.physics.solver import SolverParams, solve_velocity, step_bodies_cached
from scx.physics.warmstart import empty_contact_cache, gather_warm_impulses

K = MAX_CONTACTS_PER_PAIR


def mixed_scene(n=24, seed=7, with_caps=True):
    """Ground slab + random boxes/spheres/capsules, deterministic."""
    rng = np.random.default_rng(seed)
    pos = np.zeros((n, 3), np.float32)
    pos[:, 0] = rng.uniform(-4, 4, n)
    pos[:, 1] = rng.uniform(0.5, 4.0, n)
    pos[:, 2] = rng.uniform(-4, 4, n)
    pos[0] = [0.0, -0.55, 0.0]
    size = np.full((n, 3), 0.5, np.float32)
    size[0] = [8.0, 0.05, 8.0]
    shape = np.zeros((n,), np.int32)
    if with_caps:
        shape[1::3] = ph.rigid.SHAPE_SPHERE
        shape[2::3] = ph.rigid.SHAPE_CAPSULE
    body_type = np.full((n,), ph.rigid.BODY_DYNAMIC, np.int32)
    body_type[0] = ph.rigid.BODY_STATIC
    # random-ish orientations
    ang = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    from scx.core import math3d as m3

    quat = m3.quat_from_euler_xyz(
        jnp.asarray(ang[:, 0]), jnp.asarray(ang[:, 1]), jnp.asarray(ang[:, 2])
    )
    b = ph.make_bodies(
        jnp.asarray(pos),
        quat=quat,
        size=jnp.asarray(size),
        shape=jnp.asarray(shape),
        body_type=jnp.asarray(body_type),
        vel=jnp.asarray(rng.uniform(-1, 1, (n, 3)).astype(np.float32)),
    )
    return b


def stk3(v):
    return np.stack([np.asarray(v.x), np.asarray(v.y), np.asarray(v.z)], -1)


@pytest.mark.parametrize("with_caps", [False, True])
def test_broadphase_parity(with_caps):
    b = mixed_scene(with_caps=with_caps)
    p = pp.planar_from_rigid(b)
    ia, ib, val, n_cand = broadphase_pairs(b, 64)
    ia2, ib2, val2, n2 = pp.planar_broadphase(p, 64)
    np.testing.assert_array_equal(np.asarray(val), np.asarray(val2))
    np.testing.assert_array_equal(
        np.asarray(ia)[np.asarray(val)], np.asarray(ia2)[np.asarray(val2)]
    )
    np.testing.assert_array_equal(
        np.asarray(ib)[np.asarray(val)], np.asarray(ib2)[np.asarray(val2)]
    )
    assert int(n_cand) == int(n2)


def test_roundtrip_conversion():
    b = mixed_scene()
    b2 = pp.rigid_from_planar(pp.planar_from_rigid(b))
    for leaf1, leaf2 in zip(
        jax.tree_util.tree_leaves(b), jax.tree_util.tree_leaves(b2)
    ):
        np.testing.assert_array_equal(np.asarray(leaf1), np.asarray(leaf2))


@pytest.mark.parametrize("with_caps", [False, True])
def test_contacts_parity(with_caps):
    b = mixed_scene(with_caps=with_caps)
    p = pp.planar_from_rigid(b)
    params = SolverParams(max_pairs=64)
    ia, ib, val, _ = broadphase_pairs(b, params.max_pairs)
    con = generate_contacts(b, ia, ib, val)
    pcon = pp.planar_contacts(p, ia, ib, val)

    P = params.max_pairs
    # conventional: [P*K] pair-blocked; planar: [K, P]
    c_valid = np.asarray(con.valid).reshape(P, K).T
    np.testing.assert_array_equal(np.asarray(pcon.valid), c_valid)
    c_cand = np.asarray(con.cand).reshape(P, K).T
    c_depth = np.asarray(con.depth).reshape(P, K).T
    p_depth = np.asarray(pcon.depth)
    m = c_valid
    np.testing.assert_array_equal(np.asarray(pcon.cand)[m], c_cand[m])
    np.testing.assert_allclose(p_depth[m], c_depth[m], atol=1e-5)
    c_pt = np.asarray(con.point).reshape(P, K, 3).transpose(1, 0, 2)
    c_nm = np.asarray(con.normal).reshape(P, K, 3).transpose(1, 0, 2)
    np.testing.assert_allclose(stk3(pcon.point)[m], c_pt[m], atol=1e-4)
    np.testing.assert_allclose(stk3(pcon.normal)[m], c_nm[m], atol=1e-5)
    # trigger accounting matches
    c_trig = np.asarray(con.trigger_overlap).reshape(P, K).T
    np.testing.assert_array_equal(np.asarray(pcon.trigger_overlap), c_trig)


@pytest.mark.parametrize("with_caps", [False, True])
def test_solve_parity(with_caps):
    b = mixed_scene(with_caps=with_caps)
    p = pp.planar_from_rigid(b)
    params = SolverParams(max_pairs=64, iterations=6)
    ia, ib, val, _ = broadphase_pairs(b, params.max_pairs)
    con = generate_contacts(b, ia, ib, val)
    pcon = pp.planar_contacts(p, ia, ib, val)
    vel, omega, lam, cnt = solve_velocity(b, con, params)
    pvel, pomega, (ln, l1, l2), pcnt = pp.planar_solve(
        p, pcon, params, ia, ib
    )
    np.testing.assert_allclose(stk3(pvel), np.asarray(vel), atol=2e-4)
    np.testing.assert_allclose(stk3(pomega), np.asarray(omega), atol=2e-4)
    np.testing.assert_allclose(np.asarray(pcnt), np.asarray(cnt), atol=1e-5)
    P = params.max_pairs
    c_lam = np.asarray(lam).reshape(P, K, 3).transpose(1, 0, 2)
    m = np.asarray(pcon.valid)
    np.testing.assert_allclose(np.asarray(ln)[m], c_lam[..., 0][m], atol=2e-4)


@pytest.mark.parametrize("with_caps", [False, True])
def test_trajectory_parity(with_caps):
    """Warm-started multi-step trajectories stay together (identical
    formulas; only f32 reassociation differs). Rolling spheres/capsules
    amplify rounding chaos much faster than boxes, so the caps variant
    runs fewer steps and tolerates small contact-count drift."""
    steps = 6 if with_caps else 12
    b = mixed_scene(with_caps=with_caps)
    p = pp.planar_from_rigid(b)
    params = SolverParams(max_pairs=64, iterations=6)
    cache = empty_contact_cache(params.max_pairs)
    pcache = pp.empty_planar_cache(params.max_pairs)

    @jax.jit
    def run_conv(b, cache):
        def step(carry, _):
            b, c = carry
            b, c, st = step_bodies_cached(b, params, c)
            return (b, c), st["contacts"]
        return jax.lax.scan(step, (b, cache), None, length=steps)

    @jax.jit
    def run_planar(p, pc):
        def step(carry, _):
            p, c = carry
            p, c, st = pp.step_planar_cached(p, params, c)
            return (p, c), st["contacts"]
        return jax.lax.scan(step, (p, pc), None, length=steps)

    (b_f, _), n_conv = run_conv(b, cache)
    (p_f, _), n_planar = run_planar(p, pcache)
    if not with_caps:
        # box scenes: contact counts match step for step. Capsule scenes
        # have borderline (depth ~ 1e-7) probes whose validity flips even
        # between eager and jit runs of the SAME path, so counts are not a
        # meaningful comparison there — the position tolerance below is.
        np.testing.assert_array_equal(np.asarray(n_conv), np.asarray(n_planar))
    # caps: borderline-contact flips (see above) grow ~1 cm over 6 steps;
    # the strict pin is the box trajectory + the exact single-step suites
    np.testing.assert_allclose(
        stk3(p_f.pos), np.asarray(b_f.pos), atol=2e-2 if with_caps else 2e-3
    )
    q_f = np.stack(
        [np.asarray(p_f.quat.w), np.asarray(p_f.quat.x),
         np.asarray(p_f.quat.y), np.asarray(p_f.quat.z)], -1
    )
    np.testing.assert_allclose(
        q_f, np.asarray(b_f.quat), atol=2e-2 if with_caps else 2e-3
    )


def test_warmstart_parity():
    """Convert the conventional cache to planar form and compare the warm
    gather on IDENTICAL inputs (independent 2-step runs drift enough to
    flip near-tie candidate picks, which is not what this pins)."""
    b = mixed_scene()
    params = SolverParams(max_pairs=64, iterations=4)
    cache = empty_contact_cache(params.max_pairs)
    for _ in range(2):
        b, cache, _ = step_bodies_cached(b, params, cache)
    P = params.max_pairs
    pcache = pp.PlanarCache(
        key_a=cache.key_a,
        key_b=cache.key_b,
        cand=np.asarray(cache.cand).T,
        lam_n=np.asarray(cache.lam).reshape(P, K, 3)[..., 0].T,
        lam_1=np.asarray(cache.lam).reshape(P, K, 3)[..., 1].T,
        lam_2=np.asarray(cache.lam).reshape(P, K, 3)[..., 2].T,
    )
    p = pp.planar_from_rigid(b)
    ia, ib, val, _ = broadphase_pairs(b, params.max_pairs)
    con = generate_contacts(b, ia, ib, val)
    lam0 = gather_warm_impulses(cache, ia, ib, val, con.cand, b.n)
    pcon = pp.planar_contacts(p, ia, ib, val)
    m = np.asarray(pcon.valid)  # invalid slots tie-break differently
    np.testing.assert_array_equal(
        np.asarray(pcon.cand)[m], np.asarray(con.cand).reshape(P, K).T[m]
    )
    ln, l1, l2 = pp.planar_gather_warm(pcache, ia, ib, val, pcon.cand)
    c_lam0 = np.asarray(lam0).reshape(P, K, 3).transpose(1, 0, 2)
    np.testing.assert_allclose(np.asarray(ln)[m], c_lam0[..., 0][m], atol=1e-6)
    np.testing.assert_allclose(np.asarray(l1)[m], c_lam0[..., 1][m], atol=1e-6)
    np.testing.assert_allclose(np.asarray(l2)[m], c_lam0[..., 2][m], atol=1e-6)


def test_tower_stability_planar():
    """8-box tower holds under the production setting (6 warm iterations) —
    mirrors the conventional tower test."""
    n = 9
    pos = np.zeros((n, 3), np.float32)
    pos[0] = [0, -0.55, 0]
    for i in range(1, n):
        pos[i] = [0, 0.5 + (i - 1) * 1.001, 0]
    size = np.full((n, 3), 0.5, np.float32)
    size[0] = [8, 0.05, 8]
    bt = np.full((n,), ph.rigid.BODY_DYNAMIC, np.int32)
    bt[0] = ph.rigid.BODY_STATIC
    b = ph.make_bodies(
        jnp.asarray(pos), size=jnp.asarray(size), body_type=jnp.asarray(bt)
    )
    p = pp.planar_from_rigid(b)
    params = SolverParams(max_pairs=64, iterations=8)
    pcache = pp.empty_planar_cache(params.max_pairs)

    @jax.jit
    def run(p, pc):
        def step(carry, _):
            p, c = carry
            p, c, _ = pp.step_planar_cached(p, params, c)
            return (p, c), None
        return jax.lax.scan(step, (p, pc), None, length=300)[0]

    p_f, _ = run(p, pcache)
    ys = np.asarray(p_f.pos.y)[1:]
    # boxes fall 0.5 onto the slab and settle at centers 0, 1.001, ... —
    # same bound as the conventional 8-box tower test (test_physics_solver)
    want = np.arange(n - 1, dtype=np.float64)
    assert np.max(np.abs(ys - want)) < 0.3, ys
    lat = np.abs(np.stack([np.asarray(p_f.pos.x), np.asarray(p_f.pos.z)]))
    assert lat[:, 1:].max() < 0.25  # no lateral collapse


def test_vmapped_fleet_step():
    """The planar step vmaps over a fleet and matches per-scene results."""
    scenes = [mixed_scene(seed=s) for s in (3, 4)]
    params = SolverParams(max_pairs=64, iterations=4)
    ps = [pp.planar_from_rigid(b) for b in scenes]
    fleet = jax.tree.map(lambda *xs: jnp.stack(xs), *ps)
    caches = jax.tree.map(
        lambda x: jnp.broadcast_to(x, (2,) + x.shape),
        pp.empty_planar_cache(params.max_pairs),
    )
    stepped, _, _ = jax.vmap(
        lambda b, c: pp.step_planar_cached(b, params, c)
    )(fleet, caches)
    for i, p0 in enumerate(ps):
        single, _, _ = pp.step_planar_cached(
            p0, params, pp.empty_planar_cache(params.max_pairs)
        )
        np.testing.assert_allclose(
            np.asarray(stepped.pos.x[i]), np.asarray(single.pos.x), atol=1e-5
        )


def _fleet_sat_inputs(n_envs, pairs=128):
    """Stacked SAT operand planes for a mixed fleet: varied scenes so
    every pair-type branch (box/sphere/capsule x static/dynamic) and the
    invalid-pair tail are all exercised."""
    gas, gbs, pvs = [], [], []
    for e in range(n_envs):
        b = mixed_scene(seed=100 + e, with_caps=(e % 2 == 0))
        p = pp.planar_from_rigid(b)
        ia, ib, val, _ = pp.planar_broadphase(p, pairs)
        ga, gb, pvf = pp._sat_inputs(p, ia, ib, val)
        gas.append(ga)
        gbs.append(gb)
        pvs.append(pvf)
    return jnp.stack(gas), jnp.stack(gbs), jnp.stack(pvs)


def _assert_sat_outputs_agree(got, ref, min_live):
    """SAT output contract between two float graphs of the same formulas:
    they may only disagree about GRAZE contacts — |depth| ~ 1e-7 sites
    where float association lands the SAT depth on the other side of zero.
    A graze carries ~zero impulse; anything deeper must agree exactly in
    validity and candidate id."""
    assert len(ref) == len(got) == 12
    vr = np.asarray(ref[7]) > 0.5
    vg = np.asarray(got[7]) > 0.5
    dis = vr != vg
    if dis.any():
        graze = np.abs(np.where(vr, np.asarray(ref[6]), np.asarray(got[6])))
        assert graze[dis].max() < 1e-5, "non-graze validity disagreement"
    both = vr & vg
    assert both.sum() > min_live  # scene is live
    names = "ptx pty ptz nmx nmy nmz depth".split()
    for i, name in enumerate(names):
        np.testing.assert_allclose(
            np.asarray(got[i])[both], np.asarray(ref[i])[both],
            atol=5e-6, err_msg=name,
        )
    np.testing.assert_array_equal(
        np.asarray(got[8])[both], np.asarray(ref[8])[both],
        err_msg="cand id",
    )
    for i, name in ((9, "friction"), (10, "restitution"), (11, "trigger")):
        np.testing.assert_array_equal(
            np.asarray(got[i]), np.asarray(ref[i]), err_msg=name
        )


@pytest.mark.parametrize("n_envs", [8, 128])
def test_sat_fleet_vmap_matches_per_scene(n_envs):
    """The fleet narrowphase (vmapped SAT, the path every fleet step
    takes) matches the per-scene SAT of each env."""
    ga, gb, pvf = _fleet_sat_inputs(n_envs)
    fleet = jax.jit(jax.vmap(pp._sat_ref))(ga, gb, pvf)
    one = jax.jit(pp._sat_ref)
    per = [one(ga[e], gb[e], pvf[e]) for e in range(n_envs)]
    ref = tuple(jnp.stack([p[i] for p in per]) for i in range(12))
    _assert_sat_outputs_agree(fleet, ref, 50 if n_envs == 8 else 1000)


@pytest.mark.parametrize("n_envs", [8, 16])
def test_solve_fleet_vmap_matches_per_scene(n_envs):
    """The vmapped velocity solve matches the per-scene solve on a mixed
    fleet: velocities and accumulated impulses to f32-reassociation
    tolerance."""
    params = SolverParams(max_pairs=128, iterations=6)
    ps, cons, ias, ibs = [], [], [], []
    for e in range(n_envs):
        b = mixed_scene(seed=50 + e, with_caps=(e % 2 == 0))
        p = pp.planar_from_rigid(b)
        p = pp.planar_integrate_velocities(p, params.dt, params.gravity)
        ia, ib, val, _ = pp.planar_broadphase(p, params.max_pairs)
        ps.append(p)
        cons.append(pp.planar_contacts(p, ia, ib, val))
        ias.append(ia)
        ibs.append(ib)
    solve = lambda p, c, ia, ib: pp.planar_solve(p, c, params, ia, ib)
    stack = lambda xs: jax.tree.map(lambda *a: jnp.stack(a), *xs)
    vel, om, lam, _ = jax.jit(jax.vmap(solve))(
        stack(ps), stack(cons), jnp.stack(ias), jnp.stack(ibs)
    )
    one = jax.jit(solve)
    for e in range(n_envs):
        v1, o1, l1, _ = one(ps[e], cons[e], ias[e], ibs[e])
        for a, r in ((vel, v1), (om, o1)):
            np.testing.assert_allclose(
                stk3(jax.tree.map(lambda x: x[e], a)), stk3(r), atol=2e-5
            )
        for k in range(3):
            np.testing.assert_allclose(
                np.asarray(lam[k][e]), np.asarray(l1[k]), atol=2e-5
            )


def test_shape_kinds_box_specialization_matches():
    """SolverParams(shape_kinds=('box',)) on a box-only scene produces
    IDENTICAL contacts and trajectories to the general narrowphase (the
    dropped generators never fire on box-only scenes) — per scene and
    across a vmapped fleet."""
    b = mixed_scene(with_caps=False)  # boxes only
    p = pp.planar_from_rigid(b)
    params = SolverParams(max_pairs=64, iterations=4)
    ia, ib, val, _ = pp.planar_broadphase(p, params.max_pairs)
    con_gen = pp.planar_contacts(p, ia, ib, val)
    con_box = pp.planar_contacts(p, ia, ib, val, kinds=("box",))
    m = np.asarray(con_gen.valid) & np.asarray(con_box.valid)
    assert m.sum() > 20
    np.testing.assert_array_equal(
        np.asarray(con_gen.cand)[m], np.asarray(con_box.cand)[m]
    )
    for name in ("friction", "restitution"):
        np.testing.assert_array_equal(
            np.asarray(getattr(con_gen, name)),
            np.asarray(getattr(con_box, name)), err_msg=name,
        )
    np.testing.assert_allclose(
        np.asarray(con_gen.depth)[m], np.asarray(con_box.depth)[m],
        atol=5e-6,
    )
    np.testing.assert_allclose(
        np.asarray(con_gen.point.x)[m], np.asarray(con_box.point.x)[m],
        atol=5e-6,
    )

    # fleet path: box hint == general on 8 vmapped box envs
    gas, gbs, pvs = [], [], []
    for e in range(8):
        bb = mixed_scene(seed=200 + e, with_caps=False)
        pb = pp.planar_from_rigid(bb)
        i2, j2, v2, _ = pp.planar_broadphase(pb, 128)
        ga, gb_, pvf = pp._sat_inputs(pb, i2, j2, v2)
        gas.append(ga); gbs.append(gb_); pvs.append(pvf)
    ga, gb_, pvf = jnp.stack(gas), jnp.stack(gbs), jnp.stack(pvs)
    out_g = jax.jit(jax.vmap(pp._sat_ref))(ga, gb_, pvf)
    out_b = jax.jit(jax.vmap(lambda *a: pp._sat_ref(*a, kinds=("box",))))(
        ga, gb_, pvf
    )
    # the two graphs compile with different fusion/FMA choices, so float
    # planes carry ~1e-6 drift; graze-depth validity flips are the only
    # permitted discrete divergence
    _assert_sat_outputs_agree(out_b, out_g, 200)

    # trajectories with the params-level hint stay together (graph-level
    # FMA drift only)
    c0 = pp.empty_planar_cache(params.max_pairs)
    pk = params.replace(shape_kinds=("box",))
    sg, sb = p, p
    cg, cb = c0, c0
    for _ in range(5):
        sg, cg, _ = pp.step_planar_cached(sg, params, cg)
        sb, cb, _ = pp.step_planar_cached(sb, pk, cb)
    np.testing.assert_allclose(
        np.asarray(sg.pos.y), np.asarray(sb.pos.y), atol=1e-4
    )


# ---------------------------------------------------------------------------
# fused middle (contacts + warm + solve in one dispatchable unit)
# ---------------------------------------------------------------------------

def _staged_step(b, params, cache, key_id=None):
    """The pre-fusion staged step, kept as the equivalence reference for
    the fused middle (same stage functions step_planar_cached used before
    the fusion; the fused primal must reproduce it)."""
    b = pp.planar_integrate_velocities(b, params.dt, params.gravity)
    ia, ib, val, n_cand = pp.planar_broadphase(b, params.max_pairs)
    con = pp.planar_contacts(b, ia, ib, val, params.shape_kinds)
    lam0 = pp.planar_gather_warm(cache, ia, ib, val, con.cand, key_id)
    vel, om, (ln, l1, l2), cnt = pp.planar_solve(b, con, params, ia, ib, lam0)
    dyn = (b.inv_mass > 0) & b.active
    low = (pp.pl.vdot(vel, vel) < params.sleep_lin**2) & (
        pp.pl.vdot(om, om) < params.sleep_ang**2
    )
    timer = jnp.where(dyn & low, b.sleep_timer + params.dt, 0.0)
    asleep = (timer > params.sleep_time) & (cnt > 0)
    zero = jnp.zeros_like(vel.x)
    vel = pp.pl.vwhere(asleep, pp.V3(zero, zero, zero), vel)
    om = pp.pl.vwhere(asleep, pp.V3(zero, zero, zero), om)
    b = b.replace(vel=vel, omega=om, sleep_timer=timer)
    cache = pp.planar_store(cache, ia, ib, val, con, ln, l1, l2, key_id)
    return pp.planar_integrate_positions(b, params.dt), cache


@pytest.mark.parametrize("with_caps", [False, True])
def test_fused_step_matches_staged(with_caps):
    """step_planar_cached (fused middle primal) reproduces the staged
    stage-function composition over a 40-step settling trajectory,
    including the warm-start cache contents."""
    params = SolverParams(max_pairs=128, iterations=6)
    b = pp.planar_from_rigid(mixed_scene(seed=11, with_caps=with_caps))
    cf = pp.empty_planar_cache(params.max_pairs)
    cs = pp.empty_planar_cache(params.max_pairs)
    bf, bs = b, b
    for i in range(40):
        bf, cf, _ = pp.step_planar_cached(bf, params, cf)
        bs, cs = _staged_step(bs, params, cs)
    np.testing.assert_allclose(
        np.asarray(bf.pos.y), np.asarray(bs.pos.y), atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(bf.vel.x), np.asarray(bs.vel.x), atol=1e-5
    )
    np.testing.assert_array_equal(
        np.asarray(cf.key_a), np.asarray(cs.key_a)
    )
    np.testing.assert_array_equal(
        np.asarray(cf.cand), np.asarray(cs.cand)
    )
    np.testing.assert_allclose(
        np.asarray(cf.lam_n), np.asarray(cs.lam_n), atol=1e-4
    )


def _warm_middle_args(n_envs, params):
    """Fleet operands of the fused middle after two warm-up steps, so the
    warm-gather path is live."""
    fleet = jax.tree.map(
        lambda *xs: jnp.stack(xs),
        *[pp.planar_from_rigid(mixed_scene(seed=90 + e, with_caps=(e % 2 == 0)))
          for e in range(n_envs)],
    )
    cache = jax.tree.map(
        lambda x: jnp.broadcast_to(x, (n_envs,) + x.shape),
        pp.empty_planar_cache(params.max_pairs),
    )
    warm = jax.jit(jax.vmap(lambda b, c: _staged_step(b, params, c)))
    for _ in range(2):
        fleet, cache = warm(fleet, cache)

    def operands(b, cache):
        b = pp.planar_integrate_velocities(b, params.dt, params.gravity)
        ia, ib, val, _ = pp.planar_broadphase(b, params.max_pairs)
        ka, kb = pp._pair_keys(ia, ib, val, None)
        vw = jnp.stack(
            [b.vel.x, b.vel.y, b.vel.z, b.omega.x, b.omega.y, b.omega.z],
            axis=-2,
        )
        return (pp._middle_rows(b), ia, ib, val.astype(jnp.float32),
                pp._warm_prev(cache, ka, kb, val), vw)

    return jax.jit(jax.vmap(operands))(fleet, cache)


@pytest.mark.parametrize("n_envs", [8, 16, 128])
def test_fused_middle_fleet_vmap_matches_primal(n_envs):
    """The fleet middle (vmapped _middle_core, the only fleet path)
    matches the per-scene primal on a warm mixed fleet: velocities,
    impulses and the discrete contact outputs."""
    params = SolverParams(max_pairs=128, iterations=6)
    args = _warm_middle_args(n_envs, params)
    core = lambda *a: pp._middle_core(*a, params=params,
                                      kinds=params.shape_kinds)
    fleet = [np.asarray(x) for x in jax.jit(jax.vmap(core))(*args)]
    one = jax.jit(core)
    per = [one(*(a[e] for a in args)) for e in range(n_envs)]
    ref = [np.stack([np.asarray(p[i]) for p in per]) for i in range(5)]
    vwc_r, lam_r, cand_r, val_r, trig_r = ref
    vwc_k, lam_k, cand_k, val_k, trig_k = fleet
    # discrete contract: graze-depth validity flips only; both-valid
    # slots must agree on candidate ids
    both = (val_r > 0.5) & (val_k > 0.5)
    assert both.sum() > 40
    np.testing.assert_array_equal(cand_k[both], cand_r[both])
    np.testing.assert_array_equal(trig_k, trig_r)
    np.testing.assert_allclose(vwc_k, vwc_r, atol=5e-5)
    np.testing.assert_allclose(lam_k, lam_r, atol=5e-4)

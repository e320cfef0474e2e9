"""Physics correctness: integration, contacts, stacking, friction,
restitution, vmap equivalence."""

import pytest
import jax
import jax.numpy as jnp
import numpy as np

from scx import physics as ph


def make_ground_scene(extra_pos, extra_kw=None, n_pad=0):
    """Static ground slab (64 x 0.1 x 64 like the reference sectors) + bodies."""
    extra_kw = extra_kw or {}
    k = extra_pos.shape[0]
    n = 1 + k + n_pad
    pos = jnp.zeros((n, 3)).at[0, 1].set(-0.55)
    pos = pos.at[1 : 1 + k].set(extra_pos)
    size = jnp.full((n, 3), 0.5).at[0].set(jnp.asarray([32.0, 0.05, 32.0]))
    body_type = jnp.full((n,), ph.rigid.BODY_DYNAMIC, jnp.int32).at[0].set(
        ph.rigid.BODY_STATIC
    )
    active = jnp.ones((n,), bool)
    if n_pad:
        active = active.at[1 + k :].set(False)
    kw = dict(size=size, body_type=body_type, active=active)
    kw.update(extra_kw)
    return ph.make_bodies(pos, **kw)


def run_steps(bodies, params, steps):
    """Warm-started stepping — the engine's real loop shape."""
    cache = ph.empty_contact_cache(params.max_pairs)

    def body_fn(carry, _):
        b, c = carry
        b, c, _ = ph.step_bodies_cached(b, params, c)
        return (b, c), None

    (out, _), _ = jax.lax.scan(body_fn, (bodies, cache), None, length=steps)
    return out


def test_free_fall():
    b = ph.make_bodies(jnp.asarray([[0.0, 100.0, 0.0]]))
    p = ph.SolverParams(max_pairs=4)
    steps = 60
    out = jax.jit(run_steps, static_argnums=2)(b, p, steps)
    # semi-implicit Euler: y = y0 - g*dt^2*(1+2+...+n) = y0 - g dt^2 n(n+1)/2
    dt = p.dt
    expected = 100.0 - 9.81 * dt * dt * steps * (steps + 1) / 2
    assert abs(float(out.pos[0, 1]) - expected) < 1e-3


def test_box_rests_on_ground():
    b = make_ground_scene(jnp.asarray([[0.0, 0.501, 0.0]]))
    p = ph.SolverParams(max_pairs=8)
    out = jax.jit(run_steps, static_argnums=2)(b, p, 120)
    # box half-extent 0.5 on ground top (y=-0.5): rest center y ~ 0.0
    assert abs(float(out.pos[1, 1]) - 0.0) < 0.02
    assert float(jnp.abs(out.vel[1]).max()) < 0.05


def test_dropped_box_settles():
    b = make_ground_scene(jnp.asarray([[0.0, 2.0, 0.0]]))
    p = ph.SolverParams(max_pairs=8)
    out = jax.jit(run_steps, static_argnums=2)(b, p, 240)
    assert abs(float(out.pos[1, 1]) - 0.0) < 0.05
    assert float(jnp.abs(out.vel[1]).max()) < 0.1


def test_restitution_bounce():
    b = make_ground_scene(
        jnp.asarray([[0.0, 3.0, 0.0]]),
        extra_kw=dict(
            shape=jnp.asarray([0, ph.rigid.SHAPE_SPHERE], jnp.int32),
            restitution=jnp.asarray([1.0, 0.8]),
        ),
    )
    p = ph.SolverParams(max_pairs=8)
    traj = []
    state = b
    step = jax.jit(lambda s: ph.step_bodies(s, p))
    for _ in range(150):
        state = step(state)
        traj.append(float(state.pos[1, 1]))
    top_after_bounce = max(traj[60:150])
    # dropped from 3.0 (2.5m above rest): with e=0.8 expect a solid rebound
    assert top_after_bounce > 0.8


def test_friction_stops_sliding_box():
    b = make_ground_scene(
        jnp.asarray([[0.0, 0.5, 0.0]]),
    )
    b = b.replace(vel=b.vel.at[1].set(jnp.asarray([4.0, 0.0, 0.0])))
    p = ph.SolverParams(max_pairs=8)
    out = jax.jit(run_steps, static_argnums=2)(b, p, 180)
    assert float(jnp.abs(out.vel[1, 0])) < 0.05  # friction stopped it
    # mu=0.64 combined -> stopping distance v^2/(2 mu g) ~ 1.3m
    assert 0.3 < float(out.pos[1, 0]) < 2.5


def test_stack_stability():
    b = make_ground_scene(
        jnp.asarray([[0.0, 0.5, 0.0], [0.02, 1.52, 0.0], [0.0, 2.54, 0.0]])
    )
    p = ph.SolverParams(max_pairs=16, iterations=12)
    out = jax.jit(run_steps, static_argnums=2)(b, p, 300)
    ys = np.asarray(out.pos[1:4, 1])
    np.testing.assert_allclose(ys, [0.0, 1.0, 2.0], atol=0.12)
    xz = np.asarray(out.pos[1:4, (0, 2)])
    assert np.abs(xz).max() < 0.3


def test_tower_8_boxes_stands_600_steps():
    """VERDICT r1 done-criterion: an 8-box tower stays standing for 600
    steps at 60 Hz (warm starting + face manifolds + sleeping)."""
    # ground top is y=-0.5; unit boxes rest at centers y = 0, 1, ..., 7
    ys = 0.5 + 1.0 * np.arange(8)
    pos = np.zeros((8, 3), np.float32)
    pos[:, 1] = ys
    b = make_ground_scene(jnp.asarray(pos))
    p = ph.SolverParams(max_pairs=64, iterations=8)
    out = jax.jit(run_steps, static_argnums=2)(b, p, 600)
    got = np.asarray(out.pos[1:9])
    np.testing.assert_allclose(got[:, 1], np.arange(8.0), atol=0.3)
    assert np.abs(got[:, (0, 2)]).max() < 0.25  # no lateral collapse
    # settled: the tower is quiescent (sleeping snaps residual jitter)
    assert float(jnp.abs(out.vel[1:9]).max()) < 0.05


def test_edge_edge_crossed_boxes_two_contacts():
    """45-degree crossed boxes produce a stable rest (edge manifold)."""
    from scx.core import math3d as m3

    q45 = np.asarray(m3.quat_from_euler_xyz(0.0, jnp.pi / 4, 0.0))
    b = make_ground_scene(
        jnp.asarray([[0.0, 0.5, 0.0], [0.0, 1.55, 0.0]]),
        extra_kw=dict(
            size=jnp.asarray(
                [[32.0, 0.05, 32.0], [2.0, 0.5, 0.5], [2.0, 0.5, 0.5]]
            )
        ),
    )
    b = b.replace(quat=b.quat.at[2].set(jnp.asarray(q45)))
    p = ph.SolverParams(max_pairs=16, iterations=10)
    out = jax.jit(run_steps, static_argnums=2)(b, p, 300)
    # top box rests crossed on the bottom one without sliding off
    # (ground top -0.5: bottom center ~0.0, top center ~1.0)
    assert abs(float(out.pos[2, 1]) - 1.0) < 0.15
    assert float(jnp.abs(out.pos[2, (0, 2)]).max()) < 0.3


def test_capsule_lies_on_box_face():
    """A capsule dropped lying sideways rests on the box face (the clipped
    segment probes give a 2-point manifold; 3-probe version rolled off)."""
    from scx.core import math3d as m3

    qz = np.asarray(m3.quat_from_euler_xyz(0.0, 0.0, jnp.pi / 2))
    b = make_ground_scene(
        jnp.asarray([[0.0, 1.0, 0.0]]),
        extra_kw=dict(
            shape=jnp.asarray([0, ph.rigid.SHAPE_CAPSULE], jnp.int32),
            size=jnp.asarray([[32.0, 0.05, 32.0], [0.3, 0.6, 0.0]]),
        ),
    )
    b = b.replace(quat=b.quat.at[1].set(jnp.asarray(qz)))  # axis along X
    p = ph.SolverParams(max_pairs=8)
    out = jax.jit(run_steps, static_argnums=2)(b, p, 240)
    # lying capsule rests at radius height over ground top -0.5 -> y=-0.2
    assert abs(float(out.pos[1, 1]) - (-0.2)) < 0.05
    axis = np.asarray(m3.quat_rotate(out.quat[1], jnp.asarray([0.0, 1.0, 0.0])))
    assert abs(axis[1]) < 0.2  # axis stayed horizontal


def test_sphere_capsule_rest():
    b = make_ground_scene(
        jnp.asarray([[2.0, 0.6, 0.0], [-2.0, 1.2, 0.0]]),
        extra_kw=dict(
            shape=jnp.asarray(
                [ph.rigid.SHAPE_BOX, ph.rigid.SHAPE_SPHERE, ph.rigid.SHAPE_CAPSULE],
                jnp.int32,
            ),
            size=jnp.asarray(
                [[32.0, 0.05, 32.0], [0.5, 0.5, 0.5], [0.3, 0.45, 0.0]]
            ),
        ),
    )
    p = ph.SolverParams(max_pairs=8)
    out = jax.jit(run_steps, static_argnums=2)(b, p, 240)
    # sphere r=0.5 rests at y=0; capsule r=0.3 hh=0.45 upright rests at 0.25
    assert abs(float(out.pos[1, 1]) - 0.0) < 0.05
    assert abs(float(out.pos[2, 1]) - 0.25) < 0.1


def test_vmap_batch_matches_single():
    single = make_ground_scene(jnp.asarray([[0.0, 1.3, 0.0], [0.4, 2.4, 0.1]]))
    p = ph.SolverParams(max_pairs=16)
    out1 = jax.jit(run_steps, static_argnums=2)(single, p, 60)
    batch = jax.tree.map(lambda x: jnp.stack([x, x, x]), single)
    outb = jax.jit(
        jax.vmap(lambda bb: run_steps(bb, p, 60))
    )(batch)
    np.testing.assert_allclose(
        np.asarray(outb.pos[1]), np.asarray(out1.pos), atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(outb.pos[0]), np.asarray(outb.pos[2]), atol=0
    )


def test_inactive_bodies_ignored():
    b = make_ground_scene(jnp.asarray([[0.0, 0.501, 0.0]]), n_pad=5)
    p = ph.SolverParams(max_pairs=16)
    out = jax.jit(run_steps, static_argnums=2)(b, p, 60)
    # padded slots stay exactly at origin, untouched by contacts
    np.testing.assert_allclose(np.asarray(out.pos[2:]), 0.0, atol=1e-6)
    assert abs(float(out.pos[1, 1])) < 0.02


def test_pair_overflow_reported_not_silent():
    """VERDICT r1 #7: an over-dense scene reports broadphase overflow in
    stats instead of silently dropping contacts."""
    # 20 boxes in one heap -> ~190 candidate pairs, cap at 16
    pos = np.zeros((20, 3), np.float32)
    pos[:, 1] = 0.5 + 0.1 * np.arange(20)
    b = make_ground_scene(jnp.asarray(pos))
    p = ph.SolverParams(max_pairs=16)
    cache = ph.empty_contact_cache(p.max_pairs)
    _, _, stats = jax.jit(lambda bb, cc: ph.step_bodies_cached(bb, p, cc))(b, cache)
    assert int(stats["pair_overflow"]) > 0
    assert int(stats["pairs"]) == 16  # cap saturated


@pytest.mark.slow
def test_one_hot_and_scatter_solve_paths_agree(monkeypatch):
    """The one-hot matmul solve (small scenes) and the row-scatter solve
    (huge scenes) are the same algorithm — results must match closely."""
    import numpy as np

    from scx.physics import solver as solver_mod

    def build():
        pos = jnp.asarray(
            [[0.0, -0.55, 0.0], [0.0, 0.45, 0.0], [0.0, 1.46, 0.0],
             [1.4, 0.45, 0.0], [0.3, 2.5, 0.1]]
        )
        size = jnp.asarray(
            [[8.0, 0.05, 8.0], [0.5, 0.5, 0.5], [0.5, 0.5, 0.5],
             [0.5, 0.5, 0.5], [0.4, 0.4, 0.4]]
        )
        bt = jnp.asarray(
            [ph.rigid.BODY_STATIC] + [ph.rigid.BODY_DYNAMIC] * 4, jnp.int32
        )
        return ph.make_bodies(pos, size=size, body_type=bt)

    params = ph.SolverParams(max_pairs=32, iterations=6)

    def run(limit):
        monkeypatch.setattr(solver_mod, "_ONE_HOT_LIMIT", limit)
        b = build()
        for _ in range(30):
            b = ph.step_bodies(b, params)
        return np.asarray(b.pos), np.asarray(b.vel)

    pos_mm, vel_mm = run(1 << 30)   # force one-hot matmuls
    pos_sc, vel_sc = run(0)         # force row scatters
    np.testing.assert_allclose(pos_mm, pos_sc, atol=1e-4)
    np.testing.assert_allclose(vel_mm, vel_sc, atol=1e-3)


def test_broadphase_topk_and_scatter_paths_agree(monkeypatch):
    """top_k compaction (small scenes) == rank-scatter compaction."""
    import numpy as np

    from scx.physics import broadphase as bp_mod

    rng = np.random.RandomState(3)
    pos = jnp.asarray(rng.uniform(-4, 4, size=(40, 3)).astype(np.float32))
    size = jnp.full((40, 3), 0.6)
    bt = jnp.asarray(
        [ph.rigid.BODY_STATIC] * 5 + [ph.rigid.BODY_DYNAMIC] * 35, jnp.int32
    )
    b = ph.make_bodies(pos, size=size, body_type=bt)

    def run(limit):
        monkeypatch.setattr(bp_mod, "_TOPK_MIN", 0)
        monkeypatch.setattr(bp_mod, "_TOPK_LIMIT", limit)
        return [
            np.asarray(x) for x in bp_mod.broadphase_pairs(b, max_pairs=64)
        ]

    for a, c in zip(run(1 << 30), run(0)):
        np.testing.assert_array_equal(a, c)


@pytest.mark.slow
def test_tower_12_boxes_colored_gauss_seidel():
    """VERDICT r2 item 5 done-criterion: a 12-box tower is stable for
    1,000 steps at 60 Hz with <= 6 iterations under the graph-colored
    Gauss-Seidel option, where the pure Jacobi path visibly creeps
    (Bullet's sequential impulse, sc_physics.cpp:283-302, batched)."""
    ys = 0.5 + 1.0 * np.arange(12)
    pos = np.zeros((12, 3), np.float32)
    pos[:, 1] = ys

    def run(colors):
        p = ph.SolverParams(max_pairs=64, iterations=6, colors=colors)
        b = make_ground_scene(jnp.asarray(pos))
        out = jax.jit(run_steps, static_argnums=2)(b, p, 1000)
        got = np.asarray(out.pos[1:13])
        dy = np.abs(got[:, 1] - np.arange(12.0)).max()
        lat = np.abs(got[:, (0, 2)]).max()
        return dy, lat, float(jnp.abs(out.vel[1:13]).max())

    dy_c, lat_c, v_c = run(colors=4)
    assert dy_c < 0.35 and lat_c < 0.05, (dy_c, lat_c)
    assert v_c < 0.05  # quiescent (sleeping)
    # the Jacobi path at the same budget drifts (measured: lat ~0.43)
    dy_j, lat_j, _ = run(colors=0)
    assert lat_j > 4 * lat_c + 0.1, (lat_j, lat_c)


def test_colored_solver_matches_jacobi_rest_state():
    """Both solver options project to the same contact fixed point: a box
    resting on the ground lands identically (colored path smoke)."""
    b0 = make_ground_scene(jnp.asarray([[0.2, 0.8, -0.1]]))

    def run(colors):
        p = ph.SolverParams(max_pairs=16, iterations=6, colors=colors)
        out = jax.jit(run_steps, static_argnums=2)(b0, p, 240)
        return np.asarray(out.pos[1]), np.asarray(out.vel[1])

    pos_c, vel_c = run(3)
    pos_j, vel_j = run(0)
    np.testing.assert_allclose(pos_c, pos_j, atol=2e-2)
    assert np.abs(vel_c).max() < 0.05 and np.abs(vel_j).max() < 0.05
    # rests on the ground plane (top of slab -0.5 + half extent 0.5)
    assert abs(pos_c[1] - 0.0) < 0.05

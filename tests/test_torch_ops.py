"""Parity of the port's ops (transforms, physics, geometry, path) with the
JAX package on identical seeded inputs, and with the committed float64
golden fixtures."""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drone2d_tpu.config import EnvConfig as JEnvConfig
from drone2d_tpu.ops import geometry as jgeom
from drone2d_tpu.ops import path as jpath
from drone2d_tpu.ops import physics as jphys
from drone2d_tpu.ops import transforms as jtf
from drone2d_tpu_torch.config import EnvConfig
from drone2d_tpu_torch.ops import geometry, path as tpath, physics, transforms

torch.set_num_threads(1)

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
CFG = EnvConfig()
MAX_WPS = 16
T = torch.as_tensor


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def test_config_copy_matches_jax():
    """The port's own EnvConfig copy has every field and derived constant of
    the JAX package's."""
    j = JEnvConfig()
    for f in j.__dataclass_fields__:
        assert getattr(CFG, f) == getattr(j, f), f
    for p in ("drone_radius", "total_mass", "moment_of_inertia", "screen_diag"):
        assert getattr(CFG, p) == getattr(j, p), p


def test_transforms_match_jax():
    rng = np.random.default_rng(0)
    a = rng.uniform(-20, 20, 4096).astype(np.float32)
    v = rng.normal(0, 100, (4096, 2)).astype(np.float32)
    # ssa is a float modulo: torch.remainder has jnp's sign semantics, so
    # the wrapped angles agree to float32 rounding of the argument
    np.testing.assert_allclose(_np(transforms.ssa(T(a))), jtf.ssa(a), atol=2e-6)
    assert _np(transforms.ssa(T(a))).min() >= -math.pi - 1e-6
    np.testing.assert_allclose(
        _np(transforms.rotate(T(a), T(v))), jtf.rotate(a, v), rtol=1e-6, atol=1e-4)
    x = rng.uniform(-5, 1300, 256).astype(np.float32)
    np.testing.assert_array_equal(
        _np(transforms.m1to1(T(x), 0.0, 1300.0)), jtf.m1to1(jnp.asarray(x), 0.0, 1300.0))
    np.testing.assert_allclose(
        _np(transforms.invm1to1(transforms.m1to1(T(x), -7.0, 11.0), -7.0, 11.0)), x,
        rtol=1e-5, atol=1e-4)


def _body_args():
    return dict(dt=CFG.physics_dt, gravity_y=CFG.gravity_y, mass=CFG.total_mass,
                inertia=CFG.moment_of_inertia, arm=CFG.drone_radius)


def test_step_body_matches_jax():
    rng = np.random.default_rng(1)
    n = 512
    pos = rng.uniform(0, 1300, (n, 2)).astype(np.float32)
    vel = rng.normal(0, 300, (n, 2)).astype(np.float32)
    ang = rng.uniform(-3, 3, n).astype(np.float32)
    om = rng.normal(0, 3, n).astype(np.float32)
    act = rng.uniform(-1, 1, (n, 2)).astype(np.float32)

    f = physics.thrust_forces(T(act), CFG.force_scale)
    got = physics.step_body(physics.BodyState(T(pos), T(vel), T(ang), T(om)),
                            f[:, 0], f[:, 1], **_body_args())

    def one(p, v, a, w, u):
        ff = jphys.thrust_forces(u, CFG.force_scale)
        return jphys.step_body(jphys.BodyState(p, v, a, w), ff[0], ff[1], **_body_args())

    want = jax.vmap(one)(pos, vel, ang, om, act)
    # one step of identical float32 arithmetic; sin/cos may differ by an ulp
    for name in ("pos", "vel", "angle", "omega"):
        np.testing.assert_allclose(_np(getattr(got, name)), getattr(want, name),
                                   rtol=1e-6, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("script", ["hover", "spin", "random"])
def test_physics_matches_golden_trajectory(script):
    """300 float32 steps vs the float64 C++ engine, to the bounds of
    tests/test_golden.py (float32 rounding compounding over the horizon)."""
    z = np.load(os.path.join(FIX, "golden_physics.npz"))
    actions = T(z[f"actions_{script}"].astype(np.float32))
    golden = z[f"traj_{script}"]
    init = z["init_state"].astype(np.float32)
    body = physics.BodyState(T(init[None, :2]), T(init[None, 2:4]),
                             T(init[None, 4:5]).reshape(1), T(init[None, 5:6]).reshape(1))
    traj = []
    for a in actions:
        f = physics.thrust_forces(a, CFG.force_scale)
        body = physics.step_body(body, f[0:1], f[1:2], **_body_args())
        traj.append(torch.cat([body.pos[0], body.vel[0], body.angle, body.omega]))
    traj = torch.stack(traj).double().numpy()
    rel = np.abs(traj - golden) / np.maximum(np.abs(golden), 1.0)
    assert rel.max() < 2e-3, (script, rel.max())
    assert np.abs(traj[:30] - golden[:30]).max() < 0.05, script


def _random_obstacle_states(n=1024, k=12, seed=2):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(200, 1100, (n, 2)).astype(np.float32)
    ang = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    centers = (pos[:, None] + rng.normal(0, 80, (n, k, 2))).astype(np.float32)
    radii = rng.uniform(10, 50, (n, k)).astype(np.float32)
    mask = rng.random((n, k)) < 0.7
    return pos, ang, centers, radii, mask


def test_frame_vertices_and_collision_match_jax():
    pos, ang, centers, radii, mask = _random_obstacle_states()
    hw, hh = CFG.drone_width / 2, CFG.drone_height / 4
    verts = geometry.frame_vertices(T(pos), T(ang), hw, hh)
    want_v = jax.vmap(lambda p, a: jgeom.frame_vertices(p, a, hw, hh))(pos, ang)
    np.testing.assert_allclose(_np(verts), want_v, rtol=1e-6, atol=1e-4)

    got = geometry.any_collision(T(pos), T(ang), hw, hh, T(centers), T(radii), T(mask))
    want = jax.vmap(
        lambda p, a, c, r, m: jgeom.any_collision(p, a, hw, hh, c, r, m)
    )(pos, ang, centers, radii, mask)
    # a boolean of a float32 SDF vs radius: equal unless within an ulp of
    # contact, which these seeded draws do not hit
    np.testing.assert_array_equal(_np(got), want)
    assert 0.2 < _np(got).mean() < 0.9  # both outcomes exercised


def _chains(n=12, seed=3, n_live=(12, 3, 7, 16)):
    """Random-corner-style waypoint chains (N, MAX_WPS, 2) padded with the
    last live waypoint, with a few live counts."""
    rng = np.random.default_rng(seed)
    wps = np.zeros((n, MAX_WPS, 2), np.float32)
    live = np.asarray([n_live[i % len(n_live)] for i in range(n)], np.int32)
    for i in range(n):
        p = rng.uniform(100, 400, 2)
        az0 = rng.uniform(-np.pi, np.pi)
        pts = [p]
        for _ in range(live[i] - 1):
            az = az0 + rng.uniform(-np.pi / 4, np.pi / 4)
            pts.append(pts[-1] + 100 * np.array([np.cos(az), np.sin(az)]))
        pts = np.stack(pts)
        wps[i] = np.concatenate([pts, np.repeat(pts[-1:], MAX_WPS - live[i], 0)])
    return wps, live


def _path_pair(wps, live, table_n=512, margin=10.0):
    got = tpath.make_path(T(wps), T(live), table_n=table_n, margin=margin)
    want = jax.vmap(lambda w, n: jpath.make_path(w, n, table_n=table_n, margin=margin))(
        wps, live)
    return got, want


def test_make_path_matches_jax():
    wps, live = _chains()
    got, want = _path_pair(wps, live)
    # arc lengths and fits are the same float32 operations in the same order
    # (the cumulative sum runs left to right, as jnp.cumsum does): equal
    for name in ("n_wps", "us", "centers", "length", "coef_x", "coef_y"):
        np.testing.assert_array_equal(_np(getattr(got, name)), getattr(want, name),
                                      err_msg=name)
    # XLA on the CPU fuses the table's multiply-add into an FMA and divides
    # by a reciprocal, so the table differs by float32 rounding, which the
    # extrapolated samples (u < 0 wraps to the last segment) amplify
    np.testing.assert_allclose(_np(got.table_u), want.table_u, rtol=1e-6, atol=1e-3)
    for name in ("table_x", "table_y"):
        np.testing.assert_allclose(_np(getattr(got, name)), getattr(want, name),
                                   rtol=1e-5, atol=2e-3, err_msg=name)


def test_path_point_and_gradient_match_jax_including_negative_u():
    wps, live = _chains()
    got, want = _path_pair(wps, live)
    L = np.asarray(want.length)
    # queries across [-margin-40, L+margin+40]: u < 0 takes the reference's
    # wrap to the last segment's polynomial, u > L the last-stretch branch
    frac = np.linspace(-0.1, 1.1, 97, dtype=np.float32)
    u = (frac[None] * (L[:, None] + 20.0) - 10.0).astype(np.float32)
    u[:, :3] = [-10.0, -3.0, -0.5]
    pts = tpath.path_point(got, T(u))
    grads = tpath.path_gradient(got, T(u))
    ang = tpath.direction_angle(got, T(u))
    jp = jax.vmap(jax.vmap(jpath.path_point, in_axes=(None, 0)))(want, u)
    jg = jax.vmap(jax.vmap(jpath.path_gradient, in_axes=(None, 0)))(want, u)
    ja = jax.vmap(jax.vmap(jpath.direction_angle, in_axes=(None, 0)))(want, u)
    # same branch and segment per query; the values differ only through the
    # float32 rounding of the fitted coefficients (positions ~1e3 px)
    np.testing.assert_allclose(_np(pts), jp, rtol=1e-5, atol=2e-3)
    np.testing.assert_allclose(_np(grads), jg, rtol=1e-4, atol=1e-5)
    d = np.abs((_np(ang) - np.asarray(ja) + np.pi) % (2 * np.pi) - np.pi)
    assert d.max() < 1e-4
    la = tpath.lookahead_point_from_u(got, T(u[:, 10]), CFG.lookahead)
    jla = jax.vmap(lambda pd, uu: jpath.lookahead_point_from_u(pd, uu, CFG.lookahead))(
        want, u[:, 10])
    np.testing.assert_allclose(_np(la), jla, rtol=1e-5, atol=2e-3)


def test_path_matches_golden():
    """The port's path vs the float64 fixture, to tests/test_golden.py's bounds."""
    z = np.load(os.path.join(FIX, "golden_path.npz"))
    n = len(z["wps"])
    wps = np.concatenate([z["wps"], np.repeat(z["wps"][-1:], MAX_WPS - n, 0)])
    pd = tpath.make_path(T(wps[None].astype(np.float32)), T([n]), table_n=512)
    assert float(pd.length[0]) == pytest.approx(float(z["length"]), rel=1e-5)
    us = T(z["us"][None].astype(np.float32))
    np.testing.assert_allclose(_np(tpath.path_point(pd, us)[0]), z["points"], atol=2e-2)
    np.testing.assert_allclose(_np(tpath.path_gradient(pd, us)[0]), z["gradients"],
                               atol=5e-3)
    ang = _np(tpath.direction_angle(pd, us)[0])
    assert np.abs((ang - z["angles"] + np.pi) % (2 * np.pi) - np.pi).max() < 5e-3
    la = tpath.lookahead_point_from_u(pd, us, CFG.lookahead)[0]
    np.testing.assert_allclose(_np(la), z["lookahead"], atol=3e-2)


@pytest.mark.parametrize(
    "mode", [dict(fine_points=17), dict(fine_points=0), dict(golden_iters=12)],
    ids=["fine17", "table_parabola", "golden12"],
)
def test_closest_u_matches_jax(mode):
    wps, live = _chains(n=16, seed=4, n_live=(12,))
    got, want = _path_pair(wps, live)
    rng = np.random.default_rng(5)
    m = 64
    lo, hi = wps[:, :12].min(1) - 150, wps[:, :12].max(1) + 150
    q = (lo[:, None] + rng.random((16, m, 2)) * (hi - lo)[:, None]).astype(np.float32)
    qf = q.reshape(-1, 2)
    rep = lambda x: x.repeat_interleave(m, 0)  # noqa: E731
    pd_rep = tpath.PathData(**{k: rep(v) for k, v in vars(got).items()})
    u = tpath.closest_u(pd_rep, T(qf), **mode)
    ju = jax.vmap(jax.vmap(lambda pd, p: jpath.closest_u(pd, p, **mode),
                           in_axes=(None, 0)))(want, q).reshape(-1)
    cp = tpath.path_point(pd_rep, u)
    jcp = jax.vmap(jax.vmap(jpath.path_point, in_axes=(None, 0)))(
        want, np.asarray(ju).reshape(16, m)).reshape(-1, 2)
    dist = np.linalg.norm(_np(cp) - qf, axis=1)
    jdist = np.linalg.norm(np.asarray(jcp) - qf, axis=1)
    # a near-tie in the table argmin may move the bracket by one cell, so
    # the distance at u* is held tightly and u* itself per query to a cell
    du = float(np.max(np.asarray(want.table_u[:, 1] - want.table_u[:, 0])))
    np.testing.assert_allclose(dist, jdist, rtol=1e-4, atol=1e-2)
    err = np.abs(_np(u) - np.asarray(ju))
    assert err.max() <= du
    if "fine_points" in mode:
        # the parabola steps agree closely; golden section's comparisons of
        # near-equal float32 distances in a flat minimum are rounding noise
        assert np.mean(err < 1e-2) > 0.95


def test_closest_u_all_equal_table_takes_first_index():
    """torch.argmin keeps the first index on ties, as jnp.argmin does: a
    query equidistant from every table sample resolves to table_u[0]."""
    T_n = 8
    pd = tpath.PathData(
        wps=torch.zeros(1, 4, 2), n_wps=T([4]).int(), us=torch.zeros(1, 4),
        centers=torch.zeros(1, 2), coef_x=torch.zeros(1, 2, 3),
        coef_y=torch.zeros(1, 2, 3), length=torch.zeros(1),
        table_u=torch.linspace(-10.0, 30.0, T_n)[None],
        table_x=torch.zeros(1, T_n), table_y=torch.zeros(1, T_n),
    )
    u = tpath.closest_u(pd, torch.zeros(1, 2), fine_points=0)
    assert float(u[0]) == -10.0

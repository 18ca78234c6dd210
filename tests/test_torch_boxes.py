"""The port's box obstacles, initial throw and fresh-draw step against the
JAX package, on the CPU.

The rounded-box geometry (`ops/geometry.py`) is held function by function
against JAX's on random fields, with half_wh = 0 equal to the circle
formulas; `parallel_boxes` is built array for array as in JAX; a step on
`parallel_boxes` states, teacher-forced from a JAX trajectory, gives JAX's
observation, collisions and dones.  The initial throw takes JAX's draws;
`step_autoreset` / `step_batch` take JAX's reset batch and must give what
JAX's `step_batch` gives.  Draws come from numpy seeds or JAX keys, never
from Pallas.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drone2d_tpu.config import EnvConfig as JEnvConfig
from drone2d_tpu.env import env as jenv, scenarios as jscen
from drone2d_tpu.ops import geometry as jgeo
from drone2d_tpu.ops.physics import BodyState as JBodyState
from drone2d_tpu_torch.compat.from_jax import (
    env_state_from_numpy,
    env_state_to_numpy,
    flatten_fields,
)
from drone2d_tpu_torch.config import EnvConfig
from drone2d_tpu_torch.env import scenarios
from drone2d_tpu_torch.env.env import Drone2DEnv
from drone2d_tpu_torch.env.types import INFO_FIELDS, cat_states, select_state
from drone2d_tpu_torch.ops import geometry
from drone2d_tpu_torch.ops.physics import BodyState
from tests.test_torch_env import _assert_obs_close

torch.set_num_threads(1)

HALF_W, HALF_H = 50.0, 5.0
BOXES = EnvConfig(mode="test", scenario="parallel_boxes", path_table_n=128)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x):
    return torch.as_tensor(np.array(x))


def _jax_cfg(cfg: EnvConfig) -> JEnvConfig:
    return JEnvConfig(**{k: getattr(cfg, k) for k in JEnvConfig.__dataclass_fields__})


def _field(seed, n=256, k=6, boxes=True):
    """Random drone poses and an obstacle field around them: half the
    obstacles boxes (half-extents 5-40 px, some rounded), half circles."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(300, 700, (n, 2)).astype(np.float32)
    angle = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    centers = (pos[:, None, :] + rng.normal(0, 110, (n, k, 2))).astype(np.float32)
    radii = rng.uniform(5, 40, (n, k)).astype(np.float32)
    half_wh = rng.uniform(5, 40, (n, k, 2)).astype(np.float32)
    if boxes:
        circle = rng.random((n, k)) < 0.5
        half_wh[circle] = 0.0
        radii[~circle & (rng.random((n, k)) < 0.7)] = 0.0  # most boxes sharp
    else:
        half_wh[:] = 0.0
    mask = rng.random((n, k)) < 0.85
    verts = np.asarray(jax.vmap(lambda p, a: jgeo.frame_vertices(p, a, HALF_W, HALF_H))(
        pos, angle))
    return dict(pos=pos, angle=angle, centers=centers, radii=radii, half_wh=half_wh,
                mask=mask, verts=verts)


def _close(got, want):
    # float32 formulas of the same order; XLA may contract a multiply-add
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6, atol=1e-4)


# -- the five geometry functions ----------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_vertex_circle_distances_match_jax(seed):
    f = _field(seed, boxes=False)
    want = jax.vmap(jgeo.vertex_circle_distances)(f["verts"], f["centers"], f["radii"])
    _close(geometry.vertex_circle_distances(_t(f["verts"]), _t(f["centers"]),
                                            _t(f["radii"])), want)


@pytest.mark.parametrize("seed", [0, 1])
def test_box_circle_sdf_matches_jax(seed):
    f = _field(seed)
    want = jax.vmap(lambda p, a, c: jgeo.box_circle_sdf(p, a, HALF_W, HALF_H, c))(
        f["pos"], f["angle"], f["centers"])
    got = geometry.box_circle_sdf(_t(f["pos"]), _t(f["angle"]), HALF_W, HALF_H,
                                  _t(f["centers"]))
    _close(got, want)
    # the circle collision test is the sdf below the radius
    hit = ((_np(got) < f["radii"]) & f["mask"]).any(1)
    np.testing.assert_array_equal(_np(geometry.any_collision(
        _t(f["pos"]), _t(f["angle"]), HALF_W, HALF_H, _t(f["centers"]), _t(f["radii"]),
        _t(f["mask"]))), hit)


@pytest.mark.parametrize("seed", [0, 1])
def test_point_aabb_sdf_matches_jax(seed):
    f = _field(seed)
    want = jax.vmap(jgeo.point_aabb_sdf)(f["verts"], f["centers"], f["half_wh"])
    got = geometry.point_aabb_sdf(_t(f["verts"]), _t(f["centers"]), _t(f["half_wh"]))
    assert got.shape == (256, 4, 6)
    _close(got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_vertex_rounded_box_distances_match_jax(seed):
    f = _field(seed)
    want = jax.vmap(jgeo.vertex_rounded_box_distances)(f["verts"], f["centers"],
                                                       f["half_wh"], f["radii"])
    _close(geometry.vertex_rounded_box_distances(_t(f["verts"]), _t(f["centers"]),
                                                 _t(f["half_wh"]), _t(f["radii"])), want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_any_collision_mixed_matches_jax(seed):
    f = _field(seed)
    want = jax.vmap(lambda p, a, c, r, hw, m: jgeo.any_collision_mixed(
        p, a, HALF_W, HALF_H, c, r, hw, m))(f["pos"], f["angle"], f["centers"], f["radii"],
                                            f["half_wh"], f["mask"])
    got = geometry.any_collision_mixed(_t(f["pos"]), _t(f["angle"]), HALF_W, HALF_H,
                                       _t(f["centers"]), _t(f["radii"]), _t(f["half_wh"]),
                                       _t(f["mask"]))
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    assert 20 < int(_np(got).sum()) < 236  # both outcomes, many times


def test_zero_half_extents_are_the_circle_formulas():
    """half_wh = 0: the rounded-box distance is the circle distance and the
    mixed collision is the circles-only one, bit for bit."""
    f = _field(3, boxes=False)
    verts, c, r = _t(f["verts"]), _t(f["centers"]), _t(f["radii"])
    hw = torch.zeros_like(c)
    torch.testing.assert_close(geometry.vertex_rounded_box_distances(verts, c, hw, r),
                               geometry.vertex_circle_distances(verts, c, r), rtol=0, atol=0)
    args = (_t(f["pos"]), _t(f["angle"]), HALF_W, HALF_H, c, r)
    torch.testing.assert_close(
        geometry.any_collision_mixed(*args, hw, _t(f["mask"])),
        geometry.any_collision(*args, _t(f["mask"])), rtol=0, atol=0)


# -- the scenario and its step --------------------------------------------------


def test_parallel_boxes_geometry_matches_jax():
    got = scenarios.build_test_scenario(BOXES)
    want = jscen.build_test_scenario(_jax_cfg(BOXES))
    assert got.n_wps == want.n_wps
    for k in ("wps", "obs_xy", "obs_r", "obs_mask", "spawn_rect", "obs_half_wh"):
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert (got.obs_r == 0).all() and (got.obs_half_wh[got.obs_mask] == 30.0).all()
    # the other scenarios stay circles only
    assert scenarios.build_test_scenario(BOXES.replace(scenario="parallel")).obs_half_wh is None


@pytest.fixture(scope="module")
def box_trajectory():
    """A JAX trajectory on parallel_boxes: 128 envs x 24 steps, a quarter of
    them spawned just beside a box, with random thrust, auto-reset to a
    template batch."""
    jcfg = _jax_cfg(BOXES)
    jenv_ = jenv.Drone2DEnv(jcfg)
    n, steps = 128, 24
    reset = jax.jit(jenv_.reset_batch, static_argnums=1)
    state, obs = reset(jax.random.PRNGKey(0), n)
    tmpl, tmpl_obs = reset(jax.random.PRNGKey(1), n)
    rng = np.random.default_rng(0)
    box = rng.integers(0, 6, n)
    beside = np.asarray(state.obstacles.xy)[np.arange(n), box] + np.stack(
        [rng.uniform(-90, 90, n), rng.choice([-1.0, 1.0], n) * rng.uniform(38, 60, n)], 1)
    near = (np.arange(n) % 4 == 0)[:, None]
    state = state._replace(body=state.body._replace(
        pos=jnp.where(near, beside.astype(np.float32), state.body.pos)))
    actions = np.clip(rng.uniform(-1, 1, (1, n, 2)) + 0.3 * rng.standard_normal((steps, n, 2)),
                      -1, 1).astype(np.float32)

    @jax.jit
    def run(state, obs, actions):
        def body(carry, a):
            s, o = carry
            out = jenv_.step_batch_template(s, a, tmpl, tmpl_obs)
            return (out.state, out.obs), s
        return jax.lax.scan(body, (state, obs), actions)[1]

    pre = jax.tree.map(lambda x: np.asarray(x).reshape((steps * n,) + x.shape[2:]),
                       run(state, obs, actions))
    actions = actions.reshape(-1, 2)
    return dict(pre=pre, actions=actions, plain=jax.jit(jax.vmap(jenv_.step))(pre, actions))


def test_box_state_bridge_round_trip(box_trajectory):
    flat = flatten_fields(box_trajectory["pre"])
    assert "obstacles.half_wh" in flat
    state = env_state_from_numpy(box_trajectory["pre"], device="cpu")
    back = env_state_to_numpy(state)
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_teacher_forced_box_step_matches_jax(box_trajectory):
    """obs to 1e-5 of scale on every column the boxes feed (the obstacle
    slots, 8-16) and the bounds of tests/test_torch_env.py on the rest;
    collisions, dones and the info flags exact."""
    want = box_trajectory["plain"]
    state = env_state_from_numpy(box_trajectory["pre"], device="cpu")
    got = Drone2DEnv(BOXES, device="cpu").step(state, _t(box_trajectory["actions"]))
    obs, wobs = _np(got.obs), np.asarray(want.obs)
    np.testing.assert_allclose(obs[:, 8:17], wobs[:, 8:17], rtol=0,
                               atol=1e-5 * max(1.0, np.abs(wobs[:, 8:17]).max()))
    _assert_obs_close(obs, wobs)
    np.testing.assert_array_equal(_np(got.done), np.asarray(want.done))
    for k in INFO_FIELDS + ("terminal",):
        w = np.asarray(want.info[k])
        if w.dtype.kind in "iub":
            np.testing.assert_array_equal(_np(got.info[k]), w, err_msg=k)
    coll = _np(got.info["n_collisions"])
    assert coll.sum() >= 5 and (~_np(got.done)).sum() >= 100


def test_box_collision_differs_from_circles():
    """A level drone beside the first box's corner, its frame overlapping the
    square (30 px half-side) where a circle of radius 30 would miss it, and
    a second one 3 px higher, clear of both."""
    env = Drone2DEnv(BOXES, device="cpu")
    state, _ = env.reset_batch(torch.Generator().manual_seed(0), 2)
    c = state.obstacles.xy[:, 0]
    pos = c + torch.tensor([[-70.0, 33.0], [-70.0, 36.0]])  # the row runs to +x
    body = dataclasses.replace(state.body, pos=pos, vel=torch.zeros(2, 2),
                               angle=torch.zeros(2), omega=torch.zeros(2))
    state = dataclasses.replace(state, body=body)
    out = env.step(state, torch.full((2, 2), 0.0))
    circles = dataclasses.replace(state.obstacles, half_wh=None, r=torch.where(
        state.obstacles.mask, 30.0, 0.0))
    out_c = env.step(dataclasses.replace(state, obstacles=circles), torch.full((2, 2), 0.0))
    assert _np(out.info["n_collisions"]).tolist() == [1, 0]
    assert _np(out_c.info["n_collisions"]).tolist() == [0, 0]


# -- the initial throw ----------------------------------------------------------


@pytest.mark.parametrize("throw", [True, False])
def test_initial_motion_matches_jax(throw):
    """`_initial_motion` from JAX's own draws (its key split as JAX splits
    it) gives JAX's body, and a reset with the throw on starts from it."""
    cfg = EnvConfig(initial_motion_enabled=True, initial_throw=throw, path_table_n=128)
    jenv_ = jenv.Drone2DEnv(_jax_cfg(cfg))
    n = 64
    rng = np.random.default_rng(1)
    body = JBodyState(pos=rng.uniform(100, 1200, (n, 2)).astype(np.float32),
                      vel=rng.normal(0, 20, (n, 2)).astype(np.float32),
                      angle=rng.uniform(-0.8, 0.8, n).astype(np.float32),
                      omega=rng.normal(0, 1, n).astype(np.float32))
    keys = jax.random.split(jax.random.PRNGKey(3), n)
    want = jax.jit(jax.vmap(jenv_._initial_motion))(keys, body)

    def draws(k):
        ka, kf, kr = jax.random.split(k, 3)
        return (jax.random.uniform(ka, ()) * 2 * jnp.pi,
                jax.random.uniform(kf, (), minval=0.0, maxval=1500.0),
                jax.random.uniform(kr, (), minval=-3000.0, maxval=3000.0))

    drawn = tuple(_t(d) for d in jax.vmap(draws)(keys)) if throw else None
    env = Drone2DEnv(cfg, device="cpu")
    got = env._initial_motion(BodyState(*(_t(x) for x in body)), drawn)
    for k in ("pos", "vel", "angle", "omega"):
        w = np.asarray(getattr(want, k))
        np.testing.assert_allclose(_np(getattr(got, k)), w, rtol=1e-6,
                                   atol=1e-5 * max(1.0, np.abs(w).max()), err_msg=k)
    # the reset ends with the throw: velocities away from zero, finite obs
    state, obs = env.reset_batch(torch.Generator().manual_seed(0), n)
    assert bool(torch.isfinite(obs).all())
    assert bool((state.body.vel[:, 1] < -50.0).all())  # 6 steps of gravity at least
    if throw:
        assert float(state.body.omega.abs().min()) > 0.0


def test_throw_draws_ranges_and_stream():
    """The throw's draws are in their ranges; with the throw off the
    generator's stream is the one it was (the reset draws nothing more)."""
    env = Drone2DEnv(EnvConfig(path_table_n=128), device="cpu")
    a, f, r = env.throw_draws(torch.Generator().manual_seed(0), 4096)
    assert 0 <= float(a.min()) and float(a.max()) < 2 * np.pi
    assert 0 <= float(f.min()) and float(f.max()) < 1500
    assert -3000 <= float(r.min()) and float(r.max()) < 3000
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    env.reset_batch(g1, 8)
    Drone2DEnv(EnvConfig(path_table_n=128, initial_motion_enabled=True, initial_throw=False),
               device="cpu").reset_batch(g2, 8)
    assert torch.equal(g1.get_state(), g2.get_state())


# -- the fresh-draw step --------------------------------------------------------


@pytest.mark.parametrize("scen", ["stage_5", "parallel_boxes"])
def test_step_autoreset_matches_jax(scen, monkeypatch):
    """The port's `step_batch` (= `step_autoreset`) with JAX's reset batch
    injected (the vmapped resets of the keys JAX's step_batch splits) gives
    JAX's step_batch: the done envs take their own fresh episode."""
    cfg = (BOXES if scen == "parallel_boxes" else
           EnvConfig(scenario=scen, path_table_n=128)).replace(n_steps=6)
    jenv_ = jenv.Drone2DEnv(_jax_cfg(cfg))
    n = 64
    state, obs = jax.jit(jenv_.reset_batch, static_argnums=1)(jax.random.PRNGKey(4), n)
    rng = np.random.default_rng(2)
    state = state._replace(t=jnp.asarray(rng.integers(0, 6, n).astype(np.int32)))
    actions = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    want = jax.jit(jenv_.step_batch)(state, actions, key)
    keys = jax.random.split(key, n)
    fresh, fresh_obs = jax.jit(jax.vmap(lambda k: jenv_.reset(k, 0)))(keys)

    env = Drone2DEnv(cfg, device="cpu")
    calls = []

    def injected(gen, num_envs, global_step=0.0, rehearsal_probs=None):
        calls.append((num_envs, global_step))
        return env_state_from_numpy(jax.tree.map(np.asarray, fresh), "cpu"), _t(fresh_obs)

    monkeypatch.setattr(env, "reset_batch", injected)
    for fn in (env.step_batch, env.step_autoreset):
        got = fn(env_state_from_numpy(jax.tree.map(np.asarray, state), "cpu"), _t(actions),
                 torch.Generator())
        done = np.asarray(want.done)
        assert 10 <= done.sum() < n  # the cap and the boxes end some, not all
        np.testing.assert_array_equal(_np(got.done), done)
        _assert_obs_close(_np(got.obs), np.asarray(want.obs))
        np.testing.assert_array_equal(_np(got.obs)[done], np.asarray(fresh_obs)[done])
        wflat = flatten_fields(want.state)
        for k, g in env_state_to_numpy(got.state).items():
            w = wflat[k]
            if w.dtype.kind in "iub":
                np.testing.assert_array_equal(g, w, err_msg=k)
            else:
                np.testing.assert_allclose(g, w, rtol=1e-5, atol=3e-3, err_msg=k)
    assert calls == [(n, 0.0)] * 2


def test_step_batch_draws_fresh_episodes():
    """Without injection: every done env restarts at t = 0 on a path of its
    own, different from its last one and from every other restarted env's."""
    env = Drone2DEnv(EnvConfig(path_table_n=128, n_steps=3), device="cpu")
    gen = torch.Generator().manual_seed(0)
    state, _ = env.reset_batch(gen, 32)
    for _ in range(3):
        before = state.path.wps
        out = env.step_batch(state, torch.zeros(32, 2), gen)
        state = out.state
    assert bool(out.done.all()) and bool((state.t == 0).all())
    first = state.path.wps[:, 0]
    assert not bool((first == before[:, 0]).all(1).any())
    assert len(torch.unique(first, dim=0)) == 32


def test_optional_leaf_select_and_cat():
    """select_state and cat_states carry a None half_wh through and raise
    on a mix of None and a tensor."""
    env = Drone2DEnv(BOXES, device="cpu")
    boxes, _ = env.reset_batch(torch.Generator().manual_seed(0), 4)
    circles, _ = Drone2DEnv(BOXES.replace(scenario="parallel"), device="cpu").reset_batch(
        torch.Generator().manual_seed(0), 4)
    mask = torch.tensor([True, False, True, False])
    assert select_state(mask, circles, circles).obstacles.half_wh is None
    assert cat_states([circles, circles]).obstacles.half_wh is None
    both = cat_states([boxes, boxes])
    assert both.obstacles.half_wh.shape == (8, BOXES.max_obs, 2)
    for bad in (lambda: select_state(mask, boxes, circles),
                lambda: cat_states([circles, boxes])):
        with pytest.raises(ValueError, match="optional leaf"):
            bad()

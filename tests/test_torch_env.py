"""Parity of the port's environment with the JAX package.

The step is held by teacher forcing: a JAX trajectory of 64 envs x 32 steps
(stages 2-5, random actions, auto-reset to a template) is recorded, and at
every step the port is fed the JAX state and action and must give the same
observation, reward, done, info and next state.  Resets draw from a torch
Generator, whose bits differ from JAX's threefry, so they are held by
invariants and distributions, and by exact agreement of everything
computed from the drawn waypoints.
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drone2d_tpu.config import EnvConfig as JEnvConfig
from drone2d_tpu.env import env as jenv
from drone2d_tpu.env import scenarios as jscen
from drone2d_tpu.env.types import EnvState as JEnvState, ObstacleSet as JObstacleSet
from drone2d_tpu.ops import path as jpath
from drone2d_tpu.ops.physics import BodyState as JBodyState
from drone2d_tpu_torch.compat.from_jax import (
    env_state_from_numpy,
    env_state_to_numpy,
    flatten_fields,
)
from drone2d_tpu_torch.config import EnvConfig
from drone2d_tpu_torch.env import scenarios
from drone2d_tpu_torch.env.env import Drone2DEnv, _observe, _rewards_and_done
from drone2d_tpu_torch.env.types import INFO_FIELDS
from drone2d_tpu_torch.ops import path as tpath

torch.set_num_threads(1)

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
CFG = EnvConfig()
JENV = jenv.Drone2DEnv(JEnvConfig())
ENV = Drone2DEnv(CFG, device="cpu")
GROUP_STEPS = (8e5, 1.3e6, 1.8e6, 3e6)   # stages 2, 3, 4, 5
GROUP, T_STEPS = 16, 32


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _to_jax_state(flat):
    """A flat numpy dict of EnvState leaves -> the JAX package's EnvState."""
    g = lambda p, cls: cls(**{f: jnp.asarray(flat[f"{p}.{f}"]) for f in cls._fields  # noqa: E731
                             if f"{p}.{f}" in flat})
    top = {f: jnp.asarray(flat[f]) for f in JEnvState._fields
           if f not in ("path", "obstacles", "body")}
    return JEnvState(path=g("path", jpath.PathData), obstacles=g("obstacles", JObstacleSet),
                     body=g("body", JBodyState), **top)


def _concat(trees):
    return jax.tree.map(lambda *xs: jnp.concatenate(xs), *trees)


@pytest.fixture(scope="module")
def trajectory():
    reset = jax.jit(JENV.reset_batch, static_argnums=1)

    def batch(seed):
        parts = [reset(jax.random.PRNGKey(seed + i), GROUP, jnp.float32(gs))
                 for i, gs in enumerate(GROUP_STEPS)]
        return _concat([p[0] for p in parts]), jnp.concatenate([p[1] for p in parts])

    state, obs = batch(0)
    tmpl_state, tmpl_obs = batch(10)
    n = GROUP * len(GROUP_STEPS)
    # the stage-4 group starts just below its on-path obstacle, so that
    # collisions happen; a constant thrust difference per env plus noise
    # makes many drones tumble past the aggressive-angle limit
    m = JENV.cfg.max_curriculum_obs
    xy, r = state.obstacles.xy[:, m], state.obstacles.r[:, m]
    below = xy - jnp.stack([jnp.zeros_like(r), r + 12.0], -1)
    stage4 = ((jnp.arange(n) // GROUP == 2) & state.obstacles.mask[:, m])[:, None]
    state = state._replace(body=state.body._replace(
        pos=jnp.where(stage4, below, state.body.pos)))
    rng = np.random.default_rng(0)
    actions = np.clip(rng.uniform(-1, 1, (1, n, 2)) + 0.3 * rng.standard_normal((T_STEPS, n, 2)),
                      -1, 1).astype(np.float32)

    @jax.jit
    def run(state, obs, actions):
        def body(carry, a):
            s, o = carry
            out = JENV.step_batch_template(s, a, tmpl_state, tmpl_obs)
            return (out.state, out.obs), (s, out)
        return jax.lax.scan(body, (state, obs), actions)[1]

    pre, outs = run(state, obs, actions)
    flat = lambda x: np.asarray(x).reshape((T_STEPS * n,) + x.shape[2:])  # noqa: E731
    pre = jax.tree.map(flat, pre)
    outs = jax.tree.map(flat, outs)
    # the same states through the plain (no auto-reset) step
    plain = jax.jit(jax.vmap(JENV.step))(pre, actions.reshape(-1, 2))
    tile = lambda x: np.tile(np.asarray(x), (T_STEPS,) + (1,) * (x.ndim - 1))  # noqa: E731
    return dict(pre=pre, actions=actions.reshape(-1, 2), outs=outs, plain=plain,
                tmpl_state=jax.tree.map(tile, tmpl_state), tmpl_obs=tile(tmpl_obs))


def test_state_bridge_round_trip(trajectory):
    flat = flatten_fields(trajectory["pre"])
    state = env_state_from_numpy(trajectory["pre"], device="cpu")
    assert state.t.dtype == torch.int32 and state.family.dtype == torch.int32
    assert state.path.n_wps.dtype == torch.int32 and state.la_locked.dtype == torch.bool
    back = env_state_to_numpy(state)
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


# Teacher-forced tolerances.  Both sides run the same float32 formulas on
# the same state; they differ only where XLA contracts a multiply-add into
# an FMA or where the libraries' sin/cos/atan2 round differently, and the
# closest-point search (u* sits in a flat minimum of the distance) turns
# those ulps into ~1e-4 of normalized observation, i.e. ~0.05 px of the
# closest point.
OBS_ATOL = 2e-4
CP_SHIFT_PX = 0.1


def _assert_obs_close(obs, wobs):
    """OBS_ATOL on every column, except the bearing to the closest point
    (sin/cos, columns 25-26): a shift of the closest point by delta px turns
    it by delta / |cp - pos| radians, which is large when the drone sits on
    the path, so those columns get that conditioning on top."""
    w, h = CFG.screensize_x, CFG.screensize_y
    dist = np.hypot((wobs[:, 19] - wobs[:, 6]) * w / 2, (wobs[:, 20] - wobs[:, 7]) * h / 2)
    tol = np.full(wobs.shape, OBS_ATOL)
    tol[:, 25:27] += (CP_SHIFT_PX / np.maximum(dist, 1e-6))[:, None]
    err = np.abs(obs - wobs)
    assert (err <= tol).all(), np.argwhere(err > tol)[:10]


def _check_step(got, want):
    obs, wobs = _np(got.obs), np.asarray(want.obs)
    _assert_obs_close(obs, wobs)
    np.testing.assert_array_equal(_np(got.done), np.asarray(want.done))
    # the reward reads the observation back; its largest gains (PP's speed
    # term, CA's 1/d) map an obs difference of 2e-4 to ~2e-3
    np.testing.assert_allclose(_np(got.reward), want.reward, rtol=1e-4, atol=3e-3)
    for k in INFO_FIELDS + ("terminal",):
        g, w = _np(got.info[k]), np.asarray(want.info[k])
        if w.dtype.kind in "iub":
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=3e-3, err_msg=k)
    want_flat = flatten_fields(want.state)
    for k, g in env_state_to_numpy(got.state).items():
        w = want_flat[k]
        if w.dtype.kind in "iub":
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=3e-3, err_msg=k)


def test_teacher_forced_step_matches_jax(trajectory):
    state = env_state_from_numpy(trajectory["pre"], device="cpu")
    got = ENV.step(state, torch.as_tensor(trajectory["actions"]))
    _check_step(got, trajectory["plain"])
    # the trajectory exercises collisions, tumbles, live and padded obstacle
    # slots, and both sides of the lambda blend's danger range
    info = got.info
    assert _np(info["n_collisions"]).sum() >= 5
    assert (_np(got.done) & ~(_np(info["n_collisions"]) > 0)).sum() >= 5
    assert len(np.unique(_np(state.obstacles.mask.sum(1)))) >= 3
    d = _np(info["dist_closest_obs"])
    assert (d < CFG.danger_range).sum() >= 20 and (d > CFG.danger_range).sum() >= 20


def test_teacher_forced_autoreset_step_matches_jax(trajectory):
    state = env_state_from_numpy(trajectory["pre"], device="cpu")
    tmpl = env_state_from_numpy(trajectory["tmpl_state"], device="cpu")
    got = ENV.step_batch_template(state, torch.as_tensor(trajectory["actions"]), tmpl,
                                  torch.as_tensor(trajectory["tmpl_obs"]))
    _check_step(got, trajectory["outs"])


def test_reward_matches_golden():
    """The port's reward + done vs the float64 oracle fixture, to
    tests/test_golden.py's bounds."""
    z = np.load(os.path.join(FIX, "golden_reward.npz"))
    r = _rewards_and_done(CFG, torch.as_tensor(z["obs"].astype(np.float32)),
                          torch.as_tensor(z["has_obs"]), torch.as_tensor(z["collided"]),
                          torch.as_tensor(z["t_new"].astype(np.int32)))
    np.testing.assert_allclose(_np(r["reward"]), z["rewards"], atol=2e-3, rtol=1e-4)
    np.testing.assert_array_equal(_np(r["done"]), z["dones"])


def test_stage_schedule_matches_jax():
    steps = np.array([0, 699_999, 700_000, 999_999, 1e6, 1_599_999, 1.6e6, 1_999_999,
                      2e6, 3e9, 2**31 + 2**17], np.float32)
    got = _np(scenarios.stage_from_step(torch.as_tensor(steps)))
    want = np.asarray(jax.vmap(jscen.stage_from_step)(steps))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 5])
    for f, jf in ((scenarios.stage3_spawn_chance, jscen.stage3_spawn_chance),
                  (scenarios.stage4_spawn_chance, jscen.stage4_spawn_chance)):
        np.testing.assert_allclose(_np(f(torch.as_tensor(steps))), jax.vmap(jf)(steps),
                                   rtol=1e-6)


def _reset(scenario="large", n=2048, global_step=0.0, seed=0):
    env = Drone2DEnv(CFG.replace(scenario=scenario), device="cpu")
    return env.reset_batch(torch.Generator().manual_seed(seed), n, global_step)


def test_reset_path_and_observation_match_jax():
    """Everything computed from the drawn waypoints is the JAX package's
    function of them: the path tables and the first observation."""
    state, obs = _reset("stage_5", n=256)
    wps = _np(state.path.wps)
    want = jax.vmap(lambda w: jpath.make_path(w, jnp.int32(12), table_n=512))(wps)
    for k in ("us", "centers", "length", "coef_x", "coef_y"):
        np.testing.assert_array_equal(_np(getattr(state.path, k)), getattr(want, k),
                                      err_msg=k)
    for k in ("table_u", "table_x", "table_y"):
        np.testing.assert_allclose(_np(getattr(state.path, k)), getattr(want, k),
                                   rtol=1e-5, atol=2e-3, err_msg=k)
    js = _to_jax_state(env_state_to_numpy(state))
    jobs, jlock = jax.vmap(
        lambda s: jenv._observe(JENV.cfg, s.path, s.obstacles, s.body, s.target,
                                jnp.asarray(False))
    )(js)
    _assert_obs_close(_np(obs), np.asarray(jobs))
    np.testing.assert_array_equal(_np(state.la_locked), jlock)


def test_reset_invariants_per_stage():
    m = CFG.max_curriculum_obs
    for k in range(1, 6):
        state, obs = _reset(f"stage_{k}", n=4096, seed=k)
        mask = _np(state.obstacles.mask)
        xy = _np(state.obstacles.xy)
        wps = _np(state.path.wps)
        pos = _np(state.body.pos)
        near, on = mask[:, :m].sum(1), mask[:, m]
        assert not mask[:, m + 1:].any()
        assert (xy[~mask] == 1e6).all()
        assert np.abs(_np(state.body.angle)).max() <= math.pi / 4
        np.testing.assert_array_equal(_np(state.target), wps[:, CFG.n_wps - 1])
        assert np.isfinite(_np(obs)).all()
        assert not _np(state.t).any() and not _np(state.family).any()
        if k in (1, 2):
            assert not mask.any()
        if k == 2:  # anywhere on screen
            assert (pos >= 100).all() and (pos <= CFG.screensize_x - 100).all()
            assert np.abs(pos - wps[:, 0]).max() > 100
        else:       # at the path start
            np.testing.assert_array_equal(pos, wps[:, 0])
        if k == 3:  # forced stage: one near-path obstacle with chance 0.6
            assert near.max() == 1 and not on.any()
            assert abs(near.mean() - 0.6) < 0.04  # 5 sigma at n=4096
        if k == 4:  # forced stage: always one on-path obstacle
            assert on.all() and not near.any()
        if k == 5:  # n ~ N(1, 4): 0 for n < -3, 1 for -3 < n < 0, else ceil
            zero = (near == 0).mean()
            # P(n < -3) = Phi(-1) = 0.1587 and E[count] = 2.694 (numpy,
            # 1e7 draws); bounds are 5 sigma at n=4096
            assert abs(zero - 0.1587) < 0.03
            assert (on == (near > 0)).all()
            assert abs(near.mean() - 2.694) < 0.2


def test_reset_schedule_by_global_step():
    for gs, stage_obstacles in ((0.0, False), (7.5e5, False), (3e6, True)):
        state, _ = _reset(global_step=gs, n=512, seed=7)
        assert bool(state.obstacles.mask.any()) == stage_obstacles
    # scheduled stage 3 at 1.3M: one near obstacle with chance 0.4
    state, _ = _reset(global_step=1.3e6, n=4096, seed=8)
    near = _np(state.obstacles.mask).sum(1)
    assert abs(near.mean() - 0.4) < 0.04


def test_near_path_obstacles_keep_margin():
    """Accepted near-path obstacles satisfy |offset| > radius + 10: the
    path's closest approach exceeds the radius (minus refine slack)."""
    state, _ = _reset("stage_5", n=512, seed=3)
    m = CFG.max_curriculum_obs
    mask = state.obstacles.mask[:, :m]
    env_idx, slot = torch.nonzero(mask, as_tuple=True)
    assert len(env_idx) > 200
    pd = tpath.PathData(**{k: v[env_idx] for k, v in vars(state.path).items()})
    q = state.obstacles.xy[env_idx, slot]
    u = tpath.closest_u(pd, q, golden_iters=16)
    d = torch.linalg.norm(tpath.path_point(pd, u) - q, dim=1)
    assert bool((d > state.obstacles.r[env_idx, slot] - 1.0).all())


def test_random_corner_waypoints():
    wps = _np(scenarios.random_corner_waypoints(torch.Generator().manual_seed(0), CFG,
                                                512, "cpu"))
    x1, y1 = wps[:, 0, 0], wps[:, 0, 1]
    assert (((100 <= x1) & (x1 <= 180)) | ((1120 <= x1) & (x1 <= 1200))).all()
    assert (((100 <= y1) & (y1 <= 180)) | ((1120 <= y1) & (y1 <= 1200))).all()
    seg = np.linalg.norm(np.diff(wps[:, :CFG.n_wps], axis=1), axis=-1)
    np.testing.assert_allclose(seg, CFG.path_segment_length, rtol=1e-5)
    np.testing.assert_array_equal(wps[:, CFG.n_wps:], np.repeat(wps[:, CFG.n_wps - 1:CFG.n_wps],
                                                                CFG.max_wps - CFG.n_wps, 1))
    # all four corners are drawn
    corners = (x1 > 650).astype(int) + 2 * (y1 > 650)
    assert len(np.unique(corners)) == 4


def test_unported_settings_raise():
    """No setting of the JAX package's env is refused any more: the initial
    throw and the box obstacles build, reset and step (held against JAX in
    tests/test_torch_boxes.py)."""
    for kw in (dict(initial_motion_enabled=True),
               dict(mode="test", scenario="parallel_boxes")):
        env = Drone2DEnv(CFG.replace(path_table_n=128, **kw), device="cpu")
        state, obs = env.reset_batch(torch.Generator().manual_seed(0), 8)
        out = env.step(state, torch.zeros(8, 2))
        assert bool(torch.isfinite(obs).all()) and bool(torch.isfinite(out.obs).all())


def test_observe_all_padding_slots():
    """With no live obstacles the k-nearest argmin sees an all-inf row and
    every slot reads (1, 0, 0), as in the JAX package."""
    state, obs = _reset("stage_1", n=64, seed=2)
    np.testing.assert_array_equal(_np(obs[:, 8:17]),
                                  np.tile([1, 0, 0, 1, 0, 0, 1, 0, 0], (64, 1)))
    obs2, _ = _observe(CFG, state.path, state.obstacles, state.body, state.target,
                       state.la_locked)
    torch.testing.assert_close(obs2, obs, rtol=0, atol=0)

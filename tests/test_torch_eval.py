"""The port's eval campaign against the JAX package, on the CPU.

The 7 spatial test scenarios must be built array for array as in JAX, and a
test-mode reset must give the same path tables and first observation.  The
episode runner is fed the JAX runner's own reset states and per-step noise
(its episode keys split as `drone2d_tpu/eval/episode.py` splits them) and
must latch the same outcomes; a scripted batch holds the latch, the coast
and the timeout fix-up; `write_campaign` must write the same files as the
JAX package's from the same results, the overlay PNG and the GIF included;
the CLI runs on the CPU, with its default GIF and `--gif-all`.
"""

import dataclasses
import json
import os

import imageio.v2 as imageio
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drone2d_tpu.config import EnvConfig as JEnvConfig
from drone2d_tpu.env import env as jenv, scenarios as jscen
from drone2d_tpu.eval import artifacts as jartifacts, episode as jepisode, run as jrun
from drone2d_tpu.models.policy import flat_dict_to_params as jax_from_flat
from drone2d_tpu.ops.physics import BodyState as JBodyState
from drone2d_tpu.utils.host_path import HostQPMI as JHostQPMI
from drone2d_tpu_torch.compat.from_jax import env_state_from_numpy, env_state_to_numpy
from drone2d_tpu_torch.config import (
    ALL_SCENARIOS,
    EXTRA_SCENARIOS,
    STAGE_SCENARIOS,
    TEST_SCENARIOS,
    EnvConfig,
    PPOConfig,
)
from drone2d_tpu_torch.env import scenarios
from drone2d_tpu_torch.env.env import Drone2DEnv
from drone2d_tpu_torch.eval import artifacts, episode, run
from drone2d_tpu_torch.learn.ppo import PPOLearner
from drone2d_tpu_torch.models.policy import flat_dict_to_params
from drone2d_tpu_torch.utils.checkpoint import save_checkpoint
from drone2d_tpu_torch.utils.host_path import HostQPMI
from tests.test_torch_env import _assert_obs_close

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
AGENT = os.path.join(ROOT, "artifacts", "agent_s8004", "new_agent.npz")


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _jax_cfg(cfg: EnvConfig) -> JEnvConfig:
    return JEnvConfig(**{k: getattr(cfg, k) for k in JEnvConfig.__dataclass_fields__})


# -- scenarios and the test-mode reset ----------------------------------------


def test_scenario_names_and_host_path_match_jax():
    from drone2d_tpu import config as jconfig

    assert (TEST_SCENARIOS, STAGE_SCENARIOS, ALL_SCENARIOS, EXTRA_SCENARIOS) == (
        jconfig.TEST_SCENARIOS, jconfig.STAGE_SCENARIOS, jconfig.ALL_SCENARIOS,
        jconfig.EXTRA_SCENARIOS)
    wps = scenarios.scenario_waypoints("S_corridor", 1300.0, 1300.0, n_wps=7, distance=200)
    got, want = HostQPMI(wps), JHostQPMI(wps)
    for u in np.linspace(-5.0, got.length + 5.0, 97):
        np.testing.assert_array_equal(got.point(u), want.point(u))
        np.testing.assert_array_equal(got.gradient(u), want.gradient(u))
    np.testing.assert_array_equal(got.coords(50), want.coords(50))


@pytest.mark.parametrize("scen", TEST_SCENARIOS)
def test_build_test_scenario_matches_jax(scen):
    cfg = EnvConfig(scenario=scen)
    got = scenarios.build_test_scenario(cfg)
    want = jscen.build_test_scenario(_jax_cfg(cfg))
    assert want.obs_half_wh is None and got.n_wps == want.n_wps
    for k in ("wps", "obs_xy", "obs_r", "obs_mask", "spawn_rect"):
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def test_box_scenario_is_not_ported():
    """`parallel_boxes` is ported now: built array for array as in JAX, box
    half-extents included; test mode still refuses a stage scenario and
    an unknown mode."""
    cfg = EnvConfig(mode="test", scenario="parallel_boxes")
    got = scenarios.build_test_scenario(cfg)
    want = jscen.build_test_scenario(_jax_cfg(cfg))
    for k in ("wps", "obs_xy", "obs_r", "obs_mask", "spawn_rect", "obs_half_wh"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k), err_msg=k)
    env = Drone2DEnv(cfg.replace(path_table_n=128), device="cpu")
    state, obs = env.reset_batch(torch.Generator().manual_seed(0), 4)
    assert state.obstacles.half_wh.shape == (4, cfg.max_obs, 2)
    assert bool(torch.isfinite(obs).all())
    for kw in (dict(mode="test", scenario="stage_2"), dict(mode="replay")):
        with pytest.raises(ValueError):
            Drone2DEnv(EnvConfig(**kw), device="cpu")
        with pytest.raises(ValueError):
            jenv.Drone2DEnv(JEnvConfig(**kw))


@pytest.mark.parametrize("scen", ["perpendicular", "S_corridor", "large"])
def test_test_mode_reset_matches_jax(scen):
    """Every env gets the scenario's path (tables as in
    test_reset_path_and_observation_match_jax) and obstacles, a spawn in
    the scenario's rectangle, an angle in +-pi/4 and family 0; the first
    observation is the JAX package's `_observe` of that state, to the
    bounds of tests/test_torch_env.py."""
    cfg = EnvConfig(mode="test", scenario=scen)
    jcfg = _jax_cfg(cfg)
    env = Drone2DEnv(cfg, device="cpu")
    n = 512
    state, obs = env.reset_batch(torch.Generator().manual_seed(0), n)
    jax_env = jenv.Drone2DEnv(jcfg)
    jpd, jobst = jax_env._test_path, jax_env._test_obstacles
    for k in ("us", "centers", "length", "coef_x", "coef_y", "wps", "n_wps"):
        got = _np(getattr(state.path, k))
        np.testing.assert_array_equal(got, np.broadcast_to(getattr(jpd, k), got.shape), err_msg=k)
    for k in ("table_u", "table_x", "table_y"):
        got = _np(getattr(state.path, k))
        np.testing.assert_allclose(got, np.broadcast_to(getattr(jpd, k), got.shape),
                                   rtol=1e-5, atol=2e-3, err_msg=k)
    for k in ("xy", "r", "mask"):
        got = _np(getattr(state.obstacles, k))
        np.testing.assert_array_equal(got, np.broadcast_to(getattr(jobst, k), got.shape))
    xmin, ymin, xmax, ymax = np.asarray(jax_env._spawn_rect)
    pos = _np(state.body.pos)
    assert ((pos >= [xmin, ymin]) & (pos <= [xmax, ymax])).all()
    # uniform in the rectangle: means within 5 sigma
    for lo, hi, x in ((xmin, xmax, pos[:, 0]), (ymin, ymax, pos[:, 1])):
        assert abs(x.mean() - (lo + hi) / 2) <= 5 * (hi - lo) / np.sqrt(12 * n)
    assert np.abs(_np(state.body.angle)).max() <= np.pi / 4
    assert not state.family.any() and not state.t.any()
    np.testing.assert_array_equal(_np(state.target), np.broadcast_to(
        jpd.wps[int(jpd.n_wps) - 1], (n, 2)))
    # JAX's first observation of the same state, env by env
    flat = env_state_to_numpy(state)
    jobs, jlock = jax.vmap(lambda p, t, a: jenv._observe(
        jcfg, jpd, jobst, JBodyState(pos=p, vel=jnp.zeros(2), angle=a, omega=jnp.float32(0.0)),
        t, jnp.asarray(False)))(flat["body.pos"], flat["target"], flat["body.angle"])
    _assert_obs_close(_np(obs), np.asarray(jobs))
    np.testing.assert_array_equal(_np(state.la_locked), np.asarray(jlock))


# -- the episode runner against JAX's _episode_runner ------------------------

CAP, N_EP = 64, 24
# the random policy's tumbles end episodes at many steps before the cap
RUNNER_CASES = [(s, p) for s in ("S_corridor", "stage_5")
                for p in ("stochastic", "deterministic")] + [("stage_5", "random"),
                                                             ("parallel_boxes", "stochastic")]


@pytest.fixture(scope="module")
def jax_campaigns():
    """JAX's runner for each case at a 64-step cap, with its reset states
    and noise reproduced from its episode keys."""
    flat = dict(np.load(AGENT))
    params = jax_from_flat(flat)
    out = {}
    for i, (scen, policy) in enumerate(RUNNER_CASES):
        cfg = run.scenario_config(scen).replace(n_steps=CAP, path_table_n=128)
        jcfg = _jax_cfg(cfg)
        det, rand = policy == "deterministic", policy == "random"
        one = jepisode._episode_runner(jcfg, rand, det, 0)
        keys = jax.random.split(jax.random.PRNGKey(40 + i), N_EP)
        metrics, traj, angles, length = jax.jit(jax.vmap(one, in_axes=(None, 0)))(params, keys)
        want = jepisode._to_results(metrics, traj, angles, length)
        jax_env = jenv.Drone2DEnv(jcfg)

        def draws(key):
            k_reset, k_policy = jax.random.split(key)
            state, obs = jax_env.reset(k_reset, 0)
            draw = ((lambda k: jax.random.uniform(k, (2,), minval=-1.0, maxval=1.0)) if rand
                    else (lambda k: jax.random.normal(k, (2,))))
            noise = jax.vmap(draw)(jax.random.split(k_policy, CAP))
            return state, obs, noise

        state, obs, noise = jax.jit(jax.vmap(draws))(keys)
        out[(scen, policy)] = dict(
            cfg=cfg, want=want, state=jax.tree.map(np.asarray, state), obs=np.asarray(obs),
            noise=np.asarray(noise).transpose(1, 0, 2), flat=flat)
    return out


def _scale_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(1.0, np.abs(want).max())


# Latched flags and lengths exactly.  APE, return, trajectories and angles
# to 1e-4 of scale (max(1, max |ref|); the screen's 1300 px; pi): each
# episode is a closed loop of a steep policy, so rounding-level differences
# grow over the 64 steps (measured at most 2.0e-5 in APE, 1.1e-5 in return
# and 1.5e-5 in angle, at stage_5).
RUNNER_TOL = 1e-4


@pytest.mark.parametrize("scen, policy", RUNNER_CASES)
def test_run_episodes_from_matches_jax(jax_campaigns, scen, policy):
    case = jax_campaigns[(scen, policy)]
    env = Drone2DEnv(case["cfg"], device="cpu")
    params = flat_dict_to_params(case["flat"], device="cpu")
    got = episode.run_episodes_from(
        env, None if policy == "random" else params,
        env_state_from_numpy(case["state"], device="cpu"),
        torch.tensor(case["obs"]), torch.tensor(case["noise"]),
        deterministic=policy == "deterministic")
    want = case["want"]
    for k in ("success", "fail", "collision", "time_steps", "traj_len"):
        g, w = getattr(got, k), getattr(want, k)
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)
    for k in ("ape", "total_reward"):
        assert _scale_err(getattr(got, k), getattr(want, k)) <= RUNNER_TOL, k
    assert got.traj.shape == want.traj.shape == (N_EP, CAP, 2)
    assert np.abs(got.traj - want.traj).max() <= RUNNER_TOL * 1300.0
    assert np.abs(got.angles - want.angles).max() <= RUNNER_TOL * np.pi
    assert want.fail.any()
    if policy == "random":
        assert (want.time_steps < CAP).sum() >= 3


def test_random_policy_draws_are_the_actions():
    """With no params the draws are the actions: the runner's random policy
    equals the deterministic core fed the same uniform draws."""
    cfg = run.scenario_config("stage_2").replace(n_steps=16, path_table_n=128)
    got = episode.run_episodes(cfg, None, 3, 8, device="cpu")
    env = Drone2DEnv(cfg, device="cpu")
    gen = torch.Generator().manual_seed(3)
    state, obs = env.reset_batch(gen, 8)
    draws = 2.0 * torch.rand((16, 8, 2), generator=gen) - 1.0
    want = episode.run_episodes_from(env, None, state, obs, draws)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def _scripted(cap):
    """Five stage-1 envs: 0 spawned 5 px from its target (a reach-end on
    step 1), 1 inside a circle (a collision on step 1), 2 and 3 flying
    free, 4 started past the cap (t = cap, so the step-cap end never fires:
    the timeout fix-up)."""
    cfg = EnvConfig(scenario="stage_1", n_steps=cap, path_table_n=128)
    env = Drone2DEnv(cfg, device="cpu")
    state, obs = env.reset_batch(torch.Generator().manual_seed(1), 5)
    pos = state.body.pos.clone()
    pos[0] = state.target[0] + 5.0
    xy, r, mask = (x.clone() for x in (state.obstacles.xy, state.obstacles.r,
                                       state.obstacles.mask))
    xy[1, 0], r[1, 0], mask[1, 0] = pos[1], 30.0, True
    t = state.t.clone()
    t[4] = cap
    state = dataclasses.replace(
        state, body=dataclasses.replace(state.body, pos=pos), t=t,
        obstacles=dataclasses.replace(state.obstacles, xy=xy, r=r, mask=mask))
    return env, state, obs


def test_latch_coast_and_timeout_scripted(monkeypatch):
    """Hand-checked outcomes of the latch: the first done's metrics, frozen
    positions after it, traj_len counting the live steps, the timeout
    fix-up, and both flags on a step where reach-end and the cap coincide.
    The early stop gives what a run to the cap gives."""
    cap = 12
    env, state, obs = _scripted(cap)
    draws = torch.zeros((cap, 5, 2))  # hover-ish zero thrust for the free envs
    res = episode.run_episodes_from(env, None, state, obs, draws)
    np.testing.assert_array_equal(res.success, [True, False, False, False, False])
    np.testing.assert_array_equal(res.fail, [False, True, True, True, True])
    np.testing.assert_array_equal(res.collision, [0, 1, 0, 0, 0])
    assert res.time_steps[0] == 1 and res.time_steps[1] == 1
    assert res.traj_len[0] == 1 and res.traj_len[1] == 1
    # coasting: every recorded position after the done repeats the last one
    for i in (0, 1):
        assert (res.traj[i, 1:] == res.traj[i, :1]).all()
        assert (res.angles[i, 1:] == res.angles[i, :1]).all()
    # envs 2 and 3 run to the cap (or fall out of bounds first)
    assert (res.traj_len[2:4] == res.time_steps[2:4]).all()
    # env 4 never ends: timeout -> fail, its length the cap, APE its mean
    # path error over the cap, its return the state's
    assert res.time_steps[4] == cap and res.traj_len[4] == cap and res.fail[4]
    out = state
    for t in range(cap):
        out = env.step(out, draws[t]).state
    np.testing.assert_allclose(res.ape[4], float(out.path_error[4]) / cap, rtol=1e-6)
    np.testing.assert_allclose(res.total_reward[4], float(out.total_reward[4]), rtol=1e-6)

    # the early stop (every CHECK_EVERY steps, once all have latched) gives
    # the run to the cap; opposite full thrusts tumble the free drones past
    # the aggressive-angle limit long before it
    env, state, obs = _scripted(100)
    state.t[4] = 0
    draws = torch.tensor([1.0, -1.0]).expand(100, 5, 2).contiguous()
    steps = []
    step = Drone2DEnv.step  # the runner steps an env of its own: count every env's steps
    monkeypatch.setattr(Drone2DEnv, "step",
                        lambda self, s, a: (steps.append(1), step(self, s, a))[1])
    monkeypatch.setattr(episode, "CHECK_EVERY", 8)
    early = episode.run_episodes_from(env, None, state, obs, draws)
    n_early = len(steps)
    monkeypatch.setattr(episode, "CHECK_EVERY", 10**6)
    full = episode.run_episodes_from(env, None, state, obs, draws)
    for a, b in zip(early, full):
        np.testing.assert_array_equal(a, b)
    assert n_early < 100 and len(steps) - n_early == 100
    assert n_early == 8 * -(-int(full.time_steps.max()) // 8)

    # reach-end and the cap on one step latch success and fail both
    env, state, obs = _scripted(1)
    res = episode.run_episodes_from(env, None, state, obs, torch.zeros((1, 5, 2)))
    assert res.success[0] and res.fail[0] and res.time_steps[0] == 1


# -- artifacts, names, scenario configs and the CLI --------------------------


def _results(n=5, t=7, seed=0):
    rng = np.random.default_rng(seed)
    return episode.EpisodeResults(
        success=rng.random(n) < 0.5, fail=rng.random(n) < 0.5,
        collision=rng.integers(0, 2, n).astype(np.int32),
        ape=rng.uniform(0, 100, n).astype(np.float32),
        time_steps=rng.integers(1, t + 1, n).astype(np.int32),
        total_reward=rng.normal(0, 50, n).astype(np.float32),
        traj=rng.uniform(0, 1300, (n, t, 2)).astype(np.float32),
        angles=rng.uniform(-1, 1, (n, t)).astype(np.float32),
        traj_len=rng.integers(1, t + 1, n).astype(np.int32))


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            out[os.path.relpath(os.path.join(d, f), root)] = os.path.join(d, f)
    return out


def test_write_campaign_matches_jax(tmp_path):
    """The same results through both writers, three campaigns (a stage
    scenario twice, which starts test_1, then a spatial one, which joins
    test_1): the same files with the same text and arrays, and the same
    overlay PNG, pixel for pixel; then a spatial campaign with a GIF
    directory: both write the GIF, with as many frames."""
    roots = {"port": str(tmp_path / "port"), "jax": str(tmp_path / "jax")}
    for i, scen in enumerate(("stage_3", "stage_3", "corridor")):
        res = _results(seed=i)
        cfg = run.scenario_config(scen)
        kw = dict(agent="agent_s8004", agent_path="artifacts/agent_s8004/new_agent.npz",
                  scenario=scen)
        artifacts.write_campaign(cfg, res, root=roots["port"], gif_root=None, **kw)
        jartifacts.write_campaign(_jax_cfg(cfg), jepisode.EpisodeResults(*res),
                                  root=roots["jax"], gif_root=None, **kw)
    got, want = _tree(roots["port"]), _tree(roots["jax"])
    assert set(got) == set(want)
    assert "agent_s8004/test_1/corridor/corridor_s8004_results.txt" in got
    assert "agent_s8004/test_1/plots/corridor_s8004.png" in got
    for rel, path in got.items():
        if rel.endswith(".png"):
            np.testing.assert_array_equal(imageio.imread(path), imageio.imread(want[rel]))
        elif rel.endswith(".npy"):
            a, b = np.load(path), np.load(want[rel])
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        else:
            with open(path) as f, open(want[rel]) as g:
                assert f.read() == g.read(), rel
    res = _results(seed=3)
    gifs = {k: str(tmp_path / f"gif_{k}") for k in roots}
    artifacts.write_campaign(run.scenario_config("corridor"), res, root=roots["port"],
                             gif_root=gifs["port"], gif_episode=1, **kw)
    jartifacts.write_campaign(_jax_cfg(run.scenario_config("corridor")),
                              jepisode.EpisodeResults(*res), root=roots["jax"],
                              gif_root=gifs["jax"], gif_episode=1, **kw)
    frames = {k: imageio.mimread(os.path.join(g, "agent_s8004", "corridor.gif"))
              for k, g in gifs.items()}
    assert len(frames["port"]) == len(frames["jax"]) == len(range(0, int(res.traj_len[1]), 2))


def test_agent_names_and_scenario_configs_match_jax():
    for path in ("artifacts/agent_s8004/new_agent.npz", "runs/agent_12.npz", "agent-7",
                 "logs/new_agent.npz", "logs/ckpt/", "x/agent_s6006", ""):
        assert run._derive_agent_name(path) == jrun._derive_agent_name(path), path
    for scen in ALL_SCENARIOS + EXTRA_SCENARIOS:
        got, want = run.scenario_config(scen), jrun.scenario_config(scen)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), scen
    for mod in (run, jrun):
        with pytest.raises(ValueError, match="unknown scenario"):
            mod.scenario_config("stage_6")


def test_eval_cli_on_cpu(tmp_path, capsys, monkeypatch):
    """4 episodes of a stage scenario and of a spatial one through the CLI;
    the random baseline; params from the port's checkpoint directory equal
    the .npz's; a spatial scenario with the defaults writes the overlay PNG
    and one episode's GIF under --gif-root, and --gif-all a GIF of every
    episode (those two at a 24-step cap, so that the GIFs stay short)."""
    out = str(tmp_path / "Tests")
    base = ["--device", "cpu", "--episodes", "4", "--out-root", out]
    run.main([*base, "--agent", AGENT, "--scenario", "stage_4"])
    run.main([*base, "--agent", AGENT, "--scenario", "corridor", "--no-gif"])
    run.main([*base, "--agent", "random", "--scenario", "stage_2", "--agent-name", "rnd"])
    printed = capsys.readouterr().out
    assert printed.count(" SR ") == 3
    files = _tree(out)
    for scen in ("stage_4", "corridor"):
        for f in ("flight_paths", "collisions.npy", "rewards.npy", "apes.npy",
                  "time_spent.npy", f"{scen}_new_agent_results.txt"):
            assert f"new_agent/test_0/{scen}/{f}" in files, (scen, f)
    with open(files["new_agent/test_0/corridor/flight_paths"]) as f:
        paths = json.load(f)
    assert len(paths) == 4 and all(len(p) > 0 for p in paths)
    assert np.load(files["new_agent/test_0/corridor/time_spent.npy"]).shape == (4,)
    assert "rnd/test_0/stage_2/stage_2_rnd_results.txt" in files
    # --no-gif drops the GIF only: the spatial scenario has its overlay plot
    assert "new_agent/test_0/plots/corridor_new_agent.png" in files
    assert not os.path.exists("Gifs")
    cap = 24
    config = run.scenario_config
    monkeypatch.setattr(run, "scenario_config",
                        lambda s, base=None: config(s, base).replace(n_steps=cap))
    gifs = tmp_path / "Gifs"
    run.main([*base, "--agent", AGENT, "--scenario", "corridor", "--gif-root", str(gifs)])
    run.main([*base, "--agent", AGENT, "--scenario", "parallel_boxes", "--gif-root", str(gifs),
              "--gif-all"])
    files = _tree(out)
    for scen in ("corridor", "parallel_boxes"):  # test_1: corridor had a test_0
        png = imageio.imread(files[f"new_agent/test_1/plots/{scen}_new_agent.png"])
        assert png.shape[:2] == (1300, 1300)
    one = imageio.mimread(gifs / "new_agent" / "corridor.gif")
    every = imageio.mimread(gifs / "new_agent" / "parallel_boxes.gif")
    assert len(one) == cap // 2 and len(every) == 4 * cap // 2

    learner = PPOLearner(EnvConfig(path_table_n=128), PPOConfig(hidden_sizes=(128, 128)), 4,
                         device="cpu")
    agent = run.load_params(AGENT, device="cpu")
    save_checkpoint(str(tmp_path / "ckpt"), learner.init(0, params=agent))
    a, b = run.load_params(str(tmp_path / "ckpt"), device="cpu"), agent
    for x, y in zip(a.parameters(), b.parameters()):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert run.load_params("random") is None
    with pytest.raises(FileNotFoundError):
        run.load_params(str(tmp_path / "ckpt"), step=123)

"""The port's gym surface and SB3 import against the JAX package, on the CPU.

The cases of tests/test_compat.py run on the port's adapters (`device="cpu"`);
the vector env's step is held against JAX's `device_step` on identical state,
templates and actions, and a sequence of steps against JAX's vector env;
its template refresh is counted.  Both adapters' steps run their step
graph's body (called directly on the CPU), one graph across resets, bit
for bit the eager step.  SB3 zips are built from the shipped
agent files (`save_sb3_zip`, weights transposed to (out, in)) and imported
by both packages; the import CLI's `.npz` loads through the JAX package.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from drone2d_tpu.compat import sb3_import as jsb3
from drone2d_tpu.compat.vector_env import Drone2dVectorEnv as JVectorEnv
from drone2d_tpu.eval.run import load_params as jax_load_params
from drone2d_tpu.models.policy import params_to_flat_dict as jax_to_flat
from drone2d_tpu_torch.compat import Drone2dGymEnv, Drone2dVectorEnv, make, register_gym_envs
from drone2d_tpu_torch.compat import sb3_import
from drone2d_tpu_torch.compat.from_jax import env_state_from_numpy, flatten_fields
from drone2d_tpu_torch.compat.vector_env import VectorEnvCore
from drone2d_tpu_torch.models.policy import params_to_flat_dict
from drone2d_tpu_torch.utils import graphs
from tests.test_torch_env import _assert_obs_close

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
AGENTS = {"agent_17_90": os.path.join(ROOT, "artifacts", "imported", "agent_17_90.npz"),
          "agent_s8004": os.path.join(ROOT, "artifacts", "agent_s8004", "new_agent.npz")}
SMALL = dict(path_table_n=128, device="cpu")


# -- the single env: tests/test_compat.py on the port ----------------------------


@pytest.fixture(scope="module")
def env():
    return make("large", n_steps=64, **SMALL)


def test_spaces(env):
    assert env.observation_space.shape == (27,)
    assert env.action_space.shape == (2,)
    assert env.action_space.contains(env.action_space.sample())


def test_reset_step_cycle(env):
    obs = env.reset()
    assert obs.shape == (27,) and obs.dtype == np.float32
    # the target deltas (4, 5) may leave the Box, as the reference's
    # unclipped m1to1 does (drone_2d_env.py:648-649)
    assert np.all(np.delete(np.abs(obs), [4, 5]) <= 1.0 + 1e-5)
    total = 0.0
    for _ in range(5):
        obs, reward, done, info = env.step([0.0, 0.0])
        total += reward
        assert obs.shape == (27,) and obs.dtype == np.float32
        assert isinstance(reward, float) and isinstance(done, bool)
        for k in ("reward", "env_steps", "APE", "n_collisions", "n_successful_runs",
                  "n_failed_runs", "total_reward", "terminal"):
            assert k in info, k
        assert isinstance(info["env_steps"], int) and isinstance(info["APE"], float)
    assert np.isfinite(total) and info["env_steps"] == 5 and reward == info["reward"]


def test_runs_episode_to_done(env):
    env.seed(3)
    env.reset()
    for t in range(64):
        obs, reward, done, info = env.step([-1.0, -1.0])  # free fall
        if done:
            break
    assert done and info["env_steps"] == t + 1


def test_rgb_render(env):
    env.reset()
    env.step([0.0, 0.0])
    frame = env.render(mode="rgb_array")
    assert frame.shape == (int(env.cfg.screensize_y), int(env.cfg.screensize_x), 3)
    assert frame.dtype == np.uint8
    # the human mode blits to a headless display
    assert env.render() is None
    env.close()


def test_gymnasium_five_tuple(env):
    obs, info = env.reset_seeded(seed=5)
    assert obs.shape == (27,) and info == {}
    obs, reward, terminated, truncated, info = env.step_gymnasium([0.0, 0.0])
    assert isinstance(terminated, bool) and isinstance(truncated, bool)


def test_seed_repeats_the_episode():
    a, b = make("stage_3", **SMALL), make("stage_3", **SMALL)
    a.seed(7)
    b.seed(7)
    np.testing.assert_array_equal(a.reset(), b.reset())
    np.testing.assert_array_equal(a.step([0.3, -0.2])[0], b.step([0.3, -0.2])[0])


def test_curriculum_mode_default():
    env = make(n_steps=32, **SMALL)
    assert env.cfg.mode == "curriculum"
    assert env.reset().shape == (27,)
    env.step(env.action_space.sample())
    frame = env.render("rgb_array")  # the episode's own path and obstacles
    assert frame.shape[2] == 3


def test_step_before_reset_raises():
    with pytest.raises(RuntimeError):
        make("large", **SMALL).step([0.0, 0.0])


def test_truncated_only_on_step_cap():
    """The step-cap end reports truncated, a real end (here the aggressive
    angle) terminated: from the env's `terminal` flag."""
    env = make("large", n_steps=5, **SMALL)
    env.reset_seeded(seed=0)
    for _ in range(5):
        obs, r, terminated, truncated, info = env.step_gymnasium([0.0, 0.0])
    assert truncated and not terminated

    env2 = make("large", n_steps=500, **SMALL)
    env2.reset_seeded(seed=0)
    for _ in range(200):
        obs, r, terminated, truncated, info = env2.step_gymnasium([1.0, -1.0])
        if terminated or truncated:
            break
    assert terminated and not truncated


def test_gym_env_step_matches_the_batched_env():
    """The adapter's step is the port's env step of a batch of one."""
    gym_env = make("S_corridor", **SMALL)
    gym_env.reset_seeded(seed=2)
    state = gym_env._state
    obs, reward, done, info = gym_env.step([0.5, -0.25])
    out = gym_env._env.step(state, torch.tensor([[0.5, -0.25]]))
    np.testing.assert_array_equal(obs, out.obs[0].numpy())
    assert reward == float(out.reward[0]) and done == bool(out.done[0])
    for k, v in out.info.items():
        assert info[k] == v.item(), k


def _count_calls(graph):
    """Count the calls of a graph's body from now on."""
    calls, body = [], graph.body
    graph.body = lambda: calls.append(1) or body()
    return calls


def test_gym_steps_run_one_step_graph():
    """`step`, `step_gymnasium` and the gymnasium wrapper's `step` all run
    the one step graph (its body called directly on the CPU), which a reset
    keeps; each step bit-equal to the eager env step of the batch of one
    with the action clipped, from the same state."""
    gym = pytest.importorskip("gymnasium")
    register_gym_envs()
    wrapped = gym.make("drone2d_tpu_torch/S_corridor-v0", **SMALL)
    env = wrapped.unwrapped._e
    wrapped.reset(seed=2)
    state = env._state
    actions = [[0.5, -0.25], [0.1, 0.2], [-1.5, 2.0], [0.3, 0.0]]
    got = [env.step(actions[0])[0]]
    graph = env._step.graph
    assert isinstance(graph, graphs.Graph) and graph.eager and graph.graph is None
    calls = _count_calls(graph)
    got.append(env.step_gymnasium(actions[1])[0])
    got.append(wrapped.step(np.asarray(actions[2], np.float32))[0])
    for a, obs in zip(actions, got):
        out = env._env.step(state, torch.tensor([a]).clamp(-1.0, 1.0))
        np.testing.assert_array_equal(obs, out.obs[0].numpy())
        state = out.state
    wrapped.reset(seed=3)
    env.step(actions[3])
    assert env._step.graph is graph and len(calls) == 3


def test_vector_steps_run_one_step_graph(jax_vector):
    """The core's steps from JAX's state and templates run its step graph
    (the body called directly on the CPU), made at the first step and kept
    by a reset and a template refresh: each step bit-equal to the eager
    `device_step` chain, and within the tolerances of the test below of
    JAX's vector env."""
    core = _core_from(jax_vector)
    state, prev_done = core._state, core._prev_done
    calls = None
    for t, (a, want) in enumerate(zip(jax_vector["actions"], jax_vector["outs"])):
        got = core.step(a)
        if calls is None:
            graph = core._step.graph
            assert isinstance(graph, graphs.Graph) and graph.eager
            calls = _count_calls(graph)
        ref = core.device_step(state, prev_done, torch.as_tensor(a), *core._templates)
        state, prev_done = ref[0], ref[3] | ref[4]
        np.testing.assert_array_equal(got[0], ref[1].numpy())
        np.testing.assert_array_equal(got[1], ref[2].numpy())
        np.testing.assert_array_equal(got[2] | got[3], prev_done.numpy())
        _assert_obs_close(got[0], want[0])
        np.testing.assert_allclose(got[1], want[1], rtol=1e-4, atol=3e-3)
    for g, w in zip(graphs.leaves(core._state), graphs.leaves(state)):
        assert (g is None and w is None) or torch.equal(g, w)
    core.reset(seed=1)
    core.step(jax_vector["actions"][0])
    assert core._step.graph is graph and len(calls) == len(jax_vector["actions"])


def test_gym_registration():
    g = pytest.importorskip("gymnasium")
    ids = register_gym_envs()
    assert "drone2d_tpu_torch/corridor-v0" in ids or "drone2d_tpu_torch/corridor-v0" in g.registry
    assert register_gym_envs() == []  # already registered
    env = g.make("drone2d_tpu_torch/corridor-v0", n_steps=16, **SMALL)
    obs, info = env.reset(seed=0)
    assert obs.shape == (27,)
    obs, reward, terminated, truncated, info = env.step(np.zeros(2, np.float32))
    assert isinstance(reward, float)
    assert env.render().shape == (1300, 1300, 3)
    env.close()
    # both packages register side by side
    from drone2d_tpu.compat import register_gym_envs as jax_register

    jax_register()
    assert "drone2d_tpu/corridor-v0" in g.registry and "drone2d_tpu_torch/corridor-v0" in g.registry


# -- the vector env ---------------------------------------------------------------


def test_vector_env_step_and_autoreset():
    """gymnasium's VectorEnv surface with NEXT_STEP autoreset: an env that is
    truncated gives (reset obs, reward 0, not done) on the next step, with
    its info masked out."""
    gym = pytest.importorskip("gymnasium")
    n = 4
    env = Drone2dVectorEnv(num_envs=n, scenario="large", n_steps=5, **SMALL)
    assert env.metadata["autoreset_mode"] is gym.vector.AutoresetMode.NEXT_STEP
    assert env.single_observation_space.shape == (27,)
    assert env.observation_space.shape == (n, 27)

    obs, infos = env.reset(seed=0)
    assert obs.shape == (n, 27) and obs.dtype == np.float32
    actions = np.zeros((n, 2), np.float32)
    for _ in range(5):
        obs, reward, terminated, truncated, infos = env.step(actions)
        assert obs.shape == (n, 27) and reward.shape == (n,) and reward.dtype == np.float32
        assert terminated.dtype == bool and truncated.dtype == bool
        assert not np.any(terminated & truncated)
        assert "APE" in infos and "_APE" in infos and infos["env_steps"].dtype == np.int32
    assert np.all(truncated) and not np.any(terminated)
    tmpl_obs = env._templates[1].numpy()
    obs2, reward2, terminated2, truncated2, infos2 = env.step(actions)
    assert np.all(reward2 == 0.0) and not np.any(terminated2 | truncated2)
    assert not np.any(infos2["_APE"])
    np.testing.assert_array_equal(obs2, tmpl_obs)
    env.close()
    assert env.closed


def test_vector_env_via_make_vec():
    gym = pytest.importorskip("gymnasium")
    register_gym_envs()
    env = gym.make_vec("drone2d_tpu_torch/corridor-v0", num_envs=3, n_steps=8, **SMALL)
    assert isinstance(env.unwrapped, Drone2dVectorEnv)
    assert env.num_envs == 3
    obs, _ = env.reset(seed=1)
    assert obs.shape == (3, 27)
    obs, reward, terminated, truncated, infos = env.step(np.zeros((3, 2)))
    assert reward.shape == (3,)
    env.close()


@pytest.fixture(scope="module")
def jax_vector():
    """JAX's vector env at a 6-step cap on stage 5 (collisions and the cap
    both end episodes), its state, templates and a sequence of actions."""
    n, steps = 32, 14
    jv = JVectorEnv(num_envs=n, scenario="stage_5", path_table_n=128, n_steps=6,
                    template_refresh_steps=10**6)
    jv.reset(seed=3)
    jv._key, k = jax.random.split(jv._key)
    jv._templates = jv._device_reset(k, np.float32(0.0))
    rng = np.random.default_rng(5)
    actions = np.clip(rng.normal(0.2, 0.6, (steps, n, 2)), -1.2, 1.2).astype(np.float32)
    start = (jax.tree.map(np.asarray, jv._state), jax.tree.map(np.asarray, jv._templates))
    outs = [jv.step(a) for a in actions]
    return dict(n=n, start=start, actions=actions, outs=outs, device_step=jv._device_step)


def _core_from(jax_vector, **kw):
    state, (tstate, tobs) = jax_vector["start"]
    tobs = np.array(tobs)
    core = VectorEnvCore(num_envs=jax_vector["n"], scenario="stage_5", n_steps=6,
                         template_refresh_steps=10**6, **SMALL, **kw)
    core.start_from(env_state_from_numpy(state, "cpu"),
                    (env_state_from_numpy(tstate, "cpu"), torch.as_tensor(tobs)))
    return core


def test_vector_device_step_matches_jax(jax_vector):
    """The core's device_step against JAX's on identical state, prev_done,
    actions and templates: obs, reward, flags, info and the next state."""
    state, (tstate, tobs) = jax_vector["start"]
    n = jax_vector["n"]
    prev_done = np.arange(n) % 3 == 0
    a = jax_vector["actions"][0]
    want = jax_vector["device_step"](state, prev_done, a, tstate, tobs)
    core = _core_from(jax_vector)
    got = core.device_step(env_state_from_numpy(state, "cpu"), torch.as_tensor(prev_done),
                           torch.as_tensor(a), env_state_from_numpy(tstate, "cpu"),
                           torch.as_tensor(np.array(tobs)))
    _assert_obs_close(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[1].numpy()[prev_done], np.asarray(tobs)[prev_done])
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-4, atol=3e-3)
    assert (got[2].numpy()[prev_done] == 0).all()
    for g, w in zip(got[3:5], want[3:5]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for k, v in got[5].items():
        w = np.asarray(want[5][k])
        if w.dtype.kind in "iub":
            np.testing.assert_array_equal(v.numpy(), w, err_msg=k)
    wflat = flatten_fields(want[0])
    for k, g in flatten_fields(got[0]).items():
        if wflat[k].dtype.kind in "iub":
            np.testing.assert_array_equal(g, wflat[k], err_msg=k)
        else:
            np.testing.assert_allclose(g, wflat[k], rtol=1e-5, atol=3e-3, err_msg=k)


def test_vector_steps_match_jax(jax_vector):
    """14 steps of the core and of JAX's vector env from the same state and
    templates: the same ends, resets and info masks on every step."""
    core = _core_from(jax_vector)
    ends = 0
    for a, want in zip(jax_vector["actions"], jax_vector["outs"]):
        got = core.step(a)
        _assert_obs_close(got[0], want[0])
        np.testing.assert_allclose(got[1], want[1], rtol=1e-4, atol=3e-3)
        for g, w in zip(got[2:4], want[2:4]):
            np.testing.assert_array_equal(g, w)
        assert set(got[4]) == set(want[4])
        np.testing.assert_array_equal(got[4]["_APE"], want[4]["_APE"])
        np.testing.assert_array_equal(got[4]["n_collisions"], want[4]["n_collisions"])
        ends += int((got[2] | got[3]).sum())
    assert ends >= jax_vector["n"]  # the cap alone ends each env twice


@pytest.mark.parametrize("refresh, draws", [(4, 4), (0, 2), (10**6, 1)])
def test_template_refresh(refresh, draws):
    """Templates are drawn on the first step, then every `refresh` steps,
    or, with 0, on each step that follows an end: hovering, every env hits
    the 6-step cap on step 6 and resets on step 7 (and ends again on 13)."""
    core = VectorEnvCore(num_envs=8, scenario="large", n_steps=6,
                         template_refresh_steps=refresh, **SMALL)
    core.reset(seed=0)
    calls = []
    reset_batch = core._env.reset_batch
    core._env.reset_batch = lambda *a, **k: calls.append(1) or reset_batch(*a, **k)
    for t in range(13):
        _, _, terminated, truncated, _ = core.step(np.zeros((8, 2), np.float32))
        assert (terminated | truncated).all() == (t in (5, 12))
    assert len(calls) == draws


def test_vector_core_needs_no_gymnasium():
    """Importing the compat package, eval.run and eval.artifacts loads no
    gymnasium and no pygame, and the core steps without them."""
    code = (
        "import sys\n"
        "import drone2d_tpu_torch.compat, drone2d_tpu_torch.eval.run\n"
        "import drone2d_tpu_torch.eval.artifacts\n"
        "from drone2d_tpu_torch.compat.vector_env import VectorEnvCore\n"
        "c = VectorEnvCore(4, scenario='large', path_table_n=128, device='cpu')\n"
        "c.reset(seed=0); c.step([[0.0, 0.0]] * 4)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('gymnasium', 'gym', 'pygame')]\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


# -- SB3 import -------------------------------------------------------------------


@pytest.fixture(scope="module")
def sb3_zips(tmp_path_factory):
    d = tmp_path_factory.mktemp("sb3")
    out = {}
    for name, path in AGENTS.items():
        out[name] = str(d / f"{name}.zip")
        sb3_import.save_sb3_zip(dict(np.load(path)), out[name])
    return out


@pytest.mark.parametrize("name", sorted(AGENTS))
def test_sb3_import_matches_jax(sb3_zips, name):
    """Both packages read the zip into the same state dict and the same
    leaves, equal to the agent file's, at H = 64 and H = 128."""
    sd = sb3_import.load_sb3_state_dict(sb3_zips[name])
    jsd = jsb3.load_sb3_state_dict(sb3_zips[name])
    assert sorted(sd) == sorted(jsd)
    for k in sd:
        np.testing.assert_array_equal(sd[k], jsd[k])
    assert sd["mlp_extractor.policy_net.0.weight"].shape[0] == (64 if "17" in name else 128)
    got = params_to_flat_dict(sb3_import.params_from_state_dict(sd, device="cpu"))
    want = jax_to_flat(jsb3.params_from_state_dict(jsd))
    agent = dict(np.load(AGENTS[name]))
    assert sorted(got) == sorted(want) == sorted(agent)
    for k in got:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
        np.testing.assert_array_equal(got[k], agent[k], err_msg=k)
    params = sb3_import.load_sb3_agent(sb3_zips[name], device="cpu")
    assert params.log_std.device.type == "cpu"


@pytest.mark.parametrize("name", sorted(AGENTS))
def test_torch_policy_value_matches_jax_and_the_port(sb3_zips, name):
    sd = sb3_import.load_sb3_state_dict(sb3_zips[name])
    obs = np.random.default_rng(0).standard_normal((512, 27)).astype(np.float32)
    mean, value = sb3_import.torch_policy_value(sd, obs)
    jmean, jvalue = jsb3.torch_policy_value(sd, obs)
    np.testing.assert_array_equal(mean, jmean)
    np.testing.assert_array_equal(value, jvalue)
    params = sb3_import.params_from_state_dict(sd, device="cpu")
    with torch.no_grad():
        m, _, v = params.policy_value(torch.as_tensor(obs))
    for g, w in ((m.numpy(), mean), (v.numpy(), value)):  # to 1e-5 of scale
        assert np.abs(g - w).max() / max(1.0, np.abs(w).max()) < 1e-5


def test_sb3_import_cli(sb3_zips, tmp_path, capsys):
    """The CLI's --verify passes, and its .npz loads through the JAX
    package's load_params to the zip's weights."""
    out = str(tmp_path / "agents" / "agent_17_90.npz")
    sb3_import.main([sb3_zips["agent_17_90"], "--out", out, "--verify", "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "verify: max|mean diff|" in printed and f"wrote {out}" in printed
    loaded = jax_to_flat(jax_load_params(out))
    agent = dict(np.load(AGENTS["agent_17_90"]))
    assert sorted(loaded) == sorted(agent)
    for k, v in agent.items():
        np.testing.assert_array_equal(np.asarray(loaded[k]), v, err_msg=k)
    with pytest.raises(ValueError, match="policy_net"):
        sb3_import.params_from_state_dict({"log_std": np.zeros(2, np.float32)}, device="cpu")


def test_drone2d_gym_env_is_exported():
    from drone2d_tpu_torch import compat

    assert set(compat.__all__) == {"Drone2dGymEnv", "Drone2dVectorEnv", "make",
                                   "register_gym_envs"}
    assert isinstance(make(**SMALL), Drone2dGymEnv)

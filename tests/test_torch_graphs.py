"""The port's compiled programs on the CPU: `PPOLearner.update_jit` and the
chunked eval runner, whose bodies run on the card as CUDA graphs
(`drone2d_tpu_torch/utils/graphs.py`) and here directly, over the same
static buffers.

`update_jit` with the JAX update's own draws injected is held against the
JAX package's `update` over two consecutive updates (the second one catches
a stale or aliased static buffer), for one learner and for a population of
two, at the tolerances of `tests/test_torch_ppo.py::test_update_matches_jax`.
The chunked runner at a cap of 100 steps (a 64-step chunk and a 36-step
one) is held against `drone2d_tpu.eval.episode`'s runner as
`tests/test_torch_eval.py::test_run_episodes_from_matches_jax` holds it,
once with every episode over before the first check (the early exit) and
once to the cap.  Also: a returned state is the caller's, the graph
helpers' trees, cache and restore point, and Adam's state across devices.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drone2d_tpu.config import EnvConfig as JEnvConfig, PPOConfig as JPPOConfig
from drone2d_tpu.eval import episode as jepisode
from drone2d_tpu.env import env as jenv
from drone2d_tpu.learn import zoo as jzoo
from drone2d_tpu.learn.ppo import PPOLearner as JPPOLearner, TrainState as JTrainState
from drone2d_tpu.models.policy import (
    flat_dict_to_params as jax_from_flat,
    init_actor_critic as jax_init,
)
from drone2d_tpu_torch.compat.from_jax import env_state_from_numpy, zoo_state_from_numpy
from drone2d_tpu_torch.config import EnvConfig, PPOConfig
from drone2d_tpu_torch.env.env import Drone2DEnv
from drone2d_tpu_torch.env.types import cat_states
from drone2d_tpu_torch.eval import episode, run
from drone2d_tpu_torch.learn import optim
from drone2d_tpu_torch.learn.ppo import PPOLearner
from drone2d_tpu_torch.learn.zoo import ZooTrainer
from drone2d_tpu_torch.models.policy import ActorCritic, flat_dict_to_params
from drone2d_tpu_torch.utils import graphs
from tests.test_torch_ppo import (
    _assert_params_close,
    _jax_draws,
    _params_bound,
    _port_state,
)

torch.set_num_threads(1)

AGENT = os.path.join(os.path.dirname(__file__), "..", "artifacts", "agent_s8004",
                     "new_agent.npz")
N, T, HIDDEN, LR = 16, 8, (32, 32), 3e-4
ENV_KW = dict(path_table_n=128)
GLOBAL_STEP = 8e5  # curriculum stage 2: random spawns, no obstacles
CAP = JEnvConfig().n_steps
UPDATES = 2
# the metrics to 1e-4 of max(|value|, 1) and the counts exactly, as
# test_update_matches_jax holds one update
METRIC_TOL = 1e-4
COUNTS = ("episodes/episodes", "episodes/total", "global_step", "episodes/success_rate",
          "episodes/failure_rate")


def _ppo_kw():
    return dict(n_steps=T, num_minibatches=4, n_epochs=2, shuffle="timeperm",
                hidden_sizes=HIDDEN, learning_rate=LR)


def _near_cap(n):
    """Every other env 1..6 steps from the episode cap, so that episodes end
    (and auto-reset to the template) inside an 8-step rollout."""
    return np.where(np.arange(n) % 2 == 0, CAP - 1 - np.arange(n) % 6, 0).astype(np.int32)


def _port_draws(draws):
    reset_state, reset_obs, noise, perms = draws
    return (env_state_from_numpy(reset_state, device="cpu"), torch.tensor(reset_obs),
            torch.tensor(noise), torch.tensor(perms))


@pytest.fixture(scope="module")
def jax_single():
    """One JAX update from init gives a mid-training state at stage 2 with
    every other env near the cap; then UPDATES consecutive JAX updates from
    it, each with its draws reproduced from its key."""
    jl = JPPOLearner(JEnvConfig(**ENV_KW), JPPOConfig(**_ppo_kw()), N)
    update = jax.jit(jl.update)
    reset = jax.jit(jl.env.reset_batch, static_argnums=1)
    params = jax_init(jax.random.PRNGKey(0), 27, 2, HIDDEN)
    env_state, obs = reset(jax.random.PRNGKey(1), N, jnp.float32(0.0))
    state = JTrainState(
        params=params, opt_state=jl.tx.init(params), env_state=env_state, obs=obs,
        rng=jax.random.PRNGKey(2), global_step=jnp.float32(0.0),
        episodes_total=jnp.float32(0.0), rehearsal_probs=jnp.zeros(7),
        family_counts=jnp.zeros(8), family_wins=jnp.zeros(8))
    state, _ = update(state)
    state = state._replace(global_step=jnp.float32(GLOBAL_STEP),
                           env_state=state.env_state._replace(t=jnp.asarray(_near_cap(N))))
    start, steps = state, []
    for _ in range(UPDATES):
        draws = _jax_draws(jl, reset, state)
        state, metrics = update(state)
        steps.append(dict(draws=draws, state=state, metrics=jax.tree.map(np.asarray, metrics)))
    return dict(start=start, steps=steps)


def _assert_metrics(metrics, jm, u):
    assert set(metrics) == set(jm)
    for k in COUNTS:
        np.testing.assert_array_equal(np.asarray(metrics[k]), jm[k], err_msg=f"{u} {k}")
    for k, v in metrics.items():
        want = jm[k].astype(np.float64)
        assert (np.abs(v.numpy() - want) <= METRIC_TOL * np.maximum(np.abs(want), 1.0)).all(), (
            u, k)


def test_update_jit_matches_jax_over_two_updates(jax_single):
    """`update_jit` twice from the JAX state with the JAX draws: after each,
    the metrics to 1e-4 of max(|v|, 1), the counts exactly, and the weights
    to 1e-3 of the lr x SGD-steps budget of the updates so far (the bound
    of test_update_matches_jax, for one update, grows with the steps);
    both calls go through one program."""
    learner = PPOLearner(EnvConfig(**ENV_KW), PPOConfig(**_ppo_kw()), N, device="cpu")
    state = _port_state(learner, jax_single["start"])
    finished = 0.0
    for u, step in enumerate(jax_single["steps"]):
        state, metrics = learner.update_jit(state, _port_draws(step["draws"]))
        _assert_metrics(metrics, step["metrics"], u)
        _assert_params_close(state.params, step["state"].params,
                             (u + 1) * _params_bound(learner))
        assert float(state.global_step) == float(step["state"].global_step)
        assert float(state.episodes_total) == float(step["state"].episodes_total)
        finished += float(metrics["episodes/episodes"])
    assert finished >= 4
    assert learner._graphs.captures == 1 and len(learner._graphs.entries) == 1


@pytest.fixture(scope="module")
def jax_population():
    """JAX's ZooTrainer of 2 members: one update from init gives the
    mid-training state (stage 2, every other env near the cap), then
    UPDATES updates from it, each member's draws reproduced from its key."""
    trainer = jzoo.ZooTrainer(JEnvConfig(**ENV_KW), JPPOConfig(**_ppo_kw()), N // 2)
    reset = jax.jit(trainer.learner.env.reset_batch, static_argnums=1)
    state, _ = trainer.update(trainer.init([3, 4]))
    state = state._replace(
        global_step=jnp.full((2,), GLOBAL_STEP, jnp.float32),
        env_state=state.env_state._replace(t=jnp.asarray(np.stack([_near_cap(N // 2)] * 2))))
    start, steps = state, []
    for _ in range(UPDATES):
        draws = [_jax_draws(trainer.learner, reset, jax.tree.map(lambda x: x[m], state))
                 for m in range(2)]
        state, metrics = trainer.update(state)
        steps.append(dict(draws=draws, state=state, metrics=jax.tree.map(np.asarray, metrics)))
    return dict(start=start, steps=steps)


def test_population_update_jit_matches_jax_over_two_updates(jax_population):
    """A population of 2 through `update_jit` from the JAX zoo's state with
    each member's JAX draws, twice: the bounds of the single learner's."""
    trainer = ZooTrainer(EnvConfig(**ENV_KW), PPOConfig(**_ppo_kw()), N // 2, device="cpu")
    state = zoo_state_from_numpy(jax.tree.map(np.asarray, jax_population["start"]), LR,
                                 device="cpu")
    for u, step in enumerate(jax_population["steps"]):
        d = step["draws"]
        draws = (cat_states([env_state_from_numpy(x[0], device="cpu") for x in d]),
                 torch.tensor(np.concatenate([x[1] for x in d])),
                 torch.tensor(np.stack([x[2] for x in d], axis=1)),
                 torch.tensor(np.stack([x[3] for x in d])))
        state, metrics = trainer.update_jit(state, draws)
        for k, v in metrics.items():
            assert v.shape == (2,), k
        _assert_metrics(metrics, step["metrics"], u)
        _assert_params_close(state.params, step["state"].params,
                             (u + 1) * _params_bound(trainer))
        np.testing.assert_array_equal(state.episodes_total.numpy(),
                                      np.asarray(step["state"].episodes_total))
    assert trainer._graphs.captures == 1


def test_returned_state_is_the_callers():
    """What `update_jit` returns is not written by the next call: the envs,
    obs, counters and metrics of update 1 are as they were after update 2,
    and held nowhere in the program's static buffers; update_jit and update
    from twin states agree bit for bit."""
    ppo = PPOConfig(**_ppo_kw())
    learner = PPOLearner(EnvConfig(**ENV_KW), ppo, N, device="cpu")
    state, twin = learner.init(5), learner.init(5)
    first, m1 = learner.update_jit(state)
    kept = graphs.clone((first.env_state, first.obs, first.global_step, first.episodes_total,
                         m1))
    second, m2 = learner.update_jit(first)
    for a, b in zip(graphs.leaves(kept), graphs.leaves((
            first.env_state, first.obs, first.global_step, first.episodes_total, m1))):
        assert (a is None and b is None) or torch.equal(a, b)
    program = next(iter(learner._graphs.entries.values()))
    static = {t.data_ptr() for t in graphs.leaves(program.inputs) if t is not None}
    for t in graphs.leaves((second.env_state, second.obs, m2)):
        assert t is None or t.data_ptr() not in static
    for _ in range(2):
        twin, want = learner.update(twin)
    for k in m2:
        assert torch.equal(m2[k], want[k]), k
    for a, b in zip(second.params.parameters(), twin.params.parameters()):
        assert torch.equal(a, b)
    assert torch.equal(second.obs, twin.obs)


# -- the chunked eval runner against JAX's -----------------------------------

RUN_CAP, N_EP = 100, 24  # 100 steps = a 64-step chunk + a 36-step one
# (case, scenario, policy, EnvConfig overrides): the random policy at stage
# 5 with an AA end angle of 0.05 rad (every tumbling episode ends within a
# few steps, all before the first check at step 64), and agent_s8004 at
# stage 2, whose ~500-step episodes run to the cap through both chunks.
# Stage 2 has no obstacles: at stage 5 their avoidance terms amplify the
# packages' rounding differences over 100 closed-loop steps past the 64-step
# tolerance (4.4e-4 rad of angle measured), the same for the unchunked loop
RUN_CASES = {"early_exit": ("stage_5", "random", dict(AA_angle=0.05)),
             "to_the_cap": ("stage_2", "stochastic", {}),
             "to_the_cap_det": ("stage_2", "deterministic", {})}
RUNNER_TOL = 1e-4  # tests/test_torch_eval.py's, for the same closed loops


@pytest.fixture(scope="module")
def jax_runs():
    flat = dict(np.load(AGENT))
    params = jax_from_flat(flat)
    out = {}
    for i, (case, (scen, policy, kw)) in enumerate(RUN_CASES.items()):
        cfg = run.scenario_config(scen).replace(n_steps=RUN_CAP, path_table_n=128, **kw)
        jcfg = JEnvConfig(**{k: getattr(cfg, k) for k in JEnvConfig.__dataclass_fields__})
        rand, det = policy == "random", policy == "deterministic"
        one = jepisode._episode_runner(jcfg, rand, det, 0)
        keys = jax.random.split(jax.random.PRNGKey(70 + i), N_EP)
        want = jepisode._to_results(*jax.jit(jax.vmap(one, in_axes=(None, 0)))(params, keys))
        jax_env = jenv.Drone2DEnv(jcfg)

        def draws(key):
            k_reset, k_policy = jax.random.split(key)
            state, obs = jax_env.reset(k_reset, 0)
            draw = ((lambda k: jax.random.uniform(k, (2,), minval=-1.0, maxval=1.0)) if rand
                    else (lambda k: jax.random.normal(k, (2,))))
            return state, obs, jax.vmap(draw)(jax.random.split(k_policy, RUN_CAP))

        state, obs, noise = jax.jit(jax.vmap(draws))(keys)
        out[case] = dict(cfg=cfg, want=want, state=jax.tree.map(np.asarray, state),
                         obs=np.asarray(obs), noise=np.asarray(noise).transpose(1, 0, 2),
                         flat=flat)
    return out


@pytest.mark.parametrize("case", list(RUN_CASES))
def test_chunked_runner_matches_jax(jax_runs, case, monkeypatch):
    """The runner's chunks against JAX's scan to the cap: latched flags and
    lengths exactly, APE, return, trajectories and angles to RUNNER_TOL of
    scale; the early exit runs one chunk, the others both (64 + 36)."""
    c = jax_runs[case]
    policy = RUN_CASES[case][1]
    chunks = []
    body = episode._chunk
    monkeypatch.setattr(episode, "_chunk", lambda *a: (chunks.append(a[3]), body(*a))[1])
    env = Drone2DEnv(c["cfg"], device="cpu")
    got = episode.run_episodes_from(
        env, None if policy == "random" else flat_dict_to_params(c["flat"], device="cpu"),
        env_state_from_numpy(c["state"], device="cpu"), torch.tensor(c["obs"]),
        torch.tensor(c["noise"]), deterministic=policy == "deterministic")
    want = c["want"]
    if case == "early_exit":
        assert want.time_steps.max() < episode.CHECK_EVERY and chunks == [64]
    else:
        assert want.time_steps.max() == RUN_CAP and chunks == [64, 36]
    for k in ("success", "fail", "collision", "time_steps", "traj_len"):
        g, w = getattr(got, k), getattr(want, k)
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)
    for k in ("ape", "total_reward"):
        g, w = (np.asarray(getattr(x, k), np.float64) for x in (got, want))
        assert np.abs(g - w).max() <= RUNNER_TOL * max(1.0, np.abs(w).max()), k
    assert got.traj.shape == want.traj.shape == (N_EP, RUN_CAP, 2)
    assert np.abs(got.traj - want.traj).max() <= RUNNER_TOL * 1300.0
    assert np.abs(got.angles - want.angles).max() <= RUNNER_TOL * np.pi


def test_runner_is_kept_and_reused_on_its_env(monkeypatch):
    """One runner a policy and batch for the env's step, kept in the runner
    cache and reused by the next run with another start; a third policy
    releases the oldest (the cache holds two); a second run from the same
    start gives the same results."""
    runners = graphs.GraphCache(size=2, counter="eval_runner")
    monkeypatch.setattr(episode, "_EVAL_RUNNERS", runners)
    cfg = run.scenario_config("stage_2").replace(n_steps=70, path_table_n=128)
    env = Drone2DEnv(cfg, device="cpu")
    params = ActorCritic(27, 2, HIDDEN, generator=torch.Generator().manual_seed(0), device="cpu")
    gen = torch.Generator().manual_seed(1)
    state, obs = env.reset_batch(gen, 8)
    draws = torch.randn((70, 8, 2), generator=gen)
    a = episode.run_episodes_from(env, params, state, obs, draws)
    state2, obs2 = env.reset_batch(gen, 8)
    episode.run_episodes_from(env, params, state2, obs2, draws)
    b = episode.run_episodes_from(env, params, state, obs, draws)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert runners.captures == 1
    episode.run_episodes_from(env, params, state, obs, None, deterministic=True)
    episode.run_episodes_from(env, None, state, obs, draws.clamp(-1, 1))
    assert runners.captures == 3 and len(runners.entries) == 2


# -- the graph helpers ---------------------------------------------------------


def test_tree_helpers_copy_clone_and_signature():
    env = Drone2DEnv(EnvConfig(**ENV_KW), device="cpu")
    state, obs = env.reset_batch(torch.Generator().manual_seed(0), 4)
    tree = (state, obs, {"x": torch.ones(3)})
    copy = graphs.clone(tree)
    assert graphs.signature(copy) == graphs.signature(tree)
    assert all(a is None or a.data_ptr() != b.data_ptr()
               for a, b in zip(graphs.leaves(copy), graphs.leaves(tree)))
    other, obs2 = env.reset_batch(torch.Generator().manual_seed(1), 4)
    graphs.copy_(copy, (other, obs2, {"x": torch.zeros(3)}))
    assert torch.equal(copy[0].body.pos, other.body.pos) and torch.equal(copy[1], obs2)
    assert state.obstacles.half_wh is None and copy[0].obstacles.half_wh is None
    with pytest.raises(ValueError, match="leaves"):
        graphs.copy_(copy, (other, obs2))
    assert graphs.signature((obs, None)) != graphs.signature((obs2[:2], None))


def test_graph_cache_releases_the_oldest():
    cache = graphs.GraphCache(size=2)
    for k in "abc":
        cache.put(k, k.upper())
    assert cache.get("a") is None and cache.get("b") == "B" and cache.get("c") == "C"
    cache.put("d", "D")  # "b" was used longest ago
    assert list(cache.entries) == ["c", "d"]
    assert cache.captures == 4


def test_restore_point_puts_back_weights_and_adam_state():
    """What a warm-up changes in place goes back: the weights and Adam's
    moments and step as they were, and Adam's state made by the warm-up
    set to its initial zeros."""
    params = ActorCritic(27, 2, HIDDEN, generator=torch.Generator().manual_seed(0), device="cpu")
    opt = optim.adam(params.parameters(), LR)

    def step():
        opt.zero_grad(set_to_none=True)
        params.policy_value(torch.ones(5, 27))[2].sum().backward()
        opt.step()

    fresh = [p.detach().clone() for p in params.parameters()]
    restore = graphs._restore_point(list(params.parameters()), [opt])
    step()
    restore()
    assert all(torch.equal(a, b) for a, b in zip(params.parameters(), fresh))
    assert all(float(v.abs().sum()) == 0.0 for v in graphs.optimizer_tensors(opt))
    step()
    moved = [p.detach().clone() for p in params.parameters()]
    saved = [v.clone() for v in graphs.optimizer_tensors(opt)]
    restore = graphs._restore_point(list(params.parameters()), [opt])
    step()
    restore()
    assert all(torch.equal(a, b) for a, b in zip(params.parameters(), moved))
    assert all(torch.equal(a, b) for a, b in zip(graphs.optimizer_tensors(opt), saved))


def test_adam_state_loads_across_capturable():
    """A capturable Adam's state (the card's) loads into the CPU's Adam,
    which stays not capturable, with its step count a CPU tensor."""
    params = ActorCritic(27, 2, HIDDEN, device="cpu")
    opt = optim.adam(params.parameters(), LR)
    assert not opt.param_groups[0]["capturable"]
    opt.zero_grad()
    params.policy_value(torch.ones(3, 27))[2].sum().backward()
    opt.step()
    sd = opt.state_dict()
    sd["param_groups"] = [{**g, "capturable": True} for g in sd["param_groups"]]
    other = optim.adam(params.parameters(), LR)
    optim.load_state_dict(other, sd)
    assert not other.param_groups[0]["capturable"]
    for a, b in zip(graphs.optimizer_tensors(other), graphs.optimizer_tensors(opt)):
        assert a.device.type == "cpu" and torch.equal(a, b)
    other.step()  # a capturable group would raise on the CPU

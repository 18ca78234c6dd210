"""The port's batched multi-agent eval against per-agent runs and against the
JAX package's `run_episodes_multi`, on the CPU.

`run_episodes_multi` flies a stack of A agents over A x n episodes as one
batch: with `same_episodes` every agent must get exactly what
`run_episodes` gives it alone on the same seed, and without it exactly what
`run_episodes_from` gives it on its own slice of the draws.  Fed the JAX
runner's reset states and noise (reproduced from its episode keys, in both
modes), it must latch the same outcomes as the JAX package's
`run_episodes_multi`.  Also: `campaign_keys`, and the published tables
`select_agents` ranks against.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drone2d_tpu.env import env as jenv
from drone2d_tpu.eval import barplots as jbarplots, episode as jepisode
from drone2d_tpu.models.policy import flat_dict_to_params as jax_from_flat
from drone2d_tpu_torch.compat.from_jax import env_state_from_numpy
from drone2d_tpu_torch.env.env import Drone2DEnv
from drone2d_tpu_torch.env.types import cat_states
from drone2d_tpu_torch.eval import barplots
from drone2d_tpu_torch.eval.episode import (
    campaign_keys,
    run_episodes,
    run_episodes_from,
    run_episodes_multi,
)
from drone2d_tpu_torch.eval.run import scenario_config
from drone2d_tpu_torch.models.policy import flat_dict_to_params, stack_params
from tests.test_torch_eval import RUNNER_TOL, _jax_cfg, _scale_err

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
FLATS = [dict(np.load(os.path.join(ROOT, "artifacts", f"agent_s{s}", "new_agent.npz")))
         for s in (8004, 22307)]
# CPU elementwise kernels run 32-float vector blocks and finish a ragged
# tail in scalar code whose sin, cos and atan2 round differently; with n a
# multiple of 32 every agent's rows run the same code alone and in the
# stack, so the comparisons with runs of one agent are exact
N_EP, CAP = 32, 48


def _agents():
    return [flat_dict_to_params(f, device="cpu") for f in FLATS]


def _slice(tree, sl):
    if dataclasses.is_dataclass(tree):
        return type(tree)(**{f.name: _slice(getattr(tree, f.name), sl)
                             for f in dataclasses.fields(tree)})
    return None if tree is None else tree[sl]  # half_wh is None for circles


@pytest.mark.parametrize("scen, deterministic", [("S_corridor", False), ("stage_5", False),
                                                 ("stage_5", True)])
def test_same_episodes_equal_single_agent_runs(scen, deterministic):
    """(f) Three agents (s8004, s22307, s8004 again) on the same 32 episodes:
    each agent's results equal run_episodes of that agent alone on the same
    seed, field for field; the repeated agent's rows equal the first's."""
    cfg = scenario_config(scen).replace(n_steps=CAP, path_table_n=128)
    agents = _agents()
    stack = stack_params(agents + agents[:1])
    got = run_episodes_multi(cfg, stack, 5, N_EP, deterministic=deterministic, device="cpu")
    assert got.success.shape == (3, N_EP) and got.traj.shape == (3, N_EP, CAP, 2)
    for a, agent in enumerate(agents + agents[:1]):
        want = run_episodes(cfg, agent, 5, N_EP, deterministic=deterministic, device="cpu")
        for k, g, w in zip(want._fields, got, want):
            assert g[a].dtype == w.dtype, k
            np.testing.assert_array_equal(g[a], w, err_msg=k)
    assert got.fail.any() and not np.array_equal(got.traj[0], got.traj[1])


def test_independent_episodes_equal_runs_on_each_slice():
    """(f) same_episodes=False: agent a flies rows [a n, (a + 1) n) of A x n
    episodes and noise drawn from the seed, exactly as run_episodes_from
    flies that slice alone."""
    cfg = scenario_config("S_corridor").replace(n_steps=CAP, path_table_n=128)
    agents = _agents()
    got = run_episodes_multi(cfg, stack_params(agents), 9, N_EP, same_episodes=False,
                             device="cpu")
    env = Drone2DEnv(cfg, device="cpu")
    gen = torch.Generator().manual_seed(9)
    state, obs = env.reset_batch(gen, 2 * N_EP)
    noise = torch.randn((CAP, 2 * N_EP, 2), generator=gen)
    for a, agent in enumerate(agents):
        sl = slice(a * N_EP, (a + 1) * N_EP)
        want = run_episodes_from(env, agent, _slice(state, sl), obs[sl], noise[:, sl])
        for k, g, w in zip(want._fields, got, want):
            np.testing.assert_array_equal(g[a], w, err_msg=k)
    same = run_episodes_multi(cfg, stack_params(agents), 9, N_EP, device="cpu")
    assert not np.array_equal(got.traj, same.traj)


# -- against the JAX package's run_episodes_multi -----------------------------

JAX_CASES = [("stage_5", True), ("stage_5", False), ("S_corridor", True)]
JAX_N, JAX_CAP = 16, 64


@pytest.fixture(scope="module")
def jax_multi():
    """JAX's run_episodes_multi for s8004 and s22307 in each case, with the
    reset states and noise of its episode keys reproduced, agent-major."""
    params = jax.tree.map(lambda *x: jnp.stack(x), *[jax_from_flat(f) for f in FLATS])
    out = {}
    for i, (scen, same) in enumerate(JAX_CASES):
        cfg = scenario_config(scen).replace(n_steps=JAX_CAP, path_table_n=128)
        jcfg = _jax_cfg(cfg)
        key = jax.random.PRNGKey(60 + i)
        want = jepisode.run_episodes_multi(jcfg, params, key, JAX_N, same_episodes=same)
        keys = jax.random.split(key, JAX_N if same else 2 * JAX_N)
        jax_env = jenv.Drone2DEnv(jcfg)

        def draws(k):
            k_reset, k_policy = jax.random.split(k)
            state, obs = jax_env.reset(k_reset, 0)
            return state, obs, jax.vmap(lambda kk: jax.random.normal(kk, (2,)))(
                jax.random.split(k_policy, JAX_CAP))

        state, obs, noise = jax.jit(jax.vmap(draws))(keys)
        out[(scen, same)] = dict(cfg=cfg, want=want, state=jax.tree.map(np.asarray, state),
                                 obs=np.asarray(obs),
                                 noise=np.asarray(noise).transpose(1, 0, 2))
    return out


@pytest.mark.parametrize("scen, same", JAX_CASES)
def test_run_episodes_multi_matches_jax(jax_multi, scen, same):
    """(f) The port's stacked runner fed JAX's states and noise (repeated for
    both agents when the episodes are the same): latched flags and lengths
    exactly; APE, return and trajectories to 1e-4 of scale (the tolerance
    of test_run_episodes_from_matches_jax: closed-loop drift) and angles,
    which drift fastest, to 1e-3 of pi (measured 3.3e-4 rad over 64 steps),
    on every episode but at most one a case.  That one may part on a discrete
    choice of the observation (the path tables and obstacle distances agree
    to float32 rounding only, so an argmin at a near-tie can flip): measured,
    s22307's episode 9 in stage_5 with the same episodes, whose positions
    agree to one float32 ulp for 39 steps and then drift apart linearly, to
    1.5 px at step 64, with the same outcome."""
    case = jax_multi[(scen, same)]
    env = Drone2DEnv(case["cfg"], device="cpu")
    state = env_state_from_numpy(case["state"], device="cpu")
    obs, noise = torch.tensor(case["obs"]), torch.tensor(case["noise"])
    if same:
        state, obs, noise = cat_states([state] * 2), obs.repeat(2, 1), noise.repeat(1, 2, 1)
    got = run_episodes_from(env, stack_params(_agents()), state, obs, noise)
    want = case["want"]
    for k in ("success", "fail", "collision", "time_steps", "traj_len"):
        g, w = getattr(got, k), getattr(want, k)
        assert g.shape == w.shape == (2, JAX_N), k
        np.testing.assert_array_equal(g, w, err_msg=k)
    parted = np.abs(got.traj - want.traj).max((2, 3)) > RUNNER_TOL * 1300.0
    assert parted.sum() <= 1
    keep = ~parted
    for k in ("ape", "total_reward"):
        assert _scale_err(getattr(got, k)[keep], getattr(want, k)[keep]) <= RUNNER_TOL, k
    assert np.abs(got.angles - want.angles)[keep].max() <= 1e-3 * np.pi
    assert want.fail.any()


# -- campaign keys and the published tables -------------------------------------


def test_campaign_keys_are_deterministic_and_disjoint():
    """Seeds depend only on (seed, scenario, chunk): more chunks extend a
    campaign; scenarios and seeds get other streams; each fits a generator."""
    a = campaign_keys(0, "corridor", 4)
    assert a[:2] == campaign_keys(0, "corridor", 2) and len(set(a)) == 4
    assert not set(a) & set(campaign_keys(0, "large", 4))
    assert not set(a) & set(campaign_keys(1, "corridor", 4))
    assert all(0 <= k < 2**63 for k in a)
    assert a == [7906406901174017685, 8080712276994555641, 7392978213339271278,
                 162919321535661830]
    torch.Generator().manual_seed(a[0])


def test_published_tables_match_jax():
    assert barplots.PUBLISHED_SR == jbarplots.PUBLISHED_SR
    assert barplots.PUBLISHED_AAPE == jbarplots.PUBLISHED_AAPE

"""The draws inside the port's compiled programs, on the CPU.

The JAX package draws its reset templates, action noise and shuffles inside
its compiled programs (`update_jit`, the bench's chunk, the graft entry's
step).  The port draws them inside its CUDA graphs, from generators the
graphs are bound to; on the CPU the graphs' bodies run directly over the
same static buffers and the same generators.  Held here, at small shapes:
- `update_jit(state)` bit-equal to `update(state)` from twin generators in
  every shuffle and for a population of 2, the generators' states equal
  after each update, and its programs keyed apart from the given-draws
  variant and by the generator objects;
- the data-parallel rank streams: seeded on the host from the run's seed
  and the rank, deterministic, distinct per rank and from the env streams,
  with no read back from the device; 2 gloo ranks' `shard_update` against
  `union_update`, each rank's generator advanced by its own draws;
- the graft step (`graft.GraftStep`) bit-equal to the eager `step_batch`
  step, and the bench's drawn-inside chunks to the eager chunk;
- a checkpoint written after a drawn-inside update resumes eagerly onto the
  same stream;
- the reset draws at a host step equal those at a device step.

The JAX parity of the given-draws paths is held in `test_torch_ppo.py`,
`test_torch_graphs.py` and `test_torch_parallel.py`.
"""

import dataclasses

import numpy as np
import pytest
import torch

from drone2d_tpu_torch import bench
from drone2d_tpu_torch.config import EnvConfig, PPOConfig
from drone2d_tpu_torch.env.env import Drone2DEnv
from drone2d_tpu_torch.graft import GraftStep, graft_step
from drone2d_tpu_torch.learn.ppo import PPOLearner
from drone2d_tpu_torch.learn.zoo import ZooTrainer
from drone2d_tpu_torch.models.policy import ActorCritic, params_to_flat_dict
from drone2d_tpu_torch.parallel import mesh
from drone2d_tpu_torch.utils import graphs
from drone2d_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint
from tests import torch_dist_workers as W

torch.set_num_threads(1)

ENV = dict(path_table_n=128)
PPO = dict(n_steps=8, num_minibatches=2, n_epochs=3, hidden_sizes=(16, 16))


def _learner(shuffle="timeperm", cls=PPOLearner, num_envs=8):
    return cls(EnvConfig(**ENV), PPOConfig(**PPO, shuffle=shuffle), num_envs, device="cpu")


def _near_cap(state, cap):
    """`state` with every other env one step from the episode cap, so that
    episodes end inside the rollout and the template is taken."""
    n = state.obs.shape[0]
    t = torch.where(torch.arange(n) % 2 == 0, cap - 1, 0).to(torch.int32)
    return dataclasses.replace(state, env_state=dataclasses.replace(state.env_state, t=t))


def _assert_equal_updates(a, ma, b, mb):
    assert set(ma) == set(mb)
    for k in mb:
        assert torch.equal(ma[k], mb[k]), k
    for x, y in zip(a.params.parameters(), b.params.parameters()):
        assert torch.equal(x, y)
    xs, ys = graphs.optimizer_tensors(a.optimizer), graphs.optimizer_tensors(b.optimizer)
    assert len(xs) == len(ys) > 0 and all(torch.equal(x, y) for x, y in zip(xs, ys))
    for x, y in zip(graphs.leaves((a.env_state, a.obs, a.global_step, a.family_counts)),
                    graphs.leaves((b.env_state, b.obs, b.global_step, b.family_counts))):
        assert (x is None and y is None) or torch.equal(x, y)


@pytest.mark.parametrize("shuffle", ["timeperm", "exact", "affine"])
def test_update_jit_draws_inside_bit_equal_to_update(shuffle):
    """Three updates each way from twin states at stage 2: `update_jit(state)`
    (the draws made in its rollout graph) against `update(state)`: weights,
    Adam, envs, counters and metrics bit-equal, the generator's state equal
    after each update, one program made."""
    learner = _learner(shuffle)
    cap = learner.env.cfg.n_steps
    a = _near_cap(learner.init(3, global_step=8e5), cap)
    b = _near_cap(learner.init(3, global_step=8e5), cap)
    ended = 0.0
    for _ in range(3):
        a, ma = learner.update_jit(a)
        b, mb = learner.update(b)
        _assert_equal_updates(a, ma, b, mb)
        assert torch.equal(a.generator.get_state(), b.generator.get_state())
        ended += float(ma["episodes/episodes"])
    assert ended > 0 and learner._graphs.captures == 1


def test_population_update_jit_draws_inside_bit_equal_to_update():
    """A population of 2 through `update_jit` and `update`, two updates in
    turn: bit-equal, every member's generator in the same state after."""
    trainer = _learner(cls=ZooTrainer)
    a, b = trainer.init([4, 5]), trainer.init([4, 5])
    for _ in range(2):
        a, ma = trainer.update_jit(a)
        b, mb = trainer.update(b)
        _assert_equal_updates(a, ma, b, mb)
        for ga, gb in zip(a.generators, b.generators):
            assert torch.equal(ga.get_state(), gb.get_state())
    assert not torch.equal(a.generators[0].get_state(), a.generators[1].get_state())
    assert trainer._graphs.captures == 1


def test_drawn_and_given_programs_keyed_apart():
    """`update_jit(state)` and `update_jit(state, draws)` make a program
    each; a state with another generator object makes another drawn one."""
    learner = _learner()
    state = learner.init(1)
    learner.update_jit(state, learner.draws(state))
    state, _ = learner.update_jit(state)
    state, _ = learner.update_jit(state)
    assert learner._graphs.captures == 2
    keys = list(learner._graphs.entries)
    assert keys[0][2] is None and keys[1][2] == (state.generator,)
    other = dataclasses.replace(state, generator=torch.Generator().manual_seed(1))
    learner.update_jit(other)
    assert learner._graphs.captures == 3


def test_rank_streams_deterministic_distinct_and_host_only(monkeypatch):
    """Each rank's draw generator is seeded on the host from (seed, rank):
    the same twice, different for every rank and from every rank's env
    stream, made with nothing read from a tensor; no per-update seed is
    drawn from the device any more."""
    assert not hasattr(mesh, "draw_seed") and not hasattr(mesh, "rank_drawn")

    def refuse(*a, **k):
        raise AssertionError("a tensor was read on the host")

    for name in ("item", "tolist", "__int__", "__float__", "__bool__", "__index__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    states = [mesh.rank_generator(7, r, "cpu").get_state() for r in range(4)]
    again = [mesh.rank_generator(7, r, "cpu").get_state() for r in range(4)]
    envs = [mesh.env_generator(7, r, "cpu").get_state() for r in range(4)]
    monkeypatch.undo()
    assert all(torch.equal(x, y) for x, y in zip(states, again))
    everything = states + envs
    assert all(not torch.equal(everything[i], everything[j])
               for i in range(len(everything)) for j in range(i))
    assert not torch.equal(mesh.rank_generator(8, 0, "cpu").get_state(), states[0])


def test_union_update_against_shard_update_two_gloo_ranks(tmp_path):
    """Two gloo rank processes run UPDATES `shard_update`s (the captured
    update's bodies, drawing from each rank's generator); `union_update`
    replays them in one process: every rank's weights to rtol 2e-5, atol
    2e-6, and each rank's generator where its own draws of UPDATES updates
    leave `rank_generator(SEED, rank)`."""
    from tests.test_torch_parallel import ATOL, RTOL, _rank_states, run_ranks

    runs = run_ranks(2, ("shard",), str(tmp_path))["shard"]
    learner = W._learner(W.GLOBAL_ENVS)
    states = _rank_states(2)
    local = mesh.local_learner(learner, 2)
    for _ in range(W.UPDATES):
        states = mesh.union_update(learner, states)
    ref = params_to_flat_dict(states[0].params)
    for rank, run in enumerate(runs):
        for k, v in ref.items():
            np.testing.assert_allclose(run["params"][k], v, rtol=RTOL, atol=ATOL,
                                       err_msg=f"rank {rank} {k}")
        assert torch.equal(run["generator"], states[rank].generator.get_state()), rank
        gen = mesh.rank_generator(W.SEED, rank, "cpu")
        probe = dataclasses.replace(states[rank], generator=gen)
        for _ in range(W.UPDATES):
            local.draws(probe)
        assert torch.equal(run["generator"], gen.get_state()), rank


def test_graft_step_draws_inside_bit_equal_to_step_batch():
    """The graft step as one graph (`GraftStep`: the policy's noise and a
    whole reset batch drawn inside it each step) against the eager
    `sample_action` + `step_batch` from a twin generator, 12 steps at a
    6-step episode cap: obs, reward, done and value bit-equal each step,
    ended envs restarted, the generators equal after."""
    env = Drone2DEnv(EnvConfig(**ENV, n_steps=6), device="cpu")
    params = ActorCritic(27, 2, (16, 16), generator=torch.Generator().manual_seed(0),
                         device="cpu")
    state, obs = env.reset_batch(torch.Generator().manual_seed(1), 16, 0.0)
    g1, g2 = torch.Generator().manual_seed(2), torch.Generator().manual_seed(2)
    step = GraftStep(params, env, g1)
    a = b = (state, obs)
    ended = 0
    for _ in range(12):
        s1, o1, r1, d1, v1 = step(*a)
        s2, o2, r2, d2, v2 = graft_step(params, env, *b, g2, 0.0)
        for x, y in zip((o1, r1, d1, v1, s1.t, s1.path.wps), (o2, r2, d2, v2, s2.t, s2.path.wps)):
            assert torch.equal(x, y)
        assert bool((s1.t[d1] == 0).all())
        ended += int(d1.sum())
        a, b = (s1, o1), (s2, o2)
    assert ended > 0
    assert torch.equal(g1.get_state(), g2.get_state())


@pytest.mark.parametrize("cls", [bench.CapturedChunk, bench.CapturedSplitChunk])
def test_bench_chunk_draws_inside_bit_equal_to_eager(cls):
    """The bench's chunk with its template and noise drawn by its draw
    graph (4-step graph, 8-step chunks, 3 chunks) against `bench.chunk` from
    a twin generator: rewards, obs and envs bit-equal each chunk, the
    generators equal after."""
    learner = _learner()
    state = _near_cap(learner.init(0), learner.env.cfg.n_steps)
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    run = cls(state.params, learner.env, state.env_state, state.obs, steps=4, gen=g1,
              chunk_t=8)
    a = b = (state.env_state, state.obs)
    for _ in range(3):
        got = run(*a)
        want = bench.chunk(state.params, learner.env, *b, g2, 8)
        for x, y in zip(graphs.leaves(got), graphs.leaves(want)):
            assert (x is None and y is None) or torch.equal(x, y)
        a, b = got[:2], want[:2]
    assert torch.equal(g1.get_state(), g2.get_state())


def test_checkpoint_after_drawn_update_resumes_eagerly(tmp_path):
    """A checkpoint written after a drawn-inside `update_jit` holds the
    generator as the replay left it: the restore's envs are those a start
    from that generator resets, and the next eager update from the restore
    is bit-equal to the next `update_jit` from a second restore."""
    learner = _learner()
    state, _ = learner.update_jit(learner.init(2))
    twin = torch.Generator()
    twin.set_state(state.generator.get_state())
    save_checkpoint(str(tmp_path), state)
    eager, _ = restore_checkpoint(str(tmp_path), learner)
    captured, _ = restore_checkpoint(str(tmp_path), learner)
    fresh = learner.start(twin, state.params, float(state.global_step))
    assert torch.equal(eager.obs, fresh.obs)
    assert torch.equal(eager.generator.get_state(), twin.get_state())
    a, ma = learner.update(eager)
    b, mb = learner.update_jit(captured)
    _assert_equal_updates(a, ma, b, mb)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


@pytest.mark.parametrize("adaptive", [False, True])
def test_reset_at_host_step_equals_device_step(adaptive):
    """The curriculum reset at a host step (filled in on the device) and at
    the same step as a device tensor draws the same episodes."""
    cfg = EnvConfig(**ENV, adaptive_rehearsal=adaptive, stage_mix_prob=0.2,
                    corridor_mix_prob=0.1, cross_mix_prob=0.1)
    env = Drone2DEnv(cfg, device="cpu")
    probs = torch.tensor([0.04] * 5 + [0.1, 0.1]) if adaptive else None
    a = env.reset_batch(torch.Generator().manual_seed(3), 32, 1.7e6, probs)
    b = env.reset_batch(torch.Generator().manual_seed(3), 32, torch.tensor(1.7e6), probs)
    for x, y in zip(graphs.leaves(a), graphs.leaves(b)):
        assert (x is None and y is None) or torch.equal(x, y)


@pytest.mark.parametrize("policy", ["stochastic", "deterministic", "random"])
def test_campaign_draws_inside_equal_eager_draws(policy):
    """`run_episodes` (its reset batch and draws made by the kept env's draw
    graph) at two seeds against the eager draws from a fresh generator of
    each seed flown by `run_episodes_from`: every field equal; the two
    calls share the kept env, its one generator and one draw graph."""
    from drone2d_tpu_torch.eval import episode
    from drone2d_tpu_torch.eval.run import scenario_config

    cfg = scenario_config("stage_2").replace(n_steps=40, path_table_n=128)
    params = None if policy == "random" else ActorCritic(
        27, 2, (16, 16), generator=torch.Generator().manual_seed(0), device="cpu")
    det = policy == "deterministic"
    kept = None
    for seed in (11, 12):
        got = episode.run_episodes(cfg, params, seed, 16, deterministic=det, device="cpu")
        c = episode._campaign_env(cfg, "cpu")
        if kept is None:
            kept, made = c, c.draws.captures
        assert c.env is kept.env and c.gen is kept.gen
        gen = torch.Generator().manual_seed(seed)
        env = Drone2DEnv(cfg, device="cpu")
        state, obs, draws = episode._episode_draws(env, gen, 16, 0.0, policy)
        want = episode.run_episodes_from(env, params, state, obs, draws, deterministic=det)
        for k, g, w in zip(got._fields, got, want):
            np.testing.assert_array_equal(g, w, err_msg=k)
    assert kept.draws.captures == made  # the second seed made no new draw graph


def test_multi_campaign_draws_inside_equal_single_agent_runs():
    """`run_episodes_multi` of a stack of 2 with the same episodes: each
    agent's rows equal its own `run_episodes` at the seed."""
    from drone2d_tpu_torch.eval import episode
    from drone2d_tpu_torch.eval.run import scenario_config
    from drone2d_tpu_torch.models.policy import stack_params

    cfg = scenario_config("stage_1").replace(n_steps=30, path_table_n=128)
    agents = [ActorCritic(27, 2, (16, 16), generator=torch.Generator().manual_seed(s),
                          device="cpu") for s in (1, 2)]
    got = episode.run_episodes_multi(cfg, stack_params(agents), 5, 8, device="cpu")
    for a, agent in enumerate(agents):
        want = episode.run_episodes(cfg, agent, 5, 8, device="cpu")
        for k, g, w in zip(got._fields, got, want):
            np.testing.assert_array_equal(g[a], w, err_msg=k)


def test_adapters_draw_from_their_one_generator():
    """The vector env's and the gym env's resets (their draw graphs) equal
    the eager reset from a fresh generator of the seed, and a reset with a
    new seed re-seeds the env's one generator instead of replacing it."""
    from drone2d_tpu_torch.compat import make
    from drone2d_tpu_torch.compat.vector_env import VectorEnvCore

    vec = VectorEnvCore(8, seed=1, global_step=900_000, device="cpu", path_table_n=128)
    gen = vec._gen
    for seed in (1, 4):
        obs, _ = vec.reset(seed=seed)
        _, want = Drone2DEnv(vec.cfg, device="cpu").reset_batch(
            torch.Generator().manual_seed(seed), 8, 900_000.0)
        assert np.array_equal(obs, want.numpy()) and vec._gen is gen
    gym = make(device="cpu", path_table_n=128)
    gen = gym._gen
    for seed in (2, 3):
        gym.seed(seed)
        obs = gym.reset()
        _, want = Drone2DEnv(gym.cfg, device="cpu").reset(torch.Generator().manual_seed(seed))
        assert np.array_equal(obs, want[0].numpy()) and gym._gen is gen

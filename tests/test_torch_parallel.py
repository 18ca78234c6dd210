"""The port's data parallelism on the CPU: `parallel/` over gloo.

Ranks are separate processes (`tests/torch_dist_workers.py`, joined by a
rendezvous file), so every collective really crosses processes:
- a world-1 `shard_update` is bit-equal to the plain `PPOLearner.update`
  from the same state and draws (the collectives still run: a sum over
  one rank and a division by 1.0 are exact); so is `update_jit(...,
  group=...)`, the captured update `shard_update` runs (its bodies called
  directly on the CPU), to `update(..., group=...)` and the plain update,
  and its programs are keyed by the group;
- 2 and 4 ranks equal `union_update`, the same update replayed in one
  process over the union batch with matched minibatch composition, at the
  JAX package's tolerance (`tests/test_parallel.py`: rtol 2e-5, atol 2e-6);
- the port's 2-rank update equals JAX's 2-shard `shard_update` on the
  conftest's virtual CPU mesh, with JAX's per-shard draws injected as
  `tests/test_torch_ppo.py` injects them for one device (its bounds: the
  weights to 1e-3 of the lr x SGD-steps budget, the metrics to 1e-4 of
  max(|value|, 1), the counts exactly), eagerly and through `update_jit`,
  the two bit-equal;
- `shard_population` over 2 ranks is bit-equal, member by member, to the
  one-process population of each rank's block, and equal to the whole
  one-process population at the tolerance above;
- the divisibility checks, `init_distributed` for a lone process, the
  multi-process smoke script, `shard_restore` of rank 0's checkpoint on
  both ranks, and `train.py` under torchrun (rank 0 writes one checkpoint
  and one metrics file, and the checkpoint restores).
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from drone2d_tpu.config import EnvConfig as JEnvConfig, PPOConfig as JPPOConfig
from drone2d_tpu.learn.ppo import PPOLearner as JPPOLearner
from drone2d_tpu.models.policy import params_to_flat_dict as jax_to_flat
from drone2d_tpu.parallel import make_mesh, shard_init as jax_shard_init
from drone2d_tpu.parallel import shard_update as jax_shard_update
from drone2d_tpu_torch.compat.from_jax import flatten_fields
from drone2d_tpu_torch.config import EnvConfig, PPOConfig
from drone2d_tpu_torch.learn import optim
from drone2d_tpu_torch.learn.ppo import PPOLearner
from drone2d_tpu_torch.learn.zoo import ZooTrainer
from drone2d_tpu_torch.models.policy import ActorCritic, params_to_flat_dict
from drone2d_tpu_torch.parallel import mesh
from drone2d_tpu_torch.parallel.multihost import host_info, init_distributed
from drone2d_tpu_torch.utils.checkpoint import restore_checkpoint
from tests import torch_dist_workers as W
from tests.test_torch_ppo import _jax_draws

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 2e-5, 2e-6
# the JAX comparison: stage 2, every other env near the episode cap, so
# that episodes end inside the rollout and the stats' reduction counts them
JAX_GLOBAL_STEP, JAX_ENVS = 8e5, 16


def _env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    return env


def run_ranks(world: int, jobs, directory: str, timeout: float = 240.0) -> dict:
    """Start `world` rank processes on `jobs`; -> {job: [result of each rank]}."""
    with open(os.path.join(directory, "jobs.json"), "w") as f:
        json.dump(list(jobs), f)
    logs = [open(os.path.join(directory, f"rank_{r}.log"), "w+") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, "-m", "tests.torch_dist_workers", str(r),
                               str(world), directory], cwd=ROOT, env=_env(),
                              stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(world)]
    try:
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    text = []
    for log in logs:
        log.seek(0)
        text.append(log.read())
        log.close()
    assert all(p.returncode == 0 for p in procs), "\n".join(text)[-4000:]
    return {job: [torch.load(os.path.join(directory, f"{job}_{r}.pt"), weights_only=False)
                  for r in range(world)] for job in jobs}


def _learner(num_envs):
    return W._learner(num_envs)


def _rank_states(world):
    """The ranks' initial states as shard_init makes them, in one process,
    sharing one weights object and optimizer, each with its own generator."""
    local = mesh.local_learner(_learner(W.GLOBAL_ENVS), world)
    states = [mesh.rank_state(local, W.SEED, r) for r in range(world)]
    shared = dict(params=states[0].params, optimizer=states[0].optimizer)
    return [dataclasses.replace(s, **shared) for s in states]


def _union_params(world):
    learner = _learner(W.GLOBAL_ENVS)
    states = _rank_states(world)
    for _ in range(W.UPDATES):
        states = mesh.union_update(learner, states)
    return params_to_flat_dict(states[0].params)


# -- JAX's two shards --------------------------------------------------------


@pytest.fixture(scope="module")
def jax_two_shards(tmp_path_factory):
    """JAX's 2-shard update from its shard_init state, moved to stage 2 with
    every other env near the cap; and each rank's inputs for the port: the
    JAX state's weights and env slice, and the shard's draws (the parent
    key folded with the shard index, then split as `update` splits it)."""
    if len(jax.devices()) < 2:
        pytest.skip("needs the conftest's virtual CPU devices")
    d = str(tmp_path_factory.mktemp("jax_two"))
    env_cfg, ppo_cfg = JEnvConfig(**W.ENV_KW), JPPOConfig(**W.PPO_KW)
    jl = JPPOLearner(env_cfg, ppo_cfg, JAX_ENVS)
    m = make_mesh(jax.devices()[:2])
    state0 = jax_shard_init(m, jl, jax.random.PRNGKey(5))
    t0 = np.where(np.arange(JAX_ENVS) % 2 == 0,
                  env_cfg.n_steps - 1 - np.arange(JAX_ENVS) % 6, 0).astype(np.int32)
    moved = state0._replace(global_step=jnp.float32(JAX_GLOBAL_STEP),
                            env_state=state0.env_state._replace(t=t0))
    state0 = jax.tree.map(lambda new, old: jax.device_put(jnp.asarray(new), old.sharding),
                          moved, state0)
    state1, metrics = jax_shard_update(m, jl)(state0)
    host = jax.tree.map(np.asarray, state0)
    n_loc = JAX_ENVS // 2
    local = JPPOLearner(env_cfg, ppo_cfg, n_loc, step_increment=JAX_ENVS)
    reset = jax.jit(local.env.reset_batch, static_argnums=1)
    flat_params = {k: np.asarray(v) for k, v in jax_to_flat(host.params).items()}
    for sh in range(2):
        sl = lambda x: x[sh * n_loc:(sh + 1) * n_loc]  # noqa: E731
        st = host._replace(rng=jax.random.fold_in(state0.rng, sh))
        reset_state, reset_obs, noise, perms = _jax_draws(local, reset, st)
        arrays = {f"params/{k}": v for k, v in flat_params.items()}
        arrays.update({f"env/{k}": sl(v) for k, v in
                       flatten_fields(jax.tree.map(np.asarray, host.env_state)).items()})
        arrays.update({f"reset/{k}": v for k, v in flatten_fields(reset_state).items()})
        np.savez(os.path.join(d, f"jax_in_{sh}.npz"), obs=sl(host.obs), reset_obs=reset_obs,
                 noise=noise, perms=perms, global_step=np.float32(JAX_GLOBAL_STEP), **arrays)
    return d, dict(params={k: np.asarray(v) for k, v in jax_to_flat(state1.params).items()},
                   metrics={k: float(v) for k, v in metrics.items()},
                   global_step=float(state1.global_step),
                   episodes_total=float(state1.episodes_total))


@pytest.fixture(scope="module")
def two_ranks(jax_two_shards):
    """One 2-rank gloo group running every 2-rank job."""
    d, _ = jax_two_shards
    return run_ranks(2, ("shard", "shard_eager", "jax", "jax_jit", "population", "train_zoo",
                         "raises"), d)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    return run_ranks(4, ("shard", "shard_eager"), str(tmp_path_factory.mktemp("four")))


# -- the tests ---------------------------------------------------------------


def test_world_one_shard_update_bit_equal_to_plain(tmp_path):
    """shard_init + shard_update over a 1-rank gloo group against the plain
    update from a copy of the same state, its generator a twin of the
    rank's: the weights, Adam's moments, every other state field, every
    metric and the generator's state after the update bit-equal."""
    group, dev = mesh.make_group("cpu", backend="gloo",
                                 init_method=f"file://{tmp_path / 'rendezvous'}",
                                 world_size=1, rank=0)
    try:
        learner = _learner(8)
        state = mesh.shard_init(group, learner, 3)
        local = mesh.local_learner(learner, 1)
        assert (local.num_envs, local.step_increment) == (8, 8)
        params = ActorCritic(27, 2, W.PPO_KW["hidden_sizes"], device="cpu")
        params.load_state_dict(state.params.state_dict())
        twin = torch.Generator()
        twin.set_state(state.generator.get_state())
        plain = dataclasses.replace(
            state, params=params, optimizer=optim.adam(params.parameters(), 3e-4),
            generator=twin)
        sharded_state, sharded = mesh.shard_update(group, learner)(state)
        plain_state, want = learner.update(plain)
    finally:
        dist.destroy_process_group()
    for a, b in zip(sharded_state.params.parameters(), plain_state.params.parameters()):
        assert torch.equal(a, b)
    for sa, sb in zip(sharded_state.optimizer.state.values(),
                      plain_state.optimizer.state.values()):
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k
    assert set(sharded) == set(want)
    for k in want:
        assert torch.equal(sharded[k], want[k]), k
    for name in ("obs", "global_step", "episodes_total", "family_counts"):
        assert torch.equal(getattr(sharded_state, name), getattr(plain_state, name)), name
    # the rank's generator advanced by one update's draws, as the twin did
    assert sharded_state.generator is state.generator
    assert torch.equal(sharded_state.generator.get_state(), twin.get_state())


def _twin(state, generator_state):
    """A copy of `state` with weights, Adam and a generator of its own."""
    params = ActorCritic(27, 2, W.PPO_KW["hidden_sizes"], device="cpu")
    params.load_state_dict(state.params.state_dict())
    opt = optim.adam(params.parameters(), 3e-4)
    opt.load_state_dict(state.optimizer.state_dict())
    gen = torch.Generator()
    gen.set_state(generator_state)
    return dataclasses.replace(state, params=params, optimizer=opt, generator=gen)


def _world_one(tmp_path):
    return mesh.make_group("cpu", backend="gloo",
                           init_method=f"file://{tmp_path / 'rendezvous'}", world_size=1, rank=0)


def test_world_one_update_jit_with_group_bit_equal(tmp_path):
    """Over a 1-rank gloo group, two updates each way from twin states with
    twin generators: `update_jit(state, group=...)` (its bodies run
    directly on the CPU, collectives included) against `update(state,
    group=...)` and the plain `update`: the weights, Adam's moments, the
    envs, the counters and every metric bit-equal."""
    group, _ = _world_one(tmp_path)
    try:
        learner = _learner(8)
        start = learner.init(3)
        gen = start.generator.get_state()
        runs = {}
        for name, fn in (("jit", lambda s: learner.update_jit(s, group=group)),
                         ("group", lambda s: learner.update(s, group=group)),
                         ("plain", learner.update)):
            state, metrics = _twin(start, gen), []
            for _ in range(2):
                state, m = fn(state)
                metrics.append(m)
            runs[name] = (state, metrics)
    finally:
        dist.destroy_process_group()
    got_state, got = runs["jit"]
    for name in ("group", "plain"):
        want_state, want = runs[name]
        for a, b in zip(got_state.params.parameters(), want_state.params.parameters()):
            assert torch.equal(a, b), name
        for sa, sb in zip(got_state.optimizer.state.values(),
                          want_state.optimizer.state.values()):
            assert all(torch.equal(sa[k], sb[k]) for k in sa), name
        for field in ("obs", "global_step", "episodes_total", "family_counts"):
            assert torch.equal(getattr(got_state, field), getattr(want_state, field)), field
        for m, w in zip(got, want):
            assert set(m) == set(w) and all(torch.equal(m[k], w[k]) for k in w), name


def test_update_jit_keys_its_program_by_group(tmp_path, monkeypatch):
    """A program made with a group is never reused without one, nor the
    reverse: the same state and draws with and without the group make two
    programs, the one without runs no collective, and each call after that
    reuses its own."""
    group, _ = _world_one(tmp_path)
    reduced = []
    all_reduce = dist.all_reduce
    monkeypatch.setattr(dist, "all_reduce",
                        lambda *a, **k: reduced.append(1) or all_reduce(*a, **k))
    try:
        learner = _learner(8)
        state = learner.init(3)
        counts = []
        for g in (group, None, group, None):
            before = len(reduced)
            learner.update_jit(state, learner.draws(state), group=g)
            counts.append(len(reduced) - before)
        keys = [key[-1] for key in learner._graphs.entries]
    finally:
        dist.destroy_process_group()
    steps = W.PPO_KW["n_epochs"] * W.PPO_KW["num_minibatches"]
    # the advantage mean and variance and the flat buffer a minibatch, the
    # episode stats once
    assert counts == [3 * steps + 1, 0, 3 * steps + 1, 0]
    assert learner._graphs.captures == 2 and keys == [group, None]


def _assert_matches_union(runs, world):
    """Every rank's weights to rtol 2e-5, atol 2e-6 of the union replay,
    and the counters exact."""
    want = _union_params(world)
    for r, run in enumerate(runs):
        for k, v in want.items():
            np.testing.assert_allclose(run["params"][k], v, rtol=RTOL, atol=ATOL,
                                       err_msg=f"rank {r} {k}")
        assert run["global_step"] == W.UPDATES * W.GLOBAL_ENVS * W.PPO_KW["n_steps"]


@pytest.mark.parametrize("world", [2, 4])
def test_shard_update_matches_union_batch(world, two_ranks, four_ranks):
    """UPDATES sharded updates over `world` gloo ranks against the union
    batch replayed in one process: every rank's weights to rtol 2e-5, atol
    2e-6, and the counters exact."""
    _assert_matches_union({2: two_ranks, 4: four_ranks}[world]["shard"], world)


@pytest.mark.parametrize("world", [2, 4])
def test_eager_shard_update_matches_union_batch(world, two_ranks, four_ranks):
    """The same updates through the eager `update(..., group=group)` (the
    update gloo runs on the card) in the same rank processes: against the
    union batch as above, and bit-equal to the captured path's weights and
    metrics on every rank."""
    runs = {2: two_ranks, 4: four_ranks}[world]
    _assert_matches_union(runs["shard_eager"], world)
    for got, want in zip(runs["shard_eager"], runs["shard"]):
        for k in want["params"]:
            np.testing.assert_array_equal(got["params"][k], want["params"][k], err_msg=k)
        assert got["metrics"] == want["metrics"]


def test_ranks_stay_replicated(two_ranks):
    """After two updates both ranks hold the same weights, Adam moments and
    metrics, and their own envs and generators."""
    a, b = two_ranks["shard"]
    for k in a["params"]:
        np.testing.assert_array_equal(a["params"][k], b["params"][k])
    for sa, sb in zip(a["adam"], b["adam"]):
        for k in sa:
            assert torch.equal(sa[k], sb[k])
    assert not torch.equal(a["generator"], b["generator"])
    assert a["metrics"] == b["metrics"]
    assert not torch.equal(a["obs"], b["obs"])


def _assert_matches_jax(runs, want):
    bound = 1e-3 * 3e-4 * W.PPO_KW["n_epochs"] * W.PPO_KW["num_minibatches"]
    assert want["metrics"]["episodes/episodes"] >= 4
    for run in runs:
        for k, v in want["params"].items():
            err = float(np.abs(run["params"][k].astype(np.float64) - v).max())
            assert err <= bound, (k, err, bound)
        got = run["metrics"]
        assert set(got) == set(want["metrics"])
        for k in ("episodes/episodes", "episodes/total", "global_step",
                  "episodes/success_rate", "episodes/failure_rate"):
            assert got[k] == want["metrics"][k], k
        for k, v in want["metrics"].items():
            assert abs(got[k] - v) <= 1e-4 * max(abs(v), 1.0), k
        assert run["global_step"] == want["global_step"]
        assert run["episodes_total"] == want["episodes_total"]


def test_two_ranks_match_jax_two_shards(jax_two_shards, two_ranks):
    _assert_matches_jax(two_ranks["jax"], jax_two_shards[1])


def test_two_ranks_captured_match_jax_two_shards(jax_two_shards, two_ranks):
    """The 2-rank update through `update_jit(..., group=group)` with JAX's
    draws injected: within the bounds above of JAX's 2-shard update, and
    bit-equal on each rank to the eager `update_from(..., group=group)`."""
    _assert_matches_jax(two_ranks["jax_jit"], jax_two_shards[1])
    for got, want in zip(two_ranks["jax_jit"], two_ranks["jax"]):
        for k in want["params"]:
            np.testing.assert_array_equal(got["params"][k], want["params"][k], err_msg=k)
        assert got["metrics"] == want["metrics"]


def test_shard_population_bit_equal_to_one_process(two_ranks):
    """Each rank trains its block of POP_SEEDS with no collective: every
    member's weights after one update are bit-equal to the same member's
    in a one-process population of that block, and equal to the
    one-process population of all S at rtol 2e-5, atol 2e-6 (the stacked
    products and per-member reductions round in an order that depends on
    S: ~1e-8 apart on this CPU)."""
    trainer = ZooTrainer(EnvConfig(**W.ENV_KW), PPOConfig(**W.PPO_KW), W.POP_ENVS, device="cpu")
    whole, _ = trainer.update(trainer.init(W.POP_SEEDS))
    runs = two_ranks["population"]
    assert [s for run in runs for s in run["seeds"]] == list(W.POP_SEEDS)
    for run in runs:
        block, _ = trainer.update(trainer.init(run["seeds"]))
        for i, s in enumerate(run["seeds"]):
            flat = run["members"][s]
            want = params_to_flat_dict(block.params.member(i))
            near = params_to_flat_dict(whole.params.member(W.POP_SEEDS.index(s)))
            for k in want:
                np.testing.assert_array_equal(flat[k], want[k], err_msg=f"seed {s} {k}")
                np.testing.assert_allclose(flat[k], near[k], rtol=RTOL, atol=ATOL,
                                           err_msg=f"seed {s} {k}")


def test_train_zoo_over_two_ranks_writes_every_seed(jax_two_shards, two_ranks):
    """`train_zoo(group=...)`: each rank writes its own seeds' agent files,
    the layout `scripts/select_agents.py` reads, each the weights of its
    block's update."""
    d, _ = jax_two_shards
    for run in two_ranks["population"]:
        for s, flat in run["members"].items():
            with np.load(os.path.join(d, "zoo", f"seed_{s}", "new_agent.npz")) as z:
                assert sorted(z) == sorted(flat)
                for k in flat:
                    np.testing.assert_array_equal(z[k], flat[k], err_msg=f"seed {s} {k}")


def test_num_envs_not_divisible_raises(two_ranks):
    for run in two_ranks["raises"]:
        assert run["num_envs"] == "num_envs=3 % 2 ranks != 0"


def test_population_not_divisible_raises(two_ranks):
    for run in two_ranks["raises"]:
        assert run["population"] == "population size 3 not divisible by 2 ranks"


def test_init_distributed_lone_process_is_noop(monkeypatch):
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    info = init_distributed()
    assert not dist.is_initialized()
    assert info == host_info() and info.is_coordinator
    assert (info.process_index, info.process_count, info.global_device_count) == (0, 1, 1)


def test_multihost_smoke_script():
    out = subprocess.run([sys.executable, "-m", "drone2d_tpu_torch.scripts.multihost_smoke",
                          "--device", "cpu", "--timeout", "120"], cwd=ROOT, env=_env(), capture_output=True,
                         text=True, timeout=150)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "MULTIHOST SMOKE OK" in out.stdout
    assert out.stdout.count(" OK") == 3  # each rank's line and the verdict


def test_ddp_check_script_under_torchrun():
    """The cross-rank check (`scripts/ddp_check.py`) under torchrun with 2
    gloo ranks on the CPU: each rank within rtol 2e-5, atol 2e-6 of the
    union replay, the ranks bit-equal, the captured update bit-equal to the
    eager one, DDP CHECK OK."""
    argv = [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node=2", "-m", "drone2d_tpu_torch.scripts.ddp_check", "--device",
            "cpu", "--num-envs", "8", "--ppo-n-steps", "8", "--ppo-num-minibatches", "4",
            "--ppo-n-epochs", "2", "--env-path-table-n", "128"]
    out = subprocess.run(argv, cwd=ROOT, env=_env(), capture_output=True, text=True,
                         timeout=150)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-1] == "DDP CHECK OK"
    rows = json.loads(lines[-2])["ranks"]
    assert [r["rank"] for r in rows] == [0, 1]
    assert all(r["backend"] == "gloo" and r["replicated"] and r["excess"] <= 1.0
               and r["global_step"] == 64.0 for r in rows)
    # the captured update (its bodies run directly on the CPU) against the
    # eager one from a twin state, then timed in turn
    assert all(r["captured"] and r["eager_equal"] and r["eager_excess"] == 0.0
               and r["launches"] == r["capture_launches"] == 0
               and [len(r["seconds"][k]) for k in ("captured", "eager")] == [2, 2]
               for r in rows)


def test_shard_restore_resets_each_rank_slice(two_ranks):
    """Rank 0's checkpoint of the sharded state, restored on both ranks:
    the step and the weights as saved and the same on both; each rank's
    generators seeded from the checkpoint's stored seed as `shard_init`
    seeds them from the run's (`rank_generator`, `env_generator`), its envs
    reset once from its own env generator and its draw generator untouched."""
    a, b = (run["restored"] for run in two_ranks["shard"])
    saved = two_ranks["shard"][0]
    assert a["step"] == b["step"] == saved["global_step"] == a["global_step"]
    for k in saved["params"]:
        np.testing.assert_array_equal(a["params"][k], saved["params"][k])
        np.testing.assert_array_equal(b["params"][k], saved["params"][k])
    # the seed save_checkpoint stores: drawn from a twin of rank 0's generator
    twin = torch.Generator()
    twin.set_state(saved["generator"])
    seed = int(torch.randint(0, 2**63 - 1, (), generator=twin))
    local = mesh.local_learner(W._learner(W.GLOBAL_ENVS), 2)
    step = torch.tensor(saved["global_step"], dtype=torch.float32)
    for rank, run in enumerate((a, b)):
        assert torch.equal(run["generator"], mesh.rank_generator(seed, rank, "cpu").get_state())
        _, obs = local.env.reset_batch(mesh.env_generator(seed, rank, "cpu"),
                                       local.num_envs, step,
                                       local._reset_probs(local.initial_rehearsal_probs()))
        assert torch.equal(run["obs"], obs), rank
    assert not torch.equal(a["generator"], b["generator"])
    assert not torch.equal(a["obs"], b["obs"])


def test_train_under_torchrun_checkpoints(tmp_path):
    """Two CPU ranks under torchrun train 2 updates: rank 0 alone prints
    and writes the checkpoint, the metrics rows and new_agent.npz, which a
    resume reads back (the distributed resume: the test above)."""
    d = tmp_path / "run"
    argv = [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node=2", "-m", "drone2d_tpu_torch.train", "--device", "cpu",
            "--num-envs", "8", "--ppo-n-steps", "8", "--ppo-num-minibatches", "4",
            "--ppo-n-epochs", "2", "--env-path-table-n", "128", "--max-updates", "2",
            "--log-every-updates", "1", "--checkpoint-dir", str(d),
            "--metrics-path", str(d / "metrics.jsonl")]
    out = subprocess.run(argv, cwd=ROOT, env=_env(), capture_output=True, text=True,
                         timeout=150)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert out.stdout.count("saved final checkpoint at step 128") == 1, out.stdout
    assert out.stdout.count("loss") == 2, out.stdout
    assert [p.name for p in d.glob("ckpt_*.pt")] == ["ckpt_128.pt"]
    rows = [json.loads(line) for line in open(d / "metrics.jsonl")]
    assert [r["global_step"] for r in rows] == [64, 128]
    assert all(np.isfinite(r["loss"]) for r in rows)
    learner = PPOLearner(EnvConfig(path_table_n=128), PPOConfig(n_steps=8, num_minibatches=4,
                                                                n_epochs=2), 8, device="cpu")
    state, step = restore_checkpoint(str(d), learner)
    assert step == 128 and float(state.global_step) == 128.0
    with np.load(d / "new_agent.npz") as z:
        for k, v in params_to_flat_dict(state.params).items():
            np.testing.assert_array_equal(z[k], v)

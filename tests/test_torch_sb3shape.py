"""The reference's own training shape, on the CPU: the port against the
JAX package at SB3's `PPO("MlpPolicy")` defaults (14 envs x 2048-step
rollouts, 448 minibatches of 64, the exact shuffle, the 64-64 policy), as
the JAX package's SB3-shape hunt trained (`artifacts/campaigns/r3/
r3_9m_sb3shape/select.json`, 8 seeds x 9M steps, `docs/RESULTS.md:604-621`).

Here: `snapshot_schedule` gives exactly the record's checkpoint labels;
one epoch of SGD on a JAX 2048-step rollout batch with the JAX update's own
permutations agrees with the JAX update, and GAE over T=2048 with the JAX
package's; `update_jit` with its rollout recorded in chunks (a rollout
longer than `ROLLOUT_CHUNK`; here the chunk is cut to a few steps) is
bit-equal to `update` in every shuffle, for a population under adaptive
rehearsal and with given draws; `hunt_check` names the record, passes it
against itself, fails it moved down by 0.15 success rate, and passes the
port's committed SB3-shape hunts against their records (the r3 record and
the round-4 rerun at PP_rew_max 8).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drone2d_tpu.config import EnvConfig as JEnvConfig, PPOConfig as JPPOConfig
from drone2d_tpu.learn.gae import compute_gae as jax_gae
from drone2d_tpu.learn.ppo import PPOLearner as JPPOLearner, TrainState as JTrainState
from drone2d_tpu.models.policy import init_actor_critic as jax_init
from drone2d_tpu_torch.config import EnvConfig, PPOConfig
from drone2d_tpu_torch.learn import ppo
from drone2d_tpu_torch.learn.gae import compute_gae
from drone2d_tpu_torch.learn.ppo import PPOLearner
from drone2d_tpu_torch.learn.zoo import ZooTrainer, snapshot_schedule
from drone2d_tpu_torch.scripts import hunt_check
from tests.test_torch_ppo import (
    _assert_params_close,
    _jax_draws,
    _params_bound,
    _port_batch,
    _port_state,
    _scaled_err,
)

ROOT = os.path.join(os.path.dirname(__file__), "..")
PORT_RECORD = os.path.join(ROOT, "artifacts", "campaigns", "torch", "sb3_port_select.json")
# SB3's shape: 14 envs x 2048 steps, 448 minibatches of 64; PPOConfig's
# defaults otherwise (64-64, exact); one epoch, as each of the 10 is alike
N, T, MINIBATCHES = 14, 2048, 448
SB3_KW = dict(n_steps=T, num_minibatches=MINIBATCHES, n_epochs=1)
ENV_KW = dict(path_table_n=128)
RECORD_STEPS = ["2236416", "4501504", "6766592"]
SEEDS = range(40, 48)


def test_snapshot_schedule_gives_the_sb3_record_labels():
    """--snapshots 3 --total-timesteps 9000000 at 14 envs x 2048 steps: 314
    updates, snapshots after 78, 157 and 236, whose env steps and `final`
    are exactly the record's labels for seeds 40-47."""
    spu = N * T
    n_updates, snaps = snapshot_schedule(9_000_000, spu, 3)
    assert (n_updates, snaps) == (314, {78, 157, 236})
    with open(hunt_check.REFERENCE_SB3) as f:
        record = json.load(f)
    labels = {f"seed_{s}/{c}" for s in SEEDS
              for c in [str(u * spu) for u in sorted(snaps)] + ["final"]}
    assert set(record) == labels
    assert sorted({k.split("/")[1] for k in record} - {"final"}, key=int) == RECORD_STEPS


@pytest.fixture(scope="module")
def jax_sb3():
    """A fresh JAX learner at the SB3 shape (one epoch): its rollout batch
    from the initial state, its update from the same state and the draws
    of that update (its exact shuffle)."""
    jl = JPPOLearner(JEnvConfig(**ENV_KW), JPPOConfig(**SB3_KW), N)
    reset = jax.jit(jl.env.reset_batch, static_argnums=1)
    params = jax_init(jax.random.PRNGKey(0), 27, 2, JPPOConfig().hidden_sizes)
    env_state, obs = reset(jax.random.PRNGKey(1), N, jnp.float32(0.0))
    state = JTrainState(
        params=params, opt_state=jl.tx.init(params), env_state=env_state, obs=obs,
        rng=jax.random.PRNGKey(2), global_step=jnp.float32(0.0),
        episodes_total=jnp.float32(0.0), rehearsal_probs=jnp.zeros(7),
        family_counts=jnp.zeros(8), family_wins=jnp.zeros(8),
    )
    batch, last_values = jax.jit(jl.rollout)(state)[1:3]
    new_state, metrics = jax.jit(jl.update)(state)
    return dict(state=state, batch=jax.tree.map(np.asarray, batch),
                last_values=np.asarray(last_values), new_state=new_state,
                metrics=jax.tree.map(np.asarray, metrics),
                draws=_jax_draws(jl, reset, state))


def test_learn_from_at_the_sb3_shape_matches_jax(jax_sb3):
    """GAE over the JAX 2048-step batch of 14 envs, then one epoch of 448
    minibatches of 64 under the JAX update's own exact shuffle, hidden (64,
    64), from the JAX package's initial weights and Adam state: the
    parameters agree with the JAX update's to 1e-3 of the lr x SGD-steps
    budget, the SGD metrics to 1e-5 of max(|value|, 1), as
    tests/test_torch_ppo.py holds them at its small shape."""
    learner = PPOLearner(EnvConfig(**ENV_KW), PPOConfig(**SB3_KW), N, device="cpu")
    assert (learner.cfg.shuffle, learner.cfg.hidden_sizes, learner.minibatch_size) == (
        "exact", (64, 64), 64)
    state = _port_state(learner, jax_sb3["state"])
    perms = torch.tensor(jax_sb3["draws"][3])
    assert perms.shape == (1, N * T)
    metrics = learner.learn_from(state, _port_batch(jax_sb3["batch"]),
                                 torch.tensor(jax_sb3["last_values"]), perms)
    _assert_params_close(state.params, jax_sb3["new_state"].params, _params_bound(learner))
    jm = jax_sb3["metrics"]
    for k, v in metrics.items():
        assert abs(float(v) - float(jm[k])) <= 1e-5 * max(abs(float(jm[k])), 1.0), k
    assert all(float(s["step"]) == MINIBATCHES for s in state.optimizer.state.values())


def test_gae_over_2048_steps_matches_jax(jax_sb3):
    """compute_gae over the JAX batch's T=2048 rewards, values and dones
    (episodes ending inside it) against the JAX package's: advantages and
    returns to 1e-5 of max(1, max |JAX|)."""
    b = jax_sb3["batch"]
    assert b.dones.shape == (T, N) and b.dones.any()
    kw = dict(gamma=JPPOConfig().gamma, gae_lambda=JPPOConfig().gae_lambda)
    want = jax_gae(jnp.asarray(b.rewards), jnp.asarray(b.values), jnp.asarray(b.dones),
                   jnp.asarray(jax_sb3["last_values"]), **kw)
    got = compute_gae(torch.tensor(b.rewards), torch.tensor(b.values), torch.tensor(b.dones),
                      torch.tensor(jax_sb3["last_values"]), **kw)
    for g, w in zip(got, want):
        assert _scaled_err(g.numpy(), np.asarray(w)) <= 1e-5


def test_rollout_chunks():
    """update_jit's rollout graphs: one up to ROLLOUT_CHUNK steps, else
    chunks of ROLLOUT_CHUNK and one of the rest; the capture's warm-up
    launches one run of each distinct graph's steps and the last values."""
    K = ppo.ROLLOUT_CHUNK
    assert ppo.rollout_chunks(128) == [128] and ppo.rollout_chunks(K) == [K]
    assert ppo.rollout_chunks(T) == [K] * (T // K)
    assert ppo.rollout_chunks(2 * K + 5) == [K, K, 5]
    assert ppo.warmup_launches(128) == 129
    assert ppo.warmup_launches(2 * K + 5) == K + 5 + 1


def _same(a, b):
    for x, y in zip(a.params.parameters(), b.params.parameters()):
        assert torch.equal(x, y)
    assert torch.equal(a.obs, b.obs) and torch.equal(a.global_step, b.global_step)
    assert torch.equal(a.episodes_total, b.episodes_total)
    assert torch.equal(a.family_counts, b.family_counts)


@pytest.mark.parametrize("case", ["exact", "affine", "timeperm", "population_rehearsal",
                                  "given_draws"])
def test_chunked_update_jit_bit_equal_to_update(monkeypatch, case):
    """A rollout of 20 steps recorded as chunks of 8, 8 and 4 (ROLLOUT_CHUNK
    cut to 8; 32 steps in 4 chunks for 'affine', whose batch is a power of
    two): update_jit bit-equal to update over 2 updates from twin states,
    in each shuffle, for a population of 2 under adaptive rehearsal (the
    family counts written through the chunks), and with the draws given
    (update_jit(state, draws) against update_from(state, *draws))."""
    monkeypatch.setattr(ppo, "ROLLOUT_CHUNK", 8)
    cfg = PPOConfig(n_steps=32 if case == "affine" else 20, num_minibatches=4, n_epochs=2,
                    shuffle=case if case in ("exact", "affine", "timeperm") else "exact",
                    hidden_sizes=(16, 16))
    if case == "population_rehearsal":
        # a 12-step episode cap: episodes end inside the rollout
        env = EnvConfig(adaptive_rehearsal=True, stage_mix_prob=0.3, corridor_mix_prob=0.1,
                        n_steps=12, **ENV_KW)
        learner = ZooTrainer(env, cfg, 4, device="cpu")
        a, b = learner.init([1, 2]), learner.init([1, 2])
    else:
        learner = PPOLearner(EnvConfig(**ENV_KW), cfg, 4, device="cpu")
        a, b = learner.init(3), learner.init(3)
    assert len(ppo.rollout_chunks(cfg.n_steps)) > 1
    for _ in range(2):
        if case == "given_draws":
            draws = learner.draws(a)
            a, ma = learner.update_jit(a, draws)
            b, mb = learner.update_from(b, *draws)
        else:
            a, ma = learner.update_jit(a)
            b, mb = learner.update(b)
        assert set(ma) == set(mb) and all(torch.equal(ma[k], mb[k]) for k in mb)
        _same(a, b)
    program = next(iter(learner._graphs.entries.values()))
    assert program.chunks == ppo.rollout_chunks(cfg.n_steps)
    if case == "population_rehearsal":
        assert float(a.family_counts.sum()) > 0


# -- the learning-parity gate against the SB3-shape record ---------------------


@pytest.fixture(scope="module")
def record():
    with open(hunt_check.REFERENCE_SB3) as f:
        return json.load(f)


def test_hunt_check_names_the_sb3_record(record):
    assert os.path.samefile(hunt_check.REFERENCE_SB3, os.path.join(
        ROOT, "artifacts", "campaigns", "r3", "r3_9m_sb3shape", "select.json"))
    assert "SB3-shape hunt" in hunt_check.reference_name(hunt_check.REFERENCE_SB3)
    # named by its path, not its file name: another hunt's select.json is not it
    other = os.path.join(ROOT, "artifacts", "campaigns", "r3", "r3_9m_refbudget", "select.json")
    assert hunt_check.reference_name(other).endswith("r3_9m_refbudget/select.json")
    assert "hunt 8" in hunt_check.reference_name(hunt_check.REFERENCE_H8)


def test_the_sb3_record_against_itself_passes(record):
    """Every checkpoint compared, Bonferroni over 4 (p >= 0.0025), p 1."""
    table = hunt_check.seed_table(record)
    result = hunt_check.compare(table, table)
    assert [r["checkpoint"] for r in result["rows"]] == RECORD_STEPS + ["final"]
    assert result["threshold"] == pytest.approx(0.0025)
    assert result["ok"] and all(r["p"] == pytest.approx(1.0) for r in result["rows"])


def test_the_sb3_record_moved_down_fails(record):
    """Every candidate's 12 success rates moved down by 0.15: some
    checkpoint fails the gate."""
    moved = {k: {s: {**v, "success_rate": v["success_rate"] - 0.15} for s, v in per.items()}
             for k, per in record.items()}
    result = hunt_check.compare(hunt_check.seed_table(moved), hunt_check.seed_table(record))
    assert not result["ok"], hunt_check.format_report(result)


@pytest.mark.parametrize("port_file, reference", [
    ("sb3_port_select.json", hunt_check.REFERENCE_SB3),
    ("sb3_pp8_port_select.json", os.path.join(ROOT, "artifacts", "campaigns", "r4",
                                              "r4_9m_sb3_pp8_select.json")),
], ids=["r3_sb3shape", "r4_sb3_pp8"])
def test_the_ports_sb3_hunts_pass_against_the_records(port_file, reference):
    """The port's committed SB3-shape hunts (`sweep --vmap 8 --num-envs 14
    --n-steps 2048 --num-minibatches 448 --shuffle exact --total-timesteps
    9000000` on the card with the record's reward knobs: seeds 40-47 at the
    published recipe, and the round-4 rerun's seeds 800-807 at PP_rew_max
    8; each selected by `select_agents --episodes 100 --seed 0`): each
    holds its record's 32 labels, and `hunt_check` passes at all 4
    checkpoints."""
    path = os.path.join(os.path.dirname(PORT_RECORD), port_file)
    with open(path) as f:
        port = json.load(f)
    with open(reference) as f:
        assert set(port) == set(json.load(f))
    assert hunt_check.main([path, "--reference", reference]) == 0

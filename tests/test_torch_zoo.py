"""The port's population (zoo) trainer against S single-seed learners and
against the JAX package's `ZooTrainer`, on the CPU.

A population of S members is one `ActorCritic` with a leading member axis
and one env batch of S x N; it must train each member as the single-seed
`PPOLearner` does from the same draws (to float32 rounding: the stacked
products and the per-member sums run in another order), and as the JAX
package's vmapped update does from the JAX draws (injected member by member,
as tests/test_torch_ppo.py injects them into one learner).  Also: the
stacked plain kernel against S unstacked calls, the per-member clip against
vmapped optax, `save_zoo` and `train_zoo`'s snapshot files against the JAX
package's, the warm start, and the sweep and select CLIs end to end.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from drone2d_tpu.config import EnvConfig as JEnvConfig, PPOConfig as JPPOConfig
from drone2d_tpu.learn import zoo as jzoo
from drone2d_tpu.models.policy import (
    flat_dict_to_params as jax_from_flat,
    policy_value as jax_policy_value,
)
from drone2d_tpu_torch.compat.from_jax import (
    env_state_from_numpy,
    params_to_flat,
    zoo_state_from_numpy,
)
from drone2d_tpu_torch.config import EnvConfig, PPOConfig
from drone2d_tpu_torch.env.types import cat_states
from drone2d_tpu_torch.learn import optim
from drone2d_tpu_torch.learn.ppo import PPOLearner
from drone2d_tpu_torch.learn.zoo import ZooTrainer, assemble, save_zoo, train_zoo
from drone2d_tpu_torch.models.policy import ActorCritic, stack_params, unstack_params
from drone2d_tpu_torch.ops.fused_policy import fused_sample_action
from drone2d_tpu_torch.scripts import select_agents, sweep
from drone2d_tpu_torch.train import main as train_main
from drone2d_tpu_torch.utils.checkpoint import save_checkpoint
from tests.test_torch_ppo import _assert_params_close, _jax_draws, _params_bound

torch.set_num_threads(1)

N, T, HIDDEN, LR = 8, 8, (32, 32), 3e-4
SEEDS = [3, 4, 5]
SHUFFLES = ("exact", "affine", "timeperm")
ENV_KW = dict(path_table_n=128)
CAP = JEnvConfig().n_steps


def _ppo_kw(shuffle="timeperm"):
    return dict(n_steps=T, num_minibatches=4, n_epochs=2, shuffle=shuffle,
                hidden_sizes=HIDDEN, learning_rate=LR)


def _near_cap(t):
    """Every other env 1..6 steps from the episode cap, so that episodes end
    (and auto-reset to the template) inside an 8-step rollout."""
    n = t.shape[-1]
    return np.where(np.arange(n) % 2 == 0, CAP - 1 - np.arange(n) % 6, 0).astype(np.int32)


def _scaled(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


# -- the stacked kernel's plain version and the per-member clip ----------------


def test_stacked_plain_kernel_equals_unstacked_calls():
    """(a) One call for S = 3 members, obs (3, 37, 27): each member's outputs
    equal its own unstacked call exactly (the plain version samples member by
    member), and no kernel launch is counted on the CPU."""
    gen = torch.Generator().manual_seed(0)
    members = [ActorCritic(27, 2, HIDDEN, generator=gen, device="cpu") for _ in range(3)]
    with torch.no_grad():
        for m in members:
            m.log_std.copy_(torch.randn(2, generator=gen))
    stack = stack_params(members)
    obs, noise = torch.randn(3, 37, 27, generator=gen), torch.randn(3, 37, 2, generator=gen)
    before = fused_sample_action.launches
    got = stack.sample_action(obs, noise=noise)
    assert fused_sample_action.launches == before
    assert [tuple(x.shape) for x in got] == [(3, 37, 2), (3, 37), (3, 37)]
    for i, m in enumerate(members):
        for g, w in zip(got, m.sample_action(obs[i], noise=noise[i])):
            assert torch.equal(g[i], w)
    # member views alias the stack; unstacked copies do not
    copies = unstack_params(stack)
    for i, m in enumerate(members):
        for a, b, c in zip(m.parameters(), copies[i].parameters(),
                           stack.member(i).parameters()):
            assert torch.equal(a, b) and torch.equal(a, c)
    with torch.no_grad():
        stack.log_std[1, 0] += 1.0
    moved = float(stack.log_std.detach()[1, 0])
    assert float(stack.member(1).log_std[0]) == moved
    assert float(copies[1].log_std.detach()[0]) != moved
    with pytest.raises(ValueError, match="obs has shape"):
        stack.sample_action(obs[0], noise=noise[0])


def test_member_clip_matches_vmapped_optax():
    """clip_by_global_norm_ with the member axis against
    vmap(optax.clip_by_global_norm(0.5)) on
    3 members' gradients, one clipped (global norm ~6), one left as it is
    (~0.02) and one between: the norms and the clipped leaves to 1e-6 of
    each leaf's largest magnitude, the unclipped member bit for bit."""
    rng = np.random.default_rng(0)
    shapes = {k: v.shape for k, v in params_to_flat(ActorCritic(27, 2, HIDDEN,
                                                                device="cpu")).items()}
    scale = np.array([0.05, 2e-4, 5e-3])
    grads = {k: (scale.reshape((3,) + (1,) * len(sh))
                 * rng.standard_normal((3,) + sh)).astype(np.float32)
             for k, sh in shapes.items()}
    want, _ = jax.vmap(lambda g: optax.clip_by_global_norm(0.5).update(g, optax.EmptyState()))(
        {k: jnp.asarray(v) for k, v in grads.items()})
    want_norm = jax.vmap(optax.global_norm)({k: jnp.asarray(v) for k, v in grads.items()})
    leaves = [torch.tensor(grads[k]) for k in shapes]
    norm = optim.clip_by_global_norm_(leaves, 0.5, members=3)
    np.testing.assert_allclose(norm.numpy(), np.asarray(want_norm), rtol=1e-6)
    assert float(norm[0]) > 0.5 > float(norm[1])
    for k, leaf in zip(shapes, leaves):
        w = np.asarray(want[k])
        assert np.abs(leaf.numpy() - w).max() <= 1e-6 * np.abs(w).max(), k
        np.testing.assert_array_equal(leaf.numpy()[1], grads[k][1])


# -- a population against S single-seed learners --------------------------------


def _singles(learner, seeds):
    states = []
    for s in seeds:
        st = learner.init(s)
        t = torch.tensor(_near_cap(st.env_state.t.numpy()))
        states.append(dataclasses.replace(st, env_state=dataclasses.replace(st.env_state, t=t)))
    return states


@pytest.mark.parametrize("shuffle", SHUFFLES)
def test_population_matches_single_seed_updates(shuffle):
    """(b) Two updates of a population of 3 against 3 single-seed
    `PPOLearner.update_from` calls fed the population's own draws: weights
    and metrics to 1e-6 of scale (max(1, max |single|)), the episode counts
    and step counters exactly, the members' draws from their own generators
    as the single learner draws them."""
    env_cfg, ppo_cfg = EnvConfig(**ENV_KW), PPOConfig(**_ppo_kw(shuffle))
    learner = PPOLearner(env_cfg, ppo_cfg, N, device="cpu")
    trainer = ZooTrainer(env_cfg, ppo_cfg, N, device="cpu")
    singles = _singles(learner, SEEDS)
    zoo = assemble(_singles(learner, SEEDS), LR)
    # the population draws what each single-seed learner would
    twin = _singles(learner, SEEDS)
    reset_state, reset_obs, noise, perms = trainer.draws(zoo)
    for m, st in enumerate(twin):
        rs, ro, nz, pm = learner.draws(st)
        assert torch.equal(ro, reset_obs[m * N:(m + 1) * N]) and torch.equal(nz, noise[:, m])
        assert torch.equal(rs.body.pos, reset_state.body.pos[m * N:(m + 1) * N])
        assert torch.equal(pm, perms[m])

    finished = 0.0
    for update in range(2):
        if update:
            reset_state, reset_obs, noise, perms = trainer.draws(zoo)
        zoo, metrics = trainer.update_from(zoo, reset_state, reset_obs, noise, perms)
        for m in range(3):
            # each single-seed learner draws from its own generator, seeded
            # and advanced as member m's: the same draws
            singles[m], want = learner.update(singles[m])
            assert set(metrics) == set(want)
            for k, v in want.items():
                got = float(metrics[k][m])
                if k in ("episodes/episodes", "episodes/total", "global_step",
                         "episodes/success_rate", "episodes/failure_rate",
                         "episodes/collision_rate"):
                    assert got == float(v), (k, got, float(v))
                assert abs(got - float(v)) <= 1e-6 * max(abs(float(v)), 1.0), (k, got, float(v))
            finished += float(want["episodes/episodes"])
            got, want = params_to_flat(zoo.params.member(m)), params_to_flat(singles[m].params)
            for k in want:
                assert _scaled(got[k], want[k]) <= 1e-6, (update, m, k)
            assert float(zoo.episodes_total[m]) == float(singles[m].episodes_total)
    assert finished >= 6
    for w in zoo.params.pi[0].w, zoo.params.log_std:
        assert not torch.equal(w[0], w[1])


# -- the population against the JAX package's ZooTrainer ------------------------


@pytest.fixture(scope="module")
def jax_zoo():
    """JAX's ZooTrainer of 3 members (timeperm, the flagship recipe's
    shuffle), one compile each of its init and update: one update from init
    gives a mid-training state, then the update under test from it at
    curriculum stage 2 with every other env near the cap, with each member's
    draws reproduced from its key."""
    trainer = jzoo.ZooTrainer(JEnvConfig(**ENV_KW), JPPOConfig(**_ppo_kw()), N)
    reset = jax.jit(trainer.learner.env.reset_batch, static_argnums=1)
    state, _ = trainer.update(trainer.init(SEEDS))
    t = np.stack([_near_cap(np.zeros(N)) for _ in SEEDS])
    state = state._replace(global_step=jnp.full((3,), 8e5, jnp.float32),
                           env_state=state.env_state._replace(t=jnp.asarray(t)))
    new_state, metrics = trainer.update(state)
    draws = [_jax_draws(trainer.learner, reset, jax.tree.map(lambda x: x[m], state))
             for m in range(3)]
    return dict(trainer=trainer, state=state, new_state=new_state,
                metrics=jax.tree.map(np.asarray, metrics), draws=draws)


def test_zoo_update_matches_jax(jax_zoo):
    """(c) One population update from the JAX zoo's mid-training state
    (parameters, Adam state at count 8, envs), each member's JAX draws
    injected: weights to 1e-3 of the lr x SGD-steps budget and metrics to
    1e-4 of max(|v|, 1), the tolerances of test_update_matches_jax; the
    episode counts and step counters exactly."""
    trainer = ZooTrainer(EnvConfig(**ENV_KW), PPOConfig(**_ppo_kw()), N, device="cpu")
    state = zoo_state_from_numpy(jax.tree.map(np.asarray, jax_zoo["state"]), LR, device="cpu")
    draws = jax_zoo["draws"]
    new_state, metrics = trainer.update_from(
        state, cat_states([env_state_from_numpy(d[0], device="cpu") for d in draws]),
        torch.tensor(np.concatenate([d[1] for d in draws])),
        torch.tensor(np.stack([d[2] for d in draws], axis=1)),
        torch.tensor(np.stack([d[3] for d in draws])))
    jm = jax_zoo["metrics"]
    assert set(metrics) == set(jm)
    assert (jm["episodes/episodes"] >= 2).all()
    for k, v in metrics.items():
        assert v.shape == jm[k].shape == (3,), k
        want = jm[k].astype(np.float64)
        assert (np.abs(v.numpy() - want) <= 1e-4 * np.maximum(np.abs(want), 1.0)).all(), k
    for k in ("episodes/episodes", "episodes/total", "global_step",
              "episodes/success_rate", "episodes/failure_rate"):
        np.testing.assert_array_equal(metrics[k].numpy(), jm[k], err_msg=k)
    js = jax_zoo["new_state"]
    _assert_params_close(new_state.params, js.params, _params_bound(trainer))
    np.testing.assert_array_equal(new_state.global_step.numpy(), np.asarray(js.global_step))
    np.testing.assert_array_equal(new_state.episodes_total.numpy(),
                                  np.asarray(js.episodes_total))
    assert all(float(s["step"]) == 16 for s in new_state.optimizer.state.values())


def _files(root):
    return {d: sorted(os.listdir(os.path.join(root, d))) for d in sorted(os.listdir(root))}


@pytest.mark.parametrize("schedule", [dict(snapshots=2), dict(snapshot_steps=[1, 3 * N * T,
                                                                              99 * N * T])])
def test_train_zoo_writes_the_files_jax_writes(jax_zoo, monkeypatch, tmp_path, capsys, schedule):
    """(d) train_zoo over 4 updates of 3 seeds writes the same seed_<s>/
    files as the JAX package's train_zoo on the same arguments (evenly
    spaced snapshots, or requested steps with their clamps); every .npz
    loads in the JAX package and holds the member's weights; the log line
    matches."""
    # JAX's train_zoo builds the fixture's trainer (the same arguments), so
    # that its update compiles once
    monkeypatch.setattr(jzoo, "ZooTrainer", lambda *a, **k: jax_zoo["trainer"])
    jzoo.train_zoo(JEnvConfig(**ENV_KW), JPPOConfig(**_ppo_kw()), N, SEEDS, 4 * N * T,
                   str(tmp_path / "jax"), log_every=2, **schedule)
    capsys.readouterr()
    state = train_zoo(EnvConfig(**ENV_KW), PPOConfig(**_ppo_kw()), N, SEEDS, 4 * N * T,
                      str(tmp_path / "port"), log_every=2, device="cpu", **schedule)
    lines = capsys.readouterr().out.splitlines()
    assert [line.split()[:4] for line in lines] == [
        ["update", "2/4", "step", "128/seed"], ["update", "4/4", "step", "256/seed"]]
    files = _files(tmp_path / "port")
    assert files == _files(tmp_path / "jax")
    assert len(files["seed_3"]) >= 3
    obs = np.random.default_rng(0).standard_normal((16, 27)).astype(np.float32)
    for m, s in enumerate(SEEDS):
        for name in files[f"seed_{s}"]:
            flat = dict(np.load(tmp_path / "port" / f"seed_{s}" / name))
            assert all(np.isfinite(np.asarray(x)).all()
                       for x in jax_policy_value(jax_from_flat(flat), jnp.asarray(obs)))
        final = dict(np.load(tmp_path / "port" / f"seed_{s}" / "new_agent.npz"))
        for k, v in params_to_flat(state.params.member(m)).items():
            np.testing.assert_array_equal(final[k], v)


def test_save_zoo_layout(tmp_path):
    trainer = ZooTrainer(EnvConfig(**ENV_KW), PPOConfig(**_ppo_kw()), N, device="cpu")
    state = trainer.init([11, 12])
    paths = save_zoo(state, [11, 12], str(tmp_path))
    paths += save_zoo(state, [11, 12], str(tmp_path), step=64)
    assert paths == [str(tmp_path / f"seed_{s}" / n) for n in ("new_agent.npz", "ckpt_64.npz")
                     for s in (11, 12)]
    one = PPOLearner(EnvConfig(**ENV_KW), PPOConfig(**_ppo_kw()), N, device="cpu").init(12)
    for k, v in params_to_flat(one.params).items():
        np.testing.assert_array_equal(dict(np.load(paths[1]))[k], v)


def test_warm_start_gives_each_member_its_own_copy(tmp_path, capsys):
    """(e) Every member starts from the agent, in storage of its own (a copy,
    not a broadcast view: Adam updates in place); after one update the
    members differ.  train_zoo warm-starts from the port's checkpoint
    directory, and refuses an agent of other hidden sizes."""
    ckpt = str(tmp_path / "base")
    learner = PPOLearner(EnvConfig(**ENV_KW), PPOConfig(**_ppo_kw()), N, device="cpu")
    agent = learner.init(99).params
    trainer = ZooTrainer(EnvConfig(**ENV_KW), PPOConfig(**_ppo_kw()), N, device="cpu")
    state = trainer.init([0, 1, 2], params=agent)
    for p, a in zip(state.params.parameters(), agent.parameters()):
        assert p.stride(0) == a.numel() and p.untyped_storage().data_ptr() != \
            a.untyped_storage().data_ptr()
        for m in range(3):
            assert torch.equal(p[m], a)
    state, _ = trainer.update(state)
    w = state.params.pi[0].w
    assert not torch.equal(w[0], w[1]) and not torch.equal(w[1], w[2])
    assert float((w[0] - agent.pi[0].w).detach().abs().max()) < 0.1

    save_checkpoint(ckpt, learner.init(99))
    capsys.readouterr()
    out = train_zoo(EnvConfig(**ENV_KW), PPOConfig(**_ppo_kw()), N, [0, 1], N * T,
                    str(tmp_path / "ft"), snapshots=0, init_params=ckpt, device="cpu")
    assert f"warm-started 2 members from {ckpt}" in capsys.readouterr().out
    assert float((out.params.pi[0].w[1] - agent.pi[0].w).detach().abs().max()) < 0.1
    with pytest.raises(ValueError, match="hidden_sizes"):
        train_zoo(EnvConfig(**ENV_KW), PPOConfig(**_ppo_kw()).replace(hidden_sizes=(16, 16)),
                  N, [0], N * T, str(tmp_path / "ft"), snapshots=0, init_params=ckpt,
                  device="cpu")


def test_zero_rehearsal_budget_raises(tmp_path):
    with pytest.raises(ValueError, match="zero rehearsal budget"):
        train_zoo(EnvConfig(**ENV_KW, adaptive_rehearsal=True), PPOConfig(**_ppo_kw()), N,
                  [0], N * T, str(tmp_path), device="cpu")


def test_zoo_plr_tick_reweights_each_member(tmp_path, monkeypatch):
    """Under the PLR controller every `log_every` updates each member's
    probabilities are reweighted from its own family counts since the last
    tick (one call over the (S, 7) probabilities and (S, 8) count deltas),
    and the state carries the result."""
    import drone2d_tpu_torch.learn.zoo as zoo_module

    calls = []

    def spy(probs, counts, wins):
        calls.append((probs.copy(), counts.copy(), wins.copy()))
        return zoo_module.reweight_rehearsal.__wrapped__(probs, counts, wins)

    spy.__wrapped__ = zoo_module.reweight_rehearsal
    monkeypatch.setattr(zoo_module, "reweight_rehearsal", spy)
    env_cfg = EnvConfig(**ENV_KW, n_steps=12, adaptive_rehearsal=True, rehearsal_adapt=True,
                        stage_mix_prob=0.9)
    state = train_zoo(env_cfg, PPOConfig(**_ppo_kw()), 16, [0, 1], 4 * 16 * T,
                      str(tmp_path), snapshots=0, log_every=2, device="cpu")
    assert len(calls) == 2
    first = np.full((2, 7), 0.18, np.float32)
    first[:, 5:] = 0.0
    np.testing.assert_array_equal(calls[0][0], first)
    # the two ticks' deltas add up to each member's counts
    counts = state.family_counts.numpy()
    np.testing.assert_array_equal(calls[0][1] + calls[1][1], counts)
    np.testing.assert_array_equal(calls[0][2] + calls[1][2], state.family_wins.numpy())
    assert counts.shape == (2, 8) and not np.array_equal(counts[0], counts[1])
    assert counts[:, 1:6].sum() > 0
    np.testing.assert_array_equal(
        state.rehearsal_probs.numpy(), spy.__wrapped__(*calls[1]))


# -- the CLIs ----------------------------------------------------------------------


def test_sweep_vmap_then_select_agents_on_cpu(tmp_path, capsys):
    """(g) sweep --vmap 2 trains 2 seeds as a population and writes their
    snapshots; select_agents finds them, with a train run's checkpoints,
    and ranks all of them on 2 scenarios into the JSON."""
    out = str(tmp_path / "zoo")
    sweep.main(["--device", "cpu", "--out", out, "--vmap", "2", "--seeds", "5", "6",
                "--total-timesteps", str(3 * N * T), "--num-envs", str(N), "--n-steps", str(T),
                "--num-minibatches", "4", "--shuffle", "timeperm", "--ppo", "n_epochs=2",
                "--env", "path_table_n=128",
                "--snapshots", "1"])
    assert _files(out) == {f"seed_{s}": [f"ckpt_{2 * N * T}.npz", "new_agent.npz"]
                           for s in (5, 6)}
    run = str(tmp_path / "run")
    train_main(["--device", "cpu", "--num-envs", str(N), "--env-path-table-n", "128",
                "--ppo-n-steps", str(T), "--ppo-num-minibatches", "4", "--ppo-n-epochs", "2",
                "--total-timesteps", str(2 * N * T),
                "--checkpoint-every-steps", str(N * T),
                "--checkpoint-dir", run, "--metrics-path", f"{run}/m.jsonl"])
    cands = select_agents.find_candidates([f"{out}/seed_5", f"{out}/seed_6", run])
    assert [c[0] for c in cands] == ["seed_5/final", f"seed_5/{2 * N * T}", "seed_6/final",
                                     f"seed_6/{2 * N * T}", "run/final", f"run/{N * T}"]
    assert cands[-1] == ("run/64", run, 64)
    capsys.readouterr()
    select_agents.main([f"{out}/seed_5", f"{out}/seed_6", run, "--device", "cpu",
                        "--episodes", "4", "--scenarios", "corridor", "stage_1",
                        "--out", str(tmp_path / "select.json")])
    text = capsys.readouterr().out
    assert "6 candidates x 2 scenarios x 4 episodes" in text
    with open(tmp_path / "select.json") as f:
        table = json.load(f)
    assert sorted(table) == sorted(c[0] for c in cands)
    for per in table.values():
        assert set(per) == {"corridor", "stage_1"}
        for row in per.values():
            assert set(row) == {"success_rate", "collision_rate", "avg_ape"}
            assert 0.0 <= row["success_rate"] <= 1.0

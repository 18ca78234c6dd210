"""The port's training driver on the CPU: the CLI end to end and resumed,
a warm start, checkpoints, metrics accounting (the cases of
tests/test_train.py), presets, and an agent trained by the port loaded by
the JAX package."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drone2d_tpu.models.policy import (
    flat_dict_to_params as jax_from_flat,
    policy_value as jax_policy_value,
)
from drone2d_tpu_torch.compat.from_jax import params_to_flat
from drone2d_tpu_torch.config import EnvConfig, PPOConfig, TrainConfig
from drone2d_tpu_torch.learn.ppo import PPOLearner
from drone2d_tpu_torch.models.policy import flat_dict_to_params
from drone2d_tpu_torch.train import load_agent, main, parse_args, train
from drone2d_tpu_torch.utils.checkpoint import (
    checkpoint_steps,
    restore_checkpoint,
    save_checkpoint,
)
from drone2d_tpu_torch.utils.metrics import MetricsWriter

torch.set_num_threads(1)

SMALL_ENV = dict(path_table_n=128, n_steps=64)
AGENT_S6006 = os.path.join(os.path.dirname(__file__), "..", "artifacts", "agent_s6006",
                           "new_agent.npz")
SMALL_PPO = dict(n_steps=8, num_minibatches=4, n_epochs=2)


def _argv(ckpt, *extra):
    return ["--device", "cpu", "--num-envs", "8", "--env-path-table-n", "128",
            "--env-n-steps", "64", "--ppo-n-steps", "8", "--ppo-num-minibatches", "4",
            "--ppo-n-epochs", "2", "--checkpoint-every-steps", "64",
            "--checkpoint-dir", ckpt, "--metrics-path", f"{ckpt}/metrics.jsonl", *extra]


def _rows(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _np(t):
    return t.detach().cpu().numpy()


def _small_learner():
    return PPOLearner(EnvConfig(**SMALL_ENV), PPOConfig(**SMALL_PPO), 8, device="cpu")


def test_train_cli_end_to_end_then_resume(tmp_path):
    ckpt = str(tmp_path / "logs")
    main(_argv(ckpt, "--total-timesteps", "128"))
    assert os.path.exists(f"{ckpt}/new_agent.npz")
    rows = _rows(f"{ckpt}/metrics.jsonl")
    assert [r["global_step"] for r in rows] == [64, 128]
    assert "episodes/avg_reward" in rows[-1] and np.isfinite(rows[-1]["loss"])
    assert rows[-1]["throughput/env_steps_per_s"] > 0
    # config snapshots written separately (main.py:170-174 not replicated)
    for name in ("env_train_config", "rl_config", "train_config"):
        assert os.path.exists(f"{ckpt}/{name}.txt")
    assert checkpoint_steps(ckpt) == [64, 128]

    # resume continues from the saved step, with the saved optimizer
    main(_argv(ckpt, "--total-timesteps", "192", "--resume"))
    rows = _rows(f"{ckpt}/metrics.jsonl")
    assert [r["global_step"] for r in rows] == [64, 128, 192]
    assert rows[-1]["time/episodes"] >= rows[1]["time/episodes"]
    assert checkpoint_steps(ckpt)[-1] == 192


def test_train_warm_start_from_npz(tmp_path):
    """--init-params: params from the saved agent; optimizer, envs and
    global_step start fresh (unlike --resume)."""
    base, ft = str(tmp_path / "base"), str(tmp_path / "ft")
    main(_argv(base, "--total-timesteps", "64"))
    main(_argv(ft, "--total-timesteps", "64", "--init-params", f"{base}/new_agent.npz"))
    assert _rows(f"{ft}/metrics.jsonl")[-1]["global_step"] == 64
    a, b = dict(np.load(f"{base}/new_agent.npz")), dict(np.load(f"{ft}/new_agent.npz"))
    for k in a:
        diff = float(np.abs(a[k] - b[k]).max())
        assert 0.0 < diff < 0.1 or k.endswith("/b"), (k, diff)
    # the port's checkpoint directory: its latest checkpoint, the final agent
    main(_argv(str(tmp_path / "ft_dir"), "--total-timesteps", "64", "--init-params", base))
    assert _rows(f"{tmp_path}/ft_dir/metrics.jsonl")[-1]["global_step"] == 64
    with pytest.raises(ValueError, match="hidden sizes"):
        train(TrainConfig(num_envs=8, checkpoint_dir=ft), EnvConfig(**SMALL_ENV),
              PPOConfig(**SMALL_PPO, hidden_sizes=(32, 32)),
              init_params=f"{base}/new_agent.npz", device="cpu")


def test_init_params_takes_a_checkpoint_directory(tmp_path, capsys):
    """--init-params <the port's checkpoint dir> warm-starts from its latest
    checkpoint (as the JAX package's takes its orbax directory), with a
    fresh optimizer, envs and global_step; 'random' is refused."""
    base, ft = str(tmp_path / "base"), str(tmp_path / "ft")
    main(_argv(base, "--total-timesteps", "128"))
    assert checkpoint_steps(base) == [64, 128]
    capsys.readouterr()
    state = train(TrainConfig(num_envs=8, checkpoint_dir=ft, metrics_path=f"{ft}/m.jsonl",
                              checkpoint_every_steps=64),
                  EnvConfig(**SMALL_ENV), PPOConfig(**SMALL_PPO), max_updates=1,
                  init_params=base, device="cpu")
    assert f"warm-started params from {base}" in capsys.readouterr().out
    start = load_agent(base, PPOConfig(**SMALL_PPO), "cpu")
    final = dict(np.load(f"{base}/new_agent.npz"))
    for k, v in params_to_flat(start).items():
        np.testing.assert_array_equal(v, final[k])
    assert float(state.global_step) == 64
    assert all(float(s["step"]) == 8 for s in state.optimizer.state.values())
    for k, v in params_to_flat(state.params).items():
        assert 0.0 < float(np.abs(v - final[k]).max()) < 0.1 or k.endswith("/b"), k
    with pytest.raises(ValueError, match="random"):
        load_agent("random", PPOConfig(**SMALL_PPO), "cpu")


def test_same_device_resume_is_exact(tmp_path):
    """Saving draws the stored seed from a copy of the generator, so the run
    goes on with its stream untouched; a restore on the same device type
    sets the saved state, so its envs are reset by exactly the draws the
    live generator would make next."""
    learner = _small_learner()
    state, _ = learner.update(learner.init(0))
    before = state.generator.get_state().clone()
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, state)
    assert torch.equal(state.generator.get_state(), before)
    restored, _ = restore_checkpoint(d, learner)
    gen = torch.Generator()
    gen.set_state(before)
    want = learner.start(gen, state.params, 64.0)
    torch.testing.assert_close(restored.obs, want.obs, rtol=0, atol=0)
    assert torch.equal(restored.generator.get_state(), gen.get_state())


def test_card_checkpoint_resumes_on_cpu(tmp_path, capsys):
    """A checkpoint holding a CUDA generator's state (16 bytes, which the
    CPU generator refuses) resumes on the CPU from the stored seed, and
    says so; one from before the seed was stored raises a clear error
    there, while a CPU one of that age still restores on the CPU."""
    learner = _small_learner()
    state, _ = learner.update(learner.init(0))
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, state)
    path = f"{d}/ckpt_64.pt"
    payload = torch.load(path, weights_only=True)
    cpu_state = payload["generator"]
    assert payload["generator_device"] == "cpu" and 0 <= payload["generator_seed"] < 2**63
    with pytest.raises(RuntimeError):
        torch.Generator().set_state(torch.zeros(16, dtype=torch.uint8))
    payload.update(generator=torch.arange(16, dtype=torch.uint8), generator_device="cuda")
    torch.save(payload, path)
    capsys.readouterr()
    restored, step = restore_checkpoint(d, learner)
    assert step == 64 and "seeded from the stored seed" in capsys.readouterr().out
    gen = torch.Generator().manual_seed(payload["generator_seed"])
    want = learner.start(gen, state.params, 64.0)
    torch.testing.assert_close(restored.obs, want.obs, rtol=0, atol=0)
    for a, b in zip(restored.params.parameters(), state.params.parameters()):
        assert torch.equal(a, b)
    _, m = learner.update(restored)
    assert np.isfinite(float(m["loss"]))

    del payload["generator_seed"], payload["generator_device"]
    torch.save(payload, path)
    with pytest.raises(ValueError, match="resume it on a cuda device"):
        restore_checkpoint(d, learner)
    payload["generator"] = cpu_state
    torch.save(payload, path)
    old, _ = restore_checkpoint(d, learner)
    assert float(old.global_step) == 64


def test_checkpoint_roundtrip(tmp_path):
    learner = _small_learner()
    state = learner.init(0)
    state, _ = learner.update(state)
    d = str(tmp_path / "ckpt")
    assert save_checkpoint(d, state) == 8 * 8

    restored, step = restore_checkpoint(d, learner)
    assert step == 64 and float(restored.global_step) == 64
    assert float(restored.episodes_total) == float(state.episodes_total)
    for a, b in zip(state.params.parameters(), restored.params.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for a, b in zip(state.optimizer.state.values(), restored.optimizer.state.values()):
        for k in ("step", "exp_avg", "exp_avg_sq"):
            torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    # the restored state trains on, and two restores continue identically
    again, _ = restore_checkpoint(d, learner)
    r1, m1 = learner.update(restored)
    r2, m2 = learner.update(again)
    assert np.isfinite(float(m1["loss"])) and float(r1.global_step) == 128
    for a, b in zip(r1.params.parameters(), r2.params.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)

    # only the newest 5 are kept
    for _ in range(6):
        state, _ = learner.update(state)
        save_checkpoint(d, state)
    assert checkpoint_steps(d) == [64 * k for k in range(3, 8)]
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"), learner)


def test_device_episode_accumulator():
    """TrainState.episodes_total sums every update's episodes on the device
    (a 12-step episode cap ends episodes inside the 3 updates)."""
    learner = PPOLearner(EnvConfig(path_table_n=128, n_steps=12), PPOConfig(**SMALL_PPO), 8,
                         device="cpu")
    state = learner.init(0)
    total = 0.0
    for _ in range(3):
        state, m = learner.update(state)
        total += float(m["episodes/episodes"])
        assert float(m["episodes/total"]) == total
        assert float(state.episodes_total) == total
    assert total > 0


def test_metrics_episode_accounting(tmp_path):
    """Cumulative time/episodes counts EVERY update's episodes even when only
    every 3rd update is logged, and survives resume."""
    p = str(tmp_path / "metrics.jsonl")
    w = MetricsWriter(p)
    for i in range(9):
        w.add_episodes(5)  # every update
        if (i + 1) % 3 == 0:  # log_every_updates = 3
            w.write(i, {"episodes/episodes": 5.0})
    w.close()
    assert [r["time/episodes"] for r in _rows(p)] == [15, 30, 45]

    # resume seeds the counter from the last row instead of restarting at 0
    w2 = MetricsWriter(p, resume=True)
    assert w2.episodes_total == 45
    w2.add_episodes(2)
    w2.write(9, {})
    w2.close()
    assert _rows(p)[-1]["time/episodes"] == 47


def test_preset_overlay_explicit_flags_win():
    args, train_cfg, env_cfg, ppo_cfg = parse_args(
        ["--preset", "flagship-scratch", "--num-envs", "8", "--ppo-n-steps", "16",
         "--env-rew-collision", "-5"])
    assert (train_cfg.num_envs, ppo_cfg.n_steps, env_cfg.rew_collision) == (8, 16, -5.0)
    assert ppo_cfg.hidden_sizes == (128, 128) and ppo_cfg.num_minibatches == 64
    assert ppo_cfg.shuffle == "timeperm" and train_cfg.total_timesteps == 150_000_000
    assert (env_cfg.stage_mix_prob, env_cfg.curriculum_scale,
            env_cfg.obstacle_radius_max, env_cfg.PP_rew_max) == (0.25, 4.0, 160.0, 8.0)
    assert args.device is None  # the card, unless asked for the CPU
    _, _, env_cfg, ppo_cfg = parse_args([])
    assert env_cfg == EnvConfig() and ppo_cfg == PPOConfig()


def test_flagship_scratch_trains_on_cpu(tmp_path):
    """The recipe's own settings (128-128, the stage mix, timeperm) at 8 envs."""
    ckpt = str(tmp_path / "fs")
    main(["--preset", "flagship-scratch", "--device", "cpu", "--num-envs", "8",
          "--ppo-n-steps", "8", "--ppo-num-minibatches", "4", "--ppo-n-epochs", "1",
          "--env-path-table-n", "128", "--max-updates", "1",
          "--checkpoint-dir", ckpt, "--metrics-path", f"{ckpt}/m.jsonl"])
    assert _rows(f"{ckpt}/m.jsonl")[-1]["global_step"] == 64
    assert dict(np.load(f"{ckpt}/new_agent.npz"))["pi0/w"].shape == (27, 128)


def test_flagship_finetune_is_not_ported(tmp_path):
    """The flagship-finetune preset (adaptive rehearsal, non-uniform stage
    weights) warm-starts and trains on the CPU at 8 envs, with the
    rehearsal probabilities of the recipe (to float32 rounding) in its
    state and no controller ticks (rehearsal_adapt is off in the recipe).
    The name is historical: the test once held that the preset raised."""
    ckpt = str(tmp_path / "ft")
    _, train_cfg, env_cfg, ppo_cfg = parse_args(
        ["--preset", "flagship-finetune", "--num-envs", "8", "--ppo-n-steps", "8",
         "--ppo-num-minibatches", "4", "--ppo-n-epochs", "1", "--env-path-table-n", "128",
         "--checkpoint-dir", ckpt, "--metrics-path", f"{ckpt}/m.jsonl"])
    assert env_cfg.adaptive_rehearsal and not env_cfg.rehearsal_adapt
    state = train(train_cfg, env_cfg, ppo_cfg, max_updates=1, device="cpu",
                  init_params=AGENT_S6006)
    np.testing.assert_allclose(_np(state.rehearsal_probs),
                               [0.3 * 3 / 7] + [0.3 / 7] * 4 + [0.0, 0.0], rtol=1e-6)
    row = _rows(f"{ckpt}/m.jsonl")[-1]
    assert row["global_step"] == 64 and np.isfinite(row["loss"])
    assert not any(k.startswith("rehearsal/") for k in row)


def test_port_agent_loads_in_jax(tmp_path):
    """new_agent.npz written by the port is read by the JAX package's
    flat_dict_to_params, and its policy_value matches the port's to 1e-6
    of each output's scale (float32 products summed in another order)."""
    ckpt = str(tmp_path / "agent")
    state = train(TrainConfig(num_envs=8, checkpoint_dir=ckpt,
                              metrics_path=f"{ckpt}/m.jsonl"),
                  EnvConfig(**SMALL_ENV), PPOConfig(**SMALL_PPO), max_updates=1, device="cpu")
    flat = dict(np.load(f"{ckpt}/new_agent.npz"))
    assert set(flat) == set(params_to_flat(state.params))
    obs = np.random.default_rng(0).standard_normal((64, 27)).astype(np.float32)
    want = jax_policy_value(jax_from_flat(flat), jnp.asarray(obs))
    with torch.no_grad():
        got = flat_dict_to_params(flat, device="cpu").policy_value(torch.tensor(obs))
        live = state.params.policy_value(torch.tensor(obs))
    for g, l, w in zip(got, live, want):
        w = np.asarray(w, np.float64)
        torch.testing.assert_close(g, l, rtol=0, atol=0)
        assert np.abs(g.detach().numpy() - w).max() <= 1e-6 * max(1.0, np.abs(w).max())

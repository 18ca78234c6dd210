"""The port's headline bench (`drone2d_tpu_torch/bench.py`) on the CPU: its
chunk against the JAX composition that `bench.py` times (`sample_action`,
the clip to [-1, 1], `step_batch_template`, the rewards summed) with JAX's
template and noise injected, the captured chunks (template and split carry)
against it and bit-equal to the eager ones, its CLI's stdout against
`bench.py`'s keys, and the train line's measurement at a small config.
"""

import functools
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drone2d_tpu.config import EnvConfig as JEnvConfig, PPOConfig as JPPOConfig
from drone2d_tpu.learn.ppo import PPOLearner as JPPOLearner
from drone2d_tpu.models.policy import flat_dict_to_params as jax_from_flat
from drone2d_tpu.models.policy import sample_action as jax_sample_action
from drone2d_tpu_torch import bench
from drone2d_tpu_torch.compat.from_jax import env_state_from_numpy, params_from_flat
from drone2d_tpu_torch.config import EnvConfig
from drone2d_tpu_torch.env.env import Drone2DEnv
from drone2d_tpu_torch.utils import graphs

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AGENT = os.path.join(ROOT, "artifacts", "agent_s8004", "new_agent.npz")
N, T = 8, 4


def _jax_bench():
    spec = importlib.util.spec_from_file_location("jax_bench", os.path.join(ROOT, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.cache
def _jax_chunk():
    """`bench.py`'s chunk of 8 envs x 4 steps (its key splits, template and
    per-step composition, each piece jitted) from a JAX reset state -> the
    port's inputs (the weights, the state, obs, template and per-step
    noise, on the CPU) and JAX's summed reward."""
    env_cfg = JEnvConfig()
    jl = JPPOLearner(env_cfg, JPPOConfig(), N)
    reset = jax.jit(jl.env.reset_batch, static_argnums=1)
    step = jax.jit(jl.env.step_batch_template)
    sample = jax.jit(jax_sample_action)
    flat = dict(np.load(AGENT))
    params = jax_from_flat(flat)
    env_state, obs = reset(jax.random.PRNGKey(0), N, jnp.float32(0))
    start, start_obs = jax.tree.map(np.asarray, env_state), np.asarray(obs)
    rng, k_template = jax.random.split(jax.random.PRNGKey(1))
    reset_state, reset_obs = reset(k_template, N, jnp.float32(0))
    rewards, noise = [], []
    for _ in range(T):
        rng, k_act = jax.random.split(rng)
        action, _, _ = sample(params, obs, k_act)
        out = step(env_state, jnp.clip(action, -1.0, 1.0), reset_state, reset_obs)
        rewards.append(out.reward)
        noise.append(np.asarray(jax.random.normal(k_act, (N, 2), jnp.float32)))
        env_state, obs = out.state, out.obs
    want = float(jnp.sum(jnp.stack(rewards)))
    inputs = (params_from_flat(flat, device="cpu"),
              env_state_from_numpy(start, device="cpu"), torch.tensor(start_obs),
              env_state_from_numpy(jax.tree.map(np.asarray, reset_state), device="cpu"),
              torch.tensor(np.asarray(reset_obs)), torch.tensor(np.stack(noise)))
    return inputs, want


def test_chunk_matches_jax_composition():
    """8 envs x 4 steps of `bench.py`'s chunk (its key splits, template and
    per-step composition, each piece jitted), from a JAX reset state; the
    port's chunk with the same state, template and per-step noise: the
    summed reward within 1e-5 relative."""
    (params, state, obs, reset_state, reset_obs, noise), want = _jax_chunk()
    env = Drone2DEnv(EnvConfig(), "cpu")
    _, _, got = bench.chunk_from(params, env, state, obs, reset_state, reset_obs, noise)
    assert got.shape == (T, N)
    assert abs(float(got.sum()) - want) <= 1e-5 * abs(want), (float(got.sum()), want)


@pytest.mark.parametrize("cls", [bench.CapturedChunk, bench.CapturedSplitChunk])
def test_captured_chunks_match_jax_composition(cls):
    """The captured chunks the bench and the probes time, a 2-step graph
    replayed twice (its body run directly on the CPU), with the inputs of
    the test above: bit-equal to the eager chunk (`chunk_from`, and
    `chunk_split_from` for the split carry), so within 1e-5 of JAX's
    summed reward."""
    (params, state, obs, reset_state, reset_obs, noise), want = _jax_chunk()
    env = Drone2DEnv(EnvConfig(), "cpu")
    run = cls(params, env, state, obs, reset_state, reset_obs, 2)
    assert run.graph.eager
    got = run(state, obs, reset_state, reset_obs, noise)
    assert abs(float(got[2].sum()) - want) <= 1e-5 * abs(want), (float(got[2].sum()), want)
    eager = (bench.chunk_from, bench.chunk_split_from)[cls is bench.CapturedSplitChunk]
    ref = eager(params, env, state, obs, reset_state, reset_obs, noise)
    for a, b in zip(graphs.leaves(got), graphs.leaves(ref)):
        assert (a is None and b is None) or torch.equal(a, b)
    assert torch.equal(got[2], bench.chunk_from(params, env, state, obs, reset_state, reset_obs,
                                                noise)[2])


def test_chunk_draws_template_then_noise_from_generator():
    """`chunk` draws its template and then its noise from the generator it
    is given, so one seed gives one chunk; without the auto-reset it runs
    the plain step."""
    env = Drone2DEnv(EnvConfig(path_table_n=128), "cpu")
    params = params_from_flat(dict(np.load(AGENT)), device="cpu")
    state, obs = env.reset_batch(torch.Generator().manual_seed(3), N, 0.0)
    outs = [bench.chunk(params, env, state, obs, torch.Generator().manual_seed(5), T)
            for _ in range(2)]
    assert torch.equal(outs[0][2], outs[1][2])
    gen = torch.Generator().manual_seed(5)
    reset_state, reset_obs = env.reset_batch(gen, N, 0.0)
    noise = torch.randn((T, N, 2), generator=gen)
    _, _, want = bench.chunk_from(params, env, state, obs, reset_state, reset_obs, noise)
    assert torch.equal(outs[0][2], want)
    _, _, plain = bench.chunk(params, env, state, obs, torch.Generator().manual_seed(5), T,
                              autoreset=False)
    assert plain.shape == (T, N) and bool(torch.isfinite(plain).all())


def test_cli_prints_bench_py_lines(capsys):
    out = bench.main(["--device", "cpu", "--num-envs", str(N), "--chunk", str(T)])
    captured = capsys.readouterr()
    lines = captured.out.splitlines()
    assert len(lines) == 1
    row = json.loads(lines[0])
    assert list(row) == ["metric", "value", "unit", "vs_baseline"]
    assert row["metric"] == "env_steps_per_s" and row["unit"] == "steps/s"
    env = out["env"]
    assert len(env["seconds"]) == bench.REPEATS and env["steps"] == bench.REPEATS * T * N
    assert row["value"] == round(env["steps"] / sum(env["seconds"]), 1)
    assert row["vs_baseline"] == round(row["value"] / bench.BASELINE_TPU_V5E, 3)
    # the spread goes to stderr, and off the card no device ops are counted
    assert "min" in captured.err and "median" in captured.err and "not measured" in captured.err


def test_constants_mirror_bench_py():
    jb = _jax_bench()
    assert bench.BASELINE_TPU_V5E == jb.BASELINE
    assert (bench.NUM_ENVS, bench.CHUNK_T, bench.REPEATS) == (jb.NUM_ENVS, jb.CHUNK_T, jb.REPEATS)
    assert (bench.TRAIN_NUM_ENVS, bench.TRAIN_PPO, bench.TRAIN_REPEATS) == (
        jb.TRAIN_NUM_ENVS, jb.TRAIN_PPO, jb.TRAIN_REPEATS)


@pytest.mark.parametrize("shuffle", ["timeperm", "exact"])
def test_train_line_at_small_config(capsys, shuffle):
    out = bench.bench_train(shuffle, device="cpu", num_envs=N,
                            ppo=dict(n_steps=8, num_minibatches=4, n_epochs=2), repeats=2)
    row = json.loads(capsys.readouterr().out)
    assert list(row) == ["metric", "value", "unit", "vs_baseline"]
    assert row["metric"] == "train_steps_per_s"
    assert out["steps"] == 2 * N * 8 and len(out["seconds"]) == 2
    assert np.isfinite(out["loss"]) and out["launches"] == 0  # no kernel off the card

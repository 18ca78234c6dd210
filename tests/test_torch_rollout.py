"""The whole slice: the port's PPO rollout against the JAX package's.

`PPOLearner.rollout_from` is fed exactly what the JAX `PPOLearner.rollout`
draws (its reset template and its per-step action noise, reproduced from
its key as `learn/ppo.py` splits it) and must produce the same batch,
bootstrap values, episode statistics and GAE.  Also: the package imports
no JAX, and its entry points refuse to fall back to the CPU.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drone2d_tpu.config import EnvConfig as JEnvConfig, PPOConfig as JPPOConfig
from drone2d_tpu.learn.gae import compute_gae as jax_gae
from drone2d_tpu.learn.ppo import PPOLearner as JPPOLearner, TrainState as JTrainState
from drone2d_tpu.models.policy import (
    flat_dict_to_params as jax_from_flat,
    init_actor_critic as jax_init,
    params_to_flat_dict as jax_to_flat,
)
from drone2d_tpu_torch.compat.from_jax import env_state_from_numpy, params_from_flat
from drone2d_tpu_torch.config import EnvConfig, PPOConfig
from drone2d_tpu_torch.learn.gae import compute_gae
from drone2d_tpu_torch.learn.optim import adam
from drone2d_tpu_torch.learn.ppo import PPOLearner, TrainState

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
AGENT = os.path.join(ROOT, "artifacts", "agent_s8004", "new_agent.npz")
N, T, HIDDEN = 64, 24, (128, 128)
CASES = {
    # the flagship agent flying stage-5 fields
    "agent_stage5": dict(agent=True, global_step=3e6),
    # a fresh orthogonal-init policy in stage 2 (random spawns)
    "init_stage2": dict(agent=False, global_step=8e5),
}


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.array(x)


@pytest.fixture(scope="module")
def runs():
    jl = JPPOLearner(JEnvConfig(), JPPOConfig(n_steps=T, hidden_sizes=HIDDEN), N)
    reset = jax.jit(jl.env.reset_batch, static_argnums=1)
    rollout = jax.jit(jl.rollout)
    out = {}
    for i, (name, case) in enumerate(CASES.items()):
        if case["agent"]:
            flat = dict(np.load(AGENT))
        else:
            flat = {k: np.asarray(v) for k, v in
                    jax_to_flat(jax_init(jax.random.PRNGKey(i), 27, 2, HIDDEN)).items()}
        gs = jnp.float32(case["global_step"])
        env_state, obs = reset(jax.random.PRNGKey(100 + i), N, gs)
        # every other env is 1..20 steps from the step cap, so episodes end
        # (and auto-reset to the template) at known steps inside the rollout
        t0 = np.where(np.arange(N) % 2 == 0,
                      JEnvConfig().n_steps - 1 - np.arange(N) % 20, 0).astype(np.int32)
        env_state = env_state._replace(t=jnp.asarray(t0))
        state = JTrainState(
            params=jax_from_flat(flat), opt_state=None, env_state=env_state, obs=obs,
            rng=jax.random.PRNGKey(200 + i), global_step=gs,
            episodes_total=jnp.float32(0.0), rehearsal_probs=jnp.zeros(7),
            family_counts=jnp.zeros(8), family_wins=jnp.zeros(8),
        )
        new_state, batch, last_values, stats = rollout(state)
        # the JAX rollout's own draws (learn/ppo.py:249-259)
        template_key, rng = jax.random.split(state.rng)
        reset_state, reset_obs = reset(template_key, N, gs)
        noise = []
        for _ in range(T):
            rng, k_act = jax.random.split(rng)
            noise.append(np.asarray(jax.random.normal(k_act, (N, 2), jnp.float32)))
        out[name] = dict(
            flat=flat, state=jax.tree.map(np.asarray, state), new_state=new_state,
            batch=batch, last_values=last_values, stats=stats,
            reset_state=jax.tree.map(np.asarray, reset_state), reset_obs=np.asarray(reset_obs),
            noise=np.stack(noise),
        )
    return out


def _port_rollout(run):
    learner = PPOLearner(EnvConfig(), PPOConfig(n_steps=T, hidden_sizes=HIDDEN), N,
                         device="cpu")
    js = run["state"]
    params = params_from_flat(run["flat"], device="cpu")
    state = TrainState(
        params=params, optimizer=adam(params.parameters(), 3e-4),
        env_state=env_state_from_numpy(js.env_state, device="cpu"),
        obs=torch.tensor(js.obs), generator=torch.Generator(),
        global_step=torch.tensor(js.global_step), episodes_total=torch.tensor(0.0),
    )
    return learner.rollout_from(
        state, env_state_from_numpy(run["reset_state"], device="cpu"),
        torch.tensor(run["reset_obs"]), torch.tensor(run["noise"]),
    )


def _scaled_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(1.0, np.abs(want).max())


# Tolerances, as a fraction of each quantity's largest magnitude.  The
# first step agrees to float32 rounding (see tests/test_torch_policy.py and
# tests/test_torch_env.py).  After that the two trajectories are closed
# loops: the flagship policy is steep (action means reach ~13 before the
# clip, values ~1e3), so rounding-level observation differences grow over
# the 24 steps to ~1e-3 of scale in actions and values.  Dones, which decide
# the auto-resets, must agree exactly; log-probs depend only on the noise.
SCALED_TOL = {"obs": 5e-3, "actions": 5e-3, "values": 1e-3, "rewards": 5e-3}


@pytest.mark.parametrize("case", list(CASES))
def test_rollout_matches_jax(runs, case):
    run = runs[case]
    new_state, batch, last_values, stats = _port_rollout(run)
    jb = run["batch"]
    np.testing.assert_array_equal(_np(batch.dones), np.asarray(jb.dones))
    assert 10 <= int(np.asarray(jb.dones).sum())
    np.testing.assert_allclose(_np(batch.log_probs), jb.log_probs, rtol=0, atol=2e-6)
    # the first step starts from identical observations: the policy agrees
    # to float32 rounding, the env step to its teacher-forced bound
    np.testing.assert_array_equal(_np(batch.obs[0]), jb.obs[0])
    for k, tol in (("actions", 1e-5), ("values", 1e-5), ("rewards", 1e-3)):
        assert _scaled_err(_np(getattr(batch, k))[0], getattr(jb, k)[0]) <= tol, k
    for k, tol in SCALED_TOL.items():
        err = _scaled_err(_np(getattr(batch, k)), getattr(jb, k))
        assert err <= tol, (k, err)
    assert _scaled_err(_np(last_values), run["last_values"]) <= SCALED_TOL["values"]
    assert float(new_state.global_step) == float(run["new_state"].global_step)

    js = run["stats"]
    for k in ("n_episodes", "n_success", "n_fail", "n_collision"):
        assert float(getattr(stats, k)) == float(getattr(js, k)), k
    for k in ("sum_length", "sum_total_reward", "sum_ape", "sum_components"):
        assert _scaled_err(_np(getattr(stats, k)), getattr(js, k)) <= 5e-3, k
    summary = stats.summary()
    assert summary["episodes"] == float(js.n_episodes)
    assert summary["failure_rate"] > 0.0


@pytest.mark.parametrize("case", list(CASES))
def test_gae_matches_jax(runs, case):
    """compute_gae on the JAX rollout's own batch: the same recurrence,
    float32 in the same order."""
    jb = runs[case]["batch"]
    lv = runs[case]["last_values"]
    kw = dict(gamma=0.99, gae_lambda=0.95)
    adv, ret = compute_gae(*(torch.as_tensor(np.array(x)) for x in
                             (jb.rewards, jb.values, jb.dones, lv)), **kw)
    jadv, jret = jax_gae(jb.rewards, jb.values, jb.dones, lv, **kw)
    np.testing.assert_allclose(_np(adv), jadv, rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(_np(ret), jret, rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("hidden", [(64, 64), (32, 32)], ids=lambda h: "x".join(map(str, h)))
def test_rollout_draws_from_generator_and_advances(hidden):
    """rollout() draws its template and noise from the state's generator:
    two equal seeds give equal rollouts, and the step counter advances.
    (32, 32) is the width the JAX package's own training tests use."""
    learner = PPOLearner(EnvConfig(), PPOConfig(n_steps=4, hidden_sizes=hidden), 8,
                         device="cpu")
    a, b = learner.init(3), learner.init(3)
    (sa, ba, la, _), (sb, bb, lb, _) = learner.rollout(a), learner.rollout(b)
    for k in ("obs", "actions", "rewards", "values"):
        torch.testing.assert_close(getattr(ba, k), getattr(bb, k), rtol=0, atol=0)
    torch.testing.assert_close(la, lb, rtol=0, atol=0)
    assert float(sa.global_step) == 4 * 8
    assert np.isfinite(_np(ba.obs)).all() and ba.obs.shape == (4, 8, 27)


def test_package_imports_no_jax():
    """Importing every module of the port, and chip_smoke.py, loads neither
    JAX, optax nor any module of the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import drone2d_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'drone2d_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'optax', 'drone2d_tpu')]\n"
        "assert not bad, bad\n"
        "print(' '.join(m for m in sys.modules if m.startswith('drone2d_tpu_torch')))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    loaded = set(proc.stdout.split())
    assert len(loaded) >= 20
    for name in ("train", "learn.ppo", "learn.optim", "learn.plr", "learn.zoo",
                 "utils.checkpoint", "utils.metrics", "utils.runtime", "utils.host_path",
                 "eval.episode", "eval.artifacts", "eval.run", "eval.barplots",
                 "scripts.sweep", "scripts.select_agents", "compat.from_jax",
                 "compat.sb3_import", "compat.gym_env", "compat.vector_env", "eval.render",
                 "parallel.mesh", "parallel.multihost", "eval.replay", "eval.curves",
                 "eval.replotting", "utils.profiling", "utils.graphs", "debug", "scripts.multihost_smoke",
                 "scripts.ddp_check", "bench", "scripts.precision_campaign",
                 "scripts.package_agent", "scripts.zoo", "scripts.stage1_failure_modes",
                 "scripts.stage1_time_margin", "scripts.aape_survivorship",
                 "scripts.bench_update_split", "scripts.roofline_probe",
                 "scripts.roofline_update", "scripts.bench_kernels",
                 "scripts.bench_fused_policy", "scripts.profile_step",
                 "scripts.probe_split_carry", "scripts.hunt_check"):
        assert f"drone2d_tpu_torch.{name}" in loaded, name


def test_entry_points_need_cuda_unless_asked_for_cpu():
    """With no device argument the port runs on the card, and raises
    instead of falling back to the CPU when there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal needs its absence")
    from drone2d_tpu_torch.env.env import Drone2DEnv
    from drone2d_tpu_torch.models.policy import ActorCritic, flat_dict_to_params
    from drone2d_tpu_torch.eval.run import main as eval_main
    from drone2d_tpu_torch.learn.zoo import ZooTrainer
    from drone2d_tpu_torch.scripts import multihost_smoke, select_agents, sweep
    from drone2d_tpu_torch.train import main as train_main
    from drone2d_tpu_torch.utils.runtime import wait_for_accelerator

    argv = ["--num-envs", "4", "--ppo-n-steps", "8", "--max-updates", "1",
            "--checkpoint-dir", os.devnull, "--metrics-path", os.devnull]
    for make in (lambda: PPOLearner(EnvConfig(), PPOConfig(), 4),
                 lambda: Drone2DEnv(EnvConfig()),
                 lambda: ActorCritic(),
                 lambda: flat_dict_to_params(dict(np.load(AGENT))),
                 lambda: train_main(argv),
                 lambda: train_main([*argv, "--device", "cuda"]),
                 lambda: eval_main(["--agent", AGENT, "--episodes", "2", "--no-gif",
                                    "--out-root", os.devnull]),
                 lambda: ZooTrainer(EnvConfig(), PPOConfig(), 4),
                 lambda: sweep.main(["--out", os.devnull, "--vmap", "2", "--seeds", "1", "2"]),
                 lambda: select_agents.main([os.path.dirname(AGENT), "--episodes", "2"]),
                 lambda: multihost_smoke.main([]),
                 wait_for_accelerator):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()

"""The port's CUDA kernel on the card: built from source, held against its
plain PyTorch version at every padded width and at ragged batches, on the
flagship agent's weights, counted, refused on mixed devices, and refused
(NotImplementedError) for an architecture it does not take; it reads the
weights an optimizer step has just updated; with the agent axis, each
member's outputs are bit-equal to its own unstacked launch.  The PPO update,
a population's update and the eval runner on the card against the same on
the CPU; the adaptive rehearsal reset and its rollout's family accounting on
the card; a checkpoint written on the card resumes on the CPU.  The box
obstacles' geometry and step, the vector env core and the fresh-draw step
(`step_batch`) on the card against the CPU.  A world-1 NCCL group's sharded
update bit-equal to the plain update, and the split-carry step bit-equal to
the template step over a chunk.  The headline bench's chunk on the card
against the CPU, its launch and device-op counts (the profiler's window
without its lead-in), and the policy-kernel and split-carry probes, the
probes' captured chunks bit-equal to the eager ones.  The captured
data-parallel update over a world-1 NCCL group bit-equal to the eager one,
and the captured vector and gym env steps bit-equal to the eager ones.  The
compiled programs: `update_jit` bit-equal to `update` over 3 updates (one
learner in each shuffle, a population of 8), the captured eval runner
bit-equal to the eager one, launch counts under replay, a capture that
meets a host sync raises, and a checkpoint written after `update_jit`
resumes on the CPU.  The PPO minibatch step's kernel (`ops/ppo_sgd.py`):
one step and a whole `sgd` against the plain steps at three widths, three
member counts and every shuffle, reruns and a member alone bit-equal, the
architectures it refuses, its counts under replay, and a checkpoint after
its steps continuing bit-equal.

These need an NVIDIA GPU and nvcc, and skip without one.  This file imports
no JAX, so on a machine with the card and without JAX it runs alone:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import copy
import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

from drone2d_tpu_torch.config import EnvConfig, PPOConfig, TrainConfig, apply_preset
from drone2d_tpu_torch.env.env import Drone2DEnv
from drone2d_tpu_torch.eval.episode import run_episodes_from
from drone2d_tpu_torch.eval.run import scenario_config
from drone2d_tpu_torch.learn import optim
from drone2d_tpu_torch.learn.ppo import PPOLearner, RolloutBatch
from drone2d_tpu_torch.learn.zoo import ZooTrainer, assemble
from drone2d_tpu_torch.models.policy import ActorCritic, flat_dict_to_params, stack_params
from drone2d_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint
from drone2d_tpu_torch.ops.fused_policy import fused_sample_action, fused_sample_action_ref

pytestmark = pytest.mark.cuda

AGENT = os.path.join(os.path.dirname(__file__), "..", "artifacts", "agent_s8004",
                     "new_agent.npz")
AGENTS = [os.path.join(os.path.dirname(__file__), "..", "artifacts", f"agent_s{s}",
                       "new_agent.npz") for s in (8004, 22307, 6006)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _eager_device_step(env):
    """Have `env` (a VectorEnvCore or a Drone2dGymEnv) run the device part
    of its steps eagerly, as before it was captured: the core's
    `device_step`, the gym env's `Drone2DEnv.step`; the rest of `step`
    stays as it is."""
    from drone2d_tpu_torch.compat.vector_env import VectorEnvCore

    if isinstance(env, VectorEnvCore):
        def step(tree):
            state, prev_done, action, templates = tree
            new, obs, reward, terminated, truncated, info = env.device_step(
                state, prev_done, action, *templates)
            return ((obs, reward, terminated, truncated, prev_done, info),
                    (new, terminated | truncated, action, templates))
    else:
        def step(tree):
            state, action = tree
            out = env._env.step(state, action.clamp(-1.0, 1.0))
            return (out.obs, out.done, out.info), (out.state, action)
    env._step = step


def _scaled_err(got, want):
    """max |d| / max(1, max |want|): float32 sums in another order differ
    relative to the size of the summed terms (see chip_smoke.py)."""
    return float((got.double() - want.double()).abs().max()
                 / max(1.0, float(want.abs().max())))


def _check(params, obs, noise):
    got = fused_sample_action(params, obs, noise)
    torch.cuda.synchronize()
    with torch.no_grad():
        want = fused_sample_action_ref(params, obs, noise)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.device == w.device
        assert _scaled_err(g, w) <= 1e-5
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)  # log-prob: bit-equal


# every padded width of the kernel (H = 8 pads to 32, 96 is not a power of
# two) and batches around the 32-row block
@pytest.mark.parametrize("hidden", [8, 32, 64, 96, 128, 256])
@pytest.mark.parametrize("batch", [1, 15, 16, 17, 31, 32, 33, 4093, 4096])
def test_kernel_matches_plain(dev, hidden, batch):
    gen = torch.Generator().manual_seed(hidden + batch)
    params = ActorCritic(27, 2, (hidden, hidden), generator=gen, device=dev)
    with torch.no_grad():
        params.log_std.copy_(torch.tensor([-0.3, 0.2]))
        for p in params.parameters():  # non-zero biases and larger heads
            p.add_(0.1 * torch.randn(p.shape, generator=gen).to(dev))
    obs = torch.randn(batch, 27, generator=gen).to(dev)
    noise = torch.randn(batch, 2, generator=gen).to(dev)
    _check(params, obs, noise)


@pytest.mark.parametrize("batch", [4093, 4096])
def test_kernel_matches_plain_on_flagship(dev, batch):
    """The flagship agent: critic head weights up to ~38, values up to ~1e3."""
    params = flat_dict_to_params(dict(np.load(AGENT)), device=dev)
    with torch.no_grad():
        params.log_std.copy_(torch.tensor([-0.3, 0.2]))
    gen = torch.Generator().manual_seed(batch)
    obs = torch.randn(batch, 27, generator=gen).to(dev)
    noise = torch.randn(batch, 2, generator=gen).to(dev)
    _check(params, obs, noise)


def test_depth_three_raises_on_card_and_runs_on_cpu(dev):
    params = ActorCritic(27, 2, (64, 64, 64), generator=torch.Generator().manual_seed(0),
                         device=dev)
    obs, noise = torch.randn(8, 27, device=dev), torch.randn(8, 2, device=dev)
    before = fused_sample_action.launches
    with pytest.raises(NotImplementedError, match="two hidden layers"):
        params.sample_action(obs, noise=noise)
    assert fused_sample_action.launches == before
    cpu = params.cpu()
    out = cpu.sample_action(obs.cpu(), noise=noise.cpu())
    want = fused_sample_action_ref(cpu, obs.cpu(), noise.cpu())
    for g, w in zip(out, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_launch_count_and_no_fallback(dev):
    params = ActorCritic(27, 2, (128, 128), device=dev)
    obs, noise = torch.randn(64, 27, device=dev), torch.randn(64, 2, device=dev)
    before = fused_sample_action.launches
    fused_sample_action(params, obs, noise)
    assert fused_sample_action.launches == before + 1
    fused_sample_action(params.cpu(), obs.cpu(), noise.cpu())  # plain version
    assert fused_sample_action.launches == before + 1
    with pytest.raises(ValueError):
        fused_sample_action(params.cpu(), obs, noise)  # mixed devices


def test_rollout_on_card_launches_kernel_each_step(dev):
    learner = PPOLearner(EnvConfig(), PPOConfig(n_steps=8, hidden_sizes=(128, 128)), 256)
    state = learner.init(0)
    before = fused_sample_action.launches
    state, batch, last_values, _ = learner.rollout(state)
    torch.cuda.synchronize()
    assert fused_sample_action.launches - before == 8 + 1
    assert batch.obs.device.type == "cuda"
    assert np.isfinite(batch.obs.cpu().numpy()).all()
    assert np.isfinite(last_values.cpu().numpy()).all()


def _update_on(dev, shuffle, start, batch, last_values, perms):
    """learn_from on `dev` from the CPU state's weights and batch."""
    ppo = PPOConfig(n_steps=8, num_minibatches=4, n_epochs=2, shuffle=shuffle,
                    hidden_sizes=(128, 128))
    learner = PPOLearner(EnvConfig(), ppo, 64, device=dev)
    params = flat_dict_to_params(dict(np.load(AGENT)), device=dev)
    state = dataclasses.replace(start, params=params,
                                optimizer=optim.adam(params.parameters(), ppo.learning_rate))
    move = {f.name: getattr(batch, f.name).to(dev) for f in dataclasses.fields(batch)}
    metrics = learner.learn_from(state, type(batch)(**move), last_values.to(dev), perms.to(dev))
    return params, {k: float(v) for k, v in metrics.items()}, ppo


@pytest.mark.parametrize("shuffle", ["exact", "affine", "timeperm"])
def test_learn_from_on_card_matches_cpu(dev, shuffle):
    """One update of the flagship on a CPU-made stage-5 batch, on the card and
    on the CPU with the same shuffles: loss and aux to 1e-5 of max(|v|, 1),
    each weight to 1e-3 of the lr x SGD-steps budget plus 4 float32 ulps of
    the weight (the bounds of tests/test_torch_ppo.py and chip_smoke.py)."""
    cpu = PPOLearner(EnvConfig(), PPOConfig(n_steps=8, hidden_sizes=(128, 128)), 64,
                     device="cpu")
    start = cpu.init(0, params=flat_dict_to_params(dict(np.load(AGENT)), device="cpu"),
                     global_step=3e6)
    _, batch, last_values, _ = cpu.rollout(start)
    n = 8 if shuffle == "timeperm" else 8 * 64
    perms = torch.stack([torch.randperm(n, generator=torch.Generator().manual_seed(e))
                         for e in range(2)])
    pc, mc, ppo = _update_on("cpu", shuffle, start, batch, last_values, perms)
    pg, mg, _ = _update_on(dev, shuffle, start, batch, last_values, perms)
    for k in mc:
        assert abs(mg[k] - mc[k]) <= 1e-5 * max(abs(mc[k]), 1.0), k
    budget = 1e-3 * ppo.learning_rate * ppo.n_epochs * ppo.num_minibatches
    for g, c in zip(pg.parameters(), pc.parameters()):
        g, c = g.detach().cpu().double(), c.detach().double()
        assert bool(((g - c).abs() <= budget + 4 * 2.0**-23 * c.abs()).all())


def test_kernel_reads_weights_after_optimizer_step(dev):
    """The kernel reads the live weights at every launch: after an Adam step
    its outputs move and match the plain version on the updated weights."""
    params = flat_dict_to_params(dict(np.load(AGENT)), device=dev)
    opt = optim.adam(params.parameters(), 1e-2)
    gen = torch.Generator().manual_seed(9)
    obs = torch.randn(1024, 27, generator=gen).to(dev)
    noise = torch.randn(1024, 2, generator=gen).to(dev)
    before = fused_sample_action(params, obs, noise)
    mean, log_std, value = params.policy_value(obs)
    (mean.square().mean() + value.mean() + log_std.sum()).backward()
    optim.clip_by_global_norm_([p.grad for p in params.parameters()], 0.5)
    opt.step()
    _check(params, obs, noise)
    after = fused_sample_action(params, obs, noise)
    for a, b in zip(after, before):
        assert float((a - b).abs().max()) > 0.0


def _to(x, dev):
    if dataclasses.is_dataclass(x):
        return type(x)(**{f.name: _to(getattr(x, f.name), dev) for f in dataclasses.fields(x)})
    return None if x is None else x.to(dev)  # half_wh is None for circles


@pytest.mark.parametrize("scen", ["S_corridor", "stage_5"])
def test_eval_runner_on_card_matches_cpu(dev, scen):
    """The stochastic eval runner (the kernel a step) on the card against the
    CPU from the same CPU-made states and noise, a 32-step cap, every third
    episode started 5 px from its target: latched flags and lengths equal,
    APE, return and trajectories to 1e-4 of scale (chip_smoke.py's bounds).
    The card's runner launches the kernel once a step of its captured
    chunk's warm-up, then once a step of the replay."""
    n, cap = 96, 32
    cfg = scenario_config(scen).replace(n_steps=cap)
    gen = torch.Generator().manual_seed(3)
    state, obs = Drone2DEnv(cfg, device="cpu").reset_batch(gen, n)
    near = (torch.arange(n) % 3 == 0)[:, None]
    state = dataclasses.replace(state, body=dataclasses.replace(
        state.body, pos=torch.where(near, state.target + 5.0, state.body.pos)))
    noise = torch.randn((cap, n, 2), generator=gen)
    before = fused_sample_action.launches
    out = {d: run_episodes_from(Drone2DEnv(cfg, device=d),
                                flat_dict_to_params(dict(np.load(AGENT)), device=d),
                                _to(state, d), obs.to(d), noise.to(d))
           for d in ("cpu", dev)}
    assert fused_sample_action.launches - before == 2 * cap
    got, want = out[dev], out["cpu"]
    for k in ("success", "fail", "collision", "time_steps", "traj_len"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k), err_msg=k)
    assert want.success.sum() >= n // 3
    for k, scale in (("ape", None), ("total_reward", None), ("traj", 1300.0)):
        g, w = getattr(got, k).astype(np.float64), getattr(want, k).astype(np.float64)
        assert np.abs(g - w).max() <= 1e-4 * (scale or max(1.0, np.abs(w).max())), k


def test_adaptive_reset_and_family_counts_on_card(dev):
    """The flagship-finetune reset with both wall mixes at 0.04 on the card:
    family shares within 5 sigma at 4096 envs, the walls' circle counts; an
    adaptive rollout's family counts add up to its finished episodes."""
    env_cfg = apply_preset("flagship-finetune", EnvConfig(), PPOConfig(), TrainConfig())[0]
    env_cfg = env_cfg.replace(corridor_mix_prob=0.04, cross_mix_prob=0.04)
    learner = PPOLearner(env_cfg, PPOConfig(n_steps=8, hidden_sizes=(128, 128)), 4096)
    probs = learner.initial_rehearsal_probs()
    state, _ = learner.env.reset_batch(torch.Generator(device=dev).manual_seed(1), 4096, 0.0,
                                       probs)
    fam = state.family.cpu().numpy()
    p = np.concatenate([[1.0 - float(probs.sum())], probs.cpu().numpy()])
    shares = np.bincount(fam, minlength=8) / 4096
    assert (np.abs(shares - p) <= 5 * np.sqrt(p * (1 - p) / 4096)).all(), shares
    count = state.obstacles.mask.sum(1).cpu().numpy()
    assert (count[fam == 6] == 62).all() and (count[fam == 7] == 6).all()

    small = PPOLearner(env_cfg.replace(n_steps=6), PPOConfig(n_steps=8, hidden_sizes=(128, 128)),
                       256)
    _, _, _, stats = small.rollout(small.init(0))
    assert float(stats.family_counts.sum()) == float(stats.n_episodes) > 0
    assert float(stats.family_wins.sum()) == float(stats.n_success)


@pytest.mark.parametrize("hidden, n", [(64, 200), (128, 1000), (128, 33)])
def test_stacked_kernel_slices_equal_unstacked_launches(dev, hidden, n):
    """One launch for 3 members: each member's outputs bit-equal to its own
    unstacked launch on views of its weights (member 1's b_mean, b_value
    and log_std views are not 16-byte aligned, and are accepted), and to
    the plain version within the kernel's tolerance; one launch counted."""
    gen = torch.Generator().manual_seed(hidden + n)
    members = []
    for _ in range(3):
        p = ActorCritic(27, 2, (hidden, hidden), generator=gen, device=dev)
        with torch.no_grad():
            for leaf in p.parameters():
                leaf.add_(0.1 * torch.randn(leaf.shape, generator=gen).to(dev))
        members.append(p)
    stack = stack_params(members)
    obs = torch.randn(3, n, 27, generator=gen).to(dev)
    noise = torch.randn(3, n, 2, generator=gen).to(dev)
    before = fused_sample_action.launches
    got = fused_sample_action(stack, obs, noise)
    assert fused_sample_action.launches == before + 1
    view = stack.member(1)
    assert view.pi_out.b.data_ptr() % 16 and view.log_std.data_ptr() % 16
    for i in range(3):
        alone = fused_sample_action(stack.member(i), obs[i], noise[i])
        for g, a in zip(got, alone):
            assert torch.equal(g[i], a)
    _check(stack, obs, noise)


def _zoo_on(dev, start, draws):
    """The population update on `dev` from the CPU-made state and draws."""
    trainer = ZooTrainer(EnvConfig(), PPOConfig(n_steps=8, num_minibatches=4, n_epochs=2,
                                                shuffle="timeperm", hidden_sizes=(128, 128)),
                         64, device=dev)
    params = stack_params([p.to(dev) for p in (start.params.member(i) for i in range(3))])
    state = dataclasses.replace(
        start, params=params, optimizer=optim.adam(params.parameters(), 3e-4),
        env_state=_to(start.env_state, dev), obs=start.obs.to(dev),
        **{k: getattr(start, k).to(dev) for k in ("global_step", "episodes_total",
                                                  "rehearsal_probs", "family_counts",
                                                  "family_wins")})
    reset_state, reset_obs, noise, perms = draws
    before = fused_sample_action.launches
    new, metrics = trainer.update_from(state, _to(reset_state, dev), reset_obs.to(dev),
                                       noise.to(dev), perms.to(dev))
    return new, {k: v.cpu() for k, v in metrics.items()}, fused_sample_action.launches - before


def test_population_update_on_card_matches_cpu(dev):
    """Three 128-128 agents as one population at curriculum stage 5 (64 envs
    each, 8 steps, 4 x 2 SGD, timeperm), the same CPU-made state and draws on
    the card and on the CPU: the kernel launched n_steps + 1 times on the
    card; loss and aux to 1e-5 of max(|v|, 1), the episode counts equal,
    each weight to 1e-3 of the lr x SGD-steps budget plus 4 float32 ulps
    (the bounds of test_learn_from_on_card_matches_cpu)."""
    cpu = ZooTrainer(EnvConfig(), PPOConfig(n_steps=8, num_minibatches=4, n_epochs=2,
                                            shuffle="timeperm", hidden_sizes=(128, 128)),
                     64, device="cpu")
    members = [PPOLearner.init(cpu, i, params=flat_dict_to_params(dict(np.load(a)), device="cpu"),
                               global_step=3e6) for i, a in enumerate(AGENTS)]
    # every other env 1..6 steps from the cap, so that episodes end inside
    # the rollout (these agents fly ~500-step episodes)
    cap, i = EnvConfig().n_steps, torch.arange(64)
    t = torch.where(i % 2 == 0, cap - 1 - i % 6, 0).to(torch.int32)
    start = assemble([dataclasses.replace(m, env_state=dataclasses.replace(m.env_state, t=t))
                      for m in members], 3e-4)
    draws = cpu.draws(start)
    pc, mc, launches_cpu = _zoo_on("cpu", start, draws)
    pg, mg, launches = _zoo_on(dev, start, draws)
    assert launches_cpu == 0 and launches == 8 + 1
    for k in ("loss", "policy_loss", "value_loss", "entropy", "clip_fraction", "approx_kl"):
        assert bool(((mg[k] - mc[k]).abs() <= 1e-5 * mc[k].abs().clamp(min=1.0)).all()), k
    assert torch.equal(mg["episodes/episodes"], mc["episodes/episodes"])
    assert float(mc["episodes/episodes"].sum()) > 0
    budget = 1e-3 * 3e-4 * 2 * 4
    for g, c in zip(pg.params.parameters(), pc.params.parameters()):
        g, c = g.detach().cpu().double(), c.detach().double()
        assert bool(((g - c).abs() <= budget + 4 * 2.0**-23 * c.abs()).all())


def test_checkpoint_from_card_resumes_on_cpu(dev, tmp_path, capsys):
    """A checkpoint written on the card restores on the card with the saved
    generator state (its envs reset from the saved stream, as `start` resets
    them), and on the CPU from the stored seed."""
    ppo = PPOConfig(n_steps=8, num_minibatches=4, n_epochs=2)
    card = PPOLearner(EnvConfig(), ppo, 16, device=dev)
    state = card.init(0)
    saved = state.generator.get_state()
    save_checkpoint(str(tmp_path), state)
    again, _ = restore_checkpoint(str(tmp_path), card)
    twin = torch.Generator(device=dev)
    twin.set_state(saved)
    want = card.start(twin, again.params)
    assert torch.equal(again.generator.get_state(), twin.get_state())
    assert torch.equal(again.obs, want.obs)
    host, step = restore_checkpoint(str(tmp_path), PPOLearner(EnvConfig(), ppo, 16,
                                                               device="cpu"))
    assert step == 0 and "seeded from the stored seed" in capsys.readouterr().out
    for a, b in zip(host.params.parameters(), state.params.parameters()):
        assert torch.equal(a, b.cpu())


def test_mixed_collision_on_card_matches_cpu(dev):
    """The box obstacles' geometry on the card against the CPU on a random
    mixed field: the collisions exact, the rounded-box distances to 1e-5 of
    scale; and a parallel_boxes step with its observation."""
    from drone2d_tpu_torch.ops import geometry

    g = torch.Generator().manual_seed(0)
    n, k = 4096, 6
    pos = 300 + 400 * torch.rand(n, 2, generator=g)
    angle = (torch.rand(n, generator=g) - 0.5) * 6.28
    centers = pos[:, None] + 110 * torch.randn(n, k, 2, generator=g)
    radii = 5 + 35 * torch.rand(n, k, generator=g)
    half_wh = (5 + 35 * torch.rand(n, k, 2, generator=g)) * (torch.rand(n, k, 1, generator=g)
                                                               < 0.5)
    mask = torch.rand(n, k, generator=g) < 0.85
    args = (pos, angle, 50.0, 5.0, centers, radii, half_wh, mask)
    want = geometry.any_collision_mixed(*args)
    got = geometry.any_collision_mixed(*(a.to(dev) if torch.is_tensor(a) else a for a in args))
    assert torch.equal(got.cpu(), want) and 0 < int(want.sum()) < n
    verts = geometry.frame_vertices(pos, angle, 50.0, 5.0)
    d = geometry.vertex_rounded_box_distances(verts, centers, half_wh, radii)
    d_dev = geometry.vertex_rounded_box_distances(verts.to(dev), centers.to(dev),
                                                  half_wh.to(dev), radii.to(dev))
    assert _scaled_err(d_dev.cpu(), d) <= 1e-5

    cfg = scenario_config("parallel_boxes").replace(path_table_n=128)
    state, _ = Drone2DEnv(cfg, device="cpu").reset_batch(torch.Generator().manual_seed(1), 256)
    i = torch.arange(256)
    on_box = state.obstacles.xy[i, i % 6] + torch.tensor([0.0, 33.0])
    state = dataclasses.replace(state, body=dataclasses.replace(
        state.body, pos=torch.where((i % 2 == 0)[:, None], on_box, state.body.pos)))
    action = torch.rand(256, 2, generator=g) * 2 - 1
    want = Drone2DEnv(cfg, device="cpu").step(state, action)
    got = Drone2DEnv(cfg, device=dev).step(_to(state, dev), action.to(dev))
    assert torch.equal(got.done.cpu(), want.done) and int(want.info["n_collisions"].sum()) > 0
    assert _scaled_err(got.obs.cpu(), want.obs) <= 1e-4


def test_vector_core_on_card_matches_cpu(dev):
    """The vector env core from CPU-made state and templates, 32 steps of
    CPU-made actions on both devices: the flags exact, obs and reward to
    1e-4 of scale; on the card the captured step (a CUDA graph) bit-equal
    to the same step run eagerly (`_eager_device_step`) in every output."""
    from drone2d_tpu_torch.compat.vector_env import VectorEnvCore

    n, cfg = 512, EnvConfig(path_table_n=128)
    env = Drone2DEnv(cfg, device="cpu")
    g = torch.Generator().manual_seed(2)
    start, _ = env.reset_batch(g, n, 3e6)
    tmpl = env.reset_batch(g, n, 3e6)
    actions = torch.randn((32, n, 2), generator=g).clamp(-1, 1).numpy()
    runs = {}
    for d, captured in (("cpu", True), (dev, False), (dev, True)):
        core = VectorEnvCore(n, global_step=3_000_000, device=d, template_refresh_steps=10**9,
                             path_table_n=128)
        if not captured:
            _eager_device_step(core)
        core.start_from(_to(start, d), (_to(tmpl[0], d), tmpl[1].to(d)))
        runs[(str(d), captured)] = [core.step(a) for a in actions]
        if d == dev and captured:
            assert core._step.graph.graph is not None
    # the captured step on the card bit-equal to the same step run eagerly
    for got, want in zip(runs[("cuda", True)], runs[("cuda", False)]):
        for g, w in zip(got[:4], want[:4]):
            np.testing.assert_array_equal(g, w)
        assert set(got[4]) == set(want[4])
        for k in want[4]:
            np.testing.assert_array_equal(got[4][k], want[4][k], err_msg=k)
    runs = {str(d): runs[(str(d), True)] for d in ("cpu", dev)}
    ends = 0
    for got, want in zip(runs[str(dev)], runs["cpu"]):
        np.testing.assert_array_equal(got[2], want[2])
        np.testing.assert_array_equal(got[3], want[3])
        for a, b in zip(got[:2], want[:2]):
            assert _scaled_err(torch.as_tensor(a), torch.as_tensor(b)) <= 1e-4
        ends += int((want[2] | want[3]).sum())
    assert ends > 0


def test_gym_env_captured_step_bit_equal_to_eager(dev):
    """Drone2dGymEnv on the card, captured (a CUDA graph of the B=1 step)
    and eager (`_eager_device_step`), from one seed over 40 steps of one action
    sequence, through `step` and `step_gymnasium` and across a reset (the
    graph kept): every obs, reward, flag and info value bit-equal."""
    from drone2d_tpu_torch.compat import make

    actions = np.random.default_rng(0).uniform(-1.2, 1.2, (40, 2)).astype(np.float32)
    runs = {}
    for captured in (True, False):
        env = make("stage_3", seed=4, device=dev, n_steps=16, path_table_n=128)
        if not captured:
            _eager_device_step(env)
        env.reset()
        out = []
        for t, a in enumerate(actions):
            if t % 2:
                obs, reward, terminated, truncated, info = env.step_gymnasium(a)
                done = terminated or truncated
            else:
                obs, reward, done, info = env.step(a)
            out.append((obs, reward, done, info))
            if done:
                env.reset()
        runs[captured] = out
        if captured:
            assert env._step.graph.graph is not None
    assert sum(o[2] for o in runs[False]) >= 2  # the 16-step cap ends episodes
    for got, want in zip(runs[True], runs[False]):
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:3] == want[1:3] and got[3] == want[3]


def test_graft_step_on_card_matches_cpu(dev, monkeypatch):
    """`step_batch` on the card against the CPU with the same injected
    fresh reset batch: the same ends and the same restarted episodes; and
    on its own it draws fresh episodes on the card."""
    cfg = EnvConfig(path_table_n=128, n_steps=4)
    env_cpu, env_dev = Drone2DEnv(cfg, device="cpu"), Drone2DEnv(cfg, device=dev)
    g = torch.Generator().manual_seed(3)
    state, _ = env_cpu.reset_batch(g, 256)
    state = dataclasses.replace(state, t=torch.randint(0, 4, (256,), generator=g,
                                                       dtype=torch.int32))
    fresh = env_cpu.reset_batch(g, 256)
    action = torch.rand(256, 2, generator=g) * 2 - 1
    monkeypatch.setattr(env_cpu, "reset_batch", lambda *a, **k: fresh)
    monkeypatch.setattr(env_dev, "reset_batch",
                        lambda *a, **k: (_to(fresh[0], dev), fresh[1].to(dev)))
    want = env_cpu.step_batch(state, action, torch.Generator())
    got = env_dev.step_batch(_to(state, dev), action.to(dev), torch.Generator(device=dev))
    assert torch.equal(got.done.cpu(), want.done) and bool(want.done.any())
    assert torch.equal(got.state.t.cpu(), want.state.t)
    assert torch.equal(got.state.path.wps.cpu(), want.state.path.wps)
    assert _scaled_err(got.obs.cpu(), want.obs) <= 1e-4
    monkeypatch.undo()
    gen = torch.Generator(device=dev).manual_seed(0)
    s, _ = env_dev.reset_batch(gen, 64)
    for _ in range(4):
        before = s.path.wps[:, 0]
        out = env_dev.step_batch(s, torch.zeros(64, 2, device=dev), gen)
        s = out.state
    assert bool(out.done.all()) and bool((s.t == 0).all())
    assert not bool((s.path.wps[:, 0] == before).all(1).any())


def test_world_one_nccl_shard_update_bit_equal_to_plain(dev):
    """`shard_update` over a world-1 NCCL group on the card against the
    plain update from a copy of the same state with the rank's generator:
    weights, Adam's state and every metric bit-equal (the collectives run:
    a sum over one rank and a division by 1.0 are exact)."""
    import copy

    import torch.distributed as dist

    from drone2d_tpu_torch.parallel import mesh

    group, d = mesh.make_group("cuda:0", backend="nccl")
    try:
        assert dist.get_backend(group) == "nccl"
        learner = PPOLearner(EnvConfig(path_table_n=128),
                             PPOConfig(n_steps=8, num_minibatches=4, n_epochs=2,
                                       hidden_sizes=(32, 32)), 64, device=d)
        state = mesh.shard_init(group, learner, 3)
        twin = torch.Generator(device=d)
        twin.set_state(state.generator.get_state())
        params = copy.deepcopy(state.params)
        plain = dataclasses.replace(state, params=params,
                                    optimizer=optim.adam(params.parameters(), 3e-4),
                                    generator=twin)
        got_state, got = mesh.shard_update(group, learner)(state)
        want_state, want = learner.update(plain)
    finally:
        dist.destroy_process_group()
    for a, b in zip(got_state.params.parameters(), want_state.params.parameters()):
        assert torch.equal(a, b)
    for sa, sb in zip(got_state.optimizer.state.values(), want_state.optimizer.state.values()):
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_world_one_nccl_captured_update_bit_equal_to_eager(dev):
    """Over a world-1 NCCL group, two `shard_update`s from twin states: the
    captured update (`update_jit` with the group: NCCL's collectives inside
    the CUDA graphs) against the eager one (`update(..., group=group)`) and
    the plain `update_jit`, each drawing from a twin of the rank's
    generator: weights, Adam's state, every metric and the generator's
    state after bit-equal; a replayed update launches the kernel n_steps +
    1 times, the capturing one twice that."""
    import copy

    import torch.distributed as dist

    from drone2d_tpu_torch.parallel import mesh

    group, d = mesh.make_group("cuda:0", backend="nccl")
    try:
        learner = PPOLearner(EnvConfig(path_table_n=128),
                             PPOConfig(n_steps=8, num_minibatches=4, n_epochs=2,
                                       hidden_sizes=(32, 32)), 64, device=d)
        state = mesh.shard_init(group, learner, 3)
        gen = state.generator.get_state()

        def twin():
            params = copy.deepcopy(state.params)
            opt = optim.adam(params.parameters(), 3e-4)
            opt.load_state_dict(state.optimizer.state_dict())
            g = torch.Generator(device=d)
            g.set_state(gen)
            return dataclasses.replace(state, params=params, optimizer=opt, generator=g)

        runs, launches = {}, []
        for name, fn in (
                ("captured", mesh.shard_update(group, learner)),
                ("eager", functools.partial(learner.update, group=group)),
                ("jit", learner.update_jit)):
            s, ms = twin(), []
            for _ in range(2):
                before = fused_sample_action.launches
                s, m = fn(s)
                ms.append(m)
                if name == "captured":
                    launches.append(fused_sample_action.launches - before)
            runs[name] = (s, ms)
    finally:
        dist.destroy_process_group()
    assert launches == [2 * 9, 9]
    got_state, got = runs["captured"]
    for name in ("eager", "jit"):
        want_state, want = runs[name]
        for a, b in zip(got_state.params.parameters(), want_state.params.parameters()):
            assert torch.equal(a, b), name
        assert all(torch.equal(a, b) for a, b in zip(optim_tensors(got_state.optimizer),
                                                     optim_tensors(want_state.optimizer)))
        for m, w in zip(got, want):
            assert all(torch.equal(m[k], w[k]) for k in w), name
        assert torch.equal(got_state.generator.get_state(), want_state.generator.get_state())


def test_split_chunk_on_card_bit_exact(dev):
    """The split-carry step on the card over a chunk against the template
    step: every step's obs, reward and done bit-equal, and finalize_split
    equal to the template chunk's state."""
    from drone2d_tpu_torch.env.types import finalize_split, split_state

    env = Drone2DEnv(EnvConfig(path_table_n=128), device=dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    state, _ = env.reset_batch(gen, 512, 3e6)
    state.t = torch.where(torch.arange(512, device=dev) % 2 == 0, 1090, state.t).to(torch.int32)
    tmpl, tmpl_obs = env.reset_batch(gen, 512, 3e6)
    actions = torch.rand(32, 512, 2, generator=gen, device=dev) * 2 - 1
    init_static, dyn = split_state(state)
    tmpl_static, tmpl_dyn = split_state(tmpl)
    fresh = torch.zeros(512, dtype=torch.bool, device=dev)
    for t in range(32):
        out = env.step_batch_template(state, actions[t], tmpl, tmpl_obs)
        dyn, fresh, obs, reward, done, _ = env.step_batch_split(
            dyn, fresh, actions[t], init_static, tmpl_static, tmpl_dyn, tmpl_obs)
        assert torch.equal(obs, out.obs) and torch.equal(reward, out.reward)
        assert torch.equal(done, out.done)
        state = out.state
    assert int(fresh.sum()) >= 256
    final = finalize_split(init_static, tmpl_static, fresh, dyn)
    for name in ("t", "total_reward", "target", "family"):
        assert torch.equal(getattr(final, name), getattr(state, name)), name
    assert torch.equal(final.path.table_u, state.path.table_u)
    assert torch.equal(final.body.pos, state.body.pos)


def test_device_window_counts_the_call_not_its_lead_in(dev):
    """`utils.profiling.device_window` opens on the lead-in of trivial
    kernels and returns the device events of the call alone."""
    from drone2d_tpu_torch.utils.profiling import device_window

    x = torch.zeros(1024, device=dev)
    x.add_(1)
    torch.cuda.synchronize()
    events, dev_us, wall_us = device_window(lambda: [x.mul_(2) for _ in range(3)])
    assert len(events) == 3 and dev_us > 0 and wall_us > 0


def test_device_window_leaves_out_the_spans_annotations(dev):
    """The program's spans open `record_function` inside a profiler window;
    their annotations on the device's timeline are no device events."""
    from drone2d_tpu_torch.utils import profiling

    x = torch.zeros(1024, device=dev)
    x.add_(1)
    torch.cuda.synchronize()

    def spanned():
        with profiling.span("outer", device=True):
            with profiling.span("inner"):
                for _ in range(3):
                    x.mul_(2)

    profiling.reset()
    events, dev_us, _ = profiling.device_window(spanned)
    assert [s.name for s in profiling.spans()] == ["outer", "inner"]
    assert len(events) == 3 and dev_us > 0
    assert not {"outer", "inner"} & {e.name for e in events}
    profiling.reset()


def test_bench_chunk_on_card_matches_cpu(dev):
    """The bench chunk (policy kernel, clip, template step) on the card
    against the plain version on the CPU, from identical inputs."""
    from drone2d_tpu_torch.bench import chunk_from

    n, t = 256, 4
    cpu_env = Drone2DEnv(EnvConfig(), "cpu")
    gen = torch.Generator().manual_seed(2)
    state, obs = cpu_env.reset_batch(gen, n, 3e6)
    tmpl, tmpl_obs = cpu_env.reset_batch(gen, n, 3e6)
    noise = torch.randn((t, n, 2), generator=gen)
    out = {}
    for d in ("cpu", dev):
        params = flat_dict_to_params(dict(np.load(AGENT)), device=d)
        env = Drone2DEnv(EnvConfig(), d)
        out[str(d)] = chunk_from(params, env, _to(state, d), obs.to(d), _to(tmpl, d),
                                 tmpl_obs.to(d), noise.to(d))[2]
    assert _scaled_err(out["cuda"].cpu(), out["cpu"]) <= 1e-4


def test_bench_counts_launches_and_device_ops_on_card(dev):
    """The env line's captured chunk (a 4-step graph here) and the train
    line's update_jit: each capture warms up once (4 launches; one update's
    9), then the warm-up chunk or update, the timed ones, the eager
    profiled steps or rollout, and one more captured chunk or update under
    the profiler; a replay issues far fewer host launches than device ops."""
    from drone2d_tpu_torch import bench

    env = bench.time_env(64, 4, 2)
    assert env["warmup_launches"] == 4 and env["launches"] == 8
    assert env["launches_all"] == 4 + 3 * 4 + bench.OPS_STEPS + 4
    assert 100 < env["ops_a_step"] < 2000 and len(env["seconds"]) == 2
    host, ops = env["captured_a_step"]
    assert 100 < ops and host < ops / 10  # a 4-step graph: the copies in and out dominate
    train = bench.time_train(num_envs=64, ppo=dict(n_steps=8, num_minibatches=4, n_epochs=1),
                             repeats=1)
    assert train["warmup_launches"] == 9 and train["launches"] == 9
    assert train["launches_all"] == 9 + 2 * 9 + 9 + 9
    # a minibatch step is the SGD kernel's three launches (ops/ppo_sgd.py), with
    # the epoch's own few ops shared out
    assert np.isfinite(train["loss"]) and 3 <= train["ops_a_step"] < 10
    host, ops = train["captured_an_update"]
    assert host < ops


# -- the compiled programs: CUDA graphs of update_jit and the eval runner ------

GRAPH_PPO = dict(n_steps=8, num_minibatches=4, n_epochs=2, hidden_sizes=(128, 128))


def _assert_same_state(a, b):
    for x, y in zip(a.params.parameters(), b.params.parameters()):
        assert torch.equal(x, y)
    xs, ys = optim_tensors(a.optimizer), optim_tensors(b.optimizer)
    assert len(xs) == len(ys) > 0 and all(torch.equal(x, y) for x, y in zip(xs, ys))
    from drone2d_tpu_torch.utils import graphs

    for x, y in zip(graphs.leaves((a.env_state, a.obs, a.global_step, a.episodes_total,
                                   a.family_counts, a.family_wins)),
                    graphs.leaves((b.env_state, b.obs, b.global_step, b.episodes_total,
                                   b.family_counts, b.family_wins))):
        assert (x is None and y is None) or torch.equal(x, y)


def optim_tensors(opt):
    from drone2d_tpu_torch.utils import graphs

    return graphs.optimizer_tensors(opt)


@pytest.mark.parametrize("shuffle", ["exact", "affine", "timeperm"])
def test_update_jit_bit_equal_to_update(dev, shuffle):
    """update_jit (the draws made in its rollout graph) and update from twin
    states, 3 updates each in turn at curriculum stage 5 (64 envs, every
    other one near the cap): weights, Adam's whole state, metrics, envs,
    counters and the generator's state bit-equal after each;
    the kernel launched 2 (n_steps + 1) times by the capturing call (its
    warm-up's update, then the replay) and n_steps + 1 by each later one."""
    learner = PPOLearner(EnvConfig(), PPOConfig(**GRAPH_PPO, shuffle=shuffle), 64, device=dev)
    cap, i = EnvConfig().n_steps, torch.arange(64, device=dev)
    t = torch.where(i % 2 == 0, cap - 1 - i % 6, 0).to(torch.int32)

    def start():
        s = learner.init(3, global_step=3e6)
        return dataclasses.replace(s, env_state=dataclasses.replace(s.env_state, t=t))

    a, b = start(), start()
    finished = 0.0
    for u in range(3):
        before = fused_sample_action.launches
        a, ma = learner.update_jit(a)
        torch.cuda.synchronize()
        assert fused_sample_action.launches - before == (2 if u == 0 else 1) * 9
        b, mb = learner.update(b)
        assert set(ma) == set(mb) and all(torch.equal(ma[k], mb[k]) for k in ma)
        _assert_same_state(a, b)
        assert torch.equal(a.generator.get_state(), b.generator.get_state())
        finished += float(ma["episodes/episodes"])
    assert finished > 0 and learner._graphs.captures == 1


def test_population_update_jit_bit_equal_to_update(dev):
    """A population of 8 through update_jit and update, 3 updates in turn:
    bit-equal, every member's generator state included; one launch a step
    for all 8 members under replay."""
    trainer = ZooTrainer(EnvConfig(), PPOConfig(**GRAPH_PPO), 32, device=dev)
    a, b = trainer.init(list(range(8))), trainer.init(list(range(8)))
    for u in range(3):
        before = fused_sample_action.launches
        a, ma = trainer.update_jit(a)
        torch.cuda.synchronize()
        assert fused_sample_action.launches - before == (2 if u == 0 else 1) * 9
        b, mb = trainer.update(b)
        assert all(torch.equal(ma[k], mb[k]) for k in ma)
        _assert_same_state(a, b)
        assert all(torch.equal(x.get_state(), y.get_state())
                   for x, y in zip(a.generators, b.generators))


def _jit_against_eager(learner, a, b, updates):
    """`updates` updates of twin states through update_jit and update, in
    turn: bit-equal after each, the generators' states included; the
    capturing call launches the kernel warmup_launches + n_steps + 1 times,
    each later one n_steps + 1."""
    from drone2d_tpu_torch.learn.ppo import warmup_launches

    T = learner.cfg.n_steps
    for u in range(updates):
        before = fused_sample_action.launches
        a, ma = learner.update_jit(a)
        torch.cuda.synchronize()
        assert fused_sample_action.launches - before == (T + 1) + (
            warmup_launches(T) if u == 0 else 0)
        b, mb = learner.update(b)
        assert set(ma) == set(mb) and all(torch.equal(ma[k], mb[k]) for k in ma)
        _assert_same_state(a, b)
        gens = (a.generators, b.generators) if hasattr(a, "generators") else (
            [a.generator], [b.generator])
        assert all(torch.equal(x.get_state(), y.get_state()) for x, y in zip(*gens))
    assert learner._graphs.captures == 1
    return a, ma


@pytest.mark.parametrize("shuffle", ["exact", "affine", "timeperm"])
def test_chunked_update_jit_bit_equal_to_update(dev, shuffle):
    """A rollout longer than ROLLOUT_CHUNK (1024 steps of 16 envs, 4 chunks
    of 256) through update_jit and update, 2 updates each in turn, in each
    shuffle: bit-equal, and episodes finished inside the rollout."""
    from drone2d_tpu_torch.learn.ppo import rollout_chunks

    cfg = PPOConfig(n_steps=1024, num_minibatches=8, n_epochs=1, shuffle=shuffle)
    assert rollout_chunks(cfg.n_steps) == [256] * 4
    learner = PPOLearner(EnvConfig(), cfg, 16, device=dev)
    _, m = _jit_against_eager(learner, learner.init(5), learner.init(5), 2)
    assert float(m["episodes/episodes"]) > 0


def test_sb3_shape_population_update_jit_bit_equal_to_update(dev):
    """The reference's own shape: the population of the SB3-shape hunt (8
    seeds x 14 envs x 2048 steps, 448 minibatches of 64, exact, 64-64; one
    epoch) through update_jit, its rollout in 8 chunks, and update, 2
    updates each in turn: bit-equal."""
    from drone2d_tpu_torch.learn.ppo import rollout_chunks

    cfg = PPOConfig(n_steps=2048, num_minibatches=448, n_epochs=1)
    assert (cfg.shuffle, cfg.hidden_sizes, len(rollout_chunks(2048))) == ("exact", (64, 64), 8)
    trainer = ZooTrainer(EnvConfig(), cfg, 14, device=dev)
    seeds = list(range(40, 48))
    _jit_against_eager(trainer, trainer.init(seeds), trainer.init(seeds), 2)


def test_chunked_population_with_a_rest_and_rehearsal_bit_equal(dev):
    """A population of 2 under adaptive rehearsal (the family counts written
    by the chunks) with a rollout of 300 steps (chunks of 256 and 44):
    update_jit bit-equal to update over 2 updates, episodes counted by
    family."""
    env = EnvConfig(adaptive_rehearsal=True, stage_mix_prob=0.3, corridor_mix_prob=0.1)
    cfg = PPOConfig(n_steps=300, num_minibatches=4, n_epochs=1)
    trainer = ZooTrainer(env, cfg, 8, device=dev)
    a, m = _jit_against_eager(trainer, trainer.init([1, 2]), trainer.init([1, 2]), 2)
    assert float(a.family_counts.sum()) > 0


def test_flagship_update_jit_still_bit_equal_to_update(dev):
    """flagship-scratch at its own shape (1024 envs x 128 steps, one rollout
    graph; 64 x 10 SGD, timeperm, 128-128): update_jit bit-equal to update
    over 2 updates."""
    from drone2d_tpu_torch.learn.ppo import rollout_chunks

    env_cfg, ppo_cfg, train_cfg = apply_preset("flagship-scratch", EnvConfig(), PPOConfig(),
                                               TrainConfig())
    assert rollout_chunks(ppo_cfg.n_steps) == [ppo_cfg.n_steps]
    learner = PPOLearner(env_cfg, ppo_cfg, train_cfg.num_envs, device=dev)
    _jit_against_eager(learner, learner.init(7), learner.init(7), 2)


@pytest.mark.parametrize("policy", ["stochastic", "deterministic", "random"])
def test_captured_eval_runner_bit_equal_to_eager(dev, policy):
    """agent_s8004 on stage_2 at a 100-step cap (a 64-step graph and a
    36-step one) and 256 episodes: every field of the results equal between
    the captured runner and the same chunks run eagerly."""
    cfg = scenario_config("stage_2").replace(n_steps=100)
    env = Drone2DEnv(cfg, device=dev)
    params = None if policy == "random" else flat_dict_to_params(dict(np.load(AGENT)), device=dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    state, obs = env.reset_batch(gen, 256)
    draws = torch.randn((100, 256, 2), generator=gen, device=dev).clamp(-1, 1)
    det = policy == "deterministic"
    got = run_episodes_from(env, params, state, obs, draws, deterministic=det)
    want = run_episodes_from(env, params, state, obs, draws, deterministic=det, captured=False)
    for k, g, w in zip(got._fields, got, want):
        np.testing.assert_array_equal(g, w, err_msg=k)


def test_replay_counts_its_captured_launches(dev):
    """A graph of two kernel launches: its capture counts none, each replay
    counts two, and its outputs are static (the next replay overwrites
    them)."""
    from drone2d_tpu_torch.utils import graphs

    params = flat_dict_to_params(dict(np.load(AGENT)), device=dev)
    obs = torch.randn(64, 27, device=dev)
    noise = torch.randn(64, 2, device=dev)
    g = graphs.Graph(lambda: [params.sample_action(obs, noise=noise)[0] for _ in range(2)], dev)
    before = fused_sample_action.launches
    graphs.capture([g])
    assert fused_sample_action.launches - before == 2  # the warm-up's, which ran
    assert g.launches == 2 and g.nodes >= 2
    for k in range(3):
        out = g()
        assert fused_sample_action.launches - before == 2 + 2 * (k + 1)
    torch.cuda.synchronize()
    want = fused_sample_action(params, obs, noise)[0]
    assert torch.equal(out[0], want) and out[0] is g()[0]


def test_capture_with_a_host_sync_raises(dev):
    """A body that reads a value on the host cannot be captured: capture
    raises, and nothing runs in its place; the card works afterwards."""
    from drone2d_tpu_torch.utils import graphs

    x = torch.ones(8, device=dev)
    g = graphs.Graph(lambda: x * float(x.sum()), dev)
    with pytest.raises(RuntimeError):
        graphs.capture([g])
    torch.cuda.synchronize()
    assert float((x + 1).sum()) == 16.0


def test_checkpoint_after_update_jit_resumes_on_cpu(dev, tmp_path, capsys):
    """After update_jit, Adam's step count is a card tensor (a capturable
    Adam); the checkpoint restores on the CPU with the same weights and
    Adam state, a CPU step count, and trains on there."""
    ppo = PPOConfig(n_steps=8, num_minibatches=4, n_epochs=2)
    card = PPOLearner(EnvConfig(), ppo, 16, device=dev)
    state, _ = card.update_jit(card.init(0))
    state, _ = card.update_jit(state)
    steps = [s["step"] for s in state.optimizer.state.values()]
    assert all(t.device.type == "cuda" and float(t) == 16 for t in steps)
    save_checkpoint(str(tmp_path), state)
    host_learner = PPOLearner(EnvConfig(), ppo, 16, device="cpu")
    host, _ = restore_checkpoint(str(tmp_path), host_learner)
    for a, b in zip(host.params.parameters(), state.params.parameters()):
        assert torch.equal(a, b.cpu())
    for a, b in zip(optim_tensors(host.optimizer), optim_tensors(state.optimizer)):
        assert a.device.type == "cpu" and torch.equal(a, b.cpu())
    host, metrics = host_learner.update_jit(host)
    assert np.isfinite(float(metrics["loss"]))
    assert all(float(s["step"]) == 24 for s in host.optimizer.state.values())
    again, _ = restore_checkpoint(str(tmp_path), card)
    assert all(s["step"].device.type == "cuda" for s in again.optimizer.state.values())


def test_fused_policy_probe_and_split_probe_on_card(dev):
    from drone2d_tpu_torch.scripts import bench_fused_policy, probe_split_carry

    res = bench_fused_policy.run(512, 8, 1)
    assert max(res["scaled_errors"].values()) <= 1e-5 and res["scaled_errors"]["logp"] == 0.0
    assert probe_split_carry.run(256, 8, 1)["first_chunk_reward_equal"]


@pytest.mark.parametrize("variant", ["template", "no_autoreset", "split"])
def test_captured_probe_chunks_bit_equal_to_eager(dev, variant):
    """The probes' captured chunks on the card (an 8-step graph replayed 4
    times for a 32-step chunk): `CapturedChunk`, with and without the
    auto-reset, and `CapturedSplitChunk`, each bit-equal to its eager chunk
    (`chunk_from`, `chunk_split_from`) in its rewards, obs and state."""
    from drone2d_tpu_torch import bench
    from drone2d_tpu_torch.utils import graphs

    n, t = 512, 32
    env = Drone2DEnv(EnvConfig(path_table_n=128), dev)
    params = flat_dict_to_params(dict(np.load(AGENT)), device=dev)
    gen = torch.Generator(device=dev).manual_seed(6)
    state, obs = env.reset_batch(gen, n, 3e6)
    state.t = torch.where(torch.arange(n, device=dev) % 2 == 0, 1090, state.t).to(torch.int32)
    draws = bench.draw_chunk(env, n, gen, t, dev)
    cls, eager, kw = {
        "template": (bench.CapturedChunk, bench.chunk_from, {}),
        "no_autoreset": (bench.CapturedChunk, bench.chunk_from, {"autoreset": False}),
        "split": (bench.CapturedSplitChunk, bench.chunk_split_from, {}),
    }[variant]
    run = cls(params, env, state, obs, *draws[:2], 8, **kw)
    assert run.graph.graph is not None
    got = run(state, obs, *draws)
    want = eager(params, env, state, obs, *draws, **kw)
    assert bool(want[2].ne(0).any())
    for a, b in zip(graphs.leaves(got), graphs.leaves(want)):
        assert (a is None and b is None) or torch.equal(a, b)


# -- the draws inside the graphs ------------------------------------------------


@pytest.mark.parametrize("cls_name", ["CapturedChunk", "CapturedSplitChunk"])
def test_bench_chunk_draws_inside_bit_equal_to_eager(dev, cls_name):
    """The bench's chunk with its template and noise drawn by its draw graph
    (an 8-step graph, 32-step chunks, 3 chunks at 512 envs) against
    `bench.chunk` from a twin generator: rewards, obs and envs bit-equal
    each chunk, the generators in the same state after."""
    from drone2d_tpu_torch import bench
    from drone2d_tpu_torch.utils import graphs

    n, t = 512, 32
    env = Drone2DEnv(EnvConfig(path_table_n=128), dev)
    params = flat_dict_to_params(dict(np.load(AGENT)), device=dev)
    state, obs = env.reset_batch(torch.Generator(device=dev).manual_seed(6), n, 3e6)
    state.t = torch.where(torch.arange(n, device=dev) % 2 == 0, 1090, state.t).to(torch.int32)
    g1 = torch.Generator(device=dev).manual_seed(7)
    g2 = torch.Generator(device=dev).manual_seed(7)
    run = getattr(bench, cls_name)(params, env, state, obs, steps=8, gen=g1, chunk_t=t)
    a = b = (state, obs)
    for _ in range(3):
        got = run(*a)
        want = bench.chunk(params, env, *b, g2, t)
        for x, y in zip(graphs.leaves(got), graphs.leaves(want)):
            assert (x is None and y is None) or torch.equal(x, y)
        a, b = got[:2], want[:2]
    assert torch.equal(g1.get_state(), g2.get_state())


def test_graft_step_captured_bit_equal_to_eager(dev):
    """The graft step as one graph (`graft.GraftStep`: the noise and a whole
    reset batch drawn inside it each step) against the eager
    `sample_action` + `step_batch` from a twin generator, 256 envs x 24
    steps at an 8-step episode cap: obs, reward, done and value bit-equal
    each step, the generators equal after."""
    from drone2d_tpu_torch.graft import GraftStep, graft_step

    env = Drone2DEnv(EnvConfig(n_steps=8), dev)
    params = ActorCritic(27, 2, (128, 128), generator=torch.Generator().manual_seed(0),
                         device=dev)
    state, obs = env.reset_batch(torch.Generator(device=dev).manual_seed(1), 256, 0.0)
    g1 = torch.Generator(device=dev).manual_seed(2)
    g2 = torch.Generator(device=dev).manual_seed(2)
    step = GraftStep(params, env, g1)
    a = b = (state, obs)
    ended = 0
    for _ in range(24):
        s1, o1, r1, d1, v1 = step(*a)
        s2, o2, r2, d2, v2 = graft_step(params, env, *b, g2, 0.0)
        for x, y in zip((o1, r1, d1, v1, s1.path.wps), (o2, r2, d2, v2, s2.path.wps)):
            assert torch.equal(x, y)
        ended += int(d1.sum())
        a, b = (s1, o1), (s2, o2)
    assert ended > 0 and torch.equal(g1.get_state(), g2.get_state())


def test_drawn_replays_run_without_a_host_sync(dev):
    """A drawn-inside update, bench chunk and graft step, each captured
    first, then replayed under `torch.cuda.set_sync_debug_mode("error")`:
    nothing on their paths waits for the card."""
    from drone2d_tpu_torch import bench
    from drone2d_tpu_torch.graft import GraftStep

    learner = PPOLearner(EnvConfig(), PPOConfig(**GRAPH_PPO), 64, device=dev)
    state, _ = learner.update_jit(learner.init(1, global_step=3e6))
    env = learner.env
    run = bench.CapturedChunk(state.params, env, state.env_state, state.obs, steps=8,
                              gen=torch.Generator(device=dev).manual_seed(2), chunk_t=16)
    step = GraftStep(state.params, env, torch.Generator(device=dev).manual_seed(3))
    graft_in = step(state.env_state, state.obs)[:2]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, metrics = learner.update_jit(state)
        chunk_out = run(state.env_state, state.obs)
        graft_out = step(*graft_in)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert np.isfinite(float(metrics["loss"])) and learner._graphs.captures == 1
    assert bool(torch.isfinite(chunk_out[2]).all()) and bool(torch.isfinite(graft_out[1]).all())


def test_capture_refuses_a_cpu_generator(dev):
    """A graph on the card bound to a CPU generator raises at capture."""
    from drone2d_tpu_torch.utils import graphs

    gen = torch.Generator().manual_seed(0)
    g = graphs.Graph(lambda: torch.rand(8, generator=gen), dev, generators=[gen])
    with pytest.raises(ValueError):
        graphs.capture([g])


@pytest.mark.parametrize("policy", ["stochastic", "deterministic", "random"])
def test_campaign_draws_inside_bit_equal_to_eager(dev, policy):
    """`run_episodes` on the card (the reset batch and the draws made by the
    kept env's draw graph, the runner captured) at two seeds against the
    eager draws from a fresh generator of each seed, flown by the eager
    runner: every field equal; the second seed replays the same draw
    graph."""
    from drone2d_tpu_torch.eval import episode

    cfg = scenario_config("stage_2").replace(n_steps=100)
    params = None if policy == "random" else flat_dict_to_params(dict(np.load(AGENT)), device=dev)
    det = policy == "deterministic"
    made = None
    for seed in (11, 12):
        got = episode.run_episodes(cfg, params, seed, 256, deterministic=det)
        c = episode._campaign_env(cfg, None)
        made = c.draws.captures if made is None else made
        env = Drone2DEnv(cfg, device=dev)
        state, obs, draws = episode._episode_draws(
            env, torch.Generator(device=dev).manual_seed(seed), 256, 0.0, policy)
        want = run_episodes_from(env, params, state, obs, draws, deterministic=det,
                                 captured=False)
        for k, g, w in zip(got._fields, got, want):
            np.testing.assert_array_equal(g, w, err_msg=k)
    assert c.draws.captures == made


def test_adapters_draws_inside_bit_equal_to_eager(dev):
    """The vector env's and the gym env's resets on the card (their draw
    graphs, bound to the env's one generator) equal the eager reset from a
    fresh generator of each seed."""
    from drone2d_tpu_torch.compat import make
    from drone2d_tpu_torch.compat.vector_env import VectorEnvCore

    vec = VectorEnvCore(256, seed=1, global_step=3_000_000, path_table_n=128)
    for seed in (1, 4):
        obs, _ = vec.reset(seed=seed)
        _, want = Drone2DEnv(vec.cfg, dev).reset_batch(
            torch.Generator(device=dev).manual_seed(seed), 256, 3e6)
        assert np.array_equal(obs, want.cpu().numpy())
    gym = make("corridor")
    for seed in (2, 3):
        gym.seed(seed)
        obs = gym.reset()
        _, want = Drone2DEnv(gym.cfg, dev).reset(torch.Generator(device=dev).manual_seed(seed))
        assert np.array_equal(obs, want[0].cpu().numpy())


def test_capture_survives_a_graph_freed_by_the_collector(dev):
    """A captured graph left in a reference cycle, then a new capture with
    the cyclic collector set to run at every allocation: the old graph is
    freed before the recording, never during it (which would invalidate
    the recording), and the new graph replays right."""
    import gc

    from drone2d_tpu_torch.utils import graphs

    x = torch.arange(8.0, device=dev)

    class Holder:
        pass

    held = Holder()
    held.cycle = held
    held.graph = graphs.Graph(lambda: x * 2, dev)
    graphs.capture([held.graph])
    del held
    threshold = gc.get_threshold()
    gc.set_threshold(1)
    try:
        g = graphs.Graph(lambda: [x * k for k in range(64)], dev)
        graphs.capture([g])
    finally:
        gc.set_threshold(*threshold)
    assert torch.equal(g()[3], x * 3)


@pytest.fixture
def spans_on():
    """The recorder (`utils/profiling.py`) emptied and on; off and empty after."""
    from drone2d_tpu_torch.utils import profiling

    profiling.reset()
    profiling.enable()
    yield profiling
    profiling.enable(False)
    profiling.reset()


def test_update_jit_spans_on_card(dev, spans_on):
    """Two captured updates with spans off, then two from a twin state with
    spans on: bit-equal; one capture, caused by `update`; the last update's
    `update.rollout` and `update.sgd` timed on the device, their sum within
    the host's time from the `update` span's start to the synchronize after
    it."""
    import time

    profiling = spans_on
    cfg = PPOConfig(**GRAPH_PPO)
    on = PPOLearner(EnvConfig(), cfg, 64, device=dev)
    off = PPOLearner(EnvConfig(), cfg, 64, device=dev)
    a, b = on.init(3), off.init(3)
    profiling.enable(False)
    for _ in range(2):
        b, mb = off.update_jit(b)
    profiling.reset()
    profiling.enable()
    for _ in range(2):
        a, ma = on.update_jit(a)
    torch.cuda.synchronize()
    synced_ns = time.time_ns()
    assert set(ma) == set(mb) and all(torch.equal(ma[k], mb[k]) for k in ma)
    _assert_same_state(a, b)
    c = profiling.counters()
    assert c["graphs.captures[update]"] == c["graphs.captures"] == 1
    assert c["graph_cache.hits"] == 1
    spans = profiling.spans()
    (capture,) = [s for s in spans if s.name == "graphs.capture"]
    assert capture.attrs["cause"] == "update" and capture.attrs["nodes"] > 0
    update = [s for s in spans if s.name == "update"][-1]
    kids = {s.name: s for s in spans if s.parent == update.id}
    rollout, sgd = kids["update.rollout"].device_s, kids["update.sgd"].device_s
    assert rollout > 0 and sgd > 0
    assert (rollout + sgd) * 1e9 <= synced_ns - update.start_ns


def _empty_eval_caches(monkeypatch, campaign_envs=None):
    """The eval module's campaign envs and runners emptied (room for
    `campaign_envs` envs, if given); put back after the test."""
    import collections

    from drone2d_tpu_torch.eval import episode
    from drone2d_tpu_torch.utils import graphs

    monkeypatch.setattr(episode, "_CAMPAIGN_ENVS", collections.OrderedDict())
    monkeypatch.setattr(episode, "_EVAL_RUNNERS", graphs.GraphCache(size=2, counter="eval_runner"))
    if campaign_envs is not None:
        monkeypatch.setattr(episode, "CAMPAIGN_ENVS", campaign_envs)


def test_selection_calls_past_the_campaign_envs_capture_anew(dev, spans_on, monkeypatch):
    """Two selection calls on two scenarios with room for one campaign env:
    each makes its env anew and captures its draw graph; the first also
    captures the runner, which the second flies (shared across scenarios),
    with the causes that say so."""
    from drone2d_tpu_torch.eval import episode

    _empty_eval_caches(monkeypatch, campaign_envs=1)
    stack = stack_params([flat_dict_to_params(dict(np.load(p)), device=dev) for p in AGENTS])
    for scen in ("stage_2", "corridor"):
        res = episode.run_episodes_multi(scenario_config(scen).replace(n_steps=100), stack, 5,
                                         16, device=dev)
        assert res.success.shape == (3, 16)
    profiling = spans_on
    spans = profiling.spans()
    calls = [s for s in spans if s.name == "eval.call"]
    assert len(calls) == 2
    causes = [sorted(s.attrs["cause"] for s in spans
                     if s.name == "graphs.capture" and s.root == call.id) for call in calls]
    assert causes == [["eval.draws:new_env", "eval.runner:new_env"], ["eval.draws:new_env"]]
    c = profiling.counters()
    assert c["graphs.captures"] == 3 and c["campaign_env.misses"] == 2
    assert c["campaign_env.evictions"] == 1 and c["eval.calls"] == 2
    assert c["eval_runner.shared"] == c["eval_runner.hits"] == 1


def test_runner_shared_across_scenarios_bit_equal_on_card(dev, spans_on, monkeypatch):
    """A stack flown on stage_2 and then on corridor with the runner
    shared: every result field, `traj` and `angles` equal (`torch.equal`)
    to the same corridor call flown with both caches emptied and its runner
    stepping an env of corridor's own configuration; the corridor call
    captured its draw graph alone, and the runner was shared once."""
    from drone2d_tpu_torch.eval import episode

    profiling = spans_on
    stack = stack_params([flat_dict_to_params(dict(np.load(p)), device=dev) for p in AGENTS])
    stage, corridor = (scenario_config(s).replace(n_steps=200) for s in ("stage_2", "corridor"))
    _empty_eval_caches(monkeypatch)
    episode.run_episodes_multi(stage, stack, 5, 64, device=dev)
    profiling.reset()
    got = episode.run_episodes_multi(corridor, stack, 6, 64, device=dev)
    c = profiling.counters()
    assert c["graphs.captures"] == c["graphs.captures[eval.draws:new_env]"] == 1
    assert c["eval_runner.shared"] == c["eval_runner.hits"] == 1
    _empty_eval_caches(monkeypatch)
    monkeypatch.setattr(episode, "step_config", lambda cfg: cfg)
    want = episode.run_episodes_multi(corridor, stack, 6, 64, device=dev)
    assert episode._EVAL_RUNNERS.entries.popitem()[1].env.cfg.scenario == "corridor"
    assert got.traj.shape == (3, 64, 200, 2)
    for k, g, w in zip(got._fields, got, want):
        assert torch.equal(torch.from_numpy(g), torch.from_numpy(w)), k


# -- the PPO minibatch step as one kernel (ops/ppo_sgd.py) ---------------------


def _sgd_case(dev, hidden, members, shuffle, seed=0, num_minibatches=4, num_envs=64):
    """One epoch of `num_minibatches` steps over a rollout of random tensors
    (8 steps x `num_envs` envs a member; old log-probs that put the ratios
    inside and beyond the clip range), for a population of `members` (None:
    one actor-critic) of width `hidden` -> (learner, params, the rollout's
    (T, S N, ...) tensors, the `_sgd_data` layout, one epoch's shuffle)."""
    cfg = PPOConfig(n_steps=8, num_minibatches=num_minibatches, n_epochs=2, shuffle=shuffle,
                    hidden_sizes=(hidden, hidden))
    learner = PPOLearner(EnvConfig(path_table_n=128), cfg, num_envs, device=dev)
    g = torch.Generator().manual_seed(seed)
    ms = [ActorCritic(27, 2, (hidden, hidden), generator=torch.Generator().manual_seed(seed + i),
                      device=dev) for i in range(members or 1)]
    with torch.no_grad():
        for i, m in enumerate(ms):
            m.log_std.copy_(torch.tensor([-0.4 + 0.05 * i, 0.1]))
            m.vf_out.b.fill_(0.5)
    params = ms[0] if members is None else stack_params(ms)
    T, W = cfg.n_steps, (members or 1) * num_envs
    raw = tuple(x.to(dev) for x in (
        torch.randn(T, W, 27, generator=g), 0.8 * torch.randn(T, W, 2, generator=g),
        -1.0 - 2.0 * torch.rand(T, W, generator=g), 0.3 + 2.0 * torch.randn(T, W, generator=g),
        3.0 * torch.randn(T, W, generator=g)))
    perms = torch.stack([learner.draw_perms(torch.Generator(device=dev).manual_seed(seed + i))
                         for i in range(members or 1)])
    return learner, params, raw, learner._sgd_data(raw, members), \
        perms[0, 0] if members is None else perms[:, 0].contiguous()


def _steps(learner, params, data, perm, steps, fused):
    """`steps` minibatch steps of one epoch on a copy of `params` with a fresh
    Adam: fused (`ppo_sgd_step`) or plain (`plain_sgd_step` on the gathered
    minibatches, on the card) -> (params, optimizer, rows)."""
    from drone2d_tpu_torch.ops import ppo_sgd

    p = copy.deepcopy(params)
    opt = optim.adam(p.parameters(), learner.cfg.learning_rate)
    if fused:
        rows = learner._rows(p.members, epochs=1)[:steps]
        plan = ppo_sgd.ppo_sgd_plan(p, opt, data, perm, learner.cfg, learner.num_envs)
        for k in range(steps):
            ppo_sgd.ppo_sgd_step(plan, k, rows[k])
    else:
        mbs = learner._epoch_minibatches(data, perm, p.members)
        rows = torch.stack([learner.plain_sgd_step(p, opt, mb)
                            for _, mb in zip(range(steps), mbs)])
    torch.cuda.synchronize()
    return p, opt, rows


# |fused - plain| bounds, each over one leaf (or row entry).  The two sum
# each gradient over the minibatch's rows in another order and grouping
# (row blocks of 64 or 128, then their partials, against cuBLAS's tiles),
# which float32 rounds differently: about 1e-7 of the summed terms'
# magnitude, which cancellation can leave at ~1e-5 of the leaf's largest
# element.  The row holds means over the minibatch: the repo's loss bound,
# 1e-5 of max(|v|, 1).  Adam's moments follow their gradients (exp_avg_sq
# as its square).  A weight moves by at most lr a step, and an error d in
# its gradient moves it by lr d / (|g| + eps): the repo's weight budget,
# 1e-3 of lr x steps plus 4 float32 ulps.
SGD_GRAD_TOL, SGD_ROW_TOL, SGD_BUDGET = 1e-4, 1e-5, 1e-3


def _assert_fused_matches_plain(got, want, steps, lr):
    """`got` (params, optimizer, rows or None) against `want` after `steps`
    Adam steps, within the bounds above."""
    (pg, og, rg), (pw, ow, rw) = got, want
    if rg is not None:
        assert bool(((rg - rw).abs() <= SGD_ROW_TOL * rw.abs().clamp(min=1.0)).all())
    budget = SGD_BUDGET * lr * steps
    for (name, a), b in zip(pg.named_parameters(), pw.parameters()):
        sa, sb = og.state[a], ow.state[b]
        assert torch.equal(sa["step"], sb["step"]) and float(sa["step"]) == steps, name
        w = b.detach().double()
        bound = budget + 4 * 2.0**-23 * w.abs()
        assert bool(((a.detach().double() - w).abs() <= bound).all()), name
        for x, y in ((a.grad, b.grad), (sa["exp_avg"], sb["exp_avg"]),
                     (sa["exp_avg_sq"], sb["exp_avg_sq"])):
            assert float((x - y).abs().max()) <= SGD_GRAD_TOL * float(y.abs().max()) + 1e-30, name


@pytest.mark.parametrize("shuffle", ["exact", "timeperm", "affine"])
@pytest.mark.parametrize("members", [None, 1, 8])
@pytest.mark.parametrize("hidden", [64, 128, 256])
def test_fused_sgd_step_matches_plain(dev, hidden, members, shuffle):
    """One fused minibatch step against the plain step on the card from the
    same weights and minibatch: the clipped gradients, weights, Adam's
    moments and step count and the row within the bounds above."""
    learner, params, _, data, perm = _sgd_case(dev, hidden, members, shuffle)
    got = _steps(learner, params, data, perm, 1, True)
    want = _steps(learner, params, data, perm, 1, False)
    _assert_fused_matches_plain(got, want, 1, learner.cfg.learning_rate)


@pytest.mark.parametrize("shuffle", ["exact", "timeperm", "affine"])
@pytest.mark.parametrize("members", [None, 1, 8])
@pytest.mark.parametrize("hidden", [64, 128, 256])
def test_fused_sgd_matches_plain(dev, hidden, members, shuffle):
    """A whole `sgd` (2 epochs of 4 steps) through the kernel against the
    plain steps over the same minibatches: the metrics, and then the
    weights, Adam's moments, step counts and last clipped gradients within
    the bounds above."""
    learner, params, raw, _, _ = _sgd_case(dev, hidden, members, shuffle)
    S = members
    perms = torch.stack([learner.draw_perms(torch.Generator(device=dev).manual_seed(7 + i))
                         for i in range(members or 1)])
    perms = perms[0] if members is None else perms
    batch = RolloutBatch(obs=raw[0], actions=raw[1], log_probs=raw[2], values=raw[4],
                         rewards=raw[4], dones=torch.zeros_like(raw[4], dtype=torch.bool))
    pf = copy.deepcopy(params)
    of = optim.adam(pf.parameters(), learner.cfg.learning_rate)
    state = dataclasses.replace(learner.start(torch.Generator(device=dev).manual_seed(0), pf),
                                optimizer=of)
    metrics = learner.sgd(state, batch, raw[3], raw[4], perms)
    pp = copy.deepcopy(params)
    op = optim.adam(pp.parameters(), learner.cfg.learning_rate)
    rows = torch.stack([learner.plain_sgd_step(pp, op, mb)
                        for mb in learner._minibatches(raw, perms, S)])
    torch.cuda.synchronize()
    want = learner._means(rows)
    for k in want:
        assert bool(((metrics[k] - want[k]).abs()
                     <= SGD_ROW_TOL * want[k].abs().clamp(min=1.0)).all()), k
    steps = learner.cfg.n_epochs * learner.cfg.num_minibatches
    _assert_fused_matches_plain((pf, of, None), (pp, op, rows), steps, learner.cfg.learning_rate)


@pytest.mark.parametrize("hidden, shuffle", [(64, "exact"), (128, "timeperm"),
                                             (256, "affine")])
def test_fused_sgd_steps_match_plain_over_many_row_blocks(dev, hidden, shuffle):
    """Four fused steps of minibatches of 2,048 rows a member (8 steps x
    1,024 envs in 4 minibatches: 16 or 32 row blocks a member-trunk, summed
    through the partials, as at the hunts' shape) against the plain steps:
    within the bounds above."""
    learner, params, _, data, perm = _sgd_case(dev, hidden, 8, shuffle, num_envs=1024)
    got = _steps(learner, params, data, perm, 4, True)
    want = _steps(learner, params, data, perm, 4, False)
    _assert_fused_matches_plain(got, want, 4, learner.cfg.learning_rate)


def test_fused_sgd_reruns_bit_equal(dev):
    """Two fused epochs from the same weights and data: bit-identical
    (no atomics: every sum in a fixed order)."""
    learner, params, _, data, perm = _sgd_case(dev, 128, 8, "timeperm")
    a = _steps(learner, params, data, perm, 4, True)
    b = _steps(learner, params, data, perm, 4, True)
    assert torch.equal(a[2], b[2])
    for x, y in zip(a[0].parameters(), b[0].parameters()):
        assert torch.equal(x, y) and torch.equal(x.grad, y.grad)
    assert all(torch.equal(x, y) for x, y in zip(optim_tensors(a[1]), optim_tensors(b[1])))


@pytest.mark.parametrize("shuffle", ["exact", "timeperm"])
def test_fused_sgd_member_bit_equal_to_it_alone(dev, shuffle):
    """Member 3 of a population of 8 through one fused epoch, against the
    same member alone (its weights, its block of the rollout, its shuffle):
    weights, gradients, Adam's state and rows bit-equal."""
    from drone2d_tpu_torch.models.policy import unstack_params

    learner, params, raw, data, perm = _sgd_case(dev, 64, 8, shuffle)
    got = _steps(learner, params, data, perm, 4, True)
    alone = unstack_params(params)[3]
    mine = tuple(x[:, 3 * 64:4 * 64].contiguous() for x in raw)
    want = _steps(learner, alone, learner._sgd_data(mine, None), perm[3].contiguous(), 4, True)
    assert torch.equal(got[2][..., 3], want[2])
    for (name, a), b in zip(got[0].named_parameters(), want[0].parameters()):
        assert torch.equal(a[3], b) and torch.equal(a.grad[3], b.grad), name
        sa, sb = got[1].state[a], want[1].state[b]
        assert torch.equal(sa["step"], sb["step"]), name
        assert torch.equal(sa["exp_avg"][3], sb["exp_avg"]), name
        assert torch.equal(sa["exp_avg_sq"][3], sb["exp_avg_sq"]), name


@pytest.mark.parametrize("hidden", [(64, 64, 64), (64, 32)])
def test_fused_sgd_refuses_other_architectures(dev, hidden):
    """Depth 3 and unequal widths raise NotImplementedError on the card (the
    plain step is the CPU's alone: no fallback)."""
    cfg = PPOConfig(n_steps=8, num_minibatches=4, n_epochs=1, hidden_sizes=hidden)
    learner = PPOLearner(EnvConfig(path_table_n=128), cfg, 64, device=dev)
    params = ActorCritic(27, 2, hidden, device=dev)
    raw = tuple(torch.zeros(8, 64, *w, device=dev) for w in ((27,), (2,), (), (), ()))
    perm = torch.arange(8 * 64, device=dev)
    with pytest.raises(NotImplementedError):
        learner._epoch(params, optim.adam(params.parameters(), 3e-4),
                       learner._sgd_data(raw, None), perm)


def test_fused_sgd_counts_its_launches_and_steps_under_replay(dev):
    """`update` launches the kernel three times a minibatch step and counts each
    step in `sgd.fused_steps`; `update_jit` counts the same under replay,
    and its capture's warm-up epoch as real launches but not as an update's
    steps."""
    from drone2d_tpu_torch.ops.ppo_sgd import ppo_sgd_step
    from drone2d_tpu_torch.utils import profiling

    learner = PPOLearner(EnvConfig(), PPOConfig(**GRAPH_PPO), 64, device=dev)
    steps = GRAPH_PPO["n_epochs"] * GRAPH_PPO["num_minibatches"]

    def counts():
        return ppo_sgd_step.launches, profiling.counters().get("sgd.fused_steps", 0)

    l0, s0 = counts()
    learner.update(learner.init(0))
    l1, s1 = counts()
    assert (l1 - l0, s1 - s0) == (3 * steps, steps)
    state, _ = learner.update_jit(learner.init(1))
    l2, s2 = counts()
    assert (l2 - l1, s2 - s1) == (3 * (steps + GRAPH_PPO["num_minibatches"]), steps)
    learner.update_jit(state)
    l3, s3 = counts()
    assert (l3 - l2, s3 - s2) == (3 * steps, steps)


def test_checkpoint_after_fused_steps_continues_bit_equal(dev, tmp_path):
    """After a fused epoch, a checkpoint restores on the card the weights
    and Adam's whole state the kernel reads: the next fused epoch from the
    restored state and from the original one bit-equal."""
    learner, params, _, data, perm = _sgd_case(dev, 64, None, "exact")
    p, opt, _ = _steps(learner, params, data, perm, 4, True)
    state = dataclasses.replace(learner.start(torch.Generator(device=dev).manual_seed(0), p),
                                optimizer=opt)
    save_checkpoint(str(tmp_path), state)
    again, _ = restore_checkpoint(str(tmp_path), learner)
    a = learner._epoch(state.params, state.optimizer, data, perm)
    b = learner._epoch(again.params, again.optimizer, data, perm)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    for x, y in zip(state.params.parameters(), again.params.parameters()):
        assert torch.equal(x, y)
    assert all(torch.equal(x, y) for x, y in zip(optim_tensors(state.optimizer),
                                                 optim_tensors(again.optimizer)))

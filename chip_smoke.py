"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `drone2d_tpu_torch/csrc/`, holds each
against its plain PyTorch version on the card, drives the port's main path
(the PPO rollout of the flagship 27-128-128 actor-critic over 4096 curriculum
envs x 128 steps, twice, then GAE), checks that the path launched the
kernels and that its outputs are right, and prints one JSON line of kernel
measurements and, last, one JSON status line.  Any failure raises, so the
exit code is 0 only when every phase passed.  Needs CUDA; imports no JAX.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from drone2d_tpu_torch.config import EnvConfig, PPOConfig
from drone2d_tpu_torch.env.env import Drone2DEnv, _observe, _rewards_and_done
from drone2d_tpu_torch.env.types import select_state
from drone2d_tpu_torch.learn.gae import compute_gae
from drone2d_tpu_torch.learn.ppo import PPOLearner, TrainState
from drone2d_tpu_torch.models.policy import ActorCritic, flat_dict_to_params
from drone2d_tpu_torch.ops import cuda_build, geometry, physics
from drone2d_tpu_torch.ops.fused_policy import fused_sample_action, fused_sample_action_ref

ROOT = Path(__file__).resolve().parent
AGENT = ROOT / "artifacts" / "agent_s8004" / "new_agent.npz"
NUM_ENVS, N_STEPS, HIDDEN = 4096, 128, (128, 128)
START_STEP = 3e6  # curriculum stage 5
# H100 SXM peaks (NVIDIA data sheet, dense): float32 on the CUDA cores,
# fp16 on the tensor cores, HBM3
PEAK_F32_FLOPS, PEAK_F16_FLOPS, PEAK_BYTES = 67e12, 989e12, 3.35e12
TOL = 1e-5


def log(*args):
    print(*args, flush=True)


def scaled_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max(1, max |want|): float32 sums taken in another
    order differ relative to the size of the summed terms, and the flagship
    critic sums terms of ~1e3 into values of any size below that."""
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / max(1.0, float(want.abs().max())))


def device_ms(fn, reps: int = 25, inner: int = 20) -> float:
    """Median device time of one call, from CUDA events around `inner`
    back-to-back calls.  A spin kernel keeps the card busy while the host
    enqueues them, so host launch overhead does not show up as device time."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")


def phase_build():
    sources = sorted(p.stem for p in cuda_build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source at once
        results = dict(zip(sources, pool.map(cuda_build.build, sources)))
    log(f"build: {len(sources)} source(s) in {time.perf_counter() - t0:.2f} s")
    for name, r in results.items():
        log(f"  {name}: nvcc {r['seconds']:.2f} s -> {r['path'].relative_to(ROOT)}")
        for line in r["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"    {line.strip()}")


def load_agent(device):
    return flat_dict_to_params(dict(np.load(AGENT)), device=device)


def kernel_work(b: int, h: int, k: int = 27) -> dict:
    """What one call of the fused policy must do at batch b, width h: its
    float32 FLOPs (both trunks and the three head dot products), the FLOPs
    of its matrix products as the kernel runs them on the tensor cores
    (three fp16 MMAs a product), and the bytes it must move (obs, noise and
    weights read once, outputs written once)."""
    n_params = 2 * (k * h + h + h * h + h) + h * 3 + 3 + 2
    products = b * 2 * 2 * (k * h + h * h)
    return {"flops": products + b * 2 * 3 * h, "tc_flops": 3 * products,
            "bytes": 4 * (b * k + b * 2 + n_params + b * 2 + b + b)}


def phase_kernel_vs_plain() -> dict:
    """fused_sample_action against its plain version at the main path's
    shapes (B=4096, H=128, the flagship weights), a ragged batch and the
    other padded widths, then its times at H=128 and at PPOConfig's default
    H=64."""
    dev = torch.device("cuda")
    params = load_agent(dev)
    with torch.no_grad():
        params.log_std.copy_(torch.tensor([-0.3, 0.2]))  # exercises exp/affine
    gen = torch.Generator(device=dev).manual_seed(0)

    def check(p, b, label):
        obs = torch.randn(b, 27, generator=gen, device=dev)
        noise = torch.randn(b, 2, generator=gen, device=dev)
        got = fused_sample_action(p, obs, noise)
        torch.cuda.synchronize()
        with torch.no_grad():
            want = fused_sample_action_ref(p, obs, noise)
        errs = {k: scaled_err(g, w) for k, g, w in zip(("action", "logp", "value"), got, want)}
        abs_err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        log(f"  {label}: max_abs_err {abs_err:.3e}, scaled "
            + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
        bad = {k: v for k, v in errs.items() if v > TOL}
        if bad:
            raise AssertionError(f"fused_sample_action disagrees with plain ({label}): {bad}")
        return obs, noise, abs_err

    log(f"kernel vs plain (tolerance: |d| <= {TOL} * max(1, max |plain|)):")
    obs, noise, abs_err = check(params, NUM_ENVS, f"B={NUM_ENVS} H=128 agent_s8004")
    check(params, 4093, "B=4093 H=128 agent_s8004 (ragged)")
    widths = {h: ActorCritic(27, 2, (h, h), generator=torch.Generator().manual_seed(h),
                             device=dev) for h in (32, 64, 96, 256)}
    for h, p in widths.items():
        check(p, 1000, f"B=1000 H={h}")

    def times(p, o, n, h):
        with torch.no_grad():
            ms = device_ms(lambda: fused_sample_action(p, o, n))
            plain_ms = device_ms(lambda: fused_sample_action_ref(p, o, n))
        w = kernel_work(o.shape[0], h)
        t_ops, t_bytes = w["flops"] / PEAK_F32_FLOPS * 1e3, w["bytes"] / PEAK_BYTES * 1e3
        t_tc = w["tc_flops"] / PEAK_F16_FLOPS * 1e3
        bound = max(t_ops, t_bytes)
        log(f"  time at B={o.shape[0]} H={h}: kernel {ms:.5f} ms, plain {plain_ms:.5f} ms; "
            f"{w['flops'] / 1e6:.1f} MFLOP, {w['bytes'] / 1e6:.3f} MB -> bound {bound:.5f} ms "
            f"({100 * bound / ms:.1f}% of it); fp16 pieces {w['tc_flops'] / 1e6:.1f} MFLOP "
            f"-> bound_tc {t_tc:.5f} ms ({100 * t_tc / ms:.1f}%)")
        return ms, plain_ms, bound, t_ops >= t_bytes, t_tc

    obs64 = torch.randn(NUM_ENVS, 27, generator=gen, device=dev)
    times(widths[64], obs64, noise, 64)  # PPOConfig's default width
    times(params, obs[:32], noise[:32], 128)  # one block: the latency floor
    ms, plain_ms, bound, by_ops, t_tc = times(params, obs, noise, 128)
    log("  library_ms: null (no single PyTorch call computes this function: "
        "two MLP trunks, two heads and the Gaussian sample)")
    return {
        "name": "fused_sample_action",
        "route": "cuda",
        "source": "drone2d_tpu_torch/csrc/fused_policy.cu",
        "replaces": "drone2d_tpu/ops/pallas_policy.py:93",
        "launches": None,
        "max_abs_err": abs_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": "operations" if by_ops else "bytes",
        "bound_tc_ms": t_tc,
        "library_ms": None,
    }


def phase_reference():
    """A short rollout on the card against the same rollout on the CPU (the
    plain versions), from identical inputs: the env ops and the kernel
    agree on a small input."""
    n, t = 256, 4
    out = {}
    env = Drone2DEnv(EnvConfig(), device="cpu")
    gen = torch.Generator().manual_seed(2)
    env_state, obs = env.reset_batch(gen, n, 3e6)  # stage-5 obstacle fields
    tmpl, tmpl_obs = env.reset_batch(gen, n, 3e6)
    noise = torch.randn(t, n, 2, generator=gen)
    for dev in ("cpu", "cuda"):
        learner = PPOLearner(EnvConfig(), PPOConfig(n_steps=t, hidden_sizes=HIDDEN), n,
                             device=dev)
        move = lambda x: _to(x, dev)  # noqa: E731
        s = TrainState(params=load_agent(dev), env_state=move(env_state), obs=move(obs),
                       generator=torch.Generator(), global_step=torch.tensor(3e6, device=dev))
        out[dev] = learner.rollout_from(s, move(tmpl), move(tmpl_obs), move(noise))
    (_, bc, lc, _), (_, bg, lg, _) = out["cpu"], out["cuda"]
    if not torch.equal(bc.dones, bg.dones.cpu()):
        raise AssertionError("dones differ between the card and the CPU")
    errs = {k: scaled_err(getattr(bg, k).cpu(), getattr(bc, k))
            for k in ("obs", "actions", "values", "rewards")}
    errs["last_values"] = scaled_err(lg.cpu(), lc)
    first = {k: scaled_err(getattr(bg, k)[0].cpu(), getattr(bc, k)[0])
             for k in ("actions", "values")}
    log(f"card vs CPU, {n} envs x {t} steps: scaled errors "
        + ", ".join(f"{k} {v:.2e}" for k, v in {**errs, **{f'{k}[0]': v for k, v in first.items()}}.items()))
    # same bounds as tests/test_torch_rollout.py (the JAX package vs the port)
    if max(first.values()) > TOL or max(errs.values()) > 5e-3:
        raise AssertionError(f"card and CPU rollouts disagree: {errs} {first}")


def _to(x, dev):
    if dataclasses.is_dataclass(x):
        return type(x)(**{f.name: _to(getattr(x, f.name), dev) for f in dataclasses.fields(x)})
    return x.to(dev)


def phase_breakdown(learner, state):
    """Host-clock time of each layer of one rollout step at 4096 envs, each
    synchronized, median of 10."""
    cfg, env = learner.env.cfg, learner.env
    es, obs = state.env_state, state.obs
    noise = torch.zeros(NUM_ENVS, 2, device="cuda")
    with torch.no_grad():
        act = state.params.sample_action(obs, noise=noise)[0].clamp(-1, 1)
        f = physics.thrust_forces(act, cfg.force_scale)
        body = physics.step_body(es.body, f[:, 0], f[:, 1], dt=cfg.physics_dt,
                                 gravity_y=cfg.gravity_y, mass=cfg.total_mass,
                                 inertia=cfg.moment_of_inertia, arm=cfg.drone_radius)
        o, _ = _observe(cfg, es.path, es.obstacles, body, es.target, es.la_locked)
        done = torch.zeros(NUM_ENVS, dtype=torch.bool, device="cuda")
        layers = {
            "policy kernel": lambda: state.params.sample_action(obs, noise=noise),
            "physics + collision": lambda: (
                physics.step_body(es.body, f[:, 0], f[:, 1], dt=cfg.physics_dt,
                                  gravity_y=cfg.gravity_y, mass=cfg.total_mass,
                                  inertia=cfg.moment_of_inertia, arm=cfg.drone_radius),
                geometry.any_collision(body.pos, body.angle, cfg.drone_width / 2,
                                       cfg.drone_height / 4, es.obstacles.xy,
                                       es.obstacles.r, es.obstacles.mask)),
            "observe": lambda: _observe(cfg, es.path, es.obstacles, body, es.target,
                                        es.la_locked),
            "reward": lambda: _rewards_and_done(cfg, o, es.obstacles.mask.any(1), done,
                                                es.t + 1),
            "template select": lambda: select_state(done, es, es),
            "whole step": lambda: env.step_batch_template(es, act, es, obs),
        }
        out = {}
        for name, fn in layers.items():
            times = []
            for _ in range(11):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            out[name] = statistics.median(times[1:])
    log("step layers at 4096 envs (host clock, synchronized, median ms): "
        + ", ".join(f"{k} {v:.3f}" for k, v in out.items()))

    # device busy share over three steps, from the profiler's kernel times
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            a = state.params.sample_action(obs, noise=noise)[0]
            env.step_batch_template(es, a.clamp(-1, 1), es, obs)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    device_events = [e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.time_range.elapsed_us() for e in device_events)
    kernels = len(device_events)
    if dev_us > 0:
        log(f"profiler, 3 steps: device busy {dev_us / 1e3:.3f} ms of {wall_us / 1e3:.3f} ms "
            f"wall ({100 * dev_us / wall_us:.1f}%), {kernels / 3:.0f} device ops a step")
        by_name = {}
        for e in device_events:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        log("  top device ops (us a step): "
            + "; ".join(f"{name[:60]} {us / 3:.1f}" for name, us in top))
    else:
        log("profiler, 3 steps: device time not measured (no device events)")


def phase_slice(kernel_row: dict):
    """The port's main path: 2 rollouts of 4096 envs x 128 steps + GAE."""
    ppo = PPOConfig(n_steps=N_STEPS, hidden_sizes=HIDDEN)
    learner = PPOLearner(EnvConfig(), ppo, NUM_ENVS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # the flagship was trained through the whole curriculum: resume it at
    # stage 5, where obstacles end episodes inside two rollouts (a stage-1
    # episode of this agent lasts ~480 steps)
    state = learner.init(0, params=load_agent("cuda"), global_step=START_STEP)
    torch.cuda.synchronize()
    log(f"slice: init {NUM_ENVS} envs at global step {START_STEP:.0f} in "
        f"{time.perf_counter() - t0:.3f} s")

    fused_sample_action.launches = 0
    episodes = 0.0
    for i in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, batch, last_values, stats = learner.rollout(state)
        advantages, returns = compute_gae(batch.rewards, batch.values, batch.dones,
                                          last_values, gamma=ppo.gamma,
                                          gae_lambda=ppo.gae_lambda)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        episodes += float(stats.n_episodes)
        log(f"  rollout {i + 1}: {dt:.3f} s, {NUM_ENVS * N_STEPS / dt:.1f} env_steps_per_s, "
            f"episodes {stats.summary()}")
    launches = fused_sample_action.launches
    log(f"  rollout 2 env_steps_per_s {NUM_ENVS * N_STEPS / dt:.1f} "
        f"({NUM_ENVS} envs x {N_STEPS} steps, rollout + GAE, synchronized)")

    want = 2 * (N_STEPS + 1)
    if launches != want:
        raise AssertionError(f"fused_sample_action launched {launches} times, want {want}")
    shapes = {"obs": (N_STEPS, NUM_ENVS, 27), "rewards": (N_STEPS, NUM_ENVS),
              "values": (N_STEPS, NUM_ENVS)}
    for name, shape in shapes.items():
        t = getattr(batch, name)
        if tuple(t.shape) != shape or not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{name}: shape {tuple(t.shape)} or non-finite values")
    if not (bool(torch.isfinite(advantages).all()) and bool(torch.isfinite(returns).all())):
        raise AssertionError("non-finite advantages or returns")
    if episodes <= 0:
        raise AssertionError("no episode finished in two rollouts")
    log(f"  kernel launches on the main path: {launches}; episodes finished: {episodes:.0f}")
    kernel_row["launches"] = launches

    # the rate is bound by host launch overhead on a shared host: repeat it
    rates = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, batch, last_values, _ = learner.rollout(state)
        compute_gae(batch.rewards, batch.values, batch.dones, last_values,
                    gamma=ppo.gamma, gae_lambda=ppo.gae_lambda)
        torch.cuda.synchronize()
        rates.append(NUM_ENVS * N_STEPS / (time.perf_counter() - t0))
    log(f"  env_steps_per_s over 5 more rollouts: median {statistics.median(rates):.1f}, "
        f"min {min(rates):.1f}, max {max(rates):.1f}")
    return learner, state


def main():
    phase_device()
    phase_build()
    row = phase_kernel_vs_plain()
    phase_reference()
    learner, state = phase_slice(row)
    phase_breakdown(learner, state)
    print(json.dumps({"kernels": [row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

"""Headline benchmark on the card: the port's counterpart of `bench.py`.

    python -m drone2d_tpu_torch.bench [--train | --all] [--shuffle timeperm]
        [--num-envs 4096] [--chunk 256] [--device cpu]

The env line times the training-relevant hot loop at 4096 envs: per
256-step chunk one reset template (`reset_batch`), then each step the policy
sample (`sample_action`, the fused kernel on the card), the clip to [-1, 1]
and the auto-resetting `step_batch_template`, the rewards summed.  The
chunk runs captured (`CapturedChunk`: a CUDA graph of the template and
noise draws, then one of GRAPH_STEPS steps replayed 8 times a chunk), as
`bench.py` jits its chunk, draws included.  `--train`
instead times the full quality-recipe PPO update (`PPOLearner.update_jit`:
rollout + GAE + 10 epochs x 64 minibatches of SGD at 1024 envs x 128
steps, as CUDA graphs), as `train.py` runs it; `--all` prints both, the
train line first.

Stdout carries exactly `bench.py`'s lines, one JSON object a metric:
{"metric", "value", "unit", "vs_baseline"}, `value` being the total steps
over the total seconds of the timed repeats.  The spread (the seconds of
each repeat, min/median/max), the kernel launches and the device ops a step
go to stderr, with the host launches (launch calls: one a kernel eager,
one a graph replayed) a step or an update beside the device ops.  The
kernel is built, the graphs captured, and one chunk or update run, before
the timed window; the host clock is read after `torch.cuda.synchronize()`,
since launches return before the card has run them.  Runs on the CUDA card
unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import torch

from drone2d_tpu_torch.config import EnvConfig, PPOConfig
from drone2d_tpu_torch.device import resolve_device, synchronize
from drone2d_tpu_torch.env.env import ACT_DIM
from drone2d_tpu_torch.env.types import finalize_split, split_state
from drone2d_tpu_torch.learn.gae import compute_gae
from drone2d_tpu_torch.learn.ppo import PPOLearner
from drone2d_tpu_torch.ops.fused_policy import fused_sample_action
from drone2d_tpu_torch.utils import graphs
from drone2d_tpu_torch.utils.profiling import device_window, launch_window

NUM_ENVS = 4096
CHUNK_T = 256          # steps per timed chunk
REPEATS = 8
# the env-steps/s target of BASELINE.json, stated there for a TPU v5e; the
# `vs_baseline` ratio is against it, and it is no figure of the card
BASELINE_TPU_V5E = 1_000_000.0

# the quality-recipe update shape (1024 envs x 128 steps, 64 minibatches x
# 10 epochs = 640 SGD steps per update), shuffle 'timeperm' by default
TRAIN_NUM_ENVS = 1024
TRAIN_PPO = dict(n_steps=128, num_minibatches=64, n_epochs=10)
TRAIN_REPEATS = 5
# env steps under the profiler, for the device ops a step of the eager chunk
OPS_STEPS = 4
# steps of the env line's captured chunk graph: 256 steps at 4096 envs would
# be ~160k graph nodes, slow to capture and instantiate
GRAPH_STEPS = 32


@torch.no_grad()
def chunk_from(params, env, env_state, obs, reset_state, reset_obs, noise, *,
               autoreset: bool = True):
    """The chunk's steps with its reset template and (T, N, 2) noise given:
    each step the policy sample, the clip, and the auto-resetting step
    against the template (`autoreset=False`: the plain `env.step`, no reset
    select).  Returns (env_state, obs, rewards (T, N))."""
    rewards = torch.empty(noise.shape[:2], device=obs.device)
    for t in range(noise.shape[0]):
        action = torch.clamp(params.sample_action(obs, noise=noise[t])[0], -1.0, 1.0)
        out = (env.step_batch_template(env_state, action, reset_state, reset_obs)
               if autoreset else env.step(env_state, action))
        rewards[t] = out.reward
        env_state, obs = out.state, out.obs
    return env_state, obs, rewards


def draw_chunk(env, n: int, gen: torch.Generator, chunk_t: int, device):
    """A bench chunk's draws from `gen`: the reset template at global step
    0 (a zero made on the device, so that a graph can draw it), then the
    (chunk_t, n, 2) noise."""
    reset_state, reset_obs = env.reset_batch(gen, n, torch.zeros((), device=device))
    noise = torch.randn((chunk_t, n, ACT_DIM), generator=gen, device=device)
    return reset_state, reset_obs, noise


def chunk(params, env, env_state, obs, gen: torch.Generator, chunk_t: int, **kw):
    """One bench chunk drawn from `gen`: the reset template at global step 0,
    then the noise; -> (env_state, obs, rewards (T, N))."""
    draws = draw_chunk(env, obs.shape[0], gen, chunk_t, obs.device)
    return chunk_from(params, env, env_state, obs, *draws, **kw)


def graph_steps(chunk_t: int) -> int:
    """The steps of a captured chunk's graph for `chunk_t`-step chunks."""
    return min(GRAPH_STEPS, chunk_t)


class CapturedChunk:
    """`chunk_from` as a CUDA graph of `steps` steps over static buffers (the
    envs and obs carried from replay to replay, the template, `steps` steps
    of noise), replayed T / steps times for a T-step chunk: the kernels of
    `chunk_from`, so the same results.  `autoreset` goes to `chunk_from`.
    On the CPU the graphs' bodies run directly (`utils/graphs.py`).

    Given `gen` and `chunk_t`, a second graph draws a `chunk_t`-step chunk's
    template and noise from `gen` (`draw_chunk`, the graph bound to `gen`)
    into the static buffers, and a call without draws replays it first:
    `chunk(params, env, env_state, obs, gen, chunk_t)` from the same
    generator state, bit for bit.  A call with draws takes them instead.
    Without `gen`, `reset_state` and `reset_obs` give the template's
    shapes; with it, a draw from a copy of `gen` does.

    A subclass records another step by its three hooks: `enter` (a chunk's
    start -> the carry and the template it reads), `run` (the steps over
    them) and `leave` (the carry and template -> (env_state, obs))."""

    def __init__(self, params, env, env_state, obs, reset_state=None, reset_obs=None,
                 steps: int = GRAPH_STEPS, *, gen: torch.Generator | None = None,
                 chunk_t: int | None = None, **kw):
        self.steps, dev, n = steps, obs.device, obs.shape[0]
        if gen is not None:
            if chunk_t is None or chunk_t % steps:
                raise ValueError(f"chunk_t={chunk_t} is no multiple of the graph's {steps} steps")
            twin = torch.Generator(device=gen.device)
            twin.set_state(gen.get_state())
            reset_state, reset_obs = draw_chunk(env, n, twin, 1, dev)[:2]
        carry, template = self.enter(env_state, obs, reset_state, reset_obs)
        self.carry = carry = graphs.clone(carry)
        self.template = template = graphs.clone(template)
        self.noise = noise = torch.zeros((steps, n, ACT_DIM), device=dev)
        run, enter = self.run, self.enter

        def body():
            new, rewards = run(params, env, carry, template, noise, **kw)
            graphs.copy_(carry, new)
            return rewards

        self.graph = graphs.Graph(body, dev)
        self.draw = None
        if gen is not None:
            # a chunk's start, and all its noise, which each step replay
            # reads `steps` steps of
            self.start = start = graphs.clone((env_state, obs))
            self.drawn = drawn = torch.zeros((chunk_t, n, ACT_DIM), device=dev)

            def draw():
                reset_state, reset_obs, noise = draw_chunk(env, n, gen, chunk_t, dev)
                graphs.copy_((carry, template), enter(*start, reset_state, reset_obs))
                drawn.copy_(noise)

            self.draw = graphs.Graph(draw, dev, generators=[gen])
        # every call copies its start into the carry
        graphs.capture([self.graph] if self.draw is None else [self.draw, self.graph])

    @staticmethod
    def enter(env_state, obs, reset_state, reset_obs):
        return (env_state, obs), (reset_state, reset_obs)

    @staticmethod
    def run(params, env, carry, template, noise, **kw):
        env_state, obs, rewards = chunk_from(params, env, *carry, *template, noise, **kw)
        return (env_state, obs), rewards

    @staticmethod
    def leave(carry, template):
        return carry

    def __call__(self, env_state, obs, reset_state=None, reset_obs=None, noise=None):
        """The chunk from (env_state, obs) with its template and (T, N, 2)
        noise, or with no draws given the chunk drawn from the generator
        (the draw graph) -> (env_state, obs, rewards (T, N)), the caller's
        copies."""
        if noise is None:
            if self.draw is None:
                raise ValueError("a chunk made without a generator takes its draws")
            graphs.copy_(self.start, (env_state, obs))
            self.draw()
            noise = self.drawn
        else:
            carry, template = self.enter(env_state, obs, reset_state, reset_obs)
            graphs.copy_((self.carry, self.template), (carry, template))
        T = noise.shape[0]
        if T % self.steps:
            raise ValueError(f"a chunk of {T} steps is no multiple of the graph's {self.steps}")
        rewards = torch.empty(noise.shape[:2], device=obs.device)
        for i in range(0, T, self.steps):
            self.noise.copy_(noise[i:i + self.steps])
            rewards[i:i + self.steps] = self.graph()
        env_state, obs = graphs.clone(self.leave(self.carry, self.template))
        return env_state, obs, rewards


class CapturedSplitChunk(CapturedChunk):
    """`chunk_split_from` as a captured chunk: the split-carry step
    (`Drone2DEnv.step_batch_split`) in the graph, its carry the episodes'
    dynamic leaves, the auto-reset flags and the obs; the template the
    chunk's initial statics and the reset template's two halves, split
    before the first replay and merged (`finalize_split`) after the last,
    as the eager split chunk does once a chunk."""

    @staticmethod
    def enter(env_state, obs, reset_state, reset_obs):
        tmpl_static, tmpl_dyn = split_state(reset_state)
        init_static, dyn = split_state(env_state)
        fresh = torch.zeros(obs.shape[0], dtype=torch.bool, device=obs.device)
        return (dyn, fresh, obs), (init_static, tmpl_static, tmpl_dyn, reset_obs)

    @staticmethod
    @torch.no_grad()
    def run(params, env, carry, template, noise):
        dyn, fresh, obs = carry
        rewards = torch.empty(noise.shape[:2], device=obs.device)
        for t in range(noise.shape[0]):
            action = torch.clamp(params.sample_action(obs, noise=noise[t])[0], -1.0, 1.0)
            dyn, fresh, obs, rewards[t], _, _ = env.step_batch_split(dyn, fresh, action,
                                                                     *template)
        return (dyn, fresh, obs), rewards

    @staticmethod
    def leave(carry, template):
        dyn, fresh, obs = carry
        return finalize_split(template[0], template[1], fresh, dyn), obs


def chunk_split_from(params, env, env_state, obs, reset_state, reset_obs, noise):
    """`chunk_from` through the split-carry step, eagerly: the statics split
    off once, the steps, then `finalize_split` -> (env_state, obs, rewards
    (T, N)), bit-equal to `chunk_from`'s."""
    cls = CapturedSplitChunk
    carry, template = cls.enter(env_state, obs, reset_state, reset_obs)
    carry, rewards = cls.run(params, env, carry, template, noise)
    return (*cls.leave(carry, template), rewards)


def _line(metric: str, rate: float) -> str:
    return json.dumps({"metric": metric, "value": round(rate, 1), "unit": "steps/s",
                       "vs_baseline": round(rate / BASELINE_TPU_V5E, 3)})


def _spread(label: str, seconds, launches: int, ops_a_step, host: str = "") -> str:
    ops = "not measured (no CUDA device)" if ops_a_step is None else f"{ops_a_step:.1f}"
    return (f"{label}: seconds {[round(s, 6) for s in seconds]}; min {min(seconds):.6f} median "
            f"{statistics.median(seconds):.6f} max {max(seconds):.6f}; kernel launches "
            f"{launches}; device ops a step {ops}{host}")


def _ops_a_step(fn, steps: int, device: torch.device):
    """Device ops a step of fn() (`steps` steps), or None off the card."""
    if device.type != "cuda":
        return None
    events, _, _ = device_window(fn)
    return len(events) / steps


def _launches_a_step(fn, steps: int, device: torch.device):
    """(host launches, device ops) a step of fn() (`steps` steps), or None
    off the card."""
    if device.type != "cuda":
        return None
    events, host, _, _ = launch_window(fn)
    return len(host) / steps, len(events) / steps


def _host_note(measured, unit: str) -> str:
    if measured is None:
        return f"; host launches {unit} not measured (no CUDA device)"
    host, ops = measured
    return f"; captured: host launches {unit} {host:.2f}, device ops {unit} {ops:.1f}"


def time_env(num_envs: int = NUM_ENVS, chunk_t: int = CHUNK_T, repeats: int = REPEATS,
             device=None) -> dict:
    """The env line's measurement: seconds of each of `repeats` captured
    chunks (`CapturedChunk`, its draws made in its draw graph from the
    state's generator) after a warm-up chunk, synchronized; the kernel
    launches in them, in the capture's warm-up (`warmup_launches`) and in
    the whole measurement (`launches_all`); the summed reward of the last
    chunk; the device ops a step of the eager chunk over OPS_STEPS steps,
    and the host launches and device ops a step of one replay of the
    captured graph (OPS_STEPS + GRAPH_STEPS more launches)."""
    dev = resolve_device(device)
    start = fused_sample_action.launches
    learner = PPOLearner(EnvConfig(), PPOConfig(), num_envs, device=dev)
    state = learner.init(0)
    params, env, gen = state.params, learner.env, state.generator
    env_state, obs = state.env_state, state.obs
    before = fused_sample_action.launches
    run = CapturedChunk(params, env, env_state, obs, steps=graph_steps(chunk_t), gen=gen,
                        chunk_t=chunk_t)
    warmup_launches = fused_sample_action.launches - before
    env_state, obs, r = run(env_state, obs)  # warm-up
    float(r.sum())
    seconds, before = [], fused_sample_action.launches
    for _ in range(repeats):
        synchronize(dev)
        t0 = time.perf_counter()
        env_state, obs, r = run(env_state, obs)
        total = float(r.sum())  # the summed reward, on the host: synchronizes
        seconds.append(time.perf_counter() - t0)
    launches = fused_sample_action.launches - before
    # the steps alone: a chunk's template is drawn once for all its steps
    reset_state, reset_obs, noise = draw_chunk(env, num_envs, gen, chunk_t, dev)
    ops = _ops_a_step(lambda: chunk_from(params, env, env_state, obs, reset_state, reset_obs,
                                         noise[:OPS_STEPS]), OPS_STEPS, dev)
    captured = _launches_a_step(lambda: run(env_state, obs, reset_state, reset_obs,
                                            noise[:run.steps]), run.steps, dev)
    return dict(steps=repeats * chunk_t * num_envs, seconds=seconds, launches=launches,
                warmup_launches=warmup_launches,
                launches_all=fused_sample_action.launches - start, reward_sum=total,
                ops_a_step=ops, captured_a_step=captured)


def time_train(shuffle: str = "timeperm", num_envs: int = TRAIN_NUM_ENVS, ppo: dict = TRAIN_PPO,
               repeats: int = TRAIN_REPEATS, device=None) -> dict:
    """The train line's measurement: seconds of each of `repeats`
    `PPOLearner.update_jit` calls after a warm-up one (which captures its
    graphs), synchronized; the kernel launches in them (n_steps + 1 an
    update), in the capture's warm-up (`warmup_launches`) and in the whole
    measurement (`launches_all`); the last loss; the device ops a minibatch
    step over one eager epoch of SGD on one more rollout, and the host
    launches and device ops of one more `update_jit` (2 (n_steps + 1) more
    launches)."""
    dev = resolve_device(device)
    start = fused_sample_action.launches
    cfg = PPOConfig(**ppo, shuffle=shuffle)
    learner = PPOLearner(EnvConfig(), cfg, num_envs, device=dev)
    state = learner.init(0)
    state, metrics = learner.update_jit(state)  # warm-up, and the capture
    float(metrics["loss"])
    warmup_launches = fused_sample_action.launches - start - (cfg.n_steps + 1)
    seconds, before = [], fused_sample_action.launches
    for _ in range(repeats):
        synchronize(dev)
        t0 = time.perf_counter()
        state, metrics = learner.update_jit(state)
        loss = float(metrics["loss"])  # on the host: synchronizes
        seconds.append(time.perf_counter() - t0)
    launches = fused_sample_action.launches - before
    ops = captured = None
    if dev.type == "cuda":
        epoch = PPOLearner(EnvConfig(), cfg.replace(n_epochs=1), num_envs, device=dev)
        state, batch, last_values, _ = epoch.rollout(state)
        adv, ret = compute_gae(batch.rewards, batch.values, batch.dones, last_values,
                               gamma=cfg.gamma, gae_lambda=cfg.gae_lambda)
        perms = epoch.draw_perms(state.generator)
        ops = _ops_a_step(lambda: float(epoch.sgd(state, batch, adv, ret, perms)["loss"]),
                          cfg.num_minibatches, dev)
        captured = _launches_a_step(lambda: float(learner.update_jit(state)[1]["loss"]), 1, dev)
    return dict(steps=repeats * num_envs * cfg.n_steps, seconds=seconds, launches=launches,
                warmup_launches=warmup_launches,
                launches_all=fused_sample_action.launches - start, loss=loss, ops_a_step=ops,
                captured_an_update=captured)


def bench_train(shuffle: str = "timeperm", device=None, **kw) -> dict:
    out = time_train(shuffle, device=device, **kw)
    print(_line("train_steps_per_s", out["steps"] / sum(out["seconds"])), flush=True)
    print(_spread("train_steps_per_s", out["seconds"], out["launches"], out["ops_a_step"],
                  " (a minibatch step, eager)" + _host_note(out["captured_an_update"],
                                                             "an update")),
          file=sys.stderr, flush=True)
    return out


def bench_env(num_envs: int = NUM_ENVS, chunk_t: int = CHUNK_T, device=None, **kw) -> dict:
    out = time_env(num_envs, chunk_t, device=device, **kw)
    print(_line("env_steps_per_s", out["steps"] / sum(out["seconds"])), flush=True)
    print(_spread("env_steps_per_s", out["seconds"], out["launches"], out["ops_a_step"],
                  " (eager)" + _host_note(out["captured_a_step"], "a step")),
          file=sys.stderr, flush=True)
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--train", action="store_true",
                   help="time the full quality-recipe PPO update instead")
    p.add_argument("--shuffle", default="timeperm", choices=["exact", "affine", "timeperm"],
                   help="shuffle mode for --train (default: timeperm)")
    p.add_argument("--all", action="store_true", help="print both lines")
    p.add_argument("--num-envs", type=int, default=NUM_ENVS,
                   help="env batch for the hot-loop line (the headline default is 4096)")
    p.add_argument("--chunk", type=int, default=CHUNK_T,
                   help="steps per timed chunk (default 256)")
    p.add_argument("--device", default=None, choices=("cuda", "cpu"),
                   help="where to run; the default is the CUDA card, and the run fails "
                   "without one ('cpu' runs on the host)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        print(f"device: {torch.cuda.get_device_name(dev)}", file=sys.stderr, flush=True)
    out = {}
    if args.train or args.all:
        out["train"] = bench_train(args.shuffle, device=dev)
        if not args.all:
            return out
    out["env"] = bench_env(args.num_envs, args.chunk, device=dev)
    return out


if __name__ == "__main__":
    main()

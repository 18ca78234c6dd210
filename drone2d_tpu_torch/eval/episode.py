"""Full-episode evaluation rollouts, all episodes as one batch.

Counterpart of `drone2d_tpu/eval/episode.py`.  The reference evaluates one
env at a time (`main.py:259-286`); here the N episodes of a campaign step in
lockstep up to the episode cap, with a done latch: an episode's metrics are
taken at its first done, after which its state and observation freeze
(coast).  Trajectories are recorded as a fixed (N, T, 2) position array per
episode plus the live length; the host converts them to the reference's
screen-coordinate flight_path lists (drone_2d_env.py:984-986).

Three policies: a random one (uniform actions), the deterministic one (the
clipped action mean of `policy_value`) and the stochastic one, SB3's
`model.predict` default: clip(mean + exp(log_std) * noise), which is what
`ActorCritic.sample_action` computes, the fused kernel on the card.
`run_episodes_from` is the deterministic core: it takes the reset states and
the per-step draws, so a test can feed it the JAX package's.

`run_episodes_multi` flies a stack of A agents (an `ActorCritic` with a
leading member axis) over A x n episodes as one batch, one kernel launch a
step for all of them; results have shape (A, n).  `campaign_keys` gives the
generator seeds of a chunked campaign.

`run_episodes` and `run_episodes_multi` draw a campaign's reset batch and
its per-step draws inside a CUDA graph of their own (`_campaign_draws`), as
the JAX runner splits its keys inside `jax.jit`.  They keep one env a
configuration and device, with one generator, across calls
(`_campaign_env`): each call re-seeds that generator on the host, so a
chunked campaign replays the same draw graph and the same runner chunks
from a new seed each chunk, and draws exactly what the eager draws would.

Each call is a root span `eval.call` (`utils/profiling.py`) and adds to the
counters `eval.calls` and `eval.call_s`; inside it the spans `eval.draws`
(the kept env and its draw graph, captured or replayed), `eval.runner`
(the runner, found or captured), `eval.chunks` (the chunk replays and the
host's reads of whether every episode has latched) and `eval.results`
(the copies to the host).  `_campaign_env` counts its hits, misses and
evictions (`campaign_env.*`).

The runner, its chunks captured as CUDA graphs, is kept apart from the
scenario's env (`_chunk_runner`): only the env's constructor and its resets
read the scenario (`RESET_ONLY`), so a runner steps an env of its own made
from the step's configuration, and one runner flies every scenario whose
states have its shapes.  The runner cache counts its hits, misses and
evictions (`eval_runner.*`), and `eval_runner.shared` the hits on a runner
made for another scenario.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import threading
import time
import zlib
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from drone2d_tpu_torch.config import EnvConfig
from drone2d_tpu_torch.env.env import ACT_DIM, OBS_DIM, Drone2DEnv
from drone2d_tpu_torch.env.types import EnvState, cat_states, select_state
from drone2d_tpu_torch.models.policy import ActorCritic
from drone2d_tpu_torch.utils import graphs, profiling

# how many steps run between the checks whether every episode has latched
CHECK_EVERY = 64


class EpisodeResults(NamedTuple):
    """Per-episode campaign results (leading dim = episode), as numpy."""

    success: np.ndarray       # (N,) bool
    fail: np.ndarray          # (N,) bool
    collision: np.ndarray     # (N,) int32 (1 if ended by collision)
    ape: np.ndarray           # (N,) mean distance from path
    time_steps: np.ndarray    # (N,) int32 episode length
    total_reward: np.ndarray  # (N,) return
    traj: np.ndarray          # (N, T, 2) world positions (frozen after done)
    angles: np.ndarray        # (N, T) body angles (for drone replay)
    traj_len: np.ndarray      # (N,) int32 live steps in traj

    def flight_paths(self, screen_h: float):
        """Reference flight_path format: [(x, screen_h - y), ...] per episode
        (drone_2d_env.py:986)."""
        out = []
        for i in range(self.traj.shape[0]):
            n = int(self.traj_len[i])
            out.append(
                [(float(x), float(screen_h - y)) for x, y in self.traj[i, :n]]
            )
        return out


@torch.no_grad()
def run_episodes_from(
    env: Drone2DEnv,
    params: Optional[ActorCritic],
    state: EnvState,
    obs: torch.Tensor,
    draws: Optional[torch.Tensor],
    *,
    deterministic: bool = False,
    captured: bool = True,
) -> EpisodeResults:
    """Run the N episodes that start at (state, obs) to their end.

    `draws` (T, N, 2), T = env.cfg.n_steps, is what each step draws: the
    standard-normal noise of the stochastic policy, or the actions
    themselves when `params` is None (the random policy); the deterministic
    policy takes none (None).  The latch follows `_episode_runner`
    (`drone2d_tpu/eval/episode.py:52-121`): an episode whose reach-end and
    step cap fire on one step latches both success and fail.  The steps
    run in chunks of CHECK_EVERY (the last one shorter when CHECK_EVERY
    does not divide T), each chunk a CUDA graph on the card (the
    counterpart of the JAX runner's jitted scan), and after each chunk the
    loop stops once every episode has latched; the steps it skips would
    only repeat the frozen positions, so the results equal a run to the
    cap.  `captured=False` runs the same chunks eagerly on the card: the
    reference the captured runner is held against, equal bit for bit.

    A stack of A agents (`params.members`) flies N = A x n episodes, agent
    a the n of rows [a n, (a + 1) n), and the results come back shaped
    (A, n, ...).
    """
    with _eval_call():
        return _run_from(env, params, state, obs, draws, deterministic, captured)


def _run_from(env: Drone2DEnv, params: Optional[ActorCritic], state: EnvState,
              obs: torch.Tensor, draws: Optional[torch.Tensor], deterministic: bool,
              captured: bool) -> EpisodeResults:
    """`run_episodes_from`'s work, inside an open eval call."""
    T, N, dev = env.cfg.n_steps, obs.shape[0], obs.device
    lead = (N,) if params is None or params.members is None else (params.members, -1)
    if (params is None or not deterministic) and (
            draws is None or tuple(draws.shape) != (T, N, ACT_DIM)):
        raise ValueError(f"this policy needs draws of shape {(T, N, ACT_DIM)}")
    if params is not None and deterministic:
        draws = None
    with profiling.span("eval.runner"):
        runner = _chunk_runner(env, params, state, obs, draws, captured)
        carry = runner.start(state, obs)
    with profiling.span("eval.chunks"):
        traj = torch.empty((T, N, 2), device=dev)
        angles = torch.empty((T, N), device=dev)
        t = 0
        while t < T:
            n = min(CHECK_EVERY, T - t)
            if draws is not None:
                runner.draws[:n].copy_(draws[t:t + n])
            runner.chunks[n]()
            traj[t:t + n] = runner.traj[:n]
            angles[t:t + n] = runner.angles[:n]
            t += n
            if t < T and bool(carry.done.all()):
                traj[t:] = carry.state.body.pos
                angles[t:] = carry.state.body.angle
                break

    with profiling.span("eval.results"):
        # an episode that hit the cap without a terminal is a timeout fail
        c = carry
        timeout = ~c.done
        fail = c.fail | timeout
        ape = torch.where(timeout, c.state.path_error / T, c.ape)
        time_steps = torch.where(timeout, T, c.time_steps)
        total_reward = torch.where(timeout, c.state.total_reward, c.total_reward)

        def host(x):  # (A, n, ...) for a stack of agents
            return x.cpu().numpy().reshape(*lead, *x.shape[1:])

        return EpisodeResults(
            success=host(c.success), fail=host(fail), collision=host(c.collision),
            ape=host(ape), time_steps=host(time_steps), total_reward=host(total_reward),
            traj=host(traj.transpose(0, 1)), angles=host(angles.transpose(0, 1)),
            traj_len=host(c.traj_len),
        )


# whether an eval call is open on this thread (`_eval_call`)
_in_call = threading.local()


@contextlib.contextmanager
def _eval_call():
    """One eval call: the root span `eval.call`, and the counters
    `eval.calls` and `eval.call_s` (always on: a `perf_counter` pair).
    Inside an open call it adds nothing: `run_episodes` and
    `run_episodes_multi` fly their draws through `run_episodes_from`, looked
    up on the module, which callers may wrap."""
    if getattr(_in_call, "open", False):
        yield
        return
    _in_call.open, t0 = True, time.perf_counter()
    try:
        with profiling.span("eval.call") as span:
            yield
            seconds = time.perf_counter() - t0
            span.set(seconds=seconds)
    finally:
        _in_call.open = False
    profiling.count("eval.calls")
    profiling.count("eval.call_s", seconds)


@dataclasses.dataclass
class _Carry:
    """The runner's state between steps: the envs, their observations and
    each episode's latch and first-done metrics."""

    state: EnvState
    obs: torch.Tensor
    done: torch.Tensor          # (N,) bool
    success: torch.Tensor       # (N,) bool
    fail: torch.Tensor          # (N,) bool
    collision: torch.Tensor     # (N,) int32
    ape: torch.Tensor           # (N,)
    time_steps: torch.Tensor    # (N,) int32
    total_reward: torch.Tensor  # (N,)
    traj_len: torch.Tensor      # (N,) int32


def _fresh_carry(state: EnvState, obs: torch.Tensor) -> _Carry:
    N, dev = obs.shape[0], obs.device

    def zeros(dtype=torch.float32):
        return torch.zeros(N, dtype=dtype, device=dev)

    return _Carry(state=state, obs=obs, done=zeros(torch.bool), success=zeros(torch.bool),
                  fail=zeros(torch.bool), collision=zeros(torch.int32), ape=zeros(),
                  time_steps=zeros(torch.int32), total_reward=zeros(),
                  traj_len=zeros(torch.int32))


class _ChunkRunner:
    """`run_episodes_from`'s chunks for one step configuration, policy and
    batch: the env they step (`env`, made from the step's configuration),
    static buffers for the carry, a chunk's draws and its positions and
    angles, and one graph a chunk length (CHECK_EVERY, and T mod
    CHECK_EVERY when it is not 0), captured on the card, called directly on
    the CPU.  `scenario` is the one it was made for."""

    def __init__(self, env: Drone2DEnv, params: Optional[ActorCritic], state: EnvState,
                 obs: torch.Tensor, draws: Optional[torch.Tensor], captured: bool,
                 scenario: str, cause: str):
        T, N, dev = env.cfg.n_steps, obs.shape[0], obs.device
        self.env, self.scenario = env, scenario
        self.carry = graphs.clone(_fresh_carry(state, obs))
        n = min(CHECK_EVERY, T)
        # contiguous: each step's (N, 2) slice feeds the kernel
        self.draws = None if draws is None else graphs.clone(draws[:n])
        self.traj = torch.empty((n, N, 2), device=dev)
        self.angles = torch.empty((n, N), device=dev)
        lead = (N,) if params is None or params.members is None else (params.members, -1)
        self.chunks = {
            steps: graphs.Graph(functools.partial(
                _chunk, env, params, lead, steps, self.carry, self.draws, self.traj,
                self.angles), dev, eager=not captured)
            for steps in sorted({n, T % CHECK_EVERY} - {0}, reverse=True)}
        graphs.capture(list(self.chunks.values()), cause=cause)

    def start(self, state: EnvState, obs: torch.Tensor) -> _Carry:
        """The carry set to a run's start at (state, obs)."""
        graphs.copy_(self.carry, _fresh_carry(state, obs))
        return self.carry


@torch.no_grad()
def _chunk(env, params, lead, steps: int, c: _Carry, draws, traj, angles) -> None:
    """`steps` steps of the runner from the carry `c`, written back into it;
    step k's positions and angles into traj[k] and angles[k]."""
    N = c.obs.shape[0]
    state, obs, done = c.state, c.obs, c.done
    success, fail, collision = c.success, c.fail, c.collision
    ape, time_steps, total_reward = c.ape, c.time_steps, c.total_reward
    for k in range(steps):
        if params is None:
            action = draws[k]
        elif draws is None:
            action = params.deterministic_action(obs.view(*lead, OBS_DIM)).reshape(N, ACT_DIM)
        else:
            action = params.sample_action(obs.view(*lead, OBS_DIM),
                                          noise=draws[k].view(*lead, ACT_DIM))[0]
            action = torch.clamp(action.reshape(N, ACT_DIM), -1.0, 1.0)
        out = env.step(state, action)
        info = out.info
        first = out.done & ~done
        success = success | (first & (info["n_successful_runs"] == 1))
        fail = fail | (first & (info["n_failed_runs"] == 1))
        collision = collision + torch.where(first, info["n_collisions"], 0)
        ape = torch.where(first, info["APE"], ape)
        time_steps = torch.where(first, info["env_steps"], time_steps)
        total_reward = torch.where(first, info["total_reward"], total_reward)
        # freeze the state once done (coast); record the position after the
        # freeze, and the step as live if the episode ran it
        state = select_state(done, out.state, state)
        obs = torch.where(done[:, None], obs, out.obs)
        traj[k] = state.body.pos
        angles[k] = state.body.angle
        c.traj_len += (~done).to(torch.int32)
        done = done | out.done
    graphs.copy_(c, dataclasses.replace(
        c, state=state, obs=obs, done=done, success=success, fail=fail, collision=collision,
        ape=ape, time_steps=time_steps, total_reward=total_reward))


# EnvConfig's fields that only the env's constructor and its resets read
RESET_ONLY = ("mode", "scenario")


def step_config(cfg: EnvConfig) -> EnvConfig:
    """`cfg` with its `RESET_ONLY` fields at EnvConfig's defaults: what
    `Drone2DEnv.step` reads of it, the same for every scenario."""
    return cfg.replace(**{f.name: f.default for f in dataclasses.fields(EnvConfig)
                          if f.name in RESET_ONLY})


# the eval runners, by what their captured chunks depend on (`_chunk_runner`);
# the least recently used is released first, its graphs and pool with it
_EVAL_RUNNERS = graphs.GraphCache(size=2, counter="eval_runner")


def _chunk_runner(env: Drone2DEnv, params: Optional[ActorCritic], state: EnvState,
                  obs: torch.Tensor, draws: Optional[torch.Tensor],
                  captured: bool) -> _ChunkRunner:
    """The runner for `env`'s step, this policy and batch, from the runner
    cache, made (and captured) at its first use.  Its key is what the
    chunks depend on: the step's configuration (`step_config`) and device,
    the policy and the storages of its weights, and the shapes of (state,
    obs, draws); so a runner made for one scenario flies every other one
    whose states have its shapes.  A new runner steps the env of a kept
    runner of its step configuration, or else an env made anew (the
    capture's cause then says `:new_env`)."""
    mode = "random" if params is None else "deterministic" if draws is None else "stochastic"
    step = (step_config(env.cfg), str(env.device))
    key = (step, mode, captured, CHECK_EVERY,
           None if params is None else graphs.storage_key(params.parameters()),
           graphs.signature((state, obs, draws)))
    runner = _EVAL_RUNNERS.get(key)
    if runner is None:
        kin = next((r.env for k, r in _EVAL_RUNNERS.entries.items() if k[0] == step), None)
        runner = _ChunkRunner(Drone2DEnv(step[0], env.device) if kin is None else kin, params,
                              state, obs, draws, captured, env.cfg.scenario,
                              cause="eval.runner" + (":new_env" if kin is None else ""))
        _EVAL_RUNNERS.put(key, runner)
    elif runner.scenario != env.cfg.scenario:
        profiling.count("eval_runner.shared")
    return runner


# the campaigns' envs, by configuration and device, each with its one
# generator and its draw graphs; the least recently used is released first
_CAMPAIGN_ENVS: collections.OrderedDict = collections.OrderedDict()
CAMPAIGN_ENVS = 4


@dataclasses.dataclass
class _CampaignEnv:
    env: Drone2DEnv
    gen: torch.Generator
    draws: graphs.GraphCache


def _campaign_env(cfg: EnvConfig, device) -> _CampaignEnv:
    """The kept env of `cfg` on `device`, with its generator and draw
    graphs, made at its first use."""
    key = (cfg, None if device is None else str(torch.device(device)))
    entry = _CAMPAIGN_ENVS.get(key)
    if entry is None:
        profiling.count("campaign_env.misses")
        env = Drone2DEnv(cfg, device)
        entry = _CampaignEnv(env, torch.Generator(device=env.device), graphs.GraphCache(size=2))
        while len(_CAMPAIGN_ENVS) >= CAMPAIGN_ENVS:
            _CAMPAIGN_ENVS.popitem(last=False)
            profiling.count("campaign_env.evictions")
        _CAMPAIGN_ENVS[key] = entry
    else:
        profiling.count("campaign_env.hits")
    _CAMPAIGN_ENVS.move_to_end(key)
    return entry


@torch.no_grad()
def _episode_draws(env: Drone2DEnv, gen: torch.Generator, n: int, global_step, policy: str,
                   repeat: int = 1):
    """A campaign's start and draws from `gen`: n fresh episodes at
    `global_step`, then the (T, n, 2) draws of `policy` (uniform actions in
    [-1, 1) for "random", standard normals for "stochastic", none for
    "deterministic"); with `repeat` A, the episodes and draws repeated A
    times -> (state, obs, draws)."""
    state, obs = env.reset_batch(gen, n, global_step)
    shape = (env.cfg.n_steps, n, ACT_DIM)
    draws = (2.0 * torch.rand(shape, generator=gen, device=env.device) - 1.0
             if policy == "random" else None if policy == "deterministic"
             else torch.randn(shape, generator=gen, device=env.device))
    if repeat > 1:
        state, obs = cat_states([state] * repeat), obs.repeat(repeat, 1)
        draws = None if draws is None else draws.repeat(1, repeat, 1)
    return state, obs, draws


def _campaign_draws(cfg: EnvConfig, device, seed: int, n: int, global_step: float,
                    policy: str, repeat: int = 1):
    """`_episode_draws` from the kept env's generator seeded with `seed`, as
    a graph bound to that generator (on the card; called directly on the
    CPU), made at the first call for (n, global_step, policy, repeat) ->
    (env, state, obs, draws), the graph's static outputs: the next call's
    draws overwrite them."""
    c = _campaign_env(cfg, device)
    c.gen.manual_seed(int(seed))
    key = (n, float(global_step), policy, repeat)
    graph = c.draws.get(key)
    if graph is None:
        env, gen = c.env, c.gen
        step = torch.full((), float(global_step), dtype=torch.float32, device=env.device)
        graph = graphs.Graph(lambda: _episode_draws(env, gen, n, step, policy, repeat),
                             env.device, generators=[gen])
        # the env's first draw graph: the env was made anew for this call
        graphs.capture([graph],
                       cause="eval.draws" + (":new_env" if c.draws.captures == 0 else ""))
        c.draws.put(key, graph)
    return (c.env, *graph())


def run_episodes(
    cfg: EnvConfig,
    params: Optional[ActorCritic],
    seed: int,
    n_episodes: int,
    *,
    deterministic: bool = False,
    global_step: float = 0.0,
    device=None,
) -> EpisodeResults:
    """Run n_episodes complete episodes under the policy (or random actions
    when params is None), drawn from a generator seeded with `seed` on
    `device` (the card unless device="cpu"): the reset batch, then the
    (T, N, 2) draws, inside the draw graph (`_campaign_draws`).
    `deterministic=False` matches the reference's `model.predict(obs)`
    (SB3's default samples the Gaussian, main.py:263)."""
    policy = ("random" if params is None else "deterministic" if deterministic
              else "stochastic")
    with _eval_call():
        with profiling.span("eval.draws"):
            env, state, obs, draws = _campaign_draws(cfg, device, seed, n_episodes,
                                                     global_step, policy)
        return run_episodes_from(env, params, state, obs, draws, deterministic=deterministic)


def run_episodes_multi(
    cfg: EnvConfig,
    params_stack: ActorCritic,
    seed: int,
    n_episodes: int,
    *,
    deterministic: bool = False,
    global_step: float = 0.0,
    same_episodes: bool = True,
    device=None,
) -> EpisodeResults:
    """Evaluate a stack of A agents (`params_stack`, an ActorCritic whose
    leaves carry a leading agent axis, `models/policy.stack_params`) on
    n_episodes each, as one batch of A x n episodes: one env step and one
    kernel launch a step for all of them.  Results have shape (A, n, ...).

    With `same_episodes` every agent flies the same n episodes with the same
    noise (a paired comparison): a generator seeded with `seed` on `device`
    draws them as `run_episodes` does, and they are repeated A times, so
    agent a's results are `run_episodes(cfg, agent a, seed, n)`'s.  Else the
    generator draws A x n independent episodes and their noise.  The draws
    run inside the draw graph (`_campaign_draws`).  The JAX package's
    counterpart (`drone2d_tpu/eval/episode.py:164-204`) splits threefry
    keys, whose streams differ: only the statistics compare."""
    A = params_stack.members
    n, repeat = (n_episodes, A) if same_episodes else (A * n_episodes, 1)
    with _eval_call():
        with profiling.span("eval.draws"):
            env, state, obs, draws = _campaign_draws(
                cfg, device, seed, n, global_step,
                "deterministic" if deterministic else "stochastic", repeat)
        return run_episodes_from(env, params_stack, state, obs, draws,
                                 deterministic=deterministic)


def campaign_keys(seed: int, scenario: str, n_chunks: int) -> List[int]:
    """The generator seeds of a chunked campaign: chunk c of `scenario`'s
    campaign at `seed` runs from a generator seeded with the c-th of these.

    Each is a deterministic function of (seed, crc32(scenario) % 2**30, c),
    as the JAX package's keys are (`drone2d_tpu/eval/episode.py:207-220`):
    the crc32 tag keeps scenarios' streams apart at one seed and is stable
    across processes (unlike hash()), and more chunks extend a campaign
    without reusing a seed.  Torch's generator is not threefry, so only the
    statistics compare with the JAX package's campaigns."""
    tag = zlib.crc32(scenario.encode()) % (1 << 30)
    words = np.random.SeedSequence([seed, tag]).spawn(n_chunks)
    return [int(w.generate_state(1, np.uint64)[0] >> np.uint64(1)) for w in words]

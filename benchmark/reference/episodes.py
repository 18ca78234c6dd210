# Frozen copy of the plain math of `drone2d_tpu_torch/eval/episode.py` at
# commit 012002a (`_episode_draws`, `_chunk`, the end of `run_episodes_from`),
# without graphs or kernels, and of `scenario_config` of `eval/run.py`.
"""A selection campaign in plain PyTorch, float32: A agents fly the same n
episodes, each episode latched at its first done (`campaign`); and the
latches of given flights worked out again from their positions and angles
(`judge`).

A generator on the device, seeded with the campaign's seed, draws the n
reset episodes and then the (T, n, 2) standard-normal noise, T the episode
cap; every agent flies those episodes with that noise.  A step samples
clip(mean + exp(log_std) * noise, -1, 1), steps the env without auto-reset,
latches success, fail, collision, APE, steps and return at the first done
and then freezes the episode.  An episode still flying at the cap is a
timeout fail.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from benchmark.reference import policy
from benchmark.reference.config import (
    EXTRA_SCENARIOS,
    STAGE_SCENARIOS,
    TEST_SCENARIOS,
    EnvConfig,
)
from benchmark.reference import geometry
from benchmark.reference.env import ACT_DIM, OBS_DIM, Drone2DEnv, _observe, _rewards_and_done
from benchmark.reference.physics import BodyState
from benchmark.reference.types import cat_states, select_state

# the steps between two looks at whether every episode has latched
CHECK_EVERY = 64
# `follow`: the first step it takes a flight's state at (the steps before
# are held against the reference's own flight), the steps the reference
# flies from each state it takes, and the blocks it flies at once
FOLLOW_FROM = 16
FOLLOW_STEPS = 32
FOLLOW_ROWS = 1 << 17


def scenario_config(scenario: str) -> EnvConfig:
    """The eval env of one scenario: a spatial one in test mode, stage_k in
    curriculum mode with the stage forced; every other knob at its default."""
    if scenario in TEST_SCENARIOS + EXTRA_SCENARIOS:
        return EnvConfig(mode="test", scenario=scenario)
    if scenario in STAGE_SCENARIOS:
        return EnvConfig(mode="curriculum", scenario=scenario)
    raise ValueError(f"unknown scenario {scenario!r}")


@torch.no_grad()
def campaign(cfg: EnvConfig, params: Dict[str, torch.Tensor], seed: int, n: int,
             device) -> Dict[str, torch.Tensor]:
    """The A x n episodes of `params` (A agents) on `cfg` from `seed` ->
    {success, fail, collision, ape, time_steps}, each (A, n),
    and `traj`, (A, n, T, 2) positions, and `angles`, (A, n, T), frozen after
    the episode's end (the steps the loop skips once all have latched repeat
    the last), on the host."""
    dev = torch.device(device)
    env = Drone2DEnv(cfg, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    T, A = cfg.n_steps, params["log_std"].shape[0]
    state, obs = env.reset_batch(gen, n, torch.zeros((), device=dev))
    noise = torch.randn((T, n, ACT_DIM), generator=gen, device=dev)
    state, obs = cat_states([state] * A), obs.repeat(A, 1)
    N = A * n

    def zeros(dtype=torch.float32):
        return torch.zeros(N, dtype=dtype, device=dev)

    done, success, fail = zeros(torch.bool), zeros(torch.bool), zeros(torch.bool)
    collision, time_steps = zeros(torch.int32), zeros(torch.int32)
    ape = zeros()
    traj = torch.empty((T, N, 2), device=dev)
    angles = torch.empty((T, N), device=dev)
    for t in range(T):
        action = policy.sample_action(params, obs.view(A, n, OBS_DIM),
                                      noise[t].expand(A, n, ACT_DIM))[0]
        action = torch.clamp(action.reshape(N, ACT_DIM), -1.0, 1.0)
        out = env.step(state, action)
        info = out.info
        first = out.done & ~done
        success = success | (first & (info["n_successful_runs"] == 1))
        fail = fail | (first & (info["n_failed_runs"] == 1))
        collision = collision + torch.where(first, info["n_collisions"], 0)
        ape = torch.where(first, info["APE"], ape)
        time_steps = torch.where(first, info["env_steps"], time_steps)
        state = select_state(done, out.state, state)
        obs = torch.where(done[:, None], obs, out.obs)
        traj[t] = state.body.pos
        angles[t] = state.body.angle
        done = done | out.done
        if (t + 1) % CHECK_EVERY == 0 and bool(done.all()):
            traj[t + 1:] = state.body.pos
            angles[t + 1:] = state.body.angle
            break
    timeout = ~done
    out = dict(
        success=success, fail=fail | timeout, collision=collision,
        ape=torch.where(timeout, state.path_error / T, ape),
        time_steps=torch.where(timeout, T, time_steps))
    out = {k: v.reshape(A, n).cpu() for k, v in out.items()}
    out["traj"] = traj.transpose(0, 1).reshape(A, n, T, 2).cpu()
    out["angles"] = angles.transpose(0, 1).reshape(A, n, T).cpu()
    return out


@torch.no_grad()
def judge(cfg: EnvConfig, seed: int, n: int, traj: torch.Tensor, angles: torch.Tensor,
          device) -> Dict[str, torch.Tensor]:
    """The latches of A x n given flights of the campaign at `seed`: the
    episodes drawn as `campaign` draws them, flown along `traj` (A, n, T, 2)
    positions and `angles` (A, n, T), each step's terminations and path
    distance worked out by the env's own functions from the position and
    angle after it -> {success, fail, collision, ape, time_steps}, each (A, n),
    on the host.  Velocities play no part in a termination."""
    dev = torch.device(device)
    env = Drone2DEnv(cfg, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    A, T = traj.shape[0], traj.shape[2]
    state, _ = env.reset_batch(gen, n, torch.zeros((), device=dev))
    state = cat_states([state] * A)
    N = A * n
    traj = traj.to(dev).reshape(N, T, 2)
    angles = angles.to(dev).reshape(N, T)
    obst = state.obstacles
    has_obstacles = obst.mask.any(dim=1)

    def zeros(dtype=torch.float32):
        return torch.zeros(N, dtype=dtype, device=dev)

    done, success, fail = zeros(torch.bool), zeros(torch.bool), zeros(torch.bool)
    collision, time_steps = zeros(torch.int32), zeros(torch.int32)
    ape, path_error, la_locked = zeros(), zeros(), state.la_locked
    locked = torch.zeros((T, N), dtype=torch.bool, device=dev)
    for t in range(T):
        body = BodyState(pos=traj[:, t], vel=torch.zeros((N, 2), device=dev),
                         angle=angles[:, t], omega=zeros())
        if obst.half_wh is None:
            collided = geometry.any_collision(
                body.pos, body.angle, cfg.drone_width / 2, cfg.drone_height / 4,
                obst.xy, obst.r, obst.mask)
        else:
            collided = geometry.any_collision_mixed(
                body.pos, body.angle, cfg.drone_width / 2, cfg.drone_height / 4,
                obst.xy, obst.r, obst.half_wh, obst.mask)
        t_new = torch.full((N,), t + 1, dtype=torch.int32, device=dev)
        obs, la_locked = _observe(cfg, state.path, obst, body, state.target, la_locked)
        locked[t] = la_locked
        r = _rewards_and_done(cfg, obs, has_obstacles, collided, t_new)
        path_error = path_error + r["dist_from_path"]
        first = r["done"] & ~done
        success = success | (first & r["end2"])
        fail = fail | (first & (r["end1"] | r["end4"] | r["end5"]))
        collision = collision + (first & r["end1"] & ~(r["end2"] | r["end4"] | r["end5"])).to(
            torch.int32)
        ape = torch.where(first, path_error / torch.clamp(t_new.to(torch.float32), min=1.0), ape)
        time_steps = torch.where(first, t_new, time_steps)
        done = done | r["done"]
        if (t + 1) % CHECK_EVERY == 0 and bool(done.all()):
            break
    out = dict(success=success, fail=fail, collision=collision, ape=ape, time_steps=time_steps)
    out = {k: v.reshape(A, n).cpu() for k, v in out.items()}
    out["la_locked"] = locked.transpose(0, 1).reshape(A, n, T).cpu()
    return out


def _take(tree, idx: torch.Tensor):
    """Leaf-wise tree[idx] along the batch axis over a dataclass tree; a None
    leaf stays None."""
    if dataclasses.is_dataclass(tree):
        return type(tree)(**{f.name: _take(getattr(tree, f.name), idx)
                             for f in dataclasses.fields(tree)})
    return None if tree is None else tree[idx]


@torch.no_grad()
def follow(cfg: EnvConfig, params: Dict[str, torch.Tensor], seed: int, n: int,
           flights: Dict[str, torch.Tensor], device) -> torch.Tensor:
    """The given flights of the campaign at `seed` (slot i flies agent
    i mod len(params)), followed over their whole length from their own
    states: from step s = FOLLOW_FROM, FOLLOW_FROM + FOLLOW_STEPS, ... of an
    episode still flying, the state after s steps is taken from the flight
    (position and angle as flown, the velocities that the next step's move
    gives, Chipmunk moving the position with the previous velocity; the
    lookahead lock as `judge` found it), the reference flies FOLLOW_STEPS
    steps from it with the campaign's noise, and each of its positions is
    held against the flight's own while the episode flies.  `flights`: `traj` (A, n, T, 2),
    `angles` (A, n, T), `time_steps` (A, n) and `la_locked` (A, n, T) ->
    (K,) the widest gap, in pixels, of each of the K blocks so followed, on
    the host."""
    dev = torch.device(device)
    env = Drone2DEnv(cfg, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    start, _ = env.reset_batch(gen, n, torch.zeros((), device=dev))
    traj, angles = flights["traj"].to(dev), flights["angles"].to(dev)
    steps, locked = flights["time_steps"].to(dev).long(), flights["la_locked"].to(dev)
    A, T = traj.shape[0], traj.shape[2]
    noise = torch.randn((T, n, ACT_DIM), generator=gen, device=dev)
    n_agents = params["log_std"].shape[0]
    # the blocks: (slot, episode, s) while the episode still flies after s
    # steps; traj[.., k] is the position after step k + 1
    grid = torch.meshgrid(torch.arange(A, device=dev), torch.arange(n, device=dev),
                          torch.arange(FOLLOW_FROM, T, FOLLOW_STEPS, device=dev),
                          indexing="ij")
    a, e, s = (g.reshape(-1) for g in grid)
    live = s < steps[a, e]
    a, e, s = a[live], e[live], s[live]
    dt = cfg.physics_dt
    gaps = []
    for lo in range(0, a.numel(), FOLLOW_ROWS):
        a_, e_, s_ = (x[lo:lo + FOLLOW_ROWS] for x in (a, e, s))
        R = a_.numel()
        body = BodyState(pos=traj[a_, e_, s_ - 1],
                         vel=(traj[a_, e_, s_] - traj[a_, e_, s_ - 1]) / dt,
                         angle=angles[a_, e_, s_ - 1],
                         omega=(angles[a_, e_, s_] - angles[a_, e_, s_ - 1]) / dt)
        fixed = _take(start, e_)
        obs, la_locked = _observe(cfg, fixed.path, fixed.obstacles, body, fixed.target,
                                  locked[a_, e_, s_ - 2])
        zeros = torch.zeros(R, device=dev)
        state = dataclasses.replace(fixed, body=body, t=s_.to(torch.int32), path_error=zeros,
                                    total_reward=zeros, la_locked=la_locked, left_force=zeros,
                                    right_force=zeros)
        # every agent's action on every row, each row's own agent's taken
        agent, row = a_ % n_agents, torch.arange(R, device=dev)
        gap = torch.zeros(R, device=dev)
        for k in range(FOLLOW_STEPS):
            at = torch.clamp(s_ + k, max=T - 1)
            draws = noise[at, e_]
            action = policy.sample_action(params, obs.expand(n_agents, R, OBS_DIM),
                                          draws.expand(n_agents, R, ACT_DIM))[0][agent, row]
            out = env.step(state, torch.clamp(action, -1.0, 1.0))
            state, obs = out.state, out.obs
            d = torch.linalg.vector_norm(state.body.pos - traj[a_, e_, at], dim=-1)
            d = torch.where(torch.isfinite(d), d, torch.inf)
            gap = torch.maximum(gap, torch.where(s_ + k < steps[a_, e_], d, 0.0))
        gaps.append(gap.cpu())
    return torch.cat(gaps) if gaps else torch.zeros(0)

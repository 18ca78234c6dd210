# Frozen copy of the plain math of `drone2d_tpu_torch/learn/ppo.py`,
# `learn/zoo.py`, `learn/gae.py` and `learn/optim.py` at commit 012002a:
# the eager update of a population, without graphs, kernels or collectives.
"""PPO over a population of S seeds, in plain PyTorch, float32.

Each member m has its own generator, seeded with its seed on the device,
and draws from it what the port draws, in the same order: its initial
envs, then every update its reset template (N envs at its curriculum
step), its (T, N, 2) action noise and its shuffles (one a epoch).  Its
weights start as `policy.init_member(seed)` makes them.  An update is the
rollout (the plain policy sample, the clipped action into the
auto-resetting env step), GAE, then n_epochs x num_minibatches steps of the
clipped-surrogate loss, the per-member clip by global norm and Adam
(betas 0.9, 0.999, eps 1e-5).  Adaptive rehearsal is not covered.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import torch

from benchmark.reference import policy
from benchmark.reference.config import EnvConfig, PPOConfig
from benchmark.reference.env import ACT_DIM, OBS_DIM, Drone2DEnv
from benchmark.reference.types import EnvState, cat_states

ADAM_EPS = 1e-5


@dataclasses.dataclass
class Population:
    params: Dict[str, torch.Tensor]   # every leaf (S, ...)
    optimizer: torch.optim.Adam
    env_state: EnvState               # S * N envs, member-major
    obs: torch.Tensor                 # (S * N, 27)
    generators: List[torch.Generator]
    global_step: torch.Tensor         # (S,)


def compute_gae(rewards, values, dones, last_values, *, gamma, gae_lambda):
    """(advantages, returns), both (T, N); the bootstrap is dropped at a done."""
    not_done = 1.0 - dones.to(values.dtype)
    advantages = torch.empty_like(values)
    gae = torch.zeros_like(last_values)
    next_value = last_values
    for t in reversed(range(values.shape[0])):
        nd = not_done[t]
        delta = rewards[t] + gamma * next_value * nd - values[t]
        gae = delta + gamma * gae_lambda * nd * gae
        advantages[t] = gae
        next_value = values[t]
    return advantages, advantages + values


def clip_by_global_norm_(grads, max_norm: float, members: int) -> None:
    """optax.clip_by_global_norm per member, in place: member m's slice of
    every leaf scaled by max_norm / n when its norm n is max_norm or more."""
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g.reshape(members, -1), dim=1) for g in grads]), dim=0)
    keep = norm < max_norm
    div, mul = torch.where(keep, 1.0, norm), torch.where(keep, 1.0, max_norm)
    for g in grads:
        shape = (members,) + (1,) * (g.dim() - 1)
        g.div_(div.view(shape)).mul_(mul.view(shape))


class PopulationPPO:
    def __init__(self, env_cfg: EnvConfig, ppo_cfg: PPOConfig, num_envs: int, device):
        if env_cfg.adaptive_rehearsal:
            raise ValueError("the reference does not cover adaptive rehearsal")
        self.device = torch.device(device)
        self.env = Drone2DEnv(env_cfg, self.device)
        self.cfg = ppo_cfg
        self.num_envs = num_envs
        self.batch_size = ppo_cfg.n_steps * num_envs
        self.minibatch_size = self.batch_size // ppo_cfg.num_minibatches

    def init(self, seeds: Sequence[int]) -> Population:
        dev, N = self.device, self.num_envs
        members, states, obs, gens = [], [], [], []
        for seed in seeds:
            gen = torch.Generator(device=dev)
            gen.manual_seed(int(seed))
            members.append(policy.init_member(seed, OBS_DIM, ACT_DIM, self.cfg.hidden_sizes))
            s, o = self.env.reset_batch(gen, N, torch.tensor(0.0, device=dev), None)
            states.append(s)
            obs.append(o)
            gens.append(gen)
        params = policy.stack(members, dev)
        opt = torch.optim.Adam(list(params.values()), lr=self.cfg.learning_rate,
                               betas=(0.9, 0.999), eps=ADAM_EPS)
        return Population(params, opt, cat_states(states), torch.cat(obs), gens,
                          torch.zeros(len(seeds), device=dev))

    def _draw_perms(self, gen):
        cfg = self.cfg
        if cfg.shuffle not in ("exact", "timeperm"):
            raise ValueError(f"the reference does not cover shuffle {cfg.shuffle!r}")
        n = cfg.n_steps if cfg.shuffle == "timeperm" else self.batch_size
        return torch.stack([torch.randperm(n, generator=gen, device=self.device)
                            for _ in range(cfg.n_epochs)])

    def _draws(self, pop: Population):
        T, N = self.cfg.n_steps, self.num_envs
        templates, noise, perms = [], [], []
        for m, gen in enumerate(pop.generators):
            templates.append(self.env.reset_batch(gen, N, pop.global_step[m], None))
            noise.append(torch.randn((T, N, ACT_DIM), generator=gen, device=self.device))
            perms.append(self._draw_perms(gen))
        return (cat_states([t for t, _ in templates]), torch.cat([o for _, o in templates]),
                torch.stack(noise, dim=1), torch.stack(perms))

    @torch.no_grad()
    def _rollout(self, pop: Population, reset_state, reset_obs, noise):
        T, S, N = self.cfg.n_steps, len(pop.generators), self.num_envs
        params = {k: v.detach() for k, v in pop.params.items()}
        env_state, obs = pop.env_state, pop.obs
        cols = {k: [] for k in ("obs", "actions", "log_probs", "values", "rewards", "dones")}
        for t in range(T):
            action, log_prob, value = policy.sample_action(
                params, obs.reshape(S, N, OBS_DIM), noise[t])
            action = action.reshape(S * N, ACT_DIM)
            out = self.env.step_batch_template(
                env_state, torch.clamp(action, -1.0, 1.0), reset_state, reset_obs)
            cols["obs"].append(obs)
            cols["actions"].append(action)
            cols["log_probs"].append(log_prob.reshape(S * N))
            cols["values"].append(value.reshape(S * N))
            cols["rewards"].append(out.reward)
            cols["dones"].append(out.done)
            env_state, obs = out.state, out.obs
        _, _, last = policy.sample_action(params, obs.reshape(S, N, OBS_DIM),
                                          torch.zeros((S, N, ACT_DIM), device=obs.device))
        batch = {k: torch.stack(v) for k, v in cols.items()}
        return env_state, obs, batch, last.reshape(-1)

    def _loss(self, params, obs, actions, old_log_probs, advantages, returns):
        cfg = self.cfg
        log_prob, entropy, value = policy.action_log_prob_entropy(params, obs, actions)

        def mean(x, **kw):
            return torch.mean(x, dim=-1, **kw)

        m = mean(advantages, keepdim=True)
        var = mean(torch.square(advantages - m), keepdim=True)
        adv = (advantages - m) / (torch.sqrt(var) + 1e-8)
        ratio = torch.exp(log_prob - old_log_probs)
        pg1 = adv * ratio
        pg2 = adv * torch.clamp(ratio, 1.0 - cfg.clip_range, 1.0 + cfg.clip_range)
        pg_loss = -mean(torch.minimum(pg1, pg2))
        v_loss = mean((returns - value) ** 2)
        return pg_loss + cfg.vf_coef * v_loss - cfg.ent_coef * mean(entropy)

    def _minibatches(self, data, perm, S):
        cfg, M, mb = self.cfg, self.cfg.num_minibatches, self.minibatch_size
        member = torch.arange(S, device=perm.device)[:, None]
        if cfg.shuffle == "timeperm":
            xs = [x[member, perm].reshape(S, M, mb, *x.shape[3:]).movedim(1, 0) for x in data]
            return [tuple(x[k] for x in xs) for k in range(M)]
        idx = perm.view(S, M, mb).movedim(1, 0)
        return [tuple(x[member, idx[k]] for x in data) for k in range(M)]

    def update(self, pop: Population) -> torch.Tensor:
        """One PPO iteration in place on `pop` -> each member's loss averaged
        over the update's minibatch steps, (S,)."""
        cfg, T, S, N = self.cfg, self.cfg.n_steps, len(pop.generators), self.num_envs
        reset_state, reset_obs, noise, perms = self._draws(pop)
        env_state, obs, batch, last = self._rollout(pop, reset_state, reset_obs, noise)
        pop.env_state, pop.obs = env_state, obs
        pop.global_step = pop.global_step + float(T * N)
        advantages, returns = compute_gae(batch["rewards"], batch["values"], batch["dones"],
                                          last, gamma=cfg.gamma, gae_lambda=cfg.gae_lambda)
        data = [x.reshape(T, S, N, *x.shape[2:]).transpose(0, 1) for x in (
            batch["obs"], batch["actions"], batch["log_probs"], advantages, returns)]
        if cfg.shuffle != "timeperm":
            data = [x.flatten(1, 2) for x in data]
        leaves = list(pop.params.values())
        losses = []
        for e in range(cfg.n_epochs):
            for mb in self._minibatches(data, perms[:, e], S):
                loss = self._loss(pop.params, *mb)
                pop.optimizer.zero_grad(set_to_none=True)
                loss.sum().backward()
                clip_by_global_norm_([p.grad for p in leaves], cfg.max_grad_norm, S)
                pop.optimizer.step()
                losses.append(loss.detach())
        return torch.stack(losses).mean(dim=0)

"""PPO over a warm-started population under adaptive rehearsal, in plain
PyTorch, float32: the reference of the fine-tune recipe (`flagship-finetune`).

It is `ppo.PopulationPPO` with three things added, each as the port does it
(`drone2d_tpu_torch/learn/ppo.py`, `learn/zoo.py`):
- every member starts from its own copy of one agent, read from its file
  with numpy (`policy.load_npz`), or, with no agent, from
  `policy.init_member(seed)`;
- every reset, the initial one and each update's template, draws one family
  an env from the rehearsal probabilities through the env's adaptive branch
  (`env.Drone2DEnv._curriculum_reset`, `scenarios.family_from_uniform`),
  in the port's draw order: member by member, its reset template, then its
  action noise and its shuffles.  The probabilities are the initial ones of
  `PPOLearner.initial_rehearsal_probs`: `stage_mix_prob` split over the five
  stages by `stage_mix_weights`, then `corridor_mix_prob` and
  `cross_mix_prob`, and stay fixed (no controller tick);
- each rollout step records every env's family before its step, and the
  finished episodes and wins are counted per member and family.

Departures from the port: the families drawn at each reset are kept
(`drawn`), and every update's shuffles and SGD data (`shuffles`, `fed`),
for the comparison, where the port keeps only the state; the
counts are taken with `torch.bincount` over the rollout's recorded steps,
where the port adds them up in its rollout graph with `index_add_`.  The
controller (`learn/plr.py`) is not covered: the recipe runs with it off.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from benchmark.reference import policy
from benchmark.reference.config import EnvConfig, PPOConfig
from benchmark.reference.env import ACT_DIM, OBS_DIM, Drone2DEnv
from benchmark.reference.ppo import ADAM_EPS, Population, PopulationPPO, clip_by_global_norm_
from benchmark.reference.types import N_FAMILIES, cat_states


def initial_probs(cfg: EnvConfig) -> torch.Tensor:
    """The (7,) rehearsal probabilities a run starts with, float32 on the
    host: stage_1..stage_5, corridor, cross."""
    w = [float(x) for x in cfg.stage_mix_weights]
    stages = [cfg.stage_mix_prob * x / sum(w) for x in w]
    return torch.tensor(stages + [cfg.corridor_mix_prob, cfg.cross_mix_prob],
                        dtype=torch.float32)


class _RecordingEnv(Drone2DEnv):
    """The env, recording of each auto-resetting step every env's family
    before it, whether the step ended its episode, and its success."""

    def __init__(self, cfg: EnvConfig, device):
        super().__init__(cfg, device)
        self.steps = []

    def step_batch_template(self, state, action, reset_state, reset_obs):
        out = super().step_batch_template(state, action, reset_state, reset_obs)
        self.steps.append((state.family, out.done, out.info["n_successful_runs"]))
        return out


class RehearsalPPO(PopulationPPO):
    """`PopulationPPO` under adaptive rehearsal with fixed probabilities.
    `init(seeds)` starts every member from `agent` (an agent file's leaves,
    `policy.load_npz`), or from fresh weights given None.  After
    each update, `family_counts` and `family_wins` (S, 8) hold the finished
    episodes and wins of every member and family so far
    (`types.FAMILY_NAMES`), `drawn` the families of every reset so far,
    (S * N,) each, member-major, `shuffles` every update's (S, n_epochs, n)
    and `fed` every update's SGD data; `sgd_from` steps an update's SGD
    alone, from data it is given (a teacher-forced check)."""

    def __init__(self, env_cfg: EnvConfig, ppo_cfg: PPOConfig, num_envs: int, device,
                 agent: Optional[Dict] = None):
        if not env_cfg.adaptive_rehearsal:
            raise ValueError("RehearsalPPO runs adaptive rehearsal only")
        # the base refuses adaptive rehearsal: it is built on the same knobs
        # without it (and so with an even stage mix), then steps this env
        plain = env_cfg.replace(adaptive_rehearsal=False,
                                stage_mix_weights=(1.0,) * len(env_cfg.stage_mix_weights))
        super().__init__(plain, ppo_cfg, num_envs, device)
        self.env = _RecordingEnv(env_cfg, self.device)
        self.agent = agent
        self.probs = initial_probs(env_cfg).to(self.device)
        self.drawn, self.shuffles, self.fed = [], [], []
        self.family_counts = self.family_wins = None

    def init(self, seeds: Sequence[int]) -> Population:
        dev, N = self.device, self.num_envs
        members, states, obs, gens = [], [], [], []
        for seed in seeds:
            gen = torch.Generator(device=dev)
            gen.manual_seed(int(seed))
            members.append(self.agent if self.agent is not None else
                           policy.init_member(seed, OBS_DIM, ACT_DIM, self.cfg.hidden_sizes))
            s, o = self.env.reset_batch(gen, N, torch.tensor(0.0, device=dev), self.probs)
            states.append(s)
            obs.append(o)
            gens.append(gen)
        params = policy.stack(members, dev)
        opt = torch.optim.Adam(list(params.values()), lr=self.cfg.learning_rate,
                               betas=(0.9, 0.999), eps=ADAM_EPS)
        env_state = cat_states(states)
        self.drawn = [env_state.family]
        zeros = torch.zeros((len(seeds), N_FAMILIES), device=dev)
        self.family_counts, self.family_wins = zeros, zeros.clone()
        return Population(params, opt, env_state, torch.cat(obs), gens,
                          torch.zeros(len(seeds), device=dev))

    def _draws(self, pop: Population):
        T, N = self.cfg.n_steps, self.num_envs
        templates, noise, perms = [], [], []
        for m, gen in enumerate(pop.generators):
            templates.append(self.env.reset_batch(gen, N, pop.global_step[m], self.probs))
            noise.append(torch.randn((T, N, ACT_DIM), generator=gen, device=self.device))
            perms.append(self._draw_perms(gen))
        template = cat_states([t for t, _ in templates])
        self.drawn.append(template.family)
        self.shuffles.append(torch.stack(perms))
        return (template, torch.cat([o for _, o in templates]), torch.stack(noise, dim=1),
                self.shuffles[-1])

    def _minibatches(self, data, perm, S):
        if len(self.fed) < len(self.shuffles):  # an update's first epoch
            self.fed.append(data)
        return super()._minibatches(data, perm, S)

    def sgd_from(self, params: Dict[str, torch.Tensor], data, perms: torch.Tensor):
        """An update's SGD alone, as `update` steps it after GAE: its epochs
        over `data` (laid out as `update` lays it out, as `fed` keeps it)
        with the shuffles `perms` (S, n_epochs, n), on `params` (leaves (S,
        ...), stepped in place) with a fresh Adam.  Returns each member's
        loss averaged over the steps, (S,), and the Adam."""
        cfg, S = self.cfg, perms.shape[0]
        leaves = list(params.values())
        opt = torch.optim.Adam(leaves, lr=cfg.learning_rate, betas=(0.9, 0.999), eps=ADAM_EPS)
        losses = []
        for e in range(cfg.n_epochs):
            for mb in super()._minibatches(data, perms[:, e], S):
                loss = self._loss(params, *mb)
                opt.zero_grad(set_to_none=True)
                loss.sum().backward()
                clip_by_global_norm_([p.grad for p in leaves], cfg.max_grad_norm, S)
                opt.step()
                losses.append(loss.detach())
        return torch.stack(losses).mean(dim=0), opt

    @torch.no_grad()
    def _rollout(self, pop: Population, reset_state, reset_obs, noise):
        self.env.steps = []
        out = super()._rollout(pop, reset_state, reset_obs, noise)
        family, done, wins = (torch.stack(x) for x in zip(*self.env.steps))
        S, N = len(pop.generators), self.num_envs
        owner = torch.arange(S * N, device=self.device) // N
        slot = (family.long() + N_FAMILIES * owner)[done]
        n = S * N_FAMILIES
        self.family_counts = self.family_counts + torch.bincount(slot, minlength=n).view(
            S, N_FAMILIES).to(torch.float32)
        self.family_wins = self.family_wins + torch.bincount(
            slot, weights=wins[done].to(torch.float64), minlength=n).view(
            S, N_FAMILIES).to(torch.float32)
        return out

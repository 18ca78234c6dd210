"""PPO learner: the SB3 `PPO("MlpPolicy")` equivalent.

Counterpart of `drone2d_tpu/learn/ppo.py`.  A rollout steps all envs in
lockstep for `n_steps`: the policy sample (the fused kernel on the card), a
clip of the action to [-1, 1] for the env, and the auto-resetting env step
against a reset template built once per rollout.  An update is a rollout,
GAE, then `n_epochs` x `num_minibatches` steps of the clipped-surrogate loss,
clipped by global norm and applied by Adam (`learn/optim.py`): on the card
each step is one hand-written kernel (`ops/ppo_sgd.py`), on the CPU the
plain loss through `policy_value` with autograd.

Under `adaptive_rehearsal` the state carries the PLR fields: the family
probabilities the reset templates are drawn with, and each family's
finished episodes and wins, counted in the rollout (`learn/plr.py` reweights
the probabilities between updates).

The deterministic cores take what the JAX package draws from its key, so a
test can feed them its draws: `rollout_from` takes the reset template and
the (T, N, 2) standard-normal noise, `learn_from` the minibatch
permutations, and `update_from` all three.  `rollout` and `update` draw them
from the state's generator.  The parameters and the optimizer are updated
in place.

Every step past the draws also takes a population (`learn/zoo.py`): weights
with a leading member axis S (`state.params.members`) over S blocks of
`num_envs` envs, one kernel launch a rollout step for all of them, each
member's minibatches cut from its own rows, its loss, clip and metrics its
own.  A single learner is the case with no member axis.

Where the JAX package takes `axis_name` (inside `shard_map`), `update`,
`update_jit`, `update_from`, `learn_from`, `sgd` and `loss_fn` take
`group`, a `torch.distributed` process group (`parallel/mesh.py`): the
advantage moments, each minibatch's gradients, loss and aux, and the
rollout's episode stats are reduced over the ranks with `all_reduce` (a
mean is the SUM divided by the world size); `update_jit` records them
into its CUDA graphs.  `group=None` runs no collective.
"""

from __future__ import annotations

import dataclasses
import functools
import weakref
from typing import Dict, Tuple

import torch
import torch.distributed as dist

from drone2d_tpu_torch.config import EnvConfig, PPOConfig
from drone2d_tpu_torch.device import resolve_device
from drone2d_tpu_torch.env.env import ACT_DIM, OBS_DIM, Drone2DEnv
from drone2d_tpu_torch.env.types import N_FAMILIES, EnvState
from drone2d_tpu_torch.learn import optim
from drone2d_tpu_torch.learn.gae import compute_gae
from drone2d_tpu_torch.models.policy import ActorCritic
from drone2d_tpu_torch.ops import ppo_sgd
from drone2d_tpu_torch.utils import graphs, profiling
from drone2d_tpu_torch.utils.collectives import all_reduce_grads_, all_reduce_mean_

# Final-step info components averaged over finished episodes
# (tensorboardlogger.py:101-108).
_COMPONENT_KEYS = (
    "reward",
    "collision_reward",
    "collision_avoidance_reward",
    "path_adherence",
    "path_progression",
    "reach_end_reward",
    "agressive_alpha_reward",
)
_STAT_KEYS = (
    "env_steps", "total_reward", "APE", "n_successful_runs", "n_failed_runs",
    "n_collisions",
)
# loss_fn's aux values, in the order the update's metrics average them
_AUX_KEYS = ("policy_loss", "value_loss", "entropy", "clip_fraction", "approx_kl")


@dataclasses.dataclass
class EpisodeStats:
    """Sums over the episodes that finished during one rollout.  For a
    population (`learn/zoo.py`) every field has a leading member axis S."""

    n_episodes: torch.Tensor        # () finished episodes
    sum_length: torch.Tensor        # () sum of final env_steps
    sum_total_reward: torch.Tensor  # () sum of episode returns
    sum_ape: torch.Tensor           # () sum of episode APEs
    n_success: torch.Tensor
    n_fail: torch.Tensor
    n_collision: torch.Tensor
    sum_components: torch.Tensor    # (7,) final-step reward components
    # per-rehearsal-family episodes and successes (env.types.FAMILY_NAMES
    # axis); all zero unless EnvConfig.adaptive_rehearsal is on
    family_counts: torch.Tensor     # (8,)
    family_wins: torch.Tensor       # (8,)

    def summary(self) -> Dict[str, torch.Tensor]:
        """Per-episode means, as () tensors on the stats' device."""
        n = torch.clamp(self.n_episodes, min=1.0)
        out = {
            "episodes": self.n_episodes,
            "avg_length": self.sum_length / n,
            "avg_total_reward": self.sum_total_reward / n,
            "avg_APE": self.sum_ape / n,
            "success_rate": self.n_success / n,
            "failure_rate": self.n_fail / n,
            "collision_rate": self.n_collision / n,
        }
        for i, k in enumerate(_COMPONENT_KEYS):
            out[f"avg_{k}"] = self.sum_components[..., i] / n
        return out


def episode_stats(dones: torch.Tensor, infos: Dict[str, torch.Tensor],
                  families: torch.Tensor | None, members: int | None = None) -> EpisodeStats:
    """The EpisodeStats of a rollout's (T, N) dones and final-step infos;
    with `families` (T, N), each env's rehearsal family before its step,
    the per-family counts.  With `members` S the N envs are S members' blocks
    of N / S and every sum is taken per member."""
    T = dones.shape[0]
    d = dones.to(torch.float32)
    f32 = dict(dtype=torch.float32, device=dones.device)
    if members is None:
        total = torch.sum
    else:
        def total(x):  # over the steps and the envs of each member
            return x.reshape(T, members, -1).sum((0, 2))
    S = 1 if members is None else members
    family_counts = torch.zeros(S * N_FAMILIES, **f32)
    family_wins = torch.zeros(S * N_FAMILIES, **f32)
    if families is not None:
        # whole-number sums below 2^24: exact in float32 in any order
        owner = torch.arange(dones.shape[1], device=dones.device) // (dones.shape[1] // S)
        fam = (families.long() + N_FAMILIES * owner).flatten()
        family_counts.index_add_(0, fam, d.flatten())
        family_wins.index_add_(0, fam, (infos["n_successful_runs"] * d).flatten())
    shape = (N_FAMILIES,) if members is None else (members, N_FAMILIES)
    return EpisodeStats(
        n_episodes=total(d),
        sum_length=total(infos["env_steps"] * d),
        sum_total_reward=total(infos["total_reward"] * d),
        sum_ape=total(infos["APE"] * d),
        n_success=total(infos["n_successful_runs"] * d),
        n_fail=total(infos["n_failed_runs"] * d),
        n_collision=total(infos["n_collisions"] * d),
        sum_components=torch.stack([total(infos[k] * d) for k in _COMPONENT_KEYS], dim=-1),
        family_counts=family_counts.view(shape),
        family_wins=family_wins.view(shape),
    )


def sum_stats(stats: EpisodeStats, group) -> EpisodeStats:
    """Each field of `stats` summed over the ranks of `group`, in one
    all_reduce of the fields flattened into one buffer."""
    fields = [getattr(stats, f.name) for f in dataclasses.fields(stats)]
    flat = torch.cat([x.reshape(-1) for x in fields])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    out, at = {}, 0
    for f, x in zip(dataclasses.fields(stats), fields):
        out[f.name] = flat[at:at + x.numel()].view_as(x)
        at += x.numel()
    return EpisodeStats(**out)


@dataclasses.dataclass
class TrainState:
    params: ActorCritic
    optimizer: torch.optim.Adam    # Adam's moments over `params` (learn/optim.py)
    env_state: EnvState            # batched over num_envs
    obs: torch.Tensor              # (N, 27)
    generator: torch.Generator     # reset templates, action noise, permutations
    # float32 env-step counter, advanced once per rollout by n_steps*num_envs
    # (exact in float32 for power-of-two increments), as in the JAX package
    global_step: torch.Tensor      # () float32
    # finished episodes over all updates, summed on the device so that the
    # train loop copies nothing to the host between logged updates
    episodes_total: torch.Tensor   # () float32
    # Adaptive (PLR-lite) rehearsal state, float32 on the device:
    # rehearsal_probs (7,) is each rehearsal family's per-episode
    # probability (stage_1..stage_5, corridor, cross), the data the reset
    # templates are drawn with under EnvConfig.adaptive_rehearsal;
    # family_counts / family_wins (8,) sum finished episodes / successes per
    # family over all updates (axis: env.types.FAMILY_NAMES).  Left out,
    # they are zeros on the state's device.
    rehearsal_probs: torch.Tensor | None = None
    family_counts: torch.Tensor | None = None
    family_wins: torch.Tensor | None = None

    def __post_init__(self):
        for name, n in (("rehearsal_probs", 7), ("family_counts", N_FAMILIES),
                        ("family_wins", N_FAMILIES)):
            if getattr(self, name) is None:
                setattr(self, name, torch.zeros(n, dtype=torch.float32,
                                                device=self.global_step.device))


@dataclasses.dataclass
class RolloutBatch:
    obs: torch.Tensor        # (T, N, 27)
    actions: torch.Tensor    # (T, N, 2) unclipped samples
    log_probs: torch.Tensor  # (T, N)
    values: torch.Tensor     # (T, N)
    rewards: torch.Tensor    # (T, N)
    dones: torch.Tensor      # (T, N) bool


def rollout_buffers(T: int, N: int, device, families: bool, make=torch.zeros):
    """What `collect_steps` fills for T steps of N envs, made by `make`
    (`torch.zeros` or `torch.empty`): the RolloutBatch, the final-step infos
    of `_STAT_KEYS` and `_COMPONENT_KEYS`, and the families (None unless
    `families`)."""
    f32 = dict(dtype=torch.float32, device=device)
    batch = RolloutBatch(
        obs=make((T, N, OBS_DIM), **f32),
        actions=make((T, N, ACT_DIM), **f32),
        log_probs=make((T, N), **f32),
        values=make((T, N), **f32),
        rewards=make((T, N), **f32),
        dones=make((T, N), dtype=torch.bool, device=device),
    )
    infos = {k: make((T, N), **f32) for k in _STAT_KEYS + _COMPONENT_KEYS}
    return batch, infos, make((T, N), dtype=torch.int64, device=device) if families else None


@torch.no_grad()
def collect_steps(params: ActorCritic, env: Drone2DEnv, env_state: EnvState,
                  obs: torch.Tensor, reset_state: EnvState, reset_obs: torch.Tensor,
                  noise: torch.Tensor):
    """The T steps of a rollout over N envs: the policy sample (one kernel
    launch a step on the card), the clipped action into the auto-resetting
    env step against the template.  `noise` is (T, N, 2), or (T, S, N / S,
    2) for a population `params` of S, whose member m drives envs
    [m N / S, (m + 1) N / S).  Returns (env_state, obs, batch, infos,
    families): the final-step infos of `_STAT_KEYS` and `_COMPONENT_KEYS`
    (T, N), and each env's family before its step (T, N) under adaptive
    rehearsal, else None."""
    T, N = noise.shape[0], obs.shape[0]
    batch, infos, families = rollout_buffers(T, N, obs.device, env.cfg.adaptive_rehearsal,
                                             torch.empty)
    lead = noise.shape[1:-1]  # (N,), or (S, N / S) for a population
    for t in range(T):
        # one launch for every member of a population
        action, log_prob, value = params.sample_action(obs.reshape(*lead, OBS_DIM),
                                                       noise=noise[t])
        action, log_prob, value = action.reshape(N, ACT_DIM), log_prob.reshape(N), value.reshape(N)
        out = env.step_batch_template(
            env_state, torch.clamp(action, -1.0, 1.0), reset_state, reset_obs
        )
        batch.obs[t] = obs
        batch.actions[t] = action
        batch.log_probs[t] = log_prob
        batch.values[t] = value
        batch.rewards[t] = out.reward
        batch.dones[t] = out.done
        for k in infos:
            infos[k][t] = out.info[k]
        if families is not None:
            families[t] = env_state.family
        env_state, obs = out.state, out.obs
    return env_state, obs, batch, infos, families


class PPOLearner:
    """Binds (EnvConfig, PPOConfig, num_envs) to a device (the card unless
    device="cpu").  `update(state)` is one training step: a rollout of
    n_steps, GAE, then epochs x minibatches of SGD."""

    def __init__(self, env_cfg: EnvConfig, ppo_cfg: PPOConfig, num_envs: int,
                 *, device=None, step_increment: int | None = None):
        batch_size = ppo_cfg.n_steps * num_envs
        # the JAX learner's checks and messages (learn/ppo.py:160-182)
        if batch_size % ppo_cfg.num_minibatches:
            raise ValueError(
                f"n_steps*num_envs={batch_size} not divisible by "
                f"num_minibatches={ppo_cfg.num_minibatches}"
            )
        if ppo_cfg.shuffle not in ("exact", "affine", "timeperm"):
            raise ValueError(
                "shuffle must be 'exact', 'affine' or 'timeperm', "
                f"got {ppo_cfg.shuffle!r}"
            )
        if ppo_cfg.shuffle == "affine" and batch_size & (batch_size - 1):
            raise ValueError(
                "shuffle='affine' needs a power-of-two batch (odd multiplier "
                f"bijection); n_steps*num_envs={batch_size}"
            )
        if ppo_cfg.shuffle == "timeperm" and ppo_cfg.n_steps % ppo_cfg.num_minibatches:
            raise ValueError(
                "shuffle='timeperm' slices minibatches as whole timesteps: "
                f"n_steps={ppo_cfg.n_steps} must be divisible by "
                f"num_minibatches={ppo_cfg.num_minibatches}"
            )
        self.device = resolve_device(device)
        self.env = Drone2DEnv(env_cfg, self.device)
        self.cfg = ppo_cfg
        self.num_envs = num_envs
        # global_step's advance an env step: under data parallelism a rank
        # steps num_envs / world envs, but the curriculum clock counts the
        # global batch (drone2d_tpu/learn/ppo.py:151-159)
        self.step_increment = num_envs if step_increment is None else step_increment
        self.batch_size = batch_size
        self.minibatch_size = batch_size // ppo_cfg.num_minibatches
        # update_jit's captured programs
        self._graphs = graphs.GraphCache(size=2)

    # -- construction --------------------------------------------------------

    def initial_rehearsal_probs(self) -> torch.Tensor:
        """Starting family probabilities (7,) on the device: stage_mix_prob
        split across the 5 stages by cfg.stage_mix_weights, then
        corridor_mix_prob and cross_mix_prob (`drone2d_tpu/learn/ppo.py:190-212`)."""
        e = self.env.cfg
        w = [float(x) for x in e.stage_mix_weights]
        if len(w) != 5 or min(w) < 0.0 or sum(w) <= 0.0:
            raise ValueError(
                f"stage_mix_weights must be 5 nonnegative weights with a "
                f"positive sum, got {e.stage_mix_weights}"
            )
        stage_probs = [e.stage_mix_prob * x / sum(w) for x in w]
        if any(abs(x - w[0]) > 1e-9 for x in w) and not e.adaptive_rehearsal:
            raise ValueError(
                "non-uniform stage_mix_weights only take effect through the "
                "adaptive reset path (probabilities as data); set "
                "adaptive_rehearsal=True (with rehearsal_adapt=False for a "
                "fixed weighted mix)"
            )
        return torch.tensor(stage_probs + [e.corridor_mix_prob, e.cross_mix_prob],
                            dtype=torch.float32, device=self.device)

    def _reset_probs(self, probs: torch.Tensor):
        """What `reset_batch` takes as rehearsal_probs: `probs` under
        adaptive rehearsal, else None."""
        return probs if self.env.cfg.adaptive_rehearsal else None

    def init(self, seed: int, params: ActorCritic | None = None,
             global_step: float = 0.0) -> TrainState:
        """Fresh envs, a fresh optimizer and, unless given, fresh weights,
        all from `seed`.  The curriculum clock starts at `global_step` (0 for
        a run from scratch; a trained agent resumes where its curriculum has
        obstacles)."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        if params is None:
            params = ActorCritic(
                OBS_DIM, ACT_DIM, self.cfg.hidden_sizes,
                generator=torch.Generator().manual_seed(seed), device=self.device,
            )
        return self.start(gen, params, global_step)

    def start(self, generator: torch.Generator, params: ActorCritic,
              global_step: float = 0.0, episodes_total: float = 0.0,
              rehearsal_probs: torch.Tensor | None = None,
              env_generator: torch.Generator | None = None) -> TrainState:
        """A state over `params` with a fresh optimizer and envs reset at
        `global_step` from `env_generator` (default: `generator`, the
        state's), with zero family counts.  The rehearsal probabilities
        default to the initial ones."""
        f32 = dict(dtype=torch.float32, device=self.device)
        step = torch.tensor(global_step, **f32)
        probs = (self.initial_rehearsal_probs() if rehearsal_probs is None
                 else rehearsal_probs.to(**f32))
        env_state, obs = self.env.reset_batch(
            generator if env_generator is None else env_generator, self.num_envs, step,
            self._reset_probs(probs))
        return TrainState(
            params=params, optimizer=optim.adam(params.parameters(), self.cfg.learning_rate),
            env_state=env_state, obs=obs, generator=generator, global_step=step,
            episodes_total=torch.tensor(episodes_total, **f32), rehearsal_probs=probs,
        )

    # -- rollout -------------------------------------------------------------

    def rollout(
        self, state: TrainState
    ) -> Tuple[TrainState, RolloutBatch, torch.Tensor, EpisodeStats]:
        """Collect n_steps across all envs under the current policy.

        Returns (state', batch, last_values, episode_stats)."""
        return self.rollout_from(state, *self._rollout_draws(state))

    def _rollout_draws(self, state: TrainState):
        """A rollout's reset template, then its (T, N, 2) action noise, from
        the state's generator."""
        gen = state.generator
        reset_state, reset_obs = self.env.reset_batch(
            gen, self.num_envs, state.global_step, self._reset_probs(state.rehearsal_probs))
        noise = torch.randn(
            (self.cfg.n_steps, self.num_envs, ACT_DIM), generator=gen, device=self.device,
        )
        return reset_state, reset_obs, noise

    @torch.no_grad()
    def rollout_from(
        self,
        state: TrainState,
        reset_state: EnvState,
        reset_obs: torch.Tensor,
        noise: torch.Tensor,
    ) -> Tuple[TrainState, RolloutBatch, torch.Tensor, EpisodeStats]:
        """The rollout with its reset template and noise (T, N, 2) given; a
        population of S takes a template of S * N envs, member-major, and
        noise (T, S, N, 2), and counts its episodes per member.  Under
        adaptive rehearsal it counts finished episodes and wins per family,
        reading each env's family before its step, so that an auto-reset
        does not replace it."""
        self._check_noise(state, noise)
        env_state, obs, batch, last_values, stats = self._rollout_body(
            state.params, state.env_state, state.obs, reset_state, reset_obs, noise)
        return self._advance(state, env_state, obs), batch, last_values, stats

    def _check_noise(self, state, noise: torch.Tensor) -> None:
        T, N, S = self.cfg.n_steps, self.num_envs, state.params.members
        lead = (N,) if S is None else (S, N)
        if tuple(noise.shape) != (T, *lead, ACT_DIM):
            raise ValueError(f"noise has shape {tuple(noise.shape)}, want {(T, *lead, ACT_DIM)}")

    @torch.no_grad()
    def _rollout_body(self, params: ActorCritic, env_state: EnvState, obs: torch.Tensor,
                      reset_state: EnvState, reset_obs: torch.Tensor, noise: torch.Tensor):
        """The rollout's device work, all of it on the device with no host
        sync (`update_jit` captures it): the steps, the episode sums and the
        last values.  Returns (env_state, obs, batch, last_values, stats)."""
        env_state, obs, batch, infos, families = collect_steps(
            params, self.env, env_state, obs, reset_state, reset_obs, noise)
        last_values, stats = self._rollout_end(params, obs, batch, infos, families)
        return env_state, obs, batch, last_values, stats

    @torch.no_grad()
    def _rollout_end(self, params: ActorCritic, obs: torch.Tensor, batch: RolloutBatch,
                     infos, families):
        """A rollout's ending, from `collect_steps`' outputs: the values at
        its last obs and its episode sums -> (last_values, stats)."""
        S = params.members
        lead = (self.num_envs,) if S is None else (S, self.num_envs)
        stats = episode_stats(batch.dones, infos, families, members=S)
        # the kernel's value output with zero noise, so that nothing plain
        # runs on the card's path
        _, _, last_values = params.sample_action(
            obs.view(*lead, OBS_DIM),
            noise=torch.zeros((*lead, ACT_DIM), dtype=torch.float32, device=obs.device))
        return last_values.reshape(-1), stats

    def _advance(self, state, env_state: EnvState, obs: torch.Tensor):
        """`state` after a rollout that ended at (env_state, obs): the step
        counter advanced by the rollout's env steps."""
        # a float32 add of an integer below 2^24, exact: no copy from the host
        return dataclasses.replace(
            state, env_state=env_state, obs=obs,
            global_step=state.global_step + float(self.cfg.n_steps * self.step_increment))

    # -- loss ----------------------------------------------------------------

    def loss_fn(
        self,
        params: ActorCritic,
        obs: torch.Tensor,
        actions: torch.Tensor,
        old_log_probs: torch.Tensor,
        advantages: torch.Tensor,
        returns: torch.Tensor,
        group=None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The clipped-surrogate loss of one minibatch and its aux values
        (`drone2d_tpu/learn/ppo.py:323-371`).  The minibatch is (B, ...); a
        population's is (S, B, ...), each member's loss and aux taken over
        its own B, shaped (S,).  With `group` the minibatch is the union of
        the ranks' equal-sized local minibatches: the advantage moments are
        averaged over the ranks (the mean of the local moments is the
        union's), as the JAX package pmeans them."""
        cfg = self.cfg
        log_prob, entropy, value = params.action_log_prob_entropy(obs, actions)

        def mean(x, **kw):  # over the batch axis
            return torch.mean(x, dim=-1, **kw)

        # per-minibatch advantage normalization (SB3 normalize_advantage),
        # two-pass with the population variance, as the JAX package writes
        # it (torch.std would divide by n - 1); the advantages are data, so
        # no gradient flows through the moments
        m = mean(advantages, keepdim=True)
        if group is not None:
            all_reduce_mean_(m, group)
        var = mean(torch.square(advantages - m), keepdim=True)
        if group is not None:
            all_reduce_mean_(var, group)
        adv = (advantages - m) / (torch.sqrt(var) + 1e-8)

        ratio = torch.exp(log_prob - old_log_probs)
        pg1 = adv * ratio
        pg2 = adv * torch.clamp(ratio, 1.0 - cfg.clip_range, 1.0 + cfg.clip_range)
        pg_loss = -mean(torch.minimum(pg1, pg2))

        v_loss = mean((returns - value) ** 2)
        ent = mean(entropy)
        loss = pg_loss + cfg.vf_coef * v_loss - cfg.ent_coef * ent

        clip_frac = mean(((ratio - 1.0).abs() > cfg.clip_range).to(torch.float32))
        approx_kl = mean(old_log_probs - log_prob)
        aux = dict(
            policy_loss=pg_loss,
            value_loss=v_loss,
            entropy=ent,
            clip_fraction=clip_frac,
            approx_kl=approx_kl,
        )
        return loss, aux

    # -- update --------------------------------------------------------------

    def draw_perms(self, gen: torch.Generator) -> torch.Tensor:
        """One epoch's shuffle a row, drawn from `gen`: (n_epochs, n_steps)
        permutations of the time axis for 'timeperm', else (n_epochs, B)
        permutations of the flat batch: uniform for 'exact', a random affine
        bijection i -> (a*i + b) mod B, a odd, for 'affine'."""
        cfg, dev, B = self.cfg, self.device, self.batch_size
        if cfg.shuffle == "affine":
            a = torch.randint(0, B // 2, (cfg.n_epochs, 1), generator=gen, device=dev) * 2 + 1
            b = torch.randint(0, B, (cfg.n_epochs, 1), generator=gen, device=dev)
            return affine_perm(a, b, B)
        n = cfg.n_steps if cfg.shuffle == "timeperm" else B
        return torch.stack([torch.randperm(n, generator=gen, device=dev)
                            for _ in range(cfg.n_epochs)])

    def sgd(
        self,
        state: TrainState,
        batch: RolloutBatch,
        advantages: torch.Tensor,
        returns: torch.Tensor,
        perms: torch.Tensor,
        group=None,
    ) -> Dict[str, torch.Tensor]:
        """The epochs x minibatches of clipped-surrogate steps, in place on
        `state.params` and `state.optimizer`, with the shuffles `perms` (see
        `draw_perms`; (S, ...) for a population, one row of shuffles a
        member).  Returns the loss and aux values averaged over every
        minibatch, as () tensors on the device, (S,) for a population.
        With `group`, each minibatch's gradients, loss and aux are averaged
        over the ranks after the backward pass, before the clip and Adam, in
        one all_reduce of one flat buffer.  The steps the SGD kernel ran are
        counted in `sgd.fused_steps` (`count_fused_steps`)."""
        cfg, M = self.cfg, self.cfg.num_minibatches
        S = state.params.members
        *lead, n = self.perm_shape(S)
        if tuple(perms.shape) != (*lead, cfg.n_epochs, n):
            raise ValueError(f"perms has shape {tuple(perms.shape)}, "
                             f"want {(*lead, cfg.n_epochs, n)}")
        perms = perms.to(device=self.device, dtype=torch.int64)
        data = self._sgd_data((batch.obs, batch.actions, batch.log_probs, advantages, returns),
                              S)
        rows = self._rows(S)
        launches = ppo_sgd.ppo_sgd_step.launches
        for e in range(cfg.n_epochs):
            rows[e * M:(e + 1) * M] = self._epoch(state.params, state.optimizer, data,
                                                  perms[..., e, :], group=group)
        count_fused_steps(launches, group)
        return self._means(rows)

    def _rows(self, members: int | None, epochs: int | None = None) -> torch.Tensor:
        """(loss, *aux) rows, one a minibatch step, for `epochs` epochs (all
        of an update's by default)."""
        lead = () if members is None else (members,)
        steps = (self.cfg.n_epochs if epochs is None else epochs) * self.cfg.num_minibatches
        return torch.empty((steps, 1 + len(_AUX_KEYS), *lead), dtype=torch.float32,
                           device=self.device)

    @staticmethod
    def _means(rows: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The SGD metrics: every minibatch's (loss, *aux) averaged."""
        means = rows.mean(dim=0)
        return {key: means[i] for i, key in enumerate(("loss",) + _AUX_KEYS)}

    def _epoch(self, params: ActorCritic, opt: torch.optim.Adam, data, perm: torch.Tensor,
               group=None) -> torch.Tensor:
        """One epoch of `sgd` over the prepared `data` (`_sgd_data`) with its
        shuffle `perm` ((n,), or (S, n) for a population), in place on
        `params` and `opt`, with no host sync (`update_jit` captures it,
        with `group`'s collectives too).  Returns its (num_minibatches, 1 +
        aux, ...) rows.

        On the card each minibatch step is the hand-written kernel
        (`ops/ppo_sgd.py`: three launches, the rows read straight from `data`
        by the shuffle), which raises for an architecture it does not take;
        on the CPU it is `plain_sgd_step` on the gathered minibatch."""
        S = params.members
        rows = self._rows(S, epochs=1)
        if data[0].device.type == "cuda":
            plan = ppo_sgd.ppo_sgd_plan(params, opt, data, perm, self.cfg, self.num_envs,
                                        group=group)
            for k in range(self.cfg.num_minibatches):
                ppo_sgd.ppo_sgd_step(plan, k, rows[k])
            return rows
        for k, mb in enumerate(self._epoch_minibatches(data, perm, S)):
            rows[k] = self.plain_sgd_step(params, opt, mb, group=group)
        return rows

    def plain_sgd_step(self, params: ActorCritic, opt: torch.optim.Adam, minibatch,
                       group=None) -> torch.Tensor:
        """The plain minibatch step, the SGD kernel's oracle, on one gathered
        minibatch (obs, actions, old log-probs, advantages, returns), in
        place on `params` and `opt`: `loss_fn`, the gradient (a population's
        members share no weight, so the sum's gradient is each member's
        own), with `group` its average over the ranks, the per-member clip
        and Adam's step.  Returns the (loss, *aux) row, (6,) or (6, S)."""
        leaves = list(params.parameters())
        loss, aux = self.loss_fn(params, *minibatch, group=group)
        opt.zero_grad(set_to_none=True)
        loss.sum().backward()
        row = torch.stack([v.detach() for v in (loss, *map(aux.get, _AUX_KEYS))])
        if group is not None:
            row = all_reduce_grads_(leaves, row, group)
        optim.clip_by_global_norm_([p.grad for p in leaves], self.cfg.max_grad_norm,
                                   members=params.members)
        opt.step()
        return row

    def _sgd_data(self, data, members: int | None):
        """`data`'s (T, N, ...) tensors laid out for `_epoch_minibatches`:
        as they are for 'timeperm', else time-major rows (T * N, ...); for a
        population over (T, S * N), each member's (T, N) block first (S, T,
        N, ...), then (S, T * N, ...) rows (a copy)."""
        if members is not None:
            T, N = self.cfg.n_steps, self.num_envs
            data = [x.reshape(T, members, N, *x.shape[2:]).transpose(0, 1) for x in data]
        if self.cfg.shuffle != "timeperm":
            lead = 0 if members is None else 1
            data = [x.flatten(lead, lead + 1) for x in data]
        return tuple(data)

    def _epoch_minibatches(self, data, perm: torch.Tensor, members: int | None):
        """One epoch's minibatches of `sgd`: each a tuple of the prepared
        `data` (`_sgd_data`) cut to (mb, ...) rows by the shuffle `perm`, or,
        for a population, to (S, mb, ...), member m's rows cut from its own
        block by its own shuffle."""
        cfg, M, mb = self.cfg, self.cfg.num_minibatches, self.minibatch_size
        lead = () if members is None else (members,)
        if members is None:
            def take(x, index):
                return x.index_select(0, index)
        else:
            member = torch.arange(members, device=perm.device)[:, None]

            def take(x, index):
                return x[member, index]
        if cfg.shuffle == "timeperm":
            # permute whole timesteps, then slice: minibatch k holds
            # n_steps/M permuted timesteps x all envs, time-major, as
            # the JAX package's x[perm].reshape((M, mb, ...)) does
            xs = [take(x, perm).reshape(*lead, M, mb, *x.shape[len(lead) + 2:])
                  .movedim(len(lead), 0) for x in data]
            yield from (tuple(x[k] for x in xs) for k in range(M))
        else:
            # gather each minibatch by its indices; a shuffled copy of
            # the batch an epoch would move the same bytes and write more
            idx = perm.view(*lead, M, mb).movedim(len(lead), 0)
            for k in range(M):
                yield tuple(take(x, idx[k]) for x in data)

    def _minibatches(self, data, perms: torch.Tensor, members: int | None):
        """The minibatches of `sgd`, epoch by epoch, from `data`'s (T, N, ...)
        tensors and the shuffles `perms` (`draw_perms`)."""
        data = self._sgd_data(data, members)
        for e in range(self.cfg.n_epochs):
            yield from self._epoch_minibatches(data, perms[..., e, :], members)

    def learn_from(
        self,
        state: TrainState,
        batch: RolloutBatch,
        last_values: torch.Tensor,
        perms: torch.Tensor,
        group=None,
    ) -> Dict[str, torch.Tensor]:
        """GAE over `batch`, then `sgd` with the shuffles `perms` (over
        `group`'s ranks, if given); updates `state.params` and
        `state.optimizer` in place and returns the SGD metrics."""
        advantages, returns = compute_gae(
            batch.rewards, batch.values, batch.dones, last_values,
            gamma=self.cfg.gamma, gae_lambda=self.cfg.gae_lambda,
        )
        return self.sgd(state, batch, advantages, returns, perms, group=group)

    def draws(self, state: TrainState):
        """An update's draws from the state's generator, as `update_from`
        takes them: the rollout's reset template (state, obs) and noise,
        then the shuffles."""
        return (*self._rollout_draws(state), self.draw_perms(state.generator))

    def generators(self, state: TrainState):
        """The generators `draws(state)` draws from."""
        return [state.generator]

    def perm_shape(self, members: int | None) -> tuple:
        """The shape of one epoch's shuffle (a row of `draw_perms`), (S,
        ...) for a population of S."""
        n = self.cfg.n_steps if self.cfg.shuffle == "timeperm" else self.batch_size
        return (n,) if members is None else (members, n)

    def update(self, state: TrainState, *, group=None
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One PPO iteration with the draws made from the state's generator;
        with `group`, one rank's share of a data-parallel iteration (see
        `update_from`)."""
        return self.update_from(state, *self.draws(state), group=group)

    def update_jit(self, state: TrainState, draws=None, *, group=None
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """`update` as compiled programs, the counterpart of the JAX
        package's `update_jit` (`drone2d_tpu/learn/ppo.py:489-491`): on the
        card CUDA graphs (not TorchScript), one of the draws, the rollout
        and GAE, replayed once (for a rollout longer than `ROLLOUT_CHUNK`
        steps: a head of the draws, chunks of the steps and a tail of GAE,
        replayed in turn), and one of an SGD epoch, replayed `n_epochs`
        times.

        With no `draws`, the rollout graph begins with `draws(state)`, in
        its order (the reset template, the noise, every epoch's shuffles),
        from the state's generators, which the graph is bound to; a replay
        draws exactly what `update` draws from the same generator state and
        leaves the generators where `update` leaves them.  The curriculum
        step and the rehearsal probabilities are copied in each call (the
        PLR controller moves the probabilities between updates).  Given
        `draws`, as `draws` returns them, the graphs take those instead (a
        program of its own: the tests inject the JAX package's draws, and
        `parallel.mesh.union_update` replays through it).  The graphs run
        the kernels `update` runs, so the results are bit-equal to
        `update`'s.  The first call for a (weights, optimizer, shapes,
        generators or given draws, group) key captures them (a warm-up run
        of each graph, its device work and draws undone and its kernel
        launches counted, `warmup_launches`, then the recording; a state
        whose weights, optimizer or generators are other objects captures
        anew); the learner keeps the last two.  The returned state and
        metrics are the caller's: no later call writes them.  A failed capture raises; so
        does one while the caller still holds an eager autograd graph over
        these weights (a loss it back-propagated): its gradient
        accumulators stay on the stream they were made on, which a capture
        may not depend on, so drop such a loss first.

        With `group`, one rank's share of a data-parallel update, as
        `update(state, group=...)`: the graphs record its collectives (the
        advantage moments and each minibatch's flat gradient buffer in the
        epoch graph, the episode stats' sum in the rollout graph), as the
        JAX package compiles its `shard_update` with them.  Every rank must
        make the same calls, so that each captures on the same call and
        replays its collectives in the same order as the others; a program
        made with a group never serves a call without one, nor the reverse.
        NCCL's collectives can be recorded; gloo's cannot, so a gloo group
        on the card takes `update(group=...)` (`parallel.mesh.shard_update`
        decides by the backend).

        On the CPU the same bodies run directly over the same static
        buffers, collectives included."""
        key = _UpdateProgram.key(self, state, draws, group)
        program = self._graphs.get(key)
        new = program is None
        if new:
            program = _UpdateProgram(self, state, draws, group)
        env_state, obs, stats, rows = program(state, draws)
        if new:  # keyed once Adam's lazily made state exists
            self._graphs.put(_UpdateProgram.key(self, state, draws, group), program)
        return self._finish(self._advance(state, env_state, obs), stats, self._means(rows))

    def update_data(self, state) -> tuple | None:
        """The SGD data that the last `update_jit(state)` (its weights,
        optimizer and generators) replayed its epochs over, laid out as
        `_sgd_data` lays it out: (obs, actions, log_probs, advantages,
        returns), copies; None if no kept program serves `state`.  It reads
        the program's static buffers, which its next replay overwrites, so
        that a check can step another SGD from the batch the captured
        rollout made."""
        program = self._graphs.entries.get(_UpdateProgram.key(self, state))
        return None if program is None else graphs.clone(program.rollout_graphs[-1].outputs[3])

    def update_from(
        self,
        state: TrainState,
        reset_state: EnvState,
        reset_obs: torch.Tensor,
        noise: torch.Tensor,
        perms: torch.Tensor,
        *,
        group=None,
    ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One PPO iteration with its draws given.  Returns (state',
        metrics): the keys of the JAX package's metrics
        (`learn/ppo.py:468-478`), as () tensors on the device, (S,) for a
        population.  With `group` this rank rolls out its own envs, the SGD
        steps take the union of the ranks' minibatches (`sgd`) and the
        episode stats are summed over the ranks, so that the weights, the
        optimizer, the counters and the metrics come out the same on every
        rank (`drone2d_tpu/learn/ppo.py:376-402, 471-473`)."""
        state, batch, last_values, stats = self.rollout_from(state, reset_state, reset_obs, noise)
        metrics = self.learn_from(state, batch, last_values, perms, group=group)
        if group is not None:
            stats = sum_stats(stats, group)
        return self._finish(state, stats, metrics)

    @staticmethod
    def _finish(state, stats: EpisodeStats, metrics: Dict[str, torch.Tensor]):
        """(state', metrics) of an update from the state after its rollout,
        the rollout's episode stats and the SGD metrics: the episode
        counters and family counts added, the episode means and the
        counters put into the metrics."""
        episodes_total = state.episodes_total + stats.n_episodes
        metrics.update({f"episodes/{k}": v for k, v in stats.summary().items()})
        metrics["episodes/total"] = episodes_total
        metrics["global_step"] = state.global_step
        return dataclasses.replace(
            state, episodes_total=episodes_total,
            family_counts=state.family_counts + stats.family_counts,
            family_wins=state.family_wins + stats.family_wins,
        ), metrics


# `update_jit` records a rollout of up to ROLLOUT_CHUNK steps as one graph,
# unrolled, and a longer one as graphs of ROLLOUT_CHUNK steps (and one of
# the rest) replayed in turn, so that no graph grows with n_steps.  The
# reference's 2048-step rollout of 8 x 14 envs unrolled is one graph of
# 1,357,302 nodes, which took 62.6 s and 12.8 GiB of host memory to capture;
# in chunks of 256 the capture took 9.3 s and an update replayed as fast,
# 3.67 s (scripts/probe_update_capture.py; NVIDIA H100 80GB HBM3, 700.00 W)
ROLLOUT_CHUNK = 256


def rollout_chunks(n_steps: int) -> list:
    """The steps of each rollout graph `update_jit` replays in turn for a
    rollout of `n_steps`: [n_steps] when it is one graph."""
    if n_steps <= ROLLOUT_CHUNK:
        return [n_steps]
    rest = n_steps % ROLLOUT_CHUNK
    return [ROLLOUT_CHUNK] * (n_steps // ROLLOUT_CHUNK) + ([rest] if rest else [])


def warmup_launches(n_steps: int) -> int:
    """The kernel launches of `update_jit`'s capture warm-up: one run of each
    distinct rollout graph's steps, and the last values' launch."""
    return sum(set(rollout_chunks(n_steps))) + 1


class _UpdateProgram:
    """`update_jit`'s captured program for one learner, weights, optimizer,
    shapes, generators (or given draws) and process group (or none): the
    rollout graphs (`rollout_chunks`) and an SGD epoch's graph.  A rollout
    of one chunk is one graph: the draws, the steps, GAE.  A longer one is
    a head (the draws), its chunks and a tail (the last values, the episode
    sums and GAE over the whole rollout): each chunk reads its noise from,
    and writes its steps into, the whole rollout's buffers at a step offset
    on the device that the head zeroes and each chunk advances, and carries
    the envs and obs in the static input buffers.  The tail reads the whole
    buffers as the eager rollout reads its own, so either way a replay runs
    the kernels `update` runs on the same values.

    Static buffers hold the state's envs and obs, and either its curriculum
    step and rehearsal probabilities (the draws made in the graph, from the
    state's generators) or the given draws' template and noise, copied in
    every call; and one epoch's shuffle, copied in before each epoch's
    replay from the rollout's shuffles or the given ones.  The epoch
    graph reads the rollout's batch, advantages and returns where the
    last rollout graph writes them, and updates the weights and Adam's state
    in place, as `update` does.  With a group the last rollout graph ends
    with the episode stats' sum over the ranks and the epoch graph holds each
    minibatch's collectives (`_epoch`).  Every epoch's shuffles are drawn
    with the rollout's draws, as `draws` draws them: 'affine' draws all
    epochs' multipliers in one call and then all offsets, so a draw an
    epoch would draw in another order."""

    def __init__(self, learner: PPOLearner, state, draws=None, group=None):
        params, opt, S = state.params, state.optimizer, state.params.members
        self.drawn = drawn = draws is None
        dev, cfg = learner.device, learner.cfg
        # the learner holds this program: a weak reference back, so that the
        # pair is freed, graphs and all, without waiting for a collection
        learner = weakref.proxy(learner)
        self.learner = learner
        # the bodies close over the buffers, not over this program, so that
        # nothing here is a reference cycle
        if not drawn:
            learner._check_noise(state, draws[2])
        self.inputs = inputs = graphs.clone(self._inputs(state, draws))
        self.perm = perm = torch.empty(learner.perm_shape(S), dtype=torch.int64, device=dev)
        if drawn:
            # the state as `draws` reads it: its generators, the static step
            # and probabilities
            view = dataclasses.replace(state, env_state=inputs[0], obs=inputs[1],
                                       global_step=inputs[2], rehearsal_probs=inputs[3])
            gens = learner.generators(state)
            perm.copy_(torch.arange(perm.shape[-1], device=dev).expand(perm.shape))
        else:
            gens = ()
            perm.copy_(draws[3][..., 0, :])

        def draw():
            """(reset_state, reset_obs, noise, perms): drawn, or the given
            template and noise (their shuffles copied in by the call)."""
            return learner.draws(view) if drawn else (*inputs[2:], None)

        def finish(env_state, obs, batch, last_values, stats, perms):
            if group is not None:
                stats = sum_stats(stats, group)
            advantages, returns = compute_gae(
                batch.rewards, batch.values, batch.dones, last_values,
                gamma=cfg.gamma, gae_lambda=cfg.gae_lambda)
            data = learner._sgd_data(
                (batch.obs, batch.actions, batch.log_probs, advantages, returns), S)
            return env_state, obs, stats, data, perms

        chunks = rollout_chunks(cfg.n_steps)
        if len(chunks) == 1:
            def rollout():
                reset_state, reset_obs, noise, perms = draw()
                env_state, obs, batch, last_values, stats = learner._rollout_body(
                    params, inputs[0], inputs[1], reset_state, reset_obs, noise)
                return finish(env_state, obs, batch, last_values, stats, perms)

            distinct = [graphs.Graph(rollout, dev, generators=gens)]
            self.rollout_graphs = distinct
        else:
            offset = torch.zeros((), dtype=torch.int64, device=dev)
            # zeros, not garbage: the capture's warm-up runs the tail over
            # buffers that only its chunks' steps have written
            whole = rollout_buffers(cfg.n_steps, inputs[1].shape[0], dev,
                                    learner.env.cfg.adaptive_rehearsal)

            def head():
                offset.zero_()
                return draw()

            first = graphs.Graph(head, dev, generators=gens)

            def chunk(k):
                reset_state, reset_obs, noise, _ = first.outputs
                at = offset + torch.arange(k, device=dev)
                env_state, obs, *steps = collect_steps(
                    params, learner.env, inputs[0], inputs[1], reset_state, reset_obs,
                    noise.index_select(0, at))
                for dst, src in zip(graphs.leaves(whole), graphs.leaves(steps)):
                    if dst is not None:
                        dst.index_copy_(0, at, src)
                graphs.copy_(inputs[:2], (env_state, obs))
                offset.add_(k)

            def tail():
                batch, infos, families = whole
                last_values, stats = learner._rollout_end(params, inputs[1], batch, infos,
                                                          families)
                return finish(inputs[0], inputs[1], batch, last_values, stats,
                              first.outputs[3])

            by_steps = {k: graphs.Graph(functools.partial(chunk, k), dev)
                        for k in sorted(set(chunks), reverse=True)}
            self.rollout_graphs = [first, *(by_steps[k] for k in chunks),
                                   graphs.Graph(tail, dev)]
            distinct = [first, *by_steps.values(), self.rollout_graphs[-1]]
        self.chunks = chunks
        last = self.rollout_graphs[-1]
        self.epoch = graphs.Graph(
            lambda: learner._epoch(params, opt, last.outputs[3], perm, group=group), dev)
        self.cuda = torch.device(dev).type == "cuda"
        self.group = group
        self.capture_stats = graphs.capture(
            [*distinct, self.epoch], restore=list(params.parameters()), optimizers=[opt],
            cause="update")

    @staticmethod
    def _inputs(state, draws):
        """What a call copies into the static buffers: the envs and obs, then
        the curriculum step and probabilities, or the given template and
        noise."""
        if draws is None:
            return state.env_state, state.obs, state.global_step, state.rehearsal_probs
        return (state.env_state, state.obs, *draws[:3])

    @staticmethod
    def key(learner: PPOLearner, state, draws=None, group=None) -> tuple:
        """What a program depends on: the storages of the weights and of the
        optimizer's state, the shapes of its inputs, the generators it draws
        from (None: the draws are given) and the process group whose
        collectives it holds (None: none)."""
        return (graphs.storage_key(list(state.params.parameters())
                                   + graphs.optimizer_tensors(state.optimizer)),
                graphs.signature(_UpdateProgram._inputs(state, draws)
                                 + (None if draws is None else draws[3],)),
                None if draws is not None else tuple(learner.generators(state)), group)

    def rollout(self):
        """Replay the rollout graphs in turn -> the last one's outputs (env_state,
        obs, stats, the SGD data, the shuffles or None)."""
        for g in self.rollout_graphs:
            out = g()
        return out

    def __call__(self, state, draws=None):
        """Replay on `state` (with `draws`, if the program takes them): ->
        (env_state, obs, stats, rows), the caller's own copies.  The span
        `update` holds `update.rollout` (the rollout graphs) and
        `update.sgd` (the epoch replays and their shuffles' copies), each
        timed on the device too; the replays' kernel steps are counted in
        `sgd.fused_steps`."""
        learner, M = self.learner, self.learner.cfg.num_minibatches
        with profiling.span("update"):
            graphs.copy_(self.inputs, self._inputs(state, draws))
            with profiling.span("update.rollout", device=self.cuda):
                out = self.rollout()
            env_state, obs, stats = graphs.clone(out[:3])
            perms = out[4] if self.drawn else draws[3]
            rows = learner._rows(state.params.members)
            launches = ppo_sgd.ppo_sgd_step.launches
            with profiling.span("update.sgd", device=self.cuda):
                for e in range(learner.cfg.n_epochs):
                    self.perm.copy_(perms[..., e, :])
                    rows[e * M:(e + 1) * M] = self.epoch()
            count_fused_steps(launches, self.group)
        return env_state, obs, stats, rows


def count_fused_steps(launches: int, group) -> None:
    """Add to the counter `sgd.fused_steps` the minibatch steps the SGD
    kernel ran since its launch count (`ppo_sgd_step.launches`, which a
    replayed graph advances too) read `launches`: none on the CPU."""
    steps = (ppo_sgd.ppo_sgd_step.launches - launches) // ppo_sgd.launches_a_step(group)
    if steps:
        profiling.count("sgd.fused_steps", steps)


def affine_perm(a: torch.Tensor, b: torch.Tensor, n: int) -> torch.Tensor:
    """(a * i + b) mod n for i in 0..n-1, broadcast over a and b.  The JAX
    package computes it in uint32, wrapping at 2^32; int64 gives the same
    values, because n is a power of two that divides 2^32 (so reducing mod
    2^32 first changes nothing mod n) and a*i + b < n^2 + n stays exact."""
    return (a.to(torch.int64) * torch.arange(n, device=a.device) + b.to(torch.int64)) % n

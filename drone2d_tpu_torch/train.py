"""Training driver: the port's counterpart of `drone2d_tpu/train.py` (the
`mode == "train"` path of reference `main.py:149-210`).

    python -m drone2d_tpu_torch.train --preset flagship-scratch

Runs on the CUDA card unless `--device cpu`.  Under torchrun,

    torchrun --nproc_per_node=K -m drone2d_tpu_torch.train --preset flagship-scratch

it trains one learner over K ranks, one card each (`parallel/mesh.py`:
each rank rolls out num_envs / K envs, the gradients are averaged over the
ranks; NCCL on the cards, its collectives inside the update's CUDA graphs,
gloo with `--device cpu`), and rank 0 alone
writes the metrics, the checkpoints and new_agent.npz.  It maps the
reference pipeline as the JAX package does:
  PPO("MlpPolicy", ent_coef=0.01)     -> drone2d_tpu_torch.learn.PPOLearner
  CheckpointCallback(100000//n_cpu)   -> torch.save every checkpoint_every_steps
  TensorboardLogger                   -> MetricsWriter (JSONL + TB)
  curriculum via checkpoint glob      -> global_step carried in TrainState
  model.save('new_agent')             -> final checkpoint + new_agent.npz
The `.npz` keeps the JAX package's flat naming, so either package loads it.
Under `--env-adaptive-rehearsal true --env-rehearsal-adapt true` the PLR
controller (`learn/plr.py`) reweights the rehearsal families on the logging
cadence, e.g. `--preset flagship-finetune --init-params AGENT.npz
--env-rehearsal-adapt true`.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch
import torch.distributed as dist

from drone2d_tpu_torch.config import (
    PRESETS,
    EnvConfig,
    PPOConfig,
    TrainConfig,
    apply_preset,
)
from drone2d_tpu_torch.env.types import FAMILY_NAMES
from drone2d_tpu_torch.eval.run import load_params
from drone2d_tpu_torch.learn.plr import family_report, reweight_rehearsal
from drone2d_tpu_torch.learn.ppo import PPOLearner, TrainState
from drone2d_tpu_torch.models.policy import params_to_flat_dict
from drone2d_tpu_torch.parallel.mesh import (
    captures,
    make_group,
    shard_init,
    shard_restore,
    shard_update,
)
from drone2d_tpu_torch.parallel.multihost import host_info, launched
from drone2d_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint
from drone2d_tpu_torch.utils.metrics import MetricsWriter


def _add_dataclass_args(
    parser: argparse.ArgumentParser, prefix: str, cls, *, suppress: bool = False
) -> None:
    for f in dataclasses.fields(cls):
        if not isinstance(f.default, (int, float, str, bool)):
            continue
        name = f"--{prefix.replace('_', '-')}{f.name.replace('_', '-')}"
        default = argparse.SUPPRESS if suppress else f.default
        if isinstance(f.default, bool):
            parser.add_argument(name, type=lambda s: s.lower() in ("1", "true", "yes"),
                                default=default, metavar="BOOL")
        else:
            parser.add_argument(name, type=type(f.default), default=default)


def _collect(args, prefix: str, cls):
    kw = {}
    for f in dataclasses.fields(cls):
        key = f"{prefix}{f.name}"
        if hasattr(args, key):
            kw[f.name] = getattr(args, key)
    return cls(**kw)


def build_parser(*, suppress: bool = False) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    _add_dataclass_args(p, "", TrainConfig, suppress=suppress)
    _add_dataclass_args(p, "env_", EnvConfig, suppress=suppress)
    _add_dataclass_args(p, "ppo_", PPOConfig, suppress=suppress)
    p.add_argument(
        "--preset", default=None, choices=sorted(PRESETS),
        help="published training recipe (config.PRESETS) applied over the "
        "defaults; explicit flags still win — e.g. --preset flagship-scratch",
    )
    p.add_argument("--resume", action="store_true", help="resume from latest checkpoint")
    p.add_argument("--max-updates", type=int, default=0, help="stop after N updates (0 = by timesteps)")
    p.add_argument(
        "--init-params", default=None, metavar="NPZ_OR_CKPT_DIR",
        help="warm-start: initialize policy params from a saved agent (.npz "
        "or the port's checkpoint dir) with a FRESH optimizer, env batch, and "
        "global_step. Unlike --resume, nothing else is restored.",
    )
    p.add_argument(
        "--device", default=None, choices=("cuda", "cpu"),
        help="where to train; the default is the CUDA card, and the run "
        "fails without one ('cpu' runs on the host)",
    )
    return p


def parse_args(argv=None):
    """argv -> (args, train_cfg, env_cfg, ppo_cfg), with `--preset`
    overlaid on the defaults and every flag typed explicitly winning."""
    args = build_parser().parse_args(argv)
    train_cfg = _collect(args, "", TrainConfig)
    env_cfg = _collect(args, "env_", EnvConfig)
    ppo_cfg = _collect(args, "ppo_", PPOConfig)
    if args.preset:
        # keys the user typed explicitly (suppressed-defaults twin parse)
        provided = set(vars(build_parser(suppress=True).parse_known_args(argv)[0]))
        env_cfg, ppo_cfg, train_cfg = apply_preset(
            args.preset, env_cfg, ppo_cfg, train_cfg, provided
        )
    return args, train_cfg, env_cfg, ppo_cfg


def load_agent(path: str, ppo_cfg: PPOConfig, device):
    """Params of an agent `.npz` (the flat naming of either package) or of
    the port's checkpoint directory (its latest `ckpt_<step>.pt`), through
    `eval.run.load_params`, as the JAX package's train CLI loads its own."""
    params = load_params(path, device=device)
    if params is None:
        raise ValueError("a warm start needs an agent, not 'random'")
    hidden = tuple(layer.w.shape[1] for layer in params.pi)
    if hidden != tuple(ppo_cfg.hidden_sizes):
        raise ValueError(f"{path!r} has hidden sizes {hidden}, the run {ppo_cfg.hidden_sizes}")
    return params


def train(
    train_cfg: TrainConfig,
    env_cfg: EnvConfig,
    ppo_cfg: PPOConfig,
    *,
    resume: bool = False,
    max_updates: int = 0,
    init_params: str | None = None,
    device=None,
    group=None,
) -> TrainState:
    """Train until `total_timesteps` (or `max_updates`), then save a
    checkpoint and `new_agent.npz` under `checkpoint_dir`.  Returns the
    final state.  With `group` (`parallel.make_group`) this process is one
    rank of a data-parallel run over `train_cfg.num_envs` envs in all; rank
    0 alone writes and prints."""
    learner = PPOLearner(env_cfg, ppo_cfg, train_cfg.num_envs, device=device)
    if env_cfg.adaptive_rehearsal and float(learner.initial_rehearsal_probs().sum()) <= 0.0:
        raise ValueError(
            "adaptive_rehearsal=True with a zero rehearsal budget is a "
            "silent no-op: the mix knobs define the total budget the "
            "controller redistributes — set stage_mix_prob (and/or "
            "corridor_mix_prob, cross_mix_prob) > 0"
        )
    plr_tick = env_cfg.adaptive_rehearsal and env_cfg.rehearsal_adapt

    lead = group is None or dist.get_rank(group) == 0
    log = print if lead else (lambda *a, **k: None)
    start_step = 0
    if resume:
        if group is None:
            state, start_step = restore_checkpoint(train_cfg.checkpoint_dir, learner)
        else:
            state, start_step = shard_restore(group, learner, train_cfg.checkpoint_dir)
        log(f"resumed from step {start_step}")
    else:
        # a warm start takes the policy only; optimizer, envs and
        # global_step start fresh (a fine-tune, not a resume)
        params = load_agent(init_params, ppo_cfg, learner.device) if init_params else None
        if group is None:
            state = learner.init(train_cfg.seed, params=params)
        else:
            state = shard_init(group, learner, train_cfg.seed, params=params)
        if init_params:
            log(f"warm-started params from {init_params}")
    # the captured update (CUDA graphs on the card), in one process or over
    # the ranks, as the JAX package's train runs one compiled update either
    # way; gloo on the card cannot be captured and runs the eager update
    if group is None:
        update = learner.update_jit
    else:
        update = shard_update(group, learner)
        log(f"data-parallel update over {dist.get_world_size(group)} ranks "
            f"({dist.get_backend(group)} on {learner.device.type}): "
            + ("captured (update_jit with the group)" if captures(group, learner.device)
               else "eager (update with the group: gloo on the card cannot be captured)"))

    writer = None
    if lead:
        writer = MetricsWriter(
            train_cfg.metrics_path,
            tensorboard_dir=f"{train_cfg.checkpoint_dir}/tb",
            resume=resume,
        )
        writer.write_config_snapshot(
            train_cfg.checkpoint_dir,
            env_train_config=env_cfg, rl_config=ppo_cfg, train_config=train_cfg,
        )

    steps_per_update = ppo_cfg.n_steps * train_cfg.num_envs
    next_ckpt = (start_step // train_cfg.checkpoint_every_steps + 1) * train_cfg.checkpoint_every_steps
    n_updates = 0
    gs = start_step
    plr_last = (state.family_counts.cpu().numpy(), state.family_wins.cpu().numpy())
    t0 = time.perf_counter()
    try:
        while True:
            state, metrics = update(state)
            n_updates += 1
            # host-side step bookkeeping: nothing is copied from the device
            # between logged updates
            gs += steps_per_update
            if n_updates == 1:
                # the first update also builds the kernel and warms the
                # caches: restart the throughput clock after it
                float(metrics["loss"])
                t0 = time.perf_counter()
            if n_updates % train_cfg.log_every_updates == 0:
                # one copy of every metric to the host
                values = torch.stack(list(metrics.values())).tolist()
                m = dict(zip(metrics, values))
                episodes_total = int(m.pop("episodes/total"))
                if plr_tick:
                    # PLR-lite controller tick: reweight the rehearsal
                    # families by their failure rates since the last tick
                    # (on every rank: the counts are summed over the ranks,
                    # so the probabilities stay replicated)
                    counts, wins, probs = (t.cpu().numpy() for t in (
                        state.family_counts, state.family_wins, state.rehearsal_probs))
                    dc, dw = counts - plr_last[0], wins - plr_last[1]
                    plr_last = (counts, wins)
                    new_probs = reweight_rehearsal(probs, dc, dw)
                    state = dataclasses.replace(state, rehearsal_probs=torch.as_tensor(
                        new_probs, device=learner.device))
                    for f, name in enumerate(FAMILY_NAMES[1:]):
                        m[f"rehearsal/p_{name}"] = float(new_probs[f])
                    log("  rehearsal:", family_report(dc, dw), "->", np.round(new_probs, 3))
                rate = ""
                if n_updates > 1:  # the clock restarted after the first update
                    m["throughput/env_steps_per_s"] = steps_per_update * (n_updates - 1) / (
                        time.perf_counter() - t0)
                    rate = f"  {m['throughput/env_steps_per_s']:,.0f} steps/s"
                if lead:
                    # cumulative episodes accumulated on the device (exact
                    # across skipped updates and across resume)
                    writer.set_episodes_total(episodes_total)
                    writer.write(gs, m)
                log(
                    f"step {gs:>9d}  loss {m['loss']:8.3f}  "
                    f"ep_ret {m['episodes/avg_total_reward']:8.2f}  "
                    f"sr {m['episodes/success_rate']:.2f}{rate}"
                )
            if gs >= next_ckpt:
                if lead:
                    save_checkpoint(train_cfg.checkpoint_dir, state)
                next_ckpt += train_cfg.checkpoint_every_steps
            if gs >= train_cfg.total_timesteps:
                break
            if max_updates and n_updates >= max_updates:
                break
    finally:
        # final save (reference model.save('new_agent'), main.py:209)
        if lead:
            step = save_checkpoint(train_cfg.checkpoint_dir, state)
            np.savez(f"{train_cfg.checkpoint_dir}/new_agent.npz",
                     **params_to_flat_dict(state.params))
            writer.close()
            print(f"saved final checkpoint at step {step}")
    return state


def main(argv=None) -> None:
    from drone2d_tpu_torch.utils.runtime import wait_for_accelerator

    args, train_cfg, env_cfg, ppo_cfg = parse_args(argv)
    group, device = None, args.device
    if launched():  # one rank of a torchrun launch
        group, device = make_group(args.device)
    log = print if host_info().is_coordinator else (lambda *a: None)
    if args.preset:
        log(f"preset {args.preset!r}: {PRESETS[args.preset]['doc']}")
    if args.device != "cpu":
        log(f"device: {wait_for_accelerator()}")
    try:
        train(
            train_cfg,
            env_cfg,
            ppo_cfg,
            resume=args.resume,
            max_updates=args.max_updates,
            init_params=args.init_params,
            device=device,
            group=group,
        )
    finally:
        if group is not None:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()

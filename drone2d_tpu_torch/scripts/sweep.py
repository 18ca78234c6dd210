"""Training-quality seed sweep + evaluation campaign: the port's counterpart
of `scripts/sweep.py`.

The reference's published numbers come from hand-picking the best of ~20
training runs (ppo_agents/ holds ~80 checkpoints across runs; the three
best, run17/19/20, are enshrined in best_models_config_and_res/).  This
script runs that methodology on the card: several seeds trained end to end,
each evaluated on the full 12-scenario suite, summaries written to --out.

    python -m drone2d_tpu_torch.scripts.sweep --out results/sweep1 --seeds 17 19 20 \\
        --total-timesteps 150000000

`--vmap S` trains the seeds in populations of S (`learn/zoo.py`: one env
batch and one policy-kernel launch a step for all S), writes the
seed_<s>/ snapshots and leaves the evaluation to
`drone2d_tpu_torch.scripts.select_agents`.  Runs on the CUDA card unless
`--device cpu`.  Under torchrun (`torchrun --nproc_per_node=K -m
drone2d_tpu_torch.scripts.sweep --vmap S ...`) each population of S seeds
is split over the K ranks, one card each (`learn/zoo.py::shard_population`).
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import time
from fractions import Fraction

from drone2d_tpu_torch.config import (
    ALL_SCENARIOS,
    PRESETS,
    EnvConfig,
    PPOConfig,
    TrainConfig,
)
from drone2d_tpu_torch.eval.run import evaluate
from drone2d_tpu_torch.learn.zoo import train_zoo
from drone2d_tpu_torch.parallel.mesh import make_group
from drone2d_tpu_torch.parallel.multihost import host_info, launched
from drone2d_tpu_torch.train import train


def parse_value(v: str):
    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        return float(Fraction(v))  # allows '1/6'


def parse_overrides(pairs, defaults):
    """KEY=VALUE strings -> typed kwargs against a dataclass's defaults.
    Later occurrences of a key win (presets prepend, explicit flags append)."""
    out = {}
    for kv in pairs:
        k, v = kv.split("=", 1)
        cur = getattr(defaults, k)
        if isinstance(cur, str):
            out[k] = v
        elif isinstance(cur, tuple):
            elem = type(cur[0]) if cur else int
            out[k] = tuple(elem(parse_value(x)) for x in v.split(","))
        else:
            out[k] = type(cur)(parse_value(v))
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", required=True)
    p.add_argument("--seeds", type=int, nargs="+", default=[17, 19, 20])
    p.add_argument("--total-timesteps", type=int, default=150_000_000)
    p.add_argument("--num-envs", type=int, default=1024)
    p.add_argument("--n-steps", type=int, default=128)
    p.add_argument("--num-minibatches", type=int, default=64)
    p.add_argument("--eval-episodes", type=int, default=100)
    p.add_argument(
        "--env", action="append", default=[], metavar="KEY=VALUE",
        help="EnvConfig override, e.g. --env PP_rew_max=3.5 (repeatable)",
    )
    p.add_argument(
        "--ppo", action="append", default=[], metavar="KEY=VALUE",
        help="PPOConfig override, e.g. --ppo hidden_sizes=128,128 (repeatable)",
    )
    p.add_argument(
        "--no-eval", action="store_true",
        help="train only; defer evaluation to drone2d_tpu_torch.scripts.select_agents, "
        "which flies all seeds x checkpoints of a scenario as one batch",
    )
    p.add_argument(
        "--shuffle", default="exact", choices=["exact", "affine", "timeperm"],
        help="PPO minibatch shuffle mode (config.PPOConfig.shuffle)",
    )
    p.add_argument(
        "--snapshots", type=int, default=3,
        help="intermediate per-seed checkpoints in --vmap mode (candidate "
        "pool for select_agents)",
    )
    p.add_argument(
        "--snapshot-steps", type=int, nargs="+", default=None,
        help="snapshot at these exact env-step counts instead of evenly "
        "spaced (--vmap mode; e.g. 9000000 18000000 37500000 75000000 for "
        "the sample-efficiency frontier)",
    )
    p.add_argument(
        "--init-params", default=None, metavar="NPZ_OR_CKPT_DIR",
        help="warm-start every seed's policy from this saved agent "
        "(population fine-tuning; hidden_sizes must match)",
    )
    p.add_argument(
        "--vmap", type=int, default=0, metavar="S",
        help="train seeds in populations of S (learn/zoo.py: one batch and "
        "one policy-kernel launch a step per S seeds). Implies --no-eval; "
        "run select_agents afterwards.",
    )
    p.add_argument(
        "--preset", default=None, choices=sorted(PRESETS),
        help="published training recipe from config.PRESETS (e.g. "
        "'flagship-scratch'); explicit --env/--ppo/scalar flags still win",
    )
    p.add_argument(
        "--device", default=None, choices=("cuda", "cpu"),
        help="where to train and evaluate; the default is the CUDA card, and "
        "the run fails without one ('cpu' runs on the host)",
    )
    return p


def main(argv=None) -> None:
    from drone2d_tpu_torch.utils.runtime import wait_for_accelerator

    args = build_parser().parse_args(argv)
    if args.preset:
        preset = PRESETS[args.preset]

        def fmt(v):
            return ",".join(map(str, v)) if isinstance(v, tuple) else str(v)

        # env/ppo overlays: prepended so explicit --env/--ppo pairs win
        # (parse_overrides keeps the last occurrence of a key)
        args.env = [f"{k}={fmt(v)}" for k, v in preset.get("env", {}).items()] + args.env
        _scalar_ppo = ("n_steps", "num_minibatches", "shuffle")
        args.ppo = [
            f"{k}={fmt(v)}" for k, v in preset.get("ppo", {}).items()
            if k not in _scalar_ppo
        ] + args.ppo
        # knobs the sweep CLI owns directly: the preset fills them unless
        # the user typed them (suppressed-defaults twin parse)
        tw = argparse.ArgumentParser(add_help=False)
        for name in ("--total-timesteps", "--num-envs", "--n-steps",
                     "--num-minibatches", "--shuffle"):
            tw.add_argument(name, default=argparse.SUPPRESS)
        given = set(vars(tw.parse_known_args(argv)[0]))
        for sec, key in (("train", "total_timesteps"), ("train", "num_envs"),
                         ("ppo", "n_steps"), ("ppo", "num_minibatches"),
                         ("ppo", "shuffle")):
            val = preset.get(sec, {}).get(key)
            if val is not None and key not in given:
                setattr(args, key, val)
        print(f"preset {args.preset!r}: {preset['doc']}")
    if args.device != "cpu":
        print(f"device: {wait_for_accelerator()}")

    env_cfg = EnvConfig(**parse_overrides(args.env, EnvConfig()))
    ppo_overrides = parse_overrides(args.ppo, PPOConfig())
    # n_steps/num_minibatches/shuffle are owned by the scalar flags; a --ppo
    # pair for one of them goes onto the scalar flag, and wins
    for key in ("n_steps", "num_minibatches", "shuffle"):
        if key in ppo_overrides:
            setattr(args, key, ppo_overrides.pop(key))
    ppo_cfg = PPOConfig(n_steps=args.n_steps, num_minibatches=args.num_minibatches,
                        shuffle=args.shuffle, **ppo_overrides)

    os.makedirs(args.out, exist_ok=True)
    group, device = None, args.device
    if launched():
        if not args.vmap:
            raise SystemExit("under torchrun the sweep splits each population over the "
                             "ranks: pass --vmap S")
        group, device = make_group(args.device)
    if args.vmap:
        for i in range(0, len(args.seeds), args.vmap):
            chunk = args.seeds[i:i + args.vmap]
            t0 = time.time()
            train_zoo(
                env_cfg, ppo_cfg, args.num_envs, chunk, args.total_timesteps, args.out,
                snapshots=args.snapshots, snapshot_steps=args.snapshot_steps,
                init_params=args.init_params, device=device, group=group,
            )
            if host_info().is_coordinator:
                print(f"=== zoo chunk {chunk}: trained ({time.time()-t0:.0f}s), "
                      f"eval via select_agents")
        return
    for seed in args.seeds:
        run_dir = os.path.join(args.out, f"seed_{seed}")
        t0 = time.time()
        train(
            TrainConfig(
                total_timesteps=args.total_timesteps,
                num_envs=args.num_envs,
                seed=seed,
                checkpoint_every_steps=max(args.total_timesteps // 4, 1),
                checkpoint_dir=run_dir,
                metrics_path=os.path.join(run_dir, "metrics.jsonl"),
                log_every_updates=20,
            ),
            env_cfg, ppo_cfg, init_params=args.init_params, device=args.device,
        )
        train_s = time.time() - t0
        if args.no_eval:
            print(f"=== seed {seed}: trained ({train_s:.0f}s), eval deferred")
            continue

        summaries = []
        for scen in ALL_SCENARIOS:
            summaries.append(
                evaluate(
                    os.path.join(run_dir, "new_agent.npz"), scen,
                    args.eval_episodes, seed=seed,
                    out_root=os.path.join(run_dir, "Tests"), gif_root=None,
                    agent_name=f"agent_s{seed}", device=args.device,
                )
            )
        with open(os.path.join(run_dir, "summary.json"), "w") as f:
            json.dump(
                {"seed": seed, "train_seconds": train_s,
                 "total_timesteps": args.total_timesteps,
                 "scenarios": summaries},
                f, indent=1,
            )
        mean_sr = sum(s["success_rate"] for s in summaries) / len(summaries)
        print(f"=== seed {seed}: mean SR {mean_sr:.3f}  ({train_s:.0f}s train)")


if __name__ == "__main__":
    main()

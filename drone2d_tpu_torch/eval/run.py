"""Evaluation CLI: the port's counterpart of `drone2d_tpu/eval/run.py`, the
reference's `mode == "test"` harness (`main.py:242-400`) as a command:

    python -m drone2d_tpu_torch.eval.run --agent artifacts/agent_s8004/new_agent.npz \\
        --scenario all --episodes 1000 --no-gif

Runs all episodes of a scenario as one env batch on the CUDA card (unless
`--device cpu`), then writes the reference's artifact set: results.txt,
collisions/rewards/apes/time_spent .npy and the flight_paths JSON, and for a
spatial scenario the overlay PNG and the replay GIF of one episode under
`--gif-root` (`--gif-all`: of every episode; `--no-gif`: none), drawn on
the host with pygame.  `--scenario all` sweeps the 12-scenario suite (7
spatial + 5 curriculum stages, rl_config.py:45-58).
"""

from __future__ import annotations

import argparse
import os
import re
from typing import Optional

import numpy as np
import torch

from drone2d_tpu_torch.config import (
    ALL_SCENARIOS,
    EXTRA_SCENARIOS,
    STAGE_SCENARIOS,
    TEST_SCENARIOS,
    EnvConfig,
)
from drone2d_tpu_torch.eval.artifacts import write_campaign
from drone2d_tpu_torch.eval.episode import run_episodes
from drone2d_tpu_torch.models.policy import ActorCritic, flat_dict_to_params
from drone2d_tpu_torch.utils.checkpoint import checkpoint_steps


def load_params(path: str, step: Optional[int] = None, device=None) -> Optional[ActorCritic]:
    """Policy params from an agent .npz (either package's) or the port's
    checkpoint directory (`ckpt_<step>.pt`, the latest unless `step` is
    given).  Returns None for the literal 'random' (random-policy
    baseline)."""
    if path == "random":
        return None
    if path.endswith(".npz"):
        with np.load(path) as z:
            return flat_dict_to_params(dict(z), device=device)
    steps = checkpoint_steps(path)
    step = steps[-1] if step is None and steps else step
    if step is None or step not in steps:
        raise FileNotFoundError(f"no checkpoint under {path!r}" + (
            "" if step is None else f" at step {step}"))
    sd = torch.load(os.path.join(path, f"ckpt_{step}.pt"), map_location="cpu",
                    weights_only=True)["params"]
    # state_dict keys ("pi.0.w", "vf_out.b") -> the agent-file naming ("pi0/w")
    flat = {re.sub(r"^(pi|vf)\.(\d)", r"\1\2", k).replace(".", "/"): v.numpy()
            for k, v in sd.items()}
    return flat_dict_to_params(flat, device=device)


def _derive_agent_name(agent_path: str) -> str:
    """Artifact directory name for an agent path.

    `agent_<nr>`-style paths (the reference's Tests/<agent> convention) keep
    that name; anything else (e.g. the train CLI's `new_agent.npz`) falls
    back to the full basename.  Directory paths (checkpoints) use the
    directory basename."""
    stem = os.path.basename(os.path.normpath(agent_path)).split(".")[0]
    m = re.fullmatch(r"agent[_-](\w+)", stem)
    if m:
        return f"agent_{m.group(1)}"
    return stem or "agent"


def scenario_config(scenario: str, base: Optional[EnvConfig] = None) -> EnvConfig:
    """Env config for one scenario name, mirroring env_test_config derivation
    (rl_config.py:63-79): spatial scenarios -> mode='test'; stage_k ->
    mode='curriculum' with the stage forced."""
    base = base or EnvConfig()
    if scenario in TEST_SCENARIOS + EXTRA_SCENARIOS:
        return base.replace(mode="test", scenario=scenario)
    if scenario in STAGE_SCENARIOS:
        return base.replace(mode="curriculum", scenario=scenario)
    raise ValueError(
        f"unknown scenario {scenario!r} "
        f"(choose from {ALL_SCENARIOS + EXTRA_SCENARIOS})"
    )


def evaluate(
    agent_path: str,
    scenario: str,
    episodes: int,
    *,
    seed: int = 0,
    deterministic: bool = False,
    out_root: str = "Tests",
    gif_root: Optional[str] = "Gifs",
    agent_name: Optional[str] = None,
    checkpoint_step: Optional[int] = None,
    gif_all_episodes: bool = False,
    device=None,
) -> dict:
    """One scenario's campaign: run it, write its artifacts, print and
    return its summary."""
    cfg = scenario_config(scenario)
    params = load_params(agent_path, checkpoint_step, device)
    results = run_episodes(cfg, params, seed, episodes, deterministic=deterministic,
                           device=device)
    agent = agent_name or _derive_agent_name(agent_path)
    out_dir = write_campaign(cfg, results, agent=agent, agent_path=agent_path,
                             scenario=scenario, root=out_root, gif_root=gif_root,
                             gif_all_episodes=gif_all_episodes)
    n = max(int(np.sum(results.success) + np.sum(results.fail)), 1)
    summary = dict(
        scenario=scenario,
        episodes=episodes,
        success_rate=float(np.sum(results.success)) / n,
        collision_rate=float(np.sum(results.collision)) / n,
        avg_ape=float(np.mean(results.ape)),
        avg_flight_time=float(np.mean(results.time_steps.astype(np.float64))),
        out_dir=out_dir,
    )
    print(
        f"{scenario:>14s}: SR {summary['success_rate']:.2f}  "
        f"CR {summary['collision_rate']:.2f}  APE {summary['avg_ape']:.1f}  "
        f"T {summary['avg_flight_time']:.1f}  -> {out_dir}"
    )
    return summary


def main(argv=None) -> None:
    from drone2d_tpu_torch.utils.runtime import wait_for_accelerator

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--agent", required=True,
                   help=".npz params, the port's checkpoint dir, or 'random'")
    p.add_argument("--scenario", default="large",
                   help="scenario name or 'all' (choices: %s)" % ",".join(ALL_SCENARIOS))
    p.add_argument("--episodes", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--deterministic", action="store_true")
    p.add_argument("--out-root", default="Tests")
    p.add_argument("--gif-root", default="Gifs")
    p.add_argument("--no-gif", action="store_true")
    p.add_argument("--gif-all", action="store_true",
                   help="one GIF spanning ALL campaign episodes (the reference's "
                   "test-mode behavior, main.py:259-295) instead of a single episode")
    p.add_argument("--agent-name", default=None)
    p.add_argument("--checkpoint-step", type=int, default=None,
                   help="checkpoint step to load (default: latest)")
    p.add_argument(
        "--device", default=None, choices=("cuda", "cpu"),
        help="where to evaluate; the default is the CUDA card, and the run "
        "fails without one ('cpu' runs on the host)",
    )
    args = p.parse_args(argv)
    if args.device != "cpu":
        print(f"device: {wait_for_accelerator()}")

    scenarios = ALL_SCENARIOS if args.scenario == "all" else (args.scenario,)
    for s in scenarios:
        evaluate(
            args.agent, s, args.episodes,
            seed=args.seed, deterministic=args.deterministic,
            out_root=args.out_root,
            gif_root=None if args.no_gif else args.gif_root,
            agent_name=args.agent_name,
            checkpoint_step=args.checkpoint_step,
            gif_all_episodes=args.gif_all,
            device=args.device,
        )


if __name__ == "__main__":
    main()

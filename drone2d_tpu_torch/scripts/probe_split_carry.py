"""A/B probe on the card: the template-carry against the split-carry hot
loop; the port's counterpart of `scripts/probe_split_carry.py`.

Times the bench's captured chunk (policy sample + env step + auto-reset, a
CUDA graph of `bench.GRAPH_STEPS` steps replayed, each chunk's draws made
by its draw graph)
both ways at the headline shape (4096 envs x 256-step chunks), as the JAX
probe jits both chunks: `bench.CapturedChunk` with the template carry and
`bench.CapturedSplitChunk` with the split carry.  Prints ns per env step of
each and the speedup.  It also asserts that the two captured loops agree
bit for bit on the whole (T, n) reward arrays of the first chunk, drawn
from one seed each way (`torch.equal` on the card's tensors; the whole
state is held bit-equal in `tests/test_torch_split.py`).

    python -m drone2d_tpu_torch.scripts.probe_split_carry [--num-envs 4096] \\
        [--chunk 256] [--repeats 8] [--device cpu]

Runs on the CUDA card unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from drone2d_tpu_torch.bench import CapturedChunk, CapturedSplitChunk, graph_steps
from drone2d_tpu_torch.config import EnvConfig, PPOConfig
from drone2d_tpu_torch.learn.ppo import PPOLearner


def run(num_envs: int = 4096, chunk_t: int = 256, repeats: int = 8, device=None) -> dict:
    learner = PPOLearner(EnvConfig(), PPOConfig(), num_envs, device=device)
    state = learner.init(0)
    dev, env = learner.device, learner.env
    results, rewards = {}, {}
    for name, cls in (("template", CapturedChunk), ("split", CapturedSplitChunk)):
        gen = torch.Generator(device=dev).manual_seed(1)
        env_state, obs = state.env_state, state.obs
        chunk = cls(state.params, env, env_state, obs, steps=graph_steps(chunk_t), gen=gen,
                    chunk_t=chunk_t)
        env_state, obs, rewards[name] = chunk(env_state, obs)
        float(rewards[name].sum())  # the first chunk, synchronized
        t0 = time.perf_counter()
        for _ in range(repeats):
            env_state, obs, r = chunk(env_state, obs)
        float(r.sum())
        dt = time.perf_counter() - t0
        results[name] = dt / (repeats * chunk_t * num_envs) * 1e9
        print(f"{name}: {results[name]:.1f} ns/env-step "
              f"({repeats * chunk_t * num_envs / dt / 1e6:.2f}M steps/s)", flush=True)
    out = {
        "num_envs": num_envs, "chunk": chunk_t,
        "template_ns": round(results["template"], 2),
        "split_ns": round(results["split"], 2),
        "speedup": round(results["template"] / results["split"], 4),
        "first_chunk_reward_equal": bool(torch.equal(rewards["template"], rewards["split"])),
    }
    print(json.dumps(out))
    if not out["first_chunk_reward_equal"]:
        raise AssertionError("the template and split chunks' rewards differ")
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--num-envs", type=int, default=4096)
    p.add_argument("--chunk", type=int, default=256)
    p.add_argument("--repeats", type=int, default=8)
    p.add_argument("--device", default=None, choices=("cuda", "cpu"),
                   help="where to run; the default is the CUDA card, and the run fails "
                   "without one ('cpu' runs on the host)")
    args = p.parse_args(argv)
    return run(args.num_envs, args.chunk, args.repeats, device=args.device)


if __name__ == "__main__":
    main()

"""Trace the env hot loop on the card with `torch.profiler`: the port's
counterpart of `scripts/profile_step.py`.

    python -m drone2d_tpu_torch.scripts.profile_step [outdir] [--device cpu]

Writes a Chrome trace (`chrome://tracing`, Perfetto) of a few chunks of the
bench's env line (`drone2d_tpu_torch.bench.CapturedChunk`, a CUDA graph of
`bench.GRAPH_STEPS` steps replayed after the chunk's draw graph, as the
bench makes them; 4096 envs x 64 steps, 3 chunks) through `utils.profiling.trace`
to `<outdir>/trace.json` (default logs/profile) and prints where it went.
The capture and a warm-up chunk come before the trace.  Runs on the CUDA
card unless `--device cpu`.
"""

from __future__ import annotations

import argparse

from drone2d_tpu_torch.bench import CapturedChunk, graph_steps
from drone2d_tpu_torch.config import EnvConfig, PPOConfig
from drone2d_tpu_torch.learn.ppo import PPOLearner
from drone2d_tpu_torch.utils.profiling import trace

NUM_ENVS, T, CHUNKS = 4096, 64, 3


def profile(out: str, num_envs: int = NUM_ENVS, chunk_t: int = T, chunks: int = CHUNKS,
            device=None) -> str:
    """Trace `chunks` captured bench chunks after the capture and a warm-up
    chunk; returns the trace's path."""
    learner = PPOLearner(EnvConfig(), PPOConfig(), num_envs, device=device)
    state = learner.init(0)
    params, env, gen, dev = state.params, learner.env, state.generator, learner.device
    run = CapturedChunk(params, env, state.env_state, state.obs, steps=graph_steps(chunk_t),
                        gen=gen, chunk_t=chunk_t)
    env_state, obs, r = run(state.env_state, state.obs)
    float(r.sum())
    with trace(out) as path:
        for _ in range(chunks):
            env_state, obs, r = run(env_state, obs)
        float(r.sum())
    return path


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("out", nargs="?", default="logs/profile")
    p.add_argument("--device", default=None, choices=("cuda", "cpu"),
                   help="where to run; the default is the CUDA card, and the run fails "
                   "without one ('cpu' runs on the host)")
    args = p.parse_args(argv)
    path = profile(args.out, device=args.device)
    print(f"trace written to {path}")
    return path


if __name__ == "__main__":
    main()

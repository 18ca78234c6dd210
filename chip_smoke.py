"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `drone2d_tpu_torch/csrc/`, holds each
against its plain PyTorch version on the card (with the agent axis, each
member's slice against its own launch too), and drives the port's main
paths, each with the kernel counts set to 0 just before it and read just
after: the PPO rollout of the flagship 27-128-128 actor-critic over 4096
curriculum envs x 128 steps (twice, then GAE); training through
`drone2d_tpu_torch.train` at the published flagship-scratch recipe
(128-128 actor-critic, 1024 envs x 128 steps, 64 minibatches x 10 epochs,
3 updates from scratch, then 1 after a resume); the seed hunt's first
checkpoint: a population of 8 seeds of that recipe through
`drone2d_tpu_torch.scripts.sweep --vmap 8` (143 updates, 18,743,296 env
steps a seed), the selection of its 16 candidates on the 12 scenarios x
100 episodes through `drone2d_tpu_torch.scripts.select_agents`, and the
8 finals held against the JAX package's hunt 7 at that checkpoint
(`drone2d_tpu_torch.scripts.hunt_check`); the flagship-finetune recipe
(adaptive rehearsal) warm-started from agent_s6006, 2 updates as
published, then 6 with the corridor and crossing-wall mixes at 0.04 and the
PLR controller on, then 1 after a resume; the rehearsal fine-tune hunt's
first checkpoint: 8 seeds of that recipe from agent_s6006 through `sweep
--vmap 8` (23 updates, 3,014,656 env steps a seed), its 8 finals selected
on the 12 scenarios x 100 and held against the JAX package's hunt 8 at that
checkpoint; the reference's own training shape (`sb3_shape`: the JAX
package's SB3-shape hunt's population, 8 seeds x 14 envs x 2048-step
rollouts, 448 minibatches of 64, exact, 64-64, its rollout captured in
chunks): one update at one epoch bit-equal to the eager one, the capture's
costs and 2 replayed updates at 10 epochs; agent_s8004's eval campaign on
stage_2 through `drone2d_tpu_torch.eval.run.evaluate`; the reference's own
surface: an SB3 zip imported onto the card, the vector env core at 1024
envs (256 steps through the kernel), the gym env at B=1 (200 steps), the
graft entry's fresh-draw step (`graft.GraftStep`: `sample_action` +
`step_batch` as one graph, 256 envs x 128 steps) and the initial throw; agent_s8004 on `parallel_boxes` x 1000; and two stacked
campaigns through `eval.episode.run_episodes_multi`: s8004 + s22307 on the
12 scenarios at 1000 episodes each (through `scripts/precision_campaign`),
the four imported reference agents on 4 of them at 200.
Data parallelism (`drone2d_tpu_torch.parallel`) at flagship-scratch: a
world-1 NCCL group's captured update (`update_jit` with the group, NCCL's
collectives inside the CUDA graphs) bit-equal to the plain `update_jit`,
the two timed in turn; and two gloo
ranks on the one card (2 x 512 envs, eager: gloo cannot
be captured) against the union batch replayed in one process, with the
population split over them; the split-carry step
against the template step at 4096 envs; a corridor campaign's flight
paths replayed through `eval.replay` on the card and on the CPU; and one
rollout step traced by `utils.profiling.trace`.  The system's last entry
points: the headline bench (`python -m drone2d_tpu_torch.bench --all`, its
stdout `bench.py`'s two lines), the precision campaign of s8004 + s22307
(the stacked campaign above) and its n1000 conversion
through `package_agent`, `package_agent`'s 100-episode campaigns on two
scenarios, the stage-1 failure modes and time margin, the AAPE
survivorship's paired width groups, and the probes at small depth
(`scripts/bench_update_split`, `roofline_probe`, `roofline_update`,
`bench_kernels`, `bench_fused_policy`, `profile_step`,
`probe_split_carry`).
The training, population, data-parallel, bench, probe, eval and gym and
vector env paths run as CUDA graphs (`PPOLearner.update_jit`, the eval
runner's captured chunks, the bench's captured chunks, the adapters'
captured steps, each adapter also timed eagerly in turn), with their
draws (reset templates, noise, shuffles) made inside the graphs from the
generators the graphs are bound to; the `graphs` phase holds `update_jit`
bit-equal to the eager `update` over 2 updates in the recipe's shuffle and
for a population of 8, the generators' states included, and a drawn-inside
campaign flown by the captured eval runner bit-equal to the eager draws and
runner; the data-parallel, bench, probe and graft paths are
held bit-equal to their eager draws too, and one replay of each drawn path
runs with every wait for the card refused
(`torch.cuda.set_sync_debug_mode("error")`).
It checks that the paths launched the kernels and that their outputs are
right (an update, an eval batch and the vector env on the card against the
same on the CPU, 129 launches an update for one seed or for 8, finite
losses, moved and distinct weights, finished episodes, the NEXT_STEP reset
rows, fresh episodes after each end, the rehearsal families' frequencies
and walls, the controller's budget, each success rate against the
committed campaigns, the JAX package's and the conformance report by a
two-proportion z-test, files on disk), times each phase, the updates by
layer and a campaign step, and
prints one JSON line of kernel measurements and, last, one JSON status
line.  Any failure raises, so the exit code is 0 only when every phase
passed.  Needs CUDA; imports no JAX, and needs no gymnasium, pygame,
imageio or matplotlib.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import io
import json
import math
import multiprocessing
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from drone2d_tpu_torch import bench
from drone2d_tpu_torch.compat import make as make_gym_env
from drone2d_tpu_torch.compat.sb3_import import load_sb3_agent, save_sb3_zip, torch_policy_value
from drone2d_tpu_torch.compat.sb3_import import load_sb3_state_dict
from drone2d_tpu_torch.compat.vector_env import VectorEnvCore
from drone2d_tpu_torch.config import ALL_SCENARIOS, EnvConfig, PPOConfig
from drone2d_tpu_torch.env.env import Drone2DEnv, _observe, _rewards_and_done
from drone2d_tpu_torch.env.types import FAMILY_NAMES, finalize_split, select_state, split_state
from drone2d_tpu_torch.eval import episode as eval_episode
from drone2d_tpu_torch.eval.episode import run_episodes, run_episodes_from, run_episodes_multi
from drone2d_tpu_torch.eval.replay import replay_campaign
from drone2d_tpu_torch.eval.run import evaluate, load_params, scenario_config
from drone2d_tpu_torch.graft import GraftStep, graft_step
from drone2d_tpu_torch.learn import optim
from drone2d_tpu_torch.learn.gae import compute_gae
from drone2d_tpu_torch.learn.ppo import PPOLearner, TrainState, collect_steps, warmup_launches
from drone2d_tpu_torch.learn.zoo import ZooTrainer, shard_population, snapshot_schedule
from drone2d_tpu_torch.models.policy import (
    ActorCritic,
    flat_dict_to_params,
    params_to_flat_dict,
    stack_params,
)
from drone2d_tpu_torch.ops import cuda_build, geometry, physics
from drone2d_tpu_torch.ops.fused_policy import fused_sample_action, fused_sample_action_ref
from drone2d_tpu_torch.ops.ppo_sgd import ppo_sgd_plan, ppo_sgd_step
from drone2d_tpu_torch.parallel import mesh
from drone2d_tpu_torch.scripts import (
    aape_survivorship,
    bench_fused_policy,
    bench_kernels,
    bench_update_split,
    hunt_check,
    package_agent,
    precision_campaign,
    probe_split_carry,
    probe_update_capture,
    profile_step,
    roofline_probe,
    roofline_update,
    select_agents,
    stage1_failure_modes,
    stage1_time_margin,
    sweep,
)
from drone2d_tpu_torch.train import parse_args, train
from drone2d_tpu_torch.utils.checkpoint import restore_checkpoint
from drone2d_tpu_torch.utils import graphs
from drone2d_tpu_torch.utils.profiling import LEAD_KERNELS, device_window, launch_window, trace

ROOT = Path(__file__).resolve().parent
AGENT = ROOT / "artifacts" / "agent_s8004" / "new_agent.npz"
# the parent of agent_s8004, which the flagship-finetune recipe started from
FINETUNE_AGENT = ROOT / "artifacts" / "agent_s6006" / "new_agent.npz"
CAMPAIGN = ROOT / "artifacts" / "agent_s8004" / "campaign_n1000_summary.json"
NUM_ENVS, N_STEPS, HIDDEN = 4096, 128, (128, 128)
START_STEP = 3e6  # curriculum stage 5
# H100 SXM peaks (NVIDIA data sheet, dense): float32 on the CUDA cores,
# fp16 on the tensor cores, HBM3
PEAK_F32_FLOPS, PEAK_F16_FLOPS, PEAK_BYTES = 67e12, 989e12, 3.35e12
TOL = 1e-5
# the update on the card against the CPU, as tests/test_torch_ppo.py holds
# the port against the JAX package: loss and aux to UPDATE_TOL of
# max(|value|, 1); each weight to PARAM_TOL of the lr x SGD-steps budget
# (Adam moves a weight by at most ~lr a step) plus PARAM_ULPS float32 ulps
# of the weight (the same step added to a weight rounds to its ulp)
UPDATE_TOL, PARAM_TOL, PARAM_ULPS = 1e-5, 1e-3, 4
TRAIN_UPDATES = 3  # from scratch, then 1 more after a resume
# `train`, `train_zoo` and the bench train through `update_jit`: a run's first
# update captures its CUDA graphs after a warm-up on one update's device
# work, whose n_steps + 1 kernel launches are real and counted
WARMUPS = 1
# the graphs phase: update_jit against update over GRAPH_UPDATES updates in
# the recipe's shuffle (timeperm) and for the population of ZOO_SEEDS; a
# drawn-inside campaign on GRAPH_EVAL_SCENARIO x EVAL_EPISODES with
# agent_s8004, seeds GRAPH_EVAL_SEED and the next (cut to hold the script's
# time: 2 updates, the capturing call and a replay, in timeperm alone, not
# timed against `update`, and no full-length eval runner against the eager
# one; `train_timing` runs one captured update in exact and in affine, and
# tests/test_torch_cuda.py holds 3 updates in every shuffle and the eval
# runner in every policy bit-equal on the card)
GRAPH_UPDATES = 2
GRAPH_EVAL_SCENARIO, GRAPH_EVAL_SEED = "stage_2", 8004
# the campaign draws' check: the eval scenario at a shorter episode cap
CAMPAIGN_CHECK_STEPS = 256
# flagship-finetune: 2 updates as published, then PLR_UPDATES with both
# wall mixes at WALL_MIX and the controller on, then 1 more after a resume.
# Stage-1 and scheduled episodes of this agent last ~500 steps, so every
# family finishes episodes, and several reach the controller's 8 a tick,
# only from the 4th-5th update of 128 steps on
FINETUNE_UPDATES = 2
PLR_UPDATES = 6
WALL_MIX = 0.04
EVAL_EPISODES = 1000
# the one-agent campaign through eval.run.evaluate, cut to one scenario:
# agent_s8004's whole 12-scenario parity comes from the stacked campaign.
# A stage scenario, for which evaluate draws no overlay PNG (a spatial one
# would need pygame on this machine); the stacked campaign flies the
# spatial ones and writes no files
CAMPAIGN_SCENARIOS = ("stage_2",)
# a scenario's success rate against the committed campaign's: |z| <= Z_MAX
Z_MAX = 3.0
# the population: flagship-scratch, 8 seeds (the JAX package's population
# size), for the graphs phase's bit-equality checks
ZOO_SEEDS = tuple(range(1, 9))
# the seed hunt's first checkpoint (the zoo phase): the JAX package's hunt 7
# recipe (`sweep --preset flagship-scratch --vmap 8 --total-timesteps
# HUNT_TIMESTEPS --snapshots HUNT_SNAPSHOTS`) snapshots first after
# HUNT_UPDATES = 143 updates, 18,743,296 env steps a seed; the population of
# HUNT_SEEDS trains that far, then `select_agents` flies its 16 candidates
# on the 12 scenarios x SELECT_EPISODES (seed SELECT_SEED), and
# `hunt_check.compare` holds the 8 finals against the record's 24 seeds at
# that checkpoint at p >= HUNT_ALPHA
HUNT_SEEDS = tuple(range(7000, 7008))
HUNT_TIMESTEPS, HUNT_SNAPSHOTS, HUNT_ALPHA = 150_000_000, 7, 0.01
# the rehearsal fine-tune hunt's first checkpoint (the finetune_hunt phase):
# the JAX package's hunt 8 recipe (`sweep --preset flagship-finetune
# --init-params artifacts/agent_s6006/new_agent.npz --vmap 8
# --total-timesteps FT_HUNT_TIMESTEPS --snapshot-steps
# FT_HUNT_SNAPSHOT_STEPS`) snapshots first after 23 updates, 3,014,656 env
# steps a seed; FT_HUNT_SEEDS train that far, `select_agents --finals-only`
# flies the 8 finals, and `hunt_check.compare` holds them against the
# record's 8 seeds at that checkpoint at p >= HUNT_ALPHA
FT_HUNT_SEEDS = tuple(range(8000, 8008))
FT_HUNT_TIMESTEPS = 30_000_000
FT_HUNT_SNAPSHOT_STEPS = tuple(3_000_000 * k for k in range(1, 10))
SELECT_EPISODES, SELECT_SEED = 100, 0
# the reference's own training shape (the sb3_shape phase; SB3's
# `PPO("MlpPolicy")` defaults, which PPOConfig's are): the JAX package's
# SB3-shape hunt's population (SB3_SEEDS x SB3_ENVS envs) at 2048-step
# rollouts and 448 minibatches of 64, exact, 64-64, 10 epochs; one update at
# one epoch held bit-equal to the eager one, SB3_TIMED replays timed at 10
SB3_SEEDS, SB3_ENVS = probe_update_capture.SEEDS, 14
SB3_PPO = PPOConfig(n_steps=2048, num_minibatches=448)
SB3_TIMED = 2
# the four 128-128 agents of artifacts/, and the stacked campaigns: s8004 and
# s22307 against their committed campaigns, the four imported reference
# agents (64-64) against the conformance report
SHIPPED = ("s8004", "s22307", "s6006", "s5004")
IMPORTED = tuple(f"agent_{k}_90" for k in (17, 19, 20, 21))
IMPORTED_EPISODES = 200
# the imported campaign's scenarios: 4 of the 12, cut to hold the script's
# time (each flies to the 1100-step cap: some episode of these agents
# always times out); the aape phase holds these agents against the same
# conformance rows on parallel and stage_2
IMPORTED_SCENARIOS = ("perpendicular", "S_corridor", "large", "stage_1")
CONFORMANCE = ROOT / "artifacts" / "conformance" / "report.json"
# the reference's own surface: the vector env (VEC_ENVS envs at stage 5,
# VEC_STEPS steps, templates drawn every VEC_REFRESH), the single gym env
# (GYM_STEPS steps at B = 1, agent_17_90), the graft entry's step (GRAFT_ENVS
# envs, the fresh draw per reset, GRAFT_STEPS steps) and the initial throw
# (NUM_ENVS envs)
IMPORTED_17 = ROOT / "artifacts" / "imported" / "agent_17_90.npz"
VEC_ENVS, VEC_STEPS, VEC_REFRESH, VEC_CHECK_STEPS = 1024, 256, 128, 64
GYM_STEPS = 200
GRAFT_ENVS, GRAFT_STEPS = 256, 128
# the graft step's generator seed, and its steps held captured against eager
GRAFT_SEED, GRAFT_CHECK_STEPS = 12, 32
# data parallelism at flagship-scratch: a world-1 NCCL group (the global
# batch of the recipe, 1024 envs), then 2 gloo ranks on the one card
# (2 x 512 envs; NCCL refuses two ranks on one device) and the population
# split over them (DDP_POP_SEEDS, 2 a rank, 1024 envs a member); the
# union-batch tolerance is the JAX package's (tests/test_parallel.py:206)
DDP_ENVS, DDP_SEED, DDP_POP_SEEDS = 1024, 5, (11, 12, 13, 14)
DDP_RTOL, DDP_ATOL = 2e-5, 2e-6
# the world-1 group's updates from twin states, each path in turn: the
# first captures, the later ones replay
DDP_UPDATES = 2
# ddp2's depth cut: 2 of the recipe's 10 epochs (128 SGD steps an update,
# its widths and minibatches as published), to hold the script's time
DDP2_EPOCHS = 2
# the split-carry step against the template step: NUM_ENVS envs at stage 5,
# one N_STEPS chunk; then the replay of a corridor campaign (a straight
# scenario: the kernel's replay must reproduce the live APEs to the JAX
# package's 0.05 px, and the card's replay the CPU's to REPLAY_TOL px)
REPLAY_EPISODES, REPLAY_TOL = 200, 1e-3
# the agent-shipping tools: the precision campaign (PRECISION_EPISODES a
# scenario in one chunk, seed PRECISION_SEED; 500 took as long: a batch's
# slowest episode sets its steps, and a step's time hardly depends on the
# batch), package_agent's campaigns on PACKAGE_SCENARIOS (one stage, one
# spatial) at the committed 100 episodes,
# the stage-1 analyses at STAGE1_EPISODES, the AAPE survivorship on
# AAPE_SCENARIOS x AAPE_EPISODES; each against its committed report
PRECISION_EPISODES, PRECISION_SEED = 1000, 555
PACKAGE_SCENARIOS, PACKAGE_EPISODES = ("stage_2", "parallel"), 100
STAGE1_EPISODES = 500
R4 = ROOT / "artifacts" / "campaigns" / "r4"
AAPE_SCENARIOS, AAPE_EPISODES = ("parallel", "stage_2"), 250
AAPE_REPORT = ROOT / "artifacts" / "campaigns" / "r5" / "aape_survivorship.json"
# the probes at small depth: the roofline grid, a chunk of PROBE_CHUNK steps
PROBE_ENVS, PROBE_TABLES, PROBE_CHUNK = (1024, 4096), (256, 512), 32
# agent_s8004 on parallel_boxes: the JAX package's success rate over 1000
# stochastic episodes (seed 0), computed on the CPU by
# drone2d_tpu.eval.episode.run_episodes(scenario_config("parallel_boxes"),
# agent_s8004, PRNGKey(0), 1000): 1000 successes, 0 collisions
BOXES_EPISODES, JAX_BOXES_SR, JAX_BOXES_N = 1000, 1.0, 1000


def log(*args):
    print(*args, flush=True)


def scaled_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max(1, max |want|): float32 sums taken in another
    order differ relative to the size of the summed terms, and the flagship
    critic sums terms of ~1e3 into values of any size below that."""
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / max(1.0, float(want.abs().max())))


def device_ms(fn, reps: int = 25, inner: int = 20, launches: int = 1) -> float:
    """Median device time of one call, from CUDA events around `inner`
    back-to-back calls.  A spin kernel keeps the card busy while the host
    enqueues them (longer for a call of several `launches`), so host launch
    overhead does not show up as device time."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000 * launches)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    log(card_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    # information only: the port's card paths need none of these (the
    # renderer and gymnasium's spaces import them where they are used)
    found = {m: subprocess.run([sys.executable, "-c", f"import {m}"], capture_output=True,
                               env={**os.environ, "PYGAME_HIDE_SUPPORT_PROMPT": "1"}
                               ).returncode == 0
             for m in ("gymnasium", "pygame", "imageio", "matplotlib")}
    log("optional packages importable: " + ", ".join(f"{m} {ok}" for m, ok in found.items()))


def phase_build():
    sources = sorted(p.stem for p in cuda_build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source at once
        results = dict(zip(sources, pool.map(cuda_build.build, sources)))
    log(f"build: {len(sources)} source(s) in {time.perf_counter() - t0:.2f} s")
    for name, r in results.items():
        log(f"  {name}: nvcc {r['seconds']:.2f} s -> {r['path'].relative_to(ROOT)}")
        for line in r["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"    {line.strip()}")


def load_agent(device):
    return flat_dict_to_params(dict(np.load(AGENT)), device=device)


def kernel_work(b: int, h: int, k: int = 27, members: int = 1) -> dict:
    """What one call of the fused policy must do at batch b (all members'
    rows), width h: its float32 FLOPs (both trunks and the three head dot
    products), the FLOPs of its matrix products as the kernel runs them on
    the tensor cores (three fp16 MMAs a product), and the bytes it must move
    (obs, noise and each member's weights read once, outputs written once)."""
    n_params = 2 * (k * h + h + h * h + h) + h * 3 + 3 + 2
    products = b * 2 * 2 * (k * h + h * h)
    return {"flops": products + b * 2 * 3 * h, "tc_flops": 3 * products,
            "bytes": 4 * (b * k + b * 2 + members * n_params + b * 2 + b + b)}


def bounds(w: dict) -> tuple:
    """(bound ms, bound by operations?, tensor-core bound ms) of kernel_work
    `w` on the card's peaks."""
    t_ops, t_bytes = w["flops"] / PEAK_F32_FLOPS * 1e3, w["bytes"] / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), t_ops >= t_bytes, w["tc_flops"] / PEAK_F16_FLOPS * 1e3


def phase_kernel_vs_plain() -> dict:
    """fused_sample_action against its plain version at the rollout path's
    shapes (B=4096, H=128, the flagship weights), a ragged batch and the
    other padded widths, then its times at H=128 (B=4096; B=1024, the
    training path's batch; one block) and at PPOConfig's default H=64."""
    dev = torch.device("cuda")
    params = load_agent(dev)
    with torch.no_grad():
        params.log_std.copy_(torch.tensor([-0.3, 0.2]))  # exercises exp/affine
    gen = torch.Generator(device=dev).manual_seed(0)

    def check(p, b, label, launches=1):
        """`launches` calls at batch b, their outputs held together."""
        obs = torch.randn(launches, b, 27, generator=gen, device=dev)
        noise = torch.randn(launches, b, 2, generator=gen, device=dev)
        got = [torch.cat(x) for x in zip(*(fused_sample_action(p, o, n)
                                          for o, n in zip(obs, noise)))]
        torch.cuda.synchronize()
        with torch.no_grad():
            want = fused_sample_action_ref(p, obs.flatten(0, 1), noise.flatten(0, 1))
        obs, noise = obs[0], noise[0]
        errs = {k: scaled_err(g, w) for k, g, w in zip(("action", "logp", "value"), got, want)}
        abs_err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        log(f"  {label}: max_abs_err {abs_err:.3e}, scaled "
            + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
        bad = {k: v for k, v in errs.items() if v > TOL}
        if bad or not torch.equal(got[1], want[1]):
            raise AssertionError(f"fused_sample_action disagrees with plain ({label}): {bad}, "
                                 f"log-prob equal {torch.equal(got[1], want[1])}")
        return obs, noise, abs_err

    log(f"kernel vs plain (tolerance: |d| <= {TOL} * max(1, max |plain|)):")
    obs, noise, abs_err = check(params, NUM_ENVS, f"B={NUM_ENVS} H=128 agent_s8004")
    check(params, 4093, "B=4093 H=128 agent_s8004 (ragged)")
    # the eval and fine-tune paths' batches, with their weights as shipped
    check(load_agent(dev), EVAL_EPISODES, f"B={EVAL_EPISODES} H=128 agent_s8004 (eval path)")
    check(flat_dict_to_params(dict(np.load(FINETUNE_AGENT)), device=dev), 1024,
          "B=1024 H=128 agent_s6006 (fine-tune path)")
    # the shipping tools' single-agent batches
    check(load_agent(dev), PACKAGE_EPISODES, f"B={PACKAGE_EPISODES} H=128 agent_s8004 (package)")
    check(load_agent(dev), STAGE1_EPISODES, f"B={STAGE1_EPISODES} H=128 agent_s8004 (stage1)")
    # the gym env's single env (agent_17_90, 64-64) and the graft entry's step
    agent17 = flat_dict_to_params(dict(np.load(IMPORTED_17)), device=dev)
    # B=1: 64 single-row launches held together, the scale over their 64
    # outputs, as every other shape's is over its batch.  One row alone can
    # put its value near 0 while its 64 value-head terms are ~12 each (this
    # agent's critic), where float32 itself, the plain version's too, rounds
    # beyond 1e-5 of that one value
    obs1, noise1, _ = check(agent17, 1, "B=1 x 64 launches H=64 agent_17_90 (gym env path)",
                            launches=64)
    obs256, noise256, _ = check(graft_agent(dev), GRAFT_ENVS,
                                f"B={GRAFT_ENVS} H=128 fresh 128-128 (graft step path)")
    # a rank's rollout batch in the two-rank data-parallel run (2 x 512)
    obs512, noise512, _ = check(graft_agent(dev), DDP_ENVS // 2,
                                f"B={DDP_ENVS // 2} H=128 fresh 128-128 (ddp2 rank path)")
    widths = {h: ActorCritic(27, 2, (h, h), generator=torch.Generator().manual_seed(h),
                             device=dev) for h in (32, 64, 96, 256)}
    for h, p in widths.items():
        check(p, 1000, f"B=1000 H={h}")
    # the bench's lines: PPOConfig's default width at the env line's and the
    # train line's batches
    obs64, noise64, _ = check(widths[64], NUM_ENVS, f"B={NUM_ENVS} H=64 (bench env line)")
    obs64k, noise64k, _ = check(widths[64], 1024, "B=1024 H=64 (bench train line)")

    def times(p, o, n, h):
        with torch.no_grad():
            ms = device_ms(lambda: fused_sample_action(p, o, n))
            plain_ms = device_ms(lambda: fused_sample_action_ref(p, o, n))
        w = kernel_work(o.shape[0], h)
        bound, by_ops, t_tc = bounds(w)
        log(f"  time at B={o.shape[0]} H={h}: kernel {ms:.5f} ms, plain {plain_ms:.5f} ms; "
            f"{w['flops'] / 1e6:.1f} MFLOP, {w['bytes'] / 1e6:.3f} MB -> bound {bound:.5f} ms "
            f"({100 * bound / ms:.1f}% of it); fp16 pieces {w['tc_flops'] / 1e6:.1f} MFLOP "
            f"-> bound_tc {t_tc:.5f} ms ({100 * t_tc / ms:.1f}%)")
        return ms, plain_ms, bound, by_ops, t_tc

    times(params, obs[:32], noise[:32], 128)  # one block: the latency floor
    ms_1k, plain_ms_1k, bound_1k, by_ops_1k, t_tc_1k = times(
        params, obs[:1024], noise[:1024], 128)  # the training path's batch
    ms, plain_ms, bound, by_ops, t_tc = times(params, obs, noise, 128)
    extra = {f"b{NUM_ENVS}_h64": times(widths[64], obs64, noise64, 64),
             "b1024_h64": times(widths[64], obs64k, noise64k, 64),
             "b1_h64": times(agent17, obs1, noise1, 64),
             f"b{GRAFT_ENVS}": times(graft_agent(dev), obs256, noise256, 128),
             f"b{DDP_ENVS // 2}": times(graft_agent(dev), obs512, noise512, 128)}
    log("  library_ms: null (no single PyTorch call computes this function: "
        "two MLP trunks, two heads and the Gaussian sample)")
    return {
        "name": "fused_sample_action",
        "route": "cuda",
        "source": "drone2d_tpu_torch/csrc/fused_policy.cu",
        "replaces": "drone2d_tpu/ops/pallas_policy.py:93",
        "launches": None,
        "max_abs_err": abs_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": "operations" if by_ops else "bytes",
        "bound_tc_ms": t_tc,
        "library_ms": None,
        # the same columns at B=1024, the training path's batch
        "b1024": {"ms": ms_1k, "plain_ms": plain_ms_1k, "bound_ms": bound_1k,
                  "bound_by": "operations" if by_ops_1k else "bytes",
                  "bound_tc_ms": t_tc_1k, "library_ms": None},
        # the bench's env and train lines (H=64, B=4096 and 1024), the gym
        # env's B=1 (H=64), the graft step's B=256 and a ddp2 rank's B=512
        # (H=128)
        **{key: {"ms": t[0], "plain_ms": t[1], "bound_ms": t[2],
                 "bound_by": "operations" if t[3] else "bytes", "bound_tc_ms": t[4],
                 "library_ms": None} for key, t in extra.items()},
    }


def shipped_agent(name: str, device):
    return flat_dict_to_params(dict(np.load(ROOT / "artifacts" / f"agent_{name}" /
                                            "new_agent.npz")), device=device)


def graft_agent(device):
    """The graft entry's policy: a fresh 128-128 actor-critic (seed 0)."""
    return ActorCritic(27, 2, HIDDEN, generator=torch.Generator().manual_seed(0), device=device)


def imported_agent(name: str, device):
    return flat_dict_to_params(dict(np.load(ROOT / "artifacts" / "imported" / f"{name}.npz")),
                               device=device)


def phase_kernel_stacked(kernel_row: dict):
    """The kernel with the agent axis, at the stacked shapes of the paths:
    the zoo's rollout step (8 members x 1024 envs, H=128: the four shipped
    128-128 agents and perturbed copies of them), the SB3-shape hunt's
    rollout step (8 x 14, H=64: its fresh members) and selection (32 x
    SELECT_EPISODES, H=64: the four imported agents and 28 perturbed
    copies), the selection of the
    fine-tune hunt's 8 finals (8 x SELECT_EPISODES) and of the zoo's
    16 candidates (16 x SELECT_EPISODES, H=128: the four shipped agents and
    12 perturbed copies, so member offsets reach 15 weight sets), of the
    whole hunt's 64 (64 x SELECT_EPISODES: the four and 60 copies) and of
    the fine-tune hunt's 80 (the four and 76 copies), the stacked eval of
    s8004 and s22307 (2 x 1000, H=128), the precision campaign of a hunt's 3
    finalists (3 x 1000, H=128) and the stacked eval of the four
    imported agents (4 x 200, H=64), and the AAPE survivorship's two stacks
    (1 x 250, H=128; 4 x 250, H=64).  Each against its plain version
    (scaled errors <= TOL, log-prob equal), each member's slice bit-equal
    to its own unstacked launch; then
    device times of one stacked launch, of the S unstacked launches and of
    the plain version, against the bounds."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    shipped = [shipped_agent(a, dev) for a in SHIPPED]
    def perturbed_copies(agents, rounds):
        """`rounds` perturbed copies of each of `agents`, in rounds."""
        out = []
        for _ in range(rounds):
            for p in agents:
                q = copy.deepcopy(p)
                with torch.no_grad():
                    for leaf in q.parameters():
                        leaf.add_(0.05 * leaf.abs().mean() * torch.randn(
                            leaf.shape, generator=gen, device=dev))
                out.append(q)
        return out

    perturbed = perturbed_copies(shipped, 19)
    imported = [imported_agent(a, dev) for a in IMPORTED]
    # the SB3-shape hunt's population as it starts (fresh 64-64 members of
    # its seeds) and its selection's 32 candidates (the four imported 64-64
    # agents and 28 perturbed copies)
    sb3_members = [ActorCritic(27, 2, SB3_PPO.hidden_sizes,
                               generator=torch.Generator().manual_seed(s), device=dev)
                   for s in SB3_SEEDS]
    shapes = {
        "s8_n1024": (shipped + perturbed[:4], 1024, "zoo rollout step, 8 seeds x 1024 envs"),
        "s8_n100": (shipped + perturbed[:4], SELECT_EPISODES,
                    "the fine-tune hunt's selection of its 8 finals x SELECT_EPISODES "
                    "episodes"),
        "s16_n100": (shipped + perturbed[:12], SELECT_EPISODES,
                     "selection, 16 candidates x SELECT_EPISODES episodes"),
        "s64_n100": (shipped + perturbed[:60], SELECT_EPISODES,
                     "the whole hunt's selection, 64 candidates x SELECT_EPISODES episodes"),
        "s80_n100": (shipped + perturbed, SELECT_EPISODES,
                     "the fine-tune hunt's selection, 80 candidates x SELECT_EPISODES "
                     "episodes"),
        "s8_n14_h64": (sb3_members, SB3_ENVS,
                       "the SB3-shape hunt's rollout step, 8 seeds x 14 envs"),
        "s32_n100_h64": (imported + perturbed_copies(imported, 7), SELECT_EPISODES,
                         "the SB3-shape hunt's selection, 32 candidates x SELECT_EPISODES "
                         "episodes"),
        "a2_n1000": (shipped[:2], EVAL_EPISODES, "stacked eval, s8004 + s22307"),
        "a3_n1000": (shipped[:3], EVAL_EPISODES,
                     "precision campaign of a hunt's 3 finalists"),
        "a4_n200": (imported, IMPORTED_EPISODES,
                    "stacked eval, the 4 imported agents"),
        "a1_n250": (shipped[:1], AAPE_EPISODES, "aape, the focal agent's stack of one"),
        "a4_n250": (imported, AAPE_EPISODES,
                    "aape, the 4 imported agents' stack"),
    }
    log(f"kernel with the agent axis vs plain (|d| <= {TOL} * max(1, max |plain|); each "
        "member's slice bit-equal to its own unstacked launch):")
    out = {}
    for key, (members, n, label) in shapes.items():
        stack = stack_params(members)
        S, h = len(members), members[0].pi[0].w.shape[1]
        obs = torch.randn(S, n, 27, generator=gen, device=dev)
        noise = torch.randn(S, n, 2, generator=gen, device=dev)
        got = fused_sample_action(stack, obs, noise)
        torch.cuda.synchronize()
        with torch.no_grad():
            want = fused_sample_action_ref(stack, obs, noise)
        errs = {k: scaled_err(g, w) for k, g, w in zip(("action", "logp", "value"), got, want)}
        abs_err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        views = [stack.member(i) for i in range(S)]
        alone = [fused_sample_action(v, obs[i], noise[i]) for i, v in enumerate(views)]
        sliced = all(torch.equal(g[i], a[j]) for i, a in enumerate(alone)
                     for j, g in enumerate(got))
        with torch.no_grad():
            ms = device_ms(lambda: fused_sample_action(stack, obs, noise))
            # fewer repeats at a whole hunt's 64 or 80 members: one repeat
            # of 64 launches, or of the plain version, takes ~1 s
            big = S > 16
            unstacked_ms = device_ms(lambda: [fused_sample_action(v, obs[i], noise[i])
                                              for i, v in enumerate(views)], launches=S,
                                     reps=5 if big else 25)
            plain_ms = device_ms(lambda: fused_sample_action_ref(stack, obs, noise), reps=5,
                                 inner=4 if big else 20)
        w = kernel_work(S * n, h, members=S)
        bound, by_ops, t_tc = bounds(w)
        log(f"  S={S} x N={n} H={h} ({label}): max_abs_err {abs_err:.3e}, scaled "
            + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
            + f"; slices bit-equal to unstacked launches: {sliced}; one stacked launch "
            f"{ms:.5f} ms, {S} unstacked launches {unstacked_ms:.5f} ms, plain {plain_ms:.5f} ms; "
            f"{w['flops'] / 1e6:.1f} MFLOP, {w['bytes'] / 1e6:.3f} MB -> bound {bound:.5f} ms "
            f"({100 * bound / ms:.1f}% of it), bound_tc {t_tc:.5f} ms ({100 * t_tc / ms:.1f}%)")
        if max(errs.values()) > TOL or not torch.equal(got[1], want[1]) or not sliced:
            raise AssertionError(f"stacked kernel ({key}): errors {errs}, slices equal {sliced}")
        out[key] = {"members": S, "rows_a_member": n, "hidden": h, "max_abs_err": abs_err,
                    "ms": ms, "unstacked_ms": unstacked_ms, "plain_ms": plain_ms,
                    "bound_ms": bound, "bound_by": "operations" if by_ops else "bytes",
                    "bound_tc_ms": t_tc, "library_ms": None}
    kernel_row["stacked"] = out


def _graph_ms(body, reps: int) -> float:
    """Device ms of `body` captured once in a CUDA graph (after a warm-up
    run) and replayed `reps` times back to back, from CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        body()
    g.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _sgd_setup(hidden: int, members: int, shuffle: str, n_steps: int, num_envs: int,
               minibatches: int, seed: int):
    """A learner of one epoch, a population of `members` fresh actor-critics
    and a rollout of random tensors laid out for its SGD (old log-probs that
    put the ratios inside and beyond the clip range) -> (learner, params,
    data, the epoch's shuffle)."""
    dev = torch.device("cuda")
    cfg = PPOConfig(n_steps=n_steps, num_minibatches=minibatches, n_epochs=1, shuffle=shuffle,
                    hidden_sizes=(hidden, hidden))
    learner = PPOLearner(EnvConfig(path_table_n=128), cfg, num_envs, device=dev)
    g = torch.Generator().manual_seed(seed)
    params = stack_params([ActorCritic(27, 2, (hidden, hidden), device=dev,
                                       generator=torch.Generator().manual_seed(seed + i))
                           for i in range(members)])
    T, W = n_steps, members * num_envs
    raw = tuple(x.to(dev) for x in (
        torch.randn(T, W, 27, generator=g), 0.8 * torch.randn(T, W, 2, generator=g),
        -1.0 - 2.0 * torch.rand(T, W, generator=g), 0.3 + 2.0 * torch.randn(T, W, generator=g),
        3.0 * torch.randn(T, W, generator=g)))
    perm = torch.stack([learner.draw_perms(torch.Generator(device=dev).manual_seed(seed + i))[0]
                        for i in range(members)])
    return learner, params, learner._sgd_data(raw, members), perm


# the fused SGD step against the plain one on the card: the clipped
# gradients and Adam's moments to SGD_REL of each leaf's largest element
# (the two sum each gradient over the rows in another order and grouping,
# about 1e-7 of the summed terms, which cancellation can leave at ~1e-5 of
# the leaf's largest element), the rows to TOL of max(1, |v|) (means over
# the minibatch), the weights to 1e-3 of the lr x steps budget (a weight
# moves by at most lr a step)
SGD_REL = 1e-4


def _sgd_compare(hidden: int, shuffle: str, n_steps: int, num_envs: int, minibatches: int,
                 steps: int, seed: int) -> float:
    """The first `steps` fused minibatch steps of an epoch of a population of
    8 against the plain steps (`PPOLearner.plain_sgd_step`, on the card)
    from the same weights and minibatches; raises past the bounds above.
    -> the rows' largest absolute difference."""
    learner, params, data, perm = _sgd_setup(hidden, 8, shuffle, n_steps, num_envs,
                                             minibatches, seed)
    lr = learner.cfg.learning_rate
    got, want = copy.deepcopy(params), copy.deepcopy(params)
    opt_g, opt_w = optim.adam(got.parameters(), lr), optim.adam(want.parameters(), lr)
    rows = learner._rows(8, epochs=1)[:steps]
    plan = ppo_sgd_plan(got, opt_g, data, perm, learner.cfg, learner.num_envs)
    for k in range(steps):
        ppo_sgd_step(plan, k, rows[k])
    mbs = learner._epoch_minibatches(data, perm, 8)
    plain = torch.stack([learner.plain_sgd_step(want, opt_w, mb)
                         for _, mb in zip(range(steps), mbs)])
    torch.cuda.synchronize()

    def rel(x, y):
        return float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30)

    errs = {"rows": scaled_err(rows, plain), "weights": 0.0, "grad": 0.0, "exp_avg": 0.0,
            "exp_avg_sq": 0.0}
    for a, b in zip(got.parameters(), want.parameters()):
        sa, sb = opt_g.state[a], opt_w.state[b]
        if not (torch.equal(sa["step"], sb["step"]) and float(sa["step"]) == steps):
            raise AssertionError(f"fused SGD step count {float(sa['step'])}, want {steps}")
        errs["weights"] = max(errs["weights"],
                              float((a - b).detach().abs().max()) / (1e-3 * lr * steps))
        for key, x, y in (("grad", a.grad, b.grad), ("exp_avg", sa["exp_avg"], sb["exp_avg"]),
                          ("exp_avg_sq", sa["exp_avg_sq"], sb["exp_avg_sq"])):
            errs[key] = max(errs[key], rel(x, y))
    rows_a_step = n_steps * num_envs // minibatches
    log(f"  8 x {rows_a_step} rows, H={hidden}, {shuffle}, {steps} steps: rows {errs['rows']:.3e}, "
        f"weights {errs['weights']:.3e} of the budget, grad {errs['grad']:.3e}, exp_avg "
        f"{errs['exp_avg']:.3e}, exp_avg_sq {errs['exp_avg_sq']:.3e}")
    if errs["rows"] > TOL or errs["weights"] > 1.0 or max(
            errs[k] for k in ("grad", "exp_avg", "exp_avg_sq")) > SGD_REL:
        raise AssertionError(f"fused SGD step disagrees with plain (8 x {rows_a_step} rows, "
                             f"H={hidden} {shuffle}): {errs}")
    return float((rows - plain).abs().max())


def sgd_step_flops(hidden: int, rows: int, obs_dim: int = 27) -> int:
    """FLOPs of one minibatch step of `rows` rows of an actor-critic with two
    hidden layers of `hidden` and two actions: the forward's products
    (`benchmark/counts.py::policy_forward_flops`), as many again for the
    weights' gradients, and the inputs' gradients of every layer but the
    first (no gradient flows into the observations)."""
    forward = 2 * 2 * (obs_dim * hidden + hidden * hidden) + 2 * 3 * hidden
    return rows * (3 * forward - 2 * 2 * obs_dim * hidden)


def phase_sgd_kernel() -> dict:
    """The PPO minibatch step as one kernel (`ops/ppo_sgd.py`) against its
    plain version (`PPOLearner.plain_sgd_step`, on the card), a population
    of 8 (`_sgd_compare`): an epoch of 4 steps at each shuffle at a small
    shape (128 rows a member: one or two row blocks), then 8 steps at each
    main path's shape, the hunts' (8 x 2,048 rows at H=128, timeperm: 16 row
    blocks summed through the partials) and the SB3 shape's (8 x 64 rows at
    H=64, exact over 2,048 x 14 rows).  Then one step's device time at those
    two shapes, each over an epoch captured in a CUDA graph and replayed,
    with the bound by the FLOPs the step needs (`sgd_step_flops`)."""
    log("fused SGD step vs plain (8 members):")
    err = 0.0
    for shuffle, hidden in (("timeperm", 128), ("exact", 64), ("affine", 256)):
        err = max(err, _sgd_compare(hidden, shuffle, 8, 64, 4, 4, 3))
    err = max(err, _sgd_compare(128, "timeperm", 128, 1024, 64, 8, 5))
    err = max(err, _sgd_compare(64, "exact", 2048, 14, 448, 8, 6))

    def times(hidden, shuffle, n_steps, num_envs, minibatches):
        learner, params, data, perm = _sgd_setup(hidden, 8, shuffle, n_steps, num_envs,
                                                 minibatches, 11)
        fused, plain = copy.deepcopy(params), copy.deepcopy(params)
        opt_f = optim.adam(fused.parameters(), learner.cfg.learning_rate)
        opt_p = optim.adam(plain.parameters(), learner.cfg.learning_rate)
        rows = learner._rows(8, epochs=1)

        def plain_epoch():
            for k, mb in enumerate(learner._epoch_minibatches(data, perm, 8)):
                rows[k] = learner.plain_sgd_step(plain, opt_p, mb)

        ms = _graph_ms(lambda: learner._epoch(fused, opt_f, data, perm), 5) / minibatches
        plain_ms = _graph_ms(plain_epoch, 2) / minibatches
        rows_a_step = n_steps * num_envs // minibatches
        flops = 8 * sgd_step_flops(hidden, rows_a_step)
        bound = flops / PEAK_F32_FLOPS * 1e3
        log(f"  step of 8 x {rows_a_step} rows at H={hidden} ({shuffle}, captured epoch of "
            f"{minibatches}): kernel {ms:.5f} ms, plain {plain_ms:.5f} ms; "
            f"{flops / 1e6:.1f} MFLOP -> bound {bound:.5f} ms ({100 * bound / ms:.1f}% of it)")
        return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "operations",
                "library_ms": None}

    hunt = times(128, "timeperm", 128, 1024, 64)
    sb3 = times(64, "exact", 2048, 14, 448)
    log("  library_ms: null (no single PyTorch call computes a PPO step)")
    return {"name": "ppo_sgd_step", "route": "cuda",
            "source": "drone2d_tpu_torch/csrc/ppo_sgd.cu",
            "replaces": None,  # none: the JAX package leaves its SGD step to XLA
            "launches": None, "max_abs_err": err, **hunt,
            # the SB3 shape's step: 8 x 64 rows at H=64
            "s8_r64_h64": sb3, "launches_by_path": {}}


def phase_reference():
    """A short rollout on the card against the same rollout on the CPU (the
    plain versions), from identical inputs: the env ops and the kernel
    agree on a small input."""
    n, t = 256, 4
    out = {}
    env = Drone2DEnv(EnvConfig(), device="cpu")
    gen = torch.Generator().manual_seed(2)
    env_state, obs = env.reset_batch(gen, n, 3e6)  # stage-5 obstacle fields
    tmpl, tmpl_obs = env.reset_batch(gen, n, 3e6)
    noise = torch.randn(t, n, 2, generator=gen)
    for dev in ("cpu", "cuda"):
        learner = PPOLearner(EnvConfig(), PPOConfig(n_steps=t, hidden_sizes=HIDDEN), n,
                             device=dev)
        move = lambda x: _to(x, dev)  # noqa: E731
        params = load_agent(dev)
        s = TrainState(params=params, optimizer=optim.adam(params.parameters(), 3e-4),
                       env_state=move(env_state), obs=move(obs), generator=torch.Generator(),
                       global_step=torch.tensor(3e6, device=dev),
                       episodes_total=torch.tensor(0.0, device=dev))
        out[dev] = learner.rollout_from(s, move(tmpl), move(tmpl_obs), move(noise))
    (_, bc, lc, _), (_, bg, lg, _) = out["cpu"], out["cuda"]
    if not torch.equal(bc.dones, bg.dones.cpu()):
        raise AssertionError("dones differ between the card and the CPU")
    errs = {k: scaled_err(getattr(bg, k).cpu(), getattr(bc, k))
            for k in ("obs", "actions", "values", "rewards")}
    errs["last_values"] = scaled_err(lg.cpu(), lc)
    first = {k: scaled_err(getattr(bg, k)[0].cpu(), getattr(bc, k)[0])
             for k in ("actions", "values")}
    log(f"card vs CPU, {n} envs x {t} steps: scaled errors "
        + ", ".join(f"{k} {v:.2e}" for k, v in {**errs, **{f'{k}[0]': v for k, v in first.items()}}.items()))
    # same bounds as tests/test_torch_rollout.py (the JAX package vs the port)
    if max(first.values()) > TOL or max(errs.values()) > 5e-3:
        raise AssertionError(f"card and CPU rollouts disagree: {errs} {first}")


def _to(x, dev):
    if dataclasses.is_dataclass(x):
        return type(x)(**{f.name: _to(getattr(x, f.name), dev) for f in dataclasses.fields(x)})
    return None if x is None else x.to(dev)


def phase_breakdown(learner, state):
    """Host-clock time of each layer of one rollout step at 4096 envs, each
    synchronized, median of 10."""
    cfg, env = learner.env.cfg, learner.env
    es, obs = state.env_state, state.obs
    noise = torch.zeros(NUM_ENVS, 2, device="cuda")
    with torch.no_grad():
        act = state.params.sample_action(obs, noise=noise)[0].clamp(-1, 1)
        f = physics.thrust_forces(act, cfg.force_scale)
        body = physics.step_body(es.body, f[:, 0], f[:, 1], dt=cfg.physics_dt,
                                 gravity_y=cfg.gravity_y, mass=cfg.total_mass,
                                 inertia=cfg.moment_of_inertia, arm=cfg.drone_radius)
        o, _ = _observe(cfg, es.path, es.obstacles, body, es.target, es.la_locked)
        done = torch.zeros(NUM_ENVS, dtype=torch.bool, device="cuda")
        layers = {
            "policy kernel": lambda: state.params.sample_action(obs, noise=noise),
            "physics + collision": lambda: (
                physics.step_body(es.body, f[:, 0], f[:, 1], dt=cfg.physics_dt,
                                  gravity_y=cfg.gravity_y, mass=cfg.total_mass,
                                  inertia=cfg.moment_of_inertia, arm=cfg.drone_radius),
                geometry.any_collision(body.pos, body.angle, cfg.drone_width / 2,
                                       cfg.drone_height / 4, es.obstacles.xy,
                                       es.obstacles.r, es.obstacles.mask)),
            "observe": lambda: _observe(cfg, es.path, es.obstacles, body, es.target,
                                        es.la_locked),
            "reward": lambda: _rewards_and_done(cfg, o, es.obstacles.mask.any(1), done,
                                                es.t + 1),
            "template select": lambda: select_state(done, es, es),
            "whole step": lambda: env.step_batch_template(es, act, es, obs),
        }
        out = {}
        for name, fn in layers.items():
            times = []
            for _ in range(11):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            out[name] = statistics.median(times[1:])
    log("step layers at 4096 envs (host clock, synchronized, median ms): "
        + ", ".join(f"{k} {v:.3f}" for k, v in out.items()))

    # device busy share over three steps, from the profiler's kernel times
    def three_steps():
        with torch.no_grad():
            for _ in range(3):
                a = state.params.sample_action(obs, noise=noise)[0]
                env.step_batch_template(es, a.clamp(-1, 1), es, obs)

    device_events, dev_us, wall_us = device_window(three_steps)
    kernels = len(device_events)
    if dev_us > 0:
        log(f"profiler, 3 steps: device busy {dev_us / 1e3:.3f} ms of {wall_us / 1e3:.3f} ms "
            f"wall ({100 * dev_us / wall_us:.1f}%), {kernels / 3:.0f} device ops a step")
        by_name = {}
        for e in device_events:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        log("  top device ops (us a step): "
            + "; ".join(f"{name[:60]} {us / 3:.1f}" for name, us in top))
    else:
        log("profiler, 3 steps: device time not measured (no device events)")


def phase_slice(kernel_row: dict):
    """The port's main path: 2 rollouts of 4096 envs x 128 steps + GAE."""
    ppo = PPOConfig(n_steps=N_STEPS, hidden_sizes=HIDDEN)
    learner = PPOLearner(EnvConfig(), ppo, NUM_ENVS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # the flagship was trained through the whole curriculum: resume it at
    # stage 5, where obstacles end episodes inside two rollouts (a stage-1
    # episode of this agent lasts ~480 steps)
    state = learner.init(0, params=load_agent("cuda"), global_step=START_STEP)
    torch.cuda.synchronize()
    log(f"slice: init {NUM_ENVS} envs at global step {START_STEP:.0f} in "
        f"{time.perf_counter() - t0:.3f} s")

    fused_sample_action.launches = 0
    episodes = 0.0
    for i in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, batch, last_values, stats = learner.rollout(state)
        advantages, returns = compute_gae(batch.rewards, batch.values, batch.dones,
                                          last_values, gamma=ppo.gamma,
                                          gae_lambda=ppo.gae_lambda)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        episodes += float(stats.n_episodes)
        summary = {k: round(float(v), 3) for k, v in stats.summary().items()}
        log(f"  rollout {i + 1}: {dt:.3f} s, {NUM_ENVS * N_STEPS / dt:.1f} env_steps_per_s, "
            f"episodes {summary}")
    launches = fused_sample_action.launches
    log(f"  rollout 2 env_steps_per_s {NUM_ENVS * N_STEPS / dt:.1f} "
        f"({NUM_ENVS} envs x {N_STEPS} steps, rollout + GAE, synchronized)")

    want = 2 * (N_STEPS + 1)
    if launches != want:
        raise AssertionError(f"fused_sample_action launched {launches} times, want {want}")
    shapes = {"obs": (N_STEPS, NUM_ENVS, 27), "rewards": (N_STEPS, NUM_ENVS),
              "values": (N_STEPS, NUM_ENVS)}
    for name, shape in shapes.items():
        t = getattr(batch, name)
        if tuple(t.shape) != shape or not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{name}: shape {tuple(t.shape)} or non-finite values")
    if not (bool(torch.isfinite(advantages).all()) and bool(torch.isfinite(returns).all())):
        raise AssertionError("non-finite advantages or returns")
    if episodes <= 0:
        raise AssertionError("no episode finished in two rollouts")
    log(f"  kernel launches on the main path: {launches}; episodes finished: {episodes:.0f}")
    kernel_row["launches_by_path"] = {"rollout": launches}
    return learner, state


def params_excess(got: ActorCritic, want: ActorCritic, budget: float) -> float:
    """max over every weight of |got - want| / (budget + PARAM_ULPS ulps of
    |want|); at most 1 passes."""
    worst = 0.0
    for g, w in zip(got.parameters(), want.parameters()):
        g, w = g.detach().double().cpu(), w.detach().double().cpu()
        allowed = budget + PARAM_ULPS * 2.0**-23 * w.abs()
        worst = max(worst, float(((g - w).abs() / allowed).max()))
    return worst


def phase_update_reference():
    """`learn_from` on the card against the same call on the CPU, from
    identical inputs: the flagship weights, a 256-env x 8-step rollout batch
    made on the CPU at curriculum stage 5, 4 minibatches x 2 epochs with
    fixed shuffles, in each shuffle mode."""
    n, t = 256, 8
    env_cfg = EnvConfig()
    cpu = PPOLearner(env_cfg, PPOConfig(n_steps=t, hidden_sizes=HIDDEN), n, device="cpu")
    start = cpu.init(0, params=load_agent("cpu"), global_step=START_STEP)
    _, batch, last_values, _ = cpu.rollout(start)
    log(f"update on the card vs the CPU, {n} envs x {t} steps, 4 minibatches x 2 epochs "
        f"(loss and aux to {UPDATE_TOL} of max(|v|, 1); weights to excess <= 1):")
    for shuffle in ("exact", "affine", "timeperm"):
        ppo = PPOConfig(n_steps=t, num_minibatches=4, n_epochs=2, shuffle=shuffle,
                        hidden_sizes=HIDDEN)
        perms = PPOLearner(env_cfg, ppo, n, device="cpu").draw_perms(
            torch.Generator().manual_seed(4))
        out = {}
        for dev in ("cpu", "cuda"):
            learner = PPOLearner(env_cfg, ppo, n, device=dev)
            params = load_agent(dev)
            # learn_from reads only the state's weights and optimizer
            state = dataclasses.replace(
                start, params=params, optimizer=optim.adam(params.parameters(), ppo.learning_rate))
            metrics = learner.learn_from(state, _to(batch, dev), last_values.to(dev),
                                         perms.to(dev))
            out[dev] = params, {k: float(v) for k, v in metrics.items()}
        (pc, mc), (pg, mg) = out["cpu"], out["cuda"]
        errs = {k: abs(mg[k] - mc[k]) / max(abs(mc[k]), 1.0) for k in mc}
        budget = PARAM_TOL * ppo.learning_rate * ppo.n_epochs * ppo.num_minibatches
        excess = params_excess(pg, pc, budget)
        log(f"  {shuffle}: loss {mc['loss']:.4f}, clip_fraction {mc['clip_fraction']:.4f}; "
            f"errors " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
            + f"; weights excess {excess:.3f}")
        if max(errs.values()) > UPDATE_TOL or excess > 1.0:
            raise AssertionError(f"{shuffle} update disagrees between the card and the CPU: "
                                 f"{errs}, weights excess {excess}")


def phase_train(kernel_row: dict):
    """The training path: `train` at the flagship-scratch recipe from
    scratch for TRAIN_UPDATES updates in a temporary directory, then
    resumed for 1 more, each run with the kernel count set to 0 just
    before it and read just after."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as d:
        return _train_in(d, kernel_row)


def _train_in(d: str, kernel_row: dict):
    _, train_cfg, env_cfg, ppo_cfg = parse_args(
        ["--preset", "flagship-scratch", "--checkpoint-dir", d,
         "--metrics-path", f"{d}/metrics.jsonl"])
    steps = ppo_cfg.n_steps * train_cfg.num_envs
    log(f"training (flagship-scratch: hidden {ppo_cfg.hidden_sizes}, {train_cfg.num_envs} envs "
        f"x {ppo_cfg.n_steps} steps, {ppo_cfg.num_minibatches} minibatches x "
        f"{ppo_cfg.n_epochs} epochs, shuffle {ppo_cfg.shuffle}, stage_mix_prob "
        f"{env_cfg.stage_mix_prob}):")
    init = ActorCritic(27, 2, ppo_cfg.hidden_sizes, device="cuda",
                       generator=torch.Generator().manual_seed(train_cfg.seed)).requires_grad_(False)
    launches = {}
    for name, kw, updates in (("train", {}, TRAIN_UPDATES), ("train_resume", dict(resume=True), 1)):
        torch.cuda.synchronize()
        fused_sample_action.launches = 0
        t0 = time.perf_counter()
        state = train(train_cfg, env_cfg, ppo_cfg, max_updates=updates, **kw)
        torch.cuda.synchronize()
        launches[name] = fused_sample_action.launches
        log(f"  {name}: {updates} update(s) in {time.perf_counter() - t0:.2f} s, "
            f"kernel launches {launches[name]} (the capture's warm-up included)")
        if launches[name] != (updates + WARMUPS) * (ppo_cfg.n_steps + 1):
            raise AssertionError(f"{name}: fused_sample_action launched {launches[name]} "
                                 f"times, want ({updates} + {WARMUPS}) x {ppo_cfg.n_steps + 1}")

    with open(f"{d}/metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    want_steps = [steps * k for k in range(1, TRAIN_UPDATES + 2)]
    if [r["global_step"] for r in rows] != want_steps:
        raise AssertionError(f"metrics rows at {[r['global_step'] for r in rows]}, "
                             f"want {want_steps}")
    for r in rows:
        log(f"  step {r['global_step']}: loss {r['loss']:.4f}, value_loss "
            f"{r['value_loss']:.4f}, entropy {r['entropy']:.4f}, approx_kl "
            f"{r['approx_kl']:.5f}, episodes {r['episodes/episodes']:.0f} (avg length "
            f"{r['episodes/avg_length']:.1f}, return {r['episodes/avg_total_reward']:.2f})"
            + (f", env_steps_per_s logged by train {r['throughput/env_steps_per_s']:.1f}"
               if "throughput/env_steps_per_s" in r else ""))
    if not all(math.isfinite(r[k]) for r in rows for k in ("loss", "value_loss", "entropy")):
        raise AssertionError("non-finite loss")
    if rows[-1]["time/episodes"] <= 0:
        raise AssertionError("no episode finished in training")
    with torch.no_grad():
        moved = [float((a - b).abs().max()) for a, b in zip(state.params.parameters(),
                                                            init.parameters())]
    if min(moved) <= 0.0:
        raise AssertionError(f"a weight did not move in training: {moved}")
    for f in (f"ckpt_{want_steps[-1]}.pt", "new_agent.npz"):
        if not Path(d, f).exists():
            raise AssertionError(f"training wrote no {f}")
    saved = flat_dict_to_params(dict(np.load(f"{d}/new_agent.npz")), device="cuda")
    if params_excess(saved, state.params, 0.0) > 0.0:
        raise AssertionError("new_agent.npz differs from the trained weights")
    log(f"  {len(rows)} metrics rows at global_step {want_steps}; episodes finished "
        f"{rows[-1]['time/episodes']}; smallest weight change per leaf {min(moved):.3e}; "
        f"ckpt_{want_steps[-1]}.pt and new_agent.npz on disk")
    kernel_row["launches_by_path"].update(launches)
    return (train_cfg, env_cfg, ppo_cfg), state


@contextlib.contextmanager
def no_host_sync():
    """Inside the block any operation that waits for the card raises
    (`torch.cuda.set_sync_debug_mode("error")`)."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def phase_graphs(cfgs, kernel_row: dict):
    """The compiled programs: `update_jit` (its draws made inside its
    rollout graph) against `update` from twin starts over GRAPH_UPDATES
    consecutive updates at flagship-scratch (1024 envs x 128 steps, 64 x 10
    SGD, timeperm), and for a population of the 8 ZOO_SEEDS: weights,
    Adam's whole state, metrics, envs, counters and the generators' states
    bit-equal after each update, 2 (n_steps + 1) launches for the capturing
    call and n_steps + 1 for each later one; the programs' nodes, capture
    and instantiation seconds and pool bytes; the rollout and SGD graphs
    replayed alone, the host launches and device ops of an update each way
    under the profiler, one more update replayed with every wait for the
    card refused (`no_host_sync`); a campaign drawn inside its graph and
    flown by the captured runner (agent_s8004 on GRAPH_EVAL_SCENARIO x
    EVAL_EPISODES at a CAMPAIGN_CHECK_STEPS cap, two seeds) against the
    eager draws and runner: every field of the results equal.  The path's
    launches are those of the captured calls: the eager references' are
    counted apart."""
    train_cfg, env_cfg, ppo_cfg = cfgs
    n, N = ppo_cfg.n_steps + 1, train_cfg.num_envs
    torch.cuda.synchronize()
    fused_sample_action.launches = 0
    others = [0]  # the eager references' launches: not the path's own

    def reference(fn, *args, **kw):
        before = fused_sample_action.launches
        out = fn(*args, **kw)
        others[0] += fused_sample_action.launches - before
        return out

    log(f"graphs: update_jit against update, {GRAPH_UPDATES} updates from twin starts "
        f"(flagship-scratch, {N} envs x {ppo_cfg.n_steps} steps, {ppo_cfg.num_minibatches} x "
        f"{ppo_cfg.n_epochs} SGD):")
    runs = [(f"shuffle {ppo_cfg.shuffle}", PPOLearner(env_cfg, ppo_cfg, N),
             lambda learner: learner.init(train_cfg.seed))]
    runs.append((f"population of {len(ZOO_SEEDS)}", ZooTrainer(env_cfg, ppo_cfg, N),
                 lambda trainer: trainer.init(ZOO_SEEDS)))
    timing = None
    for label, learner, start in runs:
        a, b = start(learner), start(learner)
        counts, equal, secs = [], [], []
        for _ in range(GRAPH_UPDATES):
            before = fused_sample_action.launches
            t0 = time.perf_counter()
            a, ma = learner.update_jit(a)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            counts.append(fused_sample_action.launches - before)
            b, mb = reference(learner.update, b)
            eq = probe_update_capture.states_equal(a, b)
            eq["metrics"] = set(ma) == set(mb) and all(torch.equal(ma[k], mb[k]) for k in mb)
            equal.append(eq)
        program = next(iter(learner._graphs.entries.values()))
        st = program.capture_stats
        log(f"  {label}: bit-equal {equal}; kernel launches {counts} (want "
            f"{[(1 + WARMUPS) * n] + [n] * (GRAPH_UPDATES - 1)}); update_jit seconds "
            f"{[round(x, 4) for x in secs]}; nodes {st.nodes} (rollout + GAE, an SGD epoch), "
            f"warm-up {st.warmup_s:.3f} s, recording {st.capture_s:.3f} s, instantiation "
            f"{st.instantiate_s:.3f} s, pool {st.pool_bytes / 2**20:.1f} MiB")
        if not all(all(e.values()) for e in equal) or counts != [(1 + WARMUPS) * n] + [n] * (
                GRAPH_UPDATES - 1) or learner._graphs.captures != 1:
            raise AssertionError(f"graphs {label}: {equal}, launches {counts}, "
                                 f"{learner._graphs.captures} captures")
        if timing is None:
            timing = (learner, a, b, program)

    learner, a, b, program = timing
    parts = {}
    for name, g, k in (("rollout + GAE", program.rollout, ppo_cfg.n_steps),
                       ("SGD epoch", program.epoch, ppo_cfg.num_minibatches)):
        ts = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            g()
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        parts[name] = 1e3 * min(ts) / k
        log(f"  {name} graph replayed alone: {1e3 * min(ts):.3f} ms (min of 3), "
            f"{parts[name]:.4f} ms a {'rollout' if k == ppo_cfg.n_steps else 'minibatch'} "
            f"step")
    # the profiler over one whole captured update, and over one SGD epoch
    # each way (an eager update's ~420k events would take it long to read)
    sgd_steps = ppo_cfg.n_epochs * ppo_cfg.num_minibatches
    events, host, dev_us, wall_us = launch_window(lambda: float(learner.update_jit(a)[1]["loss"]))
    steps_an_update = ppo_cfg.n_steps + sgd_steps
    log(f"  profiler, one update_jit: {len(events)} device ops "
        f"({len(events) / steps_an_update:.1f} a step of {ppo_cfg.n_steps} rollout + "
        f"{sgd_steps} SGD), {len(host)} host launches "
        f"({len(host) / steps_an_update:.2f} a step), device busy "
        f"{100 * dev_us / wall_us:.1f}% of {wall_us / 1e3:.1f} ms")
    with no_host_sync():
        a, m = learner.update_jit(a)
    log(f"  update_jit replayed under set_sync_debug_mode('error'): no wait for the card; "
        f"loss {float(m['loss']):.6f}")
    epoch = PPOLearner(env_cfg, ppo_cfg.replace(n_epochs=1), N)
    b, batch, last_values, _ = reference(epoch.rollout, b)
    adv, ret = compute_gae(batch.rewards, batch.values, batch.dones, last_values,
                           gamma=ppo_cfg.gamma, gae_lambda=ppo_cfg.gae_lambda)
    perms = epoch.draw_perms(b.generator)
    for name, fn in (("SGD epoch graph replay", program.epoch),
                     ("eager SGD epoch",
                      lambda: reference(epoch.sgd, b, batch, adv, ret, perms))):
        events, host, dev_us, wall_us = launch_window(fn)
        k = ppo_cfg.num_minibatches
        log(f"  profiler, one {name}: {len(events) / k:.1f} device ops and {len(host) / k:.2f} "
            f"host launches a minibatch step, device busy {100 * dev_us / wall_us:.1f}% of "
            f"{wall_us / 1e3:.1f} ms")

    # a campaign's draws inside their graph and its captured runner
    # (`run_episodes`, the kept env's generator re-seeded each call) against
    # the eager draws of a fresh generator flown by the eager runner, at two
    # seeds
    params = load_agent("cuda")
    short = scenario_config(GRAPH_EVAL_SCENARIO).replace(n_steps=CAMPAIGN_CHECK_STEPS)
    same = []
    for seed in (GRAPH_EVAL_SEED, GRAPH_EVAL_SEED + 1):
        got = eval_episode.run_episodes(short, params, seed, EVAL_EPISODES)
        env_e = Drone2DEnv(short)
        want = reference(run_episodes_from, env_e, params, *eval_episode._episode_draws(
            env_e, torch.Generator(device="cuda").manual_seed(seed), EVAL_EPISODES, 0.0,
            "stochastic"), captured=False)
        same.append(all(np.array_equal(g, w) for g, w in zip(got, want)))
    kept = eval_episode._campaign_env(short, None)
    log(f"  run_episodes ({GRAPH_EVAL_SCENARIO} x {EVAL_EPISODES} at a {CAMPAIGN_CHECK_STEPS}-step "
        f"cap, the reset batch and noise drawn inside the kept env's draw graph) vs the eager "
        f"draws and runner, two seeds: equal in every field {same}; draw graphs made "
        f"{kept.draws.captures}")
    if not all(same) or kept.draws.captures != 1:
        raise AssertionError(f"graphs: run_episodes' drawn-inside campaign differs: {same}")
    torch.cuda.synchronize()
    launches = fused_sample_action.launches - others[0]
    log(f"graphs: kernel launches {launches} (and {others[0]} of the eager references); card "
        f"{card_line()}")
    kernel_row["launches_by_path"]["graphs"] = launches


def phase_train_timing(cfgs, state):
    """One update each with the 'exact' and 'affine' shuffles on a fresh
    rollout's batch; the device's busy share over one SGD epoch under the
    profiler.  (The update's own time is the bench's train line, its split
    by layer the `probes` phase's `bench_update_split`, and one SGD step's
    the `sgd_kernel` phase's.)"""
    train_cfg, env_cfg, ppo_cfg = cfgs
    learner = PPOLearner(env_cfg, ppo_cfg, train_cfg.num_envs)
    state, batch, last_values, _ = learner.rollout(state)
    adv, ret = compute_gae(batch.rewards, batch.values, batch.dones, last_values,
                           gamma=ppo_cfg.gamma, gae_lambda=ppo_cfg.gae_lambda)

    for shuffle in ("exact", "affine"):
        other = PPOLearner(env_cfg, ppo_cfg.replace(shuffle=shuffle), train_cfg.num_envs)
        fused_sample_action.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = other.update_jit(state)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        log(f"  shuffle {shuffle}: one update_jit {dt:.4f} s (its capture included), loss "
            f"{loss:.4f}, kernel launches {fused_sample_action.launches} (the warm-up's "
            f"included)")
        want = (1 + WARMUPS) * (ppo_cfg.n_steps + 1)
        if not math.isfinite(loss) or fused_sample_action.launches != want:
            raise AssertionError(f"shuffle {shuffle}: loss {loss}, "
                                 f"{fused_sample_action.launches} launches, want {want}")

    # the device's busy share over one epoch of SGD (64 minibatch steps);
    # the rollout's is in the update split above
    epoch = PPOLearner(env_cfg, ppo_cfg.replace(n_epochs=1), train_cfg.num_envs)
    perms = epoch.draw_perms(state.generator)
    device_events, dev_us, wall_us = device_window(
        lambda: float(epoch.sgd(state, batch, adv, ret, perms)["loss"]))
    if dev_us > 0:
        log(f"  profiler, one SGD epoch ({ppo_cfg.num_minibatches} minibatch steps): device "
            f"busy {dev_us / 1e3:.1f} ms of {wall_us / 1e3:.1f} ms wall "
            f"({100 * dev_us / wall_us:.1f}%), "
            f"{len(device_events) / ppo_cfg.num_minibatches:.0f} device ops a step")
    else:
        log("  profiler, one SGD epoch: device time not measured (no device events)")
    return learner, state


def phase_weights_live(learner, state):
    """After an optimizer step the kernel reads the updated weights: one
    kernel call against the plain version on the same, updated weights."""
    params, obs = state.params, state.obs
    noise = torch.randn(obs.shape[0], 2, device=obs.device)
    before = fused_sample_action(params, obs, noise)
    state, batch, last_values, _ = learner.rollout(state)
    adv, ret = compute_gae(batch.rewards, batch.values, batch.dones, last_values,
                           gamma=learner.cfg.gamma, gae_lambda=learner.cfg.gae_lambda)
    mb = [x.reshape((-1,) + x.shape[2:])[: learner.minibatch_size]
          for x in (batch.obs, batch.actions, batch.log_probs, adv, ret)]
    loss = learner.loss_fn(params, *mb)[0]
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    optim.clip_by_global_norm_([p.grad for p in params.parameters()], learner.cfg.max_grad_norm)
    state.optimizer.step()
    got = fused_sample_action(params, obs, noise)
    torch.cuda.synchronize()
    with torch.no_grad():
        want = fused_sample_action_ref(params, obs, noise)
    errs = [scaled_err(g, w) for g, w in zip(got, want)]
    moved = max(float((g - b).abs().max()) for g, b in zip(got, before))
    log(f"kernel after an optimizer step, B={obs.shape[0]}: scaled errors against the plain "
        f"version on the updated weights {', '.join(f'{e:.2e}' for e in errs)}; "
        f"outputs moved by up to {moved:.3e}")
    if max(errs) > TOL or moved <= 0.0:
        raise AssertionError(f"the kernel did not read the updated weights: {errs}, {moved}")

    # the captured rollout reads the weights by pointer: after update_jit
    # (Adam in place, inside the SGD graph) the kernel reads the new ones;
    # the eager loss's autograd graph goes first (see phase_train_timing)
    del loss
    before = fused_sample_action(params, obs, noise)
    state, _ = learner.update_jit(state)
    got = fused_sample_action(params, obs, noise)
    torch.cuda.synchronize()
    with torch.no_grad():
        want = fused_sample_action_ref(params, obs, noise)
    errs = [scaled_err(g, w) for g, w in zip(got, want)]
    moved = max(float((g - b).abs().max()) for g, b in zip(got, before))
    log(f"kernel after update_jit: scaled errors against the plain version on the updated "
        f"weights {', '.join(f'{e:.2e}' for e in errs)}; outputs moved by up to {moved:.3e}")
    if max(errs) > TOL or moved <= 0.0:
        raise AssertionError(f"the kernel did not read update_jit's weights: {errs}, {moved}")


def _finetune_args(d: str, *extra: str):
    """(train_cfg, env_cfg, ppo_cfg) of the flagship-finetune recipe writing
    under `d`, with `extra` flags."""
    return parse_args(["--preset", "flagship-finetune", "--checkpoint-dir", d,
                       "--metrics-path", f"{d}/metrics.jsonl", *extra])[1:]


PLR_FLAGS = ("--env-corridor-mix-prob", str(WALL_MIX), "--env-cross-mix-prob", str(WALL_MIX),
             "--env-rehearsal-adapt", "true")


def phase_rehearsal_reset():
    """The adaptive reset on the card: 4096 envs at the flagship-finetune
    recipe with both wall mixes at WALL_MIX.  Each family's share within 5
    sigma of its probability; 62 corridor circles, 6 crossing-wall circles,
    and every wall episode at its path start."""
    _, _, env_cfg, ppo_cfg = parse_args(["--preset", "flagship-finetune", *PLR_FLAGS])
    learner = PPOLearner(env_cfg, ppo_cfg, NUM_ENVS)
    probs = learner.initial_rehearsal_probs()
    gen = torch.Generator(device="cuda").manual_seed(5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, obs = learner.env.reset_batch(gen, NUM_ENVS, 0.0, probs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    fam = state.family.cpu().numpy()
    p = np.concatenate([[1.0 - float(probs.sum())], probs.cpu().numpy()])
    shares = np.bincount(fam, minlength=8) / NUM_ENVS
    sigma = np.sqrt(p * (1 - p) / NUM_ENVS)
    log(f"adaptive reset on the card, {NUM_ENVS} envs at flagship-finetune + walls {WALL_MIX}: "
        f"{dt:.3f} s; family share (probability, |d|/sigma): "
        + ", ".join(f"{n} {s:.4f} ({q:.4f}, {abs(s - q) / max(g, 1e-12):.2f})"
                    for n, s, q, g in zip(FAMILY_NAMES, shares, p, sigma)))
    if (np.abs(shares - p) > 5 * sigma).any():
        raise AssertionError(f"family shares {shares} off the probabilities {p}")
    count = state.obstacles.mask.sum(1).cpu().numpy()
    at_start = (state.body.pos == state.path.wps[:, 0]).all(1).cpu().numpy()
    if not ((count[fam == 6] == 62).all() and (count[fam == 7] == 6).all()
            and at_start[np.isin(fam, (6, 7))].all()):
        raise AssertionError("corridor/cross episodes lack their walls or their start")
    if not bool(torch.isfinite(obs).all()):
        raise AssertionError("non-finite observation after the adaptive reset")
    log(f"  walls: {int((fam == 6).sum())} corridor episodes with 62 circles, "
        f"{int((fam == 7).sum())} cross episodes with 6, all at their path start")


def phase_finetune(kernel_row: dict):
    """The fine-tune path: `train` at the flagship-finetune recipe from
    agent_s6006 for FINETUNE_UPDATES updates; PLR_UPDATES with both wall
    mixes at WALL_MIX and the PLR controller on; then 1 update resumed from that,
    each run with the kernel count set to 0 just before it and read just
    after."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_finetune_") as d:
        return _finetune_in(d, kernel_row)


def _finetune_in(d: str, kernel_row: dict):
    start = flat_dict_to_params(dict(np.load(FINETUNE_AGENT)), device="cuda")
    warm = dict(init_params=str(FINETUNE_AGENT))
    runs = (("finetune", f"{d}/recipe", (), warm, FINETUNE_UPDATES),
            ("finetune_plr", f"{d}/plr", PLR_FLAGS, warm, PLR_UPDATES),
            ("finetune_plr_resume", f"{d}/plr", PLR_FLAGS, dict(resume=True), 1))
    launches, states = {}, {}
    for name, out, flags, kw, updates in runs:
        train_cfg, env_cfg, ppo_cfg = _finetune_args(out, *flags)
        if name == "finetune":
            log(f"fine-tune (flagship-finetune from {FINETUNE_AGENT.parent.name}: hidden "
                f"{ppo_cfg.hidden_sizes}, {train_cfg.num_envs} envs x {ppo_cfg.n_steps} steps, "
                f"{ppo_cfg.num_minibatches} x {ppo_cfg.n_epochs} SGD, {ppo_cfg.shuffle}, "
                f"curriculum_scale {env_cfg.curriculum_scale}, stage_mix_prob "
                f"{env_cfg.stage_mix_prob} weighted {env_cfg.stage_mix_weights}):")
        if name == "finetune_plr_resume":
            saved, _ = restore_checkpoint(out, PPOLearner(env_cfg, ppo_cfg, train_cfg.num_envs))
        torch.cuda.synchronize()
        fused_sample_action.launches = 0
        t0 = time.perf_counter()
        states[name] = train(train_cfg, env_cfg, ppo_cfg, max_updates=updates, **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches[name] = fused_sample_action.launches
        log(f"  {name}: {updates} update(s) in {dt:.2f} s ({dt / updates:.2f} s an update, "
            f"setup and capture included), kernel launches {launches[name]} (the capture's "
            f"warm-up included)")
        if launches[name] != (updates + WARMUPS) * (ppo_cfg.n_steps + 1):
            raise AssertionError(f"{name}: fused_sample_action launched {launches[name]} "
                                 f"times, want ({updates} + {WARMUPS}) x {ppo_cfg.n_steps + 1}")

    for name, out in (("finetune", f"{d}/recipe"), ("finetune_plr", f"{d}/plr")):
        with open(f"{out}/metrics.jsonl") as f:
            rows = [json.loads(line) for line in f]
        for r in rows:
            # train's rate after the first update: one update's seconds
            rate = r.get("throughput/env_steps_per_s")
            log(f"  {name} step {r['global_step']}: loss {r['loss']:.4f}, value_loss "
                f"{r['value_loss']:.4f}, approx_kl {r['approx_kl']:.5f}, episodes "
                f"{r['episodes/episodes']:.0f}, success_rate {r['episodes/success_rate']:.3f}"
                + (f", {rows[0]['global_step'] / rate:.3f} s an update ({rate:.1f} "
                   "train_steps_per_s)" if rate else "")
                + "".join(f", p_{n} {r[f'rehearsal/p_{n}']:.5f}" for n in FAMILY_NAMES[1:]
                          if f"rehearsal/p_{n}" in r))
        if not all(math.isfinite(r[k]) for r in rows for k in ("loss", "value_loss", "entropy")):
            raise AssertionError(f"{name}: non-finite loss")
        with torch.no_grad():
            moved = min(float((a - b).abs().max()) for a, b in zip(
                states[name].params.parameters(), start.parameters()))
        if moved <= 0.0:
            raise AssertionError(f"{name}: a weight did not move")
        if name == "finetune_plr":
            plr_rows = rows
        elif any(k.startswith("rehearsal/") for r in rows for k in r):
            raise AssertionError("the recipe's run (rehearsal_adapt off) logged a tick")

    # the controller: every family with p > 0 finished episodes; the tick
    # reweighted the measured families and kept the budget; unmeasured ones
    # kept their probability exactly
    _, env_cfg, ppo_cfg = _finetune_args(d, *PLR_FLAGS)
    first = PPOLearner(env_cfg, ppo_cfg, 8).initial_rehearsal_probs().cpu().numpy()
    plr = states["finetune_plr"]
    counts, wins = plr.family_counts.cpu().numpy(), plr.family_wins.cpu().numpy()
    probs = plr.rehearsal_probs.cpu().numpy()
    log(f"  finetune_plr: family episodes {dict(zip(FAMILY_NAMES, counts.tolist()))}, wins "
        f"{dict(zip(FAMILY_NAMES, wins.tolist()))}; probabilities {first.tolist()} -> "
        f"{probs.tolist()} (sum {float(probs.sum()):.7f})")
    if not (counts[1:][first > 0] > 0).all():
        raise AssertionError(f"a rehearsal family with p > 0 finished no episode: {counts}")
    if abs(float(probs.sum()) - float(first.sum())) > 1e-6:
        raise AssertionError(f"the controller changed the budget: {probs.sum()} vs {first.sum()}")
    unmeasured = counts[1:] < 8
    if (probs[unmeasured] != first[unmeasured]).any() or (probs == first).all():
        raise AssertionError(f"the tick did not reweight (only) the measured families: {probs}")
    # the resumed update appended the last row
    last = np.array([plr_rows[PLR_UPDATES - 1][f"rehearsal/p_{n}"]
                     for n in FAMILY_NAMES[1:]], np.float32)
    if len(plr_rows) != PLR_UPDATES + 1 or (last != probs).any():
        raise AssertionError("the rehearsal/p_* rows do not hold the controller's probabilities")

    # the resume restored the PLR fields and counted on
    res = states["finetune_plr_resume"]
    if (saved.rehearsal_probs.cpu().numpy() != probs).any() or (
            saved.family_counts.cpu().numpy() != counts).any():
        raise AssertionError("the checkpoint did not carry the PLR fields")
    if not (res.family_counts.cpu().numpy() >= counts).all():
        raise AssertionError("the resumed run lost family counts")
    log(f"  finetune_plr_resume: restored probabilities and counts equal the saved ones; "
        f"family episodes now {res.family_counts.cpu().numpy().tolist()}")
    kernel_row["launches_by_path"]["finetune"] = sum(launches.values())
    return launches


def _episode_errors(got, want) -> dict:
    """Scaled differences of two EpisodeResults' float fields."""
    errs = {}
    for k, scale in (("ape", None), ("total_reward", None), ("traj", 1300.0),
                     ("angles", math.pi)):
        g, w = np.asarray(getattr(got, k), np.float64), np.asarray(getattr(want, k), np.float64)
        errs[k] = float(np.abs(g - w).max() / (scale or max(1.0, np.abs(w).max())))
    return errs


def phase_eval_reference():
    """The eval runner on the card against the CPU from identical inputs
    (CPU-made reset states and noise, agent_s8004, stochastic policy, a
    64-step cap), in one spatial and one stage scenario: latched flags and
    lengths equal, APE, return, trajectory and angles to 1e-4 of scale, as
    tests/test_torch_eval.py holds the port against the JAX package.  A
    quarter of the episodes start 5 px from their target (a reach-end on
    the first step) and a quarter, where they have one, on their first
    obstacle's center (a collision), so that the latch sees every end; in
    parallel_boxes that center is a box's, so the box geometry ends them."""
    n, cap = 512, 64
    for scen in ("S_corridor", "stage_5", "parallel_boxes"):
        cfg = scenario_config(scen).replace(n_steps=cap)
        gen = torch.Generator().manual_seed(7)
        state, obs = Drone2DEnv(cfg, device="cpu").reset_batch(gen, n)
        i = torch.arange(n)
        near, hit = i % 4 == 0, (i % 4 == 1) & state.obstacles.mask[:, 0]
        pos = torch.where(near[:, None], state.target + 5.0, state.body.pos)
        pos = torch.where(hit[:, None], state.obstacles.xy[:, 0], pos)
        state = dataclasses.replace(state, body=dataclasses.replace(state.body, pos=pos))
        noise = torch.randn((cap, n, 2), generator=gen)
        out = {}
        for dev in ("cpu", "cuda"):
            out[dev] = run_episodes_from(Drone2DEnv(cfg, device=dev), load_agent(dev),
                                         _to(state, dev), obs.to(dev), noise.to(dev))
        got, want = out["cuda"], out["cpu"]
        for k in ("success", "fail", "collision", "time_steps", "traj_len"):
            if not np.array_equal(getattr(got, k), getattr(want, k)):
                raise AssertionError(f"eval {scen}: {k} differs between the card and the CPU")
        errs = _episode_errors(got, want)
        log(f"eval on the card vs the CPU, {scen}, {n} episodes x {cap} steps: latched flags and "
            f"lengths equal ({int(want.success.sum())} successes, {int(want.collision.sum())} "
            f"collisions, {int(want.fail.sum())} fails); "
            f"scaled errors " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
        if max(errs.values()) > 1e-4 or not (want.success.any() and want.collision.any()):
            raise AssertionError(f"eval {scen}: the card and the CPU disagree, or an end is "
                                 f"missing: {errs}")


def phase_eval_breakdown():
    """Where a campaign step's time goes, in the corridor scenario at
    B=EVAL_EPISODES: host ms a step over 64 steps of the stochastic runner,
    eager and captured in turn (synchronized, the results' copy to the host
    included, the capture made before), and the device's busy share, ops
    and host launches a step under the profiler over 8 steps of each."""
    params = load_agent("cuda")
    step_ms, busy = {}, {}
    for cap in (64, 8):
        cfg = scenario_config("corridor").replace(n_steps=cap)
        env = Drone2DEnv(cfg)
        gen = torch.Generator(device="cuda").manual_seed(1)
        state, obs = env.reset_batch(gen, EVAL_EPISODES)
        noise = torch.randn((cap, EVAL_EPISODES, 2), generator=gen, device="cuda")
        run_episodes_from(env, params, state, obs, noise)  # the capture
        for captured in ((False, True, True, False) if cap == 64 else (False, True)):
            label = "captured" if captured else "eager"
            if cap == 64:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run_episodes_from(env, params, state, obs, noise, captured=captured)
                step_ms.setdefault(label, []).append((time.perf_counter() - t0) * 1e3 / cap)
                continue
            events, host, dev_us, wall_us = launch_window(
                lambda: run_episodes_from(env, params, state, obs, noise, captured=captured))
            busy[label] = (f"{label}: device busy {dev_us / 1e3:.3f} ms of "
                           f"{wall_us / 1e3:.3f} ms wall ({100 * dev_us / wall_us:.1f}%), "
                           f"{len(events) / 8:.0f} device ops and {len(host) / 8:.1f} host "
                           f"launches a step" if events
                           else f"{label}: device time not measured (no device events)")
    log(f"eval step at B={EVAL_EPISODES} (corridor; host clock, 64 steps, synchronized, "
        f"in turn): " + ", ".join(
            f"{k} {min(v):.3f} ms a step ({', '.join(f'{x:.3f}' for x in v)})"
            for k, v in step_ms.items())
        + f"; profiler, 8 steps: {'; '.join(busy.values())}")


def _z(p1: float, p2: float, n1: int, n2: int) -> float:
    """Two-proportion z of success rates p1, p2 over n1, n2 episodes, with
    the pooled rate; 0 where both rates are 0 or both 1."""
    pool = (p1 * n1 + p2 * n2) / (n1 + n2)
    se = math.sqrt(pool * (1 - pool) * (1 / n1 + 1 / n2))
    return 0.0 if se == 0.0 else (p1 - p2) / se


def phase_campaign(kernel_row: dict):
    """The eval path: `evaluate` for agent_s8004 over CAMPAIGN_SCENARIOS,
    EVAL_EPISODES stochastic episodes each, writing the Tests/ schema into a
    temporary directory; each scenario's success rate against the committed
    campaign by |z| <= Z_MAX.  (All 12 scenarios fly in the stacked
    campaign.)"""
    with open(CAMPAIGN) as f:
        ref = {s["scenario"]: s for s in json.load(f)["scenarios"]}
    log(f"eval campaign: agent_s8004, {len(CAMPAIGN_SCENARIOS)} scenarios x {EVAL_EPISODES} "
        f"stochastic episodes, against {CAMPAIGN.relative_to(ROOT)} (|z| <= {Z_MAX}):")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_eval_") as d:
        torch.cuda.synchronize()
        fused_sample_action.launches = 0
        t_all = time.perf_counter()
        rows, bad = [], []
        for scen in CAMPAIGN_SCENARIOS:
            before = fused_sample_action.launches
            t0 = time.perf_counter()
            s = evaluate(str(AGENT), scen, EVAL_EPISODES, out_root=d)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            r = ref[scen]
            z = _z(s["success_rate"], r["success_rate"], EVAL_EPISODES, r["episodes"])
            n = fused_sample_action.launches - before
            rows.append(dict(scenario=scen, sr=s["success_rate"], ref_sr=r["success_rate"], z=z,
                             cr=s["collision_rate"], ape=s["avg_ape"],
                             flight_time=s["avg_flight_time"], seconds=dt, launches=n))
            log(f"  campaign {scen}: SR {s['success_rate']:.3f} (committed "
                f"{r['success_rate']:.3f}, z {z:+.2f}), CR {s['collision_rate']:.3f}, APE "
                f"{s['avg_ape']:.2f} ({r['avg_ape']:.2f}), flight time "
                f"{s['avg_flight_time']:.1f} ({r['avg_flight_time']:.1f}), {dt:.2f} s, "
                f"kernel launches {n}")
            if abs(z) > Z_MAX:
                bad.append(scen)
            files = ["flight_paths", "collisions.npy", "rewards.npy", "apes.npy",
                     "time_spent.npy", f"{scen}_new_agent_results.txt"]
            missing = [f for f in files if not Path(s["out_dir"], f).exists()]
            if missing:
                raise AssertionError(f"campaign {scen}: no {missing} in {s['out_dir']}")
        total = time.perf_counter() - t_all
        launches = fused_sample_action.launches
    mean_sr = statistics.mean(r["sr"] for r in rows)
    log(f"  campaign: {len(rows) * EVAL_EPISODES} episodes in {total:.2f} s, "
        f"{len(rows) * EVAL_EPISODES / total:.1f} episodes_per_s; mean SR {mean_sr:.4f} "
        f"(committed {statistics.mean(r['ref_sr'] for r in rows):.4f}); kernel launches "
        f"{launches}; the Tests/ schema files on disk for every scenario")
    if bad:
        raise AssertionError(f"campaign success rates off the committed ones: {bad}")
    if launches <= 0 or launches != sum(r["launches"] for r in rows):
        raise AssertionError(f"the campaign launched the kernel {launches} times")
    kernel_row["launches_by_path"]["eval"] = launches
    return rows


def phase_zoo(kernel_row: dict, sgd_row: dict):
    """The population path at the seed hunt's first checkpoint: `python -m
    drone2d_tpu_torch.scripts.sweep --preset flagship-scratch --vmap 8` over
    HUNT_SEEDS to the first snapshot of the JAX package's hunt 7 (143
    updates, 18,743,296 env steps a seed), with a snapshot after the first
    update, then `select_agents` over the 16 candidates and the 8 finals
    held against the record's 24 seeds at that checkpoint (`_hunt_in`).
    The record spans 0.146-0.612 there, so this gate catches only a gross
    failure to learn; the whole hunt (`README.md`, 8 seeds x 150M steps,
    every checkpoint) is the real check."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_zoo_") as d:
        _hunt_in(d, kernel_row, sgd_row, path=("zoo", "select"), preset="flagship-scratch",
                 seeds=HUNT_SEEDS, schedule=(HUNT_TIMESTEPS, dict(snapshots=HUNT_SNAPSHOTS)),
                 reference=hunt_check.REFERENCE, snapshot_first=True)


def phase_finetune_hunt(kernel_row: dict, sgd_row: dict):
    """The rehearsal fine-tune hunt's first checkpoint: `sweep --preset
    flagship-finetune --init-params artifacts/agent_s6006/new_agent.npz
    --vmap 8` over FT_HUNT_SEEDS to the first snapshot of the JAX package's
    hunt 8 (23 updates, 3,014,656 env steps a seed; every member warm-started
    from its own copy of agent_s6006, the fixed weighted stage mix drawn
    inside the captured population graph), no snapshot, then `select_agents
    --finals-only` over the 8 finals and `hunt_check.compare` against the
    record's 8 seeds at that checkpoint (`_hunt_in`).  Hunt 8's seeds sit at
    0.853-0.873 there, so a port that fine-tunes a few hundredths worse
    shows; the whole hunt (`README.md`, 8 seeds x 30M steps, every
    checkpoint, both selection RNGs) is the real check."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ft_hunt_") as d:
        _hunt_in(d, kernel_row, sgd_row, path=("finetune_hunt", "finetune_select"),
                 preset="flagship-finetune", seeds=FT_HUNT_SEEDS,
                 schedule=(FT_HUNT_TIMESTEPS, dict(snapshot_steps=FT_HUNT_SNAPSHOT_STEPS)),
                 reference=hunt_check.REFERENCE_H8, snapshot_first=False,
                 init_params=FINETUNE_AGENT)


def phase_sb3_shape(kernel_row: dict):
    """The reference's own training shape on the card: the population of the
    JAX package's SB3-shape hunt (SB3_SEEDS x SB3_ENVS envs, 2048-step
    rollouts, 448 minibatches of 64, exact, 64-64) through `update_jit`
    (`scripts/probe_update_capture`): one update at one epoch (the epoch
    graph is the same for any number) bit-equal to the eager `update` from
    a twin state, weights, Adam, metrics, envs, counters and generators;
    then the capture at the recipe's 10 epochs (the rollout's chunks, nodes,
    seconds, pool bytes, the host's peak resident set) and SB3_TIMED
    replayed updates, each with a finite loss.  The path's launches are the
    captured calls': `warmup_launches` + n_steps + 1 for a capturing call,
    n_steps + 1 for each replay; the eager reference's are counted apart."""
    T = SB3_PPO.n_steps
    torch.cuda.synchronize()
    fused_sample_action.launches = 0
    check = probe_update_capture.check_eager(SB3_PPO, SB3_ENVS, SB3_SEEDS)
    eager = check["update_launches"]
    m = probe_update_capture.measure(SB3_PPO, SB3_ENVS, SB3_SEEDS, updates=SB3_TIMED)
    torch.cuda.synchronize()
    launches = fused_sample_action.launches - eager
    capturing = warmup_launches(T) + T + 1
    want = 2 * capturing + SB3_TIMED * (T + 1)
    log(f"sb3_shape: {len(SB3_SEEDS)} seeds x {SB3_ENVS} envs x {T} steps, "
        f"{SB3_PPO.num_minibatches} x {SB3_PPO.n_epochs} SGD of "
        f"{SB3_ENVS * T // SB3_PPO.num_minibatches}, {SB3_PPO.shuffle}, "
        f"{'-'.join(map(str, SB3_PPO.hidden_sizes))}; rollout graphs of {m['chunks']} steps")
    log(f"  one update at 1 epoch: update_jit bit-equal to update {check['equal']}; "
        f"update_jit {check['update_jit_s']:.3f} s (its capture included), update "
        f"{check['update_s']:.3f} s")
    log(f"  capture at {SB3_PPO.n_epochs} epochs: nodes {m['nodes']} (head, chunks, tail, an SGD "
        f"epoch), warm-up {m['warmup_s']:.3f} s, recording {m['recording_s']:.3f} s, "
        f"instantiation {m['instantiation_s']:.3f} s, pool {m['pool_bytes'] / 2**20:.1f} MiB, "
        f"host peak resident {m['peak_rss_mib_before']:.0f} -> {m['peak_rss_mib_after']:.0f} "
        f"MiB; the capturing call {m['capturing_call_s']:.3f} s")
    log(f"  replayed updates: {[round(x, 4) for x in m['replay_s']]} s "
        f"({len(SB3_SEEDS) * SB3_ENVS * T / statistics.median(m['replay_s']):.1f} env steps a "
        f"second for the population), loss {m['loss']:.4f}; kernel launches {launches} (want "
        f"{want}), and {eager} of the eager reference; card {card_line()}")
    if not all(check["equal"].values()) or launches != want or not math.isfinite(m["loss"]):
        raise AssertionError(f"sb3_shape: {check['equal']}, launches {launches} (want {want}), "
                             f"loss {m['loss']}")
    kernel_row["launches_by_path"]["sb3_shape"] = launches


def _run_cli(main_fn, argv) -> str:
    """Run a CLI's main in this process; echo and return what it printed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main_fn(argv)
    for line in buf.getvalue().splitlines():
        log(f"  | {line}")
    return buf.getvalue()


def _hunt_in(d: str, kernel_row: dict, sgd_row: dict, *, path, preset, seeds, schedule, reference,
             snapshot_first, init_params=None):
    """A hunt's first checkpoint in `d`: `sweep --preset PRESET --vmap S` over
    `seeds` to the first snapshot of `schedule` ((total timesteps,
    `snapshot_schedule`'s keywords): the JAX package's hunt at `reference`,
    so the finals are that checkpoint), warm-started
    from `init_params` if given, with a snapshot after the first update if
    `snapshot_first` (else none): one kernel launch a rollout step for all
    S seeds ((updates + 1) x (n_steps + 1) launches, the capture's warm-up
    included) and three SGD kernel launches a minibatch step (the warm-up's
    one epoch included: 3 x minibatches x (epochs x updates + 1)), a finite
    loss, the seed_<s>/ files, members whose weights
    are finite and pairwise different (and moved from the warm start); then
    `select_agents` over the candidates (the finals alone without the first
    snapshot) on the 12 scenarios x SELECT_EPISODES, each path with the
    kernel count set to 0 just before it and read just after
    (`launches_by_path` keys `path`); then `hunt_check.compare` of the
    finals' 12-scenario mean success rates against the record's seeds at
    that checkpoint, at p >= HUNT_ALPHA."""
    t_phase = time.perf_counter()
    name, select_name = path
    _, train_cfg, _, ppo_cfg = parse_args(["--preset", preset])
    spu = ppo_cfg.n_steps * train_cfg.num_envs
    updates = min(snapshot_schedule(schedule[0], spu, **schedule[1])[1])
    checkpoint = str(updates * spu)
    argv = ["--preset", preset, "--vmap", str(len(seeds)), "--seeds", *map(str, seeds),
            "--total-timesteps", checkpoint, "--no-eval", "--out", d]
    argv += ["--snapshot-steps", str(spu)] if snapshot_first else ["--snapshots", "0"]
    if init_params is not None:
        argv += ["--init-params", str(init_params)]
    log(f"{name}: python -m drone2d_tpu_torch.scripts.sweep {' '.join(argv)}")
    torch.cuda.synchronize()
    fused_sample_action.launches = ppo_sgd_step.launches = 0
    t0 = time.perf_counter()
    text = _run_cli(sweep.main, argv)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches, sgd_launches = fused_sample_action.launches, ppo_sgd_step.launches
    log(f"  {name}: {len(seeds)} seeds x {updates} updates in {dt:.2f} s (setup, "
        f"capture and snapshots included), kernel launches {launches} "
        f"({launches / (updates + WARMUPS):.0f} a population update, the capture's "
        f"warm-up included)")
    if launches != (updates + WARMUPS) * (ppo_cfg.n_steps + 1):
        raise AssertionError(f"{name}: fused_sample_action launched {launches} times, want "
                             f"({updates} + {WARMUPS}) x {ppo_cfg.n_steps + 1}")
    want_sgd = 3 * ppo_cfg.num_minibatches * (ppo_cfg.n_epochs * updates + 1)
    log(f"  {name}: SGD kernel launches {sgd_launches} (want {want_sgd})")
    if sgd_launches != want_sgd:
        raise AssertionError(f"{name}: ppo_sgd_step launched {sgd_launches} times, "
                             f"want {want_sgd}")
    sgd_row["launches_by_path"][name] = sgd_launches
    m = re.search(rf"update {updates}/{updates} .*loss\s+(\S+)", text)
    if not m or not math.isfinite(float(m.group(1))):
        raise AssertionError(f"{name}: no finite loss in the last update's line")
    if init_params is not None and f"warm-started {len(seeds)} members from" not in text:
        raise AssertionError(f"{name}: the sweep did not warm-start from {init_params}")
    want_files = ([f"ckpt_{spu}.npz"] if snapshot_first else []) + ["new_agent.npz"]
    finals = []
    for s in seeds:
        files = sorted(p.name for p in Path(d, f"seed_{s}").iterdir())
        if files != want_files:
            raise AssertionError(f"{name}: seed_{s} holds {files}")
        finals.append(dict(np.load(Path(d, f"seed_{s}", "new_agent.npz"))))
    if not all(np.isfinite(v).all() for f in finals for v in f.values()):
        raise AssertionError(f"{name}: non-finite weights")
    same = [(i, j) for i in range(len(finals)) for j in range(i)
            if np.array_equal(finals[i]["pi0/w"], finals[j]["pi0/w"])]
    if init_params is not None:
        start = dict(np.load(init_params))["pi0/w"]
        same += [(i, "start") for i, f in enumerate(finals) if np.array_equal(f["pi0/w"], start)]
    if same:
        raise AssertionError(f"{name}: members with equal weights {same}")
    log(f"  seed_<s>/{' and '.join(want_files)} for all {len(seeds)} seeds; the members' "
        f"weights are finite and pairwise different"
        + ("" if init_params is None else f", each moved from {Path(init_params).parent.name}'s"))
    kernel_row["launches_by_path"][name] = launches

    sel = [str(Path(d, f"seed_{s}")) for s in seeds] + [
        "--episodes", str(SELECT_EPISODES), "--seed", str(SELECT_SEED),
        "--out", f"{d}/select.json"] + ([] if snapshot_first else ["--finals-only"])
    log(f"selection: python -m drone2d_tpu_torch.scripts.select_agents {' '.join(sel)}")
    torch.cuda.synchronize()
    fused_sample_action.launches = 0
    t0 = time.perf_counter()
    _run_cli(select_agents.main, sel)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    with open(f"{d}/select.json") as f:
        table = json.load(f)
    if len(table) != len(want_files) * len(seeds) or any(
            set(per) != set(ALL_SCENARIOS) for per in table.values()):
        raise AssertionError(f"selection: {len(table)} candidates in the summary")
    log(f"  selection: {len(table)} candidates x {len(ALL_SCENARIOS)} scenarios x "
        f"{SELECT_EPISODES} episodes in {dt:.2f} s, kernel launches "
        f"{fused_sample_action.launches}")
    if fused_sample_action.launches <= 0:
        raise AssertionError("selection launched no kernel")
    kernel_row["launches_by_path"][select_name] = fused_sample_action.launches

    # the finals are the hunt's first checkpoint: held against the record's
    with open(reference) as f:
        ref_table = hunt_check.seed_table(json.load(f))
    port_table = {checkpoint: hunt_check.seed_table(table)["final"]}
    result = hunt_check.compare(port_table, ref_table, [checkpoint], HUNT_ALPHA)
    for line in hunt_check.format_report(result).splitlines():
        log(f"  | {line}")
    r = result["rows"][0]
    ref_name = hunt_check.reference_name(reference)
    log(f"  hunt's first checkpoint ({checkpoint} env steps a seed): the port's "
        f"{r['port']['n']} seeds' median mean SR {r['port']['median']:.4f} against "
        f"{ref_name} {r['reference']['median']:.4f} ({r['reference']['n']} seeds), "
        f"Mann-Whitney U {r['u']:.1f}, two-sided p {r['p']:.5f} (gate p >= {HUNT_ALPHA}); "
        f"cover-12 {hunt_check.cover_count(table)} of {len(table)}; "
        f"{time.perf_counter() - t_phase:.1f} s for the phase")
    if not result["ok"]:
        raise AssertionError(f"{name}: the hunt's first checkpoint differs from {ref_name}: "
                             f"p {r['p']:.5f} < {HUNT_ALPHA}")


def phase_precision(kernel_row: dict):
    """Stacked eval parity through `scripts/precision_campaign`: s8004 and
    s22307 as one stack over the 12 scenarios x PRECISION_EPISODES episodes
    (one chunk each, one kernel launch a step for both), each scenario's
    success rate against its committed campaign (each file's own episodes)
    by |z| <= Z_MAX.  The report then goes through `package_agent`'s n1000
    conversion for s8004: the committed file's keys, and its rows the
    report's."""
    names = ("s8004", "s22307")
    paths = [str(ROOT / "artifacts" / f"agent_{a}" / "new_agent.npz") for a in names]
    refs = {}
    for a in names:
        with open(ROOT / "artifacts" / f"agent_{a}" / "campaign_n1000_summary.json") as f:
            refs[a] = json.load(f)
    log(f"precision campaign: {' + '.join(names)}, {len(ALL_SCENARIOS)} scenarios x "
        f"{PRECISION_EPISODES} stochastic episodes each (seed {PRECISION_SEED}, one chunk), "
        f"one batch of {len(names) * PRECISION_EPISODES}, against the committed campaigns "
        f"(|z| <= {Z_MAX}):")
    torch.cuda.synchronize()
    fused_sample_action.launches = 0
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        doc = precision_campaign.run(paths, ALL_SCENARIOS, episodes=PRECISION_EPISODES,
                                     chunk=PRECISION_EPISODES, seed=PRECISION_SEED)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = fused_sample_action.launches
    for line in buf.getvalue().splitlines():
        log(f"  | {line}")
    labels = list(doc["agents"])
    bad = []
    for a, lab in zip(names, labels):
        ref = {r["scenario"]: r for r in refs[a]["scenarios"]}
        zs = []
        for scen, r in doc["agents"][lab].items():
            z = _z(r["success_rate"], ref[scen]["success_rate"], r["episodes"],
                   ref[scen]["episodes"])
            zs.append(z)
            if abs(z) > Z_MAX:
                bad.append((a, scen))
            log(f"  precision {a} {scen}: SR {r['success_rate']:.4f} ({r['successes']}/"
                f"{r['episodes']}; committed {ref[scen]['success_rate']:.4f}, n "
                f"{ref[scen]['episodes']}, z {z:+.2f}), APE {r['avg_ape']:.2f} "
                f"({ref[scen]['avg_ape']:.2f})")
        rows = doc["agents"][lab].values()
        log(f"  {a}: mean SR {statistics.mean(r['success_rate'] for r in rows):.4f} "
            f"(committed {refs[a]['mean_success_rate']:.4f}), largest |z| "
            f"{max(abs(z) for z in zs):.2f}")
    episodes = len(names) * len(ALL_SCENARIOS) * PRECISION_EPISODES
    log(f"  precision campaign: {episodes} episodes in {total:.2f} s, "
        f"{episodes / total:.1f} episodes_per_s; kernel launches {launches}")
    if bad:
        raise AssertionError(f"precision campaign success rates off the committed ones: {bad}")
    if launches <= 0:
        raise AssertionError("the precision campaign launched no kernel")

    summary = package_agent.n1000_doc(doc, paths[0], seed=8004, note="chip smoke")
    if list(summary) != list(refs["s8004"]):
        raise AssertionError(f"n1000 summary keys {list(summary)}, committed "
                             f"{list(refs['s8004'])}")
    for row in summary["scenarios"]:
        r = doc["agents"][labels[0]][row["scenario"]]
        want = dict(scenario=row["scenario"], episodes=r["episodes"],
                    success_rate=r["success_rate"], sr_stderr=round(r["sr_stderr"], 4),
                    collision_rate=r["collision_rate"], avg_ape=r["avg_ape"],
                    avg_flight_time=r["avg_flight_time"])
        if row != want or list(row) != list(refs["s8004"]["scenarios"][0]):
            raise AssertionError(f"n1000 row {row} is not the report's {want}")
    log(f"  package_agent --n1000 of s8004: the committed keys, {len(summary['scenarios'])} rows "
        f"equal to the report's; coverage {summary['published_coverage']}/12, mean "
        f"{summary['mean_success_rate']}")
    kernel_row["launches_by_path"]["precision"] = launches


def _against_conformance(report, agent: str, scen: str, sr: float, n: int, compared: dict,
                         bad: list) -> list:
    """`agent`'s success rate `sr` over `n` episodes of `scen` against its
    rows of the conformance report by |z| <= Z_MAX: the JAX package's pooled
    seeds 0 and 777 (100 episodes each) on every row, the reference's own
    where the row has one.  Counts the comparisons in `compared`, appends
    the failures to `bad`, and returns a text a row."""
    texts = []
    for row in (r for r in report[agent]["rows"] if r["scenario"] == scen):
        ours = statistics.mean(o["success_rate"] for o in row["ours"])
        z_ours = _z(sr, ours, n, 100 * len(row["ours"]))
        text = f"{row['label']} {agent}: SR {sr:.3f} (JAX {ours:.3f}, z {z_ours:+.2f}"
        compared["ours"] += 1
        if abs(z_ours) > Z_MAX:
            bad.append((agent, row["label"], "JAX"))
        if row["ref"]:
            ref = row["ref"]
            ref_n = ref["successes"] + ref["fails"]
            z_ref = _z(sr, ref["success_rate"], n, ref_n)
            text += f"; reference {ref['success_rate']:.3f}, n {ref_n}, z {z_ref:+.2f}"
            compared["ref"] += 1
            if abs(z_ref) > Z_MAX:
                bad.append((agent, row["label"], "reference"))
        texts.append(text + ")")
    return texts


def phase_imported_campaign(kernel_row: dict):
    """The four imported reference agents (64-64, so the kernel runs at
    H=64) as one stacked campaign of IMPORTED_SCENARIOS x IMPORTED_EPISODES
    episodes each, held by |z| <= Z_MAX against the reference's own row of
    `artifacts/conformance/report.json` (n = 100) wherever it has one, and
    against the JAX package's pooled rows (seeds 0 and 777, n = 200) on
    every row."""
    with open(CONFORMANCE) as f:
        report = json.load(f)["agents"]
    stack = stack_params([imported_agent(a, "cuda") for a in IMPORTED])
    log(f"imported agents' stacked campaign: {', '.join(IMPORTED)}, "
        f"{len(IMPORTED_SCENARIOS)} "
        f"scenarios x {IMPORTED_EPISODES} episodes each, one batch of "
        f"{len(IMPORTED) * IMPORTED_EPISODES}, against {CONFORMANCE.relative_to(ROOT)} "
        f"(|z| <= {Z_MAX}):")
    torch.cuda.synchronize()
    fused_sample_action.launches = 0
    t_all = time.perf_counter()
    bad, compared = [], {"ref": 0, "ours": 0}
    for scen in IMPORTED_SCENARIOS:
        before = fused_sample_action.launches
        t0 = time.perf_counter()
        res = run_episodes_multi(scenario_config(scen), stack, 0, IMPORTED_EPISODES)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n = np.maximum(res.success.sum(1) + res.fail.sum(1), 1)
        sr = res.success.sum(1) / n
        parts = []
        for i, a in enumerate(IMPORTED):
            parts += _against_conformance(report, a, scen, float(sr[i]), IMPORTED_EPISODES,
                                          compared, bad)
        log(f"  imported {scen} ({dt:.2f} s, kernel launches "
            f"{fused_sample_action.launches - before}): " + "; ".join(parts))
    total = time.perf_counter() - t_all
    launches = fused_sample_action.launches
    log(f"  imported campaign: {len(IMPORTED) * len(IMPORTED_SCENARIOS) * IMPORTED_EPISODES} "
        f"episodes in {total:.2f} s; {compared['ref']} rows against the reference, "
        f"{compared['ours']} against the JAX package; kernel launches {launches}")
    if bad:
        raise AssertionError(f"imported agents off the conformance rows: {bad}")
    kernel_row["launches_by_path"]["imported_eval"] = launches


def _synced(fn):
    """Host ms of fn(), synchronized before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


# the closest point's bearing (obs columns 25-26) turns a shift of the
# closest point by d px by d / |cp - pos| radians, large where the drone
# sits on the path: those columns get that conditioning on top of the 1e-4
# (CP_SHIFT_PX of shift, the bound tests/test_torch_env.py holds the port
# to against the JAX package)
CP_SHIFT_PX = 0.1


def _check_equal_steps(label, got, want):
    """Vector-env step outputs (obs, reward, terminated, truncated, info) of
    the card against the CPU's: flags exact, floats to 1e-4 of scale, the
    bearing columns 25-26 with their conditioning (CP_SHIFT_PX)."""
    obs, wobs = np.asarray(got[0], np.float64), np.asarray(want[0], np.float64)
    errs = {"obs": scaled_err(torch.as_tensor(obs[:, :25]), torch.as_tensor(wobs[:, :25])),
            "reward": scaled_err(torch.as_tensor(got[1]), torch.as_tensor(want[1]))}
    half_w, half_h = EnvConfig().screensize_x / 2, EnvConfig().screensize_y / 2  # obs -> px
    dist = np.hypot((wobs[:, 19] - wobs[:, 6]) * half_w, (wobs[:, 20] - wobs[:, 7]) * half_h)
    allowed = 1e-4 + CP_SHIFT_PX / np.maximum(dist, 1e-6)
    errs["bearing / allowed"] = float((np.abs(obs[:, 25:27] - wobs[:, 25:27])
                                       / allowed[:, None]).max() * 1e-4)
    for k, g, w in zip(("terminated", "truncated"), got[2:4], want[2:4]):
        if not np.array_equal(g, w):
            raise AssertionError(f"{label}: {k} differs between the card and the CPU")
    if max(errs.values()) > 1e-4:
        raise AssertionError(f"{label}: the card and the CPU disagree: {errs}")
    return errs


def _eager_device_step(env):
    """Have `env` (a VectorEnvCore or a Drone2dGymEnv) run the device part
    of its steps eagerly, as it did before it was captured: the core's
    `device_step`, the gym env's `Drone2DEnv.step` of the batch of one.  The
    rest of `step` (the draws, the host copy) stays as it is.  The
    reference the captured step is timed and checked against."""
    if isinstance(env, VectorEnvCore):
        def step(tree):
            state, prev_done, action, templates = tree
            new, obs, reward, terminated, truncated, info = env.device_step(
                state, prev_done, action, *templates)
            return ((obs, reward, terminated, truncated, prev_done, info),
                    (new, terminated | truncated, action, templates))
    else:
        def step(tree):
            state, action = tree
            out = env._env.step(state, action.clamp(-1.0, 1.0))
            return (out.obs, out.done, out.info), (out.state, action)
    env._step = step
    return env


def phase_compat(kernel_row: dict):
    """The reference's own surface on the card.  (1) An SB3 zip written from
    agent_17_90.npz imports onto the card with every leaf bit-equal, and
    the kernel's mean and value at B=VEC_ENVS match `torch_policy_value`.
    (2) The vector env core: VEC_ENVS curriculum envs at stage 5 driven by
    agent_s8004 through `sample_action` for VEC_STEPS steps, templates every
    VEC_REFRESH; one kernel launch a step; the NEXT_STEP rule on the rows
    that end; env steps a second with the host copies against the same
    steps kept on the card; the run twice with the device step captured
    (the main path: a CUDA graph) and twice eager (`_eager_device_step`),
    in turn, their steps a second and last obs bit-equal; then
    VEC_CHECK_STEPS steps of the core on the card against the CPU from
    CPU-made state, templates and actions.  (3) Drone2dGymEnv at B=1,
    GYM_STEPS steps of agent_17_90 through the kernel, captured and eager
    in turn as the vector env.  (4) The graft entry's step as one graph
    (`graft.GraftStep`: `sample_action` + `step_batch`, the noise and a
    whole reset batch drawn inside it) at GRAFT_ENVS envs for GRAFT_STEPS
    steps, every ended env restarting at t = 0 on a fresh path of its own;
    then GRAFT_CHECK_STEPS steps bit-equal to the eager step from a twin
    generator, one replay with every wait for the card refused, and ms a
    step captured, eager and of `step_batch_template`, in turn.  (5) The initial throw: the reset at NUM_ENVS
    envs on the card, and `_initial_motion` on the card against the CPU
    from the same body and draws."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(21)

    # (1) SB3 import
    flat = dict(np.load(IMPORTED_17))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sb3_") as d:
        path = f"{d}/PFCA_see_3_obs_17_90.zip"
        save_sb3_zip(flat, path)
        sd = load_sb3_state_dict(path)
        agent17 = load_sb3_agent(path)
    leaves = params_to_flat_dict(agent17)
    same = sorted(leaves) == sorted(flat) and all(np.array_equal(leaves[k], v)
                                                  for k, v in flat.items())
    obs = torch.randn(VEC_ENVS, 27, generator=gen, device=dev)
    mean, _, value = fused_sample_action(agent17, obs, torch.zeros(VEC_ENVS, 2, device=dev))
    mean_ref, value_ref = torch_policy_value(sd, obs.cpu().numpy())
    errs = {"mean": scaled_err(mean.cpu(), torch.as_tensor(mean_ref)),
            "value": scaled_err(value.cpu(), torch.as_tensor(value_ref))}
    log(f"sb3 import onto the card ({path.rsplit('/', 1)[1]} from {IMPORTED_17.name}): leaves "
        f"bit-equal to the .npz: {same}; kernel at B={VEC_ENVS} against torch_policy_value, "
        f"scaled errors " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    if not same or max(errs.values()) > TOL:
        raise AssertionError(f"sb3 import: leaves equal {same}, errors {errs}")

    # (2) the vector env core, driven by the flagship through the kernel,
    # its device step captured (the main path) and eager, in turn
    params = load_agent(dev)

    def drive_vector(captured: bool):
        core = VectorEnvCore(VEC_ENVS, seed=3, global_step=int(START_STEP),
                             template_refresh_steps=VEC_REFRESH)
        if not captured:
            _eager_device_step(core)
        obs_np, _ = core.reset()
        g = torch.Generator(device=dev).manual_seed(22)
        torch.cuda.synchronize()
        before = fused_sample_action.launches
        t0 = time.perf_counter()
        pending, checked, ended = np.zeros(0, np.int64), 0, 0
        for t in range(VEC_STEPS):
            with torch.no_grad():
                a = params.sample_action(torch.as_tensor(obs_np, device=dev), g)[0]
            obs_np, reward, terminated, truncated, infos = core.step(
                a.clamp(-1, 1).cpu().numpy())
            if len(pending):  # the rows that ended on the last step reset now
                tmpl_obs = core._templates[1][pending].cpu().numpy()
                if ((reward[pending] != 0).any() or (terminated | truncated)[pending].any()
                        or not np.array_equal(obs_np[pending], tmpl_obs)
                        or infos["_APE"][pending].any()):
                    raise AssertionError(f"vector env step {t}: the NEXT_STEP reset rows are "
                                         f"wrong")
                checked += len(pending)
            pending = np.flatnonzero(terminated | truncated)
            ended += len(pending)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0, fused_sample_action.launches - before, ended, checked,
                obs_np, core)

    fused_sample_action.launches = 0
    runs = {True: [], False: []}
    for captured in (True, False, True, False):  # in turn
        runs[captured].append(drive_vector(captured))
    dt, launches, ended, checked, obs_np, core = runs[True][0]
    same = all(np.array_equal(r[4], runs[False][0][4]) for r in runs[True] + runs[False])
    vec_rate = {k: [VEC_ENVS * VEC_STEPS / r[0] for r in v] for k, v in runs.items()}
    # the same steps kept on the card: the policy and the template step
    state, tmpl = core._state, core._templates
    obs_d = torch.as_tensor(obs_np, device=dev)

    def on_card():
        with torch.no_grad():
            act = params.sample_action(obs_d, gen)[0].clamp(-1, 1)
            core._env.step_batch_template(state, act, *tmpl)

    card_ms = statistics.median(_synced(on_card) for _ in range(11))
    log(f"vector env core: {VEC_ENVS} envs at stage 5 x {VEC_STEPS} steps (templates every "
        f"{VEC_REFRESH}), agent_s8004 through sample_action, the device step captured: "
        f"{dt:.3f} s, {VEC_ENVS * VEC_STEPS / dt:.1f} env steps a second with the host copies "
        f"({1e3 * dt / VEC_STEPS:.3f} ms a step) against {card_ms:.3f} ms a step kept on the "
        f"card (host clock, synchronized, median of 11); {ended} ends, the next step of "
        f"{checked} reset rows checked (reward 0, not done, the template's obs, info masked); "
        f"kernel launches {launches}")
    log(f"  vector env steps a second, captured vs eager device step, in turn (captured, "
        f"eager, captured, eager): captured {[round(x, 1) for x in vec_rate[True]]}, eager "
        f"{[round(x, 1) for x in vec_rate[False]]} ({max(vec_rate[True]) / max(vec_rate[False]):.2f}x"
        f" best to best); the four runs' last obs bit-equal: {same}")
    if launches != VEC_STEPS or checked == 0 or not same:
        raise AssertionError(f"vector env: {launches} launches, {checked} reset rows checked, "
                             f"captured and eager runs equal {same}")

    # the core on the card against the CPU from the same CPU-made inputs
    cpu_env = Drone2DEnv(EnvConfig(), device="cpu")
    g = torch.Generator().manual_seed(8)
    start, _ = cpu_env.reset_batch(g, VEC_ENVS, START_STEP)
    templates = cpu_env.reset_batch(g, VEC_ENVS, START_STEP)
    actions = torch.randn((VEC_CHECK_STEPS, VEC_ENVS, 2), generator=g).clamp(-1, 1).numpy()
    runs = {}
    for d in ("cpu", "cuda"):
        c = VectorEnvCore(VEC_ENVS, global_step=int(START_STEP), device=d,
                          template_refresh_steps=10**9)
        c.start_from(_to(start, d), (_to(templates[0], d), templates[1].to(d)))
        runs[d] = [c.step(a) for a in actions]
    worst = {"obs": 0.0, "reward": 0.0, "bearing / allowed": 0.0}
    for got, want in zip(runs["cuda"], runs["cpu"]):
        for k, v in _check_equal_steps("vector env", got, want).items():
            worst[k] = max(worst[k], v)
    ends = sum(int((w[2] | w[3]).sum()) for w in runs["cpu"])
    log(f"  vector env on the card vs the CPU, {VEC_ENVS} envs x {VEC_CHECK_STEPS} steps from "
        f"CPU-made state, templates and actions: terminated and truncated equal ({ends} ends); "
        f"scaled errors (obs: columns 0-24; bearing 25-26 as a share of its bound x 1e-4) "
        + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()))
    if ends == 0:
        raise AssertionError("vector env check: no env ended")

    # (3) the single gym env, B = 1, its device step captured (the main
    # path) and eager, in turn
    def drive_gym(captured: bool):
        env = make_gym_env("corridor", seed=4)
        if not captured:
            _eager_device_step(env)
        obs_np = env.reset()
        g = torch.Generator(device=dev).manual_seed(23)
        before = fused_sample_action.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        episodes = 0
        for _ in range(GYM_STEPS):
            with torch.no_grad():
                a = agent17.sample_action(torch.as_tensor(obs_np, device=dev)[None], g)[0]
            obs_np, reward, done, info = env.step(a[0].clamp(-1, 1).cpu().numpy())
            if done:
                episodes += 1
                obs_np = env.reset()
        return time.perf_counter() - t0, fused_sample_action.launches - before, episodes, obs_np

    fused_sample_action.launches = 0
    gyms = {True: [], False: []}
    for captured in (True, False, True, False):  # in turn
        gyms[captured].append(drive_gym(captured))
    dt, gym_launches, episodes, obs_np = gyms[True][0]
    gym_same = all(np.array_equal(r[3], gyms[False][0][3]) for r in gyms[True] + gyms[False])
    gym_rate = {k: [GYM_STEPS / r[0] for r in v] for k, v in gyms.items()}
    log(f"gym env (Drone2dGymEnv, corridor) at B=1, agent_17_90 through sample_action, the "
        f"device step captured: {GYM_STEPS} steps in {dt:.3f} s, {GYM_STEPS / dt:.1f} steps a "
        f"second, {episodes} episodes ended; kernel launches {gym_launches}")
    log(f"  gym env steps a second, captured vs eager device step, in turn: captured "
        f"{[round(x, 1) for x in gym_rate[True]]}, eager {[round(x, 1) for x in gym_rate[False]]}"
        f" ({max(gym_rate[True]) / max(gym_rate[False]):.2f}x best to best); the four runs' "
        f"last obs bit-equal: {gym_same}")
    if gym_launches != GYM_STEPS or not np.isfinite(obs_np).all() or not gym_same:
        raise AssertionError(f"gym env: {gym_launches} launches, captured and eager runs "
                             f"equal {gym_same}")

    # (4) the graft entry's step as one graph (`graft.GraftStep`: the noise
    # and a whole reset batch drawn inside it each step, the fresh draw per
    # reset), at its shapes (a fresh 128-128 actor-critic, curriculum stage
    # 1), whose random thrusts end episodes within tens of steps
    env, graft_params = Drone2DEnv(EnvConfig()), graft_agent(dev)
    start = env.reset_batch(gen, GRAFT_ENVS, 0.0)
    fused_sample_action.launches = 0
    step = GraftStep(graft_params, env, torch.Generator(device=dev).manual_seed(GRAFT_SEED))
    state, obs = start
    restarted = 0
    for _ in range(GRAFT_STEPS):
        first = state.path.wps[:, 0].clone()  # the step writes its static state in place
        state, obs, _, done, _ = step(state, obs)
        if bool(done.any()):
            new = state.path.wps[done, 0]
            if (bool((state.t[done] != 0).any()) or bool((new == first[done]).all(1).any())
                    or len(torch.unique(new, dim=0)) != int(done.sum())):
                raise AssertionError("graft step: an ended env did not restart on a fresh path")
            restarted += int(done.sum())
    graft_launches = fused_sample_action.launches
    # the captured step against the eager one from twin generators, step by
    # step, then one replay with every wait for the card refused
    g1 = torch.Generator(device=dev).manual_seed(GRAFT_SEED + 1)
    g2 = torch.Generator(device=dev).manual_seed(GRAFT_SEED + 1)
    captured_step = GraftStep(graft_params, env, g1)
    a = b = start
    graft_same = True
    for _ in range(GRAFT_CHECK_STEPS):
        got = captured_step(*a)
        want = graft_step(graft_params, env, *b, g2, 0.0)
        graft_same &= all((x is None and y is None) or torch.equal(x, y)
                          for x, y in zip(graphs.leaves(got), graphs.leaves(want)))
        a, b = got[:2], want[:2]
    graft_same = bool(graft_same and torch.equal(g1.get_state(), g2.get_state()))
    with no_host_sync():
        captured_step(*a)
    events, host, _, _ = launch_window(lambda: captured_step(*a))
    state, obs = b
    tmpl = env.reset_batch(gen, GRAFT_ENVS, 0.0)
    a_clip = graft_params.sample_action(obs, gen)[0].clamp(-1, 1)
    times = {"captured": [], "step_batch": [], "step_batch_template": []}
    for _ in range(11):  # in turn, so that the host's drift falls on all three
        times["captured"].append(_synced(lambda: captured_step(state, obs)))
        times["step_batch"].append(_synced(lambda: graft_step(graft_params, env, state, obs, g2,
                                                              0.0)))
        times["step_batch_template"].append(
            _synced(lambda: env.step_batch_template(state, a_clip, *tmpl)))
    ms = {k: statistics.median(v[1:]) for k, v in times.items()}
    log(f"graft step (graft.GraftStep: sample_action + step_batch as one graph, the noise and a "
        f"whole reset batch drawn inside it) at {GRAFT_ENVS} envs (a fresh 128-128, stage 1) x "
        f"{GRAFT_STEPS} steps: {restarted} ended envs, each restarted at t = 0 on a fresh path "
        f"of its own; kernel launches {graft_launches} (the capture's warm-up step included)")
    log(f"  the captured step vs the eager sample_action + step_batch from a twin generator, "
        f"{GRAFT_CHECK_STEPS} steps: bit-equal (state, obs, reward, done, value, generator) "
        f"{graft_same}; a replay under set_sync_debug_mode('error'): no wait for the card; "
        f"a replay under the profiler: {len(host)} host launches, {len(events)} device ops; "
        f"ms a step (host clock, synchronized, median of 10, in turn): captured "
        f"{ms['captured']:.3f}, eager sample_action + step_batch {ms['step_batch']:.3f} "
        f"({ms['step_batch'] / ms['captured']:.2f}x the captured), step_batch_template "
        f"{ms['step_batch_template']:.3f} (step_batch "
        f"{ms['step_batch'] / ms['step_batch_template']:.1f}x it)")
    if graft_launches != GRAFT_STEPS + WARMUPS or restarted == 0 or not graft_same:
        raise AssertionError(f"graft step: {graft_launches} launches, {restarted} restarts, "
                             f"captured equal to eager {graft_same}")

    # (5) the initial throw
    throw_cfg = EnvConfig(initial_motion_enabled=True)
    env = Drone2DEnv(throw_cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, obs = env.reset_batch(gen, NUM_ENVS, START_STEP)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if not bool(torch.isfinite(obs).all()) or bool((state.body.omega == 0).any()):
        raise AssertionError("initial throw: non-finite obs or an env not thrown")
    cpu_env = Drone2DEnv(throw_cfg, device="cpu")
    g = torch.Generator().manual_seed(9)
    body = Drone2DEnv(EnvConfig(), device="cpu").reset_batch(g, NUM_ENVS, START_STEP)[0].body
    draws = cpu_env.throw_draws(g, NUM_ENVS)
    want = cpu_env._initial_motion(body, draws)
    got = env._initial_motion(_to(body, "cuda"), tuple(x.to(dev) for x in draws))
    errs = {k: scaled_err(getattr(got, k).cpu(), getattr(want, k))
            for k in ("pos", "vel", "angle", "omega")}
    log(f"initial throw: reset of {NUM_ENVS} envs with the throw on the card in {dt:.3f} s, "
        f"every env thrown; _initial_motion on the card vs the CPU from the same body and "
        f"draws, scaled errors " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    if max(errs.values()) > TOL:
        raise AssertionError(f"initial throw: the card and the CPU disagree: {errs}")
    kernel_row["launches_by_path"].update(
        {"vector_env": launches, "gym_env": gym_launches, "graft_step": graft_launches})


def phase_boxes(kernel_row: dict):
    """agent_s8004 flies parallel_boxes, BOXES_EPISODES stochastic episodes
    (seed 0) on the card; its success rate against the JAX package's by
    |z| <= Z_MAX: the box geometry at campaign level."""
    params = load_agent("cuda")
    torch.cuda.synchronize()
    fused_sample_action.launches = 0
    t0 = time.perf_counter()
    res = run_episodes(scenario_config("parallel_boxes"), params, 0, BOXES_EPISODES)
    dt = time.perf_counter() - t0
    launches = fused_sample_action.launches
    n = max(int(res.success.sum() + res.fail.sum()), 1)
    sr = float(res.success.sum()) / n
    z = _z(sr, JAX_BOXES_SR, n, JAX_BOXES_N)
    log(f"boxes: agent_s8004 on parallel_boxes, {BOXES_EPISODES} stochastic episodes: SR "
        f"{sr:.4f} (JAX {JAX_BOXES_SR:.4f}, n {JAX_BOXES_N}, z {z:+.2f}), collisions "
        f"{int(res.collision.sum())}, APE {res.ape.mean():.2f}, flight time "
        f"{res.time_steps.mean():.1f}; {dt:.2f} s; kernel launches {launches}")
    if abs(z) > Z_MAX or launches <= 0:
        raise AssertionError(f"parallel_boxes: SR {sr} against the JAX package's, z {z}")
    kernel_row["launches_by_path"]["boxes"] = launches


def _copy_state(state: TrainState, generator: torch.Generator) -> TrainState:
    """A copy of a learner's state with its own weights and Adam, and
    `generator` (the update replaces the env state, never writes it)."""
    params = copy.deepcopy(state.params)
    opt = optim.adam(params.parameters(), state.optimizer.defaults["lr"])
    opt.load_state_dict(state.optimizer.state_dict())
    return dataclasses.replace(state, params=params, optimizer=opt, generator=generator)


def phase_ddp(kernel_row: dict):
    """The data-parallel update at flagship-scratch on a world-1 NCCL group
    (`parallel.make_group`; no other backend is tried), DDP_UPDATES updates
    each from twin states, taken in turn: the captured `shard_update` (the
    main path: `update_jit` with the group, NCCL's collectives inside the
    CUDA graphs) and the plain `update_jit`, each drawing from a twin of the
    rank's own generator (`mesh.rank_generator`) inside its rollout graph;
    the weights, Adam's state, every metric and the generator's state after
    bit-equal (the plain eager `update` is held bit-equal to `update_jit` in
    the `graphs` phase, the eager data-parallel update to the captured one
    by tests/test_torch_cuda.py), n_steps + 1 launches a replayed update
    (twice that for the capturing one), the updates' seconds in turn; and
    the collectives' share of an eager
    SGD step (an epoch's SGD with and without the group, in turn, and the
    NCCL kernels' device time under the profiler)."""
    _, train_cfg, env_cfg, ppo_cfg = parse_args(["--preset", "flagship-scratch"])
    group, dev = mesh.make_group("cuda:0", backend="nccl")
    n = ppo_cfg.n_steps + 1
    try:
        log(f"ddp: world-1 group, backend {dist.get_backend(group)}, flagship-scratch "
            f"{train_cfg.num_envs} envs")
        learner = PPOLearner(env_cfg, ppo_cfg, train_cfg.num_envs, device=dev)
        state = mesh.shard_init(group, learner, DDP_SEED)
        gen = state.generator.get_state()

        # the reference, from a twin of the rank's generator (the eager
        # data-parallel update was cut to hold the script's time:
        # tests/test_torch_cuda.py holds the captured one bit-equal to it)
        paths = {"captured": mesh.shard_update(group, learner),
                 "update_jit": learner.update_jit}
        states = {k: _copy_state(state, torch.Generator(device=dev).set_state(gen))
                  for k in paths}
        metrics = {k: [] for k in paths}
        secs = {k: [] for k in paths}
        counts = []
        torch.cuda.synchronize()
        fused_sample_action.launches = 0
        for _ in range(DDP_UPDATES):  # the two in turn, update by update
            for name, fn in paths.items():
                before = fused_sample_action.launches
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                states[name], m = fn(states[name])
                torch.cuda.synchronize()
                secs[name].append(time.perf_counter() - t0)
                metrics[name].append(m)
                if name == "captured":
                    counts.append(fused_sample_action.launches - before)
        launches = sum(counts)
        got = states["captured"]
        equal = {}
        for ref in ("update_jit",):
            want = states[ref]
            equal[ref] = {
                "weights": all(torch.equal(a, b) for a, b in zip(
                    got.params.parameters(), want.params.parameters())),
                "adam": all(torch.equal(a, b) for a, b in zip(
                    graphs.optimizer_tensors(got.optimizer),
                    graphs.optimizer_tensors(want.optimizer))),
                "metrics": all(set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in b)
                               for a, b in zip(metrics["captured"], metrics[ref])),
                "generator": torch.equal(got.generator.get_state(),
                                         want.generator.get_state()),
            }
        sharded = metrics["captured"][-1]
        log(f"  {DDP_UPDATES} updates each from twin states, the captured shard_update "
            f"(update_jit with the NCCL group) against: "
            + "; ".join(f"{k} bit-equal {v}" for k, v in equal.items())
            + f"; loss {float(sharded['loss']):.6f}, episodes "
            f"{float(sharded['episodes/episodes']):.0f}; kernel launches {counts} (a replayed "
            f"update {n}, the capturing one {2 * n})")
        if not all(all(v.values()) for v in equal.values()) or counts != [2 * n] + [n] * (
                DDP_UPDATES - 1):
            raise AssertionError(f"ddp: captured world-1 update {equal}, launches {counts}")

        steps = ppo_cfg.n_steps * train_cfg.num_envs
        log("  seconds an update (host clock, synchronized, the two in turn; the first "
            "of each includes its capture): " + "; ".join(
                f"{k} {[round(x, 4) for x in v]}" for k, v in secs.items()))
        log("  train_steps_per_s from the last update of each: " + ", ".join(
            f"{k} {steps / v[-1]:.1f}" for k, v in secs.items()) + f"; card {card_line()}")
        # one more captured update under the profiler (not the path's count)
        events, host, _, _ = launch_window(
            lambda: float(paths["captured"](states["captured"])[1]["loss"]))
        log(f"  profiler, one more captured shard_update: {len(host)} host launches, "
            f"{len(events)} device ops")
        sharded_state = got
        # an SGD epoch with and without the group, in turn, on one batch
        epoch = PPOLearner(env_cfg, ppo_cfg.replace(n_epochs=1), train_cfg.num_envs, device=dev)
        st, batch, last_values, _ = epoch.rollout(sharded_state)
        adv, ret = compute_gae(batch.rewards, batch.values, batch.dones, last_values,
                               gamma=ppo_cfg.gamma, gae_lambda=ppo_cfg.gae_lambda)
        perms = epoch.draw_perms(st.generator)
        sgd = {}
        for g in (group, None, None, group):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            float(epoch.sgd(st, batch, adv, ret, perms, group=g)["loss"])
            sgd.setdefault("ddp" if g else "plain", []).append(
                (time.perf_counter() - t0) / ppo_cfg.num_minibatches)
        ms_g, ms_0 = (1e3 * statistics.mean(sgd[k]) for k in ("ddp", "plain"))
        events, dev_us, wall_us = device_window(
            lambda: float(epoch.sgd(st, batch, adv, ret, perms, group=group)["loss"]))
        nccl_us = sum(e.time_range.elapsed_us() for e in events if "nccl" in e.name.lower())
        n_nccl = sum("nccl" in e.name.lower() for e in events)
        log(f"  SGD step (minibatch {epoch.minibatch_size}, host clock, synchronized, mean of "
            f"two epochs each): with the group {ms_g:.3f} ms, without {ms_0:.3f} ms; the "
            f"collectives' share {100 * (ms_g - ms_0) / ms_g:.1f}% of a step; profiler: "
            f"{n_nccl / ppo_cfg.num_minibatches:.0f} NCCL kernels a step, "
            f"{nccl_us / ppo_cfg.num_minibatches:.1f} us of device time a step "
            f"({100 * nccl_us / max(dev_us, 1e-9):.1f}% of the device's busy time), "
            f"{len(events) / ppo_cfg.num_minibatches:.0f} device ops a step")
    finally:
        dist.destroy_process_group()
    kernel_row["launches_by_path"]["ddp"] = launches


def _ddp2_rank(rank: int, port: int, out_dir: str) -> None:
    """One of the two ranks of phase_ddp2 (a spawned process): one sharded
    update at flagship-scratch over DDP_ENVS envs in all, then one update of
    its block of DDP_POP_SEEDS; writes its weights and counts to out_dir."""
    _, train_cfg, env_cfg, ppo_cfg = parse_args(["--preset", "flagship-scratch",
                                                 "--ppo-n-epochs", str(DDP2_EPOCHS)])
    group, dev = mesh.make_group("cuda:0", backend="gloo",
                                 init_method=f"tcp://localhost:{port}", world_size=2, rank=rank)
    learner = PPOLearner(env_cfg, ppo_cfg, DDP_ENVS, device=dev)
    state = mesh.shard_init(group, learner, DDP_SEED)
    torch.cuda.synchronize()
    fused_sample_action.launches = 0
    t0 = time.perf_counter()
    state, metrics = mesh.shard_update(group, learner)(state)
    torch.cuda.synchronize()
    out = dict(seconds=time.perf_counter() - t0, launches=fused_sample_action.launches,
               params=params_to_flat_dict(state.params), loss=float(metrics["loss"]),
               episodes=float(metrics["episodes/episodes"]))
    seeds = shard_population(group, DDP_POP_SEEDS)
    trainer = ZooTrainer(env_cfg, ppo_cfg, train_cfg.num_envs, device=dev)
    pop = trainer.init(seeds)
    torch.cuda.synchronize()
    fused_sample_action.launches = 0
    t0 = time.perf_counter()
    pop, _ = trainer.update(pop)
    torch.cuda.synchronize()
    out.update(pop_seconds=time.perf_counter() - t0, pop_launches=fused_sample_action.launches,
               seeds=seeds, members={s: params_to_flat_dict(pop.params.member(i))
                                     for i, s in enumerate(seeds)})
    torch.save(out, os.path.join(out_dir, f"rank_{rank}.pt"))
    dist.destroy_process_group()


def phase_ddp2(kernel_row: dict):
    """Two ranks on the one card (spawned processes, each given cuda:0,
    gloo passed explicitly: NCCL refuses two ranks on one device), eager:
    gloo's collectives cannot be recorded into a CUDA graph, so
    `shard_update` runs `update(group=...)` for gloo on the card
    (`parallel.mesh.captures`), as the train CLI does: one
    sharded update of flagship-scratch over 2 x 512 envs against
    `union_update`, the world-1 replay of the union batch with matched
    minibatch composition (rtol DDP_RTOL, atol DDP_ATOL); then one
    `shard_population` update of 2 members a rank, each member bit-equal to
    the same member in a one-process population of its rank's block, and
    held to the tolerance above against the one-process population of all
    four.  Both at flagship-scratch's widths with DDP2_EPOCHS epochs.
    Either rank failing fails the phase."""
    _, train_cfg, env_cfg, ppo_cfg = parse_args(["--preset", "flagship-scratch",
                                                 "--ppo-n-epochs", str(DDP2_EPOCHS)])
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ddp2_") as d:
        port = mesh.free_port()
        procs = [ctx.Process(target=_ddp2_rank, args=(r, port, d)) for r in range(2)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=600)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        if any(p.exitcode != 0 for p in procs):
            raise AssertionError(f"ddp2: rank exit codes {[p.exitcode for p in procs]}")
        ranks = [torch.load(os.path.join(d, f"rank_{r}.pt"), weights_only=False)
                 for r in range(2)]
    wall = time.perf_counter() - t0
    log(f"ddp2: 2 gloo ranks on cuda:0, {DDP_ENVS} envs in all, {ppo_cfg.n_epochs} epochs x "
        f"{ppo_cfg.num_minibatches} minibatches, in {wall:.1f} s (spawn "
        f"included): update {', '.join(f'{r['seconds']:.2f}' for r in ranks)} s, loss "
        f"{ranks[0]['loss']:.6f} / {ranks[1]['loss']:.6f}, episodes {ranks[0]['episodes']:.0f}; "
        f"kernel launches {[r['launches'] for r in ranks]}; population update "
        f"{', '.join(f'{r['pop_seconds']:.2f}' for r in ranks)} s, launches "
        f"{[r['pop_launches'] for r in ranks]}")
    if [r["launches"] for r in ranks] != [ppo_cfg.n_steps + 1] * 2 \
            or [r["pop_launches"] for r in ranks] != [ppo_cfg.n_steps + 1] * 2:
        raise AssertionError("ddp2: a rank launched the kernel other than n_steps + 1 times")

    # the union batch replayed in this process
    learner = PPOLearner(env_cfg, ppo_cfg, DDP_ENVS)
    local = mesh.local_learner(learner, 2)
    states = [mesh.rank_state(local, DDP_SEED, r) for r in range(2)]
    shared = dict(params=states[0].params, optimizer=states[0].optimizer)
    states = mesh.union_update(learner, [dataclasses.replace(s, **shared) for s in states])
    want = params_to_flat_dict(states[0].params)

    def excess(got, ref):
        """max |got - ref| / (atol + rtol |ref|): at most 1 passes."""
        return max(float(np.max(np.abs(got[k].astype(np.float64) - ref[k])
                                / (DDP_ATOL + DDP_RTOL * np.abs(ref[k])))) for k in ref)

    union = max(excess(r["params"], want) for r in ranks)
    replicated = all(np.array_equal(ranks[0]["params"][k], ranks[1]["params"][k]) for k in want)
    log(f"  sharded vs the union batch in one process: excess {union:.4f} (<= 1 passes: "
        f"rtol {DDP_RTOL}, atol {DDP_ATOL}); the ranks' weights bit-equal: {replicated}")

    trainer = ZooTrainer(env_cfg, ppo_cfg, train_cfg.num_envs)
    whole, _ = trainer.update(trainer.init(DDP_POP_SEEDS))
    block_equal, pop_excess = True, 0.0
    for r in ranks:
        block, _ = trainer.update(trainer.init(r["seeds"]))
        for i, s in enumerate(r["seeds"]):
            ref = params_to_flat_dict(block.params.member(i))
            block_equal &= all(np.array_equal(r["members"][s][k], ref[k]) for k in ref)
            pop_excess = max(pop_excess, excess(r["members"][s], params_to_flat_dict(
                whole.params.member(DDP_POP_SEEDS.index(s)))))
    log(f"  shard_population, {len(DDP_POP_SEEDS)} seeds over 2 ranks: each member bit-equal "
        f"to its rank's block trained in one process: {block_equal}; against the population "
        f"of all {len(DDP_POP_SEEDS)} in one process: excess {pop_excess:.4f}")
    if union > 1.0 or not replicated or not block_equal or pop_excess > 1.0:
        raise AssertionError(f"ddp2: union excess {union}, replicated {replicated}, "
                             f"block equal {block_equal}, population excess {pop_excess}")
    kernel_row["launches_by_path"]["ddp2"] = sum(r["launches"] for r in ranks)
    kernel_row["launches_by_path"]["ddp2_zoo"] = sum(r["pop_launches"] for r in ranks)


def phase_split(kernel_row: dict):
    """The split-carry step (`step_batch_split`) against the template step
    over one N_STEPS chunk of NUM_ENVS envs at stage 5, agent_s8004 acting
    through the kernel with one noise sequence: every step's obs, reward
    and done bit-equal, and `finalize_split` equal to the template chunk's
    state; ms a step of each, and the device ops a step under the profiler."""
    dev = torch.device("cuda")
    env = Drone2DEnv(EnvConfig(), dev)
    gen = torch.Generator(device=dev).manual_seed(31)
    state, obs = env.reset_batch(gen, NUM_ENVS, START_STEP)
    # every 8th env near the step cap, so that episodes end in the chunk
    k = torch.arange(NUM_ENVS, device=dev)
    state.t = torch.where(k % 8 == 0, env.cfg.n_steps - 1 - k % 64, state.t).to(torch.int32)
    tmpl, tmpl_obs = env.reset_batch(gen, NUM_ENVS, START_STEP)
    noise = torch.randn(N_STEPS, NUM_ENVS, 2, generator=gen, device=dev)
    params = load_agent(dev)
    init_static, dyn0 = split_state(state)
    tmpl_static, tmpl_dyn = split_state(tmpl)

    def template_steps(s, o, n):
        outs = []
        for t in range(n):
            a = params.sample_action(o, noise=noise[t])[0].clamp(-1.0, 1.0)
            out = env.step_batch_template(s, a, tmpl, tmpl_obs)
            outs.append((out.obs, out.reward, out.done))
            s, o = out.state, out.obs
        return s, outs

    def split_steps(d, o, n):
        fresh = torch.zeros(NUM_ENVS, dtype=torch.bool, device=dev)
        outs = []
        for t in range(n):
            a = params.sample_action(o, noise=noise[t])[0].clamp(-1.0, 1.0)
            d, fresh, o, r, done, _ = env.step_batch_split(d, fresh, a, init_static,
                                                           tmpl_static, tmpl_dyn, tmpl_obs)
            outs.append((o, r, done))
        return d, fresh, outs

    with torch.no_grad():
        template_steps(state, obs, 2)  # warm the caches of both
        split_steps(dyn0, obs, 2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        final, want = template_steps(state, obs, N_STEPS)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fused_sample_action.launches = 0
        dyn, fresh, got = split_steps(dyn0, obs, N_STEPS)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches = fused_sample_action.launches
        equal = all(torch.equal(g, w) for gs, ws in zip(got, want) for g, w in zip(gs, ws))
        finalized = finalize_split(init_static, tmpl_static, fresh, dyn)
        same_state = all(torch.equal(a, b) for a, b in zip(_leaves(finalized), _leaves(final)))
        ops = {}
        for label, fn in (("template", lambda: template_steps(state, obs, 3)),
                          ("split", lambda: split_steps(dyn0, obs, 3))):
            events, dev_us, wall_us = device_window(fn)
            ops[label] = (len(events) / 3, dev_us / 3e3, wall_us / 3e3)
    ends = int(sum(int(w[2].sum()) for w in want))
    log(f"split: {NUM_ENVS} envs x {N_STEPS} steps at stage 5, agent_s8004: template "
        f"{1e3 * (t1 - t0) / N_STEPS:.3f} ms a step, split {1e3 * (t2 - t1) / N_STEPS:.3f} ms "
        f"a step (host clock, synchronized, kernel included); {ends} episode ends, "
        f"{int(fresh.sum())} envs reset in the chunk; obs, reward and done bit-equal every "
        f"step: {equal}; finalize_split equal to the template's state: {same_state}; "
        f"kernel launches {launches}")
    log("  profiler, 3 steps each: " + "; ".join(
        f"{k} {n:.0f} device ops a step, device {d:.3f} ms of {w:.3f} ms wall"
        for k, (n, d, w) in ops.items()))
    if not equal or not same_state or launches != N_STEPS or ends <= 0:
        raise AssertionError(f"split: equal {equal}, state {same_state}, {launches} launches, "
                             f"{ends} ends")
    kernel_row["launches_by_path"]["split"] = launches


def _leaves(tree):
    if dataclasses.is_dataclass(tree):
        return [x for f in dataclasses.fields(tree) for x in _leaves(getattr(tree, f.name))]
    return [] if tree is None else [tree]


def phase_replay(kernel_row: dict):
    """agent_s8004 flies corridor REPLAY_EPISODES times on the card; its
    `flight_paths` and `apes.npy`, written as `eval/artifacts.py` writes
    them, are replayed through `eval/replay.replay_campaign` on the card
    and on the CPU: the card's replay against the CPU's (REPLAY_TOL px) and
    against the live APEs (0.05 px, the JAX package's bar on a straight
    path)."""
    cfg = scenario_config("corridor")
    torch.cuda.synchronize()
    fused_sample_action.launches = 0
    t0 = time.perf_counter()
    res = run_episodes(cfg, load_agent("cuda"), 3, REPLAY_EPISODES)
    launches = fused_sample_action.launches
    fly = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_replay_") as d:
        with open(f"{d}/flight_paths", "w") as f:
            json.dump(res.flight_paths(cfg.screensize_y), f)
        np.save(f"{d}/apes.npy", res.ape)
        t0 = time.perf_counter()
        card = replay_campaign(d, "corridor")
        t1 = time.perf_counter()
        cpu = replay_campaign(d, "corridor", device="cpu")
        t2 = time.perf_counter()
    vs_cpu = float(np.abs(card.ape_ours - cpu.ape_ours).max())
    vs_live = float(card.abs_err.max())
    log(f"replay: {REPLAY_EPISODES} corridor episodes of agent_s8004 ({int(card.n_steps.sum())} "
        f"positions) flown in {fly:.2f} s, kernel launches {launches}; replayed on the card "
        f"in {t1 - t0:.3f} s, on the CPU in {t2 - t1:.3f} s; |card - CPU| max {vs_cpu:.2e} px "
        f"(limit {REPLAY_TOL}); |card - live APE| max {vs_live:.2e} px (limit 0.05); mean APE "
        f"{card.ape_ours.mean():.3f} px")
    if vs_cpu > REPLAY_TOL or vs_live > 0.05 or launches <= 0:
        raise AssertionError(f"replay: card vs CPU {vs_cpu}, vs live {vs_live}")
    kernel_row["launches_by_path"]["replay"] = launches


def phase_profiling(kernel_row: dict, learner, state):
    """`utils/profiling.trace` around one rollout step at NUM_ENVS envs:
    the Chrome trace exists, every launch of the step has its kernel
    recorded (the lead-in's trivial kernels may lose theirs), and it names
    the step's one fused policy kernel."""
    reset_state, reset_obs, noise = learner._rollout_draws(state)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as d:
        fused_sample_action.launches = 0
        with trace(d) as path:
            collect_steps(state.params, learner.env, state.env_state, state.obs, reset_state,
                          reset_obs, noise[:1])
        launches = fused_sample_action.launches
        size = os.path.getsize(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    recorded = {e["args"].get("correlation") for e in kernels}
    calls = sorted(e["args"]["correlation"] for e in events
                   if e.get("cat") == "cuda_runtime" and "Launch" in e.get("name", ""))
    lead = LEAD_KERNELS + 1  # the lead-in's zeros and its adds
    lost_lead = sum(c not in recorded for c in calls[:lead])
    lost = sum(c not in recorded for c in calls[lead:])
    named = [e["name"] for e in kernels if "fused_sample_action" in e["name"]]
    log(f"profiling: trace of one rollout step, {size} bytes; {len(calls) - lead} launches in "
        f"the step, {lost} of them without their kernel recorded ({lost_lead} of the "
        f"lead-in's {lead}); the policy kernel's events: {named}; kernel launches {launches}")
    if len(named) != 1 or launches != 1 or lost:
        raise AssertionError("profiling: the trace lost kernels of the step or does not name "
                             "its one fused_sample_action kernel")
    kernel_row["launches_by_path"]["profiling"] = launches


def phase_bench(kernel_row: dict):
    """The headline bench: `python -m drone2d_tpu_torch.bench --all` at its
    defaults.  Its stdout is exactly `bench.py`'s two lines; the kernel
    launched n_steps + 1 times an update run (the capture's warm-up, the
    warm-up update, the timed repeats, the eager rollout and one captured
    update under the profiler) and 256 a chunk run (the warm-up and the
    timed repeats), plus the capture's GRAPH_STEPS warm-up steps, the
    OPS_STEPS eager profiled steps and one replay's GRAPH_STEPS under the
    profiler.  Then the env line's chunk, drawn inside its draw
    graph, against the eager chunk (`drawn_chunks_check`, one chunk each at
    its shape), not counted."""
    out, err = io.StringIO(), io.StringIO()
    fused_sample_action.launches = 0
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        res = bench.main(["--all"])
    torch.cuda.synchronize()
    launches = fused_sample_action.launches
    lines = out.getvalue().splitlines()
    for line in lines:
        log(f"  | {line}")
    for line in err.getvalue().splitlines():
        log(f"  ! {line}")
    rows = [json.loads(line) for line in lines]
    if [list(r) for r in rows] != [["metric", "value", "unit", "vs_baseline"]] * 2 or [
            r["metric"] for r in rows] != ["train_steps_per_s", "env_steps_per_s"]:
        raise AssertionError(f"bench stdout is not bench.py's two lines: {lines}")
    train, env = res["train"], res["env"]
    # the capture's warm-up, the warm-up update and the timed ones, the
    # eager rollout under the profiler, one captured update under it
    n = bench.TRAIN_PPO["n_steps"] + 1
    want_train = (WARMUPS + 1 + bench.TRAIN_REPEATS + 2) * n
    # the capture's warm-up (one graph of GRAPH_STEPS), the warm-up and
    # timed chunks, the eager profiled steps, one replay under the profiler
    want_env = (bench.GRAPH_STEPS + (1 + bench.REPEATS) * bench.CHUNK_T + bench.OPS_STEPS
                + bench.GRAPH_STEPS)
    if (train["warmup_launches"], env["warmup_launches"]) != (n, bench.GRAPH_STEPS):
        raise AssertionError(f"bench warm-ups launched {train['warmup_launches']} and "
                             f"{env['warmup_launches']} times")
    if (train["launches_all"], env["launches_all"]) != (want_train, want_env) or (
            launches != want_train + want_env):
        raise AssertionError(f"bench launched the kernel {train['launches_all']} + "
                             f"{env['launches_all']} = {launches} times, want {want_train} + "
                             f"{want_env}")
    if not all(math.isfinite(r["value"]) and r["value"] > 0 for r in rows):
        raise AssertionError(f"bench values {rows}")
    log(f"bench: train line {rows[0]['value']} steps/s, env line {rows[1]['value']} steps/s "
        f"(vs_baseline: against BASELINE.json's TPU v5e target); kernel launches "
        f"{train['launches_all']} (train) + {env['launches_all']} (env); card {card_line()}")
    # the env line's chunk against the eager one (launches not the path's)
    drawn_chunks_check("bench chunk", bench.NUM_ENVS, bench.CHUNK_T, chunks=1, profile=False)
    kernel_row["launches_by_path"]["bench_train"] = train["launches_all"]
    kernel_row["launches_by_path"]["bench_env"] = env["launches_all"]


def drawn_chunks_check(label: str, num_envs: int, chunk_t: int, chunks: int = 2,
                       profile: bool = True) -> dict:
    """The bench's chunks with their template and noise drawn by their draw
    graph (`bench.CapturedChunk`, `CapturedSplitChunk` given a generator)
    against the eager chunks from a twin generator (`bench.chunk`; the split
    chunk's `chunk_split_from` over `draw_chunk`), `chunks` chunks each at
    `num_envs` envs: rewards, obs, envs and the generators' states bit-equal;
    one more drawn chunk replayed with every wait for the card refused, and
    (`profile`) its host launches and device ops under the profiler.
    Raises unless all are equal."""
    dev = torch.device("cuda")
    env = Drone2DEnv(EnvConfig(), dev)
    params = ActorCritic(27, 2, generator=torch.Generator().manual_seed(0), device=dev)
    state, obs = env.reset_batch(torch.Generator(device=dev).manual_seed(1), num_envs, 0.0)
    equal = {}
    for cls, eager in ((bench.CapturedChunk, bench.chunk),
                       (bench.CapturedSplitChunk,
                        lambda p, e, s, o, g, t: bench.chunk_split_from(
                            p, e, s, o, *bench.draw_chunk(e, o.shape[0], g, t, dev)))):
        g1 = torch.Generator(device=dev).manual_seed(2)
        g2 = torch.Generator(device=dev).manual_seed(2)
        run = cls(params, env, state, obs, steps=bench.graph_steps(chunk_t), gen=g1,
                  chunk_t=chunk_t)
        a = b = (state, obs)
        same = True
        for _ in range(chunks):
            got = run(*a)
            want = eager(params, env, *b, g2, chunk_t)
            same &= all((x is None and y is None) or torch.equal(x, y)
                        for x, y in zip(graphs.leaves(got), graphs.leaves(want)))
            a, b = got[:2], want[:2]
        equal[cls.__name__] = bool(same and torch.equal(g1.get_state(), g2.get_state()))
    with no_host_sync():
        run(*a)
    note = ""
    if profile:
        events, host, _, _ = launch_window(lambda: run(*a))
        note = (f"; a drawn chunk under the profiler: {len(host)} host launches, "
                f"{len(events)} device ops ({len(host) / chunk_t:.3f} and "
                f"{len(events) / chunk_t:.1f} a step)")
    log(f"  {label}: the chunk drawn inside its graph vs the eager chunk from a twin generator, "
        f"{chunks} chunks of {num_envs} envs x {chunk_t} steps, bit-equal (rewards, obs, envs, "
        f"generator) {equal}; a drawn chunk replayed under set_sync_debug_mode('error'): no "
        f"wait for the card" + note)
    if not all(equal.values()):
        raise AssertionError(f"{label}: drawn chunks differ from the eager ones: {equal}")
    return equal


def phase_package(kernel_row: dict):
    """`package_agent`'s two campaigns for s8004 on PACKAGE_SCENARIOS at the
    committed PACKAGE_EPISODES episodes (eval seeds 0 and 777): each
    success rate within |z| <= Z_MAX of `summary.json` and
    `campaign_seed777_summary.json`, and the documents, written to a
    temporary directory, with the committed files' keys."""
    agent_dir = ROOT / "artifacts" / "agent_s8004"
    params = load_params(str(agent_dir / "new_agent.npz"), device="cuda")
    hidden = package_agent.hidden_sizes(params)
    torch.cuda.synchronize()
    fused_sample_action.launches = 0
    t0 = time.perf_counter()
    bad = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_package_") as d:
        for eval_seed, fname, tag in package_agent.SUMMARIES:
            with open(agent_dir / fname) as f:
                committed = json.load(f)
            ref = {r["scenario"]: r for r in committed["scenarios"]}
            results = package_agent.campaign_results(params, eval_seed, PACKAGE_EPISODES,
                                                     scenarios=PACKAGE_SCENARIOS)
            rows = package_agent.campaign_rows(results, PACKAGE_EPISODES)
            doc = package_agent.summary_doc(rows, seed=8004,
                                            checkpoint_step=committed["checkpoint_step"],
                                            eval_seed=eval_seed, note="chip smoke", tag=tag,
                                            hidden=hidden)
            with open(Path(d, fname), "w") as f:
                json.dump(doc, f, indent=1)
            with open(Path(d, fname)) as f:
                keys = list(json.load(f))
            if keys != list(committed) or list(rows[0]) != list(committed["scenarios"][0]):
                raise AssertionError(f"package {fname}: keys {keys}, committed {list(committed)}")
            for r in rows:
                c = ref[r["scenario"]]
                z = _z(r["success_rate"], c["success_rate"], PACKAGE_EPISODES, c["episodes"])
                log(f"  package seed {eval_seed} {r['scenario']}: SR {r['success_rate']:.2f} "
                    f"(committed {c['success_rate']:.2f}, z {z:+.2f}), APE {r['avg_ape']:.2f} "
                    f"({c['avg_ape']:.2f}), flight time {r['avg_flight_time']:.1f} "
                    f"({c['avg_flight_time']:.1f})")
                if abs(z) > Z_MAX:
                    bad.append((eval_seed, r["scenario"]))
    torch.cuda.synchronize()
    launches = fused_sample_action.launches
    log(f"package: s8004, {len(PACKAGE_SCENARIOS)} scenarios x {PACKAGE_EPISODES} episodes x 2 "
        f"eval seeds in {time.perf_counter() - t0:.2f} s, hidden sizes {hidden}, the committed "
        f"files' keys; kernel launches {launches}")
    if bad or launches <= 0:
        raise AssertionError(f"package campaigns off the committed summaries: {bad}")
    kernel_row["launches_by_path"]["package"] = launches


def phase_stage1(kernel_row: dict):
    """The stage-1 analyses of s8004 at STAGE1_EPISODES episodes:
    `stage1_failure_modes`' successes against
    `stage1_failmodes_s8004.json`, and `stage1_time_margin`'s finishes
    within the reference cap, both modes, against `stage1_margin_s8004.json`
    (|z| <= Z_MAX each)."""
    with open(R4 / "stage1_failmodes_s8004.json") as f:
        fail_ref = json.load(f)
    with open(R4 / "stage1_margin_s8004.json") as f:
        margin_ref = json.load(f)
    agent = str(AGENT)
    params = load_params(agent, device="cuda")
    torch.cuda.synchronize()
    fused_sample_action.launches = 0
    t0 = time.perf_counter()
    cfg = scenario_config("stage_1")
    chunks = stage1_failure_modes.stage1_chunks(params, 606, STAGE1_EPISODES, STAGE1_EPISODES,
                                                cfg)
    rep = stage1_failure_modes.failure_report(agent, chunks, cfg.n_steps)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        margin = stage1_time_margin.run([agent], episodes=STAGE1_EPISODES,
                                        chunk=STAGE1_EPISODES)
    torch.cuda.synchronize()
    launches = fused_sample_action.launches
    for line in buf.getvalue().splitlines():
        log(f"  | {line}")
    z = _z(rep["successes"] / rep["episodes"], fail_ref["successes"] / fail_ref["episodes"],
           rep["episodes"], fail_ref["episodes"])
    log(f"stage1 failure modes: s8004 {rep['successes']}/{rep['episodes']} successes "
        f"(committed {fail_ref['successes']}/{fail_ref['episodes']}, z {z:+.2f}); timeouts "
        f"{rep['timeouts']}, aggressive alpha {rep['aggressive_alpha']}, collisions "
        f"{rep['collisions']}")
    zs = {"failure_modes": z}
    for mode, row in margin["agents"][agent].items():
        want = margin_ref["agents"]["artifacts/agent_s8004/new_agent.npz"][mode]
        n, n_ref = margin["episodes"], margin_ref["episodes"]
        zs[mode] = _z(row["finish_within_ref_cap"] / n, want["finish_within_ref_cap"] / n_ref,
                      n, n_ref)
        log(f"stage1 time margin {mode}: {row['finish_within_ref_cap']}/{n} within the "
            f"reference cap (committed {want['finish_within_ref_cap']}/{n_ref}, z "
            f"{zs[mode]:+.2f}); over it {row['finish_over_ref_cap']}, stuck "
            f"{row['stuck_at_cap']}, p50 {row['time_p50']} ({want['time_p50']}), max "
            f"{row['time_max']} ({want['time_max']})")
    log(f"  stage1: {time.perf_counter() - t0:.2f} s, kernel launches {launches}")
    if any(abs(v) > Z_MAX for v in zs.values()) or launches <= 0:
        raise AssertionError(f"stage1 analyses off the committed reports: {zs}")
    kernel_row["launches_by_path"]["stage1"] = launches


def phase_aape(kernel_row: dict):
    """`aape_survivorship` on AAPE_SCENARIOS x AAPE_EPISODES: the focal
    s8004 (128-128) and the four imported 64-64 agents as two stacks under
    the same chunk seeds.  Each agent's success rate within |z| <= Z_MAX of
    the committed report's, each imported agent's also of its conformance
    rows (as `phase_imported_campaign` holds it), and the two stacks'
    episodes identical (start states, obstacles, paths and noise, each
    agent's block of the larger stack the same)."""
    with open(AAPE_REPORT) as f:
        ref = json.load(f)
    seen = []
    real = eval_episode.run_episodes_from

    def spy(env, params, state, obs, draws, **kw):
        seen.append((params.members, state, obs, draws))
        return real(env, params, state, obs, draws, **kw)

    refs = [str(ROOT / r) for r in aape_survivorship.REFERENCE_IMPORTS]
    torch.cuda.synchronize()
    fused_sample_action.launches = 0
    t0 = time.perf_counter()
    buf = io.StringIO()
    eval_episode.run_episodes_from = spy
    try:
        with contextlib.redirect_stdout(buf):
            rep, raw = aape_survivorship.run(str(AGENT), refs, AAPE_SCENARIOS,
                                             episodes=AAPE_EPISODES, chunk=AAPE_EPISODES)
    finally:
        eval_episode.run_episodes_from = real
    torch.cuda.synchronize()
    launches = fused_sample_action.launches
    for line in buf.getvalue().splitlines():
        log(f"  | {line}")
    n = AAPE_EPISODES
    paired = []
    for (m1, s1, o1, d1), (m4, s4, o4, d4) in zip(seen[::2], seen[1::2]):
        if (m1, m4) != (1, len(refs)):
            raise AssertionError(f"aape groups of {m1} and {m4}")
        paired.append(all(
            torch.equal(o4[a * n:(a + 1) * n], o1) and torch.equal(d4[:, a * n:(a + 1) * n], d1)
            and all(torch.equal(x[a * n:(a + 1) * n], y) for x, y in (
                (s4.body.pos, s1.body.pos), (s4.body.angle, s1.body.angle),
                (s4.obstacles.xy, s1.obstacles.xy), (s4.obstacles.r, s1.obstacles.r),
                (s4.path.wps, s1.path.wps)))
            for a in range(len(refs))))
    with open(CONFORMANCE) as f:
        conformance = json.load(f)["agents"]
    bad, compared = [], {"ref": 0, "ours": 0}
    for scen in AAPE_SCENARIOS:
        parts, rows = [], []
        for lab, row in rep["scenarios"][scen]["agents"].items():
            want = ref["scenarios"][scen]["agents"][lab]
            z = _z(row["success_rate"], want["success_rate"], n, ref["episodes"])
            parts.append(f"{lab} SR {row['success_rate']:.3f} ({want['success_rate']:.3f}, z "
                         f"{z:+.2f}), AAPE {row['aape_all']:.1f} ({want['aape_all']:.1f})")
            if abs(z) > Z_MAX:
                bad.append((lab, scen))
            if lab in IMPORTED:
                rows += _against_conformance(conformance, lab, scen, row["success_rate"], n,
                                             compared, bad)
        log(f"  aape {scen}: " + "; ".join(parts))
        log(f"  aape {scen} against {CONFORMANCE.relative_to(ROOT)}: " + "; ".join(rows))
    log(f"aape: {len(AAPE_SCENARIOS)} scenarios x {n} episodes x {1 + len(refs)} agents in "
        f"{time.perf_counter() - t0:.2f} s; {compared['ref']} imported rows against the "
        f"reference, {compared['ours']} against the JAX package; the two width groups' "
        f"episodes identical: {paired}; "
        f"raw rows {sorted(raw)[:3]}...; kernel launches {launches}")
    if bad or len(paired) != len(AAPE_SCENARIOS) or not all(paired) or launches <= 0:
        raise AssertionError(f"aape: off the committed report {bad}, paired {paired}")
    kernel_row["launches_by_path"]["aape"] = launches


def phase_probes(kernel_row: dict):
    """The probes at small depth: `bench_update_split` (1024 envs x 16 steps,
    4 minibatches), `roofline_probe` on PROBE_ENVS x PROBE_TABLES with a
    PROBE_CHUNK-step chunk, `roofline_update` at the same update,
    `bench_kernels` at 4096 x 512, `bench_fused_policy` at B=4096, H=128
    (its kernel within TOL of the plain version's scale, log-prob equal),
    `profile_step` (its trace names the fused kernel at every launch) and
    `probe_split_carry` (rewards bit-equal).  The chunk probes time the
    bench's captured chunks (`bench.CapturedChunk`, `CapturedSplitChunk`);
    `roofline_probe`'s at 4096 envs is timed against the eager chunk, in
    turn, after the probes' launches are read, and the drawn-inside chunks
    are held bit-equal to the eager ones (`drawn_chunks_check`)."""
    torch.cuda.synchronize()
    fused_sample_action.launches = 0
    t0 = time.perf_counter()
    _run_cli(bench_update_split.main, ["1024", "16", "4"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rows = roofline_probe.probe(PROBE_ENVS, PROBE_TABLES, chunk_t=PROBE_CHUNK, repeats=1)
        upd = roofline_update.decompose(1024, 16, 4, reps=1, iters=5)
        closest_us = bench_kernels.time_closest(4096, 512, iters=50) * 1e6
        fused = bench_fused_policy.run(4096, 256, reps=2)
        split = probe_split_carry.run(4096, PROBE_CHUNK, repeats=1)
    for line in buf.getvalue().splitlines():
        log(f"  | {line}")
    log(f"  roofline_update (1024 x 16, 4 minibatches): ms {json.dumps(upd['ms'])}; floors "
        f"us {json.dumps(upd['floors_us'])}; shares {json.dumps(upd['shares'])}")
    log(f"  bench_kernels: closest-point scan {closest_us:.1f} us a call (4096 envs x 512)")
    log(f"  bench_fused_policy: {json.dumps(fused)}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_profile_") as d:
        before = fused_sample_action.launches
        path = profile_step.profile(d, NUM_ENVS, 4, 1)
        traced = fused_sample_action.launches - before
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    named = [e["name"] for e in events
             if e.get("cat") == "kernel" and "fused_sample_action" in e["name"]]
    # the capture's warm-up and a warm-up chunk, then the traced one
    traced -= 2 * 4
    log(f"  profile_step (the captured chunk): {len(named)} fused kernel events in the trace "
        f"for {traced} traced launches ({named[:1]})")
    # the probes' own launches: the comparison below is not counted
    torch.cuda.synchronize()
    launches = fused_sample_action.launches

    drawn_chunks_check("probes' chunk", NUM_ENVS, PROBE_CHUNK)
    # the captured chunk the probes time against the eager chunk they timed
    # before the graphs, at 4096 envs and table 512, in turn
    def eager_ns():
        env = Drone2DEnv(EnvConfig(), "cuda")
        params = ActorCritic(27, 2, generator=torch.Generator().manual_seed(0), device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(2)
        state, obs = env.reset_batch(torch.Generator(device="cuda").manual_seed(1), 4096, 0.0)
        state, obs, r = bench.chunk(params, env, state, obs, gen, PROBE_CHUNK)
        float(r.sum())
        t0 = time.perf_counter()
        state, obs, r = bench.chunk(params, env, state, obs, gen, PROBE_CHUNK)
        float(r.sum())
        return (time.perf_counter() - t0) / (PROBE_CHUNK * 4096) * 1e9

    ns = {"captured": [], "eager": []}
    for _ in range(2):
        ns["captured"].append(roofline_probe.measure(4096, 512, chunk_t=PROBE_CHUNK, repeats=1))
        ns["eager"].append(eager_ns())
    log(f"  roofline_probe's chunk at 4096 envs, table 512, {PROBE_CHUNK} steps, in turn: "
        f"captured {[round(x, 2) for x in ns['captured']]} ns an env step, eager chunk "
        f"{[round(x, 2) for x in ns['eager']]} ({min(ns['eager']) / min(ns['captured']):.2f}x)")
    log(f"probes: {time.perf_counter() - t0:.2f} s, kernel launches {launches}; roofline rows "
        f"{[(r['probe'], r['num_envs'], r['table_n'], r['ns_per_env_step']) for r in rows]}")
    errs = fused["scaled_errors"]
    if max(errs.values()) > TOL or errs["logp"] != 0.0:
        raise AssertionError(f"bench_fused_policy: kernel vs plain {errs}")
    if len(named) != traced or not named:
        raise AssertionError(f"profile_step: {len(named)} fused events, {traced} launches")
    if not split["first_chunk_reward_equal"] or launches <= 0:
        raise AssertionError(f"probe_split_carry: {split}")
    kernel_row["launches_by_path"]["probes"] = launches


def main():
    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        log(f"[phase {name}: {seconds[name]:.1f} s]")
        return out

    timed("device", phase_device)
    timed("build", phase_build)
    row = timed("kernel_vs_plain", phase_kernel_vs_plain)
    timed("kernel_stacked", phase_kernel_stacked, row)
    sgd_row = timed("sgd_kernel", phase_sgd_kernel)
    timed("reference", phase_reference)
    timed("update_reference", phase_update_reference)
    learner, state = timed("rollout", phase_slice, row)
    slice_state = (learner, state)
    timed("breakdown", phase_breakdown, learner, state)
    cfgs, state = timed("train", phase_train, row)
    timed("graphs", phase_graphs, cfgs, row)
    learner, state = timed("train_timing", phase_train_timing, cfgs, state)
    timed("weights_live", phase_weights_live, learner, state)
    timed("bench", phase_bench, row)
    timed("ddp", phase_ddp, row)
    timed("ddp2", phase_ddp2, row)
    timed("split", phase_split, row)
    timed("profiling", phase_profiling, row, *slice_state)
    timed("zoo", phase_zoo, row, sgd_row)
    timed("rehearsal_reset", phase_rehearsal_reset)
    timed("finetune", phase_finetune, row)
    timed("finetune_hunt", phase_finetune_hunt, row, sgd_row)
    timed("sb3_shape", phase_sb3_shape, row)
    timed("eval_reference", phase_eval_reference)
    timed("eval_breakdown", phase_eval_breakdown)
    timed("compat", phase_compat, row)
    timed("boxes", phase_boxes, row)
    timed("campaign", phase_campaign, row)
    timed("replay", phase_replay, row)
    timed("precision", phase_precision, row)
    timed("imported_campaign", phase_imported_campaign, row)
    timed("package", phase_package, row)
    timed("stage1", phase_stage1, row)
    timed("aape", phase_aape, row)
    timed("probes", phase_probes, row)
    log("phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items())
        + f"; total {sum(seconds.values()):.1f}")
    for r in (row, sgd_row):
        r["launches"] = sum(r["launches_by_path"].values())
    print(json.dumps({"kernels": [row, sgd_row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

"""Traffic `select`: `select_agents`' call, `run_episodes_multi` of a stack
of trained agents over one scenario's episodes, stochastic policy, the same
episodes for every agent, scenario after scenario.

Set-up loads the agents (committed `.npz` files, slot i holding agent
i mod len(agents)), stacks them and flies one call of the last scenario at
a seed of its own, as a warm-up that no window call reuses: the window
cycles through the scenarios in order, each call at a fresh seed derived
from `--seed`, so every call captures its runner anew, as in
`select_agents`.  The window runs whole rounds of the scenarios, as
`select_agents` flies every candidate on all of them, and ends at the first
round's end after `--seconds`, so every run weighs each scenario alike.  A
traced run runs the same window and then traces one more call, the next
round's first, which captures anew, with the device's records alone (host
operations recorded by the profiler would slow the capture).

Once the window has closed and the program's state is freed, the
reference (`benchmark/reference/episodes.py`) flies `checked_calls` of the
first round's calls again, drawn from the seed before the window opens,
for the distinct agents only (slot i's episodes are agent i mod
len(agents)'s), and the harness compares every episode of those calls: its
first steps against the reference's own flight, the rest of it against
blocks the reference flies from the flight's own states, and its latches.
"""

from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from benchmark.harness import ROOT, Run, derived_seeds

END_TO_END = "eval_episodes_per_s"
FIELDS = ("success", "fail", "collision", "ape", "time_steps")
# the steps over which a flight is held against the reference's own flight
# of the same episode (`path_gap_q99`): rounding alone parts two flights of
# one episode by a pixel or more by step 64 in a few episodes and by step
# 256 in most, so from this step on a flight is followed from its own
# states (`follow_gap_q90`)
PATH_STEPS = 16


def run(config: dict, traffic: dict, limits: dict, seed: int, seconds: float, trace: bool,
        device: torch.device, t0: float) -> Run:
    from drone2d_tpu_torch.eval.episode import run_episodes_multi
    from drone2d_tpu_torch.eval.run import scenario_config
    from drone2d_tpu_torch.ops.fused_policy import fused_sample_action

    agents, A, n = traffic["agents"], traffic["stack"], traffic["episodes"]
    scenarios = traffic["scenarios"]
    hidden = config["policy"]["hidden_sizes"]
    stack = _stack(config, traffic, device)
    run_episodes_multi(scenario_config(scenarios[-1]), stack, derived_seeds(seed, "setup", 1)[0],
                       n, device=device)
    seeds = derived_seeds(seed, "calls", 1000)
    checked = checked_calls(seed, len(scenarios), limits["checked_calls"])
    calls = {}

    def call(i) -> dict:
        scenario = scenarios[i % len(scenarios)]
        t = time.perf_counter()
        res = run_episodes_multi(scenario_config(scenario), stack, seeds[i], n, device=device)
        keep = FIELDS + (("traj", "angles") if i in checked else ())
        out = {"scenario": scenario, "seed": seeds[i], "seconds": time.perf_counter() - t,
               **{k: getattr(res, k) for k in keep}}
        print(f"call {i} {scenario}: {out['seconds']:.4f} s", file=sys.stderr)
        return out

    launches = fused_sample_action.launches
    t_start = time.perf_counter()
    setup_s = t_start - t0
    while True:
        calls[len(calls)] = call(len(calls))
        if len(calls) % len(scenarios) == 0 and time.perf_counter() - t_start >= seconds:
            break
    window_s = time.perf_counter() - t_start
    launches = fused_sample_action.launches - launches
    tr, traced_launches = None, 0
    if trace:
        from benchmark.trace import traced

        traced_launches = fused_sample_action.launches
        _, tr = traced(lambda: call(len(calls)), host_ops=False)
        traced_launches = fused_sample_action.launches - traced_launches
    memory = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    del stack
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    reference = [reference_call(traffic, calls[i]["scenario"], calls[i]["seed"], device,
                                judged=calls[i]) for i in checked]
    episodes = A * n * len(calls)
    failed = sum(int(not np.all(np.isfinite(c["ape"]))) for c in calls.values()) * A * n
    return Run(
        setup_s=setup_s, end_to_end={END_TO_END: episodes / window_s}, attempted=episodes,
        failed=failed, memory_peak_bytes=memory,
        readings=compare([calls[i] for i in checked], reference, len(agents)),
        shape={"kernel_rows": A * n, "kernel_members": A, "hidden": hidden[0], "agents": A,
               "episodes": n},
        counters={"calls": len(calls), "kernel_launches": launches, "window_s": window_s,
                  "traced_launches": traced_launches},
        trace=tr)


def _stack(config: dict, traffic: dict, device):
    """The stack of the cell's agents, slot i holding agent i mod len(agents)."""
    from drone2d_tpu_torch.eval.run import load_params
    from drone2d_tpu_torch.models.policy import stack_params

    agents, hidden = traffic["agents"], config["policy"]["hidden_sizes"]
    loaded = [load_params(str(ROOT / path), device=device) for path in agents]
    for path, p in zip(agents, loaded):
        if [layer.w.shape[-1] for layer in p.pi] != hidden:
            raise ValueError(f"{path} is not a {hidden} policy")
    return stack_params([loaded[i % len(agents)] for i in range(traffic["stack"])])


def checked_readings(config: dict, traffic: dict, limits: dict, seed: int, device) -> dict:
    """The readings that a run at `seed` compares, the window's other calls
    left out: the calls the reference checks, flown on the stack as the
    window flies them, against the reference."""
    from drone2d_tpu_torch.eval.episode import run_episodes_multi
    from drone2d_tpu_torch.eval.run import scenario_config

    stack = _stack(config, traffic, device)
    scenarios = traffic["scenarios"]
    seeds = derived_seeds(seed, "calls", len(scenarios))
    program = []
    for i in checked_calls(seed, len(scenarios), limits["checked_calls"]):
        res = run_episodes_multi(scenario_config(scenarios[i]), stack, seeds[i],
                                 traffic["episodes"], device=device)
        program.append({"scenario": scenarios[i], "seed": seeds[i],
                        **{k: getattr(res, k) for k in FIELDS + ("traj", "angles")}})
    del stack
    gc.collect()
    reference = [reference_call(traffic, c["scenario"], c["seed"], device, judged=c)
                 for c in program]
    return compare(program, reference, len(traffic["agents"]))


def checked_calls(seed: int, n_scenarios: int, k: int) -> list:
    """The indices, in the first round, of the calls the reference flies
    again: k drawn from the seed."""
    rng = np.random.default_rng(derived_seeds(seed, "checked", 1)[0])
    return sorted(rng.permutation(n_scenarios)[:k].tolist())


def reference_call(traffic: dict, scenario: str, seed: int, device, tf32: bool = False,
                   judged: dict | None = None) -> dict:
    """The reference's campaign of the distinct agents for one call (with
    its matrix products in TF32 for the control) and, given the `judged`
    side's flights, their latches worked out again from them and the gaps
    of the blocks the reference flies from their own states."""
    from benchmark.reference import policy
    from benchmark.reference.episodes import campaign, follow, judge, scenario_config

    cfg = scenario_config(scenario)
    params = policy.stack([policy.load_npz(str(ROOT / p)) for p in traffic["agents"]], device)
    params = {k: v.detach() for k, v in params.items()}
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        out = campaign(cfg, params, seed, traffic["episodes"], device)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    out = {k: v.numpy() for k, v in out.items()}
    if judged is not None:
        flights = {k: torch.as_tensor(judged[k]) for k in ("traj", "angles", "time_steps")}
        latches = judge(cfg, seed, traffic["episodes"], flights["traj"], flights["angles"],
                        device)
        flights["la_locked"] = latches.pop("la_locked")
        out["judged"] = {k: v.numpy() for k, v in latches.items()}
        out["followed"] = follow(cfg, params, seed, traffic["episodes"], flights,
                                 device).numpy()
    return out


def compare(program: list, reference: list, n_agents: int) -> dict:
    """The readings of `program`'s calls against `reference`'s, by name:
    - `path_gap_q99`: the 99th percentile over the episodes of the widest
      gap, in pixels, between an episode's position in the program's flight
      (slot i) and in the reference's own flight of it (agent i mod
      n_agents) over its first PATH_STEPS steps;
    - `follow_gap_q90`: the 90th percentile of the widest gaps of the blocks
      that the reference flies from the program's own states over the rest
      of every flight (`reference/episodes.py::follow`);
    - `latch_differ`: the share of the program's episodes whose success,
      fail, collision or step count differ from what the reference works
      out from the program's own flight, and `ape_gap`: the worst relative
      gap of their APE.
    Percentiles, not the widest: a flight that rounding carries across an
    edge of the observation (the nearest obstacles' order, the lookahead's
    segment) parts from the reference by a pixel or more in a few episodes
    and blocks of every run, while a fault or a lower precision moves them
    all."""
    ape_gap = 0.0
    n = latch_n = 0
    paths, followed = [], []
    for p, r in zip(program, reference):
        slots = np.arange(p["success"].shape[0]) % n_agents
        gap = np.linalg.norm(np.asarray(p["traj"])[..., :PATH_STEPS, :]
                             - np.asarray(r["traj"])[slots, :, :PATH_STEPS], axis=-1)
        paths.append(np.max(gap, axis=-1).reshape(-1))
        followed.append(r["followed"])
        j = r["judged"]
        same = np.ones(p["success"].shape, dtype=bool)
        for k in ("success", "fail", "collision", "time_steps"):
            same &= np.asarray(p[k]) == j[k]
        n += same.size
        latch_n += int(np.sum(~same))
        rel = np.abs(np.asarray(p["ape"]) - j["ape"]) / np.maximum(np.abs(j["ape"]), 1e-30)
        ape_gap = max(ape_gap, float(np.max(np.where(np.isfinite(rel), rel, np.inf))))

    def quantile(x, q):
        x = np.concatenate(x)
        return float(np.quantile(np.where(np.isfinite(x), x, np.inf), q)) if x.size else 0.0

    return {"path_gap_q99": quantile(paths, 0.99), "follow_gap_q90": quantile(followed, 0.9),
            "latch_differ": latch_n / max(n, 1), "ape_gap": ape_gap}


def control(config: dict, traffic: dict, limits: dict, seed: int, device) -> dict:
    """The control's readings at `seed`: the reference in TF32 in the
    program's place, against the reference in float32, over the calls a
    run at `seed` checks."""
    A, scenarios = traffic["stack"], traffic["scenarios"]
    seeds = derived_seeds(seed, "calls", len(scenarios))
    program, reference = [], []
    slots = np.arange(A) % len(traffic["agents"])
    for i in checked_calls(seed, len(scenarios), limits["checked_calls"]):
        tf32 = reference_call(traffic, scenarios[i], seeds[i], device, tf32=True)
        tf32 = {k: v[slots] for k, v in tf32.items()}
        program.append(tf32)
        reference.append(reference_call(traffic, scenarios[i], seeds[i], device, judged=tf32))
    return compare(program, reference, len(traffic["agents"]))


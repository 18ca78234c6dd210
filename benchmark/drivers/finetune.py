"""Traffic `finetune`: back-to-back `ZooTrainer.update_jit` calls on a
population warm-started from one agent under adaptive rehearsal, as `sweep
--vmap --preset flagship-finetune --init-params <agent>` trains the
fine-tune seed hunt.

Set-up builds one trainer and warm-starts the population through the port's
own function (`learn/zoo.py::warm_start`, which `train_zoo` calls): member
seeds derived from `--seed`, every member from its own copy of the
configuration's `init` agent, the curriculum clock at 0 and the rehearsal
probabilities the initial ones, fixed, as `train_zoo` starts them.  It then
drives the state through its first `checked_updates` updates with the
window's own call (the first captures the update's graphs).  Before each,
the families of the update's reset template are drawn by the program's
`draws` from copies of the members' generators, which leaves the members'
own where they are; after each, every env whose family the update changed
must hold that template's family, which is what the captured rollout's
own draw put there.  After the first, the SGD data its epochs ran over is
read back (`PPOLearner.update_data`).  The window is `train.py`'s: whole
updates back to back, each closed by a host read of its losses that waits
for it while the next one is queued, ending with the update queued when
`--seconds` have passed.  Just before the window opens and just after it
closes, the host feeds the program's rehearsal counters
(`learn/zoo.py::count_rehearsal`), and the run's counters hold their change
over the window.  A traced run then traces one more update.

Once the window has closed and the program's state is freed, the reference
(`benchmark/reference/rehearsal.py`) trains the same members from the same
seeds and the same agent file through the same first updates, and then
steps the first update's SGD alone over the program's own data from the
agent's weights with its own shuffles (teacher-forced).  The trained
agent's closed loop parts the two sides' flights by rounding alone within
a rollout, so the whole updates' losses and widest gaps swing as much in
sound runs as under TF32; the teacher-forced SGD and the families do not.
The cell's limits name the readings that decide `correct`.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from benchmark.drivers import train
from benchmark.drivers.train import (END_TO_END, _adam_first_moment, _env_kw, _flat, _free,
                                     _host, _ppo_kw, compare)
from benchmark.harness import ROOT, Run, derived_seeds


# `train.compare`'s readings of the first update's SGD against the
# teacher-forced one, by name
_SGD = {"loss_gap_1": "sgd_loss_gap", "grad_gap": "sgd_grad_gap",
        "grad_median": "sgd_grad_median", "change_gap": "sgd_change_gap",
        "change_median_1": "sgd_change_median"}


def _rehearsal_counters() -> dict:
    from drone2d_tpu_torch.utils import profiling

    return {k: v for k, v in profiling.counters().items() if k.startswith("rehearsal.")}


def _template_families(trainer, state) -> np.ndarray:
    """The families of the next update's reset template, (S * N,), as the
    program draws it, from copies of the members' generators."""
    twins = []
    for gen in state.generators:
        twin = torch.Generator(device=gen.device)
        twin.set_state(gen.get_state())
        twins.append(twin)
    template = trainer.draws(dataclasses.replace(state, generators=twins))[0]
    return _host(template.family)


def run(config: dict, traffic: dict, limits: dict, seed: int, seconds: float, trace: bool,
        device: torch.device, t0: float) -> Run:
    from drone2d_tpu_torch.config import EnvConfig, PPOConfig
    from drone2d_tpu_torch.learn.zoo import ZooTrainer, count_rehearsal, warm_start
    from drone2d_tpu_torch.utils import profiling

    S, N = traffic["members"], config["num_envs"]
    ppo = _ppo_kw(config)
    K = limits["checked_updates"]
    seeds = derived_seeds(seed, "members", S)
    trainer = ZooTrainer(EnvConfig(**_env_kw(config)), PPOConfig(**ppo), N, device=device)
    profiling.enable()
    state = warm_start(trainer, seeds, str(ROOT / config["init"]))
    profiling.enable(False)
    warm = [s for s in profiling.spans() if s.name == "zoo.warm_start"]
    program = {"p0": _flat(state.params), "loss": [],
               "families": [_host(state.env_state.family)], "strays": 0}
    capture_s = 0.0
    for k in range(K):
        was = _host(state.env_state.family)
        template = _template_families(trainer, state)
        program["families"].append(template)
        t = time.perf_counter()
        state, metrics = trainer.update_jit(state)
        program["loss"].append(_host(metrics["loss"]))
        after = _host(state.env_state.family)
        program["strays"] += int(np.sum((after != was) & (after != template)))
        if k == 0:
            capture_s = time.perf_counter() - t
            program["m1"] = _adam_first_moment(state.params, state.optimizer)
            program["p1"] = _flat(state.params)
            program["data"] = [_host(x) for x in trainer.update_data(state)]
    program["pK"] = _flat(state.params)
    program["family_counts"] = _host(state.family_counts)

    def update():
        """One update -> a host read of whether its losses are finite, ready
        once the update has run (on the card, the copy's event)."""
        nonlocal state
        state, metrics = trainer.update_jit(state)
        finite = torch.isfinite(metrics["loss"]).all()
        if device.type != "cuda":
            return finite, None
        host = torch.empty((), dtype=torch.bool, pin_memory=True)
        host.copy_(finite, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record()
        return host, ready

    def finished(read) -> bool:
        host, ready = read
        if ready is not None:
            ready.synchronize()
        return bool(host)

    counted = count_rehearsal(state)
    before = _rehearsal_counters()
    t_start = time.perf_counter()
    setup_s = t_start - t0
    updates = failed = 0
    pending = update()
    while True:
        updates += 1
        last = time.perf_counter() - t_start >= seconds
        following = None if last else update()
        failed += not finished(pending)
        if last:
            break
        pending = following
    window_s = time.perf_counter() - t_start
    count_rehearsal(state, counted)
    window_counts = {k: v - before.get(k, 0) for k, v in _rehearsal_counters().items()}
    tr = None
    if trace:
        from benchmark.trace import traced

        read, tr = traced(update)
        failed += not finished(read)
    memory = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    del state, trainer
    _free(device)

    reference = reference_readings(config, traffic, seeds, K, device)
    forced = teacher_forced(config, reference, program["data"], device)
    steps = S * N * ppo["n_steps"] * updates
    return Run(
        setup_s=setup_s, end_to_end={END_TO_END: steps / window_s, "update_s": window_s / updates},
        attempted=updates, failed=failed, memory_peak_bytes=memory,
        readings=compare_rehearsal(program, reference, forced, S),
        shape={"kernel_rows": S * N, "kernel_members": S, "hidden": ppo["hidden_sizes"][0],
               "members": S, "num_envs": N, "n_steps": ppo["n_steps"],
               "n_epochs": ppo["n_epochs"]},
        counters={"updates": updates, "window_s": window_s, "traced_updates": 1,
                  "capture_update_s": capture_s, "warm_start_s": warm[-1].attrs["seconds"],
                  **window_counts},
        trace=tr)


def reference_readings(config: dict, traffic: dict, seeds, updates: int, device,
                       tf32: bool = False, learner=None, agent: bool = True) -> dict:
    """`train.reference_readings` of a `RehearsalPPO` (or of `learner`, a
    subclass) whose members start from the configuration's `init` agent
    (with `agent` False, from fresh weights), and the families of every
    reset, the family counts after the last update, and the first update's
    SGD data and shuffles."""
    from benchmark.reference import policy
    from benchmark.reference.config import EnvConfig, PPOConfig
    from benchmark.reference.rehearsal import RehearsalPPO

    ref = (learner or RehearsalPPO)(
        EnvConfig(**_env_kw(config)), PPOConfig(**_ppo_kw(config)), config["num_envs"], device,
        agent=policy.load_npz(str(ROOT / config["init"])) if agent else None)
    out = train.reference_readings(config, traffic, seeds, updates, device, tf32=tf32,
                                   learner=lambda *_: ref)
    out["families"] = [_host(f) for f in ref.drawn]
    out["family_counts"] = _host(ref.family_counts)
    out["data"] = [_host(x) for x in ref.fed[0]]
    out["shuffles"] = _host(ref.shuffles[0])
    out["strays"] = 0  # the reference's families are the ones it drew
    return out


def teacher_forced(config: dict, reference: dict, data, device) -> dict:
    """The reference's first update's SGD stepped alone, in float32, over
    `data` (the SGD data of the side under test, host arrays) from the
    reference's initial weights with its shuffles, as `train.compare`
    reads a side: its initial weights, its loss, Adam's first moment and
    the weights after it."""
    from benchmark.reference.config import EnvConfig, PPOConfig
    from benchmark.reference.rehearsal import RehearsalPPO

    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ref = RehearsalPPO(EnvConfig(**_env_kw(config)), PPOConfig(**_ppo_kw(config)),
                           config["num_envs"], device)
        params = {k: torch.as_tensor(v, device=device).clone().requires_grad_(True)
                  for k, v in reference["p0"].items()}
        loss, opt = ref.sgd_from(params, [torch.as_tensor(x, device=device) for x in data],
                                 torch.as_tensor(reference["shuffles"], device=device))
        p1 = {k: _host(v) for k, v in params.items()}
        return {"p0": reference["p0"], "loss": [_host(loss)], "p1": p1, "pK": p1,
                "m1": {k: _host(opt.state[p]["exp_avg"]) for k, p in params.items()}}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def compare_rehearsal(program: dict, reference: dict, forced: dict, members: int) -> dict:
    """`train.compare`'s readings of the whole updates; the same readings
    of the first update's SGD against the teacher-forced one (`forced`,
    `teacher_forced` over the program's data), prefixed `sgd_`
    (`sgd_loss_gap`, `sgd_grad_gap`, `sgd_grad_median`, `sgd_change_gap`,
    `sgd_change_median`, all over the first update); `family_differ`: the
    (member, env) families of the
    initial reset and of each checked update's template that differ
    between the two sides, and the envs whose family an update changed to
    another than its template's; and, not compared, `family_count_gap`: the
    widest relative gap of a (member, family) count of finished episodes
    after the checked updates."""
    values = compare(program, reference, members)
    first = {**program, "loss": program["loss"][:1], "pK": program["p1"]}
    values.update({_SGD[k]: v for k, v in compare(first, forced, members).items()})
    values["family_differ"] = float(program["strays"] + sum(
        int(np.sum(p != r)) for p, r in zip(program["families"], reference["families"],
                                           strict=True)))
    p, r = program["family_counts"], reference["family_counts"]
    values["family_count_gap"] = float(np.max(np.abs(p - r) / np.maximum(r, 1.0)))
    return values


def control(config: dict, traffic: dict, limits: dict, seed: int, device) -> dict:
    """The control's readings at `seed`: the reference in TF32 in the
    program's place, against the reference in float32 (teacher-forced over
    the TF32 side's data)."""
    seeds = derived_seeds(seed, "members", traffic["members"])
    K = limits["checked_updates"]
    fp32 = reference_readings(config, traffic, seeds, K, device)
    tf32 = reference_readings(config, traffic, seeds, K, device, tf32=True)
    return compare_rehearsal(tf32, fp32, teacher_forced(config, fp32, tf32["data"], device),
                             traffic["members"])


def faults(config: dict, traffic: dict, limits: dict, seed: int, device, names) -> dict:
    """Each fault's readings at `seed`, by name: the reference with the fault
    planted, put in the program's place, against the reference (teacher-
    forced over the planted side's data).
    `flat_weights`: the families drawn with the stages weighted 1:1:1:1:1;
    `cold_start`: the members from fresh weights, not the agent;
    `half_batch`: each minibatch's loss over its first half only."""
    from benchmark.reference.rehearsal import RehearsalPPO

    class HalfBatch(RehearsalPPO):
        def _loss(self, params, obs, actions, old_log_probs, advantages, returns):
            h = obs.shape[-2] // 2
            return super()._loss(params, obs[..., :h, :], actions[..., :h, :],
                                 old_log_probs[..., :h], advantages[..., :h], returns[..., :h])

    seeds = derived_seeds(seed, "members", traffic["members"])
    K = limits["checked_updates"]
    clean = reference_readings(config, traffic, seeds, K, device)
    planted = {
        "flat_weights": lambda: reference_readings(
            {**config, "env": {**config["env"], "stage_mix_weights": [1.0] * 5}}, traffic,
            seeds, K, device),
        "cold_start": lambda: reference_readings(config, traffic, seeds, K, device,
                                                 agent=False),
        "half_batch": lambda: reference_readings(config, traffic, seeds, K, device,
                                                 learner=HalfBatch),
    }
    out = {}
    for name in names:
        side = planted[name]()
        forced = teacher_forced(config, clean, side["data"], device)
        out[name] = compare_rehearsal(side, clean, forced, traffic["members"])
    return out

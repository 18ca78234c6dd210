"""Traffic `train`: back-to-back `ZooTrainer.update_jit` calls on a
population, as `sweep --vmap` trains a seed hunt.

Set-up builds one trainer and one population state from member seeds
derived from `--seed` (fresh weights, the curriculum clock at 0, as a hunt
starts), drives it through its first `checked_updates` updates with the
window's own call (the first captures the update's graphs), and hands that
same state to the window.  The window runs whole updates back to back,
each closed by a host read of its losses that waits for it while the next
one is queued, and ends with the update queued when `--seconds` have
passed.
A traced run runs the same window and then traces one more update.

Once the window has closed and the program's state is freed, the
reference (`benchmark/reference/ppo.py`) trains the same members from the
same seeds through the same first updates, and the harness compares each
update's loss, Adam's first moment after the first update (the gradients
as the optimizer got them) and each leaf's change over the checked updates.
"""

from __future__ import annotations

import gc
import re
import time

import numpy as np
import torch

from benchmark.harness import Run, derived_seeds, leaf_gaps, quiet_leaves

END_TO_END = "train_env_steps_per_s"


def _env_kw(config: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in config["env"].items()}


def _ppo_kw(config: dict) -> dict:
    return {**config["ppo"], "hidden_sizes": tuple(config["policy"]["hidden_sizes"])}


def _leaf_name(key: str) -> str:
    """An ActorCritic parameter ("pi.0.w") by its agent-file name ("pi0/w")."""
    return re.sub(r"^(pi|vf)\.(\d)", r"\1\2", key).replace(".", "/")


def _host(t: torch.Tensor):
    """A copy of `t` on the host (on the CPU `.numpy()` alone would share it)."""
    return t.detach().cpu().numpy().copy()


def _flat(params) -> dict:
    """A population's leaves by agent-file name, as host arrays."""
    return {_leaf_name(k): _host(p) for k, p in params.named_parameters()}


def _adam_first_moment(params, optimizer) -> dict:
    return {_leaf_name(k): _host(optimizer.state[p]["exp_avg"])
            for k, p in params.named_parameters()}


def _free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def run(config: dict, traffic: dict, limits: dict, seed: int, seconds: float, trace: bool,
        device: torch.device, t0: float) -> Run:
    from drone2d_tpu_torch.config import EnvConfig, PPOConfig
    from drone2d_tpu_torch.learn.zoo import ZooTrainer

    S, N = traffic["members"], config["num_envs"]
    ppo = _ppo_kw(config)
    K = limits["checked_updates"]
    seeds = derived_seeds(seed, "members", S)
    trainer = ZooTrainer(EnvConfig(**_env_kw(config)), PPOConfig(**ppo), N, device=device)
    state = trainer.init(seeds)
    program = {"p0": _flat(state.params), "loss": []}
    capture_s = 0.0
    for k in range(K):
        t = time.perf_counter()
        state, metrics = trainer.update_jit(state)
        program["loss"].append(_host(metrics["loss"]))
        if k == 0:
            capture_s = time.perf_counter() - t
            program["m1"] = _adam_first_moment(state.params, state.optimizer)
            program["p1"] = _flat(state.params)
    program["pK"] = _flat(state.params)

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

    t_start = time.perf_counter()
    setup_s = t_start - t0
    # each update is closed by the host read of its losses, taken while the
    # next one runs, as a hunt's loop keeps the card fed; once an update
    # finishes after `seconds`, the window ends with the one queued behind it
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
    tr = None
    if trace:
        from benchmark.trace import traced

        read, tr = traced(update)
        failed += not finished(read)
    memory = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    del state, trainer
    _free(device)

    reference = reference_readings(config, traffic, seeds, K, device)
    steps = S * N * ppo["n_steps"] * updates
    return Run(
        setup_s=setup_s, end_to_end={END_TO_END: steps / window_s, "update_s": window_s / updates},
        attempted=updates,
        failed=failed, memory_peak_bytes=memory, readings=compare(program, reference, S),
        shape={"kernel_rows": S * N, "kernel_members": S, "hidden": ppo["hidden_sizes"][0],
               "members": S, "num_envs": N, "n_steps": ppo["n_steps"],
               "n_epochs": ppo["n_epochs"]},
        counters={"updates": updates, "window_s": window_s, "traced_updates": 1,
                  "capture_update_s": capture_s},
        trace=tr)


def reference_readings(config: dict, traffic: dict, seeds, updates: int, device,
                       tf32: bool = False, learner=None) -> dict:
    """The reference's readings for the members `seeds` over `updates`
    updates: initial weights, each update's losses, Adam's first moment
    after the first update and the weights after the last.  With `tf32`, its
    matrix products in TF32 (the control)."""
    from benchmark.reference.config import EnvConfig, PPOConfig
    from benchmark.reference.ppo import PopulationPPO

    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        ref = (learner or PopulationPPO)(EnvConfig(**_env_kw(config)), PPOConfig(**_ppo_kw(config)),
                            config["num_envs"], device)
        pop = ref.init(seeds)

        def host(leaves):
            return {k: _host(v) for k, v in leaves.items()}

        out = {"p0": host(pop.params), "loss": []}
        for k in range(updates):
            out["loss"].append(_host(ref.update(pop)))
            if k == 0:
                out["m1"] = {name: _host(pop.optimizer.state[p]["exp_avg"])
                             for name, p in pop.params.items()}
                out["p1"] = host(pop.params)
        out["pK"] = host(pop.params)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    return out


def compare(program: dict, reference: dict, members: int) -> dict:
    """The readings of `program` against `reference`, by name: the worst
    relative gap of a member's loss over the first update (`loss_gap_1`);
    the worst and the median (member,
    leaf) gap of the norm of Adam's first moment after the first update
    (`grad_gap`, `grad_median`); the worst (member, leaf) gap of the norm of
    the weights' change over the checked updates (`change_gap`) and the
    median over the first (`change_median_1`), leaves whose reference
    gradient is all but zero left out of the changes.  A cell's limits name
    the ones it compares."""
    lp, lr = np.asarray(program["loss"]), np.asarray(reference["loss"])
    loss = np.abs(lp - lr) / np.maximum(np.abs(lr), 1e-30)
    quiet = quiet_leaves(reference["m1"], members)

    def change_gap(at):
        change = {k: program[at][k] - program["p0"][k] for k in program[at]}
        ref_change = {k: reference[at][k] - reference["p0"][k] for k in reference[at]}
        return leaf_gaps(change, ref_change, members, skip=quiet)

    grad = leaf_gaps(program["m1"], reference["m1"], members)
    values = {"loss_gap_1": float(np.max(loss[0])),
              "grad_gap": float(np.max(grad)), "grad_median": float(np.median(grad)),
              "change_gap": float(np.max(change_gap("pK"))),
              "change_median_1": float(np.median(change_gap("p1")))}
    return values


def control(config: dict, traffic: dict, limits: dict, seed: int, device) -> dict:
    """The control's readings at `seed`: the reference in TF32 in the
    program's place, against the reference in float32."""
    seeds = derived_seeds(seed, "members", traffic["members"])
    K = limits["checked_updates"]
    fp32 = reference_readings(config, traffic, seeds, K, device)
    tf32 = reference_readings(config, traffic, seeds, K, device, tf32=True)
    return compare(tf32, fp32, traffic["members"])



def faults(config: dict, traffic: dict, limits: dict, seed: int, device, names) -> dict:
    """Each fault's readings at `seed`, by name: the reference with the fault
    planted, put in the program's place, against the reference.
    `half_batch`: each minibatch's loss over its first half only;
    `altered_action`: member 0's first env's sampled action moved by 0.5
    every rollout step (what the env and the batch get)."""
    from benchmark.reference import policy
    from benchmark.reference.ppo import PopulationPPO

    class HalfBatch(PopulationPPO):
        def _loss(self, params, obs, actions, old_log_probs, advantages, returns):
            h = obs.shape[-2] // 2
            return super()._loss(params, obs[..., :h, :], actions[..., :h, :],
                                 old_log_probs[..., :h], advantages[..., :h], returns[..., :h])

    sample = policy.sample_action

    def altered(params, obs, noise):
        action, log_prob, value = sample(params, obs, noise)
        action[0, 0] += 0.5
        return action, log_prob, value

    seeds = derived_seeds(seed, "members", traffic["members"])
    K = limits["checked_updates"]
    clean = reference_readings(config, traffic, seeds, K, device)
    out = {}
    for name in names:
        if name == "altered_action":
            policy.sample_action = altered
        try:
            planted = reference_readings(config, traffic, seeds, K, device,
                                         learner=HalfBatch if name == "half_batch" else None)
        finally:
            policy.sample_action = sample
        out[name] = compare(planted, clean, traffic["members"])
    return out

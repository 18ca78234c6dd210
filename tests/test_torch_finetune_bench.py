"""The fine-tune recipe's benchmark configuration on the CPU, at a tiny size
cut here (2 members x 8 envs x 16 steps, 4 minibatches x 2 epochs, episodes
of at most 12 steps so that they end inside a rollout): the port's
warm-started population update under adaptive rehearsal against the plain
reference `benchmark/reference/rehearsal.py`, the faults its readings must
catch, the SB3-shape selection cell's episodes against the reference's, and
the warm start and rehearsal counters of `learn/zoo.py`."""

from __future__ import annotations

import copy
import time

import pytest
import torch

from benchmark.drivers import finetune
from benchmark.harness import ROOT
from benchmark.run import cell_files, measure
from drone2d_tpu_torch.config import EnvConfig, PPOConfig
from drone2d_tpu_torch.env.types import FAMILY_NAMES
from drone2d_tpu_torch.learn import ppo, zoo
from drone2d_tpu_torch.utils import profiling

CPU = torch.device("cpu")
SEED = 3_000_000_019
CELL = "finetune-pop8-train"


def _tiny() -> dict:
    files = copy.deepcopy(cell_files(CELL))
    files["config"]["num_envs"] = 8
    files["config"]["ppo"].update(n_steps=16, num_minibatches=4, n_epochs=2)
    files["config"]["env"].update(n_steps=12, path_table_n=128)
    files["traffic"]["members"] = 2
    return files


def _trainer(files: dict) -> zoo.ZooTrainer:
    config = files["config"]
    return zoo.ZooTrainer(EnvConfig(**finetune._env_kw(config)),
                          PPOConfig(**finetune._ppo_kw(config)), config["num_envs"],
                          device="cpu")


def test_warm_started_rehearsal_update_follows_the_reference():
    """Losses, Adam's first moment and the weights' changes at rounding,
    the teacher-forced SGD's too,
    and every family of the initial reset and of the checked updates'
    templates equal, as are the per-family episode counts."""
    run = measure(_tiny(), SEED, 0.2, False, CPU, time.perf_counter())
    assert run.attempted >= 1 and run.failed == 0
    for name in ("loss_gap_1", "grad_gap", "change_gap", "change_median_1", "sgd_loss_gap",
                 "sgd_grad_gap", "sgd_change_gap", "sgd_change_median"):
        assert run.readings[name] <= 1e-5, (name, run.readings[name])
    assert run.readings["family_differ"] == 0 and run.readings["family_count_gap"] == 0
    assert run.correct, run.checks


def test_family_differ_reads_the_draw_of_the_captured_rollout(monkeypatch):
    """The update program drawing its templates with the stages weighted
    1:1:1:1:1 while the state (and so the driver's own draw) keeps the
    recipe's 3:1:1:1:1: the envs that reset into a family the template
    does not hold count into `family_differ`."""
    inputs = ppo._UpdateProgram._inputs

    def flat(state, draws):
        got = inputs(state, draws)
        probs = got[3].clone()
        probs[:, :5] = probs[:, :5].sum(dim=1, keepdim=True) / 5
        return (*got[:3], probs)

    monkeypatch.setattr(ppo._UpdateProgram, "_inputs", staticmethod(flat))
    run = measure(_tiny(), SEED, 0.1, False, CPU, time.perf_counter())
    assert run.readings["family_differ"] > 0 and not run.correct


@pytest.mark.parametrize("fault,reading", [("flat_weights", "family_differ"),
                                           ("cold_start", "change_median_1"),
                                           ("cold_start", "sgd_change_median"),
                                           ("half_batch", "sgd_grad_median")])
def test_fault_is_caught(fault, reading):
    files = _tiny()
    got = finetune.faults(files["config"], files["traffic"], files["limits"], SEED, CPU,
                          [fault])[fault]
    assert got[reading] > files["limits"]["limits"][reading], got


def test_selection_of_sb3_agents_flies_the_reference_episodes():
    """The SB3-shape selection cell cut to three of its 64-64 agents (an
    imported one among them) x 3 episodes on one scenario: every episode's
    latches and APE as the reference works them out from the flight, its
    first steps and the blocks flown from its own states within the
    cell's limits."""
    files = copy.deepcopy(cell_files("sb3-select32"))
    files["traffic"].update(stack=3, episodes=3, agents=files["traffic"]["agents"][-4:-1],
                            scenarios=["stage_2"])
    run = measure(files, 3_000_000_037, 0.1, False, CPU, time.perf_counter())
    assert run.readings["latch_differ"] == 0 and run.readings["ape_gap"] == 0
    assert run.correct, run.checks


def test_rehearsal_counters_add_what_the_state_sums():
    files = _tiny()
    trainer = _trainer(files)
    state = zoo.warm_start(trainer, [5, 6], str(ROOT / files["config"]["init"]))
    before = profiling.counters()
    counted = zoo.count_rehearsal(state)
    for _ in range(2):
        state, _ = trainer.update_jit(state)
    zoo.count_rehearsal(state, counted)
    after = profiling.counters()
    for kind, sums in (("episodes", state.family_counts), ("wins", state.family_wins)):
        want = sums.sum(0).tolist()
        got = [after[f"rehearsal.{kind}[{n}]"] - before.get(f"rehearsal.{kind}[{n}]", 0)
               for n in FAMILY_NAMES]
        assert got == want, kind
    assert after["rehearsal.episodes[schedule]"] > before.get("rehearsal.episodes[schedule]", 0)


def test_train_zoo_and_the_driver_warm_start_through_one_function(tmp_path, monkeypatch):
    files = _tiny()
    agent = str(ROOT / files["config"]["init"])
    calls = []
    real = zoo.warm_start

    def warm_start(trainer, seeds, init_params):
        calls.append(init_params)
        return real(trainer, seeds, init_params)

    monkeypatch.setattr(zoo, "warm_start", warm_start)
    trainer = _trainer(files)
    zoo.train_zoo(trainer.env.cfg, trainer.cfg, 8, [1, 2], 8 * 16, str(tmp_path),
                  snapshots=0, log_every=1, init_params=agent, device="cpu")
    measure(files, SEED, 0.1, False, CPU, time.perf_counter())
    assert calls == [agent, agent]


def test_warm_start_is_a_span():
    files = _tiny()
    profiling.enable()
    try:
        zoo.warm_start(_trainer(files), [1, 2, 3], str(ROOT / files["config"]["init"]))
    finally:
        profiling.enable(False)
    span = [s for s in profiling.spans() if s.name == "zoo.warm_start"][-1]
    assert span.attrs["members"] == 3 and span.attrs["file"].endswith("new_agent.npz")
    assert span.attrs["seconds"] > 0 and span.parent is None

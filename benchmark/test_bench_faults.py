"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card skipped (the port's CPU path, at a tiny size),
the rest of a run driven with each fault a cell can have planted in the
program, and the cell's own limits applied.  CPU only.

    python -m pytest benchmark/test_bench_faults.py -q

The faults: a step that returns its state unchanged; half of the batch left
out, the mean taken over the rest; an answer altered where it is produced;
and in the selection, an env step that goes wrong only after the steps held
against the reference's own flight.
One card runs no exchange between cards, so that fault has no cell here.
"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from benchmark.conftest import tiny
from benchmark.run import measure

CPU = torch.device("cpu")
SEED = 4_000_000_007


def _unchanged_update(monkeypatch):
    from drone2d_tpu_torch.learn.zoo import ZooTrainer

    real = ZooTrainer.update_jit

    def update_jit(self, state, *a, **kw):
        before = [p.detach().clone() for p in state.params.parameters()]
        _, metrics = real(self, state, *a, **kw)
        with torch.no_grad():
            for p, b in zip(state.params.parameters(), before):
                p.copy_(b)
        return state, metrics

    monkeypatch.setattr(ZooTrainer, "update_jit", update_jit)


def _half_minibatch(monkeypatch):
    from drone2d_tpu_torch.learn.ppo import PPOLearner

    real = PPOLearner.loss_fn

    def loss_fn(self, params, obs, actions, old_log_probs, advantages, returns, group=None):
        h = obs.shape[-2] // 2
        return real(self, params, obs[..., :h, :], actions[..., :h, :], old_log_probs[..., :h],
                    advantages[..., :h], returns[..., :h], group=group)

    monkeypatch.setattr(PPOLearner, "loss_fn", loss_fn)


def _altered_action(monkeypatch):
    from drone2d_tpu_torch.ops import fused_policy

    real = fused_policy.fused_sample_action

    def fused_sample_action(params, obs, noise):
        action, log_prob, value = real(params, obs, noise)
        action = action.clone()
        action[..., 0, 0] += 0.5
        return action, log_prob, value

    monkeypatch.setattr(fused_policy, "fused_sample_action", fused_sample_action)


def _frozen_step(monkeypatch):
    from drone2d_tpu_torch.env.env import Drone2DEnv

    real = Drone2DEnv.step

    def step(self, state, action):
        out = real(self, state, action)
        out.state = state
        return out

    monkeypatch.setattr(Drone2DEnv, "step", step)


def _late_step(monkeypatch):
    """From an episode's 33rd step on, the rotors' forces swapped: nothing
    of the first 16 steps, nor of the latches worked out from the flight,
    shows it."""
    from drone2d_tpu_torch.env.env import Drone2DEnv

    real = Drone2DEnv.step

    def step(self, state, action):
        late = (state.t >= 32)[:, None]
        return real(self, state, torch.where(late, action.flip(-1), action))

    monkeypatch.setattr(Drone2DEnv, "step", step)


def _results_patch(monkeypatch, change):
    from drone2d_tpu_torch.eval import episode

    real = episode.run_episodes_multi

    def run_episodes_multi(*a, **kw):
        res = real(*a, **kw)
        return res._replace(**change(res))

    monkeypatch.setattr(episode, "run_episodes_multi", run_episodes_multi)


def _half_agents(monkeypatch):
    """The second half of the agents' episodes left out, the first half's
    reported in their place."""
    def change(res):
        A = res.success.shape[0]
        take = np.arange(A) % max(A // 2, 1)
        return {k: getattr(res, k)[take] for k in ("success", "fail", "collision", "ape",
                                                   "time_steps", "traj", "angles")}

    _results_patch(monkeypatch, change)


def _flipped_episode(monkeypatch):
    def change(res):
        success, fail = res.success.copy(), res.fail.copy()
        success[0, 0], fail[0, 0] = not success[0, 0], not fail[0, 0]
        return {"success": success, "fail": fail}

    _results_patch(monkeypatch, change)


@pytest.mark.parametrize("cell,fault", [
    ("scratch-pop8-train", _unchanged_update), ("scratch-pop8-train", _half_minibatch),
    ("scratch-pop8-train", _altered_action), ("sb3-pop8-train", _unchanged_update),
    ("sb3-pop8-train", _half_minibatch), ("sb3-pop8-train", _altered_action),
    ("scratch-select64", _frozen_step), ("scratch-select64", _late_step),
    ("scratch-select64", _half_agents), ("scratch-select64", _flipped_episode)])
def test_fault_is_not_correct(monkeypatch, cell, fault):
    fault(monkeypatch)
    run = measure(tiny(cell), SEED, 0.1, False, CPU, time.perf_counter())
    assert not run.correct, run.checks

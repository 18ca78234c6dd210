"""Fixtures of the benchmark's own tests: a cell's files cut to a size the
CPU runs in seconds, and the card for the tests marked `cuda`."""

from __future__ import annotations

import copy

import pytest
import torch

from benchmark.run import cell_files


def tiny(name: str) -> dict:
    """Cell `name`'s files at a CPU size: 2 members x 8 envs x 16 steps, 4
    minibatches x 2 epochs; or 3 agents x 3 episodes on one scenario."""
    files = copy.deepcopy(cell_files(name))
    if files["traffic"]["driver"] == "train":
        files["config"]["num_envs"] = 8
        files["config"]["ppo"].update(n_steps=16, num_minibatches=4, n_epochs=2)
        files["traffic"]["members"] = 2
    else:
        files["traffic"].update(stack=3, episodes=3, agents=files["traffic"]["agents"][:3],
                                scenarios=["stage_2"])
    return files


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)

"""Generalized advantage estimation (counterpart of `drone2d_tpu/learn/gae.py`).

SB3 semantics: at an auto-reset boundary (done=True) the bootstrap value is
dropped, and returns = advantages + values.
"""

from __future__ import annotations

from typing import Tuple

import torch


def compute_gae(
    rewards: torch.Tensor,      # (T, N)
    values: torch.Tensor,       # (T, N) V(s_t) under the rollout policy
    dones: torch.Tensor,        # (T, N) episode ended AT step t (after acting)
    last_values: torch.Tensor,  # (N,)   V(s_T) bootstrap
    *,
    gamma: float,
    gae_lambda: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (advantages, returns), both (T, N)."""
    not_done = 1.0 - dones.to(values.dtype)
    advantages = torch.empty_like(values)
    gae = torch.zeros_like(last_values)
    next_value = last_values
    for t in reversed(range(values.shape[0])):
        nd = not_done[t]
        delta = rewards[t] + gamma * next_value * nd - values[t]
        gae = delta + gamma * gae_lambda * nd * gae
        advantages[t] = gae
        next_value = values[t]
    return advantages, advantages + values

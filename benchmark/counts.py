"""The yardstick's own operation and byte counts, and the H100's peaks.

Counts are functions of the shapes alone, never of a trace.  The roofline
and `mfu` readers divide them by device or window time from a run.

Peaks: NVIDIA's data sheet for the H100 SXM at its 700 W limit, dense:
67 TFLOP/s in float32 on the CUDA cores (the port computes in float32 with
TF32 off) and 3.35 TB/s of HBM3.  A run reports the card's power limit
beside every share.
"""

from __future__ import annotations

PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def policy_forward_flops(hidden: int, obs_dim: int = 27) -> int:
    """Float32 FLOPs of one row through the actor-critic: both tanh trunks
    of two layers of width `hidden` and the three head dot products (two
    action means, one value), multiply and add counted apart."""
    return 2 * 2 * (obs_dim * hidden + hidden * hidden) + 2 * 3 * hidden


def policy_kernel_work(rows: int, hidden: int, members: int = 1, obs_dim: int = 27) -> dict:
    """What one launch of the fused policy sample must do over `rows` rows
    (all members' together): its FLOPs, and the bytes it must move (obs and
    noise read once, each member's weights read once, action, log-prob and
    value written once)."""
    n_params = 2 * (obs_dim * hidden + hidden + hidden * hidden + hidden) + hidden * 3 + 3 + 2
    return {"flops": rows * policy_forward_flops(hidden, obs_dim),
            "bytes": 4 * (rows * obs_dim + rows * 2 + members * n_params + rows * 2 + 2 * rows)}


def bound_seconds(work: dict) -> float:
    """The least time the card could take for `work`: its FLOPs at the
    float32 peak or its bytes at the HBM peak, whichever is longer."""
    return max(work["flops"] / PEAK_F32_FLOPS, work["bytes"] / PEAK_BYTES)


def update_model_flops(members: int, num_envs: int, n_steps: int, n_epochs: int,
                       hidden: int) -> int:
    """Model FLOPs of one PPO update of a population: the rollout's forward
    pass a step and env, the last values' pass, and for every SGD sample and
    epoch a forward and a backward pass, counted as three forward passes."""
    rows = members * num_envs
    forward = policy_forward_flops(hidden)
    return forward * rows * (n_steps + 1) + 3 * forward * rows * n_steps * n_epochs


def eval_step_flops(agents: int, episodes: int, hidden: int) -> int:
    """Model FLOPs of one lockstep eval step: the forward pass of every
    agent's stack over its episodes."""
    return policy_forward_flops(hidden) * agents * episodes

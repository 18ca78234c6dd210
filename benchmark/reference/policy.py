# Frozen copy of the plain math of `drone2d_tpu_torch/models/policy.py` and
# `fused_sample_action_ref` of `drone2d_tpu_torch/ops/fused_policy.py` at
# commit 012002a, written over a dict of leaves instead of an nn.Module.
"""The actor-critic of the port in plain PyTorch, float32.

Leaves are named as in the agent `.npz` files (`pi0/w`, `vf_out/b`,
`log_std`); weights are stored (in, out), so `x @ w + b` is the product.
Every function takes a population: each leaf carries a leading member axis
S and a batch is (S, B, ...).
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np
import torch

_LOG_2PI = math.log(2.0 * math.pi)


def init_member(seed: int, obs_dim: int, act_dim: int, hidden: Sequence[int]) -> Dict:
    """One member's weights as SB3's MlpPolicy starts them: orthogonal, gain
    sqrt(2) on the hidden layers, 0.01 on the action head, 1.0 on the value
    head, zero biases and log_std, drawn on the host from a generator
    seeded with `seed` in the order pi trunk, vf trunk, pi_out, vf_out."""
    gen = torch.Generator().manual_seed(int(seed))
    dims = [obs_dim, *hidden]
    out = {}
    for trunk in ("pi", "vf"):
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            out[f"{trunk}{i}/w"] = torch.zeros(a, b)
            out[f"{trunk}{i}/b"] = torch.zeros(b)
    out["pi_out/w"], out["pi_out/b"] = torch.zeros(hidden[-1], act_dim), torch.zeros(act_dim)
    out["vf_out/w"], out["vf_out/b"] = torch.zeros(hidden[-1], 1), torch.zeros(1)
    out["log_std"] = torch.zeros(act_dim)
    for trunk in ("pi", "vf"):
        for i in range(len(hidden)):
            torch.nn.init.orthogonal_(out[f"{trunk}{i}/w"], math.sqrt(2.0), generator=gen)
    torch.nn.init.orthogonal_(out["pi_out/w"], 0.01, generator=gen)
    torch.nn.init.orthogonal_(out["vf_out/w"], 1.0, generator=gen)
    return out


def load_npz(path: str) -> Dict:
    """An agent file's leaves as float32 host tensors."""
    with np.load(path) as z:
        return {k: torch.tensor(np.asarray(z[k], np.float32)) for k in z.files}


def stack(members: Sequence[Dict], device) -> Dict:
    """A population: each leaf stacked along a new leading axis, on `device`,
    as leaves that take gradients."""
    return {k: torch.stack([m[k] for m in members]).to(device).requires_grad_(True)
            for k in members[0]}


def n_hidden(params: Dict) -> int:
    n = 0
    while f"pi{n}/w" in params:
        n += 1
    return n


def _dense(params, name, x):
    return torch.matmul(x, params[f"{name}/w"]) + params[f"{name}/b"][:, None, :]


def _trunk(params, trunk, x):
    for i in range(n_hidden(params)):
        x = torch.tanh(_dense(params, f"{trunk}{i}", x))
    return x


def policy_value(params: Dict, obs: torch.Tensor):
    """obs (S, B, obs_dim) -> (action mean (S, B, 2), log_std (S, 2), value (S, B))."""
    mean = _dense(params, "pi_out", _trunk(params, "pi", obs))
    value = _dense(params, "vf_out", _trunk(params, "vf", obs))[..., 0]
    return mean, params["log_std"], value


@torch.no_grad()
def sample_action(params: Dict, obs: torch.Tensor, noise: torch.Tensor):
    """a = mean + exp(log_std) * noise -> (action (S, B, 2), log_prob (S, B),
    value (S, B)); log_prob of the unclipped sample."""
    mean, log_std, value = policy_value(params, obs)
    log_std = log_std[:, None, :]
    action = mean + torch.exp(log_std) * noise
    log_prob = torch.sum(-0.5 * (noise**2 + _LOG_2PI) - log_std, dim=-1)
    return action, log_prob, value


def action_log_prob_entropy(params: Dict, obs: torch.Tensor, action: torch.Tensor):
    """(log_prob (S, B), entropy (S, B), value (S, B)), differentiable."""
    mean, log_std, value = policy_value(params, obs)
    log_std = log_std[:, None, :]
    z = (action - mean) / torch.exp(log_std)
    log_prob = torch.sum(-0.5 * (z**2 + _LOG_2PI) - log_std, dim=-1)
    entropy = torch.sum(log_std + 0.5 * (_LOG_2PI + 1.0), dim=-1).expand(log_prob.shape)
    return log_prob, entropy, value

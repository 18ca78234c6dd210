"""Actor-critic MLP, parity with SB3 `PPO("MlpPolicy", ...)`.

Counterpart of `drone2d_tpu/models/policy.py`: separate policy and value
trunks of tanh layers, a linear action-mean head and value head, and a
state-independent log_std.  Weights are stored (in, out) as in the JAX
package, so `x @ w + b` is the same product and the `.npz` agent files map
leaf for leaf (`params_to_flat_dict` / `flat_dict_to_params`).

A population (the zoo's seeds, or the agents of a batched eval) is one
`ActorCritic` whose every leaf carries a leading member axis S, as the JAX
package's vmapped parameters do: `stack_params` builds it from S members,
`member(i)` views one of them and `unstack_params` copies them out.  Its
methods take a batch a member, (S, B, ...), and return (S, B, ...).
"""

from __future__ import annotations

import copy
import math
from typing import Mapping, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from drone2d_tpu_torch.device import resolve_device

_LOG_2PI = math.log(2.0 * math.pi)


class Dense(nn.Module):
    """y = x @ w + b with w stored (in, out); with `members` S, w is (S, in,
    out), b (S, out) and x (S, B, in), one product a member."""

    def __init__(self, n_in: int, n_out: int, members: int | None = None):
        super().__init__()
        lead = () if members is None else (members,)
        self.w = nn.Parameter(torch.zeros(*lead, n_in, n_out))
        self.b = nn.Parameter(torch.zeros(*lead, n_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.w.dim() == 3:
            return torch.matmul(x, self.w) + self.b[:, None, :]
        return x @ self.w + self.b


class ActorCritic(nn.Module):
    """SB3 MlpPolicy-shaped actor-critic.

    `generator` seeds SB3's orthogonal init (gain sqrt(2) on hidden layers,
    0.01 on the action head, 1.0 on the value head, zero biases).  Weights
    are made on the host from that generator and then moved to `device`
    (the card unless device="cpu").  With `members` S every leaf carries a
    leading axis of S zero members, for `stack_params` to fill.
    """

    def __init__(
        self,
        obs_dim: int = 27,
        act_dim: int = 2,
        hidden: Sequence[int] = (64, 64),
        *,
        generator: torch.Generator | None = None,
        device=None,
        members: int | None = None,
    ):
        super().__init__()

        def trunk():
            dims = [obs_dim, *hidden]
            return nn.ModuleList(Dense(a, b, members) for a, b in zip(dims[:-1], dims[1:]))

        self.pi = trunk()
        self.vf = trunk()
        self.pi_out = Dense(hidden[-1], act_dim, members)
        self.vf_out = Dense(hidden[-1], 1, members)
        self.log_std = nn.Parameter(torch.zeros(*(() if members is None else (members,)), act_dim))
        if members is None:
            with torch.no_grad():
                for layer in [*self.pi, *self.vf]:
                    nn.init.orthogonal_(layer.w, math.sqrt(2.0), generator=generator)
                nn.init.orthogonal_(self.pi_out.w, 0.01, generator=generator)
                nn.init.orthogonal_(self.vf_out.w, 1.0, generator=generator)
        self.to(resolve_device(device))

    @property
    def members(self) -> int | None:
        """S for a population, None for one actor-critic."""
        return self.log_std.shape[0] if self.log_std.dim() == 2 else None

    def member(self, i: int) -> "ActorCritic":
        """Member i of a population as an ActorCritic whose leaves are views
        of the population's (no copy: they see its updates)."""
        hidden = [layer.w.shape[-1] for layer in self.pi]
        out = ActorCritic(self.pi[0].w.shape[-2], self.log_std.shape[-1], hidden,
                          device=self.log_std.device, members=1)
        for name, p in self.named_parameters():
            module, leaf = out.get_submodule(name.rpartition(".")[0]), name.rpartition(".")[2]
            setattr(module, leaf, nn.Parameter(p.detach()[i], requires_grad=False))
        return out

    @staticmethod
    def _mlp(layers, x):
        for layer in layers:
            x = torch.tanh(layer(x))
        return x

    def policy_value(
        self, obs: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(action_mean (B, 2), log_std (2,), value (B,)); for a population,
        obs (S, B, obs_dim) -> ((S, B, 2), (S, 2), (S, B))."""
        mean = self.pi_out(self._mlp(self.pi, obs))
        value = self.vf_out(self._mlp(self.vf, obs))[..., 0]
        return mean, self.log_std, value

    def sample_action(
        self,
        obs: torch.Tensor,
        generator: torch.Generator | None = None,
        noise: torch.Tensor | None = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """a ~ N(mean, exp(log_std)^2) -> (action, log_prob, value).

        `noise` is the (B, 2) standard-normal draw; when it is None it is
        drawn from `generator`.  A population takes obs (S, B, obs_dim) and
        noise (S, B, 2) and returns ((S, B, 2), (S, B), (S, B)), all its
        members in one launch of the kernel.  Runs through `ops.fused_policy`: on the CPU
        that is the plain version, for any `hidden`; on a CUDA tensor it
        launches the hand-written kernel, which takes two hidden layers of
        one width (a multiple of 8 up to 256) and raises
        NotImplementedError on any other architecture.  Forward only: the
        outputs carry no gradient.  log_prob is of the unclipped sample (SB3
        semantics; clipping happens only on the copy sent to the env).
        """
        from drone2d_tpu_torch.ops.fused_policy import fused_sample_action

        if noise is None:
            noise = torch.randn(*obs.shape[:-1], self.log_std.shape[-1],
                                generator=generator, device=obs.device)
        return fused_sample_action(self, obs, noise)

    def action_log_prob_entropy(
        self, obs: torch.Tensor, action: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(log_prob(action) (B,), entropy (B,), value (B,)) for PPO's update
        pass: differentiable plain torch through `policy_value`.  The
        entropy depends on log_std only and is broadcast to the batch.  A
        population takes (S, B, ...) and returns (S, B) each."""
        mean, log_std, value = self.policy_value(obs)
        if self.members is not None:
            log_std = log_std[:, None, :]
        z = (action - mean) / torch.exp(log_std)
        log_prob = torch.sum(-0.5 * (z**2 + _LOG_2PI) - log_std, dim=-1)
        entropy = torch.sum(log_std + 0.5 * (_LOG_2PI + 1.0), dim=-1).expand(log_prob.shape)
        return log_prob, entropy, value

    def deterministic_action(self, obs: torch.Tensor) -> torch.Tensor:
        """Greedy action clipped to the Box bounds (SB3 predict)."""
        mean, _, _ = self.policy_value(obs)
        return torch.clamp(mean, -1.0, 1.0)


def stack_params(members: Sequence[ActorCritic]) -> ActorCritic:
    """A population of copies of `members` (one architecture, one device),
    each leaf stacked along a new leading axis: every member owns its own
    rows, so an in-place update of one touches no other."""
    first = members[0]
    hidden = [layer.w.shape[-1] for layer in first.pi]
    out = ActorCritic(first.pi[0].w.shape[-2], first.log_std.shape[-1], hidden,
                      device=first.log_std.device, members=len(members))
    by_member = [dict(m.named_parameters()) for m in members]
    with torch.no_grad():
        for name, p in out.named_parameters():
            p.copy_(torch.stack([d[name].detach() for d in by_member]))
    return out


def unstack_params(params: ActorCritic) -> list:
    """The members of a population as S independent ActorCritics (copies)."""
    return [copy.deepcopy(params.member(i)).requires_grad_(True)
            for i in range(params.members)]


def params_to_flat_dict(params: ActorCritic) -> dict:
    """Flat `.npz` naming of the JAX package (models/policy.py:126-170), as
    numpy arrays.  Also takes any tree of that layout with numpy leaves (the
    JAX package's `ActorCriticParams`, or optax's Adam moments of it).  A
    population's arrays keep their member axis; `member(i)` gives one
    member's agent file."""
    def npy(t):
        return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)

    out = {"log_std": npy(params.log_std)}
    for name, layers in (("pi", params.pi), ("vf", params.vf)):
        for i, layer in enumerate(layers):
            out[f"{name}{i}/w"] = npy(layer.w)
            out[f"{name}{i}/b"] = npy(layer.b)
    for name in ("pi_out", "vf_out"):
        out[f"{name}/w"] = npy(getattr(params, name).w)
        out[f"{name}/b"] = npy(getattr(params, name).b)
    return out


def flat_dict_to_params(flat: Mapping[str, np.ndarray], device=None) -> ActorCritic:
    """Inverse of params_to_flat_dict; accepts an `np.load` of an agent."""
    hidden = []
    while f"pi{len(hidden)}/w" in flat:
        hidden.append(np.shape(flat[f"pi{len(hidden)}/w"])[1])
    obs_dim = np.shape(flat["pi0/w"])[0]
    act_dim = np.shape(flat["log_std"])[0]
    model = ActorCritic(obs_dim, act_dim, hidden, device="cpu")
    model.load_state_dict({state_dict_key(key): torch.tensor(np.asarray(value, np.float32))
                           for key, value in flat.items()})
    return model.to(resolve_device(device))


def state_dict_key(flat_name: str) -> str:
    """An agent file's name ("pi0/w", "vf_out/b", "log_std") -> the
    ActorCritic state_dict key ("pi.0.w", "vf_out.b", "log_std")."""
    name = flat_name.replace("/", ".")
    return name[:2] + "." + name[2:] if name[2].isdigit() else name

"""The learner's optimizer: optax's
`chain(clip_by_global_norm(max_norm), adam(lr, eps=1e-5))`
(`drone2d_tpu/learn/ppo.py:183-186`), which has no module of its own in the
JAX package.

`torch.optim.Adam` computes the algebra of `optax.adam`: the step count is
incremented before the bias correction, eps is added outside the square
root, and optax's `eps_root` is 0.  Only the rounding order differs.  The
clip is written out because `torch.nn.utils.clip_grad_norm_` scales by
`max_norm / (norm + 1e-6)`, which optax does not.

For a population (leaves with a leading member axis, `learn/zoo.py`) Adam is
elementwise, so one Adam over the stacked leaves is S independent Adams with
one shared step count, as `vmap(optax.adam)` is; the clip is taken per
member (`clip_by_global_norm_(..., members=S)`).
"""

from __future__ import annotations

from typing import Iterable, List

import torch

ADAM_EPS = 1e-5  # SB3's Adam eps (learn/ppo.py:185)


def adam(params: Iterable[torch.nn.Parameter], lr: float) -> torch.optim.Adam:
    """`optax.adam(lr, eps=1e-5)` over `params`: betas (0.9, 0.999), no
    weight decay, no amsgrad.  Updates the parameters in place, so each
    keeps its own allocation (the fused policy kernel reads them by pointer
    and checks their alignment).

    On a CUDA device it is `capturable`: the step count lives on the card
    and the bias correction is computed there, so that a CUDA graph can
    capture the step (`PPOLearner.update_jit`), and the eager update runs
    the same arithmetic as the captured one.  On the CPU it is not (torch
    refuses a capturable Adam there)."""
    params = list(params)
    capturable = bool(params) and params[0].device.type == "cuda"
    opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=ADAM_EPS,
                           capturable=capturable)
    # the eager update steps this capturable Adam outside a graph on purpose:
    # no warning about it
    opt._warned_capturable_if_run_uncaptured = True
    return opt


def load_state_dict(opt: torch.optim.Adam, state_dict: dict) -> None:
    """`opt.load_state_dict(state_dict)`, keeping `opt`'s own `capturable`:
    a state saved on one device type (and loaded to the CPU) then resumes
    on the other: the step count goes to the card for a capturable Adam
    and stays where it is for the other."""
    own = [g["capturable"] for g in opt.param_groups]
    groups = [{**g, "capturable": c} for g, c in zip(state_dict["param_groups"], own)]
    opt.load_state_dict({**state_dict, "param_groups": groups})


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float,
                         members: int | None = None) -> torch.Tensor:
    """`optax.clip_by_global_norm(max_norm)` in place on `grads`.

    With the global norm n = sqrt(sum of every leaf's squares), each leaf t
    is left as it is when n < max_norm and becomes (t / n) * max_norm
    otherwise, with no epsilon.  The choice is made on the device, with no
    copy to the host: every leaf is divided by 1 or n and multiplied by 1
    or max_norm, and dividing or multiplying by 1 is exact.  Returns n.

    With `members` S every leaf carries a leading member axis, and this is
    `vmap(optax.clip_by_global_norm(max_norm))`: member m's norm is taken
    over its slice of every leaf and clips that slice alone; returns the
    (S,) norms.
    """
    if members is None:
        norm = torch.nn.utils.get_total_norm(grads, 2.0)
    else:
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g.reshape(members, -1), dim=1) for g in grads]), dim=0)
    keep = norm < max_norm
    div, mul = torch.where(keep, 1.0, norm), torch.where(keep, 1.0, max_norm)
    if members is None:
        torch._foreach_div_(grads, div)
        torch._foreach_mul_(grads, mul)
    else:
        for g in grads:
            shape = (members,) + (1,) * (g.dim() - 1)
            g.div_(div.view(shape)).mul_(mul.view(shape))
    return norm

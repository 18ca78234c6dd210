"""The learner's optimizer: optax's
`chain(clip_by_global_norm(max_norm), adam(lr, eps=1e-5))`
(`drone2d_tpu/learn/ppo.py:183-186`), which has no module of its own in the
JAX package.

`torch.optim.Adam` computes the algebra of `optax.adam`: the step count is
incremented before the bias correction, eps is added outside the square
root, and optax's `eps_root` is 0.  Only the rounding order differs.  The
clip is written out because `torch.nn.utils.clip_grad_norm_` scales by
`max_norm / (norm + 1e-6)`, which optax does not.
"""

from __future__ import annotations

from typing import Iterable, List

import torch

ADAM_EPS = 1e-5  # SB3's Adam eps (learn/ppo.py:185)


def adam(params: Iterable[torch.nn.Parameter], lr: float) -> torch.optim.Adam:
    """`optax.adam(lr, eps=1e-5)` over `params`: betas (0.9, 0.999), no
    weight decay, no amsgrad.  Updates the parameters in place, so each
    keeps its own allocation (the fused policy kernel reads them by pointer
    and checks their alignment)."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=ADAM_EPS)


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """`optax.clip_by_global_norm(max_norm)` in place on `grads`.

    With the global norm n = sqrt(sum of every leaf's squares), each leaf t
    is left as it is when n < max_norm and becomes (t / n) * max_norm
    otherwise, with no epsilon.  The choice is made on the device, with no
    copy to the host: every leaf is divided by 1 or n and multiplied by 1
    or max_norm, and dividing or multiplying by 1 is exact.  Returns n.
    """
    norm = torch.nn.utils.get_total_norm(grads, 2.0)
    keep = norm < max_norm
    torch._foreach_div_(grads, torch.where(keep, 1.0, norm))
    torch._foreach_mul_(grads, torch.where(keep, 1.0, max_norm))
    return norm

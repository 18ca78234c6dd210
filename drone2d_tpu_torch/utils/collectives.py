"""The update's collectives over a `torch.distributed` process group: a
tensor's mean over the ranks, and a minibatch step's gradients and (loss,
*aux) row averaged in one all_reduce.  The plain step (`learn/ppo.py`) and
the SGD kernel's wrapper (`ops/ppo_sgd.py`) both reduce through these.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def all_reduce_mean_(x: torch.Tensor, group) -> torch.Tensor:
    """The mean of `x` over the ranks of `group`, in place: all_reduce SUM,
    then a division by the world size (by 1.0, exact, for one rank).  Only
    `all_reduce`, which gloo and NCCL both run on CUDA tensors."""
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x.div_(float(dist.get_world_size(group)))


def all_reduce_grads_(leaves, row: torch.Tensor, group) -> torch.Tensor:
    """Average every leaf's gradient and the minibatch's (loss, *aux) `row`
    over the ranks of `group` in one all_reduce: the gradients and the row
    flattened into one buffer, reduced, divided by the world size and
    copied back into the gradients.  Returns the reduced row.

    The copy keeps each gradient in its own allocation: views into the
    buffer would sit at offsets that are not 16-byte aligned, and CUDA's
    multi-tensor norm (the clip) then sums in another order than for the
    plain update's gradients."""
    grads = [p.grad for p in leaves]
    flat = all_reduce_mean_(torch.cat([g.reshape(-1) for g in grads] + [row.reshape(-1)]),
                            group)
    parts = torch.split(flat, [g.numel() for g in grads] + [row.numel()])
    torch._foreach_copy_(grads, [x.view_as(g) for x, g in zip(parts, grads)])
    return parts[-1].view_as(row)

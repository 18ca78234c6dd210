# Frozen copy of `constant` from `drone2d_tpu_torch/device.py` at commit
# 012002a: the env step's few small constants, made once a device and dtype.
"""Small constant tensors shared by the reference's env step."""

from __future__ import annotations

import functools

import torch


def constant(values, like: torch.Tensor) -> torch.Tensor:
    """A small constant tensor of `values` (a sequence, or a sequence of
    sequences) in `like`'s dtype, on its device, made once and then reused.
    Read-only: never write to it."""
    key = tuple(tuple(v) if isinstance(v, (list, tuple)) else v for v in values)
    return _constant(key, like.dtype, like.device)


@functools.cache
def _constant(values: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype, device=device)

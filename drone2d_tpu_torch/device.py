"""Where the port runs: the CUDA card unless the caller asks for the CPU."""

from __future__ import annotations

import functools

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    `None` means the card: it raises when CUDA is absent and never falls back
    to the CPU on its own.  Pass `device="cpu"` to run on the host (the tests
    do).  Also pins float32 matrix products and convolutions to full float32:
    the JAX package computes in float32, and TF32 keeps only ~3 decimal
    digits, which would break parity with it.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the host"
        )
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the work queued on `device`: eager CUDA launches return
    before the card has run them.  Nothing to wait for on the CPU."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def constant(values, like: torch.Tensor) -> torch.Tensor:
    """A small constant tensor of `values` (a sequence, or a sequence of
    sequences) in `like`'s dtype, on its device, made once and then reused.
    The env step builds its few constants this way: a CUDA graph reads the
    one kept copy, where a fresh `new_tensor` would copy from the host
    inside the capture, which CUDA refuses.  Read-only: never write to it."""
    key = tuple(tuple(v) if isinstance(v, (list, tuple)) else v for v in values)
    return _constant(key, like.dtype, like.device)


@functools.cache
def _constant(values: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype, device=device)

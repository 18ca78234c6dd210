"""The CUDA probe of the port's CLI entry points (counterpart of
`drone2d_tpu/utils/runtime.py`)."""

from __future__ import annotations

import torch


def wait_for_accelerator() -> str:
    """Check that the CUDA card is there and runs a first operation; returns
    its name.  Raises RuntimeError with the reason when CUDA is absent or
    the card fails: the port never falls back to the CPU on its own (pass
    `--device cpu` to run on the host)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port trains on an NVIDIA GPU "
            "(pass --device cpu to run on the host)"
        )
    torch.ones(1, device="cuda").add_(1)
    torch.cuda.synchronize()
    return torch.cuda.get_device_name(0)

"""Fused actor-critic forward + Gaussian sample: the Hopper kernel and its
plain version.

Replaces the TPU kernel `drone2d_tpu/ops/pallas_policy.py::fused_sample_action`
with `csrc/fused_policy.cu`, a CUDA kernel written by hand for `sm_90a` and
called through ctypes.  It computes exactly `ActorCritic.sample_action`
with the standard-normal noise as an input: both 2-hidden-layer tanh trunks,
the mean and value heads, `action = mean + exp(log_std) * noise` and the
diagonal-Gaussian log-prob.

Bound on the card: at B=4096 and H=128 the products are 80,128 FLOP a row,
328 MFLOP a call, against ~0.7 MB of traffic, so the kernel is bound by
float32 operations on the CUDA cores (4.9 us at 67 TFLOP/s; the bytes alone
would take 0.2 us).  The design (see the source's header) keeps each block's
rows and both hidden layers in shared memory and reuses every weight it
loads for all of the block's rows; it does not copy the TPU kernel's
block-diagonal packing, which would double the arithmetic here.

`fused_sample_action` takes a CPU tensor through the plain version and a
CUDA tensor through the kernel; there is no fallback between the two.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import torch

from drone2d_tpu_torch.ops import cuda_build

_LOG_2PI = math.log(2.0 * math.pi)
HIDDEN_WIDTHS = (64, 128, 256)  # the kernel's compiled widths


def fused_sample_action_ref(params, obs: torch.Tensor, noise: torch.Tensor):
    """The plain PyTorch version: (action (B, 2), log_prob (B,), value (B,))."""
    mean, log_std, value = params.policy_value(obs)
    action = mean + torch.exp(log_std) * noise
    log_prob = torch.sum(-0.5 * (noise**2 + _LOG_2PI) - log_std, dim=-1)
    return action, log_prob, value


@functools.cache
def _library():
    import ctypes

    lib = ctypes.CDLL(str(cuda_build.build("fused_policy")["path"]))
    fn = lib.fused_sample_action_launch
    fn.argtypes = (
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        + [ctypes.c_void_p] * 18
    )
    fn.restype = ctypes.c_int
    return fn


def _tensors(params):
    """The kernel's weight operands, checked: exactly two hidden layers of
    one width H in each trunk, float32, contiguous."""
    if len(params.pi) != 2 or len(params.vf) != 2:
        raise ValueError("fused_sample_action needs exactly 2 hidden layers a trunk")
    (p0, p1), (v0, v1) = params.pi, params.vf
    obs_dim, h = p0.w.shape
    shapes = {
        "pi0/w": (p0.w, (obs_dim, h)), "pi0/b": (p0.b, (h,)),
        "pi1/w": (p1.w, (h, h)), "pi1/b": (p1.b, (h,)),
        "vf0/w": (v0.w, (obs_dim, h)), "vf0/b": (v0.b, (h,)),
        "vf1/w": (v1.w, (h, h)), "vf1/b": (v1.b, (h,)),
        "pi_out/w": (params.pi_out.w, (h, 2)), "pi_out/b": (params.pi_out.b, (2,)),
        "vf_out/w": (params.vf_out.w, (h, 1)), "vf_out/b": (params.vf_out.b, (1,)),
        "log_std": (params.log_std, (2,)),
    }
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want {shape}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32")
    if h not in HIDDEN_WIDTHS:
        raise ValueError(f"hidden width {h} not in {HIDDEN_WIDTHS}")
    return obs_dim, h, [t.detach() for t, _ in shapes.values()]


def fused_sample_action(
    params, obs: torch.Tensor, noise: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(action (B, 2), log_prob (B,), value (B,)) for obs (B, obs_dim) and
    standard-normal noise (B, 2); forward only (no gradient).

    A CPU `obs` goes through `fused_sample_action_ref`; a CUDA `obs` launches
    the kernel or raises.  `fused_sample_action.launches` counts the kernel
    launches.
    """
    obs_dim, h, weights = _tensors(params)
    B = obs.shape[0]
    if obs.dim() != 2 or obs.shape[1] != obs_dim:
        raise ValueError(f"obs has shape {tuple(obs.shape)}, want (B, {obs_dim})")
    if tuple(noise.shape) != (B, 2):
        raise ValueError(f"noise has shape {tuple(noise.shape)}, want ({B}, 2)")
    for name, t in (("obs", obs), ("noise", noise)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32")
    for t in [noise, *weights]:
        if t.device != obs.device:
            raise ValueError(f"operands on {t.device} and {obs.device}")

    if obs.device.type == "cpu":
        with torch.no_grad():
            return fused_sample_action_ref(params, obs, noise)
    if obs.device.type != "cuda":
        raise ValueError(f"unsupported device {obs.device}")

    action = torch.empty((B, 2), dtype=torch.float32, device=obs.device)
    logp = torch.empty((B,), dtype=torch.float32, device=obs.device)
    value = torch.empty((B,), dtype=torch.float32, device=obs.device)
    p0w, p0b, p1w, p1b, v0w, v0b, v1w, v1b, pow_, pob, vow, vob, log_std = weights
    with torch.cuda.device(obs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library()(
            obs.data_ptr(), B, obs_dim, h,
            p0w.data_ptr(), p0b.data_ptr(), p1w.data_ptr(), p1b.data_ptr(),
            v0w.data_ptr(), v0b.data_ptr(), v1w.data_ptr(), v1b.data_ptr(),
            pow_.data_ptr(), pob.data_ptr(), vow.data_ptr(), vob.data_ptr(),
            log_std.data_ptr(), noise.data_ptr(),
            action.data_ptr(), logp.data_ptr(), value.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_sample_action kernel launch failed: CUDA error {err}")
    fused_sample_action.launches += 1
    return action, logp, value


fused_sample_action.launches = 0

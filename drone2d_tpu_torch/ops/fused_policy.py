"""Fused actor-critic forward + Gaussian sample: the Hopper kernel and its
plain version.

Replaces the TPU kernel `drone2d_tpu/ops/pallas_policy.py::fused_sample_action`
with `csrc/fused_policy.cu`, a CUDA kernel written by hand for `sm_90a` and
called through ctypes.  It computes exactly `ActorCritic.sample_action`
with the standard-normal noise as an input: both tanh trunks, the mean and
value heads, `action = mean + exp(log_std) * noise` and the diagonal-Gaussian
log-prob.

Bounds on the card at B=4096 and H=128: 328 MFLOP a call against ~0.7 MB
of traffic, i.e. 4.9 us of float32 work on the CUDA cores at 67 TFLOP/s
(the bytes alone would take 0.2 us).  The kernel runs its matrix products
on the tensor cores, float32-accurate through fp16 pieces (three MMAs a
product, 3 x 325 MFLOP, 1.0 us at 989 TFLOP/s).  The design (see the
source's header) keeps 32 rows a block, stages the weights in shared memory
with bulk asynchronous copies, and keeps both hidden layers on the chip; it
does not copy the TPU kernel's block-diagonal packing, which would double
the arithmetic here.

`fused_sample_action` takes a CPU tensor through the plain version, for any
actor-critic, and a CUDA tensor through the kernel, which takes two hidden
layers of one width H (a multiple of 8 from 8 to 256), obs_dim up to 32
and two actions, and raises `NotImplementedError` on any other
architecture.  There is no fallback between the two.

A population (an `ActorCritic` whose leaves carry a leading member axis S,
`models/policy.stack_params`) takes obs (S, N, obs_dim) and noise (S, N, 2)
in one launch: the kernel runs member a on grid row a, and each member's
outputs are bit-equal to its own unstacked launch.  The JAX package has no
such kernel: its zoo vmaps plain `sample_action`.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import torch

from drone2d_tpu_torch.ops import cuda_build

_LOG_2PI = math.log(2.0 * math.pi)
MAX_HIDDEN, MAX_OBS_DIM = 256, 32  # the kernel's limits (H a multiple of 8)


def fused_sample_action_ref(params, obs: torch.Tensor, noise: torch.Tensor):
    """The plain PyTorch version: (action (B, act_dim), log_prob (B,), value (B,)).
    A population is sampled member by member, each exactly as unstacked."""
    if params.members is not None:
        outs = [fused_sample_action_ref(params.member(i), obs[i], noise[i])
                for i in range(params.members)]
        return tuple(torch.stack(o) for o in zip(*outs))
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
        [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 18
    )
    fn.restype = ctypes.c_int
    return fn


# the leaves the kernel reads with __ldg, a float at a time: 4-byte
# alignment is enough (a member's slice of them is 4 or 8 bytes long); the
# kernel copies every other leaf in bulk, from 16-byte aligned addresses
_SCALAR_LEAVES = ("pi_out/b", "vf_out/b", "log_std")


def architecture(params, kernel: str = "fused_sample_action") -> tuple:
    """(obs_dim, H) of an actor-critic that the port's kernels take (this
    one and `ops/ppo_sgd.py`'s): two hidden layers of one width H, a
    multiple of 8 up to MAX_HIDDEN, obs_dim up to MAX_OBS_DIM and two
    actions.  Raises NotImplementedError, naming `kernel`, for any other."""
    hidden = tuple(layer.w.shape[-1] for layer in params.pi)
    vf_hidden = tuple(layer.w.shape[-1] for layer in params.vf)
    obs_dim, act_dim = params.pi[0].w.shape[-2], params.log_std.shape[-1]
    h = hidden[0] if hidden else 0
    if not (len(hidden) == 2 and hidden[1] == h and vf_hidden == hidden
            and h % 8 == 0 and 8 <= h <= MAX_HIDDEN
            and obs_dim <= MAX_OBS_DIM and act_dim == 2):
        raise NotImplementedError(
            f"{kernel} on the card takes two hidden layers of one width H "
            f"(H a multiple of 8, 8 <= H <= {MAX_HIDDEN}), obs_dim <= {MAX_OBS_DIM} and "
            f"2 actions; got hidden {hidden} (value trunk {vf_hidden}), "
            f"obs_dim {obs_dim}, act_dim {act_dim}")
    return obs_dim, h


def _kernel_operands(params):
    """The kernel's weight operands, checked.  Raises NotImplementedError
    for an architecture the kernel does not take, ValueError for operands
    it cannot read (dtype, layout, alignment)."""
    obs_dim, h = architecture(params)
    (p0, p1), (v0, v1) = params.pi, params.vf
    weights = {
        "pi0/w": p0.w, "pi0/b": p0.b, "pi1/w": p1.w, "pi1/b": p1.b,
        "vf0/w": v0.w, "vf0/b": v0.b, "vf1/w": v1.w, "vf1/b": v1.b,
        "pi_out/w": params.pi_out.w, "pi_out/b": params.pi_out.b,
        "vf_out/w": params.vf_out.w, "vf_out/b": params.vf_out.b,
        "log_std": params.log_std,
    }
    for name, t in weights.items():
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32")
        align = 4 if name in _SCALAR_LEAVES else 16
        if t.data_ptr() % align:
            raise ValueError(f"{name} must be {align}-byte aligned for the kernel")
    return obs_dim, h, [t.detach() for t in weights.values()]


def fused_sample_action(
    params, obs: torch.Tensor, noise: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(action (B, act_dim), log_prob (B,), value (B,)) for obs (B, obs_dim)
    and standard-normal noise (B, act_dim); forward only (no gradient).  A
    population of S takes obs (S, N, obs_dim) and noise (S, N, act_dim) and
    returns ((S, N, act_dim), (S, N), (S, N)).

    A CPU `obs` goes through `fused_sample_action_ref`, for any actor-critic;
    a CUDA `obs` launches the kernel or raises (NotImplementedError for an
    architecture the kernel does not take).  `fused_sample_action.launches`
    counts the kernel launches: one a call, whatever S.
    """
    obs_dim, act_dim = params.pi[0].w.shape[-2], params.log_std.shape[-1]
    lead = () if params.members is None else (params.members,)
    if obs.dim() != 2 + len(lead) or tuple(obs.shape[:len(lead)]) != lead \
            or obs.shape[-1] != obs_dim:
        want = ", ".join(map(str, lead + ("B", obs_dim)))
        raise ValueError(f"obs has shape {tuple(obs.shape)}, want ({want})")
    B = obs.shape[-2]
    if tuple(noise.shape) != lead + (B, act_dim):
        raise ValueError(f"noise has shape {tuple(noise.shape)}, want {lead + (B, act_dim)}")
    for name, t in (("obs", obs), ("noise", noise)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32")
    for t in [noise, *params.parameters()]:
        if t.device != obs.device:
            raise ValueError(f"operands on {t.device} and {obs.device}")

    if obs.device.type == "cpu":
        with torch.no_grad():
            return fused_sample_action_ref(params, obs, noise)
    if obs.device.type != "cuda":
        raise ValueError(f"unsupported device {obs.device}")

    obs_dim, h, weights = _kernel_operands(params)
    if noise.data_ptr() % 8:
        raise ValueError("noise must be 8-byte aligned: the kernel reads a row as a float2")
    action = torch.empty(lead + (B, 2), dtype=torch.float32, device=obs.device)
    logp = torch.empty(lead + (B,), dtype=torch.float32, device=obs.device)
    value = torch.empty(lead + (B,), dtype=torch.float32, device=obs.device)
    with torch.cuda.device(obs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library()(
            obs.data_ptr(), B, lead[0] if lead else 1, obs_dim, h,
            *(t.data_ptr() for t in weights),
            noise.data_ptr(), action.data_ptr(), logp.data_ptr(), value.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_sample_action kernel launch failed: CUDA error {err}")
    fused_sample_action.launches += 1
    return action, logp, value


fused_sample_action.launches = 0

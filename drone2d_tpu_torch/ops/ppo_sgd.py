"""One PPO minibatch step as a Hopper kernel.

Replaces no TPU kernel: the JAX package leaves its SGD step to XLA (its
`learn/ppo.py::loss_fn` under `jax.value_and_grad`, then optax).  Issued as
PyTorch and cuBLAS calls, one minibatch step of the update is a chain of
~239 small dependent kernels (forward, the loss's elementwise chain,
autograd's backward, the per-member clip, Adam's foreach kernels, the
minibatch gathers).  `csrc/ppo_sgd.cu` computes the same step in three
launches: the loss and its gradient, summed over row blocks into a partial
buffer; the partials' sums into the gradients; the per-member global-norm
clip and Adam, in place on the optimizer's own state.  Bounds and design:
the source's header.

`ppo_sgd_plan` and `ppo_sgd_step` are the kernel's wrapper, for CUDA
tensors only: they launch the kernel or raise (`NotImplementedError` for
an architecture it does not take).  The plain step, its oracle, is
`learn/ppo.py::PPOLearner.plain_sgd_step`, which `_epoch` runs on the
CPU; there is no fallback between the two.  The kernel takes what the
policy kernel takes: two hidden layers of one width H (a multiple of 8 up
to 256), obs_dim up to 32 and two actions.

`ppo_sgd_step.launches` counts the kernel launches (`launches_a_step`):
three a step; six with a process group (the advantage moments' two
launches, and the sums' second launch for the norm after the gradients'
all-reduce).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from drone2d_tpu_torch.ops import cuda_build
from drone2d_tpu_torch.ops.fused_policy import architecture
from drone2d_tpu_torch.utils.collectives import all_reduce_grads_, all_reduce_mean_

# the kernel's leaf order (csrc/ppo_sgd.cu, Leaf): the policy trunk, its
# head and log_std, then the value trunk and its head
LEAVES = ("pi.0.w", "pi.0.b", "pi.1.w", "pi.1.b", "pi_out.w", "pi_out.b", "log_std",
          "vf.0.w", "vf.0.b", "vf.1.w", "vf.1.b", "vf_out.w", "vf_out.b")
ROW = 6  # (loss, policy_loss, value_loss, entropy, clip_fraction, approx_kl)


class _Leaf(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for name in
                ("param", "grad", "exp_avg", "exp_avg_sq", "step")] + [("n", ctypes.c_longlong)]


class _Args(ctypes.Structure):
    _fields_ = (
        [(name, ctypes.c_void_p) for name in
         ("obs", "act", "logp_old", "adv", "ret", "perm", "partial", "rowpart", "moments",
          "row", "normpart")]
        + [("leaves", _Leaf * len(LEAVES))]
        + [(name, ctypes.c_longlong) for name in ("s_member", "s_time", "s_env", "perm_member")]
        + [(name, ctypes.c_int) for name in
           ("S", "F", "H", "mb", "k", "timeperm", "n_envs", "steps_per_mb", "nrb", "mblocks")]
        + [(name, ctypes.c_float) for name in
           ("clip_range", "vf_coef", "ent_coef", "max_norm", "lr", "beta1", "beta2",
            "one_minus_beta1", "one_minus_beta2", "eps")])


@functools.cache
def _library():
    lib = ctypes.CDLL(str(cuda_build.build("ppo_sgd")["path"]))
    lib.ppo_sgd_args_bytes.restype = ctypes.c_int
    if lib.ppo_sgd_args_bytes() != ctypes.sizeof(_Args):
        raise RuntimeError(f"ppo_sgd: the kernel's Args has {lib.ppo_sgd_args_bytes()} bytes, "
                           f"the wrapper's {ctypes.sizeof(_Args)}")
    lib.ppo_sgd_row_blocks.argtypes = (ctypes.c_int, ctypes.c_int)
    lib.ppo_sgd_row_blocks.restype = ctypes.c_int
    lib.ppo_sgd_trunk_floats.argtypes = (ctypes.c_int, ctypes.c_int)
    lib.ppo_sgd_trunk_floats.restype = ctypes.c_longlong
    lib.ppo_sgd_member_blocks.argtypes = (ctypes.c_int, ctypes.c_int)
    lib.ppo_sgd_member_blocks.restype = ctypes.c_int
    for name in ("ppo_sgd_grad_launch", "ppo_sgd_adam_launch"):
        getattr(lib, name).argtypes = (ctypes.c_void_p, ctypes.c_void_p)
    for name in ("ppo_sgd_moments_launch", "ppo_sgd_sums_launch"):
        getattr(lib, name).argtypes = (ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p)
    for name in ("ppo_sgd_grad_launch", "ppo_sgd_moments_launch", "ppo_sgd_sums_launch",
                 "ppo_sgd_adam_launch"):
        getattr(lib, name).restype = ctypes.c_int
    return lib


def adam_state(opt: torch.optim.Adam, p: torch.Tensor) -> dict:
    """The optimizer's state of `p`, made as `torch.optim.Adam` makes it at
    its first step (a capturable Adam: the step count a float32 scalar on
    the card) where it has none yet."""
    state = opt.state[p]
    if not state:
        state["step"] = torch.zeros((), dtype=torch.float32, device=p.device)
        state["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
        state["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
    return state


def _adam_group(opt: torch.optim.Adam) -> dict:
    """The optimizer's one parameter group, checked: Adam as `optim.adam`
    makes it (capturable, no weight decay, amsgrad or maximize)."""
    if not isinstance(opt, torch.optim.Adam) or len(opt.param_groups) != 1:
        raise ValueError("ppo_sgd_step takes a torch.optim.Adam with one parameter group")
    g = opt.param_groups[0]
    if not g["capturable"] or g["weight_decay"] or g["amsgrad"] or g["maximize"] \
            or isinstance(g["lr"], torch.Tensor):
        raise ValueError("ppo_sgd_step takes a capturable Adam with a float lr and no weight "
                         "decay, amsgrad or maximize (learn/optim.py::adam)")
    return g


@dataclasses.dataclass
class Plan:
    """One epoch's operands of `ppo_sgd_step`, checked once: the kernel's
    arguments, the buffers they point at (kept alive here) and the group."""

    args: _Args
    leaves: list
    buffers: tuple
    moments: torch.Tensor | None
    row: torch.Tensor | None
    members: int | None
    minibatches: int
    group: object


def ppo_sgd_plan(params, opt: torch.optim.Adam, data, perm: torch.Tensor, cfg,
                 num_envs: int, group=None) -> Plan:
    """The operands of one epoch's fused steps over `data`, laid out as
    `PPOLearner._sgd_data` lays out (obs, actions, log_probs, advantages,
    returns), with the epoch's shuffle `perm` ((n,), or (S, n) for a
    population), the PPOConfig `cfg` and `num_envs` envs a member.  Makes
    Adam's state where it has none and fresh gradient buffers (each leaf's
    `.grad`, which the steps leave holding the clipped gradient as the plain
    step does).  Raises NotImplementedError for an architecture the kernel
    does not take, ValueError for operands it cannot read."""
    obs_dim, H = architecture(params, "ppo_sgd_step")
    S = params.members
    lead = () if S is None else (S,)
    dev = perm.device
    obs, act, logp, adv, ret = data
    T, M = cfg.n_steps, cfg.num_minibatches
    timeperm = cfg.shuffle == "timeperm"
    rows_shape = lead + ((T, num_envs) if timeperm else (T * num_envs,))
    want = {"obs": rows_shape + (obs_dim,), "actions": rows_shape + (2,),
            "log_probs": rows_shape, "advantages": rows_shape, "returns": rows_shape}
    n = T if timeperm else T * num_envs
    for (name, shape), t in zip(want.items(), data):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want {shape}")
        if t.dtype != torch.float32 or t.device != dev:
            raise ValueError(f"{name} must be float32 on {dev}")
    strides = logp.stride()
    for name, t, width in (("obs", obs, obs_dim), ("actions", act, 2), ("advantages", adv, 1),
                           ("returns", ret, 1)):
        got = t.stride() if width == 1 else t.stride()[:-1]
        if tuple(got) != tuple(width * s for s in strides) or (width > 1 and t.stride(-1) != 1):
            raise ValueError(f"{name}'s layout differs from log_probs' (strides {t.stride()})")
    if tuple(perm.shape) != lead + (n,) or perm.dtype != torch.int64 or perm.stride(-1) != 1:
        raise ValueError(f"perm must be int64 {lead + (n,)} with unit stride, got "
                         f"{perm.dtype} {tuple(perm.shape)}")
    if dev.type != "cuda":
        raise ValueError(f"ppo_sgd_step runs on the card, not on {dev}")
    s_member = strides[0] if S is not None else 0
    inner = strides[len(lead):]
    s_time, s_env = (inner[0], inner[1]) if timeperm else (0, inner[0])

    group_opts = _adam_group(opt)
    named = dict(params.named_parameters())
    if set(named) != set(LEAVES):
        raise NotImplementedError(f"ppo_sgd_step takes the leaves {LEAVES}, got {tuple(named)}")
    leaves = [named[name] for name in LEAVES]
    lib = _library()
    mb = T * num_envs // M
    nrb = lib.ppo_sgd_row_blocks(mb, H)
    members = 1 if S is None else S
    partial = torch.empty(members * 2 * nrb * lib.ppo_sgd_trunk_floats(obs_dim, H), device=dev)
    rowpart = torch.empty(members * 2 * nrb * 4, device=dev)
    mblocks = lib.ppo_sgd_member_blocks(obs_dim, H)
    normpart = torch.empty(members * mblocks, device=dev)
    args = _Args(
        obs=obs.data_ptr(), act=act.data_ptr(), logp_old=logp.data_ptr(), adv=adv.data_ptr(),
        ret=ret.data_ptr(), perm=perm.data_ptr(), partial=partial.data_ptr(),
        rowpart=rowpart.data_ptr(), normpart=normpart.data_ptr(), s_member=s_member,
        s_time=s_time, s_env=s_env, perm_member=perm.stride(0) if S is not None else 0,
        S=members, F=obs_dim, H=H, mb=mb, k=0, timeperm=int(timeperm), n_envs=num_envs,
        steps_per_mb=T // M, nrb=nrb, mblocks=mblocks, clip_range=cfg.clip_range,
        vf_coef=cfg.vf_coef, ent_coef=cfg.ent_coef,
        max_norm=cfg.max_grad_norm, lr=group_opts["lr"], beta1=group_opts["betas"][0],
        beta2=group_opts["betas"][1], one_minus_beta1=1 - group_opts["betas"][0],
        one_minus_beta2=1 - group_opts["betas"][1], eps=group_opts["eps"])
    for i, p in enumerate(leaves):
        if p.dtype != torch.float32 or not p.is_contiguous() or p.device != dev:
            raise ValueError(f"{LEAVES[i]} must be contiguous float32 on {dev}")
        state = adam_state(opt, p)
        step = state["step"]
        if step.device != dev or step.dtype != torch.float32:
            raise ValueError("Adam's step count must be a float32 tensor on the card")
        # fresh gradient buffers a plan: under a CUDA graph's capture they come
        # from its pool and live as long as the graph
        p.grad = torch.empty_like(p)
        args.leaves[i] = _Leaf(p.data_ptr(), p.grad.data_ptr(), state["exp_avg"].data_ptr(),
                               state["exp_avg_sq"].data_ptr(), step.data_ptr(),
                               p.numel() // members)
    moments = row = None
    if group is not None:
        moments = torch.empty(2 * members, device=dev)
        row = torch.empty((ROW,) + lead, device=dev)
        args.moments = moments.data_ptr()
        args.row = row.data_ptr()
    return Plan(args, leaves, (partial, rowpart, normpart), moments, row, S, M, group)


def launches_a_step(group=None) -> int:
    """The kernel launches `ppo_sgd_step` makes a minibatch step."""
    return 3 if group is None else 6


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"ppo_sgd {what} launch failed: CUDA error {err}")


def ppo_sgd_step(plan: Plan, k: int, out: torch.Tensor) -> torch.Tensor:
    """Minibatch k of the plan's epoch: its loss, gradient, clip and Adam
    step in place on the weights and the optimizer, and its (loss, *aux)
    row written into `out` ((6,), or (6, S) for a population, contiguous).
    With the plan's group: the advantage moments, the gradients and the row
    averaged over the ranks as the plain step averages them."""
    want = (ROW,) if plan.members is None else (ROW, plan.members)
    if tuple(out.shape) != want or not out.is_contiguous() or out.dtype != torch.float32 \
            or out.device != plan.leaves[0].device:
        raise ValueError(f"out must be contiguous float32 {want} on the card, got "
                         f"{out.dtype} {tuple(out.shape)} on {out.device}")
    if not 0 <= k < plan.minibatches:
        raise ValueError(f"minibatch {k} of an epoch of {plan.minibatches}")
    lib, a = _library(), plan.args
    a.k = k
    stream = ctypes.c_void_p(torch.cuda.current_stream(out.device).cuda_stream)
    S = a.S
    if plan.group is None:
        a.row = out.data_ptr()
        _check(lib.ppo_sgd_grad_launch(ctypes.byref(a), stream), "grad")
        _check(lib.ppo_sgd_sums_launch(ctypes.byref(a), 1, stream), "sums")
        _check(lib.ppo_sgd_adam_launch(ctypes.byref(a), stream), "adam")
    else:
        for which in (0, 1):
            _check(lib.ppo_sgd_moments_launch(ctypes.byref(a), which, stream), "moments")
            all_reduce_mean_(plan.moments[which * S:(which + 1) * S], plan.group)
        _check(lib.ppo_sgd_grad_launch(ctypes.byref(a), stream), "grad")
        _check(lib.ppo_sgd_sums_launch(ctypes.byref(a), 1, stream), "sums")
        out.copy_(all_reduce_grads_(plan.leaves, plan.row, plan.group))
        _check(lib.ppo_sgd_sums_launch(ctypes.byref(a), 0, stream), "norm")
        _check(lib.ppo_sgd_adam_launch(ctypes.byref(a), stream), "adam")
    ppo_sgd_step.launches += launches_a_step(plan.group)
    return out


ppo_sgd_step.launches = 0

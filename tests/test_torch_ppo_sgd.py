"""The fused SGD step's wrapper (`ops/ppo_sgd.py`) on the CPU: its argument
block against the kernel source's, the architectures and operands it
refuses, the CPU route through the unchanged plain step (`loss_fn`,
backward, the clip, Adam's step; the kernel's launch count and
`sgd.fused_steps` stay where they were), and the step count read from the
launch count.  The kernel itself runs in `tests/test_torch_cuda.py`.
"""

import re
from pathlib import Path

import pytest
import torch

from drone2d_tpu_torch.config import EnvConfig, PPOConfig
from drone2d_tpu_torch.learn import optim
from drone2d_tpu_torch.learn.ppo import PPOLearner, count_fused_steps
from drone2d_tpu_torch.models.policy import ActorCritic, stack_params
from drone2d_tpu_torch.ops import ppo_sgd
from drone2d_tpu_torch.utils import profiling

SOURCE = Path(ppo_sgd.__file__).resolve().parent.parent / "csrc" / "ppo_sgd.cu"


def _fields(struct: str) -> list:
    """The member names of `struct <struct> {...};` in the kernel source."""
    text = re.sub(r"//[^\n]*", "", SOURCE.read_text())
    body = re.search(r"struct %s \{(.*?)\};" % struct, text, re.S).group(1)
    names = []
    for decl in body.split(";"):
        for part in decl.split(","):
            found = re.findall(r"(\w+)\s*(?:\[\w+\])?\s*$", part.strip())
            if found:
                names.append(found[0])
    return names


def test_argument_block_matches_the_kernel_source():
    """The ctypes structures name the C structs' members in their order
    (the library checks the sizes again when it loads)."""
    assert [f[0] for f in ppo_sgd._Leaf._fields_] == _fields("Leaf")
    assert [f[0] for f in ppo_sgd._Args._fields_] == _fields("Args")
    assert len(ppo_sgd.LEAVES) == 13 and ppo_sgd.LEAVES[6] == "log_std"


@pytest.mark.parametrize("hidden, ok", [((64, 64), True), ((128, 128), True), ((256, 256), True),
                                        ((64, 64, 64), False), ((64, 32), False),
                                        ((12, 12), False), ((264, 264), False)])
def test_architectures_the_kernel_takes(hidden, ok):
    params = ActorCritic(27, 2, hidden, device="cpu")
    if ok:
        assert ppo_sgd.architecture(params, "ppo_sgd_step") == (27, hidden[0])
    else:
        with pytest.raises(NotImplementedError, match="ppo_sgd_step on the card takes two"):
            ppo_sgd.architecture(params, "ppo_sgd_step")


def _learner(shuffle="exact", members=None, hidden=(16, 16)):
    cfg = PPOConfig(n_steps=4, num_minibatches=2, n_epochs=2, shuffle=shuffle,
                    hidden_sizes=hidden)
    learner = PPOLearner(EnvConfig(path_table_n=128), cfg, 8, device="cpu")
    ms = [ActorCritic(27, 2, hidden, generator=torch.Generator().manual_seed(i), device="cpu")
          for i in range(members or 1)]
    params = ms[0] if members is None else stack_params(ms)
    return learner, params


def _data(learner, members, seed=0):
    """Random (T, S N, ...) rollout tensors laid out by `_sgd_data`, and one
    epoch's shuffle."""
    g = torch.Generator().manual_seed(seed)
    T, W = learner.cfg.n_steps, (members or 1) * learner.num_envs
    raw = (torch.randn(T, W, 27, generator=g), torch.randn(T, W, 2, generator=g),
           -torch.rand(T, W, generator=g) - 1.0, torch.randn(T, W, generator=g),
           torch.randn(T, W, generator=g))
    perm = learner.draw_perms(g)[0]
    if members is not None:
        perm = torch.stack([learner.draw_perms(g)[0] for _ in range(members)])
    return raw, learner._sgd_data(raw, members), perm


@pytest.mark.parametrize("fault", ["obs_shape", "actions_layout", "perm_dtype", "perm_shape",
                                   "cpu"])
def test_plan_refuses_operands_it_cannot_read(fault):
    learner, params = _learner("timeperm", members=2)
    _, data, perm = _data(learner, 2)
    data = list(data)
    if fault == "obs_shape":
        data[0] = data[0][..., :20]
    elif fault == "actions_layout":
        data[1] = data[1].transpose(-1, -2).contiguous().transpose(-1, -2)
    elif fault == "perm_dtype":
        perm = perm.to(torch.int32)
    elif fault == "perm_shape":
        perm = perm[0]
    opt = optim.adam(params.parameters(), 3e-4)
    match = "runs on the card" if fault == "cpu" else None
    with pytest.raises(ValueError, match=match):
        ppo_sgd.ppo_sgd_plan(params, opt, data, perm, learner.cfg, learner.num_envs)


def test_plan_refuses_an_architecture_before_its_operands():
    learner, _ = _learner()
    params = ActorCritic(27, 2, (16, 16, 16), device="cpu")
    _, data, perm = _data(learner, None)
    with pytest.raises(NotImplementedError):
        ppo_sgd.ppo_sgd_plan(params, optim.adam(params.parameters(), 3e-4), data, perm,
                             learner.cfg, learner.num_envs)


@pytest.mark.parametrize("members", [None, 2])
def test_cpu_update_runs_the_plain_step_and_no_kernel(monkeypatch, members):
    """An epoch on the CPU calls `loss_fn` once a minibatch step, and the
    kernel's launch count does not move."""
    learner, params = _learner("exact", members)
    calls = []
    real = PPOLearner.loss_fn

    def loss_fn(self, *a, **kw):
        calls.append(1)
        return real(self, *a, **kw)

    monkeypatch.setattr(PPOLearner, "loss_fn", loss_fn)
    raw, data, perm = _data(learner, members)
    opt = optim.adam(params.parameters(), 3e-4)
    launches = ppo_sgd.ppo_sgd_step.launches
    rows = learner._epoch(params, opt, data, perm)
    assert len(calls) == learner.cfg.num_minibatches
    assert tuple(rows.shape) == (2, 6) + (() if members is None else (members,))
    assert ppo_sgd.ppo_sgd_step.launches == launches


@pytest.mark.parametrize("shuffle, members", [("exact", None), ("timeperm", 2),
                                              ("affine", None), ("exact", 2),
                                              ("timeperm", None), ("affine", 2)])
def test_cpu_epoch_is_the_plain_chain(shuffle, members):
    """`_epoch` on the CPU is the plain chain written out (loss_fn,
    zero_grad, backward of the sum, the row, the per-member clip, Adam's
    step) on the gathered minibatches: weights, Adam's state and rows
    bit-equal."""
    learner, params = _learner(shuffle, members)
    twin = stack_params([params.member(i) for i in range(members)]) if members else \
        ActorCritic(27, 2, (16, 16), device="cpu")
    if members is None:
        twin.load_state_dict(params.state_dict())
    raw, data, perm = _data(learner, members)
    opt, opt2 = optim.adam(params.parameters(), 3e-4), optim.adam(twin.parameters(), 3e-4)
    rows = learner._epoch(params, opt, data, perm)
    want = []
    leaves = list(twin.parameters())
    for mb in learner._epoch_minibatches(data, perm, members):
        loss, aux = learner.loss_fn(twin, *mb)
        opt2.zero_grad(set_to_none=True)
        loss.sum().backward()
        want.append(torch.stack([v.detach() for v in (loss, *aux.values())]))
        optim.clip_by_global_norm_([p.grad for p in leaves], learner.cfg.max_grad_norm,
                                   members=members)
        opt2.step()
    assert torch.equal(rows, torch.stack(want))
    for a, b in zip(params.parameters(), twin.parameters()):
        assert torch.equal(a, b) and torch.equal(a.grad, b.grad)
    for a, b in zip(opt.state.values(), opt2.state.values()):
        assert all(torch.equal(a[k], b[k]) for k in a)


def _fused_steps():
    return profiling.counters().get("sgd.fused_steps", 0)


def test_cpu_updates_count_no_fused_steps():
    """`update` and `update_jit` on the CPU leave `sgd.fused_steps` and the
    kernel's launch count where they were."""
    learner, params = _learner("timeperm")
    state = learner.start(torch.Generator().manual_seed(0), params)
    before = (_fused_steps(), ppo_sgd.ppo_sgd_step.launches)
    state, _ = learner.update(state)
    learner.update_jit(state)
    assert (_fused_steps(), ppo_sgd.ppo_sgd_step.launches) == before


@pytest.mark.parametrize("group, per_step", [(None, 3), (object(), 6)])
def test_fused_steps_are_read_from_the_launch_count(monkeypatch, group, per_step):
    """`count_fused_steps` counts a step for every `launches_a_step` launches
    since its mark: three, six with a process group."""
    assert ppo_sgd.launches_a_step(group) == per_step
    monkeypatch.setattr(ppo_sgd.ppo_sgd_step, "launches", 100)
    before = _fused_steps()
    count_fused_steps(100, group)
    assert _fused_steps() == before
    ppo_sgd.ppo_sgd_step.launches += 7 * per_step
    count_fused_steps(100, group)
    assert _fused_steps() == before + 7

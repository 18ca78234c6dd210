"""Tracing and phase timing (counterpart of `drone2d_tpu/utils/profiling.py`).

Three tools:
* `trace(log_dir)`: a context manager around `torch.profiler` that writes
  a Chrome trace (`chrome://tracing`, Perfetto) of the host's operators and,
  on the card, of every device kernel launched inside.
* `device_window(fn)`: the device events of one call on the card, for ops
  a step and the device's busy share; `launch_window(fn)` also the host's
  launch calls, for host launches a step (one a kernel eager, one a graph
  under replay).
* `PhaseTimer`: wall-clock phase accounting for a loop (rollout / GAE /
  update / host IO), printed or written as JSONL.

Usage:
    with trace("logs/profile") as path:
        state, metrics = learner.update(state)

    pt = PhaseTimer()
    with pt.phase("rollout", block_on=batch): ...
    print(pt.summary())
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch


# trivial kernels launched as the recorded window opens (see `trace`)
LEAD_KERNELS = 256


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[str]:
    """Profile the block and write its Chrome trace to
    `<log_dir>/trace.json`, whose path the context yields.  The device's
    kernels are traced when CUDA is available.

    In a process that has profiled before, the profiler can lose the kernel
    records of the first launches in its window, whatever the wait before
    them (up to 7 seen on an H100; their launch calls stay recorded).  So
    on the card the window opens on a warm-up step, whose events are
    dropped, and then a lead-in of LEAD_KERNELS trivial kernels under the
    range `trace: lead-in`, which takes that loss instead of the block."""
    from torch.profiler import ProfilerActivity, profile, schedule

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    with profile(activities=activities, schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        if cuda:
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
        prof.step()
        if cuda:
            _lead_in()
        yield path
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)


def _lead_in() -> None:
    """LEAD_KERNELS trivial kernels (and the zeros they add to) under the
    range `trace: lead-in`, synchronized."""
    from torch.profiler import record_function

    with record_function("trace: lead-in"):
        x = torch.zeros(1, device="cuda")
        for _ in range(LEAD_KERNELS):
            x.add_(1)
        torch.cuda.synchronize()


# the host's launch calls in a trace: kernels, graphs, copies and fills
_HOST_LAUNCHES = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch", "cudaMemcpy", "cudaMemset")


def launch_window(fn):
    """Run fn() once under torch.profiler on the card, synchronized ->
    (its device events, the host's launch calls in it, their summed device
    µs, the wall µs of the call).

    The window opens on `trace`'s lead-in, which takes the profiler's loss
    of a window's first kernel records; the lead-in's kernels ran before
    the call's range opened (a 1 ms gap apart), and only the events that
    start inside that range are returned.  A launch call is a CUDA runtime
    or libcuda call that puts work on a stream (`_HOST_LAUNCHES`): one a
    kernel in eager mode, one for a whole replayed CUDA graph."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _lead_in()
        time.sleep(1e-3)
        with record_function("device_window"):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    start = min(e.time_range.start for e in events
                if e.name == "device_window" and e.device_type != cuda)
    # the ranges' own annotations on the device's timeline are no kernels
    device = [e for e in events if e.device_type == cuda and e.time_range.start >= start
              and e.name not in ("device_window", "trace: lead-in")]
    host = [e for e in events if e.device_type != cuda and e.time_range.start >= start
            and e.name.startswith(_HOST_LAUNCHES)]
    return device, host, sum(e.time_range.elapsed_us() for e in device), wall_us


def device_window(fn):
    """Run fn() once under torch.profiler on the card, synchronized ->
    (its device events, their summed device µs, the wall µs of the call);
    see `launch_window`."""
    device, _, dev_us, wall_us = launch_window(fn)
    return device, dev_us, wall_us


def _cuda_devices(tree, out: set) -> set:
    """The CUDA devices of the tensors in `tree` (tensors, sequences,
    mappings and dataclasses of them)."""
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            out.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _cuda_devices(v, out)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            _cuda_devices(getattr(tree, f.name), out)
    return out


class PhaseTimer:
    def __init__(self) -> None:
        self._acc: Dict[str, float] = defaultdict(float)
        self._count: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, *, block_on=None) -> Iterator[None]:
        """Time a phase; pass `block_on=` the phase's output tensors (or a
        tree of them) to wait for their devices to finish (otherwise the
        card's asynchronous launches make phases look instant)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            for dev in _cuda_devices(block_on, set()):
                torch.cuda.synchronize(dev)
            self._acc[name] += time.perf_counter() - t0
            self._count[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {
                "total_s": self._acc[k],
                "calls": self._count[k],
                "mean_ms": 1e3 * self._acc[k] / max(self._count[k], 1),
            }
            for k in self._acc
        }

    def dump(self, path: str) -> None:
        with open(path, "a") as f:
            f.write(json.dumps(self.summary()) + "\n")

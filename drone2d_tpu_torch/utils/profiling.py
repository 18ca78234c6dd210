"""Tracing, and the program's own spans and counters (counterpart of
`drone2d_tpu/utils/profiling.py`).

The profiler's windows:
* `trace(log_dir)`: a context manager around `torch.profiler` that writes
  a Chrome trace (`chrome://tracing`, Perfetto) of the host's operators and,
  on the card, of every device kernel launched inside.
* `device_window(fn)`: the device events of one call on the card, for ops
  a step and the device's busy share; `launch_window(fn)` also the host's
  launch calls, for host launches a step (one a kernel eager, one a graph
  under replay).

The recorder, one a process:
* `span(name, *, device=False, **attrs)`: a context manager around one
  phase of the program (`update.rollout`, `graphs.capture`, `eval.draws`,
  ...).  It records its name, an id, its parent (the innermost span open
  on this thread), its root (the outermost: one `update` or one
  `eval.call`), its start and end in ns on `time.time_ns()` (the clock of
  `torch.profiler`'s events, so spans lie over a trace's device records)
  and its attributes; with `device=True`, a pair of CUDA events on the
  current stream, whose elapsed time is read lazily, after a
  synchronize, when the spans are read.  Spans record only while tracing
  is on: after `enable()`, or while a `torch.profiler` window is open, in
  which each span also opens `record_function(name)`, so the program's
  phases show on the profiler's host timeline.  Off, `span` returns one
  shared no-op context manager and records nothing.  At most MAX_SPANS are
  kept; those past it are counted (`profiling.spans_dropped`).
* `count(name, value=1)`: adds to a named counter.  Counters are always
  on: a dict increment, a few a graph capture, an eval call and an update.
* `spans()`, `counters()` and `reset()` read and clear the recorder.

Usage:
    with trace("logs/profile") as path:
        state, metrics = learner.update(state)

    profiling.enable()
    state, metrics = learner.update_jit(state)
    rollout = [s for s in profiling.spans() if s.name == "update.rollout"]
    print(rollout[-1].device_s, profiling.counters()["graphs.captures[update]"])
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import os
import threading
import time
from typing import Dict, Iterator, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler


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
    start inside that range are returned, user annotations (`record_function`
    ranges, `span`'s among them) left out.  A launch call is a CUDA runtime
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
    # the ranges' own annotations on the device's timeline (this window's,
    # the lead-in's and the program's spans') are no device operations
    device = [e for e in events if e.device_type == cuda and e.time_range.start >= start
              and not getattr(e, "is_user_annotation", False)
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


# -- the recorder: spans and counters -----------------------------------------

# the spans kept at most; later ones are counted and dropped
MAX_SPANS = 100_000

_enabled = False
_spans: List["Span"] = []
_counters: Dict[str, float] = {}
_counting = threading.Lock()  # a counter's read-modify-write
_ids = itertools.count(1)
_open = threading.local()  # .stack: this thread's open spans, innermost last


@dataclasses.dataclass
class Span:
    """One recorded span.  Times are ns on `time.time_ns()`; `device_s` is
    the seconds between its CUDA events (None: not a device span, or not
    on the card); `self_ns` its duration less its children's, set when
    read."""

    name: str
    id: int
    parent: Optional[int]
    root: int
    start_ns: int
    end_ns: Optional[int] = None
    attrs: dict = dataclasses.field(default_factory=dict)
    device_s: Optional[float] = None
    self_ns: Optional[int] = None
    events: Optional[tuple] = dataclasses.field(default=None, repr=False)

    @property
    def duration_ns(self) -> int:
        return self.end_ns - self.start_ns


class _NoSpan:
    """What `span` returns while tracing is off: one shared object that
    records nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass


_NO_SPAN = _NoSpan()


class _Recording:
    """A span being recorded; `set(**attrs)` adds attributes to it."""

    __slots__ = ("span", "device", "marker")

    def __init__(self, name: str, device: bool, attrs: dict):
        self.span = Span(name, 0, None, 0, 0, attrs=attrs)
        self.device, self.marker = device, None

    def set(self, **attrs) -> None:
        self.span.attrs.update(attrs)

    def __enter__(self):
        s = self.span
        stack = _stack()
        s.id = next(_ids)
        if stack:
            s.parent, s.root = stack[-1].id, stack[-1].root
        else:
            s.root = s.id
        stack.append(s)
        if len(_spans) < MAX_SPANS:
            _spans.append(s)
        else:
            count("profiling.spans_dropped")
        s.start_ns = time.time_ns()
        if _autograd_profiler._is_profiler_enabled:
            self.marker = torch.profiler.record_function(s.name)
            self.marker.__enter__()
        if self.device:
            s.events = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
            s.events[0].record()
        return self

    def __exit__(self, *exc) -> bool:
        s = self.span
        if s.events is not None:
            s.events[1].record()
        if self.marker is not None:
            self.marker.__exit__(*exc)
        s.end_ns = time.time_ns()
        _stack().pop()
        return False


def _stack() -> list:
    stack = getattr(_open, "stack", None)
    if stack is None:
        stack = _open.stack = []
    return stack


def enable(on: bool = True) -> None:
    """Record spans (or, with False, only while a profiler window is open)."""
    global _enabled
    _enabled = bool(on)


def span(name: str, *, device: bool = False, **attrs):
    """A context manager that records the block as a span while tracing is
    on (see the module's docstring), with `device` a pair of CUDA events
    around it; off, the shared no-op."""
    if not (_enabled or _autograd_profiler._is_profiler_enabled):
        return _NO_SPAN
    return _Recording(name, device, attrs)


def count(name: str, value: float = 1) -> None:
    """Add `value` to the counter `name` (always on)."""
    with _counting:
        _counters[name] = _counters.get(name, 0) + value


def counters() -> Dict[str, float]:
    """A copy of every counter."""
    with _counting:
        return dict(_counters)


def spans() -> List[Span]:
    """The recorded spans, in the order they opened, each ended one with its
    self time and, for a device span, its device seconds (waiting for its
    end event)."""
    covered: Dict[int, int] = {}
    for s in _spans:
        if s.end_ns is None:
            continue
        if s.parent is not None:
            covered[s.parent] = covered.get(s.parent, 0) + s.duration_ns
        if s.events is not None and s.device_s is None:
            s.events[1].synchronize()
            s.device_s = s.events[0].elapsed_time(s.events[1]) / 1e3
    for s in _spans:
        if s.end_ns is not None:
            s.self_ns = s.duration_ns - covered.get(s.id, 0)
    return list(_spans)


def reset() -> None:
    """Forget every span and counter (the open spans stay open)."""
    _spans.clear()
    with _counting:
        _counters.clear()

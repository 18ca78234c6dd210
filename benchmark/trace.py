"""The device trace of a window, reduced in memory to what the readers need.

`traced(fn)` runs fn() once under `torch.profiler` with CUPTI's device
records, and with the host's operations unless `host_ops` is off.  As
`drone2d_tpu_torch/utils/profiling.py` does (copied, not imported), the
window opens on a lead-in of 256 trivial kernels, which takes the
profiler's loss of a window's first device records; the lead-in ends on a
marker kernel that no program launches (`torch.cuda._sleep`'s), and only
device records that start after it count.  The window's length is the
host's clock around fn() less the idle gaps that the profiler's own work
(CUPTI's buffer flushes and requests) holds the host in.  No chrome trace is
written: the records are read from the profiler's results once, as arrays,
and reduced to a `Trace`.
"""

from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np
import torch

LEAD_KERNELS = 256
WINDOW = "bench: window"
LEAD_IN = "bench: lead-in"
# the lead-in's last kernel: `torch.cuda._sleep`'s, which no program launches
MARKER = "spin_kernel"
# CUPTI's own work on the host (its overhead records), which an untraced
# run does not do: idle gaps put down to it are left out of the window
PROFILER_WORK = ("Buffer Flush", "Activity Buffer Request", "Command Buffer Full",
                 "Instrumentation", "Resource")
# a gap between two device operations shorter than this is the device's own
# launch latency inside a replayed graph; a longer one is put down to what
# the host was doing
SHORT_GAP_S = 20e-6


@dataclasses.dataclass
class Trace:
    window_s: float                 # the window's length on the host's clock,
                                    # less the profiler's own idle gaps
    busy_s: float                   # the union of the device operations' times
    n_ops: int                      # device operations (kernels, copies, fills)
    by_name: dict                   # name -> (count, seconds)
    idle_by_host: dict              # what the host was doing -> idle seconds

    def seconds(self, name_part: str) -> tuple:
        """(count, seconds) of the device operations whose name holds `name_part`."""
        n, s = 0, 0.0
        for name, (c, t) in self.by_name.items():
            if name_part in name:
                n, s = n + c, s + t
        return n, s

    def breakdown(self) -> dict:
        top = sorted(self.by_name.items(), key=lambda kv: -kv[1][1])[:10]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n, s] for n, (_, s) in top],
                "idle_gaps": [[n, s] for n, s in gaps]}


def _lead_in() -> None:
    with torch.profiler.record_function(LEAD_IN):
        x = torch.zeros(1, device="cuda")
        for _ in range(LEAD_KERNELS):
            x.add_(1)
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()


def traced(fn, host_ops: bool = True):
    """Run fn() once under the profiler, synchronized -> (fn's result, Trace)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host_ops else [])
    with profile(activities=activities) as prof:
        _lead_in()
        time.sleep(1e-3)
        with record_function(WINDOW):
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
    return out, reduce(prof.profiler.kineto_results.events(), window_s)


def reduce(events, window_s: float) -> Trace:
    """The profiler's raw events -> a Trace of the window's device operations
    and the host's operations around their idle gaps."""
    dev_start, dev_end, dev_name = [], [], []
    host = []
    window = marker_ns = None
    for e in events:
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if name in (WINDOW, LEAD_IN) or getattr(e, "is_user_annotation", bool)():
                continue
            if MARKER in name:
                marker_ns = max(marker_ns or 0, e.start_ns() + e.duration_ns())
                continue
            dev_start.append(e.start_ns())
            dev_end.append(e.start_ns() + e.duration_ns())
            dev_name.append(name)
        else:
            if name == WINDOW:
                window = (e.start_ns(), e.start_ns() + e.duration_ns())
            host.append((e.start_ns(), e.start_ns() + e.duration_ns(), name))
    start = np.asarray(dev_start, dtype=np.int64)
    end = np.asarray(dev_end, dtype=np.int64)
    if marker_ns is None:
        raise RuntimeError("the profiler recorded no lead-in marker")
    keep = start >= marker_ns
    start, end = start[keep], end[keep]
    if not len(start):
        raise RuntimeError("the profiler recorded no device operation in the window")
    names = [n for n, k in zip(dev_name, keep) if k]
    start_ns, end_ns = window if window is not None else (int(start.min()), int(end.max()))
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for n, d in zip(names, (end - start) * 1e-9):
        by_name[n][0] += 1
        by_name[n][1] += float(d)
    order = np.argsort(start, kind="stable")
    start, end = start[order], end[order]
    # merge overlapping records; the busy time is their union
    reach = np.maximum.accumulate(end)
    new = np.ones(len(start), dtype=bool)
    new[1:] = start[1:] > reach[:-1]
    seg_start = start[new]
    seg_end = np.append(reach[np.flatnonzero(new)[1:] - 1], reach[-1:])
    busy_s = float(np.sum(seg_end - seg_start)) * 1e-9
    idle = _idle_by_host(seg_start, seg_end, start_ns, end_ns, host)
    profiler_s = sum(s for label, s in idle.items() if label[len("host: "):] in PROFILER_WORK)
    return Trace(window_s=window_s - profiler_s, busy_s=busy_s, n_ops=int(len(start)),
                 by_name={k: (c, s) for k, (c, s) in by_name.items()}, idle_by_host=idle)


def _idle_by_host(seg_start, seg_end, window_start_ns, window_end_ns, host) -> dict:
    """Idle seconds between the device's busy segments (and before the first
    and after the last), each put down to the innermost host operation
    running at the gap's start; gaps under SHORT_GAP_S go together under
    one name."""
    gap_start = np.concatenate([[window_start_ns], seg_end])
    gap_len = np.maximum(np.concatenate([seg_start, [window_end_ns]]) - gap_start, 0) * 1e-9
    out = collections.defaultdict(float)
    short = gap_len < SHORT_GAP_S
    out["device: gaps under 20 us between operations"] = float(np.sum(gap_len[short]))
    host = sorted(h for h in host if h[1] > window_start_ns)
    h_start = np.asarray([h[0] for h in host], dtype=np.int64)
    for g0, g in zip(gap_start[~short], gap_len[~short]):
        # the innermost host operation at g0: the latest to start among those
        # still running then
        i = int(np.searchsorted(h_start, g0, side="right"))
        label = "host: nothing traced"
        for j in range(i - 1, max(i - 2000, -1), -1):
            if host[j][1] >= g0:
                label = "host: " + host[j][2]
                break
        out[label] += float(g)
    return dict(out)

"""The device's idle share of the traced window: 100 x (1 - the union of
its operations' times / the window's length on the host's clock, less the
idle gaps the profiler's own work holds the host in)."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)

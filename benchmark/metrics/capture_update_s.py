"""Seconds of the first `update_jit` call, which captures the update's
graphs, on the host's clock and synchronized (set-up)."""


def read(run):
    return run.counters.get("capture_update_s")

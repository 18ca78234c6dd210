"""Device operations (kernels, copies, fills) in the trace of whole updates,
per traced update."""


def read(run):
    updates = run.counters.get("traced_updates", 0)
    if run.trace is None or updates == 0:
        return None
    return run.trace.n_ops / updates

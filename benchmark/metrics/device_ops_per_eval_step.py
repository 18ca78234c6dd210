"""Device operations (kernels, copies, fills) in the trace of a whole
selection call, per lockstep eval step of it (one policy launch a step, the
capture's warm-up steps among them)."""


def read(run):
    steps = run.counters.get("traced_launches", 0)
    if run.trace is None or steps == 0:
        return None
    return run.trace.n_ops / steps

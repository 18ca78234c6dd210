"""The fused policy kernel's share of its roofline: the least time its
work could take on the card (`counts.policy_kernel_work` at the run's
rows, members and width, bounded by FLOPs or bytes) over its mean device
time in the trace (`fused_sample_action_kernel` launches)."""

from benchmark import counts


def read(run):
    if run.trace is None:
        return None
    launches, seconds = run.trace.seconds("fused_sample_action")
    if launches == 0 or seconds <= 0:
        return None
    work = counts.policy_kernel_work(run.shape["kernel_rows"], run.shape["hidden"],
                                     run.shape["kernel_members"])
    return 100.0 * counts.bound_seconds(work) / (seconds / launches)

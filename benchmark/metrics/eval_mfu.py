"""The window's model FLOPs, the stack's forward pass a lockstep step
(`counts.eval_step_flops`) times its steps (one policy launch a step), over
the window's seconds on the host's clock (untraced), as a share of the
card's float32 peak."""

from benchmark import counts


def read(run):
    steps = run.counters.get("kernel_launches", 0)
    if "agents" not in run.shape or steps == 0 or not run.counters.get("window_s"):
        return None
    s = run.shape
    flops = counts.eval_step_flops(s["agents"], s["episodes"], s["hidden"]) * steps
    return 100.0 * flops / run.counters["window_s"] / counts.PEAK_F32_FLOPS

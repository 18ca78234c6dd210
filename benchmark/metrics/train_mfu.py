"""The window's model FLOPs, `counts.update_model_flops` an update times
its updates, over the window's seconds on the host's clock (untraced), as a
share of the card's float32 peak."""

from benchmark import counts


def read(run):
    if "n_epochs" not in run.shape or not run.counters.get("window_s"):
        return None
    s = run.shape
    flops = counts.update_model_flops(s["members"], s["num_envs"], s["n_steps"], s["n_epochs"],
                                      s["hidden"]) * run.counters["updates"]
    return 100.0 * flops / run.counters["window_s"] / counts.PEAK_F32_FLOPS

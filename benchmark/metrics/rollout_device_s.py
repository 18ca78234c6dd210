"""Seconds on the device's clock of the rollout graphs of the traced
update: the CUDA events of the program's span `update.rollout` in the last
`update` span (`drone2d_tpu_torch/utils/profiling.py`, recorded while the
profiler's window is open).  A program without the recorder reads
nothing.

The events also hold the device's idle while CUPTI flushes its buffers,
which `benchmark/trace.py` takes out of the window but cannot take out of
a span: small in the flagship's update (235k device records), most of the
span in the SB3 shape's (2.4M), where this reading is not listed."""


def device_seconds(run, name: str):
    """The device seconds of the spans `name` in the last `update` root of
    the run's recorder, or None."""
    if run.trace is None:
        return None
    try:
        from drone2d_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not hasattr(profiling, "spans"):
        return None
    spans = profiling.spans()
    roots = [s for s in spans if s.name == "update" and s.parent is None]
    if not roots:
        return None
    got = [s.device_s for s in spans
           if s.name == name and s.parent == roots[-1].id and s.device_s is not None]
    return sum(got) if got else None


def read(run):
    return device_seconds(run, "update.rollout")

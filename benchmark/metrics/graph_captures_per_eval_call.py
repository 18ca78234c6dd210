"""CUDA graphs captured for eval calls, per call, over the calls made with
tracing off: the program's counters (`graphs.captures[<cause>]` of the
`eval.*` causes, `eval.calls`) less what the spans of the traced call
hold.  Read from the recorder of the run's own process
(`drone2d_tpu_torch/utils/profiling.py`); a program without it reads
nothing.  The counters run from the process's start, so set-up's warm-up
call is among the untraced calls, with the policy kernel's first load (or
build) and the first use of the libraries inside its runner's capture."""


def untraced(run):
    """{calls, call_s, captures, capture_s} of the eval calls made with
    tracing off, or None."""
    try:
        from drone2d_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not hasattr(profiling, "counters"):
        return None
    counters, spans = profiling.counters(), profiling.spans()
    traced = {s.id: s for s in spans if s.name == "eval.call" and s.parent is None}
    captures = [s for s in spans if s.name == "graphs.capture" and s.root in traced
                and s.attrs.get("cause", "").startswith("eval.")]

    def by_eval_cause(name):
        prefix = f"graphs.{name}[eval."
        return sum(v for k, v in counters.items() if k.startswith(prefix))

    out = {"calls": counters.get("eval.calls", 0) - len(traced),
           "call_s": counters.get("eval.call_s", 0.0)
           - sum(s.attrs.get("seconds", 0.0) for s in traced.values()),
           "captures": by_eval_cause("captures") - len(captures),
           "capture_s": by_eval_cause("capture_s")
           - sum(s.attrs.get("seconds", 0.0) for s in captures)}
    return out if out["calls"] > 0 and out["call_s"] > 0 else None


def read(run):
    got = untraced(run)
    return None if got is None else got["captures"] / got["calls"]

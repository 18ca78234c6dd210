"""The share of the eval calls' host seconds spent capturing their CUDA
graphs, over the calls made with tracing off: 100 x the program's
`graphs.capture_s` of the `eval.*` causes over its `eval.call_s`, each less
the traced call's spans (`graph_captures_per_eval_call.untraced`)."""

from benchmark.harness import BENCH, load_module

untraced = load_module(BENCH / "metrics" / "graph_captures_per_eval_call.py").untraced


def read(run):
    got = untraced(run)
    return None if got is None else 100.0 * got["capture_s"] / got["call_s"]

"""Run one cell of the benchmark of `drone2d_tpu_torch` once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Reads the cell from `BENCHMARK.json` at the root of the checkout, its
configuration from `benchmark/configs/<config>.json`, its traffic from
`benchmark/traffic/<traffic>.json` (whose `driver` names
`benchmark/drivers/<driver>.py`) and its correctness limits from
`benchmark/workloads/<name>.json`.  Needs an NVIDIA card: without one, or
with fewer cards than the cell asks for, it exits with code 2 and prints no
result.  Prints the cell's end-to-end metrics (`--trace 0`) or its
per-layer metrics (`--trace 1`, each read by `benchmark/metrics/<metric>.py`)
as one JSON line, last on standard output; each number that decided
`correct` is printed beside its limit last on standard error and last in
that line.  Exits with code 3, and prints no result, if JAX or the JAX
package was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# top-level module names that may not be loaded in a run, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "drone2d_tpu")


def cell_files(name: str) -> dict:
    """The cell `name` and what BENCHMARK.json and its files say of it."""
    from benchmark.harness import BENCH, load_json

    spec = load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    cell = cells[name]
    config_file = {c["name"]: c["file"] for c in spec["configs"]}[cell["config"]]
    traffic = load_json(BENCH / "traffic" / f"{cell['traffic']}.json")
    return {"spec": spec, "cell": cell, "config": load_json(ROOT / config_file),
            "traffic": traffic, "limits": load_json(BENCH / "workloads" / f"{name}.json")}


def measure(files: dict, seed: int, seconds: float, trace: bool, device, t0: float):
    """Drive the cell once -> the driver's Run."""
    from benchmark.harness import BENCH, load_module

    driver = load_module(BENCH / "drivers" / f"{files['traffic']['driver']}.py")
    run = driver.run(files["config"], files["traffic"], files["limits"], seed, seconds, trace,
                     device, t0)
    run.limits = files["limits"]["limits"]
    return run


def _lists(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def metrics_of(files: dict, run, trace: bool) -> dict:
    """The cell's end-to-end metrics, or with `trace` its per-layer ones
    that found something to read, as {name: {value, unit}}."""
    from benchmark.harness import BENCH, load_module

    spec, cell = files["spec"], files["cell"]["name"]
    out = {}
    if not trace:
        for m in spec["end_to_end"]:
            if _lists(m, cell):
                value = run.setup_s if m["name"] == "setup_s" else run.end_to_end[m["name"]]
                out[m["name"]] = {"value": value, "unit": m["unit"]}
        return out
    reported = {m["name"] for m in spec["end_to_end"] if _lists(m, cell)}
    for m in spec["per_layer"]:
        if not _lists(m, cell) or m["moves"] not in reported:
            continue
        value = load_module(BENCH / "metrics" / f"{m['name']}.py").read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader", "-i", "0"],
                              capture_output=True, text=True, timeout=30)
        return proc.stdout.strip() or "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    files = cell_files(args.workload)
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")

    import torch

    chips = files["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    run = measure(files, args.seed, args.seconds, bool(args.trace), device, T0)
    found = forbidden_modules()
    if found:
        print(f"loaded in the run: {', '.join(found)}", file=sys.stderr)
        return 3
    trace = run.trace if args.trace else None
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
           "memory_peak_bytes": run.memory_peak_bytes, "card": power_limit()}
    if trace is not None:
        dev.update(busy_s=trace.busy_s, window_s=trace.window_s)
    line = {"correct": run.correct, "attempted": run.attempted, "failed": run.failed,
            "metrics": metrics_of(files, run, bool(args.trace)), "device": dev}
    if trace is not None:
        line["breakdown"] = trace.breakdown()
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in run.checks.items()}
    for k, v in run.readings.items():
        if k not in run.checks:
            print(f"reading {k}: {v!r} (not compared)", file=sys.stderr)
    for k, (v, lim) in run.checks.items():
        print(f"check {k}: {v!r} (limit {lim!r})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The readings that a cell's correctness limits are set from, on the card:

    python3 benchmark/readings.py --workload <name> --seeds 1 2 3 [--seconds S] [--control]

For each seed, the readings of a run of the cell (the program against the
reference, a window of `--seconds`; with `--checked-only`, from the calls
the reference checks alone), or with `--control` the control's (the
reference in TF32 in the program's place, against the reference in
float32), or with `--faults` each fault's (planted in the reference put in
the program's place), one JSON line a seed and side, all in one process.
The benchmark's own runs never run the control or the faults.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    import torch

    from benchmark.harness import BENCH, load_module
    from benchmark.run import cell_files, measure

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--checked-only", action="store_true",
                   help="the program's side from the checked calls alone (select cells)")
    p.add_argument("--faults", nargs="+",
                   help="faults planted in the reference instead (train cells)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    files = cell_files(args.workload)
    driver = load_module(BENCH / "drivers" / f"{files['traffic']['driver']}.py")
    for seed in args.seeds:
        t = time.perf_counter()
        if args.faults:
            by_fault = driver.faults(files["config"], files["traffic"], files["limits"], seed,
                                     device, args.faults)
        elif args.control:
            by_fault = {"control": driver.control(files["config"], files["traffic"],
                                                  files["limits"], seed, device)}
        elif args.checked_only:
            by_fault = {"program": driver.checked_readings(files["config"], files["traffic"],
                                                           files["limits"], seed, device)}
        else:
            by_fault = {"program": measure(files, seed, args.seconds, False, device, t).readings}
        for name, readings in by_fault.items():
            print(json.dumps({"workload": args.workload, "seed": seed, "side": name,
                              "seconds": time.perf_counter() - t, **readings}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

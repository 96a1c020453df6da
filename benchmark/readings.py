"""The readings the limits of ``limits/<cell>.json`` are set from, on the
card at the cell's own size: for each seed, the run's set-up and its
check (no window), the compared numbers of the program's states and, with
``--control``, those of the control, the reference computed in bfloat16
(the precision below the configuration's float32) in the program's place
at the same steps.  One JSON line a seed; the benchmark's own runs do not
run the control.

    python benchmark/readings.py --workload <cell> --seeds S1 S2 ... \
        [--control]
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(sp, seed: int, device, control: bool) -> dict:
    from benchmark import check, core
    drv, _ = core.setup(sp, seed, device)
    start, samples = core.check_repeat(drv, sp.traffic, seed,
                                       sp.config.get("name", sp.name))
    core.free(drv)
    per, ctrl, _, _ = core.compare(sp.config, seed, start, samples, device,
                                   control)
    nums = check.empty()
    for got in per:
        check.merge(nums, got)
    return {"seed": seed, "steps": [k for k, *_ in samples],
            "program": nums, "control": ctrl, "per_check": per}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark import core
    sp = core.spec(args.workload, ROOT)
    for seed in args.seeds:
        t = time.perf_counter()
        out = readings(sp, seed, args.device, args.control)
        out["seconds"] = time.perf_counter() - t
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

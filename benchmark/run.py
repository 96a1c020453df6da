"""One run of one cell of BENCHMARK.json on the card:

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted`` and ``failed`` (the checks of the program's states against
the plain reference), ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics), ``device`` and, traced,
``breakdown``; its last key, ``checks``, holds each compared number with
its limit, which are also the last lines of standard error.  Exits with 1
and prints no result without a CUDA card, when the cell asks for more
cards than there are, or when JAX or the JAX package is loaded once the
window has closed.  See core.py for what a run does.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def card() -> str:
    """The card's name and power limit, and its clock, draw and
    temperature as the run ends, as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                              "clocks.sm,power.draw,temperature.gpu",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # the program and the harness come from this checkout; its kernels are
    # built into build/kernels/ inside it
    sys.path.insert(0, str(ROOT))
    import torch
    from benchmark import core

    t_imports = time.perf_counter()
    sp = core.spec(args.workload, ROOT)
    chips = int(sp.cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        core.log(f"the cell needs {chips} CUDA card(s); torch sees "
                 f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 1
    kind = torch.cuda.get_device_name(0)
    torch.cuda.init()
    core.log(f"before set-up: imports {t_imports - T0:.3f} s, CUDA "
             f"{time.perf_counter() - t_imports:.3f} s")
    out = core.run_cell(sp, args.seed, args.seconds, bool(args.trace),
                        "cuda", T0, kind)
    core.log(f"card: {card()}; torch {torch.__version__}, CUDA "
             f"{torch.version.cuda}; cell {args.workload}, seed {args.seed}")
    bad = core.forbidden_loaded()
    if bad:
        core.log(f"loaded once the window closed: {bad}")
        return 1
    for k, v in out["metrics"].items():
        core.log(f"metric {k} {v['value']!r} {v['unit']}")
    for k, v in out["checks"].items():
        core.log(f"{k} {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

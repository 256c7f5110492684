"""
Readings for the limits of ``correct``: the numbers a cell compares, from
the program and from its controls, over many seeds in one process.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --seconds 2 --out chiprun_out/readings.jsonl

Each seed runs the cell as ``run.py`` does (at its own sizes, a window of
``--seconds``; a training cell's comparison needs none, so it runs one
iteration), then the cell's controls: the reference put in the program's
place in a lower precision (and, for training, with half of the batch
left out and with one observation altered).  One JSON line a seed goes to
``--out``; the benchmark's own runs never run the controls.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--out", required=True)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    _, _, _, traffic, _ = harness.cell_parts(args.workload)
    # training's comparison needs no window
    overrides = {"traffic": {}}
    if traffic["driver"] == "train":
        overrides["traffic"]["units"] = 1
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out, "a", encoding="utf-8") as f:
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            line = harness.execute(args.workload, seed, args.seconds, False,
                                   device=args.device, overrides=overrides,
                                   control=True, settle=False)
            row = {"workload": args.workload, "seed": seed,
                   "correct": line["correct"],
                   "numbers": {k: c["value"]
                               for k, c in line["checks"].items()},
                   "control": line["control"],
                   "seconds": time.perf_counter() - t0}
            f.write(json.dumps(row) + "\n")
            f.flush()
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The control of each cell's comparison: the plain reference put in the program's place and
computed in the nearest precision below the configuration's, compared with the
full-precision reference by the cell's own numbers. A limit stands only where the control
fails it. Each loop kind runs its own cells' control (`control(config, traffic, seed,
limits, blocks)` in `loops/<kind>.py`: float32 for the solves' float64, bfloat16 for the
render's float32), so a new kind brings its control in its loop file and this file knows no
kind.

    python3 -m portbench.calibrate --cell box.solve --seeds 11 12 13

prints one JSON line a seed with the control's numbers beside the cell's limits. The
benchmark's own runs never run it; portbench/tests/test_portbench_control.py runs it at a
small size.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from . import harness


def control(cell: str, seed: int, config=None, traffic=None, limits=None, blocks: int = 3):
    """The control's numbers by check name, from the cell's loop kind."""
    spec = harness.load_json("cells", cell)
    config = config or harness.load_json("configs", spec["config"])
    traffic = traffic or harness.load_json("traffic", spec["traffic"])
    limits = limits or spec["limits"]
    return harness.loop_function(traffic["kind"], "control")(config, traffic, seed, limits,
                                                             blocks)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.calibrate")
    p.add_argument("--cell", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--blocks", type=int, default=3)
    args = p.parse_args(argv)
    limits = harness.load_json("cells", args.cell)["limits"]
    for seed in args.seeds:
        t0 = time.perf_counter()
        got = control(args.cell, seed, blocks=args.blocks)
        print(json.dumps({"cell": args.cell, "seed": seed, "control": got, "limits": limits,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

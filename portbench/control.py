"""Readings that set a cell's limits, on the card at the cell's own size.

    python3 -m portbench.control --workload NAME --seeds 1 2 3 ... \\
        [--control-seeds 4 5 6] [--fault-seeds 7 8 9] [--arms 4]

For every seed of ``--seeds``: the program's numbers, as a run's check
reads them. For every seed of ``--control-seeds``: the control's, the
reference put in the program's place one precision below the
configuration's, read by the same comparison. For every seed of
``--fault-seeds``: the faults the cell can have, planted in the reference
put in the program's place. The cell's driver (``portbench/drivers/``,
named by its traffic file) makes the readings in its
``control_readings(cell, args)``. One line of JSON a reading. The
benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--arms", type=int, default=4)
    args = ap.parse_args(argv)
    from portbench import harness
    cell = harness.load_cell(args.workload)
    harness.cache_dirs()
    if not torch.cuda.is_available():
        print("portbench.control: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(harness.ROOT / "src"))
    driver = harness.driver(cell)
    for r in driver.control_readings(cell, args):
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

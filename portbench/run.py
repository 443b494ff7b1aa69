"""Run one cell of ``BENCHMARK.json`` once.

    python3 -m portbench.run --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout. The cell's configuration, traffic and
metrics are found by name (``BENCHMARK.json``, ``portbench/workloads/``,
``portbench/metrics/``); the traffic file names its driver
(``portbench/drivers/``). With ``--trace 0`` the result line carries the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics and
the device's busy and traced seconds. Without a CUDA card, or with fewer
cards than the cell asks for, the run prints no result and exits 2; a
traced run whose profiled stretch ran nothing on the device prints none
and exits 4.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import harness
    cell = harness.load_cell(args.workload)
    harness.cache_dirs()
    import torch
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell {cell.name} needs {chips} CUDA "
              f"card(s); this machine has {n}", file=sys.stderr)
        return 2
    src = harness.ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print(f"portbench: the program is missing ({src}/repro_torch)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    torch.set_num_threads(4)
    driver = harness.driver(cell)
    ctx = harness.Context(cell=cell, trace=bool(args.trace))
    checks = driver.run(ctx, args.seed, args.seconds, T_START)

    found = harness.forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}: the port "
              f"and the harness may load none of "
              f"{', '.join(harness.FORBIDDEN)}", file=sys.stderr)
        return 3
    p = ctx.profile
    if p is not None:
        if not (p["units"] and p["busy_s"] > 0):
            print("portbench: the profiled stretch ran nothing on the "
                  "device", file=sys.stderr)
            return 4
        steps = ctx.spans.get("step_s") or [0.0]
        print(f"profile: {p['wall_s']!r} s over {p['units']} units, the "
              f"window {ctx.window_s!r} s over {ctx.units} (a step "
              f"{min(steps)!r}..{max(steps)!r} s): the profiler's stretch "
              f"{(p['wall_s'] / p['units']) / (ctx.window_s / ctx.units)!r}"
              f"x", file=sys.stderr)
    kind = "per_layer" if args.trace else "end_to_end"
    metrics = {}
    for m in cell.metrics(kind):
        v = harness.load_metric(m["name"])(ctx)
        if v is not None and math.isfinite(v):
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips,
              "memory_peak_bytes": int(ctx.counters["memory_peak_bytes"])}
    out = {"correct": checks.correct, "attempted": ctx.units,
           "failed": int(ctx.counters.get("failed", 0)),
           "metrics": metrics, "device": device}
    if args.trace:
        p = p or {}
        device["busy_s"] = p.get("busy_s", 0.0)
        device["window_s"] = p.get("wall_s", 0.0)
        device["power_limit_w"] = harness.power_limit_w()
        out["breakdown"] = {
            "device_ops": [[n, s] for n, s in p.get("device_ops", [])],
            "idle_gaps": [[n, s] for n, s in p.get("idle_gaps", [])]}
    out["checks"] = checks.report()
    for note in checks.notes:
        print(f"check fault: {note}", file=sys.stderr)
    print(f"check took {ctx.counters.get('check_s', 0.0)!r} s",
          file=sys.stderr)
    for name, (v, lim) in checks.items.items():
        print(f"check {name} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""What every cell shares: the benchmark's files found by name, seeds,
the comparison's bookkeeping and the profiler's reading.

Nothing here imports the program; the drivers (``portbench/drivers``) do.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
#: top-level modules that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
MASK64 = (1 << 64) - 1


def mix(*values: int) -> int:
    """A 63-bit seed from integers (splitmix64 over them), so that
    (run seed, sweep, arm) give independent streams."""
    x = 0x243F6A8885A308D3
    for v in values:
        x = (x ^ (int(v) & MASK64)) * 0x9E3779B97F4A7C15 & MASK64
        x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
        x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & MASK64
        x ^= x >> 31
    return x & ((1 << 63) - 1)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """One entry of ``workloads`` with its configuration and traffic."""
    name: str
    entry: dict
    config: dict
    traffic: dict
    bench: dict

    def metrics(self, kind: str) -> List[dict]:
        """The ``end_to_end`` or ``per_layer`` metrics this cell reports."""
        return [m for m in self.bench[kind]
                if self.name in m.get("workloads", [self.name])]


def load_cell(name: str, bench_path: Path = ROOT / "BENCHMARK.json") -> Cell:
    bench = load_json(bench_path)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in {bench_path.name}")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = load_json(ROOT / conf["file"])
    traffic = load_json(HERE / "workloads" / f"{entry['traffic']}.json")
    return Cell(name, entry, config, traffic, bench)


def load_metric(name: str) -> Callable:
    """``read(ctx)`` of ``portbench/metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver(cell: Cell):
    """The module ``portbench/drivers/<driver>.py`` that the cell's traffic
    file names: its ``run``, ``control_readings`` and ``tiny``."""
    return importlib.import_module(
        f"portbench.drivers.{cell.traffic['driver']}")


@dataclass
class Checks:
    """Numbers compared with the reference, each with its limit."""
    items: Dict[str, List[float]] = field(default_factory=dict)
    notes: List[str] = field(default_factory=list)

    def add(self, name: str, value: float, limit: float) -> None:
        old = self.items.get(name)
        if old is None or not (value <= old[0]):
            self.items[name] = [float(value), float(limit)]

    def fail(self, note: str) -> None:
        self.notes.append(note)

    @property
    def correct(self) -> bool:
        return (not self.notes and bool(self.items)
                and all(math.isfinite(v) and v <= lim
                        for v, lim in self.items.values()))

    def report(self) -> Dict[str, Any]:
        out = {k: {"value": v, "limit": lim}
               for k, (v, lim) in self.items.items()}
        if self.notes:
            out["faults"] = self.notes
        return out


@dataclass
class Context:
    """What a driver hands to the metric readers."""
    cell: Cell
    trace: bool
    setup_s: float = 0.0
    window_s: float = 0.0
    units: int = 0                   # arm-rounds or rounds completed
    spans: Dict[str, List[float]] = field(default_factory=dict)
    counters: Dict[str, Any] = field(default_factory=dict)
    profile: Optional[dict] = None   # see ``profile``
    peaks: dict = field(default_factory=lambda: load_json(
        HERE / "peaks.json"))


def profile(fn: Callable[[], int]) -> dict:
    """torch.profiler, tracing the device's activity alone, around
    ``fn()``, which returns the units of work it ran; a first profiled call
    of nothing sets CUPTI up. The host's operators are not traced: doing
    so doubled a host-paced zoo round, and even the device's tracing
    stretches it (PERF.md §3), so a reader takes from the profile the
    device's times and no wall: ``wall_s`` is ``device.window_s`` alone.
    Returns the wall seconds, the
    seconds the device was busy (the union of the intervals in which a
    kernel, copy or fill ran on the card), the device time by name, and
    the longest idle gaps of the device by what the host was doing (the
    frozen copy of ``chip_smoke.device_busy``, with the union in place of
    its sum and the gaps added)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    acts = [ProfilerActivity.CUDA]
    with tprofile(activities=acts):
        torch.cuda.synchronize()
    with tprofile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        units = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev, host = [], []
    for e in prof.events():
        rng = e.time_range
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                dev.append((rng.start, rng.end, e.name))
        else:
            # the CUDA runtime's calls, which the device's tracing keeps
            host.append((rng.start, rng.end, e.name))
    by_name: Dict[str, float] = {}
    for a, b, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-6
    dev.sort()
    busy, gaps, end = 0.0, [], None
    for a, b, name in dev:
        if end is None or a >= end:
            if end is not None and a > end:
                gaps.append((end, a, name))
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    idle = _label_gaps(gaps, host)
    return {"wall_s": wall, "busy_s": busy * 1e-6, "units": units,
            "kernels": by_name,
            "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:10],
            "idle_gaps": sorted(idle.items(), key=lambda kv: -kv[1])[:10]}


def _label_gaps(gaps, host, longest: int = 256) -> Dict[str, float]:
    """Idle seconds of the ``longest`` gaps by the host's call that covers
    each most (of the runtime calls that cover at least 99% of the most
    any covers, the shortest), or, where none does, the host's Python
    before the launch of the device operation that ends the gap."""
    import numpy as np
    idle: Dict[str, float] = {}
    if not gaps:
        return idle
    hs = np.array([h[0] for h in host] or [0.0])
    he = np.array([h[1] for h in host] or [0.0])
    for a, b, after in sorted(gaps, key=lambda g: g[0] - g[1])[:longest]:
        over = np.minimum(he, b) - np.maximum(hs, a)
        name = f"host before {after}"
        if host and over.max() > 0:
            cand = np.nonzero(over >= 0.99 * over.max())[0]
            name = host[int(cand[np.argmin((he - hs)[cand])])][2]
        idle[name] = idle.get(name, 0.0) + (b - a) * 1e-6
    return idle


def kernel_seconds(ctx: Context, part: str) -> Optional[float]:
    """Device seconds of the profiled kernels whose name holds ``part``;
    None where none ran."""
    if ctx.profile is None:
        return None
    t = [s for n, s in ctx.profile["kernels"].items() if part in n]
    return sum(t) if t else None


def power_limit_w() -> Optional[float]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20).stdout.split()
        return float(out[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def forbidden_modules() -> List[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    base = ROOT / ".portbench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels")):
        (base / sub).mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(base / sub)

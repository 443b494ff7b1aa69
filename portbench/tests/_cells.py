"""The cells at sizes a CPU test run can hold, each cut by its driver's
``tiny``."""
import torch

from portbench import harness


def tiny(name: str) -> harness.Cell:
    """The cell ``name`` of BENCHMARK.json with its widths and lengths cut
    to a CPU's size, its checks and limits as they stand."""
    cell = harness.load_cell(name)
    cfg, tr = harness.driver(cell).tiny(cell.config, cell.traffic)
    return harness.Cell(cell.name, cell.entry, cfg, tr, cell.bench)


def run(name: str, seed: int = 2147483659, seconds: float = 0.2):
    cell = tiny(name)
    torch.set_num_threads(1)
    ctx = harness.Context(cell=cell, trace=False)
    checks = harness.driver(cell).run(ctx, seed, seconds, 0.0, device="cpu")
    return ctx, checks

"""The controls on the card, at each cell's own size: the reference put
in the program's place one precision below the configuration's (TF32
for the §V cell's f32, float8 for the zoo cell's bf16) fails the
comparison a run makes. Run on a machine with an NVIDIA GPU:

    python -m pytest -q -m cuda portbench/tests/test_portbench_card.py
"""
import argparse

import pytest

from portbench import harness


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    harness.cache_dirs()
    return torch.device("cuda")


@pytest.mark.cuda
def test_sweep_control_fails_the_first_round(card):
    cell = harness.load_cell("sec5-fig5-obcsaa")
    limit = cell.traffic["limits"]["first_round_gap"]
    args = argparse.Namespace(seeds=[], control_seeds=[2147483861],
                              fault_seeds=[], arms=2)
    readings = harness.driver(cell).control_readings(cell, args)
    assert readings and all(r["first_round_gap"]["value"] > limit
                            for r in readings), readings


@pytest.mark.cuda
def test_zoo_control_fails_a_number(card):
    cell = harness.load_cell("zoo-internvl2-1b-train")
    args = argparse.Namespace(seeds=[], control_seeds=[2147483863],
                              fault_seeds=[])
    (r,) = harness.driver(cell).control_readings(cell, args)
    limits = cell.traffic["limits"]
    assert any(r[k]["value"] > limits[k] for k in limits), r

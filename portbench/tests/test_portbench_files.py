"""BENCHMARK.json and the files it names, read by name as a run reads
them; every metric reader on an empty and on a filled context."""
import json
import math
import re

import pytest

from portbench import harness

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]


def test_contract_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    names = [c["name"] for c in BENCH["configs"]] + \
        [w["name"] for w in BENCH["workloads"]] + METRICS
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        cells = {w["name"] for w in BENCH["workloads"]}
        assert set(m["workloads"]) <= cells
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_by_name(cell):
    c = harness.load_cell(cell)
    driver = harness.driver(c)
    assert (harness.HERE / "drivers" / f"{c.traffic['driver']}.py").is_file()
    for fn in ("run", "control_readings", "tiny"):
        assert callable(getattr(driver, fn)), fn
    assert set(c.traffic["limits"]) and all(
        v > 0 for v in c.traffic["limits"].values())
    reported = {m["name"] for m in c.metrics("end_to_end")}
    assert "setup_s" in reported and len(reported) >= 2
    assert c.metrics("per_layer")
    conf = next(x for x in BENCH["configs"] if x["name"] == c.entry["config"])
    assert conf["file"].startswith("portbench/configs/")


@pytest.mark.parametrize("name", METRICS)
def test_metric_reader_loads_and_reads_nothing(name):
    read = harness.load_metric(name)
    cell = harness.load_cell(BENCH["workloads"][0]["name"])
    ctx = harness.Context(cell=cell, trace=True)
    v = read(ctx)
    assert v is None or v == 0.0


def _filled(cell_name):
    cell = harness.load_cell(cell_name)
    ctx = harness.Context(cell=cell, trace=True, setup_s=9.5, window_s=30.0,
                          units=7)
    ctx.spans = {"replay_ms": [1.1] * 10, "stage_backward": [900.0] * 3,
                 "stage_decode": [60.0] * 3}
    ctx.counters = {"replay_rounds": 10,
                    "captures": [{"warmup_s": 0.01, "capture_s": 0.02}],
                    "launches": {"backproject": 312, "cs_project": 12,
                                 "cs_project_resid": 300}}
    ctx.profile = {"wall_s": 5.0, "busy_s": 1.0, "units": 1,
                   "kernels": {"backproject_kernel": 0.4,
                               "cs_project_stream_kernel": 0.4}}
    return ctx


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_metric_readers_on_a_filled_context(cell):
    ctx = _filled(cell)
    c = ctx.cell
    for m in c.metrics("end_to_end") + c.metrics("per_layer"):
        v = harness.load_metric(m["name"])(ctx)
        assert v is not None and math.isfinite(v) and v >= 0, m["name"]
        if m["unit"] == "%":
            assert v <= 100.0, m["name"]


def test_seed_mix_is_stable_and_63_bit():
    a = harness.mix(2 ** 31 + 5, 2, 3)
    assert a == harness.mix(2 ** 31 + 5, 2, 3) != harness.mix(2 ** 31 + 6, 2, 3)
    assert 0 <= a < 2 ** 63

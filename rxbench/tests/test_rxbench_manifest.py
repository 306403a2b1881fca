"""``BENCHMARK.json`` against the benchmark's contract, and every name in
it resolved to its files."""
import json
import re

import pytest

from rxbench import manifest, txgen

BENCH = manifest.load()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["rxbench"]
    assert BENCH["command"] == ["python3", "rxbench/run.py"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_one_line_texts():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for x in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(x["why"]) <= 200 and "\n" not in x["why"]
    for m in BENCH["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200


def test_end_to_end_bounds_and_sources():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_every_cell_resolves_and_reports_enough():
    cells = [w["name"] for w in BENCH["workloads"]]
    per_layer_names = {m["name"] for m in BENCH["per_layer"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert set(m.get("workloads", cells)) <= set(cells)
    for name in cells:
        cell = manifest.cell(name)
        e2e = {m["name"] for m in cell["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell["per_layer"]
        assert set(cell["readers"]) <= per_layer_names
        assert cell["workload"]["chips"] == 1
        assert manifest.entry_class(cell["config"]) is not None
        for k in ("reports_extra", "rssi_gap_db", "cfo_gap"):
            assert cell["config"]["limits"][k] >= 0


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_files(cfg):
    assert cfg["file"].startswith("rxbench/configs/")
    config = json.loads((manifest.ROOT / cfg["file"]).read_text())
    assert cfg["reduced"] == []
    # the chunk the window hands over is one dispatch of the receiver
    N = config["num_channels"]
    blocks = config.get("n_blocks") or config["batch_blocks"]
    assert config["chunk_samples"] == (2 * N if N > 1 else 1) * \
        config["block_size"] * blocks


def test_traffic_is_data_and_streams_hold_100_MB():
    for w in BENCH["workloads"]:
        cell = manifest.cell(w["name"])
        t, c = cell["traffic"], cell["config"]
        assert c["chunk_samples"] * 8 * t["loop_chunks"] >= 100e6
        if t.get("burst_every", 1) > 1:
            assert t["traced_dispatches"] % t["burst_every"] == 0
        assert txgen.receiver_overlap(c) > 0

"""BENCHMARK.json and every configuration, workload, traffic and metric file
parse, use legal names and units, and agree with each other."""
import json
import math
import re

import pytest

from benchlib import cells

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}

BENCH = cells.benchmark()


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(_line(w) and not w.startswith("/") and ".." not in w
               for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    assert all(PATH.match(p) for p in BENCH["paths"])
    assert not BENCH["paths"][0].endswith("_torch")
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_a_full_check_fits_with_24_cells():
    runs = 2 + 14 * 24
    total = runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(cfg["name"]) and _line(cfg["why"])
    assert _line(cfg["source"]) and cfg["source"].startswith("https://")
    assert cfg["file"] == f"h100_bench/configs/{cfg['name']}.json"
    body = cells.read_json(cells.ROOT / cfg["file"])
    assert body["reduced"] == cfg["reduced"] == []
    assert body["source"] == cfg["source"]
    args = body["config"]["archs"]["SurfaceTextureInpaintingNet"]["args"]
    assert args["ngf"] == 64 and args["n_blocks"] == 9
    assert args["dilations"] == [1, 1, 1, 2, 4, 8, 16, 1, 1]


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_workload(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    assert w["chips"] in (1, 4) and _line(w["why"])
    workload, config, mix = cells.cell_files(w["name"])
    for key in ("config", "traffic", "chips", "why"):
        assert workload[key] == w[key]
    assert config["source"]
    assert (cells.BENCH_DIR / "traffic" / f"{mix['driver']}.py").exists()
    assert all(isinstance(v, (int, float)) and math.isfinite(v) and v >= 0
               for v in workload["limits"].values())
    e2e = [m["name"] for m in cells.metrics_of(BENCH, w["name"],
                                               "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cells.metrics_of(BENCH, w["name"], "per_layer")


def test_names_are_unique_and_chips_within_the_share():
    for group in ("configs", "workloads"):
        names = [x["name"] for x in BENCH[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("m", BENCH["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_metric(m):
    assert set(m) <= {"name", "unit", "better", "bound", "source",
                      "workloads"}
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert m["source"] in ("host_clock", "device_trace")
    assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric(m):
    assert set(m) == {"name", "unit", "better", "source", "layer", "moves",
                      "workloads"}
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
    assert _line(m["layer"])
    if "roofline" in m["name"] or "mfu" in m["name"]:
        assert m["unit"] == "%"
    # the metric it moves is reported by every cell that lists it
    moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
    for cell in m["workloads"]:
        assert cell in moved.get("workloads", [cell])
    reader = cells.reader(m["name"])
    assert reader.read({}) is None


def test_layers_are_named_alike():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert layers <= {"training loop", "loader and placement", "train step",
                      "ops", "kernels", "device"}


READY = sorted(p.stem for p in (cells.BENCH_DIR / "workloads").glob("*.json"))


@pytest.mark.parametrize("cell", READY)
def test_every_cell_file_names_its_files(cell):
    """Each cell's file parses and names a configuration, a traffic mix
    and a driver that exist."""
    workload, config, mix = cells.cell_files(cell)
    assert NAME.match(cell) and NAME.match(workload["traffic"])
    assert (cells.BENCH_DIR / "traffic" / f"{mix['driver']}.py").exists()
    assert config["reduced"] == [] and workload["chips"] == 1
    assert _line(workload["why"]) and workload["limits"]

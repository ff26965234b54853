"""Find a cell's files by the names in BENCHMARK.json.

A cell `<w>` is `workloads/<w>.json` (its configuration, its traffic mix,
its chips, its `why` and the limits of its comparison); its configuration
`<c>` is `configs/<c>.json`; its traffic mix `<t>` is `traffic/<t>.json`,
which names the driver `traffic/<driver>.py` that runs it; a per-layer
metric `<m>` is read by `metrics/<m>.py`. A later cell, mix or metric is
new files and new entries, with no edit to a file that is there.
"""
import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Context:
    """What a traffic driver is given for one run."""
    name: str
    seed: int
    seconds: float
    trace: bool
    workload: dict
    config: dict
    mix: dict
    device: object
    setup_t0: float
    calibrate: bool = False

    @property
    def args(self) -> dict:
        """The arch arguments of the configuration's one architecture."""
        (arch,) = self.config["config"]["archs"].values()
        return arch["args"]

    @property
    def limits(self) -> dict:
        return self.workload["limits"]


def benchmark() -> dict:
    return read_json(ROOT / "BENCHMARK.json")


def entry(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def cell_files(name: str):
    """(workload, config, mix) of cell `name`."""
    workload = read_json(BENCH_DIR / "workloads" / f"{name}.json")
    config = read_json(BENCH_DIR / "configs" / f"{workload['config']}.json")
    mix = read_json(BENCH_DIR / "traffic" / f"{workload['traffic']}.json")
    return workload, config, mix


def driver(mix: dict):
    kind = mix["driver"]
    return load_module(BENCH_DIR / "traffic" / f"{kind}.py",
                       f"bench_driver_{kind}")


def metrics_of(bench: dict, cell: str, kind: str):
    """The `end_to_end` or `per_layer` entries that cell `cell` reports."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


def reader(metric: str):
    return load_module(BENCH_DIR / "metrics" / f"{metric}.py",
                       "bench_metric_" + metric.replace(".", "_")
                       .replace("-", "_"))

"""The benchmark's own tests: `python -m pytest h100_bench/tests -q`.

They run on the CPU at small sizes, with the program's plain torch
versions; the one test marked `cuda` runs a cell on the card and skips
elsewhere. The benchmark's folder and the checkout's root go on the path,
as `run.py` puts them."""
import sys
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parents[1]
for p in (str(BENCH_DIR), str(BENCH_DIR.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture(autouse=True)
def one_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(n)


SMALL_ROOMS = {"count": 3, "min_vertices": 600, "max_vertices": 1500,
               "levels": 3, "decimation": 0.3,
               "dilations": [2, 4, 6, 8, 16], "dilation_levels": None}


@pytest.fixture
def small_context(tmp_path, monkeypatch):
    """small_context(cell, seconds, **mix) -> a CPU context of the cell
    with a pool of three small rooms, TMPDIR under the test's folder."""
    import time
    import torch
    import run
    monkeypatch.setenv("TMPDIR", str(tmp_path))

    def make(cell, seconds=1.0, calibrate=False, **mix):
        rooms = dict(SMALL_ROOMS)
        return run.make_context(cell, 2**31 + 77, seconds, 0,
                                torch.device("cpu"), time.perf_counter(),
                                calibrate=calibrate,
                                mix_overrides={"rooms": rooms, **mix})
    return make

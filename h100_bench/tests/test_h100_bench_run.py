"""The command without a card, the modules a run loads, and the comparison:
a sound run comes out correct, and a run with the timed path broken
underneath (each fault a training cell can have) or the control in the
program's place comes out not correct."""
import ast
import json
import subprocess
import sys

import pytest
import torch

import run
from benchlib import cells, env

ROOT = cells.ROOT


def _outcome_correct(out):
    ok, _ = run.judge(out["checks"])
    return ok and out["failed"] == 0


def test_exits_nonzero_without_a_card():
    p = subprocess.run(
        [sys.executable, "h100_bench/run.py", "--workload",
         "train-rooms-cli", "--seed", str(2 ** 31 + 5), "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
                          "HOME": str(ROOT)})
    assert p.returncode != 0
    assert "{" not in p.stdout
    assert "no result" in p.stderr


def test_exits_nonzero_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    folder."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(cells.BENCH_DIR, tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run(
        [sys.executable, "h100_bench/run.py", "--workload",
         "train-rooms-cli", "--seed", "3", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert p.returncode != 0
    assert "{" not in p.stdout and "no result" in p.stderr


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "stinet_tpu_torch.fake",
                        type(sys)("stinet_tpu_torch.fake"))
    monkeypatch.setitem(sys.modules, "jaxtyping_like", type(sys)("x"))
    assert env.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "stinet_tpu.ops", type(sys)("x"))
    assert env.loaded_forbidden() == ["stinet_tpu"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_reference_imports_nothing_of_the_program_or_jax():
    for path in (cells.BENCH_DIR / "reference").glob("*.py"):
        tops = set(_imports(path))
        assert not tops & {"stinet_tpu_torch", *env.FORBIDDEN}, path


def test_no_file_of_the_harness_imports_jax():
    for path in cells.BENCH_DIR.rglob("*.py"):
        assert not set(_imports(path)) & set(env.FORBIDDEN), path


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """Every cell's driver, with its readers and the reference, run at a
    small size in a fresh process: no forbidden top-level name loaded, and
    no module of the program in the reference's own process."""
    code = f"""
import sys, time, torch
sys.path[:0] = [{str(cells.BENCH_DIR)!r}, {str(ROOT)!r}]
torch.set_num_threads(2)
from reference import stinet_ref, training_ref
assert not any(m.split('.')[0] == 'stinet_tpu_torch' for m in sys.modules)
import run
from benchlib import cells, env
small = {{"count": 2, "min_vertices": 500, "max_vertices": 700, "levels": 3,
          "decimation": 0.3, "dilations": [2, 4, 6, 8, 16],
          "dilation_levels": None}}
bench = cells.benchmark()
for path in sorted((cells.BENCH_DIR / "workloads").glob("*.json")):
    ctx = run.make_context(path.stem, 7, 0.3, 1, torch.device("cpu"),
                           time.perf_counter(), mix_overrides={{
                               "rooms": small, "trace_steps": 1}})
    out = run.run_cell(ctx)
    run.metric_values(bench, path.stem, out, True)
print("FORBIDDEN", env.loaded_forbidden())
"""
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    assert "FORBIDDEN []" in p.stdout


def test_sound_training_run_is_correct(small_context):
    """On rooms of 8,000-16,000 vertices: bf16's rounding of the loss and
    of a small leaf's gradient averages out at the cells' sizes, not at a
    few hundred vertices."""
    ctx = small_context("train-rooms-cli", 0.5)
    ctx.mix["rooms"].update(min_vertices=8000, max_vertices=16000)
    assert _outcome_correct(run.run_cell(ctx))


def test_a_step_that_keeps_its_state_is_not_correct(small_context,
                                                    monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step",
                        lambda self, closure=None: None)
    out = run.run_cell(small_context("train-rooms-cli", 0.5))
    assert not _outcome_correct(out)


def test_half_the_batch_left_out_is_not_correct(small_context, monkeypatch):
    from stinet_tpu_torch.trainers import graph_common as gc
    vertex_mask = gc.vertex_mask

    def half(graph):
        m = vertex_mask(graph).clone()
        m[::2] = 0
        return m
    monkeypatch.setattr(gc, "vertex_mask", half)
    out = run.run_cell(small_context("train-rooms-cli", 0.5))
    assert not _outcome_correct(out)


def test_the_control_fails_the_limits(small_context):
    """The reference in the next precision below the configuration's
    (float8 for the bf16 trainer), read in the program's place, fails one
    of the cell's limits."""
    from traffic.train_rooms import NUMBERS
    cell = "train-rooms-cli"
    out = run.run_cell(small_context(cell, 0.5, calibrate=True))
    got = dict(zip(NUMBERS, out["calibration"]["control_fp8"]))
    lim = cells.cell_files(cell)[0]["limits"]
    assert any(got[k] > lim[k] for k in lim)


@pytest.mark.cuda
def test_a_cell_runs_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    p = subprocess.run(
        [sys.executable, "h100_bench/run.py", "--workload",
         "train-rooms-cli", "--seed", "2147483999", "--seconds", "3",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"] and "train_device_ms_per_scene" in result["metrics"]

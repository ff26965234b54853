"""The port's spans (stinet_tpu_torch/utils/profiling.py:span), on the CPU.

A span records its wall and thread-CPU time, its thread, its parent and
its batch into a bounded ring (`span_records`), also when the work inside
it raises; under a torch profiler it is a range of the trace, on every
thread where `EpochProfiler` asks torch for all of them. The loader, the
build, the placer's loop and the train step open one span each where the
work happens: one epoch of the windowed loader and one train step give
the counts below. Small rooms (a few thousand vertices), torch on one
thread. Imports no JAX."""
import json
import os
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from stinet_tpu_torch.core.config import ConfigParser
from stinet_tpu_torch.data.prefetch import PrefetchIterator
from stinet_tpu_torch.data.scannet import (
    SCANNET_TRAIN_FILE, SCANNET_VAL_FILE, ScanNetGraphColorDataLoader,
    read_split)
from stinet_tpu_torch.graph.build import build_hierarchical_graph
from stinet_tpu_torch.models.factory import define_G
from stinet_tpu_torch.ops import norms
from stinet_tpu_torch.trainers import graph_common as gc
from stinet_tpu_torch.trainers.inpainting3d import Inpainting3DTrainer
from stinet_tpu_torch.utils import profiling
from stinet_tpu_torch.utils.profiling import span, span_records
from stinet_tpu_torch.utils.synthetic import (
    synthetic_scene, write_loader_scene)

ARGS = dict(input_nc=10, output_nc=3, ngf=8, filter_type="edgeconvtransinv",
            norm="instance", n_blocks=3, dilations=[1, 2, 4], n_levels=2,
            n_repeated_io_convs=1, pooling_type="max",
            checkpoint_bottleneck=True, num_blocks_per_uncheckpointed_block=1)
TRANSFORMS = [
    {"type": "CoordsNormalization", "args": {"max_sizes": [1.5, 1.5, 1.5]}},
    {"type": "RandomLinearTransformation", "args": {"flip": True}},
    {"type": "RandomRotation", "args": {}}]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def since(t0_ns, name=None):
    """The records that started at or after t0_ns (named `name`), leaving
    out those of the ring test's fill and of another test's threads."""
    return [r for r in span_records() if r.start_ns >= t0_ns
            and (r.name == name if name else not r.name.startswith(
                ("load.", "build.", "loop.", "place.")))]


def _spin(seconds):
    end = time.perf_counter() + seconds
    while time.perf_counter() < end:
        pass


# --- the facility ----------------------------------------------------------

def test_record_fields_and_parent_on_one_thread():
    t0 = time.perf_counter_ns()
    with span("outer", ["scene_a", "scene_b"]):
        with span("inner") as s:
            s.batch = ["scene_c"]
            _spin(0.002)
    inner, outer = since(t0)
    assert (inner.name, outer.name) == ("inner", "outer")
    assert inner.parent == "outer" and outer.parent is None
    assert outer.batch == ("scene_a", "scene_b")
    assert inner.batch == ("scene_c",)
    assert inner.thread == outer.thread == threading.get_ident()
    assert t0 <= outer.start_ns <= inner.start_ns < inner.end_ns \
        <= outer.end_ns
    assert inner.end_ns - inner.start_ns >= 2_000_000
    assert 0 < inner.cpu_ns
    assert isinstance(inner, profiling.SpanRecord)


def test_parent_is_per_thread_and_can_be_named():
    """A span on another thread has no parent from this one, unless the
    code that hands the work over names it."""
    def plain():
        with span("plain"):
            pass

    def handed():
        with span("handed", parent="caller"):
            pass

    t0 = time.perf_counter_ns()
    with span("caller"):
        with ThreadPoolExecutor(1) as pool:
            pool.submit(plain).result()
            pool.submit(handed).result()
    rec = {r.name: r for r in since(t0)}
    assert rec["plain"].parent is None
    assert rec["handed"].parent == "caller"
    assert rec["handed"].thread != rec["caller"].thread


def test_an_exception_inside_a_span_is_recorded_and_raised():
    t0 = time.perf_counter_ns()
    with pytest.raises(KeyError, match="inside"):
        with span("failing", ["scene"]):
            raise KeyError("inside")
    (rec,) = since(t0)
    assert rec.name == "failing" and rec.batch == ("scene",)
    # the open spans are unwound: the next one has no parent
    with span("after"):
        pass
    assert since(t0, "after")[0].parent is None


def test_the_ring_keeps_the_newest_records():
    n = profiling.SPAN_RECORDS_MAX
    t0 = time.perf_counter_ns()
    for k in range(n + 5):
        with span("ring", [str(k)]):
            pass
    records = span_records()
    assert len(records) == n
    assert records[-1].batch == (str(n + 4),)
    ours = [r for r in records if r.start_ns >= t0 and r.name == "ring"]
    assert len(ours) == n and ours[0].batch == ("5",)


def test_threads_lose_no_record_and_keep_their_own_parents():
    """More threads than cores open nested spans at a short switch
    interval while another copies the ring: every record arrives, each
    with its own thread's parent."""
    threads, each = 2 * (os.cpu_count() or 4), 300
    t0 = time.perf_counter_ns()
    stop = threading.Event()

    def work(k):
        for _ in range(each):
            with span(f"stress.outer.{k}"):
                with span("stress.inner", [str(k)]):
                    pass

    def copy():
        while not stop.is_set():
            span_records()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        reader = threading.Thread(target=copy)
        reader.start()
        with ThreadPoolExecutor(threads) as pool:
            for f in [pool.submit(work, k) for k in range(threads)]:
                f.result(timeout=60)
        stop.set()
        reader.join(timeout=60)
        assert not reader.is_alive()
    finally:
        sys.setswitchinterval(interval)
    inner = since(t0, "stress.inner")
    assert len(inner) == threads * each
    for r in inner:
        assert r.parent == f"stress.outer.{r.batch[0]}"
    assert not profiling._open.get(threading.get_ident())


@pytest.mark.parametrize("work", ["sleep", "spin"])
def test_thread_cpu_is_at_most_wall(work):
    t0 = time.perf_counter_ns()
    with span("cpu"):
        time.sleep(0.01) if work == "sleep" else _spin(0.01)
    (rec,) = since(t0)
    wall = rec.end_ns - rec.start_ns
    assert 0 <= rec.cpu_ns <= wall
    if work == "sleep":
        assert rec.cpu_ns < wall / 2


def test_a_span_is_a_profiler_range_on_the_caller():
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter_ns()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("traced.caller"):
            torch.ones(8).sum()
    events = [e for e in prof.events() if e.name == "traced.caller"]
    assert len(events) == 1
    assert len(since(t0, "traced.caller")) == 1


def _trace_names(log_dir):
    names = set()
    for f in log_dir.glob("*.pt.trace.json"):
        names |= {e.get("name") for e in
                  json.loads(f.read_text())["traceEvents"]}
    return names


def test_epoch_profiler_traces_spans_on_other_threads(tmp_path):
    """Under `EpochProfiler` a span shows in the trace from the caller, a
    prefetch thread and a thread pool's worker."""
    if profiling._all_threads_config() is None:
        pytest.skip(f"torch {torch.__version__} has no profile_all_threads: "
                    "only the caller's ranges are traced")

    def produce():
        for k in range(2):
            with span("traced.prefetch"):
                torch.ones(8).sum()
            yield k

    def pooled():
        with span("traced.pool"):
            torch.ones(8).sum()

    prof = profiling.EpochProfiler(tmp_path, skip_first=0, wait=0, warmup=0,
                                   active=1, repeat=1)
    prof.step()
    with span("traced.caller"):
        assert list(PrefetchIterator(produce())) == [0, 1]
        with ThreadPoolExecutor(1) as pool:
            pool.submit(pooled).result()
    prof.close()
    assert {"traced.caller", "traced.prefetch", "traced.pool"} \
        <= _trace_names(tmp_path)


# --- the program's spans ---------------------------------------------------

def _write_rooms(root, names, sizes):
    for k, (name, v) in enumerate(zip(names, sizes)):
        write_loader_scene(root, name, synthetic_scene(
            num_vertices=v, levels=3, seed=k, dilation_dists=(2, 4)))


@pytest.fixture(scope="module")
def rooms(tmp_path_factory):
    base = tmp_path_factory.mktemp("rooms")
    out = {"train": str(base / "train"), "val": str(base / "val")}
    _write_rooms(out["train"], read_split(SCANNET_TRAIN_FILE)[:2],
                 (2000, 3000))
    _write_rooms(out["val"], read_split(SCANNET_VAL_FILE)[:1], (1500,))
    return out


def _loader_args(rooms):
    return {"train_root_dir": rooms["train"], "val_root_dir": rooms["val"],
            "mask_name": "rad_16", "train_batch_size": 1,
            "test_batch_size": 1, "end_level": 3, "windowed_graphs": True,
            "train_transform": TRANSFORMS,
            "valid_transform": TRANSFORMS[:1]}


def test_one_loader_epoch_opens_each_span_once_a_batch(rooms):
    """The windowed loader's epoch over two rooms: a `load.batch` a batch
    on the loader's thread holding one `load.read` and `load.transform` a
    scene and one `build.order`, `build.tables` and `build.levels`; one
    `build.edge_set` an edge set of the batch under `build.tables`; one
    `loop.wait` a batch taken, and one more for the epoch's end."""
    loader = ScanNetGraphColorDataLoader(_loader_args(rooms),
                                         seed=3).train_loader
    t0 = time.perf_counter_ns()
    got = list(gc.iter_placed(loader, torch.device("cpu")))
    assert len(got) == 2
    recs = [r for r in span_records() if r.start_ns >= t0]
    by = {}
    for r in recs:
        by.setdefault(r.name, []).append(r)
    batches = {r.batch: r for r in by["load.batch"]}
    assert sorted(batches) == sorted((n[0],) for _, n in got)
    loader_thread = by["load.batch"][0].thread
    assert loader_thread != threading.get_ident()
    for graph, names in got:
        key = tuple(names)
        for name, parent in (("load.read", "load.batch"),
                             ("load.transform", "load.batch"),
                             ("build.order", "load.batch"),
                             ("build.tables", "load.batch"),
                             ("build.levels", "load.batch")):
            (rec,) = [r for r in by[name] if r.batch == key]
            assert rec.parent == parent and rec.thread == loader_thread
            outer = batches[key]
            assert outer.start_ns <= rec.start_ns <= rec.end_ns \
                <= outer.end_ns
        sets = [r for r in by["build.edge_set"] if r.batch == key]
        want = sum(1 + len(lv.dilated) for lv in graph.levels)
        assert len(sets) == want == 5
        assert all(r.parent == "build.tables" for r in sets)
    waits = by["loop.wait"]
    assert len(waits) == 3 and waits[-1].batch is None
    assert [w.batch for w in waits[:2]] == [tuple(n) for _, n in got]
    assert all(w.thread == threading.get_ident() for w in waits)
    for r in recs:
        assert 0 <= r.cpu_ns <= r.end_ns - r.start_ns


def _model_and_graph():
    torch.manual_seed(0)
    model = define_G(**ARGS)
    graph = build_hierarchical_graph(
        [synthetic_scene(num_vertices=2000, levels=3, seed=5,
                         dilation_dists=(2, 4))],
        pad_multiple=128, geometric=True)
    return model, graph


def test_a_train_step_opens_its_spans(monkeypatch):
    """One `_TrainStep` call and its `host_metrics`: one `step.forward`,
    `step.backward`, `step.optimizer` and `step.sync`, and one
    `op.k2.backward` an instance norm of the forward, none of which holds
    the checkpointed blocks' forward rerun."""
    model, graph = _model_and_graph()
    opt, lr = gc.build_optimizer(model.parameters(),
                                 {"type": "Adam", "args": {"amsgrad": True}})
    step, _ = gc.make_inpainting_steps(model, opt, True)
    forward_at = []
    plain = norms._InstanceNorm.forward

    def counted(ctx, *args):
        forward_at.append(time.perf_counter_ns())
        return plain(ctx, *args)
    monkeypatch.setattr(norms._InstanceNorm, "forward", staticmethod(counted))
    with torch.no_grad():
        model(graph)
    norms_a_forward = len(forward_at)
    assert norms_a_forward > 0

    t0 = time.perf_counter_ns()
    forward_at.clear()
    metrics = gc.host_metrics(step(graph, lr))
    assert np.isfinite(metrics["loss"])
    counts = {}
    for r in since(t0):
        counts[r.name] = counts.get(r.name, 0) + 1
    assert counts == {"step.forward": 1, "step.backward": 1,
                      "step.optimizer": 1, "step.sync": 1,
                      "op.k2.backward": norms_a_forward}
    (fwd,) = since(t0, "step.forward")
    (bwd,) = since(t0, "step.backward")
    reruns = [t for t in forward_at if t > fwd.end_ns]
    assert reruns, "the checkpointed blocks rerun their forward"
    for r in since(t0, "op.k2.backward"):
        assert bwd.start_ns <= r.start_ns <= r.end_ns <= bwd.end_ns
        assert not [t for t in reruns if r.start_ns <= t <= r.end_ns]


def test_k2_backward_is_a_profiler_range():
    from torch.profiler import ProfilerActivity, profile
    model, graph = _model_and_graph()
    opt, lr = gc.build_optimizer(model.parameters(),
                                 {"type": "Adam", "args": {}})
    step, _ = gc.make_inpainting_steps(model, opt, False)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        gc.host_metrics(step(graph, lr))
    names = {e.name for e in prof.events()}
    assert {"op.k2.backward", "step.forward", "step.backward",
            "step.optimizer", "step.sync"} <= names


def _trainer_config(tmp_path, rooms, epochs):
    return {
        "name": "spans3d", "n_gpu": 1, "seed": 49,
        "archs": {"SurfaceTextureInpaintingNet": {"enabled": True,
                                                  "args": dict(ARGS)}},
        "data_loader": {"type": "ScanNetGraphColorDataLoader",
                        "args": dict(_loader_args(rooms),
                                     windowed_graphs=False)},
        "optimizer": {"type": "Adam", "args": {"lr": 7e-5, "amsgrad": True}},
        "loss": "", "metrics": [],
        "trainer": {"type": "Inpainting3DTrainer", "epochs": epochs,
                    "save_dir": str(tmp_path / "saved"),
                    "do_validation": False, "use_mask_weighted_loss": True,
                    "batches_per_log": 100, "save_period": epochs,
                    "verbosity": 0, "monitor": "off", "tensorboard": False,
                    "profile": True},
        "eval": None, "vis": False, "git_hash": "test",
    }


def test_a_profiled_3d_run_traces_the_spans(tmp_path, rooms):
    """`trainer.profile` on the 3D trainer: its default schedule traces
    steps 4-6 of 8 (4 epochs of 2 rooms), and the trace names the step's
    spans, and the loader's where torch traces every thread."""
    config = ConfigParser(_trainer_config(tmp_path, rooms, epochs=4))
    trainer = Inpainting3DTrainer(config, device="cpu")
    trainer.train()
    assert trainer.profiler is not None
    names = _trace_names(config.log_dir / "profile")
    assert {"step.forward", "step.backward", "step.sync",
            "op.k2.backward", "loop.wait"} <= names
    if profiling._all_threads_config() is not None:
        assert {"load.read", "load.transform", "build.tables",
                "build.edge_set"} <= names
    assert [t["steps"] for t in trainer.epoch_timings] == [2, 2, 2, 2]


def test_a_dry_run_is_not_profiled(tmp_path, rooms):
    config = ConfigParser(_trainer_config(tmp_path, rooms, epochs=1),
                          dry_run=True)
    trainer = Inpainting3DTrainer(config, device="cpu")
    assert trainer.profiler is None
    assert not os.path.exists(config.log_dir / "profile")

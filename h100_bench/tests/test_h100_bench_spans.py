"""`benchlib/spans.py`'s window rule and the readers of the program's spans,
on fabricated records: the window runs from the end of the set-up's last
`step.sync` to the end of the window's last, a record belongs to it when
it started inside, and every reader returns None where there is nothing
to read (no facts, a program without spans, a ring that lost the
window)."""
import types

import pytest

from benchlib import cells, spans
from stinet_tpu_torch.utils import profiling

MS = 1_000_000
CALLER, LOADER, PLACER, POOL = 1, 2, 3, 4
SPAN_METRICS = [m["name"] for m in cells.benchmark()["per_layer"]
                if m["source"] == "program_span"]


def rec(name, thread, start_ms, end_ms, cpu_ms=None):
    return profiling.SpanRecord(
        name, thread, int(start_ms * MS), int(end_ms * MS),
        int((end_ms - start_ms if cpu_ms is None else cpu_ms) * MS),
        None, None)


def facts(steps=2, items=1, ranges=None):
    return {"steps": steps,
            "trace": types.SimpleNamespace(items=items,
                                           ranges=dict(ranges or {}))}


def records():
    """Set-up's last step (sync ends at 100), two window steps (syncs end
    at 200 and 300), one traced step (sync ends at 400); the loader and
    the placer run beside the waits."""
    out = []
    for k, t in enumerate((0, 100, 200, 300)):
        out += [rec("loop.wait", CALLER, t + 10, t + 50),
                rec("step.forward", CALLER, t + 50, t + 70, cpu_ms=15),
                rec("step.backward", CALLER, t + 70, t + 80),
                rec("step.optimizer", CALLER, t + 80, t + 85, cpu_ms=0),
                rec("step.sync", CALLER, t + 85, t + 100)]
        # a batch's build: starts before the wait, covers its first half
        out += [rec("load.batch", LOADER, t - 20, t + 30),
                rec("load.read", LOADER, t - 20, t - 10 + k),
                rec("build.tables", LOADER, t + 1, t + 21),
                rec("build.edge_set", POOL, t + 1, t + 21),
                rec("build.edge_set", POOL + 1, t + 6, t + 16),
                rec("place.pack", PLACER, t + 30, t + 40)]
    return out


@pytest.fixture
def ring(monkeypatch):
    held = records()
    monkeypatch.setattr(profiling, "span_records", lambda: list(held))
    return held


def test_the_window_lies_between_the_syncs(ring):
    got, (a, b) = spans.window(facts())
    assert (a, b) == (100 * MS, 300 * MS)
    # the loader's read of the window's first batch started before the
    # window (at 80 ms): it is the set-up's, not the window's
    reads = spans.in_window(facts(), "load.read")
    assert [r.start_ns for r in reads] == [180 * MS, 280 * MS]
    assert len(spans.in_window(facts(), "step.sync")) == 2


def test_the_readers_read_the_window(ring):
    f = facts()

    def read(name):
        return cells.reader(name).read(f)

    assert read("step.forward_ms.train") == pytest.approx(20.0)
    assert read("step.backward_ms.train") == pytest.approx(10.0)
    assert read("step.optimizer_ms.train") == pytest.approx(5.0)
    assert read("step.sync_ms.train") == pytest.approx(15.0)
    # the window's reads are the third and fourth: 12 and 13 ms
    assert read("load.read_ms.train") == pytest.approx(12.5)
    assert read("build.tables_ms.train") == pytest.approx(20.0)
    assert read("place.pack_ms.train") == pytest.approx(10.0)
    # 20 + 10 ms of edge sets in 20 ms of tables
    assert read("build.tables_width.train") == pytest.approx(1.5)
    # forward 5 of 20 ms off the CPU, optimizer 5 of 5: 10 of 25
    assert read("step.offcpu_pct.train") == pytest.approx(40.0)
    # a wait from t+10 to t+50: the batch covers to t+30, the pack t+30
    # to t+40, so 30 of 40 ms
    assert read("wait.explained_pct.train") == pytest.approx(75.0)
    # no span of the kind in the window
    assert read("load.transform_ms.train") is None
    assert read("build.order_ms.train") is None
    assert read("build.levels_ms.train") is None


def test_a_span_on_the_waiting_thread_explains_nothing(monkeypatch):
    held = records() + [rec("place.pack", CALLER, 110, 150),
                        rec("place.pack", CALLER, 210, 250)]
    monkeypatch.setattr(profiling, "span_records", lambda: list(held))
    assert cells.reader("wait.explained_pct.train").read(facts()) \
        == pytest.approx(75.0)


@pytest.mark.parametrize("case", ["no steps", "no trace", "lost window",
                                  "no program spans", "empty ring"])
def test_nothing_to_read_gives_none(monkeypatch, case):
    held = records()
    f = facts()
    if case == "no steps":
        del f["steps"]
    elif case == "no trace":
        del f["trace"]
    elif case == "lost window":
        f = facts(steps=3, items=1)      # 4 syncs hold no 3 + 1 + 1
    elif case == "empty ring":
        held = []
    if case == "no program spans":
        monkeypatch.delattr(profiling, "span_records")
    else:
        monkeypatch.setattr(profiling, "span_records", lambda: list(held))
    assert spans.window(f) is None
    for name in SPAN_METRICS:
        assert cells.reader(name).read(f) is None, name


def test_k2_backward_reads_the_traced_range():
    reader = cells.reader("k2_backward_ms.train")
    assert reader.read(facts(items=8, ranges={"op.k2.backward": 0.04})) \
        == pytest.approx(5.0)
    assert reader.read(facts(items=8, ranges={"op.k2": 0.04})) is None
    assert reader.read({"trace": facts()["trace"]}) is None
    assert reader.read({}) is None


def test_every_span_metric_has_a_reader_and_a_span():
    """The 13 span readers are the `program_span` metrics; each names the
    program's spans it reads (no name under the benchmark's `bench.` and
    none under `op.`, which the traced epoch takes for op entries)."""
    assert len(SPAN_METRICS) == 13
    names = {"load.read", "load.transform", "build.order", "build.tables",
             "build.edge_set", "build.levels", "place.pack", "loop.wait",
             "load.batch", "step.forward", "step.backward",
             "step.optimizer", "step.sync"}
    for metric in SPAN_METRICS:
        text = (cells.BENCH_DIR / "metrics" / f"{metric}.py").read_text()
        assert any(f'"{n}"' in text for n in names), metric
    assert not any(n.startswith(("bench.", "op.")) for n in names)

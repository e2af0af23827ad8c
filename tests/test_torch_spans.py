"""The port's span tracer (isogs_slam_tpu_torch/utils/spans.py): nesting,
per-thread stacks, self time, the off mode and the export's clock."""
import threading
import time

import pytest

from isogs_slam_tpu_torch.utils import spans


def _by_name(table):
    return {n: i for i, n in enumerate(table["name"])}


def test_nesting_and_parents():
    tr = spans.Tracer()
    with spans.use(tr):
        tr.frame = 3
        with spans.span("a"):
            with spans.span("b"):
                with spans.span("c"):
                    pass
            with spans.span("d"):
                pass
        with spans.span("e"):
            pass
    t = tr.table()
    assert t["name"] == ["a", "b", "c", "d", "e"]
    assert t["parent"] == [-1, 0, 1, 0, -1]
    assert t["frame"] == [3] * 5
    for i, p in enumerate(t["parent"]):
        assert t["start_ns"][i] <= t["end_ns"][i]
        if p >= 0:
            assert t["start_ns"][p] <= t["start_ns"][i]
            assert t["end_ns"][i] <= t["end_ns"][p]
    assert tr.totals()["a"][1] == 1 and spans.current() is None


def test_second_thread_takes_the_owners_innermost_span():
    """A thread with no open span of its own (autograd's device thread)
    opens its spans under the owner thread's innermost open span; its own
    nested spans stack on its own stack."""
    tr = spans.Tracer()

    def backward():
        with spans.span("render.composite_bwd"):
            with spans.span("inner"):
                pass

    with spans.use(tr), spans.span("mapping.backward"):
        th = threading.Thread(target=backward)
        th.start()
        th.join()
    t = tr.table()
    i = _by_name(t)
    assert t["parent"][i["render.composite_bwd"]] == i["mapping.backward"]
    assert t["parent"][i["inner"]] == i["render.composite_bwd"]
    assert t["tid"][i["render.composite_bwd"]] != t["owner"]
    assert t["tid"][i["mapping.backward"]] == t["owner"]


def test_self_time_is_duration_less_covered_children():
    tr = spans.Tracer()
    with spans.use(tr):
        for _ in range(2):
            with spans.span("frame"):
                with spans.span("tracking"):
                    time.sleep(0.002)
                with spans.span("sync.loss_log"):   # not a stage: glue
                    time.sleep(0.001)
                with spans.span("mapping"):
                    with spans.span("checkpoint"):  # not the frame's child
                        time.sleep(0.001)
                time.sleep(0.001)
    tot = tr.totals()
    want = tot["frame"][0] - tot["tracking"][0] - tot["mapping"][0]
    assert tr.self_seconds("frame") == pytest.approx(want, rel=1e-9)
    assert tr.self_seconds("frame") >= 0.004
    s = tr.summary()
    assert s["frames"] == 2 and s["syncs"] == 2 and not s["fine"]
    assert s["frame_self_s"] == pytest.approx(want, rel=1e-9)


def test_off_mode_records_nothing():
    tr = spans.Tracer()
    assert spans.current() is None
    assert spans.span("x") is spans.NOOP and spans.fine("y") is spans.NOOP
    with spans.use(tr):
        assert tr.fine is False
        assert spans.fine("y") is spans.NOOP    # fine spans off
        with spans.fine("y"):
            pass
        tr.fine = True
        with spans.fine("z"):
            pass

    @spans.fine_call("w")
    def f(a, b=1):
        return a + b

    assert f(2, b=3) == 5                       # no tracer: not recorded
    with spans.use(tr):
        assert f(1) == 2
    assert tr.table()["name"] == ["z", "w"]


def test_start_run_reads_the_profiler_once():
    from torch.profiler import ProfilerActivity, profile
    tr = spans.Tracer()
    tr.start_run()
    assert not tr.fine and tr.profiler is None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.start_run()
        own = spans.Tracer()
        own.start_run(own_profiler=True)
    assert tr.fine and not tr.annotate
    assert tr.profiler is prof.profiler           # kept for the join
    assert own.fine and own.annotate and own.profiler is None


def test_epoch_export_is_within_a_millisecond_of_time_ns():
    tr = spans.Tracer()
    with spans.use(tr):
        before = time.time_ns()
        with spans.span("x"):
            pass
        after = time.time_ns()
    t = tr.table()
    assert before - 1_000_000 <= t["start_ns"][0] <= after + 1_000_000
    assert before - 1_000_000 <= t["end_ns"][0] <= after + 1_000_000

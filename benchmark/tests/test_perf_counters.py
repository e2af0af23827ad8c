"""The readers of the port's counters and of the outlier mask's span: a
number from runs that carry counters, None from runs that do not (a
program without counters) and on an empty context."""
import collections
from types import SimpleNamespace

import pytest

from benchmark import plugins

READERS = ["tracking.iters_per_frame", "tracking.ms_per_iter",
           "tracking.device_ms_per_iter",
           "loss.outlier_mask.device_ms_per_frame"]


def _summary(frames, iters=None, tracking_s=1.0, tracer=None, fine=False):
    out = {"frames": frames, "fine": fine, "tracer": tracer,
           "totals": {"tracking": [tracking_s, frames]},
           "frame_self_s": 0.0, "syncs": 0}
    if iters is not None:
        out["counters"] = {"tracking.iters": iters}
    return out


@pytest.mark.parametrize("name", READERS)
def test_none_on_an_empty_context(name):
    ctx = {"frames": 0, "window_s": 0.0, "trace": None, "trace_frames": 0,
           "tracking_s": 0.0, "mapping_s": 0.0}
    assert plugins.load("metrics", name).read(ctx) is None


def _read(name, ctx):
    return plugins.load("metrics", name).read(ctx)


def test_window_readers(monkeypatch):
    from isogs_slam_tpu_torch.utils import spans
    ctx = {"frames": 10, "window_s": 1.0, "trace": None, "trace_frames": 0}
    monkeypatch.setattr(spans, "FINISHED", collections.deque([
        _summary(2, 200),                                  # warm-up
        _summary(5, 800, tracking_s=4.0),
        _summary(5, 1000, tracking_s=6.0)]))
    assert _read("tracking.iters_per_frame", ctx) == pytest.approx(180.0)
    assert _read("tracking.ms_per_iter", ctx) == pytest.approx(
        1000.0 * 10.0 / 1800)
    monkeypatch.setattr(spans, "FINISHED", collections.deque([
        _summary(5), _summary(5)]))                        # no counters
    assert _read("tracking.iters_per_frame", ctx) is None
    assert _read("tracking.ms_per_iter", ctx) is None


def test_traced_readers(monkeypatch):
    """Device time under the spans of the traced job, per its counted
    iterations or per frame; None where the traced run has no counters
    or no such span."""
    from benchmark import spans as BS
    from isogs_slam_tpu_torch.utils import spans
    tr = SimpleNamespace(profiler=object(), table=lambda: {})
    att = {"device_s": 1.0, "inclusive_s": {"tracking": 0.8,
                                            "loss.outlier_mask": 0.05}}
    monkeypatch.setattr(BS, "_JOINED", {id(tr): att})
    ctx = {"frames": 10, "window_s": 1.0, "trace": {"kernel_s": {}},
           "trace_frames": 5}
    monkeypatch.setattr(spans, "FINISHED", collections.deque([
        _summary(5, 800, tracer=tr, fine=True)]))
    assert _read("tracking.device_ms_per_iter", ctx) == pytest.approx(1.0)
    assert _read("loss.outlier_mask.device_ms_per_frame", ctx) == \
        pytest.approx(10.0)
    monkeypatch.setattr(spans, "FINISHED", collections.deque([
        _summary(5, tracer=tr, fine=True)]))
    assert _read("tracking.device_ms_per_iter", ctx) is None
    del att["inclusive_s"]["loss.outlier_mask"]
    assert _read("loss.outlier_mask.device_ms_per_frame", ctx) is None

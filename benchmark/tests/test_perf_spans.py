"""The join of a profile with the port's spans (benchmark/spans.py) on
hand-made events, and the seven span readers."""
import collections
from types import SimpleNamespace

import pytest

from benchmark import plugins
from benchmark import spans as S
from benchmark.trace import summarize

READERS = ["pipeline.densify_s_per_frame", "pipeline.checkpoint_s_per_frame",
           "pipeline.self_s_per_frame", "pipeline.host_syncs_per_frame",
           "mapping.forward.device_ms_per_frame",
           "mapping.backward.device_ms_per_frame",
           "mapping.adam.device_ms_per_frame"]
OWNER, AUTOGRAD = 100, 200


class Ev:
    """The kineto event methods the benchmark reads."""

    def __init__(self, name, device, start, dur, corr=0, linked=0, tid=0):
        self._v = (name, device, start, dur, corr, linked, tid)

    def name(self):
        return self._v[0]

    def device_type(self):
        return "DeviceType.CUDA" if self._v[1] else "DeviceType.CPU"

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]

    def start_thread_id(self):
        return self._v[6]


def _prof(events):
    res = SimpleNamespace(events=lambda: list(events))
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=res))


# name, parent, start, end, tid
SPANS = [("slam.run", -1, 0, 1000, OWNER), ("frame", 0, 10, 990, OWNER),
         ("mapping", 1, 20, 900, OWNER),
         ("mapping.forward", 2, 30, 300, OWNER),
         ("render.composite", 3, 100, 200, OWNER),
         ("mapping.backward", 2, 300, 700, OWNER),
         ("mapping.adam", 2, 700, 800, OWNER),
         ("render.composite_bwd", 5, 400, 500, AUTOGRAD)]
TABLE = {"name": [s[0] for s in SPANS], "parent": [s[1] for s in SPANS],
         "start_ns": [s[2] for s in SPANS], "end_ns": [s[3] for s in SPANS],
         "frame": [0] * len(SPANS), "tid": [s[4] for s in SPANS],
         "owner": OWNER}
# launching runtime calls (host) and the device events they launched
EVENTS = [
    Ev("cudaLaunchKernel", False, 150, 5, corr=1, tid=OWNER),
    Ev("composite_fwd_kernel", True, 160, 50, corr=1),
    Ev("cudaLaunchKernel", False, 440, 5, corr=7, tid=AUTOGRAD),
    Ev("composite_bwd_kernel", True, 440, 20, corr=7),
    # a thread id the spans do not know (the profiler's own): the span
    # opened last among those open then, on any thread
    Ev("cudaLaunchKernel", False, 450, 5, corr=2, tid=1),
    Ev("composite_bwd_kernel", True, 460, 30, corr=2),
    # the autograd thread with no span of its own open: the owner's
    Ev("cudaLaunchKernel", False, 600, 5, corr=3, tid=AUTOGRAD),
    Ev("elementwise_kernel", True, 610, 20, corr=3),
    Ev("cudaLaunchKernel", False, 750, 5, corr=4, tid=OWNER),
    Ev("elementwise_kernel", True, 760, 10, corr=4),
    Ev("cudaMemcpyAsync", False, 950, 5, corr=5, tid=OWNER),
    Ev("Memcpy DtoH", True, 960, 5, corr=5),
    # joined through the linked id
    Ev("cudaLaunchKernel", False, 50, 5, corr=6, tid=OWNER),
    Ev("gather_kernel", True, 60, 7, linked=6),
]


def test_attribute_puts_device_time_under_the_launching_span():
    att = S.attribute(_prof(EVENTS), TABLE)
    ns = 1e-9
    assert att["launch_found"] == 1.0
    assert att["device_s"] == pytest.approx(142 * ns)
    assert att["self_s"]["render.composite"] == pytest.approx(50 * ns)
    assert att["self_s"]["render.composite_bwd"] == pytest.approx(50 * ns)
    assert att["self_s"]["mapping.backward"] == pytest.approx(20 * ns)
    assert att["self_s"]["mapping.adam"] == pytest.approx(10 * ns)
    assert att["self_s"]["mapping.forward"] == pytest.approx(7 * ns)
    want = {"mapping.forward": 57, "mapping.backward": 70,
            "mapping.adam": 10, "mapping": 137, "frame": 142,
            "slam.run": 142, "render.composite_bwd": 50}
    for k, v in want.items():
        assert att["inclusive_s"][k] == pytest.approx(v * ns), k
    assert att["unnamed_s"] == pytest.approx(5 * ns)
    assert att["self_by_path"][
        "slam.run/frame/mapping/mapping.backward/render.composite_bwd"
    ] == pytest.approx(50 * ns)
    # the idle gaps, each under the innermost span open across it
    idle = {"mapping.forward": 93, "mapping": 360, "mapping.backward": 120,
            "frame": 190}
    assert att["idle_s"].keys() == idle.keys()
    for k, v in idle.items():
        assert att["idle_s"][k] == pytest.approx(v * ns), k
    m = "slam.run/frame/mapping"
    assert att["longest_gaps"][0] == [
        pytest.approx(230 * ns), m, m + "/mapping.forward",
        m + "/mapping.backward"]
    assert att["kernels_by_span"]["render.composite_bwd"] == [
        ("composite_bwd_kernel", pytest.approx(50 * ns))]
    assert att["launch_threads"] == {1: [1, False], OWNER: [4, True],
                                     AUTOGRAD: [2, True]}


def test_attribute_leaves_summarize_unchanged():
    before = summarize(_prof(EVENTS), 1e-6)
    S.attribute(_prof(EVENTS), TABLE)
    after = summarize(_prof(EVENTS), 1e-6)
    assert before == after
    assert before["kernels"] == 6 and before["busy_s"] == pytest.approx(
        142e-9)


@pytest.mark.parametrize("name", READERS)
def test_readers_return_none_on_an_empty_context(name):
    ctx = {"frames": 0, "window_s": 0.0, "trace": None, "trace_frames": 0,
           "tracking_s": 0.0, "mapping_s": 0.0}
    assert plugins.load("metrics", name).read(ctx) is None


def _summary(frames, fine=False, tracer=None, **totals):
    return {"frames": frames, "fine": fine, "tracer": tracer,
            "totals": {k: [v, 1] for k, v in totals.items()},
            "frame_self_s": 0.01 * frames, "syncs": 10 * frames}


def test_window_readers_take_the_windows_jobs(monkeypatch):
    """The window's jobs are the newest runs without fine spans whose frames
    add up to the window's: not the warm-up before them, not the traced
    job after them."""
    from isogs_slam_tpu_torch.utils import spans
    runs = collections.deque([
        _summary(2, densify=9.0),                 # warm-up
        _summary(4, densify=1.0, checkpoint=0.5),
        _summary(4, densify=3.0),
        _summary(4, fine=True, densify=7.0)])     # traced job
    monkeypatch.setattr(spans, "FINISHED", runs)
    ctx = {"frames": 8, "window_s": 1.0, "trace": None, "trace_frames": 4}

    def read(name):
        return plugins.load("metrics", name).read(ctx)
    assert read("pipeline.densify_s_per_frame") == pytest.approx(0.5)
    assert read("pipeline.checkpoint_s_per_frame") == pytest.approx(0.0625)
    assert read("pipeline.self_s_per_frame") == pytest.approx(0.01)
    assert read("pipeline.host_syncs_per_frame") == pytest.approx(10.0)
    assert read("mapping.adam.device_ms_per_frame") is None   # not traced
    ctx["frames"] = 7                      # jobs that do not add up
    assert read("pipeline.densify_s_per_frame") is None

"""One span tracer for a SLAM run: named, nested intervals of host time.

A `Tracer` keeps its spans in memory. Each span holds its name, its parent,
its start and end on `time.perf_counter_ns()` (monotonic), the frame being
processed and the native id of the thread that opened it. `table()`
exports them on the Unix epoch in nanoseconds, the clock torch.profiler
stamps its events with, through one (perf_counter_ns, time_ns) anchor
taken when the tracer is made; so a span can be joined with the runtime
calls and kernels of a profile of the same run.

Each thread has its own stack of open spans. A span opened on a thread
with no open span takes as parent the innermost open span of the thread
that made the tracer (the owner): this covers spans opened inside an
`autograd.Function.backward` on autograd's device thread.

Code under slam/, ops/ and core/ opens spans through the module functions,
on the tracer `use()` made current (SLAM.run does, for its run); with no
current tracer they return one shared no-op context manager. Two tiers:

- `span(name)`: stage spans and sync spans ("sync.<site>", one around each
  place the host blocks on the card: a device-to-host read, an implicit
  one such as int(tensor) or boolean masking, a blocking copy from host
  memory, a synchronize). Always recorded under a current tracer: a pair
  of clock reads and a list append each.
- `fine(name)`: per-iteration and per-module spans, recorded only when the
  run started under an active torch profiler (`start_run`); otherwise one
  attribute check.

Beside the spans, `count(name, n)` adds n to a named counter of the
current tracer (a dict add, always recorded under a current tracer) from
a number the host already holds: a counter never reads the card.

No span synchronizes, copies or launches anything. Under the run's own
profiler (config["profile_trace_dir"]) spans also open
`torch.profiler.record_function` ranges, so its Chrome trace names the
modules. Under a profiler that some caller runs around the run they do
not (its device-side annotations would join the device events that the
caller counts); the tracer keeps a handle on that profiler instead
(`Tracer.profiler`), so the caller can join the profile's device events to
the spans once the profiler has stopped.

`FINISHED` holds the summaries of the runs this process finished, newest
last, for a caller that keeps only what a run returned.
"""
from __future__ import annotations

import collections
import functools
import threading
import time

# the stage spans a "frame" span is made of: what is left of a frame
# outside them is the loop's own glue (Tracer.self_seconds)
FRAME_STAGES = ("upload", "init", "tracking", "densify", "mapping",
                "compact", "keyframe", "progress", "checkpoint")
SYNC_PREFIX = "sync."

# record fields
_NAME, _PARENT, _T0, _T1, _FRAME, _TID = range(6)

_local = threading.local()


def _thread_id() -> int:
    """The calling thread's native id, read once a thread (a system call
    each time otherwise)."""
    tid = getattr(_local, "tid", None)
    if tid is None:
        tid = _local.tid = threading.get_native_id()
    return tid


class _NoSpan:
    """The shared context manager of a span that is not recorded."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _NoSpan()


class _Span:
    __slots__ = ("_tr", "_rec", "_rf")

    def __init__(self, tr: "Tracer", name: str):
        self._tr = tr
        self._rec = [name, None, 0, 0, tr.frame, 0]
        self._rf = None

    def __enter__(self):
        tr, rec = self._tr, self._rec
        tid = _thread_id()
        stack = tr._stacks.get(tid)
        if stack is None:
            stack = tr._stacks[tid] = []
        if stack:
            rec[_PARENT] = stack[-1]
        else:
            owner = tr._stacks.get(tr.owner)
            rec[_PARENT] = owner[-1] if owner else None
        rec[_TID] = tid
        stack.append(rec)
        tr.records.append(rec)
        if tr.annotate:
            import torch
            self._rf = torch.profiler.record_function(rec[_NAME])
            self._rf.__enter__()
        rec[_T0] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        rec = self._rec
        rec[_T1] = time.perf_counter_ns()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        self._tr._stacks[rec[_TID]].pop()
        return False

    @property
    def seconds(self) -> float:
        """Duration of the closed span."""
        return (self._rec[_T1] - self._rec[_T0]) * 1e-9


class Tracer:
    """The spans of one run (see the module's docstring)."""

    def __init__(self):
        self.records: list = []          # [name, parent record, t0, t1,
        self._stacks: dict = {}          #  frame, tid], in start order
        self.owner = _thread_id()
        self.frame = -1                  # stamped on the spans opened
        self.fine = False
        self.annotate = False
        self.profiler = None
        self.counters: dict = {}         # name -> total of count() calls
        self._anchor = (time.perf_counter_ns(), time.time_ns())

    def span(self, name: str) -> _Span:
        return _Span(self, name)

    def start_run(self, own_profiler: bool = False):
        """Read once, as a run starts, whether a torch profiler is
        recording: fine spans are recorded only then. `own_profiler`: the
        run started that profiler itself (and wants named ranges in its
        trace); else the recording profiler is kept in `self.profiler`."""
        import torch
        self.fine = bool(torch._C._autograd._profiler_enabled())
        self.annotate = self.fine and own_profiler
        self.profiler = (_recording_profiler()
                         if self.fine and not own_profiler else None)

    def open_span(self) -> str | None:
        """Name of the innermost span open on the calling thread (on the
        owner's when the calling thread has none open), None if none."""
        stack = (self._stacks.get(_thread_id())
                 or self._stacks.get(self.owner))
        return stack[-1][_NAME] if stack else None

    def _closed(self):
        return [r for r in self.records if r[_T1]]

    def table(self) -> dict:
        """The closed spans in start order: name, parent (an index into
        this table, -1 for a root or a parent still open), start_ns and
        end_ns on the Unix epoch, frame and tid, one list each; and the
        owner thread's id."""
        recs = self._closed()
        index = {id(r): i for i, r in enumerate(recs)}
        off = self._anchor[1] - self._anchor[0]
        return {"name": [r[_NAME] for r in recs],
                "parent": [index.get(id(r[_PARENT]), -1) for r in recs],
                "start_ns": [r[_T0] + off for r in recs],
                "end_ns": [r[_T1] + off for r in recs],
                "frame": [r[_FRAME] for r in recs],
                "tid": [r[_TID] for r in recs],
                "owner": self.owner}

    def totals(self) -> dict:
        """{name: [seconds, count]} over the closed spans."""
        out: dict = {}
        for r in self._closed():
            t = out.setdefault(r[_NAME], [0.0, 0])
            t[0] += (r[_T1] - r[_T0]) * 1e-9
            t[1] += 1
        return out

    def self_seconds(self, name: str, children=FRAME_STAGES) -> float:
        """Seconds of the closed spans `name` less those of their direct
        children whose names are in `children`."""
        total = 0
        for r in self._closed():
            if r[_NAME] == name:
                total += r[_T1] - r[_T0]
            elif r[_NAME] in children and r[_PARENT] is not None \
                    and r[_PARENT][_NAME] == name:
                total -= r[_T1] - r[_T0]
        return total * 1e-9

    def summary(self) -> dict:
        """What FINISHED keeps of a run: frames (its "frame" spans), span
        totals, the counters, the frames' self seconds, the sync spans'
        count, whether fine spans were on, and the tracer itself when an
        outside profiler recorded the run (for the join with that
        profile)."""
        totals = self.totals()
        return {"frames": totals.get("frame", [0.0, 0])[1],
                "totals": totals, "counters": dict(self.counters),
                "frame_self_s": self.self_seconds("frame"),
                "syncs": sum(n for k, (_, n) in totals.items()
                             if k.startswith(SYNC_PREFIX)),
                "fine": self.fine,
                "tracer": self if self.profiler is not None else None}


def _recording_profiler():
    """The torch.autograd.profiler.profile that is recording now (entered
    and not yet stopped), found among the live objects; None if there is
    none."""
    import gc

    from torch.autograd import profiler as tap
    for o in gc.get_objects():
        if (isinstance(o, tap.profile) and getattr(o, "entered", False)
                and getattr(o, "kineto_results", 0) is None):
            return o
    return None


_current: Tracer | None = None
FINISHED: collections.deque = collections.deque(maxlen=64)


class use:
    """Make `tracer` the current one inside the block (the previous one
    after it)."""

    def __init__(self, tracer: Tracer | None):
        self._tracer = tracer
        self._prev = None

    def __enter__(self):
        global _current
        self._prev, _current = _current, self._tracer
        return self._tracer

    def __exit__(self, *exc):
        global _current
        _current = self._prev
        return False


def current() -> Tracer | None:
    return _current


def span(name: str):
    """A stage or sync span on the current tracer."""
    tr = _current
    return NOOP if tr is None else _Span(tr, name)


def fine(name: str):
    """A per-iteration or per-module span: recorded only when the current
    tracer's run started under a profiler."""
    tr = _current
    return _Span(tr, name) if tr is not None and tr.fine else NOOP


def count(name: str, n: int = 1):
    """Add n to the current tracer's counter `name` (nothing without a
    current tracer). `n` is a host number: no read of the card."""
    tr = _current
    if tr is not None:
        tr.counters[name] = tr.counters.get(name, 0) + n


def fine_call(name: str):
    """Decorator: every call of the function in a `fine(name)` span."""
    def wrap(f):
        @functools.wraps(f)
        def traced(*args, **kwargs):
            with fine(name):
                return f(*args, **kwargs)
        return traced
    return wrap

"""The program's span-and-counter recorder: where a job's time goes, on
every thread, and what it counted.

- ``span(name)`` times one stretch of a thread's work: wall
  (``perf_counter``) and the thread's CPU time (``thread_time``).  Its
  parent is the span open below it on the same thread; a pool worker
  takes its pool's span as parent through ``within(parent)``, since
  ``ThreadPoolExecutor`` does not carry context over.  Closed spans add
  into an aggregate by name: calls, wall seconds, self seconds (wall
  minus what child spans on the same thread cover) and CPU seconds.
- ``count(name, n)`` adds to a counter.
- ``job()`` resets the recorder and opens the root span ``job``:
  ``pipeline.run_phase`` runs one job at a time in a process, and
  ``snapshot()`` writes the job's id, aggregate and counters into
  ``-metrics.json`` (``job``, ``spans``, ``counters``).

``timed(key)`` and ``add(key, n)`` are a span and a counter whose names
also make up ``stage_seconds["substages"]`` (``substages()``): seconds
summed over the threads (waits for the interpreter lock included) and
counts.

When ``torch.profiler`` is recording as the job opens, every span of the
job's thread below the root also opens a profiler range
``ahsoka.<name>``, and every span of every thread is kept as an event
(``span_events``: name, id, parent, native thread id, start and end in
seconds from the job's start).  The profiler sees the job's thread
alone; ``place()`` puts the events on the trace's clock by their ranges,
and ``export_worker_events()`` writes the other threads' spans into the
trace.  With no profiler, no event is kept and no range is opened.
"""

from __future__ import annotations

import itertools
import json
import statistics
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional

RANGE_PREFIX = "ahsoka."

_LOCK = threading.Lock()
_LOCAL = threading.local()
_IDS = itertools.count(1)
_JOB_IDS = itertools.count(1)


class Span:
    """One span: open until its ``with`` block ends, then ``wall`` and
    ``cpu`` hold its seconds."""

    __slots__ = ("name", "id", "job", "parent", "thread", "t0", "c0",
                 "covered", "wall", "cpu")

    def __init__(self, name: str, job: Optional[int],
                 parent: Optional["Span"]):
        self.name = name
        self.id = next(_IDS)
        self.job = job
        self.parent = parent
        self.thread = threading.get_ident()
        self.covered = 0            # ns of closed children on this thread
        self.wall = self.cpu = 0.0


class _Job:
    def __init__(self, job_id: Optional[int], trace: bool,
                 main: Optional[int]):
        self.id = job_id
        self.trace = trace
        self.main = main
        self.root: Optional[Span] = None
        self.agg: Dict[str, List[float]] = {}  # calls, wall, self, cpu
        self.counters: Dict[str, float] = {}
        self.sub: set = set()
        self.events: List[tuple] = []


_JOB = _Job(None, False, None)


def _stack() -> list:
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


def _profiler_enabled() -> bool:
    """Whether ``torch.profiler`` is recording in this process."""
    try:
        import torch
        return bool(torch._C._autograd._profiler_enabled())
    except (ImportError, AttributeError):
        return False


def _add(agg: dict, name: str, wall: int, self_ns: int, cpu: int) -> None:
    """Add one span's nanoseconds into an aggregate."""
    a = agg.get(name)
    if a is None:
        a = agg[name] = [0, 0.0, 0.0, 0.0]
    a[0] += 1
    a[1] += wall * 1e-9
    a[2] += self_ns * 1e-9
    a[3] += cpu * 1e-9


def _event(sp: Span, t1: int) -> tuple:
    return (sp.name, sp.id, sp.parent.id if sp.parent else None,
            threading.get_native_id(), sp.t0, t1)


@contextmanager
def span(name: str, nest: bool = True):
    """Time the block as span ``name``; yields the ``Span``.  With
    ``nest=False`` the block is timed into the aggregate alone: it parents
    nothing, covers nothing, opens no range and keeps no event (an
    interval made of several stages)."""
    job = _JOB
    stack = _stack()
    sp = Span(name, job.id, stack[-1] if stack else None)
    rng = None
    if nest:
        if job.trace and sp.parent is not None and sp.thread == job.main:
            from torch.autograd.profiler import record_function
            rng = record_function(RANGE_PREFIX + name)
        stack.append(sp)
    # a range reads the clock as it is entered and left, before its own
    # set-up and tear-down: the span's readings are taken just before
    # both; the CPU reading lies inside the wall one, so CPU <= wall
    sp.t0 = time.perf_counter_ns()
    sp.c0 = time.thread_time_ns()
    if rng is not None:
        rng.__enter__()
    try:
        yield sp
    finally:
        c1 = time.thread_time_ns()
        t1 = time.perf_counter_ns()
        if rng is not None:
            rng.__exit__(None, None, None)
        wall = t1 - sp.t0
        sp.wall, sp.cpu = wall * 1e-9, (c1 - sp.c0) * 1e-9
        if nest:
            stack.pop()
            if sp.parent is not None and sp.parent.thread == sp.thread:
                sp.parent.covered += wall
        with _LOCK:
            _add(job.agg, name, wall, wall - sp.covered, c1 - sp.c0)
            if nest and job.trace:
                job.events.append(_event(sp, t1))


@contextmanager
def within(parent: Span):
    """Run the block, on a pool worker, under ``parent`` (a span of the
    thread that submitted it): the block's spans take it as parent."""
    stack = _stack()
    stack.append(parent)
    try:
        yield
    finally:
        stack.pop()


def count(name: str, n: float = 1) -> None:
    job = _JOB
    with _LOCK:
        job.counters[name] = job.counters.get(name, 0) + n


def timed(key: str):
    """A span whose wall also goes into ``substages()``."""
    _JOB.sub.add(key)
    return span(key)


def add(key: str, n: float) -> None:
    """A counter that also goes into ``substages()``."""
    _JOB.sub.add(key)
    count(key, n)


@contextmanager
def job():
    """Reset the recorder and run the block as one job under the root
    span ``job``, which opens no range.  Ranges and events are on when
    ``torch.profiler`` is recording now."""
    global _JOB
    trace = _profiler_enabled()
    with _LOCK:
        _JOB = _Job(next(_JOB_IDS), trace, threading.get_ident())
    # the root is the job's first span on this thread
    saved = _LOCAL.__dict__.pop("stack", None)
    try:
        with span("job") as root:
            _JOB.root = root
            yield root
    finally:
        if saved is not None:
            _LOCAL.stack = saved


def substages() -> Dict[str, float]:
    """The seconds of ``timed`` spans and the counts of ``add`` counters
    so far, by key (``stage_seconds["substages"]``)."""
    job = _JOB
    with _LOCK:
        out = {k: round(job.agg[k][1], 4) for k in job.sub if k in job.agg}
        out.update((k, float(job.counters[k])) for k in job.sub
                   if k in job.counters)
    return out


def snapshot() -> dict:
    """The job so far, for ``-metrics.json``: ``spans`` (by name:
    ``calls``, ``wall_s``, ``self_s``, ``cpu_s``), ``counters``, and,
    when the profiler records, ``span_events``.  Spans still open on this
    thread (the root among them) count up to now."""
    job = _JOB
    c1 = time.thread_time_ns()
    t1 = time.perf_counter_ns()
    me = threading.get_ident()
    with _LOCK:
        agg = {k: list(v) for k, v in job.agg.items()}
        counters = dict(job.counters)
        events = list(job.events)
    inner = 0                        # ns of the open child on this thread
    for sp in reversed(_stack()):
        if sp.thread != me:
            break
        wall = t1 - sp.t0
        _add(agg, sp.name, wall, wall - sp.covered - inner, c1 - sp.c0)
        inner = wall
        if job.trace:
            events.append(_event(sp, t1))
    out = {"spans": {k: {"calls": int(v[0]), "wall_s": v[1], "self_s": v[2],
                         "cpu_s": v[3]}
                     for k, v in sorted(agg.items())},
           "counters": dict(sorted(counters.items())), "job": job.id}
    if job.trace:
        t0 = job.root.t0 if job.root is not None else 0
        events.sort(key=lambda e: (e[4], -e[5]))
        out["span_events"] = [
            {"name": n, "id": i, "parent": p, "thread": th,
             "t0": (a - t0) * 1e-9, "t1": (b - t0) * 1e-9}
            for n, i, p, th, a, b in events]
    return out


def place(span_events: List[dict], trace_events: List[dict]
          ) -> Optional[float]:
    """The offset, in microseconds, that puts one job's span events on a
    Chrome trace's clock (``ts`` = ``t0`` * 1e6 + offset).  The job's
    first event whose range ``ahsoka.<name>`` the trace holds is the
    anchor, against the trace's first range of that name; the offset is
    then the median, over the job's events on its own thread, of each
    one's distance to the nearest range of its name (within 50 ms), so
    that a stall between a span's clock reading and its range's does not
    move the rest.  None when the trace holds none of the job's ranges."""
    if not span_events:
        return None
    main = span_events[0]["thread"]
    starts: Dict[str, List[float]] = {}
    for ev in trace_events:
        name = ev.get("name", "")
        if ev.get("ph") == "X" and name.startswith(RANGE_PREFIX):
            starts.setdefault(name, []).append(float(ev["ts"]))
    mine = [(RANGE_PREFIX + e["name"], e["t0"] * 1e6) for e in span_events
            if e["thread"] == main and e["parent"] is not None]
    coarse = next((min(starts[n]) - t for n, t in mine if n in starts),
                  None)
    if coarse is None:
        return None
    diffs = []
    for name, t in mine:
        near = [s - t for s in starts.get(name, ())
                if abs(s - t - coarse) < 5e4]
        if near:
            diffs.append(min(near, key=lambda d: abs(d - coarse)))
    return statistics.median(diffs)


def export_worker_events(trace_path: str, span_events: List[dict]) -> int:
    """Append the spans of every thread but the job's to the Chrome trace
    at ``trace_path``, each thread on its own row, on the trace's clock.
    Returns the number of events written (0 when the trace holds no
    anchor)."""
    with open(trace_path) as fh:
        trace = json.load(fh)
    evs = trace.setdefault("traceEvents", [])
    offset = place(span_events, evs)
    if offset is None:
        return 0
    main = span_events[0]["thread"]
    pid = next((ev.get("pid") for ev in evs
                if ev.get("name", "").startswith(RANGE_PREFIX)), None)
    added, rows = [], {}
    for ev in span_events:
        if ev["thread"] == main:
            continue
        rows.setdefault(ev["thread"], len(rows))
        added.append({"ph": "X", "cat": "ahsoka_span", "pid": pid,
                      "tid": ev["thread"], "name": RANGE_PREFIX + ev["name"],
                      "ts": ev["t0"] * 1e6 + offset,
                      "dur": (ev["t1"] - ev["t0"]) * 1e6,
                      "args": {"id": ev["id"], "parent": ev["parent"]}})
    for tid, n in rows.items():
        added.append({"ph": "M", "name": "thread_name", "pid": pid,
                      "tid": tid, "args": {"name": f"ahsoka worker {n}"}})
    evs.extend(added)
    with open(trace_path, "w") as fh:
        json.dump(trace, fh)
    return len(added) - len(rows)

"""``device.idle_unspanned_share``: of the traced window's device-idle
seconds, the share, in %, in which the job's own thread was in none of
its stage spans (the children of the program's root span ``job``): the
root's self time and the harness's time between jobs.

Each job's ``span_events`` (``-metrics.json``: seconds from the job's
start, on the program's clock) are placed on the trace's clock by an
anchor: the job's first ``anchor`` span against the trace's range
``ahsoka.<anchor>`` of that job, the window's jobs and those ranges
matched in order, each job's offset then the median over its stages
(``place``).  Spans of the pool workers do not count: a gap under a
worker's span is spanned only where the job's thread is in a stage span
too."""

import statistics

from phasebench import stats

PREFIX = "ahsoka."


def stage_intervals(events, offset):
    """The job's main-thread stage spans on the trace's clock."""
    root = events[0]
    return [(e["t0"] + offset, e["t1"] + offset) for e in events
            if e["parent"] == root["id"] and e["thread"] == root["thread"]]


def place(jobs, host, anchor):
    """Offsets (seconds) that put each job's events on the trace's clock,
    or None where the jobs and the trace's anchor ranges do not pair.
    The anchor gives a first offset; the median, over the job's own
    thread's events, of each one's distance to the nearest range of its
    name (within 50 ms of the first offset) gives the offset, so a stall
    under one range does not move the job."""
    starts = {}
    for s, _e, name in host:
        if name.startswith(PREFIX):
            starts.setdefault(name[len(PREFIX):], []).append(s)
    ranges = sorted(starts.get(anchor, []))
    if len(ranges) != len(jobs):
        return None
    out = []
    for events, start in zip(jobs, ranges):
        root = events[0]
        mine = [(e["name"], e["t0"]) for e in events
                if e["thread"] == root["thread"] and e["parent"] is not None]
        first = next((t for name, t in mine if name == anchor), None)
        if first is None:
            return None
        coarse = start - first
        diffs = []
        for name, t in mine:
            near = [s - t for s in starts.get(name, ())
                    if abs(s - t - coarse) < 0.05]
            if near:
                diffs.append(min(near, key=lambda d: abs(d - coarse)))
        out.append(statistics.median(diffs))
    return out


def read(ctx, params):
    trace = ctx["trace"]
    events = [j.get("span_events") for j in ctx["jobs"]]
    if trace is None or not events or any(not e for e in events):
        return None
    offsets = place(events, trace.host, params["anchor"])
    if offsets is None:
        return None
    spanned = stats.union([iv for ev, off in zip(events, offsets)
                           for iv in stage_intervals(ev, off)])
    gaps = stats.gaps(trace.device, trace.lo, trace.hi)
    idle = sum(e - s for s, e in gaps)
    if idle <= 0:
        return None
    return 100.0 * (idle - overlap(gaps, spanned)) / idle


def overlap(a, b):
    """Seconds two sorted lists of disjoint intervals share."""
    i = j = 0
    out = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            out += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out

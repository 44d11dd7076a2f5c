"""``device.round_trips``: the program's ``device.round_trips`` counter
(``-metrics.json`` ``counters``: every device fetch or synchronisation
it waits on, counted at the fetch sites), averaged over the window's
jobs."""


def read(ctx, params):
    counters = [j.get("counters") for j in ctx["jobs"]]
    if not counters or any(c is None for c in counters):
        return None
    return sum(c.get(params["counter"], 0) for c in counters) \
        / len(counters)

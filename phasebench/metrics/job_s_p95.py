"""``job_s_p95``: the nearest-rank 95th percentile of the wall seconds
of the window's jobs, by the harness's clock around ``run_phase``.  With
some 30 jobs a window it is the second-largest or the largest: a reading
of stalls, too few samples for a bound."""

from phasebench.stats import nearest_rank


def read(ctx, params):
    seconds = ctx.get("job_seconds")
    return nearest_rank(seconds, 0.95) if seconds else None

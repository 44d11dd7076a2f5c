"""GAF records of the window's jobs over the seconds from the window's
start to the end of its last job: ``records_per_s``'s arithmetic, read
in the traced run of a cell that does not hold it end to end."""

from phasebench.stats import rate


def read(ctx, params):
    if not ctx["job_ends"]:
        return None
    return rate(ctx["records"], ctx["window_start"], ctx["job_ends"])

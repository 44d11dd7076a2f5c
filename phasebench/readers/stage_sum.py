"""Seconds a job of ``stage_seconds`` keys (the program's host-clock
spans around its stages), summed over ``keys`` and averaged over the
window's jobs."""


def read(ctx, params):
    jobs = ctx["jobs"]
    vals = [sum(j["stage_seconds"][k] for k in params["keys"])
            for j in jobs
            if all(k in j.get("stage_seconds", {}) for k in params["keys"])]
    if not vals or len(vals) != len(jobs):
        return None
    return sum(vals) / len(vals)

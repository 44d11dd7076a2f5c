"""Thread-seconds a job of the program's ``stage_seconds.substages``
(time summed over the host worker threads, waits for the interpreter
lock included), summed over the timed ``keys`` and averaged over the
window's jobs.  Keys that count calls or entries (``*_calls``,
``*.nnz``) and keys nested in another (``matrix.assemble.coo`` inside
``matrix.assemble``) are not listed in any metric's ``keys``."""


def read(ctx, params):
    jobs = ctx["jobs"]
    subs = [j.get("stage_seconds", {}).get("substages") for j in jobs]
    if not jobs or any(s is None for s in subs):
        return None
    vals = [sum(s.get(k, 0.0) for k in params["keys"]) for s in subs]
    if not any(vals):
        return None
    return sum(vals) / len(vals)

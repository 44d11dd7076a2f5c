"""Seconds a job of the program's own spans (``-metrics.json``
``spans``, written by ``ahsoka_tpu_torch/utils/substage.py``), the
``field`` (default ``wall_s``) of the spans named in ``keys`` summed and
averaged over the window's jobs.  None where a job carries no spans (a
program without the recorder)."""


def read(ctx, params):
    jobs = ctx["jobs"]
    spans = [j.get("spans") for j in jobs]
    if not jobs or any(s is None for s in spans):
        return None
    field = params.get("field", "wall_s")
    vals = [sum(s[k][field] for k in params["keys"] if k in s)
            for s in spans]
    return sum(vals) / len(vals)

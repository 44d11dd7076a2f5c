"""``cluster.wait_share``: 100 x (1 - CPU seconds / wall seconds) of the
program's ``clustering.solver`` spans over every thread and every job
of the window: the share of the solver's time its threads spent waiting
(the interpreter lock, locks, contended cores) rather than on a core."""


def read(ctx, params):
    spans = [j.get("spans") for j in ctx["jobs"]]
    if not spans or any(s is None for s in spans):
        return None
    wall = sum(s[params["span"]]["wall_s"] for s in spans
               if params["span"] in s)
    cpu = sum(s[params["span"]]["cpu_s"] for s in spans
              if params["span"] in s)
    if wall <= 0:
        return None
    return 100.0 * (1.0 - cpu / wall)

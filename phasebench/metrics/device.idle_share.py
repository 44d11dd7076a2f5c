"""``device.idle_share``: the share of the traced window, in %, that the
union of the card's kernel, copy and memset intervals leaves
uncovered."""


def read(ctx, params):
    trace = ctx["trace"]
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)

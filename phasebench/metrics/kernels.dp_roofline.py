"""``kernels.dp_roofline``: the least time an H100 could take for the
threading DP of the window's chains, each chain's forward and backtrace
counted at its own ploidy and positions (``phasebench.roofline``, C = 1
a chain: the work these inputs need, not a padded group's), over the
summed device time of the DP kernels in the window's trace.  A share,
in %."""

from phasebench.roofline import chain_dp_least_seconds


def read(ctx, params):
    trace = ctx["trace"]
    if trace is None:
        return None
    device_s = sum(trace.kernel_s.get(k, 0.0) for k in params["kernels"])
    if device_s <= 0:
        return None
    k = ctx["config"]["ploidy"]
    least = sum(chain_dp_least_seconds(k, c["positions"])
                for j in ctx["jobs"] for c in j["chains"]
                if not c["skipped"] and c["positions"] > 0)
    return 100.0 * least / device_s

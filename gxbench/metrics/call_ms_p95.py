"""The 95th percentile of the host-clock wall of one engine call, over
every call of the window (statistics.quantiles, exclusive method)."""

import statistics


def read(ctx):
    walls = [1e3 * c.wall_s for c in ctx["calls"]]
    if len(walls) < 20:
        return None
    return statistics.quantiles(walls, n=20)[18]

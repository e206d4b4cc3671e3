"""Percent of the traced window in which no kernel, copy or memset ran on
the card (torch.profiler)."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])

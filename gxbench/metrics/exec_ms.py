"""Mean milliseconds a call spends executing its buckets (RunStats.exec_s:
the host clock around the copies to the card, the launches, the one
synchronize and the copies back, engine/executor.py _run_buckets)."""

from gxbench.metrics import mean_ms


def read(ctx):
    return mean_ms(ctx, "exec_s")

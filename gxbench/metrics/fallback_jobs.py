"""Mean PairHMM jobs a call recomputes in fp64 on the host
(RunStats.fallback_jobs: results below the fallback threshold or not
finite)."""

from gxbench.metrics import done


def read(ctx):
    calls = done(ctx)
    if not calls:
        return None
    return sum(c.fallback_jobs for c in calls) / len(calls)

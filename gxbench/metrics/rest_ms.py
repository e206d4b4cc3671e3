"""Mean milliseconds of a call outside the pack and the bucket execution:
the call's wall less RunStats.pack_s and exec_s. The offload mask, the
PairHMM job list, the unpack, the long-pair kernels (sw_long,
pairhmm_long) and the fp64 fallback are in it."""

from gxbench.metrics import done


def read(ctx):
    calls = done(ctx)
    if not calls:
        return None
    return 1e3 * sum(c.wall_s - c.pack_s - c.exec_s for c in calls) / len(calls)

"""Mean launches of the port's kernels a traced call makes, every route
summed: the program's ``launches.<route>`` counters."""

from gxbench.program_trace import count_per_call


def read(ctx):
    return count_per_call(ctx, "launches.")

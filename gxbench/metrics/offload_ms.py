"""Mean milliseconds a traced call spends on the jobs the bucket kernels do
not take: the program's ``offload`` spans (``Engine._sw_offload_post``,
``Engine._phmm_offload_post``: the long-pair kernels' tiles, packed,
copied, launched and copied back, and the native model)."""

from gxbench.program_trace import span_ms


def read(ctx):
    return span_ms(ctx, "offload")

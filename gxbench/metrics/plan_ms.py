"""Mean milliseconds a traced call spends planning: the PairHMM job list
(``_jobs``) and the offload masks (``Engine._sw_offload_mask``,
``Engine._phmm_offload_mask``), the program's ``plan`` spans."""

from gxbench.program_trace import span_ms


def read(ctx):
    return span_ms(ctx, "plan")

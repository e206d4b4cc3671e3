"""Mean milliseconds a traced call spends in the PairHMM fp64 fallback:
the program's ``fallback`` spans (``Engine._phmm_fallback``: the test of
every result against the threshold and the native recomputation of those
below it)."""

from gxbench.program_trace import span_ms


def read(ctx):
    return span_ms(ctx, "fallback")

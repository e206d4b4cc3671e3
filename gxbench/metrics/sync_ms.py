"""Mean milliseconds a traced call waits on the card: the program's
``sync`` spans, the synchronize after the bucket launches and every copy
of results back to the host (the long-pair tiles' included)."""

from gxbench.program_trace import span_ms


def read(ctx):
    return span_ms(ctx, "sync")

"""Mean milliseconds a traced call spends copying host arrays to the card:
the program's ``h2d`` spans (``trace.to_device``), the bucket tensors,
the long-pair tiles and the phred table alike."""

from gxbench.program_trace import span_ms


def read(ctx):
    return span_ms(ctx, "h2d")

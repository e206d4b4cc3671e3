"""Mean megabytes (10**6 bytes) a traced call copies from the host to the
card: the program's ``h2d_bytes`` counter, the bytes of every array
handed to ``trace.to_device``."""

from gxbench.program_trace import count_per_call


def read(ctx):
    v = count_per_call(ctx, "h2d_bytes")
    return None if v is None else v / 1e6

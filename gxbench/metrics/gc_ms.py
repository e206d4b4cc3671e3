"""Mean milliseconds of a traced call spent in the garbage collector: the
program's ``gc`` spans, each collection that ran while the call was
open, from its start to its stop."""

from gxbench.program_trace import span_ms


def read(ctx):
    return span_ms(ctx, "gc")

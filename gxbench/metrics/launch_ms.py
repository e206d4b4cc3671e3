"""Mean milliseconds a traced call spends launching the port's kernels:
the program's ``launch`` spans, each kernel module's ``_launch`` from
its checks to the return of the launch (the host side; the kernel runs
after)."""

from gxbench.program_trace import span_ms


def read(ctx):
    return span_ms(ctx, "launch")

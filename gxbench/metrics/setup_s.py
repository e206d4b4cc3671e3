"""Seconds from the start of the run's module (before torch is imported)
to the first timed call: torch and the CUDA context, the program and the
kernels it loads (built in the first run of a checkout), the inputs from
the seed and the warm calls."""


def read(ctx):
    return ctx["setup_s"]

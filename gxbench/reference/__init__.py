"""Plain references of the benchmark's configurations, one module each,
named by the configuration's ``reference`` key.

Each module computes from the inputs the benchmark generated, in plain
torch operations one anti-diagonal at a time, and imports nothing of the
program (``genomax_torch``), of the JAX package or of jax. It exposes

    expected(traffic, cfg, device) -> the exact answers, one per job
    judge(outputs, expecteds, limit) -> the number compared (CHECK) over
                                      every call, each output against the
                                      answers of its own inputs, and
                                      whether each call's output passes
    control(traffic, cfg, device, which) -> the reference in a lower
                                      precision (or with a guarantee
                                      broken), the control of the limit
"""

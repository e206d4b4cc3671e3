"""gxbench: the benchmark of genomax_torch on one NVIDIA H100.

One command runs one cell once::

    python3 -m gxbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell is an entry of ``workloads`` in ``BENCHMARK.json`` at the root of
the checkout: a configuration (``configs/<config>.json``: the engine and
scoring settings, the plain reference that judges the outputs and the
guarantee it holds them to) under a traffic mix (``traffic/<mix>.json``:
the parameters that ``generate.py`` turns into inputs from the seed, and
the engine entry that the window calls). Each metric is a reader of its
own, ``metrics/<name>.py``, and a shape of traffic that the generator's
built-in kinds cannot draw is a kind of its own, ``kinds/<kind>.py``. The
harness finds all of them by name, so a new cell, mix, kind or metric is
new files and entries, and no edit.

Modules:

    run.py        the command: one run of one cell, one JSON line last
    harness.py    set-up, the timed window, the judgement of the outputs
    generate.py   the one traffic generator (plain bytes, no port types)
    kinds/        traffic kinds of their own, a file each, that the
                  generator loads by the mix's ``kind``
    counts.py     the DP cells of the inputs, operations and bytes a cell,
                  the H100's peaks: the roofline's yardstick
    trace.py      torch.profiler over the traced window, reduced to busy
                  time, idle gaps and kernel time
    reference/    plain torch references (int32 Gotoh, fp64 PairHMM)
    calibrate.py  readings of the program and of the controls on many
                  seeds, from which the limits were set (not run by a run)

Nothing here imports jax or the JAX package ``genomax``; the reference
imports nothing of ``genomax_torch``.
"""

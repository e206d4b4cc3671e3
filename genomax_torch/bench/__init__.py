"""Benchmarks of the port: ``sweep`` (kernel-only GCUPS by length, the
``bench`` subcommand) and ``scaling`` (pairs/s over mesh sizes,
``bench-dist``)."""

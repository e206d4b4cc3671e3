"""Validation harnesses of the port: ``parity`` (the judged contract
against the reference binaries or the vendored goldens) and ``soak`` (the
seeded randomised differential campaign against the oracles)."""

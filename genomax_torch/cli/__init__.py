"""Command line of the port (``python -m genomax_torch``)."""

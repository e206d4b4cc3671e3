"""The port's execution engine (``executor.Engine``)."""

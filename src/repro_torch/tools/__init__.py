"""First-principles cost models of the port (``analytic``)."""

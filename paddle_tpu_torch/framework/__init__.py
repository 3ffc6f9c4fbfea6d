"""Framework pieces of the port: random seeds (``random``)."""

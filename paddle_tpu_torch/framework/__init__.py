"""Framework pieces of the port: random seeds (``random``) and the
reference parameters it accepts without implementing (``unported``)."""

"""Framework pieces of the port: random seeds (``random``), the
reference parameters it accepts without implementing (``unported``) and
``paddle.save`` / ``paddle.load`` (``io``)."""

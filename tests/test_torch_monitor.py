"""Twin of tests/test_monitor.py: the reference suite's tests run on the
port (``tests/torch_ref_suite.py``)."""
from tests.torch_ref_suite import suite

globals().update(suite("tests/test_monitor.py", __name__))

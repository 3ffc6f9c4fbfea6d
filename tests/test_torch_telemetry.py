"""Twin of tests/test_telemetry.py: the reference suite's 35 tests run on
the port's TraceCollector, MetricsRegistry and engines
(``tests/torch_ref_suite.py``)."""
from tests.torch_ref_suite import suite

globals().update(suite("tests/test_telemetry.py", __name__))

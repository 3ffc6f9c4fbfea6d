"""Twin of tests/test_router.py: the reference suite's tests run on the
port's router, workers and injectors (``tests/torch_ref_suite.py``,
``spec_models=True``), the real-SIGKILL pipes test included."""
from tests.torch_ref_suite import suite

globals().update(suite("tests/test_router.py", __name__, spec_models=True))

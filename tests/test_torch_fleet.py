"""Twin of tests/test_fleet.py: the reference suite's tests run on the
port's supervisor, socket workers and migration policy
(``tests/torch_ref_suite.py``, ``spec_models=True``); ``TestWalDoctor``
runs the unedited tools/recovery_check.py on the port's router WAL."""
from tests.torch_ref_suite import suite

globals().update(suite("tests/test_fleet.py", __name__, spec_models=True))

"""Twin of tests/test_net.py: the reference suite's tests run on the
port's session transport, network injector and degraded router state
(``tests/torch_ref_suite.py``, ``spec_models=True``); the fleet doctor
tests run the unedited tools/fleet_doctor.py on the port's WALs."""
from tests.torch_ref_suite import suite

globals().update(suite("tests/test_net.py", __name__, spec_models=True))

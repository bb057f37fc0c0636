"""The sqllogictest corpus through the port.

Each suite directory runs through the port's own ``run_suite`` and
``SessionContext`` (torch on the CPU). No record may fail, and at least as
many statements must execute as through the JAX package on the same tree
(``tests/test_ported_suites.py`` holds the reference to >= 800 in
``ported``).
"""

import os

import pytest

from databend_tpu_torch import backend
from databend_tpu_torch.service.session import SessionContext
from databend_tpu_torch.testing.sqllogic import run_suite

SUITES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "suites")


@pytest.mark.parametrize("suite, at_least",
                         [("ported", 800), ("base", 159), ("index", 33)])
def test_suite_runs_through_the_port(suite, at_least, tmp_path, monkeypatch):
    monkeypatch.setenv(backend.DEVICE_ENV, "cpu")
    executed, failures = run_suite(
        lambda: SessionContext(str(tmp_path / "d")),
        os.path.join(SUITES, suite))
    assert failures == []
    assert executed >= at_least

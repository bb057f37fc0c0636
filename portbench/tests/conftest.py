"""CPU tests of the benchmark's harness, and its card tests.

    python -m pytest portbench/tests -q          # on the CPU (card tests skip)
    python -m pytest portbench/tests -q -m card  # on the card

The port runs here on the CPU because it is asked to by name
(``DATABEND_TORCH_DEVICE=cpu``); ``portbench/run.py`` itself never does.
Whether a card is present is decided in the ``card`` fixture, never while
a module is imported.
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
os.environ.setdefault("DATABEND_TORCH_DEVICE", "cpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (run on the chip: "
                   "python -m pytest portbench/tests -q -m card)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture
def bench():
    from portbench import harness
    return harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))


@pytest.fixture
def tiny(bench):
    """``tiny(name)``: cell ``name`` at a size the CPU runs in a second or
    two: its configuration and mix with fewer rows and queries, smaller
    blocks and a smaller batch."""
    from portbench import harness

    def make(name, rows=6000, queries=1500, batch=512, block=2048):
        spec = harness.resolve(bench, name)
        cfg = dict(spec["config"], rows=rows, queries=queries)
        cfg["ddl"] = [s.replace("262144", str(block)) for s in cfg["ddl"]]
        spec["config"] = cfg
        spec["mix"] = dict(spec["mix"], batch=batch)
        return spec
    return make

"""pytest settings of the benchmark's own tests (gwasbench/tests/).

``card``: a test that needs an NVIDIA card; it checks for one itself and
skips without it.  Run them on the card's machine with
``python3 -m pytest gwasbench/tests -m card``.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (skips without one)")

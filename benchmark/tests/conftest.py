import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark.tests.tiny import make_tree  # noqa: E402


@pytest.fixture(scope="session")
def tiny_tree(tmp_path_factory):
    """A throwaway checkout with the tiny cells (see ``tiny.py``)."""
    return make_tree(tmp_path_factory.mktemp("bench_tree"))

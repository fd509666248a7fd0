import pytest

from perfbench.harness.registry import Bench
from perfbench.tests import tiny_bench


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The tiny benchmark's `Bench`, one copy a test module."""
    return Bench(tiny_bench.make_root(tmp_path_factory.mktemp("tiny")))

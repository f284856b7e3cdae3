"""The port's build of ``zlogcat``, held to the reference's scenarios.

The 14 scenarios of ``tests/test_zlogcat.py`` (its fixture writers and
test classes, imported; that file stays as it is) run against the
``zlogcat`` that ``binder_torch.fastio_build`` builds from
``native/zklog/zlogcat.cpp`` into ``binder_torch/_build/``, in place of
``native/build/zlogcat``, which only ``make -C native`` writes.
"""
import pytest

from binder_torch import fastio_build
from tests import test_zlogcat as reference


@pytest.fixture(autouse=True)
def port_built_zlogcat(monkeypatch):
    # the reference's ``run`` executes the module's ZLOGCAT
    monkeypatch.setattr(reference, "ZLOGCAT",
                        fastio_build.build("zlogcat")[0])


class TestDecode(reference.TestDecode):
    pass


class TestRobustness(reference.TestRobustness):
    pass


def test_every_reference_scenario_runs_here():
    names = [n for cls in (TestDecode, TestRobustness)
             for n in dir(cls) if n.startswith("test_")]
    assert len(names) == 14

"""The port's systemd install path: its units and the port-built
``instance_adjust -m systemd`` that converges them.

- The 14 scenarios of ``tests/test_instance_adjust_systemd.py`` (its
  ``sd`` fixture and ``tests/fake_systemctl.py``, both as they are) run
  against the ``instance_adjust`` that ``binder_torch.fastio_build``
  builds, in place of ``native/build/instance_adjust``.
- ``binder_torch/deploy/systemd/`` parses under ``systemd-analyze
  verify`` with the diagnostics ``tests/test_systemd_units.py`` accepts
  for the reference's units, keeps the config bootstrap's wiring, and
  equals ``deploy/systemd/`` but for the ``ExecStart`` lines that run
  the port.
"""
import inspect
import os
import re
import shutil
import subprocess

import pytest

from binder_torch import fastio_build
from tests import test_instance_adjust_systemd as reference
from tests.test_instance_adjust_systemd import sd  # noqa: F401 (fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_UNITS = os.path.join(ROOT, "binder_torch", "deploy", "systemd")
REFERENCE_UNITS = os.path.join(ROOT, "deploy", "systemd")
SYSTEMD_ANALYZE = shutil.which("systemd-analyze")
SCENARIOS = sorted(n for n in vars(reference) if n.startswith("test_"))

#: the port's ``ExecStart`` lines, continuations joined; every other
#: line of every unit is the reference's
PORT_EXEC = {
    "binder@.service": [
        "/usr/bin/python3 -m binder_torch.main -f "
        "/opt/binder/etc/config.json -p ${BINDER_PORT} "
        "-b ${BINDER_SOCKET_PATH}"],
    "binder-balancer.service": [
        "/opt/binder/binder_torch/_build/bin/mbalancer "
        "-d /run/binder/sockets -p 53 -b 0.0.0.0"],
    "binder-config.service": [
        "/usr/bin/env PYTHONPATH=/opt/binder /usr/bin/python3 "
        "-m binder_torch.cli.config_render "
        "-m /opt/binder/etc/metadata.json -o /opt/binder/etc/config.json "
        "-c 'systemctl try-restart \"binder@*.service\"'"],
    "binder-metric-ports.service": [
        "/usr/bin/env PYTHONPATH=/opt/binder /usr/bin/python3 "
        "-m binder_torch.topology metric-ports -D /run/binder"],
}


@pytest.fixture(autouse=True)
def port_built_instance_adjust(monkeypatch):
    # the reference's ``sd.adjust`` (and its statedir scenario) run the
    # module's ADJUST
    monkeypatch.setattr(reference, "ADJUST",
                        fastio_build.build("instance_adjust")[0])


def test_every_reference_scenario_is_here():
    assert len(SCENARIOS) == 14


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_reference_scenario(scenario, request):
    fn = getattr(reference, scenario)
    fn(*(request.getfixturevalue(p)
         for p in inspect.signature(fn).parameters))


def unit_files(directory):
    return sorted(fn for fn in os.listdir(directory)
                  if fn.endswith((".service", ".path", ".target")))


def logical_lines(path):
    """The unit's lines with ``\\`` continuations joined."""
    with open(path) as f:
        text = re.sub(r"\s*\\\n\s*", " ", f.read())
    return text.splitlines()


def split_exec(path):
    lines = logical_lines(path)
    execs = [line[len("ExecStart="):] for line in lines
             if line.startswith("ExecStart=")]
    return [line for line in lines
            if not line.startswith("ExecStart=")], execs


def test_port_units_equal_the_reference_but_for_exec_start():
    assert unit_files(PORT_UNITS) == unit_files(REFERENCE_UNITS)
    for fn in unit_files(PORT_UNITS):
        port_rest, port_exec = split_exec(os.path.join(PORT_UNITS, fn))
        ref_rest, ref_exec = split_exec(os.path.join(REFERENCE_UNITS, fn))
        assert port_rest == ref_rest, fn
        assert port_exec == PORT_EXEC.get(fn, ref_exec), fn
        if fn in PORT_EXEC:
            assert port_exec != ref_exec, fn
    for fn in PORT_EXEC:
        with open(os.path.join(PORT_UNITS, fn)) as f:
            text = f.read()
        assert "binder_tpu" not in text and "native/build" not in text
        assert "bin/binder-" not in text.split("[Service]")[1], fn


@pytest.mark.skipif(SYSTEMD_ANALYZE is None,
                    reason="systemd-analyze not installed")
def test_port_units_verify():
    # the diagnostics tests/test_systemd_units.py accepts: User=nobody
    # (reference parity) and commands under /opt/binder, which exist
    # only on an installed host
    proc = subprocess.run(
        [SYSTEMD_ANALYZE, "verify"]
        + [os.path.join(PORT_UNITS, u) for u in unit_files(PORT_UNITS)],
        capture_output=True, text=True, timeout=60)
    bad = [line for line in (proc.stdout + proc.stderr).splitlines()
           if line.strip()
           and "Special user nobody configured" not in line
           and not ("is not executable: No such file" in line
                    and "/opt/binder/" in line)]
    assert not bad, bad


def port_unit(name):
    with open(os.path.join(PORT_UNITS, name)) as f:
        return f.read()


def test_port_config_bootstrap_wiring():
    # tests/test_systemd_units.py's wiring, with the port's renderer
    cfg = port_unit("binder-config.service")
    assert "-m binder_torch.cli.config_render" in cfg
    assert "ConditionPathExists=/opt/binder/etc/metadata.json" in cfg
    assert "Type=oneshot" in cfg
    assert "RemainAfterExit=" not in cfg
    assert "-c 'systemctl try-restart \"binder@*.service\"'" in cfg
    assert "ExecStartPost" not in cfg
    inst = port_unit("binder@.service")
    assert "Wants=binder-config.service" in inst
    assert "After=binder-config.service" in inst
    path = port_unit("binder-config.path")
    assert "PathChanged=/opt/binder/etc/metadata.json" in path
    assert "Unit=binder-config.service" in path

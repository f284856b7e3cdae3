"""The ``systemctl`` stand-in that runs the port's units
(``binder_torch/deploy/systemctl_shim.py``).

On small units of its own: ``start`` runs ``ExecStart`` with the
drop-in's environment, continuations, specifiers and variables
expanded and the install paths rewritten; a SIGKILLed unit shows
``failed`` until ``reset-failed`` and ``start`` restore it;
``try-restart`` with a glob restarts only what runs; ``stop`` sends
``KillSignal`` and SIGKILLs after ``TimeoutStopSec``.  Then the smoke's
systemd phase at a small zone: the port-built ``instance_adjust``
converges 2 port instances through the stand-in behind the port-built
``mbalancer``, and they answer through it.
"""
import json
import os
import signal
import subprocess
import sys
import time

import pytest

from binder_torch.deploy import systemctl_shim

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = """
import json, os, signal, sys, time
run = os.environ["PROBE_RUN"]
port = sys.argv[1]
def on_signal(signum, frame):
    with open(os.path.join(run, "signal-" + port), "w") as f:
        f.write(signal.Signals(signum).name)
    sys.exit(0)
if os.environ.get("PROBE_STUBBORN") != "1":
    signal.signal(signal.SIGUSR1, on_signal)
else:
    signal.signal(signal.SIGUSR1, signal.SIG_IGN)
path = os.path.join(run, "probe-" + port + ".json")
with open(path + ".tmp", "w") as f:
    json.dump({"argv": sys.argv[1:], "cwd": os.getcwd(),
               "pid": os.getpid()}, f)
os.replace(path + ".tmp", path)
while True:
    time.sleep(1)
"""

UNIT = """[Unit]
Description=probe %i

[Service]
Type=simple
WorkingDirectory=/opt/binder
Environment=PROBE_PORT=%i
Environment="PROBE_WORDS=a b" PROBE_RUN=/run/binder
ExecStart=/usr/bin/python3 /opt/binder/probe.py \\
    ${PROBE_PORT} ${PROBE_SOCKET} ${PROBE_WORDS} probe@%i -p 53 -b 0.0.0.0
KillSignal=SIGUSR1
TimeoutStopSec=1
Restart=always
"""


@pytest.fixture
def shim(tmp_path):
    opt, run, units = (tmp_path / d for d in ("opt", "run", "units"))
    for d in (opt, run, units):
        d.mkdir()
    (opt / "probe.py").write_text(PROBE)
    (units / "probe@.service").write_text(UNIT)
    dropin = units / "probe@7001.service.d"
    dropin.mkdir()
    (dropin / "50-instance.conf").write_text(
        "[Service]\nEnvironment=PROBE_SOCKET=/run/binder/sockets/7001\n")
    stubborn = units / "probe@7009.service.d"
    stubborn.mkdir()
    (stubborn / "50-instance.conf").write_text(
        "[Service]\nEnvironment=PROBE_STUBBORN=1\n")
    bindir = systemctl_shim.setup(str(tmp_path / "state"), str(units),
                                  str(opt), str(run), 5353)
    env = dict(os.environ, PATH=bindir + os.pathsep + os.environ["PATH"])

    class Shim:
        state = tmp_path / "state"

        def __call__(self, *args):
            proc = subprocess.run(["systemctl", *args], env=env,
                                  capture_output=True, text=True,
                                  timeout=60)
            return proc.returncode, proc.stdout.strip()

        def active(self, unit):
            return self("show", "-p", "ActiveState", "--value", unit)[1]

        def probe(self, port):
            path = run / f"probe-{port}.json"
            deadline = time.monotonic() + 10
            while not path.exists():
                assert time.monotonic() < deadline, path
                time.sleep(0.01)
            return json.loads(path.read_text())

        def pid(self, unit):
            return json.loads((self.state / "units" / f"{unit}.json")
                              .read_text())["pid"]

        def log(self):
            return (self.state / "log").read_text().splitlines()

    s = Shim()
    s.opt, s.run = str(opt), str(run)
    yield s
    for line in (s.state / "pids").read_text().splitlines() \
            if (s.state / "pids").exists() else []:
        for pid in map(int, line.split()[1:]):
            if systemctl_shim.alive(pid):
                os.kill(pid, signal.SIGKILL)


def wait_state(shim, unit, want):
    deadline = time.monotonic() + 10
    while shim.active(unit) != want:
        assert time.monotonic() < deadline, (unit, shim.active(unit), want)
        time.sleep(0.02)


def test_start_runs_exec_start_with_its_dropin(shim):
    assert shim("start", "probe@7001.service") == (0, "")
    assert shim.active("probe@7001.service") == "active"
    probe = shim.probe(7001)
    bind = "0.0.0.0" if systemctl_shim.wildcard_answers_from_loopback() \
        else "127.0.0.1"
    assert probe["argv"] == ["7001", f"{shim.run}/sockets/7001", "a b",
                             "probe@7001", "-p", "5353", "-b", bind]
    assert probe["cwd"] == shim.opt
    assert probe["pid"] == shim.pid("probe@7001.service")
    with open(f"/proc/{probe['pid']}/cmdline", "rb") as f:
        assert f.read().split(b"\0")[1] == \
            os.path.join(shim.opt, "probe.py").encode()
    rewrites = (shim.state / "rewrites").read_text()
    assert f"probe@7001.service: /opt/binder -> {shim.opt}" in rewrites
    assert f"probe@7001.service: /run/binder -> {shim.run}" in rewrites
    assert "probe@7001.service: not applied: Restart=always" in rewrites
    listed = shim("list-units", "--all", "--plain", "--no-legend",
                  "probe@*.service")[1]
    assert listed == "probe@7001.service loaded active running"


def test_wildcard_bind_rewritten_where_replies_change_source(shim):
    # where a wildcard-bound socket answers a loopback client from the
    # client's own address (gVisor), the balancer binds 127.0.0.1
    path = shim.state / "shim.json"
    cfg = json.loads(path.read_text())
    path.write_text(json.dumps(dict(cfg, bind="127.0.0.1")))
    assert shim("start", "probe@7001.service")[0] == 0
    assert shim.probe(7001)["argv"][-4:] == ["-p", "5353", "-b",
                                             "127.0.0.1"]
    assert "probe@7001.service: -b 0.0.0.0 -> -b 127.0.0.1" in \
        (shim.state / "rewrites").read_text()


def test_sigkill_is_failed_until_reset_failed_and_start(shim):
    shim("enable", "probe@7001.service")
    shim("start", "probe@7001.service")
    old = shim.probe(7001)["pid"]
    os.kill(old, signal.SIGKILL)
    wait_state(shim, "probe@7001.service", "failed")   # no Restart=
    assert "probe@7001.service loaded failed failed" in shim(
        "list-units", "--all", "--plain", "--no-legend", "probe@*")[1]
    assert shim("reset-failed", "probe@7001.service")[0] == 0
    assert shim.active("probe@7001.service") == "inactive"
    os.unlink(os.path.join(shim.run, "probe-7001.json"))
    assert shim("start", "probe@7001.service")[0] == 0
    new = shim.probe(7001)["pid"]
    assert new != old and shim.active("probe@7001.service") == "active"
    assert shim("list-unit-files", "--no-legend", "probe@*")[1] == \
        "probe@7001.service enabled enabled"


def test_try_restart_with_a_glob(shim):
    for port in (7001, 7002):
        shim("start", f"probe@{port}.service")
    before = {port: shim.probe(port)["pid"] for port in (7001, 7002)}
    for port in (7001, 7002):
        os.unlink(os.path.join(shim.run, f"probe-{port}.json"))
    assert shim("try-restart", "probe@*.service")[0] == 0
    for port in (7001, 7002):
        assert shim.probe(port)["pid"] != before[port]
        assert shim.active(f"probe@{port}.service") == "active"
    # try-restart starts nothing that was not running
    assert shim("try-restart", "probe@7003.service")[0] == 0
    assert shim.active("probe@7003.service") == "inactive"
    assert not os.path.exists(os.path.join(shim.run, "probe-7003.json"))
    assert [line for line in shim.log()
            if line.startswith("try-restart")] == [
        "try-restart 'probe@*.service'", "try-restart probe@7003.service"]


def test_stop_sends_kill_signal_then_sigkill(shim):
    shim("start", "probe@7001.service")
    pid = shim.probe(7001)["pid"]
    t0 = time.monotonic()
    assert shim("stop", "probe@7001.service")[0] == 0
    assert time.monotonic() - t0 < 1.0
    with open(os.path.join(shim.run, "signal-7001")) as f:
        assert f.read() == "SIGUSR1"
    assert not systemctl_shim.alive(pid)
    assert shim.active("probe@7001.service") == "inactive"
    # one that ignores its KillSignal is killed after TimeoutStopSec=1
    shim("start", "probe@7009.service")
    pid = shim.probe(7009)["pid"]
    t0 = time.monotonic()
    assert shim("stop", "probe@7009.service")[0] == 0
    assert time.monotonic() - t0 >= 1.0
    assert not systemctl_shim.alive(pid)
    assert shim.active("probe@7009.service") == "inactive"
    assert not os.path.exists(os.path.join(shim.run, "signal-7009"))


SYSTEMD_SMALL = """
import json, os, sys
sys.path.insert(0, {root!r})
import chip_smoke
report = chip_smoke.systemd_phase(hosts=2000, n_blast=3000, n_udp=500,
                                  instances=2)
print(json.dumps({{"report": report,
                  "left": chip_smoke.descendants(os.getpid())}}))
"""


def test_converge_boots_port_instances_behind_the_balancer():
    # the smoke's systemd phase at a small zone: the port-built
    # instance_adjust converges 2 binder@ instances through the
    # stand-in behind the port-built mbalancer; every gate holds
    out = subprocess.run(
        [sys.executable, "-c", SYSTEMD_SMALL.format(root=ROOT)],
        cwd=ROOT, capture_output=True, timeout=300)
    lines = out.stdout.decode().splitlines()
    said = "\n".join(lines) + "\n" + out.stderr.decode()[-3000:]
    assert out.returncode == 0, said
    last = json.loads(lines[-1])
    report = last["report"]
    assert report["errors"] == 0 and report["left_after_stop"] == [], said
    assert last["left"] == [], said
    assert report["dnsblast"]["errors"] == 0, said
    assert report["python_client"]["answered"] == 500, said
    assert report["restore"]["pid"][0] != report["restore"]["pid"][1]
    assert report["metric_ports"] == [report["base_port"] + 1000 + k
                                      for k in range(2)]
    assert set(report["converge_s"]) == {"create", "scale down",
                                         "scale up", "restore",
                                         "teardown"}

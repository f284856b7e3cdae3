"""The port's operator CLIs against the reference's scripts.

- ``python -m binder_torch.cli.bdig`` and ``bin/bdig`` print the same
  text and exit the same for the same queries to one live port server
  (A, SRV over TCP, PTR, ``+short``, a refused name), but for the
  query ID and the time each reports; rotating answers compare as sets.
- ``python -m binder_torch.cli.zkput`` and ``bin/zkput`` load the same
  fixture into two of the port's ZooKeeper servers, print the same and
  leave the same tree; both print the same usage on bad arguments.
- ``python -m binder_torch.cli.config_render``: the four CLI tests of
  ``tests/test_config_render.py`` (imported; that file stays as it is)
  on the port's module, and the same rendering as
  ``bin/binder-config-render``.
- None of ``binder_torch/cli/`` names the reference or its build.
"""
import asyncio
import glob
import json
import os
import re
import subprocess
import sys
import threading

import pytest

from binder_torch.store.zk_testserver import ZKTestServer
from tests import test_config_render as render_reference

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROTATING = {"svc.foo.com", "_http._tcp.svc.foo.com"}


def run(argv, **kw):
    return subprocess.run(argv, cwd=ROOT, capture_output=True, text=True,
                          timeout=60, **kw)


@pytest.fixture(scope="module")
def server_port():
    proc = subprocess.Popen(
        [sys.executable, "-m", "binder_torch.main", "-f", "etc/config.json",
         "-p", "0"], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)
    try:
        for line in proc.stdout:
            m = re.search(rb"UDP DNS service started on [\d.]+:(\d+)", line)
            if m:
                break
        else:
            raise AssertionError("binder_torch.main did not start")
        # keep draining its log so the server never blocks on the pipe
        threading.Thread(target=proc.stdout.read, daemon=True).start()
        yield int(m.group(1))
    finally:
        proc.terminate()
        proc.wait(timeout=10)


def comparable(text, name):
    """bdig's output without the query ID and time; a rotating name's
    answer lines as a set."""
    text = re.sub(r"id: \d+", "id: -", text)
    text = re.sub(r"Query time: [\d.]+ msec", "Query time: -", text)
    lines = text.splitlines()
    if name in ROTATING:
        return sorted(lines)
    return lines


@pytest.mark.parametrize("args", [
    ["web.foo.com"],
    ["web.foo.com", "A", "+norecurse"],
    ["_http._tcp.svc.foo.com", "SRV", "+tcp"],
    ["1.0.168.192.in-addr.arpa", "PTR"],
    ["svc.foo.com", "+short"],
    ["nope.foo.com", "A"],
], ids=lambda a: "-".join(a))
def test_bdig_prints_like_the_reference(server_port, args):
    where = ["@127.0.0.1", "-p", str(server_port)]
    port = run([sys.executable, "-m", "binder_torch.cli.bdig", *where,
                *args])
    ref = run([sys.executable, os.path.join(ROOT, "bin", "bdig"), *where,
               *args])
    assert port.returncode == ref.returncode, (port.stderr, ref.stderr)
    assert port.returncode == (1 if args[0] == "nope.foo.com" else 0)
    assert comparable(port.stdout, args[0]) == \
        comparable(ref.stdout, args[0])
    assert port.stdout.strip()
    assert port.stderr == ref.stderr == ""


def test_bdig_usage_errors_like_the_reference():
    for args in ([], ["web.foo.com", "NOSUCH"]):
        port = run([sys.executable, "-m", "binder_torch.cli.bdig", *args])
        ref = run([sys.executable, os.path.join(ROOT, "bin", "bdig"),
                   *args])
        assert port.returncode == ref.returncode == 2
        assert port.stderr == ref.stderr


class ZKServers:
    """Two of the port's ZooKeeper servers on one background loop."""

    def __init__(self):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.thread.start()
        self.servers = [ZKTestServer(), ZKTestServer()]
        self.ports = [self.call(s.start()) for s in self.servers]

    def call(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(30)

    def tree(self, k):
        """``{path: data}`` of server ``k``'s tree."""
        async def walk():
            out, todo = {}, [("", self.servers[k].state.root)]
            while todo:
                path, node = todo.pop()
                for name, child in node.children.items():
                    out[f"{path}/{name}"] = child.data
                    todo.append((f"{path}/{name}", child))
            return out
        return self.call(walk())

    def close(self):
        for s in self.servers:
            self.call(s.stop())
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(10)
        self.loop.close()


def test_zkput_leaves_the_reference_tree():
    zk = ZKServers()
    try:
        fixture = os.path.join(ROOT, "etc", "fixture.json")
        port = run([sys.executable, "-m", "binder_torch.cli.zkput", "-z",
                    f"127.0.0.1:{zk.ports[0]}", fixture])
        ref = run([sys.executable, os.path.join(ROOT, "bin", "zkput"),
                   "-z", f"127.0.0.1:{zk.ports[1]}", fixture])
        assert port.returncode == ref.returncode == 0, port.stderr
        assert port.stdout == ref.stdout
        with open(fixture) as f:
            assert port.stdout.splitlines() == [f"put {p}"
                                                for p in json.load(f)]
        tree = zk.tree(0)
        assert tree == zk.tree(1)
        assert tree["/com/foo/web"]
    finally:
        zk.close()


def test_zkput_usage_like_the_reference():
    port = run([sys.executable, "-m", "binder_torch.cli.zkput"])
    ref = run([sys.executable, os.path.join(ROOT, "bin", "zkput")])
    assert port.returncode == ref.returncode == 2
    assert port.stderr == ref.stderr and "Usage: zkput" in port.stderr


def port_render_cli(*argv):
    return subprocess.run(
        [sys.executable, "-m", "binder_torch.cli.config_render", *argv],
        cwd=ROOT, capture_output=True, text=True)


@pytest.fixture
def port_renderer(monkeypatch):
    # the reference's CLI tests run the module's ``_run_cli``
    monkeypatch.setattr(render_reference, "_run_cli", port_render_cli)


@pytest.mark.parametrize("scenario", [
    "test_cli_stdout", "test_cli_rejects_invalid_json_output",
    "test_cli_on_change_gating", "test_cli_on_change_hook_failure_surfaces"])
def test_config_render_cli(scenario, port_renderer, tmp_path):
    getattr(render_reference, scenario)(tmp_path)


def test_config_render_renders_like_the_reference(tmp_path):
    md = tmp_path / "md.json"
    for metadata in (render_reference.TRITON_MD, render_reference.MANTA_MD):
        md.write_text(json.dumps(metadata))
        port = port_render_cli("-m", str(md), "-o", "-")
        ref = run([sys.executable,
                   os.path.join(ROOT, "bin", "binder-config-render"),
                   "-m", str(md), "-o", "-"])
        assert port.returncode == ref.returncode == 0, port.stderr
        assert port.stdout == ref.stdout and json.loads(port.stdout)


def test_cli_modules_name_no_reference():
    files = glob.glob(os.path.join(ROOT, "binder_torch", "cli", "*.py"))
    # __init__, bdig, zkput, config_render and libresolv_probe
    assert len(files) == 5
    for path in files:
        with open(path) as f:
            text = f.read()
        assert "binder_tpu" not in text and "native/build" not in text

"""Entry-point parity and import isolation for ``binder_torch``.

``python -m binder_torch.main`` and ``python -m binder_tpu.main`` boot
from the shipped ``etc/config.json``, both on the Python serve lane and
then both on the C lane, and must answer A, SRV and PTR the same way
over UDP and TCP, serve ``/status`` with the same keys and ``/metrics``
with the same families, and the port the loop-accounting and boot-phase
families besides; the port's scrape must pass ``tools.lint``'s
validators.
The processes seed their round-robin rng themselves, so for the
rotating service names (``svc.foo.com`` A and
``_http._tcp.svc.foo.com`` SRV) the comparison is the header plus the
sorted record sets; every other reply is compared byte for byte.

The port must never load the reference: a fresh interpreter that
imports the port's entry points, its deploy-path modules (ZooKeeper,
shard group, recursion, federation, config render), its operator CLIs,
its ``systemctl`` stand-in and its traffic clients holds no
``binder_tpu``, ``jax`` or ``__graft_entry__`` module afterwards, no
file of the port (nor ``chip_smoke.py``) imports one, only
``graft_entry`` imports torch (the deploy-path modules load without it),
the smoke takes nothing from ``tools/`` but ``tools.lint``'s validators,
and a config with a ``chaos`` block runs the port's fault injection in
a shard group whose respawned worker is the port's, leaving no process
behind.

``chip_smoke.py`` must stop every process it starts, the resource
tracker that spawning the collective's ranks brings up included.
"""
import ast
import dataclasses
import glob
import json
import os
import re
import signal
import socket
import struct
import subprocess
import sys
import time
import urllib.request

from binder_torch.dns import wire
from binder_torch.introspect import loopacct
from tests.test_torch_fastio import LANE_MAIN
from tools import lint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("binder_tpu", "jax", "jaxlib", "__graft_entry__")
T = wire.Type
ROTATING = {"svc.foo.com", "_http._tcp.svc.foo.com"}
QUERIES = [("web.foo.com", T.A), ("svc.foo.com", T.A),
           ("_http._tcp.svc.foo.com", T.SRV),
           ("1.0.168.192.in-addr.arpa", T.PTR),
           ("1.1.0.10.in-addr.arpa", T.PTR), ("nope.foo.com", T.A)]


def boot(package, lane):
    proc = subprocess.Popen(
        [sys.executable, "-c", LANE_MAIN, lane, package, "-f",
         "etc/config.json", "-p", "0"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    buf = b""
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if not line:
            break
        buf += line
        m = re.search(rb"UDP DNS service started on [\d.]+:(\d+)", buf)
        if m:
            mport = re.search(rb"metrics server started on port (\d+)",
                              buf)
            return proc, int(m.group(1)), int(mport.group(1))
    proc.kill()
    raise AssertionError(f"{package}.main did not start: {buf[-2000:]!r}")


def ask(port, name, qtype, transport):
    q = wire.make_query(name, qtype, qid=0x5151).encode()
    if transport == "udp":
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            s.settimeout(5)
            s.sendto(q, ("127.0.0.1", port))
            return s.recv(65535)
    with socket.create_connection(("127.0.0.1", port), timeout=5) as s:
        s.sendall(struct.pack(">H", len(q)) + q)
        head = s.recv(2)
        (n,) = struct.unpack(">H", head)
        data = b""
        while len(data) < n:
            data += s.recv(n - len(data))
        return data


def rr_sets(data):
    m = wire.Message.decode(data)

    def rows(section):
        return sorted(repr(dataclasses.astuple(r)) for r in section)
    return (data[:12], [(q.name, q.qtype) for q in m.questions],
            rows(m.answers), rows(m.authorities), rows(m.additionals))


def key_tree(obj):
    if isinstance(obj, dict):
        return {k: key_tree(v) for k, v in obj.items()}
    return type(obj).__name__ if obj is not None else None


def answers_like_reference(lane):
    replies, status, scrape = {}, {}, {}
    for package in ("binder_torch", "binder_tpu"):
        proc, port, mport = boot(package, lane)
        try:
            replies[package] = [ask(port, name, qtype, transport)
                                for name, qtype in QUERIES
                                for transport in ("udp", "tcp")]
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{mport}/status", timeout=5) as r:
                status[package] = json.load(r)
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{mport}/metrics", timeout=5) as r:
                scrape[package] = r.read().decode()
        finally:
            proc.terminate()
            proc.wait(timeout=10)
            proc.stdout.close()
    pairs = zip(replies["binder_torch"], replies["binder_tpu"])
    for (name, qtype), got, want in zip(
            [q for q in QUERIES for _ in (0, 1)], *zip(*pairs)):
        if name in ROTATING:
            assert rr_sets(got) == rr_sets(want), name
        else:
            assert got == want, name
    web = wire.Message.decode(replies["binder_torch"][0])
    assert [a.address for a in web.answers] == ["192.168.0.1"]
    assert sorted(status["binder_torch"]) == sorted(status["binder_tpu"])
    assert key_tree(status["binder_torch"]["store"]) == \
        key_tree(status["binder_tpu"]["store"])
    assert lint.validate_status_snapshot(status["binder_tpu"]) == []
    assert lint.validate_status_snapshot(status["binder_torch"]) == []
    assert lint.validate_exposition(scrape["binder_torch"]) == []
    assert lint.validate_rrl_metrics(scrape["binder_torch"]) == []
    families = {
        package: sorted(line.split()[2] for line in text.splitlines()
                        if line.startswith("# TYPE"))
        for package, text in scrape.items()}
    # the port's server accounts its loop and its boot
    # (docs/observability.md), which the reference does not
    assert sorted(set(families["binder_tpu"]) | PORT_ONLY) == \
        families["binder_torch"]
    return families["binder_torch"]


#: the families only the port's server exports
PORT_ONLY = {loopacct.METRIC_CPU, loopacct.METRIC_WALL,
             loopacct.METRIC_CALLBACKS, loopacct.METRIC_PHASE,
             loopacct.METRIC_PHASE_END, loopacct.METRIC_PHASE_CPU}


def test_main_answers_like_reference():
    # both packages pinned to the Python serve lane
    assert "binder_fastpath_entries" not in answers_like_reference("python")


def test_main_answers_like_reference_on_the_c_lane():
    # both packages on the C lane, built by the port from native/
    assert "binder_fastpath_entries" in answers_like_reference("native")


#: the modules a shard worker or the supervisor loads on the deploy
#: path, beyond what ``binder_torch.main`` imports eagerly
DEPLOY_MODULES = ("binder_torch.store.zk_client",
                  "binder_torch.store.zk_testserver",
                  "binder_torch.shard", "binder_torch.recursion",
                  "binder_torch.recursion.ldap_server",
                  "binder_torch.federation", "binder_torch.config.render")


def fresh_imports(modules):
    """Modules a fresh interpreter gains by importing ``modules``."""
    probe = ("import sys, json, importlib; before = set(sys.modules); "
             f"[importlib.import_module(m) for m in {list(modules)!r}]; "
             "print(json.dumps(sorted(set(sys.modules) - before)))")
    env = dict(os.environ, PYTHONPATH=ROOT)
    return json.loads(subprocess.check_output(
        [sys.executable, "-c", probe], cwd=ROOT, env=env))


#: the operator CLIs and the systemctl stand-in of the install path,
#: and the conformance harnesses
INSTALL_MODULES = ("binder_torch.cli.bdig", "binder_torch.cli.zkput",
                   "binder_torch.cli.config_render",
                   "binder_torch.deploy.systemctl_shim",
                   "binder_torch.cli.resolv_ns",
                   "binder_torch.cli.conformance_tiers")
LOADGEN_MODULES = ("binder_torch.loadgen.hostile",
                   "binder_torch.loadgen.population")


def test_fresh_interpreter_imports_no_reference():
    added = fresh_imports(("binder_torch.main", "binder_torch.graft_entry")
                          + DEPLOY_MODULES + INSTALL_MODULES
                          + LOADGEN_MODULES)
    # everything a bare interpreter holds (site, .pth files,
    # sitecustomize), which ``added`` cannot see
    bare = ("import sys, json; "
            "print(json.dumps(sorted(sys.modules)))")
    baseline = json.loads(subprocess.check_output(
        [sys.executable, "-c", bare], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT)))
    assert baseline
    assert "binder_torch.graft_entry" in added and "torch" in added
    for name in DEPLOY_MODULES + INSTALL_MODULES + LOADGEN_MODULES:
        assert name in added
    for name in added:
        assert name.split(".")[0] not in FORBIDDEN, name
    for name in baseline:
        assert name.split(".")[0] not in FORBIDDEN, name


def test_deploy_modules_load_without_torch():
    # shard workers boot and respawn on this set: torch would add
    # seconds to each
    added = fresh_imports(("binder_torch.main",) + DEPLOY_MODULES)
    assert "binder_torch.shard.supervisor" in added
    assert "binder_torch.recursion.ufds" in added
    tops = {name.split(".")[0] for name in added}
    assert "torch" not in tops and "numpy" not in tops
    assert not tops & set(FORBIDDEN)


def imports_of(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(
                  node.func, "id", None)) in ("import_module",
                                              "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def test_port_sources_import_no_reference():
    files = sorted(glob.glob(os.path.join(ROOT, "binder_torch", "**",
                                          "*.py"), recursive=True))
    assert len(files) >= 39 + 18
    for sub in ("store/jute.py", "store/zk_client.py",
                "store/zk_testserver.py", "shard/supervisor.py",
                "recursion/ufds.py", "federation/federation.py",
                "config/render.py"):
        assert os.path.join(ROOT, "binder_torch", sub) in files
    third_party = {}
    for path in files + [os.path.join(ROOT, "chip_smoke.py")]:
        rel = os.path.relpath(path, ROOT)
        for mod in imports_of(path):
            top = mod.split(".")[0]
            assert top not in FORBIDDEN, (rel, mod)
            if (top not in sys.stdlib_module_names
                    and top != "binder_torch"):
                third_party.setdefault(rel, set()).add(top)
            if top == "tools":
                # the exposition and snapshot validators: stdlib-only,
                # package-neutral; never the reference's traffic clients
                assert mod == "tools.lint", (rel, mod)
    # the serve modules stay stdlib-only; torch lives in graft_entry
    assert third_party == {
        os.path.join("binder_torch", "graft_entry.py"): {"numpy", "torch"},
        "chip_smoke.py": {"numpy", "torch", "tools"},
    }


SMOKE_CLEANUP = """
import json, os, sys
sys.path.insert(0, {root!r})
import chip_smoke
from binder_torch.graft_entry import run_ranks
chip_smoke.serve_phase(hosts=2000, n_udp=200, n_tcp=10)
means = run_ranks(1, "cpu", timeout_s=120)
before = [open("/proc/%d/cmdline" % p).read()
          for p in chip_smoke.descendants(os.getpid())]
left = chip_smoke.stop_children()
print(json.dumps({{"means": means, "before": before, "left": left,
                  "after": chip_smoke.descendants(os.getpid())}}))
"""


def test_chip_smoke_stops_every_process_it_starts():
    out = subprocess.check_output(
        [sys.executable, "-c", SMOKE_CLEANUP.format(root=ROOT)],
        cwd=ROOT, timeout=240)
    got = json.loads(out.decode().splitlines()[-1])
    assert got["means"] == [0.5]
    # the server is gone once the serve phase returns; what the
    # spawned rank leaves behind is multiprocessing's resource tracker
    assert len(got["before"]) == 1
    assert "resource_tracker" in got["before"][0]
    assert got["left"] == [] and got["after"] == []


def test_chaos_block_boots_on_the_port(tmp_path):
    # a ``chaos`` block runs the port's ChaosDriver in the supervisor:
    # the scripted kill lands, the worker comes back as the port, and
    # SIGTERM leaves no process of the group behind
    config = tmp_path / "chaos.json"
    config.write_text(json.dumps({
        "dnsDomain": "foo.com", "host": "127.0.0.1", "shards": 2,
        "queryLog": False, "logLevel": "info",
        "store": {"backend": "fake",
                  "fixture": os.path.join(ROOT, "etc", "fixture.json")},
        "chaos": {"plan": "at 1 shard-kill shard=0"}}))
    tag = f"chaos-probe-{os.getpid()}-{time.monotonic_ns()}"
    log_path = tmp_path / "group.log"
    with open(log_path, "wb") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "binder_torch.main", "-f", str(config),
             "-p", "0"], cwd=ROOT, stdout=out, stderr=subprocess.STDOUT,
            env=dict(os.environ, BINDER_TEST_TAG=tag))

    def tagged():
        found = []
        for entry in os.listdir("/proc"):
            try:
                with open(f"/proc/{entry}/environ", "rb") as f:
                    if f"BINDER_TEST_TAG={tag}".encode() in f.read():
                        found.append(int(entry))
            except (OSError, ValueError):
                continue
        return found

    try:
        deadline = time.monotonic() + 60
        while True:
            text = log_path.read_bytes().decode()
            m = re.search(r"metrics server started on port (\d+)", text)
            if m and "chaos: injected shard-kill" in text and \
                    "all 2 shard(s) serving" in text:
                break
            assert proc.poll() is None, text[-3000:]
            assert time.monotonic() < deadline, text[-3000:]
            time.sleep(0.05)
        killed = int(re.search(r"shard 0: sent signal 9 to pid (\d+)",
                               text).group(1))
        while True:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{m.group(1)}/status",
                    timeout=5) as r:
                w0 = json.load(r)["shards"]["workers"][0]
            if w0["pid"] not in (None, killed) and w0["up"]:
                break
            assert time.monotonic() < deadline, w0
            time.sleep(0.1)
        with open(f"/proc/{w0['pid']}/cmdline", "rb") as f:
            line = f.read().replace(b"\0", b" ").decode()
        assert "-m binder_torch.main" in line and "--shard-worker 0" in line
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=20) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    text = log_path.read_bytes().decode()
    assert "chaos: FaultPlan armed (1 scheduled action(s), 1.0s)" in text
    assert "binder_tpu" not in text
    assert "skipped" not in text and "Traceback" not in text
    deadline = time.monotonic() + 10
    while tagged():
        assert time.monotonic() < deadline, tagged()
        time.sleep(0.05)


DEPLOY_SMALL = """
import json, os, sys
sys.path.insert(0, {root!r})
import chip_smoke
lat = chip_smoke.deploy_phase(hosts=2000, n_udp=3000, shards=2)
print(json.dumps({{"answered": len(lat),
                  "left": chip_smoke.descendants(os.getpid())}}))
"""


def test_chip_smoke_deploy_phase_on_the_cpu():
    # the smoke's deploy phase at a small zone: template render, ZK
    # seed, a 2-worker group under churn and a worker kill, cross-DC,
    # drain; every check of the phase must hold
    out = subprocess.run(
        [sys.executable, "-c", DEPLOY_SMALL.format(root=ROOT)],
        cwd=ROOT, capture_output=True, timeout=300)
    lines = out.stdout.decode().splitlines()
    assert out.returncode == 0, (lines[-5:], out.stderr.decode()[-3000:])
    report = json.loads(next(x for x in lines
                             if x.startswith('{"deploy"')))["deploy"]
    overrides = [x for x in lines if x.startswith("deploy override: ")]
    assert len(overrides) == 7
    assert report["errors"] == 0 and report["left_after_drain"] == []
    assert report["udp_answered"] == 3000
    assert report["workers_run"] == "binder_torch.main"
    assert report["respawn"]["respawns"] >= 1
    assert report["respawn"]["new_pid"] != report["respawn"]["old_pid"]
    assert report["churn"]["all_read_back"]
    assert report["churn"]["fresh_samples"] > 0
    assert report["drain_rc"] == 0
    assert json.loads(lines[-1]) == {"answered": 3000, "left": []}

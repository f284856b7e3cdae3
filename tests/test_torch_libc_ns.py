"""glibc's getent tier and the resolv.conf route of libresolv, for both
packages, in a private network and mount namespace
(``binder_torch.cli.resolv_ns``).

The reference's ``TestLibcConformance`` and ``TestLibresolvConformance``
(``tests/test_conformance.py``) rewrite the host's ``/etc/resolv.conf``
as root and bind its port 53, so they stay opt-in.  Here the same
questions go through glibc alone (NSS, ``getaddrinfo``,
``gethostbyaddr``, ``res_query`` reading resolv.conf) inside a
namespace whose resolv.conf names 127.0.0.1:53, against each package's
``BinderServer`` in process there over ``fixture_store()`` plus 512
synthetic hosts (``tests/libc_ns_serve.py``).  The two packages must
read alike and as the zone says; the host's files must not change; the
``AI_ADDRCONFIG`` trap (no configured IPv4 address, no query) is pinned;
a namespace that cannot be made fails, never falls back; and the smoke's
``libc`` phase passes at a small zone and fails on a planted wrong
address.  Where this host cannot make the namespace, the tests skip
with the reason ``resolv_ns`` gave.
"""
import errno
import hashlib
import json
import os
import shutil
import stat
import subprocess
import sys
import tempfile

import pytest

from binder_torch.cli import resolv_ns
from tests import libc_ns_serve

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HELPER = os.path.join(ROOT, "tests", "libc_ns_serve.py")
HOST_FILES = ("/etc/resolv.conf", "/etc/nsswitch.conf")
PACKAGES = ("ref", "port")


def in_namespace(*argv, env=None, timeout=120):
    return subprocess.run(
        [sys.executable, "-m", "binder_torch.cli.resolv_ns", "--", *argv],
        cwd=ROOT, capture_output=True, text=True, timeout=timeout, env=env)


def stamp(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest(), os.stat(path).st_mtime_ns


@pytest.fixture(scope="module")
def namespace():
    """Skips, with ``resolv_ns``'s own reason, where this host cannot
    make the namespace or has no ``getent``."""
    if shutil.which("getent") is None:
        pytest.skip("no getent(1) on this host")
    out = in_namespace("true", timeout=30)
    if out.returncode != 0:
        pytest.skip(f"no private namespace here: {out.stderr.strip()}")


@pytest.fixture(scope="module")
def read(namespace):
    """What glibc read of each package's server in the namespace."""
    got = {}
    for pkg in PACKAGES:
        out = in_namespace(sys.executable, HELPER, "serve", pkg)
        assert out.returncode == 0, (pkg, out.stdout, out.stderr[-3000:])
        got[pkg] = json.loads(out.stdout.splitlines()[-1])
    return got


def zone():
    return dict([libc_ns_serve.FIXTURE_HOST],
                **libc_ns_serve.synthetic_zone())


class TestGetent:
    @pytest.mark.parametrize("pkg", PACKAGES)
    def test_glibc_reads_the_zone_forward_and_reverse(self, read, pkg):
        want = zone()
        got = read[pkg]
        assert len(want) == 513
        for db in ("ahostsv4", "ahosts", "hosts"):
            assert got[db] == want, db
        assert got["hosts_reverse"] == {a: n for n, a in want.items()}

    @pytest.mark.parametrize("pkg", PACKAGES)
    def test_an_unknown_name_is_not_found(self, read, pkg):
        for db in ("ahostsv4", "hosts"):
            assert read[pkg]["unknown"][db] == [2, ""], db

    def test_both_packages_read_alike(self, read):
        ref, port = read["ref"], read["port"]
        assert ref.keys() == port.keys()
        for key in ref:
            assert ref[key] == port[key], key

    @pytest.mark.parametrize("pkg", PACKAGES)
    def test_the_namespace_was_the_one_asked_for(self, read, pkg):
        made = read[pkg]["namespace"]
        assert made["route"] == resolv_ns.route()
        assert made["address"] == f"{resolv_ns.ADDRESS}/32 on lo"
        assert made["nsswitch_hosts"]["here"] == "hosts: files dns"


class TestLibresolvRoute:
    """``TestLibresolvConformance``'s assertions, through resolv.conf:
    ``libresolv_probe`` without ``--server``."""

    @pytest.mark.parametrize("pkg", PACKAGES)
    def test_srv_a_ptr_and_edns_echo(self, read, pkg):
        probe = read[pkg]["probe"]
        srv = probe["srv"]
        assert srv["ancount"] == 1, srv
        (rec,) = srv["answers"]
        assert (rec["type"], rec["port"], rec["priority"],
                rec["target"]) == (33, 5432, 0, "lb0.svc.foo.com")
        adds = [x for x in srv["additional"] if x["type"] == 1]
        assert adds and adds[0]["name"] == "lb0.svc.foo.com"
        assert adds[0]["address"] == "10.0.1.1"
        # the OPT echo exists only because resolv.conf says edns0: the
        # namespace's file, not glibc's defaults, was read
        assert srv["opt"] == {"payload": 1232}, srv
        a = probe["a"]
        assert [x["address"] for x in a["answers"]] == ["10.7.7.7"]
        assert a["answers"][0]["ttl"] == 30
        assert a["opt"] == {"payload": 1232}
        assert [x["target"] for x in probe["ptr"]["answers"]] == [
            "web.foo.com"]

    def test_both_packages_read_alike(self, read):
        assert read["ref"]["probe"] == read["port"]["probe"]


def test_host_files_are_the_same_after(namespace):
    before = {p: stamp(p) for p in HOST_FILES}
    staged = set(os.listdir(tempfile.gettempdir()))
    out = in_namespace("sh", "-c", "cat /etc/resolv.conf; "
                       "grep '^hosts:' /etc/nsswitch.conf")
    assert out.returncode == 0, out.stderr
    assert out.stdout == resolv_ns.RESOLV_CONF + "hosts: files dns\n"
    assert {p: stamp(p) for p in HOST_FILES} == before
    left = {n for n in set(os.listdir(tempfile.gettempdir())) - staged
            if n.startswith("resolv_ns_")}
    assert not left


def test_without_the_address_getaddrinfo_sends_no_query(namespace):
    """The ``AI_ADDRCONFIG`` trap: with only loopback configured,
    ``getent ahostsv4`` fails without a query; with the TEST-NET-1
    address on ``lo`` the query goes out."""
    out = in_namespace(sys.executable, HELPER, "trap")
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.splitlines()[-1])
    assert got["without"] == {"rc": 2, "output": "", "queries": 0}, got
    assert got["with"]["queries"] >= 1, got


def test_a_failing_unshare_is_named_and_the_command_never_runs(tmp_path):
    stub = tmp_path / "bin" / "unshare"
    stub.parent.mkdir()
    stub.write_text("#!/bin/sh\necho 'unshare: unshare failed: "
                    "Operation not permitted' >&2\nexit 1\n")
    stub.chmod(stub.stat().st_mode | stat.S_IXUSR)
    ran = tmp_path / "ran"
    env = dict(os.environ, PATH=f"{stub.parent}:{os.environ['PATH']}")
    out = in_namespace("touch", str(ran), env=env)
    assert out.returncode == resolv_ns.SETUP_FAILED
    assert "step 'unshare' failed" in out.stderr, out.stderr
    assert not ran.exists()


def test_a_step_that_fails_ends_the_run_before_the_command(
        monkeypatch, capsys):
    def refuse():
        raise resolv_ns.StepError("loopback up", errno.EOPNOTSUPP,
                                  "rtnetlink")

    monkeypatch.setattr(resolv_ns, "configure_network", refuse)
    monkeypatch.setattr(os, "execvpe", lambda *a: pytest.fail("ran"))
    r, w = os.pipe()
    try:
        assert resolv_ns.inner(w, "root", "/nonexistent", ["true"]) == \
            resolv_ns.SETUP_FAILED
        os.close(w)
        assert os.read(r, 16) == b""
    finally:
        os.close(r)
    err = capsys.readouterr().err
    assert "step 'loopback up' failed" in err, err
    assert os.strerror(errno.EOPNOTSUPP) in err, err


def test_bad_arguments():
    for args in ([], ["--"], ["--inner"]):
        assert resolv_ns.main(args) == 2, args


def test_nsswitch_keeps_every_line_but_hosts():
    host = ("passwd: files systemd\n"
            "hosts:          files mdns4_minimal [NOTFOUND=return] dns "
            "myhostname\nnetworks: files\n")
    assert resolv_ns.nsswitch_text(host) == (
        "passwd: files systemd\nhosts: files dns\nnetworks: files\n")
    assert resolv_ns.hosts_line(host).startswith("hosts: files mdns4")
    assert resolv_ns.nsswitch_text("passwd: files\n") == (
        "passwd: files\nhosts: files dns\n")


@pytest.mark.parametrize("kind", ["file", "symlink", "dangling"])
def test_resolv_conf_is_bound_where_glibc_reads_it(tmp_path, monkeypatch,
                                                  kind):
    """The binds ``configure_files`` makes, recorded instead of made:
    over ``/etc/resolv.conf``, over its symlink's target, or, where the
    target is missing, over the target's directory with the file in
    it."""
    etc, run = tmp_path / "etc", tmp_path / "run" / "resolve"
    etc.mkdir()
    run.mkdir(parents=True)
    resolv = etc / "resolv.conf"
    target = run / "stub-resolv.conf"
    if kind == "file":
        resolv.write_text("nameserver 10.0.0.53\n")
    else:
        resolv.symlink_to(target)
        if kind == "symlink":
            target.write_text("nameserver 127.0.0.53\n")
    nss = etc / "nsswitch.conf"
    nss.write_text("hosts: files resolve dns\n")
    stage = tmp_path / "stage"
    stage.mkdir()
    binds = []
    monkeypatch.setattr(resolv_ns, "RESOLV_PATH", str(resolv))
    monkeypatch.setattr(resolv_ns, "NSSWITCH_PATH", str(nss))
    monkeypatch.setattr(resolv_ns, "NSCD_DIRS", (str(tmp_path / "nscd"),))
    monkeypatch.setattr(resolv_ns, "check_private", lambda: None)
    monkeypatch.setattr(resolv_ns, "bind", lambda _libc, src, dst, step:
                        binds.append((step, src, dst)))
    report = resolv_ns.configure_files(str(stage))
    (step, src, dst), nss_bind = binds
    assert nss_bind == ("nsswitch.conf", str(stage / "nsswitch.conf"),
                        str(nss))
    assert (stage / "nsswitch.conf").read_text() == "hosts: files dns\n"
    assert report["nscd"] == []
    assert step == "resolv.conf"
    if kind == "dangling":
        assert (src, dst) == (str(stage / "resolv-dir"), str(run))
        assert (stage / "resolv-dir" / target.name).read_text() == \
            resolv_ns.RESOLV_CONF
        assert "was missing" in report["resolv_conf"]
    else:
        want = resolv if kind == "file" else target
        assert (src, dst) == (str(stage / "resolv.conf"), str(want))
        assert (stage / "resolv.conf").read_text() == resolv_ns.RESOLV_CONF
        assert report["resolv_conf"] == str(want)


def test_an_unprivileged_user_gets_the_userns_route(namespace):
    """The route for a user who is not root: ``unshare --user
    --map-root-user``.  The harness is one stdlib module, copied where
    ``nobody`` can read it."""
    setpriv = shutil.which("setpriv")
    if os.geteuid() != 0 or setpriv is None:
        pytest.skip("needs root and setpriv(1) to become another user")
    where = tempfile.mkdtemp()
    try:
        os.chmod(where, 0o755)
        copy = os.path.join(where, "resolv_ns.py")
        shutil.copy(resolv_ns.__file__, copy)
        os.chmod(copy, 0o644)
        out = subprocess.run(
            [setpriv, "--reuid=65534", "--regid=65534", "--clear-groups",
             sys.executable, copy, "sh", "-c",
             'echo "$RESOLV_NS"; cat /etc/resolv.conf'],
            cwd=where, capture_output=True, text=True, timeout=60)
    finally:
        shutil.rmtree(where)
    if "step 'unshare' failed" in out.stderr:
        pytest.skip(f"no user namespace for nobody: {out.stderr.strip()}")
    assert out.returncode == 0, out.stderr
    made, conf = out.stdout.split("\n", 1)
    assert json.loads(made)["route"] == "userns"
    assert conf == resolv_ns.RESOLV_CONF


SMOKE = """
import json, os, sys
sys.path.insert(0, {root!r})
import chip_smoke
native = {{}}
try:
    chip_smoke.libc_phase(hosts=2000, sample=500, native=native,
                          wrong={wrong})
    failed = None
except chip_smoke.PhaseError as e:
    failed = str(e)
print(json.dumps({{"native": native, "failed": failed,
                  "left": chip_smoke.descendants(os.getpid())}}))
"""


def smoke_phase(wrong):
    out = subprocess.run(
        [sys.executable, "-c", SMOKE.format(root=ROOT, wrong=wrong)],
        cwd=ROOT, capture_output=True, text=True, timeout=240)
    said = out.stdout + out.stderr[-3000:]
    assert out.returncode == 0, said
    lines = out.stdout.splitlines()
    tail = json.loads(lines[-1])
    assert tail["left"] == [], said
    libc = [json.loads(x)["libc"] for x in lines
            if x.startswith('{"libc": ')]
    return libc, tail, said


def test_chip_smoke_libc_phase_on_the_cpu(namespace):
    (report,), tail, said = smoke_phase(None)
    assert tail["failed"] is None, said
    assert report["errors"] == 0, said
    assert report["route"] == resolv_ns.route()
    for kind in ("ahostsv4", "hosts", "hosts_reverse"):
        assert report["queries"][kind]["right"] == 500, (kind, said)
    assert report["unknown"] == {"ahostsv4": 2, "hosts": 2}, said
    assert report["libresolv"]["right"] == ["a", "ptr", "srv"], said
    assert report["host_files_changed"] == [], said
    assert tail["native"]["libc"]["c_zone_hits"] > 0, said


def test_chip_smoke_libc_phase_fails_on_a_planted_wrong_address(namespace):
    (report,), tail, said = smoke_phase(7)
    assert tail["failed"] is not None, said
    assert report["errors"] == 3, said      # ahostsv4, hosts, reverse
    assert report["queries"]["ahostsv4"]["right"] == 499, said
    assert "the zone says 10.255.255.254" in tail["failed"], said

"""Run inside ``binder_torch.cli.resolv_ns`` by ``test_torch_libc_ns.py``.

``python tests/libc_ns_serve.py serve PACKAGE`` boots ``PACKAGE``'s
``BinderServer`` (``ref``: ``binder_tpu``, ``port``: ``binder_torch``)
in this process on 127.0.0.1:53 over ``tests.test_conformance.
fixture_store()`` plus ``SYNTHETIC`` synthetic hosts, asks it through
glibc alone (``getent ahostsv4``, ``ahosts`` and ``hosts`` by name,
``hosts`` by address, ``binder_torch.cli.libresolv_probe`` without
``--server``, and an unknown name), and prints what glibc read as one
JSON object.

``python tests/libc_ns_serve.py trap`` listens on 127.0.0.1:53 with a
bare socket that never answers and asks ``getent ahostsv4`` twice:
without ``resolv_ns.ADDRESS`` on ``lo`` and with it.  It prints each
exit code and how many queries reached the socket.
"""
import asyncio
import json
import os
import socket
import sys
import threading

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from binder_torch.cli import resolv_ns  # noqa: E402
from tests import test_conformance  # noqa: E402

DOMAIN = test_conformance.DOMAIN
SYNTHETIC = 512
UNKNOWN = f"nosuch.{DOMAIN}"
#: ``fixture_store()``'s records
FIXTURE_HOST = ("web.foo.com", "10.7.7.7")
FIXTURE_SRV = "_pg._tcp.svc.foo.com"


def package(name: str):
    """``(BinderServer, FakeStore, MirrorCache, MetricsCollector,
    populate_synthetic)`` of one package."""
    if name == "ref":
        from binder_tpu.metrics.collector import MetricsCollector
        from binder_tpu.server import BinderServer
        from binder_tpu.store import FakeStore, MirrorCache
        from binder_tpu.store.fake import populate_synthetic
    else:
        from binder_torch.metrics.collector import MetricsCollector
        from binder_torch.server import BinderServer
        from binder_torch.store import FakeStore, MirrorCache
        from binder_torch.store.fake import populate_synthetic
    return (BinderServer, FakeStore, MirrorCache, MetricsCollector,
            populate_synthetic)


def synthetic_zone():
    """The synthetic hosts' names and addresses."""
    racks = max(1, min(1024, SYNTHETIC // 512))
    return {f"h{i:06d}.r{i % racks:04d}.zs.{DOMAIN}": chip_smoke.host_addr(i)
            for i in range(SYNTHETIC)}


def cache_for(name: str):
    """``fixture_store()`` built from ``name``'s classes, with the
    synthetic hosts in the tree before its session starts."""
    _, fake, mirror, _, populate = package(name)

    class Store(fake):
        def start_session(self):
            populate(self, DOMAIN, hosts=SYNTHETIC)
            super().start_session()

    saved = test_conformance.FakeStore, test_conformance.MirrorCache
    test_conformance.FakeStore, test_conformance.MirrorCache = Store, mirror
    try:
        return test_conformance.fixture_store()[1]
    finally:
        test_conformance.FakeStore, test_conformance.MirrorCache = saved


def glibc_reads(zone) -> dict:
    """What glibc reads of ``zone`` (name -> address)."""
    names, addrs = list(zone), list(zone.values())
    out = {}
    for db in ("ahostsv4", "ahosts", "hosts"):
        out[db], _ = chip_smoke.getent_map(db, names, 2 if db != "hosts"
                                           else 1, 0)
    out["hosts_reverse"], _ = chip_smoke.getent_map("hosts", addrs, 0, 1)
    out["unknown"] = {db: chip_smoke.getent(db, UNKNOWN)
                      for db in ("ahostsv4", "hosts")}
    out["probe"] = {
        "a": chip_smoke.probe(None, FIXTURE_HOST[0], "A"),
        "ptr": chip_smoke.probe(None, "7.7.7.10.in-addr.arpa", "PTR"),
        "srv": chip_smoke.probe(None, FIXTURE_SRV, "SRV")}
    return out


async def serve(name: str) -> dict:
    server_cls, _, _, collector, _ = package(name)
    server = server_cls(zk_cache=cache_for(name), dns_domain=DOMAIN,
                        datacenter_name="coal", host="127.0.0.1", port=53,
                        collector=collector())
    await server.start()
    try:
        zone = dict([FIXTURE_HOST], **synthetic_zone())
        return await asyncio.get_running_loop().run_in_executor(
            None, glibc_reads, zone)
    finally:
        await server.stop()


def trap() -> dict:
    """``getent ahostsv4`` without and with ``resolv_ns.ADDRESS``,
    against a socket on port 53 that counts queries and answers none."""
    seen = []
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 53))
        s.settimeout(0.2)
        stop = threading.Event()

        def listen():
            while not stop.is_set():
                try:
                    seen.append(s.recv(4096))
                except socket.timeout:
                    continue

        t = threading.Thread(target=listen)
        t.start()
        try:
            out = {}
            for label, on in (("without", False), ("with", True)):
                resolv_ns.set_address(on)
                before = len(seen)
                rc, text = chip_smoke.getent("ahostsv4", FIXTURE_HOST[0])
                out[label] = {"rc": rc, "output": text,
                              "queries": len(seen) - before}
            return out
        finally:
            stop.set()
            t.join(5)


def main() -> int:
    if "RESOLV_NS" not in os.environ:
        print("run me under binder_torch.cli.resolv_ns", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["trap"]:
        report = trap()
    else:
        report = asyncio.run(serve(sys.argv[2]))
    report["namespace"] = json.loads(os.environ["RESOLV_NS"])
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())

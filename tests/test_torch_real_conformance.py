"""The port's counterparts of the reference's opt-in real-service tiers.

- ``TestRealZooKeeper``: ``tests/test_conformance.py``'s case through
  ``binder_torch.store.zk_client.ZKClient`` against a real ZooKeeper
  server, behind the same ``ZK_HOST`` (and ``ZK_PORT``).
- ``TestRealSystemd``: ``tests/test_systemd_real_conformance.py``'s
  case, its ``real_sd`` fixture and stub unit as they are, against the
  ``instance_adjust`` that ``binder_torch.fastio_build`` builds, behind
  the same ``BINDER_SYSTEMD_CONFORMANCE=1``, systemd-as-PID-1 and root
  gates.

Each skips with the reference's reason where its service is absent;
``python -m binder_torch.cli.conformance_tiers`` names them in its
report.
"""
import asyncio
import os

import pytest

from binder_torch import fastio_build
from tests import test_systemd_real_conformance as reference_sd
from tests.test_conformance import ZK_HOST
from tests.test_systemd_real_conformance import \
    TestRealSystemd as ReferenceSystemd
from tests.test_systemd_real_conformance import real_sd  # noqa: F401


@pytest.mark.skipif(ZK_HOST is None,
                    reason="set ZK_HOST to run against a real ZooKeeper "
                           "(the reference's test precondition, "
                           "README.md:63-65)")
class TestRealZooKeeper:
    def test_session_reads_writes_watches(self):
        from binder_torch.store.zk_client import ZKClient

        async def run():
            port = int(os.environ.get("ZK_PORT", "2181"))
            client = ZKClient(address=ZK_HOST, port=port,
                              session_timeout_ms=10000)
            client.start()
            deadline = asyncio.get_running_loop().time() + 10
            while not client.is_connected():
                assert asyncio.get_running_loop().time() < deadline, \
                    f"no ZK session to {ZK_HOST}:{port}"
                await asyncio.sleep(0.05)

            base = "/binder-conformance"
            await client.mkdirp(base + "/web", b'{"type":"host"}')
            assert await client.get_data(base + "/web") == \
                b'{"type":"host"}'
            kids = await client.get_children(base)
            assert "web" in kids

            # a watched read must see a real server's notification
            ev = asyncio.Event()
            w = client.watcher(base)
            w.on("children", lambda kids: ev.set())
            await client.create(base + "/second", b"x")
            await asyncio.wait_for(ev.wait(), 10)

            await client.delete(base + "/second")
            await client.delete(base + "/web")
            await client.delete(base)
            client.close()

        asyncio.run(run())


@pytest.fixture
def port_sd(monkeypatch, request):
    """The reference's ``real_sd``, converging with the port's
    ``instance_adjust``."""
    monkeypatch.setattr(reference_sd, "ADJUST",
                        fastio_build.build("instance_adjust")[0])
    return request.getfixturevalue("real_sd")


class TestRealSystemd:
    pytestmark = [
        pytest.mark.skipif(
            not reference_sd.OPTED_IN,
            reason="set BINDER_SYSTEMD_CONFORMANCE=1 to drive real "
                   "systemd units (installs a transient stub template "
                   "under /run/systemd/system; requires root on a "
                   "systemd host)"),
        pytest.mark.skipif(reference_sd.OPTED_IN
                           and not reference_sd._booted_systemd(),
                           reason="systemd is not PID 1 here"),
        pytest.mark.skipif(reference_sd.OPTED_IN and os.geteuid() != 0,
                           reason="requires root (writes "
                                  "/run/systemd/system)"),
    ]

    def test_full_lifecycle(self, port_sd):
        ReferenceSystemd.test_full_lifecycle(self, port_sd)

"""Rolling shard operations on the port's supervisor.

The reference's ``tests/test_shards.py`` ``TestRollingOps`` on
``binder_torch``: an in-process ``binder_torch.main.run`` supervisor
over a fake store, with real ``python -m binder_torch.main`` workers.

- drain and replace: ``roll_shard`` spawns a replacement, promotes it
  once it is caught up, and drains and reaps the incumbent; the
  replacement serves a write made after the roll;
- a group roll through ``request_roll``, a second request while it runs
  absorbed, every shard on a new pid;
- a replacement that never says hello aborts the roll, and the
  incumbent keeps its pid and keeps serving.

Each asserts the reference's counters exactly: ``rolls``,
``roll_aborts``, ``respawns`` and ``/status`` ``rolls_total``.  Each
runs under its own time limit (``LIMIT_S``), so a wedged roll fails its
test instead of holding the suite.
"""
import asyncio
import json
import os
import socket
import time

import pytest

from binder_torch.dns import Message, Type, make_query
from binder_torch.main import run as binder_run

DOMAIN = "shard.test"
LIMIT_S = 60.0

FIXTURE = {
    **{f"/test/shard/w{i}":
       {"type": "host", "host": {"address": f"10.50.0.{i + 1}"}}
       for i in range(4)},
    "/test/shard/svc": {
        "type": "service",
        "service": {"srvce": "_http", "proto": "_tcp", "port": 8080}},
    **{f"/test/shard/svc/m{i}":
       {"type": "load_balancer",
        "load_balancer": {"address": f"10.50.1.{i + 1}"}}
       for i in range(3)},
}


async def boot(tmpdir: str, shards: int):
    """A port supervisor of ``shards`` real workers over a fake store."""
    fixture = os.path.join(tmpdir, "fixture.json")
    with open(fixture, "w") as f:
        json.dump(FIXTURE, f)
    return await binder_run({
        "dnsDomain": DOMAIN, "datacenterName": "dc0",
        "host": "127.0.0.1", "port": 0, "queryLog": False,
        "expiry": 60000, "size": 10000,
        "store": {"backend": "fake", "fixture": fixture},
        "shards": shards,
    })


async def ask_fresh(port: int, name: str, qid: int,
                    timeout: float = 3.0) -> bytes:
    """One A query on a fresh socket (a fresh reuseport draw)."""
    loop = asyncio.get_running_loop()
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.setblocking(False)
    sock.connect(("127.0.0.1", port))
    try:
        for _ in range(3):
            sock.send(make_query(name, Type.A, qid=qid).encode())
            try:
                return await asyncio.wait_for(
                    loop.sock_recv(sock, 4096), timeout)
            except asyncio.TimeoutError:
                continue
        raise AssertionError(f"no answer for {name} in 3 tries")
    finally:
        sock.close()


def within_limit(coro):
    asyncio.run(asyncio.wait_for(coro, LIMIT_S))


def test_roll_shard_drain_and_replace(tmp_path):
    async def run():
        sup = await boot(str(tmp_path), 2)
        try:
            port = sup.udp_port
            pid0 = sup._pid(0)
            old_proc = sup.links[0].proc
            assert await sup.roll_shard(0)
            assert sup._pid(0) not in (None, pid0)
            assert old_proc.poll() is not None      # exited and reaped
            assert sup.rolls[0] == 1 and sup.roll_aborts == 0
            assert sup.respawns[0] == 0             # a roll is no crash
            snap = sup.snapshot()
            assert snap["shards"]["rolls_total"] == 1
            assert snap["shards"]["rolling_shard"] is None
            with open(f"/proc/{sup._pid(0)}/cmdline", "rb") as f:
                line = f.read().replace(b"\0", b" ").decode()
            assert "-m binder_torch.main" in line and "binder_tpu" not in line
            # a write after the roll: the replacement's delta feed is
            # live, not just its snapshot
            sup.store.put_json(
                "/test/shard/w1",
                {"type": "host", "host": {"address": "10.50.7.7"}})

            async def converged():
                for s in range(8):
                    msg = Message.decode(await ask_fresh(
                        port, f"w1.{DOMAIN}", qid=700 + s))
                    if not msg.answers or \
                            msg.answers[0].address != "10.50.7.7":
                        return False
                return True

            deadline = time.monotonic() + 10
            while not await converged():
                assert time.monotonic() < deadline, \
                    "the rolled group never served the post-roll write"
                await asyncio.sleep(0.2)
        finally:
            await sup.drain()

    within_limit(run())


def test_request_roll_group_and_busy_absorbed(tmp_path):
    async def run():
        sup = await boot(str(tmp_path), 2)
        try:
            pids = {i: sup._pid(i) for i in range(2)}
            task = sup.request_roll()
            assert task is not None
            # an overlapping request is absorbed, not interleaved
            assert sup.request_roll() is None
            assert await task
            for i in range(2):
                assert sup._pid(i) not in (None, pids[i])
            assert sup.rolls == {0: 1, 1: 1}
            assert sup.roll_aborts == 0
            assert sup.snapshot()["shards"]["rolls_total"] == 2
            msg = Message.decode(await ask_fresh(sup.udp_port,
                                                 f"w0.{DOMAIN}", qid=41))
            assert [a.address for a in msg.answers] == ["10.50.0.1"]
        finally:
            await sup.drain()

    within_limit(run())


def test_roll_abort_keeps_incumbent_serving(tmp_path):
    async def run():
        sup = await boot(str(tmp_path), 1)
        try:
            pid0 = sup._pid(0)

            async def no_hello(i, timeout=0.0, link=None):
                raise asyncio.TimeoutError

            sup._wait_hello = no_hello
            assert not await sup.roll_shard(0)
            assert sup.roll_aborts == 1 and sup.rolls[0] == 0
            assert sup._pid(0) == pid0
            assert sup.snapshot()["shards"]["rolls_total"] == 0
            msg = Message.decode(await ask_fresh(sup.udp_port,
                                                 f"w0.{DOMAIN}", qid=51))
            assert [a.address for a in msg.answers] == ["10.50.0.1"]
        finally:
            await sup.drain()

    within_limit(run())


if __name__ == "__main__":
    raise SystemExit(pytest.main([__file__, "-v"]))

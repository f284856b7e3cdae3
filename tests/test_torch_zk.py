"""ZooKeeper-lane parity: ``binder_torch.store.{jute,zk_client,
zk_testserver}`` against ``binder_tpu.store``'s.

- Jute primitives and Stat records encode to the same bytes in both
  packages over a seeded sweep, and each package decodes the other's.
- Wire transcripts: one scripted session (connect, create, getData,
  exists with and without the node, getChildren2, setData and delete
  firing watch events, ping) runs through a recording TCP proxy for
  every pairing of client and server package.  Both directions of the
  stream must be byte-identical across the four pairings: the server's
  session ids and zxids are deterministic, so nothing is masked.
- Cross-wire mirrors: the port's ``ZKClient`` + ``MirrorCache`` over
  the reference's ``ZKTestServer`` and the reference's client over the
  port's server, fed one seeded tree and one mutation script, hold the
  same names, records and reverse index.
- Bulk seed: the port's server started with a tree file
  (``python -m binder_torch.store.zk_testserver 0 tree.json``) holds
  the tree the reference's server holds once a client has created the
  same znodes one by one: data, versions, child versions and zxid.
- Session behaviour, run on both packages and compared: a connection
  drop resumes the same session and re-arms the watches; an expired
  session comes back as a new session with a rebuilt mirror; two
  members over one ``ZKEnsembleState`` fail over with the session kept.
- The port's ``connecting()``, which the shard supervisor's boot hold
  reads: true for exactly the first connection attempt, whether it
  reaches a session or is refused.
- The port's request pipeline: the window bounds requests in flight; a
  20,000-name walk ends whole with ``syncing()`` true until then and
  batches its frames; a walk cut by dropped connections rebuilds whole
  with nothing left outstanding; a silent server is a dead peer within
  the session timeout; a watch event between two replies in one chunk
  keeps its place, and one right after the handshake is not lost.
"""
import asyncio
import json
import os
import random
import re
import socket
import struct
import subprocess
import sys

import pytest

import binder_torch.store.zk_client as port_zk
import binder_tpu.store.zk_client as ref_zk
from binder_torch.store import MirrorCache as PortCache
from binder_torch.store import jute as port_jute
from binder_torch.store import zk_testserver as port_srv
from binder_tpu.store import MirrorCache as RefCache
from binder_tpu.store import jute as ref_jute
from binder_tpu.store import zk_testserver as ref_srv

DOMAIN = "foo.com"
SIDES = {"port": (port_zk, port_srv, port_jute, PortCache),
         "ref": (ref_zk, ref_srv, ref_jute, RefCache)}


# -- jute primitives ---------------------------------------------------


def test_jute_primitives_byte_identical():
    rng = random.Random(0x2181)
    for _ in range(2000):
        v32 = rng.randint(-2**31, 2**31 - 1)
        v64 = rng.randint(-2**63, 2**63 - 1)
        blob = (None if rng.random() < 0.1
                else rng.randbytes(rng.randint(0, 64)))
        text = "".join(chr(rng.choice([rng.randint(32, 126),
                                       rng.randint(0xA0, 0x2FFF)]))
                       for _ in range(rng.randint(0, 12)))
        flag = rng.random() < 0.5
        parts = []
        for fn, arg in (("i32", v32), ("i64", v64), ("boolean", flag),
                        ("buffer", blob), ("string", text)):
            got = getattr(port_jute, fn)(arg)
            assert got == getattr(ref_jute, fn)(arg), (fn, arg)
            parts.append(got)
        wire = b"".join(parts)
        assert port_jute.frame(wire) == ref_jute.frame(wire)
        stat = [rng.randint(-2**63, 2**63 - 1) for _ in range(4)] + \
            [rng.randint(-2**31, 2**31 - 1) for _ in range(3)] + \
            [rng.randint(-2**63, 2**63 - 1)] + \
            [rng.randint(-2**31, 2**31 - 1) for _ in range(2)] + \
            [rng.randint(-2**63, 2**63 - 1)]
        packed = port_jute.pack_stat(*stat)
        assert packed == ref_jute.pack_stat(*stat)
        assert port_jute.stat_num_children(port_jute.Buf(packed)) == stat[9]
        # each package decodes the other's bytes to the same values
        for enc, dec in ((port_jute, ref_jute), (ref_jute, port_jute)):
            buf = dec.Buf(enc.frame(wire)[4:] + packed)
            assert (buf.i32(), buf.i64(), buf.boolean(), buf.buffer(),
                    buf.string()) == (v32, v64, flag, blob, text)
            assert list(dec.read_stat(buf).values()) == stat
            assert buf.remaining() == 0
    for name in ("OpCode", "Err", "EventType", "KeeperState"):
        assert vars(getattr(port_jute, name)).keys() == \
            vars(getattr(ref_jute, name)).keys()
        for k, v in vars(getattr(ref_jute, name)).items():
            if not k.startswith("_"):
                assert getattr(getattr(port_jute, name), k) == v, (name, k)
    with pytest.raises(ValueError):
        port_jute.Buf(b"\x00\x00").i32()


# -- recording proxy ---------------------------------------------------


class Recorder:
    """TCP proxy to a ZK server that keeps each connection's two byte
    streams."""

    def __init__(self, upstream_port):
        self.upstream_port = upstream_port
        self.conns = []

    async def start(self):
        self.server = await asyncio.start_server(self._conn,
                                                 "127.0.0.1", 0)
        self.port = self.server.sockets[0].getsockname()[1]

    async def stop(self):
        self.server.close()

    async def _conn(self, reader, writer):
        ureader, uwriter = await asyncio.open_connection(
            "127.0.0.1", self.upstream_port)
        up, down = bytearray(), bytearray()
        self.conns.append((up, down))

        async def pipe(src, dst, buf):
            try:
                while True:
                    data = await src.read(65536)
                    if not data:
                        break
                    buf += data
                    dst.write(data)
                    await dst.drain()
            except ConnectionError:
                pass
            finally:
                dst.close()

        await asyncio.gather(pipe(reader, uwriter, up),
                             pipe(ureader, writer, down))


def serves(cache, name, ip):
    node = cache.lookup(name)
    return node is not None and node.ip == ip


async def wait_for(predicate, timeout=8.0):
    deadline = asyncio.get_running_loop().time() + timeout
    while asyncio.get_running_loop().time() < deadline:
        if predicate():
            return True
        await asyncio.sleep(0.01)
    return False


def host(addr):
    return json.dumps({"type": "host", "host": {"address": addr}}).encode()


async def scripted_session(client_side, server_side):
    """One session of every opcode the client speaks, through the
    proxy; returns the connection's (client->server, server->client)
    bytes."""
    zk, _, jute, _ = SIDES[client_side]
    server = SIDES[server_side][1].ZKTestServer()
    await server.start()
    proxy = Recorder(server.port)
    await proxy.start()
    c = zk.ZKClient(address="127.0.0.1", port=proxy.port,
                    session_timeout_ms=30000)
    c.start()
    assert await wait_for(c.is_connected)
    await c.mkdirp("/com/foo/web", host("10.1.2.3"))
    await c.create("/com/foo/svc", json.dumps({
        "type": "service", "service": {"srvce": "_http", "proto": "_tcp",
                                       "port": 80}}).encode())
    await c.create("/com/foo/svc")            # NODEEXISTS
    assert await c.get_data("/com/foo/web", watch=True) == host("10.1.2.3")
    data, stat = await c.get_data2("/com/foo/svc")
    assert stat["dataLength"] == len(data)
    assert await c.get_data("/com/foo/nope") is None
    assert await c.exists("/com/foo/web", watch=True)
    assert not await c.exists("/com/foo/late", watch=True)
    assert await c.get_children("/com/foo", watch=True) == ["svc", "web"]
    await c.set_data("/com/foo/web", host("10.9.9.9"))   # data watch
    await c.create("/com/foo/late", host("10.4.4.4"))    # exists + child
    await c.get_children("/com/foo", watch=True)
    await c.delete("/com/foo/late")                      # child watch
    await c.delete("/com/foo/absent")                    # NONODE
    with pytest.raises(ConnectionError):
        await c.delete("/com/foo")                       # NOTEMPTY
    c._send(jute.XID_PING, jute.OpCode.PING, b"")
    (up, down), = proxy.conns
    n = len(down)
    assert await wait_for(lambda: len(down) > n)
    c.close()
    await proxy.stop()
    await server.stop()
    return bytes(up), bytes(down)


def frames(stream):
    out, off = [], 0
    while off < len(stream):
        (n,) = struct.unpack_from(">i", stream, off)
        out.append(stream[off + 4:off + 4 + n])
        off += 4 + n
    assert off == len(stream)
    return out


def test_wire_transcripts_identical_across_pairings():
    async def run():
        return {(c, s): await scripted_session(c, s)
                for c in SIDES for s in SIDES}

    got = asyncio.run(run())
    want = got[("ref", "ref")]
    for pair, streams in got.items():
        assert streams == want, pair
    up, down = (frames(s) for s in want)
    # every opcode the client speaks went out, and watch events came back
    ops = sorted({struct.unpack_from(">i", f, 4)[0] for f in up[1:]})
    op = ref_jute.OpCode
    assert ops == sorted([op.CREATE, op.DELETE, op.EXISTS, op.GETDATA,
                          op.SETDATA, op.PING, op.GETCHILDREN2])
    events = [struct.unpack_from(">i", f, 16)[0] for f in down[1:]
              if struct.unpack_from(">i", f)[0] == ref_jute.XID_WATCHER_EVENT]
    ev = ref_jute.EventType
    assert events == [ev.DATA_CHANGED, ev.CREATED, ev.CHILDREN_CHANGED,
                      ev.CHILDREN_CHANGED]


# -- cross-wire mirrors ------------------------------------------------


def seeded_tree(seed=7, hosts=120):
    """``path -> bytes`` of a small zone: hosts in racks, a service with
    load balancers, a v6 host, a node whose data is not JSON."""
    rng = random.Random(seed)
    tree = {"/com/foo/svc": json.dumps({
        "type": "service", "service": {"srvce": "_http", "proto": "_tcp",
                                       "port": 8080}, "ttl": 120}).encode()}
    for k in range(4):
        tree[f"/com/foo/svc/lb{k}"] = json.dumps({
            "type": "load_balancer",
            "load_balancer": {"address": f"10.0.1.{k + 1}"}}).encode()
    for i in range(hosts):
        addr = f"10.{rng.randrange(256)}.{rng.randrange(256)}.{i % 250 + 1}"
        tree[f"/com/foo/zs/r{i % 7}/h{i:04d}"] = host(addr)
    tree["/com/foo/v6"] = host("2001:db8::7")
    tree["/com/foo/junk"] = b"not json"
    return tree


MUTATIONS = [
    ("set_data", "/com/foo/zs/r0/h0000", host("10.200.0.1")),
    ("delete", "/com/foo/svc/lb3", None),
    ("mkdirp", "/com/foo/zs/r9/h9000", host("10.200.0.2")),
    ("set_data", "/com/foo/junk", host("10.200.0.3")),
    ("delete", "/com/foo/zs/r1/h0001", None),
    ("mkdirp", "/com/foo/sentinel", host("10.200.0.9")),
]
MUTATED_IPS = {"h0000.r0.zs.foo.com": "10.200.0.1",
               "h9000.r9.zs.foo.com": "10.200.0.2",
               "junk.foo.com": "10.200.0.3",
               "sentinel.foo.com": "10.200.0.9"}


def mirror_view(cache):
    return {
        "names": sorted(cache.nodes),
        "records": {d: (n.data, n.ip, n.path,
                        sorted(k.domain for k in n.children))
                    for d, n in sorted(cache.nodes.items())},
        "reverse": {ip: n.domain
                    for ip, n in sorted(cache.rev_lookup.items())},
    }


async def writer_for(side, port):
    w = SIDES[side][0].ZKClient(address="127.0.0.1", port=port)
    w.start()
    assert await wait_for(w.is_connected)
    return w


async def apply_mutation(w, op, path, data):
    if op == "delete":
        await w.delete(path)
    else:
        await getattr(w, op)(path, data)


def test_cross_wire_mirrors_hold_the_same_zone():
    async def run():
        views = {}
        for client_side, server_side in (("port", "ref"), ("ref", "port"),
                                         ("port", "port")):
            zk, _, _, cache_cls = SIDES[client_side]
            server = SIDES[server_side][1].ZKTestServer()
            await server.start()
            w = await writer_for(server_side, server.port)
            for path, data in seeded_tree().items():
                await w.mkdirp(path, data)
            c = zk.ZKClient(address="127.0.0.1", port=server.port,
                            session_timeout_ms=5000)
            cache = cache_cls(c, DOMAIN)
            c.start()
            assert await wait_for(
                lambda: len(cache.rev_lookup) == len(seeded_tree()) - 2)
            seeded = mirror_view(cache)
            for op, path, data in MUTATIONS:
                await apply_mutation(w, op, path, data)
            assert await wait_for(
                lambda: all(serves(cache, name, ip)
                            for name, ip in MUTATED_IPS.items())
                and cache.lookup("h0001.r1.zs.foo.com") is None
                and cache.lookup("lb3.svc.foo.com") is None)
            views[(client_side, server_side)] = (seeded, mirror_view(cache))
            c.close()
            w.close()
            await server.stop()
        return views

    views = asyncio.run(run())
    want = views[("port", "ref")]
    assert views[("ref", "port")] == want
    assert views[("port", "port")] == want
    seeded, mutated = want
    # every znode plus its parents: foo.com, zs and seven racks
    assert len(seeded["names"]) == len(seeded_tree()) + 9
    assert seeded["reverse"]["2001:db8::7"] == "v6.foo.com"
    assert mutated["reverse"]["10.200.0.1"] == "h0000.r0.zs.foo.com"
    assert mutated["reverse"]["10.200.0.3"] == "junk.foo.com"


def tree_view(node):
    return (node.data, node.version, node.cversion,
            {name: tree_view(kid) for name, kid in node.children.items()})


def creation_order(tree):
    """Every znode of ``tree`` and its parents, parents first."""
    nodes = {}
    for path, data in tree.items():
        parts = path.split("/")[1:]
        for d in range(1, len(parts)):
            nodes.setdefault("/" + "/".join(parts[:d]), b"")
        nodes[path] = data
    return sorted(nodes.items(), key=lambda kv: kv[0].count("/"))


def test_bulk_load_holds_what_creates_make(tmp_path):
    nodes = creation_order(seeded_tree())
    tree_file = tmp_path / "tree.json"
    tree_file.write_text(json.dumps([[p, d.decode()] for p, d in nodes]))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "binder_torch.store.zk_testserver", "0",
         str(tree_file)], cwd=root, stdout=subprocess.PIPE, text=True)

    async def run():
        ref = ref_srv.ZKTestServer()
        await ref.start()
        w = await writer_for("port", ref.port)
        for path, data in nodes:
            await w.create(path, data)
        w.close()
        await ref.stop()
        # the port's server over the file: a mirror holds the zone
        port = int(re.search(r":(\d+)$", proc.stdout.readline()).group(1))
        c = port_zk.ZKClient(address="127.0.0.1", port=port)
        cache = PortCache(c, DOMAIN)
        c.start()
        assert await wait_for(
            lambda: len(cache.rev_lookup) == len(seeded_tree()) - 2)
        c.close()
        return ref.state

    try:
        ref_state = asyncio.run(run())
    finally:
        proc.kill()
        proc.wait()
    loaded = port_srv.ZKTestServer()
    loaded.load(nodes)
    assert tree_view(loaded.state.root) == tree_view(ref_state.root)
    assert loaded.state.zxid == ref_state.zxid == len(nodes)
    with pytest.raises(ValueError, match="cannot create /com/foo/svc"):
        loaded.load(nodes[2:3])


# -- session behaviour, both packages ---------------------------------


@pytest.fixture
def fast_reconnect(monkeypatch):
    for zk in (port_zk, ref_zk):
        monkeypatch.setattr(zk, "RECONNECT_DELAY", 0.05)


async def mirrored(side, port, **kw):
    zk, _, _, cache_cls = SIDES[side]
    c = zk.ZKClient(address=kw.pop("address", "127.0.0.1"), port=port,
                    session_timeout_ms=2000)
    cache = cache_cls(c, DOMAIN)
    c.start()
    assert await wait_for(lambda: serves(cache, "web.foo.com", "10.1.2.3"))
    return c, cache


def run_both(scenario):
    async def run():
        return {side: await scenario(side) for side in SIDES}
    got = asyncio.run(run())
    assert got["port"] == got["ref"]
    return got["port"]


def test_connection_drop_resumes_session_and_rearms(fast_reconnect):
    async def scenario(side):
        server = SIDES[side][1].ZKTestServer()
        await server.start()
        w = await writer_for(side, server.port)
        await w.mkdirp("/com/foo/web", host("10.1.2.3"))
        c, cache = await mirrored(side, server.port)
        sid = c._session_id
        server.drop_connections()
        assert await wait_for(lambda: not c.is_connected())
        assert await wait_for(c.is_connected)
        assert await wait_for(w.is_connected)
        # re-armed watches: a data change and a new child both arrive
        await w.set_data("/com/foo/web", host("10.6.6.6"))
        await w.mkdirp("/com/foo/web4", host("10.6.6.7"))
        assert await wait_for(
            lambda: serves(cache, "web4.foo.com", "10.6.6.7")
            and serves(cache, "web.foo.com", "10.6.6.6"))
        out = (c._session_id == sid, server.dropped_conns,
               mirror_view(cache))
        c.close()
        w.close()
        await server.stop()
        return out

    same_session, dropped, view = run_both(scenario)
    assert same_session and dropped == 2
    assert view["reverse"]["10.6.6.7"] == "web4.foo.com"


def test_expired_session_starts_fresh_and_rebuilds(fast_reconnect):
    async def scenario(side):
        server = SIDES[side][1].ZKTestServer()
        await server.start()
        w = await writer_for(side, server.port)
        await w.mkdirp("/com/foo/web", host("10.1.2.3"))
        c, cache = await mirrored(side, server.port)
        sid = c._session_id
        server.expire_session(sid)
        await w.mkdirp("/com/foo/web3", host("10.5.5.5"))
        assert await wait_for(
            lambda: c.is_connected() and c._session_id != sid)
        assert await wait_for(
            lambda: serves(cache, "web3.foo.com", "10.5.5.5"))
        out = (sid, c._session_id, c.session_state(), mirror_view(cache))
        c.close()
        w.close()
        await server.stop()
        return out

    old, new, state, view = run_both(scenario)
    assert new != old and new != 0 and state == "connected"
    assert view["reverse"]["10.5.5.5"] == "web3.foo.com"


def test_connecting_lasts_the_first_connection_attempt(fast_reconnect):
    async def run():
        server = port_srv.ZKTestServer()
        await server.start()
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            closed = s.getsockname()[1]
        live = port_zk.ZKClient(address="127.0.0.1", port=server.port,
                                session_timeout_ms=2000)
        dead = port_zk.ZKClient(address="127.0.0.1", port=closed,
                                session_timeout_ms=2000)
        assert live.connecting() and dead.connecting()
        assert await wait_for(lambda: not live.connecting())
        assert live.session_state() == "connected"
        assert await wait_for(lambda: not dead.connecting())
        assert dead.session_state() == "never-connected"
        # a later retry that connects, or a lost session, is no first
        # attempt: connecting() stays false
        await asyncio.sleep(0.2)
        assert not dead.connecting()
        server.drop_connections()
        assert await wait_for(lambda: not live.is_connected())
        assert not live.connecting()
        live.close()
        dead.close()
        await server.stop()

    asyncio.run(run())


def test_ensemble_failover_keeps_the_session(fast_reconnect):
    async def scenario(side):
        srv = SIDES[side][1]
        state = srv.ZKEnsembleState()
        s1, s2 = srv.ZKTestServer(state=state), srv.ZKTestServer(state=state)
        await s1.start()
        await s2.start()
        w = await writer_for(side, s2.port)
        await w.mkdirp("/com/foo/web", host("10.1.2.3"))
        c, cache = await mirrored(
            side, 2181, address=f"127.0.0.1:{s1.port},127.0.0.1:{s2.port}")
        sid = c._session_id
        await s1.stop()
        ready_throughout = True
        while not c.is_connected() or c._server_idx != 1:
            ready_throughout &= cache.is_ready() and \
                cache.lookup("web.foo.com") is not None
            await asyncio.sleep(0.01)
        await w.mkdirp("/com/foo/moved", host("10.4.4.4"))
        assert await wait_for(
            lambda: serves(cache, "moved.foo.com", "10.4.4.4"))
        out = (c._session_id == sid, ready_throughout, mirror_view(cache))
        c.close()
        w.close()
        await s2.stop()
        return out

    same_session, ready, view = run_both(scenario)
    assert same_session and ready
    assert view["reverse"]["10.4.4.4"] == "moved.foo.com"


def test_requests_in_flight_are_bounded():
    """The port keeps at most ``MAX_IN_FLIGHT`` requests outstanding (a
    mirror's tree walk of a large zone asks for every znode at once),
    in the order they were made, and every caller gets its answer."""
    async def run():
        server = port_srv.ZKTestServer()
        await server.start()
        w = await writer_for("port", server.port)
        for k in range(40):
            await w.mkdirp(f"/com/foo/n{k}", host(f"10.0.0.{k}"))
        c = port_zk.ZKClient(address="127.0.0.1", port=server.port)
        c.start()
        assert await wait_for(c.is_connected)
        most, sent = [0], []
        send = c._send

        def counting(xid, opcode, body):
            most[0] = max(most[0], len(c._pending))
            sent.append(xid)
            send(xid, opcode, body)
        c._send = counting
        got = await asyncio.gather(*[
            c.get_data(f"/com/foo/n{k % 40}")
            for k in range(3 * port_zk.MAX_IN_FLIGHT)])
        c.close()
        w.close()
        await server.stop()
        return most[0], sent, got

    most, sent, got = asyncio.run(run())
    assert most == port_zk.MAX_IN_FLIGHT
    assert sent == sorted(sent)
    assert got == [host(f"10.0.0.{k % 40}")
                   for k in range(3 * port_zk.MAX_IN_FLIGHT)]


# -- the port's request pipeline --------------------------------------


def wire_counts(collector):
    """``{(family, dir): value}`` of the client's wire counters."""
    return {(k, d): collector.counter(f"binder_zk_wire_{k}").value(
        {"dir": d}) for k in ("batches", "frames") for d in ("send", "recv")}


def loaded_server(tree):
    server = port_srv.ZKTestServer()
    server.load(creation_order(tree))
    return server


def holds_tree(cache, tree):
    """Every znode of ``tree`` mirrored with its record (None for data
    that is not JSON)."""
    for path, data in tree.items():
        node = cache.nodes.get(port_zk.ZKClient._path_domain(path))
        try:
            rec = json.loads(data)
        except ValueError:
            rec = None
        if node is None or node.data != rec:
            return False
    return True


def test_a_shared_walk_holds_every_node_and_batches_its_frames():
    """A 20,000-name walk in shared mode: the mirror ends holding every
    node with its record, ``syncing()`` stays true until then, and the
    frames of a loop turn leave in one write."""
    from binder_torch.metrics.collector import MetricsCollector
    tree = seeded_tree(seed=11, hosts=20000)

    async def run():
        server = loaded_server(tree)
        await server.start()
        collector = MetricsCollector()
        c = port_zk.ZKClient(address="127.0.0.1", port=server.port,
                             collector=collector)
        cache = PortCache(c, DOMAIN)
        early_ends = 0
        c.start()
        while not (c.is_connected() and cache.synced()):
            if c.is_connected() and not c.syncing() \
                    and not holds_tree(cache, tree):
                early_ends += 1
            await asyncio.sleep(0)
        out = (early_ends, holds_tree(cache, tree), len(cache.nodes),
               wire_counts(collector),
               collector.counter("binder_zk_requests").value(),
               dict(c._pending), len(c._queued))
        c.close()
        await server.stop()
        return out

    early_ends, whole, names, wire, requests, pending, queued = \
        asyncio.run(run())
    assert early_ends == 0
    assert whole and names == len(tree) + 9
    assert pending == {} and queued == 0
    # every request went out, and every reply came back, in batches
    assert wire[("frames", "send")] == requests > 20000
    assert wire[("frames", "recv")] == requests
    assert wire[("frames", "send")] / wire[("batches", "send")] > 10


def test_a_walk_cut_by_dropped_connections_rebuilds_whole(fast_reconnect):
    """The server drops its connections mid-walk: every request in
    flight or queued is answered as lost, and the reconnect's rebuild
    ends with the same whole mirror and nothing left outstanding."""
    tree = seeded_tree(seed=12, hosts=5000)

    async def run():
        server = loaded_server(tree)
        await server.start()
        c = port_zk.ZKClient(address="127.0.0.1", port=server.port,
                             session_timeout_ms=5000)
        cache = PortCache(c, DOMAIN)
        c.start()
        while len(cache.nodes) < 1000:
            await asyncio.sleep(0)
        cut = (len(c._pending), len(c._queued), c.syncing())
        server.drop_connections()
        assert await wait_for(lambda: not c.is_connected())
        lost = (dict(c._pending), len(c._queued), c.syncing())
        assert await wait_for(lambda: c.is_connected() and cache.synced())
        out = (cut, lost, holds_tree(cache, tree), len(cache.nodes),
               dict(c._pending), len(c._queued), c._fetches,
               server.dropped_conns)
        c.close()
        await server.stop()
        return out

    cut, lost, whole, names, pending, queued, fetches, dropped = \
        asyncio.run(run())
    assert dropped == 1
    # the walk was cut with a full window and more waiting behind it
    assert cut[0] == port_zk.MAX_IN_FLIGHT and cut[1] > 0 and cut[2]
    assert lost == ({}, 0, False)
    assert whole and names == len(tree) + 9
    assert (pending, queued, fetches) == ({}, 0, 0)


class ScriptedServer:
    """A ZooKeeper peer that answers each handshake with session 0x99
    and then runs ``script(reader, writer)``; counts its connections."""

    def __init__(self, script):
        self.script = script
        self.conns = 0

    async def start(self):
        self.server = await asyncio.start_server(self._conn,
                                                 "127.0.0.1", 0)
        self.port = self.server.sockets[0].getsockname()[1]

    async def stop(self):
        self.server.close()

    async def _conn(self, reader, writer):
        self.conns += 1
        try:
            (n,) = struct.unpack(">i", await reader.readexactly(4))
            req = port_jute.Buf(await reader.readexactly(n))
            req.i32()
            req.i64()
            timeout = req.i32()
            writer.write(port_jute.frame(
                port_jute.i32(0) + port_jute.i32(timeout)
                + port_jute.i64(0x99) + port_jute.buffer(b"\x01" * 16)
                + port_jute.boolean(False)))
            await self.script(reader, writer)
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            writer.close()


async def read_xid(reader):
    """The xid of the next request frame."""
    (n,) = struct.unpack(">i", await reader.readexactly(4))
    return port_jute.Buf(await reader.readexactly(n)).i32()


def test_a_silent_server_is_a_dead_peer(fast_reconnect):
    """A server that stops answering (pings included) ends the session
    with ``ConnectionError`` once a session timeout passes without a
    frame, and the client reconnects."""
    async def silent(reader, writer):
        while await reader.read(65536):
            pass

    async def run():
        server = ScriptedServer(silent)
        await server.start()
        c = port_zk.ZKClient(address="127.0.0.1", port=server.port,
                             session_timeout_ms=1000)
        c.start()
        assert await wait_for(c.is_connected)
        t0 = asyncio.get_running_loop().time()
        with pytest.raises(ConnectionError):
            await asyncio.wait_for(c.get_data("/com/foo/web"), 5.0)
        waited = asyncio.get_running_loop().time() - t0
        state = c.session_state()
        assert await wait_for(lambda: server.conns == 2 and c.is_connected())
        out = (waited, state, c.session_state(), c._session_id)
        c.close()
        await server.stop()
        return out

    waited, state, after, sid = asyncio.run(run())
    # the negotiated timeout is 1 s: no sooner, and not much later
    assert 0.9 <= waited <= 2.0
    assert state == "degraded" and after == "connected" and sid == 0x99


def test_a_watch_event_between_two_replies_keeps_its_place():
    """Two replies with a watch event between them, in one chunk: the
    client hands them over in wire order."""
    from binder_torch.metrics.collector import MetricsCollector

    async def answer_both(reader, writer):
        xa, xb = [await read_xid(reader) for _ in range(2)]
        reply = (lambda xid, data: port_jute.frame(
            port_jute.i32(xid) + port_jute.i64(5) + port_jute.i32(0)
            + port_jute.buffer(data) + port_jute.pack_stat(*[0] * 11)))
        event = port_jute.frame(
            port_jute.i32(port_jute.XID_WATCHER_EVENT) + port_jute.i64(5)
            + port_jute.i32(0)
            + port_jute.i32(port_jute.EventType.DATA_CHANGED)
            + port_jute.i32(port_jute.KeeperState.SYNC_CONNECTED)
            + port_jute.string("/com/foo/a"))
        writer.write(reply(xa, b"A") + event + reply(xb, b"B"))
        await writer.drain()
        while await reader.read(65536):
            pass

    async def run():
        server = ScriptedServer(answer_both)
        await server.start()
        collector = MetricsCollector()
        c = port_zk.ZKClient(address="127.0.0.1", port=server.port,
                             collector=collector)
        c.start()
        assert await wait_for(c.is_connected)
        seen = []
        c._on_watch_event = lambda etype, path: seen.append(("event", path))
        for path in ("/com/foo/a", "/com/foo/b"):
            c._request(port_jute.OpCode.GETDATA,
                       port_jute.string(path) + port_jute.boolean(True),
                       lambda err, buf: seen.append(("reply",
                                                     buf.buffer())))
        assert await wait_for(lambda: len(seen) == 3)
        wire = wire_counts(collector)
        c.close()
        await server.stop()
        return seen, wire

    seen, wire = asyncio.run(run())
    assert seen == [("reply", b"A"), ("event", "/com/foo/a"),
                    ("reply", b"B")]
    # the two requests left in one write; the three frames came in one
    # chunk after the handshake's
    assert wire[("batches", "send")] == 1 and wire[("frames", "send")] == 2
    assert wire[("frames", "recv")] == 3 and wire[("batches", "recv")] == 1


def test_a_watch_event_right_after_the_handshake_is_not_lost():
    """A frame that follows the handshake's reply before the session has
    taken the connection over (a resumed session's watch firing) is
    dispatched once the session starts."""
    async def fire_at_once(reader, writer):
        writer.write(port_jute.frame(
            port_jute.i32(port_jute.XID_WATCHER_EVENT) + port_jute.i64(5)
            + port_jute.i32(0)
            + port_jute.i32(port_jute.EventType.DATA_CHANGED)
            + port_jute.i32(port_jute.KeeperState.SYNC_CONNECTED)
            + port_jute.string("/com/foo/early")))
        while await reader.read(65536):
            pass

    async def run():
        server = ScriptedServer(fire_at_once)
        await server.start()
        c = port_zk.ZKClient(address="127.0.0.1", port=server.port)
        seen = []
        c._on_watch_event = lambda etype, path: seen.append((etype, path))
        c.start()
        assert await wait_for(lambda: seen)
        c.close()
        await server.stop()
        return seen

    assert asyncio.run(run()) == [(port_jute.EventType.DATA_CHANGED,
                                   "/com/foo/early")]

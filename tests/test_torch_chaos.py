"""Chaos parity: ``binder_torch.chaos`` against ``binder_tpu.chaos``.

- ``FaultPlan.parse`` on the DSL example of the reference's own
  docstring (every action, ``;`` separators, comments, string values)
  gives the same timeline in both packages, and the same error for each
  malformed script.
- ``ChaosDriver.apply``, given the same actions and recording doubles
  for every target (a fake store and a ZooKeeper-test-server-shaped one,
  the mutator, the shard kill and roll sinks, the verify plane, the
  flight recorder, the stream-fault client and a UDP sink for the
  spoofed flood), makes the same calls with the same arguments in the
  same order, logs the same lines, and leaves the same upstream fault
  state; with no targets at all it skips with the same warnings.
- ``ChaosUpstream`` builds byte-identical responses for the same
  packets, and with the same seed and fault knobs drops, duplicates and
  sends the same datagrams.
- A short soak transcribed from ``tests/test_chaos.py``'s
  ``TestChaosSoak`` on port modules only (and on the port's C lane):
  scripted ZooKeeper-session loss and upstream packet loss under
  continuous queries; answers stay correct or refused, nothing staler
  than the cap is served, stale answers are clamped, and the server
  re-converges.
"""
import asyncio
import logging
import socket
import textwrap
import types

import pytest

import binder_torch.chaos.plan as port_plan
import binder_torch.chaos.stream as port_stream
import binder_torch.chaos.upstream as port_upstream
import binder_tpu.chaos.plan as ref_plan
import binder_tpu.chaos.stream as ref_stream
import binder_tpu.chaos.upstream as ref_upstream
from binder_torch.chaos import ChaosDriver, ChaosUpstream, FaultPlan
from binder_torch.dns import Message, Rcode, Type, make_query
from binder_torch.introspect import FlightRecorder
from binder_torch.metrics.collector import MetricsCollector
from binder_torch.recursion import Recursion, StaticResolverSource
from binder_torch.recursion.client import DnsClient
from binder_torch.server import BinderServer
from binder_torch.store import FakeStore, MirrorCache

SIDES = {"port": (port_plan, port_stream, port_upstream),
         "ref": (ref_plan, ref_stream, ref_upstream)}
DOMAIN = "foo.com"


def dsl_example(plan_mod):
    """The DSL block of the plan module's docstring."""
    block = plan_mod.__doc__.split("comments::\n\n", 1)[1]
    return textwrap.dedent(block.split("\n\n", 1)[0])


def test_parse_the_documented_example_alike():
    text = dsl_example(ref_plan)
    assert dsl_example(port_plan) == text
    plans = {side: mods[0].FaultPlan.parse(text + "; at 6.5 upstream "
                                           "truncate=1 # trailing",
                                           seed=9)
             for side, mods in SIDES.items()}
    port, ref = plans["port"], plans["ref"]
    assert port.timeline == ref.timeline
    assert (port.duration, port.seed) == (ref.duration, ref.seed) == (6.5, 9)
    assert [a for _, a, _ in port.timeline] == [
        "lose-session", "watch-storm", "loop-stall", "upstream",
        "tcp-slow-reader", "tcp-half-close", "tcp-rst", "expire-session",
        "shard-kill", "worker-roll", "rrl-flood", "restore-session",
        "corrupt-answer", "drop-reverse", "skew-replica", "upstream",
        "upstream"]
    assert set(port_plan.ACTIONS) == {a for _, a, _ in port.timeline}
    assert port.rng.random() == ref.rng.random()


@pytest.mark.parametrize("bad", [
    "lose-session", "at x lose-session", "at 1 warp-core-breach",
    "at 1 upstream loss", "at 1 corrupt-answer qname=", "at",
    "at 1.0 shard-kill shard=0 stray"])
def test_parse_rejects_the_same_scripts(bad):
    errors = {}
    for side, (plan_mod, _, _) in SIDES.items():
        with pytest.raises(ValueError) as err:
            plan_mod.FaultPlan.parse(bad)
        errors[side] = str(err.value)
    assert errors["port"] == errors["ref"]


# -- the driver ------------------------------------------------------------


class Calls:
    """One ordered log of every call a side's doubles receive."""

    def __init__(self):
        self.log = []

    def sink(self, name, result=None):
        def call(*args, **kwargs):
            self.log.append((name, args, kwargs))
            return result
        return call


def fake_store(calls):
    # FakeStore's session hooks
    return types.SimpleNamespace(
        lose_session=calls.sink("store.lose_session"),
        start_session=calls.sink("store.start_session"),
        expire_session=calls.sink("store.expire_session"))


def zk_server_store(calls):
    # the ZooKeeper test server's: no start_session
    return types.SimpleNamespace(
        drop_connections=calls.sink("zk.drop_connections"),
        expire_session=calls.sink("zk.expire_session"))


def verify_plane(calls, found):
    return types.SimpleNamespace(**{
        name: calls.sink("verify." + name, 3 if found else None)
        for name in ("corrupt_answer", "drop_reverse", "skew_replica")})


class Clock:
    def __init__(self, calls):
        self.now = 100.0
        self.calls = calls

    def monotonic(self):
        self.now += 0.25
        return self.now

    def sleep(self, s):
        self.calls.log.append(("time.sleep", (s,), {}))


def drive_side(side, actions, monkeypatch, targets, udp_sink):
    plan_mod, stream_mod, _ = SIDES[side]
    calls = Calls()
    monkeypatch.setattr(plan_mod, "time", Clock(calls))

    async def stream_fault(action, host, port, qname, **kwargs):
        calls.log.append(("stream." + action, (host, port, qname), kwargs))
    monkeypatch.setattr(stream_mod, "run_stream_fault", stream_fault)
    logger = logging.getLogger(f"test.chaos.{side}")
    lines = []
    handler = logging.Handler()
    handler.emit = lambda rec: lines.append((rec.levelname,
                                             rec.getMessage()))
    logger.addHandler(handler)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    plan = plan_mod.FaultPlan(seed=5)
    kw = {}
    if targets != "none":
        kw = dict(
            store=(fake_store(calls) if targets == "fake"
                   else zk_server_store(calls)),
            mutate=calls.sink("mutate"),
            tcp_target=("127.0.0.1", 5300, f"chaos0.{DOMAIN}"),
            udp_target=("127.0.0.1", udp_sink.getsockname()[1],
                        f"chaos0.{DOMAIN}"),
            shard_target=calls.sink("shard_target", 1234),
            roll_target=calls.sink("roll_target"),
            verify_target=verify_plane(calls, targets == "fake"),
            recorder=types.SimpleNamespace(record=calls.sink("record")))
    driver = plan_mod.ChaosDriver(plan, log=logger, **kw)
    faults = []
    try:
        for action, kwargs in actions:
            driver.apply(action, dict(kwargs))
            faults.append(plan.upstream.snapshot())
    finally:
        logger.removeHandler(handler)
    flood = []
    udp_sink.settimeout(0.5)
    try:
        while True:
            data, addr = udp_sink.recvfrom(65535)
            flood.append((addr[0], data))
    except socket.timeout:
        pass
    return (calls.log, [a for _, a in driver.applied], lines, faults,
            sorted(flood))


#: every action, with and without its arguments
DRIVEN = [
    ("lose-session", {}), ("watch-storm", {"n": 3}), ("watch-storm", {}),
    ("loop-stall", {"ms": 120}), ("loop-stall", {}),
    ("upstream", {"loss": 0.3, "delay_ms": 40, "dup": 0.05}),
    ("upstream", {"truncate": 1, "dead": 1}),
    ("tcp-slow-reader", {"conns": 2, "queries": 512}),
    ("tcp-half-close", {"queries": 3}), ("tcp-rst", {"conns": 2}),
    ("expire-session", {}), ("shard-kill", {"shard": 0}),
    ("shard-kill", {}), ("worker-roll", {"shard": 0}), ("worker-roll", {}),
    ("rrl-flood", {"n": 24}), ("rrl-flood", {"n": 8, "qname": "x.foo.com"}),
    ("restore-session", {}), ("corrupt-answer", {"qname": "w0.foo.com"}),
    ("drop-reverse", {"ip": "10.0.0.1"}), ("skew-replica", {"shard": 0,
                                                            "frames": 2}),
    ("upstream", {"clear": True}),
]


@pytest.mark.parametrize("targets", ["fake", "zk", "none"])
def test_driver_dispatches_alike(targets, monkeypatch):
    got = {}
    for side in SIDES:
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as sink:
            sink.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1 << 20)
            sink.bind(("127.0.0.1", 0))
            got[side] = drive_side(side, DRIVEN, monkeypatch, targets, sink)
    assert got["port"] == got["ref"]
    calls, applied, lines, faults, flood = got["port"]
    assert applied == [a for a, _ in DRIVEN]
    assert faults[-1] == FaultPlan().upstream.snapshot()
    assert faults[6]["dead"] and faults[6]["loss"] == 0.3
    names = [c[0] for c in calls]
    if targets == "none":
        assert flood == [] and names.count("time.sleep") == 2
        assert sum("skipped" in msg for level, msg in lines) == 17
        return
    assert names.count("mutate") == 3 + 100
    assert names.count("record") == len(DRIVEN)
    assert ("shard_target", (0,), {}) in calls
    assert ("roll_target", (-1,), {}) in calls
    assert ("stream.tcp-slow-reader", ("127.0.0.1", 5300, "chaos0.foo.com"),
            {"conns": 2, "queries": 512}) in calls
    assert len(flood) == 32 and len({ip for ip, _ in flood}) == 8
    if targets == "zk":
        assert ("zk.drop_connections", (), {}) in calls
        assert any("has no hook for restore-session" in msg
                   for _, msg in lines)
        assert sum("found no target state" in msg for _, msg in lines) == 3
    else:
        assert ("verify.skew_replica", (), {"shard": 0, "frames": 2}) \
            in calls


def test_unknown_upstream_knob_fails_alike():
    errors = {}
    for side, (plan_mod, _, _) in SIDES.items():
        driver = plan_mod.ChaosDriver(plan_mod.FaultPlan())
        with pytest.raises(ValueError) as err:
            driver.apply("upstream", {"jitter": 1})
        errors[side] = str(err.value)
    assert errors["port"] == errors["ref"]


# -- the upstream ----------------------------------------------------------


def packets():
    out = []
    for k, (name, qtype) in enumerate([
            ("w.remote.foo.com", Type.A), ("W.Remote.FOO.com", Type.A),
            ("gone.remote.foo.com", Type.A), ("w.remote.foo.com", Type.AAAA),
            ("1.0.8.10.in-addr.arpa", Type.PTR), ("bad.remote.foo.com",
                                                   Type.A)]):
        for rd in (False, True):
            out.append(make_query(name, qtype, qid=k * 2 + rd, rd=rd)
                       .encode())
    wire = out[0]
    out += [b"", wire[:11], wire[:16], wire[:12] + b"\xc0\x0c\x00\x01\x00\x01",
            wire[:4] + b"\x00\x02" + wire[6:], wire[:-3], bytes(range(40)),
            wire[:12] + b"\x03\xff\xfe\xfd\x00\x00\x01\x00\x01"]
    return out


HOSTS = {"w.remote.foo.com": "10.8.0.1", "bad.remote.foo.com": "300.1.1.1"}


def test_upstream_builds_the_same_bytes():
    port = ChaosUpstream(FaultPlan(), hosts=HOSTS, ttl=17)
    ref = ref_upstream.ChaosUpstream(ref_plan.FaultPlan(), hosts=HOSTS,
                                     ttl=17)
    built = 0
    for data in packets():
        assert port_upstream._parse_question(data) == \
            ref_upstream._parse_question(data)
        for tc in (False, True):
            got = port.build_response(data, tc)
            assert got == ref.build_response(data, tc)
            built += got is not None
    assert built >= 20


class Transport:
    def __init__(self):
        self.sent = []

    def sendto(self, data, addr):
        self.sent.append((data, addr))

    def is_closing(self):
        return False


def test_upstream_faults_alike_under_one_seed():
    got = {}
    for side, (plan_mod, _, up_mod) in SIDES.items():
        plan = plan_mod.FaultPlan(seed=42)
        up = up_mod.ChaosUpstream(plan, hosts=HOSTS)
        proto = up._Proto(up)
        tx = Transport()
        proto.connection_made(tx)
        script = []
        for knobs in ({"loss": 0.3, "dup": 0.25}, {"truncate": 1},
                      {"dead": 1}, {"clear": True}):
            plan.upstream.set(**knobs)
            for data in packets() * 5:
                proto.datagram_received(data, ("127.0.0.1", 5353))
            script.append(len(tx.sent))
        got[side] = (tx.sent, script, up.stats())
    assert got["port"] == got["ref"]
    sent, script, stats = got["port"]
    assert stats["dropped"] > 0 and stats["duplicated"] > 0
    assert stats["truncated"] > 0 and script[1] == script[2] < script[3]


# -- the soak (tests/test_chaos.py TestChaosSoak, on port modules) --------


def make_fixture(recorder=None, collector=None, hosts=None):
    store = FakeStore(recorder=recorder)
    cache = MirrorCache(store, DOMAIN, collector=collector,
                        recorder=recorder)
    for name, addr in (hosts or {"web": "10.0.0.1"}).items():
        store.put_json(f"/com/foo/{name}",
                       {"type": "host", "host": {"address": addr}})
    store.start_session()
    return store, cache


async def udp_ask(port, name, qtype, qid=1, rd=False, edns=1232,
                  timeout=5.0):
    loop = asyncio.get_running_loop()
    fut = loop.create_future()

    class Proto(asyncio.DatagramProtocol):
        def connection_made(self, transport):
            transport.sendto(make_query(name, qtype, qid=qid, rd=rd,
                                        edns_payload=edns).encode())

        def datagram_received(self, data, addr):
            if not fut.done():
                fut.set_result(data)

    transport, _ = await loop.create_datagram_endpoint(
        Proto, remote_addr=("127.0.0.1", port))
    try:
        data = await asyncio.wait_for(fut, timeout)
    finally:
        transport.close()
    return Message.decode(data)


SOAK_SECONDS = 3.0


def test_soak_under_session_loss_and_packet_loss():
    stats = asyncio.run(soak())
    assert stats["ok"] > 0
    assert stats["stale"] > 0, "stale-serving window not observed"
    assert stats["servfail"] > 0, "exhausted window not observed"
    assert stats["native"], "the soak did not run on the C lane"


async def soak():
    collector = MetricsCollector()
    recorder = FlightRecorder()
    store, cache = make_fixture(
        recorder=recorder, collector=collector,
        hosts={f"w{i}": f"10.0.1.{i + 1}" for i in range(8)})

    # recursion upstream with scripted packet loss
    plan = FaultPlan(seed=42)
    upstream = ChaosUpstream(plan, hosts={"w.remote.foo.com": "10.8.0.1"})
    up_port = await upstream.start()
    recursion = Recursion(
        zk_cache=cache, dns_domain=DOMAIN, datacenter_name="dc0",
        source=StaticResolverSource({"remote": [f"127.0.0.1:{up_port}"]}),
        client=DnsClient(timeout=0.25),
        collector=collector, recorder=recorder)
    await recursion.wait_ready()

    max_staleness = 0.8
    server = BinderServer(
        zk_cache=cache, dns_domain=DOMAIN, datacenter_name="dc0",
        host="127.0.0.1", port=0, collector=collector,
        query_log=False, flight_recorder=recorder, recursion=recursion,
        degradation={"maxStalenessSeconds": max_staleness,
                     "staleTtlClampSeconds": 3},
        admission={"maxInflight": 64})
    await server.start()

    # scripted faults: upstream loss early, session killed mid-churn,
    # both healed before the end
    soak_plan = FaultPlan(seed=7) \
        .at(0.3, "upstream", loss=0.4) \
        .at(0.6, "lose-session") \
        .at(0.7, "watch-storm", n=50) \
        .at(2.0, "restore-session") \
        .at(2.2, "upstream", clear=True)
    # the upstream faults must act on the UPSTREAM's plan
    soak_plan.upstream = plan.upstream

    def mutate(i):
        store.put_json(f"/com/foo/churn{i % 4}",
                       {"type": "host",
                        "host": {"address": f"10.7.0.{i % 200 + 1}"}})

    driver = ChaosDriver(soak_plan, store=store, mutate=mutate,
                         recorder=recorder)
    chaos_task = driver.start()

    pol = server._policy
    stats = {"ok": 0, "refused": 0, "servfail": 0, "stale": 0,
             "native": server._fastpath is not None}
    loop = asyncio.get_running_loop()
    t_end = loop.time() + SOAK_SECONDS
    i = 0
    try:
        while loop.time() < t_end:
            name = f"w{i % 8}.foo.com"
            rd = i % 5 == 0
            if rd:
                name = "w.remote.foo.com"
            i += 1
            try:
                msg = await udp_ask(server.udp_port, name, Type.A,
                                    qid=(i % 0xFFFF) + 1, rd=rd,
                                    timeout=1.0)
            except asyncio.TimeoutError:
                # recursion forwards may legitimately exceed the ask
                # window under 40% loss; local queries may not
                assert rd, f"local query for {name} hung"
                continue
            mode = pol.mode()
            if msg.rcode == Rcode.NOERROR and msg.answers:
                # data answers only while fresh or within the staleness
                # cap, and stale answers are clamped
                assert mode in ("fresh", "stale-serving")
                if mode == "stale-serving" and not rd:
                    assert all(a.ttl <= 3 for a in msg.answers)
                    stats["stale"] += 1
                ds = store.disconnected_seconds()
                if ds is not None and not rd:
                    assert ds <= max_staleness + 0.5, \
                        "served staler than the cap"
                stats["ok"] += 1
            elif msg.rcode == Rcode.REFUSED:
                stats["refused"] += 1
            elif msg.rcode == Rcode.SERVFAIL:
                stats["servfail"] += 1
            await asyncio.sleep(0.01)

        await asyncio.wait_for(chaos_task, 5.0)

        # re-convergence: session back -> fresh, serving, and every
        # degradation signal at rest
        gen_before = cache.gen
        store.put_json("/com/foo/w0",
                       {"type": "host", "host": {"address": "10.0.1.99"}})
        assert cache.gen > gen_before, "mirror gen must advance"
        for _ in range(50):
            if pol.mode() == "fresh":
                break
            await asyncio.sleep(0.05)
        assert pol.mode() == "fresh"
        assert collector.get("binder_degraded_state").value() == 0.0
        msg = await udp_ask(server.udp_port, "w0.foo.com", Type.A,
                            qid=9999)
        assert msg.rcode == Rcode.NOERROR
        assert msg.answers[0].address == "10.0.1.99"
        assert recursion.breakers.open_count() == 0
        kinds = {e["type"] for e in recorder.events()}
        assert "chaos-inject" in kinds
        assert "degraded-transition" in kinds
        return stats
    finally:
        await server.stop()
        await recursion.close()
        await upstream.stop()

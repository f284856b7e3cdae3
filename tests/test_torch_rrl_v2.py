"""RRL v2 parity: ``binder_torch.policy.rrl`` against ``binder_tpu.policy.rrl``.

The cases of the reference's ``tests/test_hostile.py`` ``TestRRLv2``
(allowlists, adaptive buckets, the bucket LRU), each run as one script
through a ``ResponseRateLimiter`` of each package.  Every observation
(verdict sequences, counters, bucket and prefix-cache sizes, the
adaptation table, ``introspect()``) must be equal between the two, and
equal to what the reference test expects.  The limiters run at rate 0
or with full buckets, so the clock decides nothing and the comparison
is exact.

One more case runs through a live port server with its C lane
resident: a prefix limited over UDP that then completes TCP queries
earns a doubling (``note_tcp`` is reached while ``hot()`` holds the C
lane's TCP serve shut).
"""
import asyncio
import socket

import pytest

from binder_torch.dns import Message, Rcode, Type, make_query
from binder_torch.metrics.collector import MetricsCollector
from binder_torch.policy import rrl as port_rrl
from binder_torch.server import BinderServer
from binder_torch.store import FakeStore, MirrorCache
from binder_tpu.policy import rrl as ref_rrl

SEND, SLIP, DROP = port_rrl.SEND, port_rrl.SLIP, port_rrl.DROP
assert (SEND, SLIP, DROP) == (ref_rrl.SEND, ref_rrl.SLIP, ref_rrl.DROP)


def both(script):
    """``script(module)`` run against each package's module; asserts the
    two observations are equal and returns the port's."""
    port = script(port_rrl)
    ref = script(ref_rrl)
    assert port == ref
    return port


def state(rrl):
    """What a limiter holds, in plain values."""
    return {"responses": rrl.responses, "slipped": rrl.slipped,
            "dropped": rrl.dropped, "evictions": rrl.evictions,
            "allowlisted": rrl.allowlisted,
            "adaptations": rrl.adaptations,
            "false_positives": rrl.false_positives,
            "adapted_count": rrl.adapted_count(),
            "buckets": sorted(rrl._buckets),
            "prefix_cache": len(rrl._prefix_cache),
            "adapted": {k: list(v) for k, v in rrl._adapted.items()},
            "introspect": rrl.introspect()}


def test_allowlisted_prefix_never_limited_never_buckets():
    def script(mod):
        rrl = mod.ResponseRateLimiter(
            responses_per_second=0.0, burst=1.0, slip_ratio=0,
            allowlist=["192.0.2.0/24", "2001:db8::/32"])
        verdicts = [rrl.decide(f"192.0.2.{i + 1}") for i in range(50)]
        verdicts.append(rrl.decide("2001:db8::dead:beef"))
        listed = state(rrl)
        # the /24 next door is still fully limited
        verdicts += [rrl.decide("192.0.3.1"), rrl.decide("192.0.3.2")]
        return verdicts, listed, state(rrl)

    verdicts, listed, after = both(script)
    assert verdicts == [SEND] * 52 + [DROP]
    assert listed["allowlisted"] == 51 and listed["buckets"] == []


def test_allowlist_bad_entries_ignored():
    def script(mod):
        rrl = mod.ResponseRateLimiter(
            allowlist=["banana", "10.0.0.0/99", "10.0.0.0/8"])
        nets = len(rrl._allow_nets_v4)
        first = (rrl.decide("10.200.1.2"), rrl.allowlisted)
        second = (rrl.decide("11.0.0.1"), rrl.allowlisted)
        return nets, first, second, state(rrl)

    nets, first, second, _ = both(script)
    assert nets == 1
    assert first == (SEND, 1) and second == (SEND, 1)


def test_from_config_v2_keys():
    def script(mod):
        rrl = mod.ResponseRateLimiter.from_config(
            {"allowlist": ["203.0.113.0/24"], "adaptive": False,
             "adaptMaxMultiplier": 8, "adaptEvidence": 5})
        default = mod.ResponseRateLimiter.from_config({})
        return ((rrl.allowlist, rrl.adaptive, rrl.adapt_max_multiplier,
                 rrl.adapt_evidence, rrl.introspect()),
                (default.adaptive, default.allowlist,
                 default.introspect()))

    configured, default = both(script)
    assert configured[:4] == (("203.0.113.0/24",), False, 8.0, 5)
    assert default[:2] == (True, ())


def test_tcp_evidence_earns_doubling():
    def script(mod):
        rrl = mod.ResponseRateLimiter(responses_per_second=0.0,
                                      burst=2.0, slip_ratio=0,
                                      adapt_evidence=3)
        ip = "198.51.100.7"
        verdicts = [rrl.decide(ip) for _ in range(3)]
        steps = []
        for _ in range(3):
            rrl.note_tcp(ip)
            steps.append(state(rrl))
        return verdicts, steps

    verdicts, steps = both(script)
    assert verdicts == [SEND, SEND, DROP]
    assert [s["adaptations"] for s in steps] == [0, 0, 1]
    assert steps[-1]["adapted_count"] == 1
    assert steps[-1]["adapted"]["198.51.100/24"][0] == 2.0
    assert steps[-1]["false_positives"] == 1


def test_note_tcp_ignores_unlimited_prefixes():
    def script(mod):
        rrl = mod.ResponseRateLimiter(responses_per_second=0.0,
                                      burst=10.0, slip_ratio=0)
        rrl.decide("192.0.2.1")          # within burst: not limited
        for _ in range(5):
            rrl.note_tcp("192.0.2.1")
        rrl.note_tcp("203.0.113.1")      # no bucket at all
        return state(rrl)

    after = both(script)
    assert after["adapted"] == {}
    assert after["adaptations"] == 0 and after["adapted_count"] == 0


def test_adaptation_caps_at_max_multiplier():
    def script(mod):
        rrl = mod.ResponseRateLimiter(responses_per_second=0.0,
                                      burst=2.0, slip_ratio=0,
                                      adapt_evidence=1,
                                      adapt_max_multiplier=4.0)
        ip = "198.51.100.9"
        verdicts = [rrl.decide(ip) for _ in range(3)]
        steps = []
        for _ in range(5):
            rrl.note_tcp(ip)
            steps.append(state(rrl)["adapted"]["198.51.100/24"][0])
        return verdicts, steps, state(rrl)

    verdicts, steps, after = both(script)
    assert verdicts == [SEND, SEND, DROP]
    assert steps == [2.0, 4.0, 4.0, 4.0, 4.0]
    assert after["adaptations"] == 2


def test_adapted_multiplier_survives_bucket_eviction():
    def script(mod):
        rrl = mod.ResponseRateLimiter(responses_per_second=0.0,
                                      burst=1.0, slip_ratio=0,
                                      max_buckets=4, adapt_evidence=1)
        ip = "198.51.100.1"
        verdicts = [rrl.decide(ip), rrl.decide(ip)]
        rrl.note_tcp(ip)
        adapted = rrl.adapted_count()
        for i in range(10):              # the spray evicts the bucket
            rrl.decide(f"10.{i}.0.1")
        sprayed = state(rrl)
        # the re-minted bucket starts with the doubled burst
        again = [rrl.decide(ip) for _ in range(3)]
        return verdicts, adapted, sprayed, again, state(rrl)

    verdicts, adapted, sprayed, again, _ = both(script)
    assert verdicts == [SEND, DROP] and adapted == 1
    assert "198.51.100/24" not in sprayed["buckets"]
    assert sprayed["adapted_count"] == 1
    assert again == [SEND, SEND, DROP]


def test_max_buckets_boundary_spray():
    def script(mod):
        rrl = mod.ResponseRateLimiter(responses_per_second=0.0,
                                      burst=50.0, slip_ratio=0,
                                      max_buckets=8192,
                                      allowlist=["127.0.0.0/24"])
        legit = "198.51.100.1"
        verdicts = [rrl.decide(legit)]
        for i in range(20000):
            verdicts.append(rrl.decide(f"10.{(i >> 8) & 255}.{i & 255}.1"))
            if i % 64 == 0:
                verdicts.append(rrl.decide(legit))
            if i % 100 == 0:
                verdicts.append(rrl.decide("127.0.0.5"))
        return verdicts, state(rrl)

    verdicts, after = both(script)
    assert len(after["buckets"]) <= 8192
    assert after["prefix_cache"] <= 8192
    assert "198.51.100/24" in after["buckets"]
    assert "127.0.0/24" not in after["buckets"]
    assert after["evictions"] == 20001 - 8192
    assert after["allowlisted"] == 200


def test_introspect_v2_keys():
    def script(mod):
        return mod.ResponseRateLimiter(
            allowlist=["192.0.2.0/24"]).introspect()

    snap = both(script)
    assert snap["allowlist"] == ["192.0.2.0/24"]
    for key in ("allowlisted", "adaptive", "adapted_buckets",
                "adaptations", "false_positives"):
        assert key in snap
    assert snap["adaptive"] is True and snap["adapted_buckets"] == 0


# -- through the C lane ------------------------------------------------

DOMAIN = "foo.com"
LIMITED = "127.66.7.7"      # a flood prefix of the traffic clients


async def tcp_ask(port: int, qid: int):
    reader, writer = await asyncio.open_connection(
        "127.0.0.1", port, local_addr=(LIMITED, 0))
    try:
        wire = make_query(f"web.{DOMAIN}", Type.A, qid=qid).encode()
        writer.write(len(wire).to_bytes(2, "big") + wire)
        await writer.drain()
        n = int.from_bytes(await asyncio.wait_for(
            reader.readexactly(2), 5.0), "big")
        return Message.decode(await reader.readexactly(n))
    finally:
        writer.close()


def test_tcp_retries_from_a_limited_prefix_earn_a_doubling_on_the_c_lane():
    """A /24 limited over UDP comes back over TCP, as a slipped client
    does: with the C lane resident, the limiter's hot window shuts the
    lane's TCP serve, so each completed TCP query reaches ``note_tcp``
    and ``adaptEvidence`` of them buy the prefix a doubled bucket."""
    async def run():
        store = FakeStore()
        cache = MirrorCache(store, DOMAIN)
        store.put_json("/com/foo/web",
                       {"type": "host", "host": {"address": "192.168.0.1"}})
        store.start_session()
        server = BinderServer(
            zk_cache=cache, dns_domain=DOMAIN, datacenter_name="coal",
            host="127.0.0.1", port=0, collector=MetricsCollector(),
            query_log=False,
            rrl={"responsesPerSecond": 20, "burst": 40, "slipRatio": 2,
                 "adaptive": True, "adaptEvidence": 3})
        await server.start()
        try:
            assert server.engine.fastpath is not None, "no C lane"
            assert server.engine.fastpath_gate(), "the C lane is shut"
            rrl = server._rrl
            flood = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            try:
                flood.bind((LIMITED, 0))
                wire = make_query(f"web.{DOMAIN}", Type.A, qid=1).encode()
                for _ in range(200):
                    flood.sendto(wire, ("127.0.0.1", server.udp_port))
                await asyncio.sleep(0.2)
            finally:
                flood.close()
            assert rrl.dropped + rrl.slipped > 0, "the prefix was not limited"
            assert rrl.hot() and not server.engine.fastpath_gate()
            for qid in range(2, 5):
                msg = await tcp_ask(server.tcp_port, qid)
                assert msg.rcode == Rcode.NOERROR
                assert [a.address for a in msg.answers] == ["192.168.0.1"]
            return rrl.adaptations, rrl.adapted_count(), \
                rrl._adapted["127.66.7/24"][0]
        finally:
            await server.stop()

    assert asyncio.run(run()) == (1, 1, 2.0)


if __name__ == "__main__":
    raise SystemExit(pytest.main([__file__, "-v"]))

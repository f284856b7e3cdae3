"""The port's traffic clients (``binder_torch.loadgen``) against ``tools/``'s.

- ``hostile``: the malformed corpus equals ``tools.hostile``'s and the
  committed ``tests/data/malformed_corpus.bin`` frame for frame (and
  ``write_corpus`` writes those bytes and labels); the EDNS edge frames
  are byte-identical for one seeded ``random.Random``; ``parse_mix``
  gives the same mixes and rejects the same text.
- ``population``: ``ZipfSampler`` draws the same ranks from the same
  seed.
- Both clients, run for about a second each against an in-process port
  server on a small zone, return reports with the reference clients'
  keys, categories and cohorts, and the same population shape; the
  reference clients are run against the same server for the keys.
- A source address the host will not bind raises ``SourceBindError``
  (the reference clients fall back to 127.0.0.1).
- The corpus through the port's UDP ingress and its TCP path: FORMERR
  or no reply, never an answer, and nothing deposited in any cache
  (the counterparts of the reference's ``TestCorpus`` lane tests).

Equality is exact throughout; the live runs compare structure only,
since how many frames a paced client sends in a second depends on the
clock.
"""
import asyncio
import os
import random
import struct

import pytest

from binder_torch.dns import Rcode
from binder_torch.loadgen import SourceBindError
from binder_torch.loadgen import hostile as port_hostile
from binder_torch.loadgen import population as port_population
from binder_torch.metrics.collector import MetricsCollector
from binder_torch.server import BinderServer
from binder_torch.store import FakeStore, MirrorCache
from tools import hostile as ref_hostile
from tools import population as ref_population

DOMAIN = "foo.com"
CORPUS = os.path.join(os.path.dirname(__file__), "data",
                      "malformed_corpus.bin")


def test_malformed_frames_match_reference_and_committed_corpus():
    port = port_hostile.malformed_frames()
    assert port == ref_hostile.malformed_frames()
    committed = port_hostile.read_corpus(CORPUS)
    assert committed == ref_hostile.read_corpus(CORPUS)
    assert [f for _, f in committed] == [f for _, f in port]
    assert [label for label, _ in committed] == [label for label, _ in port]
    assert len(port) == 323
    assert port_hostile.malformed_frames(seed=5) == \
        ref_hostile.malformed_frames(seed=5)


def test_write_corpus_writes_the_committed_bytes(tmp_path):
    path = str(tmp_path / "corpus.bin")
    assert port_hostile.write_corpus(path) == 323
    with open(path, "rb") as f, open(CORPUS, "rb") as g:
        assert f.read() == g.read()
    with open(path + ".manifest") as f, open(CORPUS + ".manifest") as g:
        assert f.read() == g.read()


def test_default_corpus_path_is_the_committed_corpus():
    assert os.path.samefile(port_hostile.CORPUS_DEFAULT, CORPUS)


@pytest.mark.parametrize("domain", ["foo.com", "smoke.test"])
def test_edns_edge_frames_are_byte_identical(domain):
    port = port_hostile._edns_edge_frames(domain, random.Random(7))
    ref = ref_hostile._edns_edge_frames(domain, random.Random(7))
    assert port == ref and len(port) == 11


def test_rand_name_and_classify_match():
    a, b = random.Random(3), random.Random(3)
    assert [port_hostile._rand_name(a, DOMAIN) for _ in range(50)] == \
        [ref_hostile._rand_name(b, DOMAIN) for _ in range(50)]
    replies = [b"", b"\x00" * 11,
               bytes.fromhex("1234 8200 0001 0000 0000 0000"),  # slip
               bytes.fromhex("1234 8001 0001 0000 0000 0000"),  # formerr
               bytes.fromhex("1234 8005 0001 0000 0000 0000"),  # refused
               bytes.fromhex("1234 8000 0001 0001 0000 0000")]
    assert [port_hostile._classify(r) for r in replies] == \
        [ref_hostile._classify(r) for r in replies]


@pytest.mark.parametrize("text", [
    "legit=0.2,spoof=0.5,malformed=0.3", "legit", "spoof=1,,edns=2",
    "random=0.5, oversized=0.25"])
def test_parse_mix_matches(text):
    assert port_hostile.parse_mix(text) == ref_hostile.parse_mix(text)


def test_parse_mix_rejects_what_the_reference_rejects():
    for mod in (port_hostile, ref_hostile):
        with pytest.raises(ValueError, match="unknown category"):
            mod.parse_mix("legit=1,bogus=2")


def test_constants_match():
    for name in ("CATEGORIES", "DEFAULT_MIX", "QTYPE_MIX",
                 "HOSTILE_PREFIXES"):
        assert getattr(port_hostile, name) == getattr(ref_hostile, name)
    for name in ("FARM_PREFIXES", "DIRECT_PREFIXES", "EDNS_MIX",
                 "DEFAULT_IDENTITIES", "DEFAULT_ZIPF_S"):
        assert getattr(port_population, name) == \
            getattr(ref_population, name)
    assert port_population.DEFAULT_IDENTITIES == 200_000
    assert port_population.DEFAULT_ZIPF_S == 1.1


@pytest.mark.parametrize("n,s,seed", [(16, 1.1, 7), (100_000, 1.1, 11),
                                      (50_000, 0.8, 1)])
def test_zipf_sampler_draws_match(n, s, seed):
    port = port_population.ZipfSampler(n, s)
    ref = ref_population.ZipfSampler(n, s)
    a, b = random.Random(seed), random.Random(seed)
    draws = [port.sample(a) for _ in range(5000)]
    assert draws == [ref.sample(b) for _ in range(5000)]
    assert all(0 <= d < n for d in draws)


def test_first_ttl_matches():
    from binder_torch.dns import make_query
    reply = bytearray(make_query("w0.foo.com", 1, qid=9,
                                 edns_payload=None).encode())
    reply[6:8] = b"\x00\x01"
    reply += b"\xc0\x0c\x00\x01\x00\x01\x00\x00\x01\x2c\x00\x04\x0a\x00\x00\x01"
    for r in (bytes(reply), bytes(reply[:20])):
        assert port_population._first_ttl(r) == ref_population._first_ttl(r)
    assert port_population._first_ttl(bytes(reply)) == 300


def test_refused_source_bind_raises():
    """192.0.2.1 (TEST-NET-1) is no local address: the port's clients
    report the refusal instead of sending from 127.0.0.1."""
    server = ("127.0.0.1", 9)
    with pytest.raises(SourceBindError, match="192.0.2.1"):
        port_hostile.Flow(server, "192.0.2.1", "any")
    with pytest.raises(SourceBindError, match="192.0.2.1"):
        port_population.Endpoint(server, "192.0.2.1", "farm")
    with pytest.raises(SourceBindError, match="192.0.2.1"):
        port_population._TcpRetry(server, "192.0.2.1", b"\x00" * 12, 0,
                                  1.0)


# -- live runs against an in-process port server -----------------------


def fixture_store():
    store = FakeStore()
    cache = MirrorCache(store, DOMAIN)
    for i in range(8):
        store.put_json(f"/com/foo/w{i}",
                       {"type": "host", "host": {"address": f"10.9.0.{i + 1}"}})
    store.put_json("/com/foo/svc", {
        "type": "service",
        "service": {"srvce": "_pg", "proto": "_tcp", "port": 5432}})
    store.put_json("/com/foo/svc/lb0",
                   {"type": "load_balancer",
                    "load_balancer": {"address": "10.0.1.1"}})
    store.start_session()
    return store, cache


def new_server(cache, **kw):
    return BinderServer(zk_cache=cache, dns_domain=DOMAIN,
                        datacenter_name="coal",
                        collector=MetricsCollector(), query_log=False, **kw)


def against_live_server(*clients):
    """Run each ``client(port)`` in a thread while a port server with a
    low RRL limit serves; returns their results."""
    async def run():
        _, cache = fixture_store()
        server = new_server(cache, host="127.0.0.1", port=0,
                            rrl={"responsesPerSecond": 150, "burst": 300,
                                 "slipRatio": 2, "maxBuckets": 512})
        await server.start()
        try:
            loop = asyncio.get_running_loop()
            return [await loop.run_in_executor(None, c, server.udp_port)
                    for c in clients]
        finally:
            await server.stop()
    return asyncio.run(run())


def shape(obj):
    """Nested key structure of a report."""
    if isinstance(obj, dict):
        return {k: shape(v) for k, v in obj.items()}
    return type(obj).__name__ if obj is not None else None


def test_blast_report_has_the_reference_keys():
    def run(mod):
        return lambda port: mod.blast("127.0.0.1", port, duration=1.0,
                                      flows=16, qps=1500, domain=DOMAIN)

    port_r, ref_r = against_live_server(run(port_hostile),
                                        run(ref_hostile))
    assert set(port_r) == set(ref_r)
    assert set(port_r["categories"]) == set(port_hostile.CATEGORIES)
    for cat in port_hostile.CATEGORIES:
        assert set(port_r["categories"][cat]) == \
            set(ref_r["categories"][cat])
    assert port_r["population"] == ref_r["population"]
    assert port_r["mix"] == ref_r["mix"] and port_r["flows"] == 16
    cats = port_r["categories"]
    assert cats["legit"]["answered"] > 0
    assert cats["spoof"]["sent"] > 0
    # malformed frames: FORMERR or silence (the smoke's allowance for
    # replies to a flow's shared query IDs)
    bad = cats["malformed"]
    assert bad["answered"] <= 0.02 * bad["sent"] + 3, bad


def test_run_population_report_has_the_reference_keys():
    def run(mod):
        return lambda port: mod.run_population(
            "127.0.0.1", port, duration=1.0, identities=2000,
            qps_floor=200, qps_peak=400, domain=DOMAIN)

    port_r, ref_r = against_live_server(run(port_population),
                                        run(ref_population))
    assert shape(port_r).keys() == shape(ref_r).keys()
    assert set(port_r["cohorts"]) == {"farm", "direct", "spoof"}
    for cohort, row in port_r["cohorts"].items():
        assert set(row) == set(ref_r["cohorts"][cohort])
    for key in ("identity_outcomes", "ttl_observed", "offered"):
        assert set(port_r[key]) == set(ref_r[key])
    assert port_r["population"] == ref_r["population"]
    assert port_r["cohorts"]["farm"]["sent"] > 0
    assert port_r["cohorts"]["farm"]["answered"] > 0
    assert 0.0 <= port_r["rrl_false_positive_rate"] <= 1.0


def test_hostile_main_writes_the_report(tmp_path, capsys):
    names = tmp_path / "names.txt"
    names.write_text("".join(f"w{i}.{DOMAIN}\n" for i in range(8)))

    def run(port):
        return port_hostile.main(["--port", str(port), "--duration", "0.5",
                                  "--flows", "8", "--qps", "400",
                                  "--names-file", str(names)])

    assert against_live_server(run) == [0]
    import json
    report = json.loads(capsys.readouterr().out)
    assert report["flows"] == 8
    assert report["categories"]["legit"]["answered"] > 0


# -- the corpus through the port's serve lanes -------------------------


def assert_formerr_or_drop(label, frame, responses):
    """At most one reply, and a reply is a refusal with zero answer
    records, under the frame's ID."""
    assert len(responses) <= 1, f"{label}: {len(responses)} replies"
    for resp in responses:
        assert len(resp) >= 12, f"{label}: runt reply"
        assert resp[2] & 0x80, f"{label}: reply without QR"
        rcode = resp[3] & 0x0F
        assert rcode in (Rcode.FORMERR, Rcode.REFUSED, Rcode.NOTIMP,
                         Rcode.SERVFAIL), f"{label}: rcode {rcode}"
        (ancount,) = struct.unpack_from(">H", resp, 6)
        assert ancount == 0, f"{label}: answered with {ancount} records"
        if len(frame) >= 2:
            assert resp[:2] == frame[:2], f"{label}: reply id mismatch"


def assert_no_deposits(server):
    assert not server.engine._decode_cache, "decode-cache deposit"
    stats = server.answer_cache.stats()
    assert stats["entries"] == 0, "answer-cache deposit"
    assert stats["compiled_entries"] == 0, "compiled-table deposit"


@pytest.mark.parametrize("lane,src", [("udp", ("192.0.2.7", 5353)),
                                      ("tcp", ("192.0.2.7", 40001))])
def test_corpus_formerr_or_drop_no_deposits(lane, src):
    _, cache = fixture_store()
    server = new_server(cache)
    assert server.engine.raw_lane is not None
    frames = port_hostile.read_corpus(CORPUS)
    assert len(frames) == 323
    for label, frame in frames:
        out = []
        server.engine._handle_raw(frame, src, lane, out.append)
        assert_formerr_or_drop(f"{lane}:{label}", frame, out)
    assert_no_deposits(server)


if __name__ == "__main__":
    raise SystemExit(pytest.main([__file__, "-v"]))

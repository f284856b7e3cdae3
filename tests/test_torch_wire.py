"""Wire-codec parity: ``binder_torch.dns`` against ``binder_tpu.dns``.

The port's codec is a transcription, so every comparison here is
byte-exact: the RFC golden vectors of ``test_conformance.py``, the
committed malformed corpus (same decode-or-WireError outcome and the
same re-encode, frame for frame), hypothesis-built messages, and the two
serve-path helpers every lane uses, ``make_query`` and
``patch_answer_wire``.
"""
import dataclasses
import os

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import test_conformance as conformance
from binder_torch.dns import wire as port
from binder_tpu.dns import wire as ref
from tools.hostile import read_corpus

CORPUS = os.path.join(os.path.dirname(__file__), "data",
                      "malformed_corpus.bin")
GOLDEN = conformance.TestGoldenVectors
VECTORS = ["QUERY_A", "RESPONSE_A", "RESPONSE_SRV", "RESPONSE_PTR",
           "RESPONSE_SOA", "QUERY_EDNS"]


def fields(msg):
    """A package-neutral view of a decoded Message."""
    def rec(r):
        return (type(r).__name__, r.rtype, dataclasses.asdict(r))
    return ((msg.id, msg.qr, msg.opcode, msg.aa, msg.tc, msg.rd, msg.ra,
             msg.rcode),
            [(q.name, q.qtype, q.qclass) for q in msg.questions],
            [rec(r) for r in msg.answers],
            [rec(r) for r in msg.authorities],
            [rec(r) for r in msg.additionals])


def decode_outcome(mod, frame):
    try:
        m = mod.Message.decode(frame)
    except mod.WireError as e:
        return ("WireError", str(e))
    return ("ok", fields(m), m.encode(), m.encode(max_size=512))


@pytest.mark.parametrize("vector", VECTORS)
def test_golden_vector_parity(vector):
    frame = getattr(GOLDEN, vector)
    got, want = decode_outcome(port, frame), decode_outcome(ref, frame)
    assert got[0] == "ok"
    assert got == want


def test_golden_query_encodes_byte_identical():
    for name in ("example.com", "ExAmPlE.CoM"):
        got = port.make_query(name, port.Type.A, qid=0x1234, rd=True,
                              edns_payload=None).encode()
        assert got == GOLDEN.QUERY_A
    assert port.make_query("web.foo.com", port.Type.A, qid=0x42,
                           edns_payload=1232).encode() == GOLDEN.QUERY_EDNS


def test_malformed_corpus_same_outcome_frame_for_frame():
    frames = read_corpus(CORPUS)
    assert len(frames) == 323
    rejected = 0
    for label, frame in frames:
        got, want = decode_outcome(port, frame), decode_outcome(ref, frame)
        assert got == want, label
        rejected += got[0] == "WireError"
    assert rejected > 0


@pytest.mark.parametrize("name,qtype,qid,rd,edns", [
    ("web.foo.com", 1, 0, False, 1232),
    ("_http._tcp.svc.foo.com", 33, 0xBEEF, True, 4096),
    ("1.0.168.192.in-addr.arpa", 12, 7, False, None),
    ("MiXeD.Foo.COM.", 1, 65535, True, 512),
])
def test_make_query_byte_identical(name, qtype, qid, rd, edns):
    got = port.make_query(name, qtype, qid=qid, rd=rd,
                          edns_payload=edns).encode()
    want = ref.make_query(name, qtype, qid=qid, rd=rd,
                          edns_payload=edns).encode()
    assert got == want


def test_patch_answer_wire_byte_identical():
    for wire in (GOLDEN.RESPONSE_SRV, GOLDEN.RESPONSE_A):
        for qid in (None, 0, 0x1234, 0xFFFF):
            for rd in (None, False, True):
                assert port.patch_answer_wire(wire, qid=qid, rd=rd) == \
                    ref.patch_answer_wire(wire, qid=qid, rd=rd)


# -- hypothesis round trips ------------------------------------------

label = st.text(alphabet="abcdefghijklmnopqrstuvwxyz0123456789-_",
                min_size=1, max_size=12)
dname = st.lists(label, min_size=1, max_size=4).map(".".join)
ttl = st.integers(min_value=0, max_value=2 ** 31 - 1)
u16 = st.integers(min_value=0, max_value=0xFFFF)
ipv4 = st.tuples(*[st.integers(0, 255)] * 4).map(
    lambda t: ".".join(map(str, t)))

record = st.one_of(
    st.builds(lambda n, t, a: ("ARecord", dict(name=n, ttl=t, address=a)),
              dname, ttl, ipv4),
    st.builds(lambda n, t, g: ("PTRRecord", dict(name=n, ttl=t, target=g)),
              dname, ttl, dname),
    st.builds(lambda n, t, p, w, o, g: ("SRVRecord", dict(
        name=n, ttl=t, priority=p, weight=w, port=o, target=g)),
        dname, ttl, u16, u16, u16, dname),
    st.builds(lambda n, t, m, r, s: ("SOARecord", dict(
        name=n, ttl=t, mname=m, rname=r, serial=s, refresh=3600,
        retry=900, expire=604800, minimum=60)),
        dname, ttl, dname, dname, st.integers(0, 2 ** 32 - 1)),
    st.builds(lambda n, t, x: ("TXTRecord", dict(
        name=n, ttl=t, texts=tuple(x))),
        dname, ttl, st.lists(st.text(
            alphabet="abcdefghij =;", max_size=30), min_size=1,
            max_size=3)),
)

message = st.fixed_dictionaries({
    "id": u16, "qr": st.booleans(), "aa": st.booleans(),
    "rd": st.booleans(), "rcode": st.sampled_from([0, 1, 2, 3, 4, 5]),
    "q": st.tuples(dname, st.sampled_from([1, 12, 33, 28, 16])),
    "answers": st.lists(record, max_size=6),
    "authorities": st.lists(record, max_size=2),
    "additionals": st.lists(record, max_size=4),
    "edns": st.one_of(st.none(), st.sampled_from([512, 1232, 4096])),
})


def build(mod, spec):
    m = mod.Message(id=spec["id"], qr=spec["qr"], aa=spec["aa"],
                    rd=spec["rd"], rcode=spec["rcode"])
    m.questions = [mod.Question(name=spec["q"][0], qtype=spec["q"][1])]
    for section in ("answers", "authorities", "additionals"):
        getattr(m, section).extend(
            getattr(mod, cls)(**kw) for cls, kw in spec[section])
    if spec["edns"]:
        m.additionals.append(mod.OPTRecord(
            name="", ttl=0, udp_payload_size=spec["edns"]))
    return m


@settings(max_examples=200, deadline=None)
@given(message)
def test_hypothesis_encode_decode_parity(spec):
    for max_size in (None, 512):
        got = build(port, spec).encode(max_size=max_size)
        want = build(ref, spec).encode(max_size=max_size)
        assert got == want
        assert decode_outcome(port, got) == decode_outcome(ref, want)


@settings(max_examples=300, deadline=None)
@given(st.binary(max_size=96))
def test_hypothesis_arbitrary_bytes_same_outcome(frame):
    assert decode_outcome(port, frame) == decode_outcome(ref, frame)

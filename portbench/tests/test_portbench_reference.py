"""The reference against a zone built by hand, and the verdict on
replies built by hand."""
import json
import struct

import pytest

from portbench.reference import dnswire
from portbench.reference.answers import ChurnLog, ZoneReference
from portbench.reference.judge import Judge, verdict


def rec(obj):
    return json.dumps(obj).encode()


ZONE = [
    ("/com", b""), ("/com/foo", b""),
    ("/com/foo/web", rec({"type": "host", "host": {"address": "192.0.2.1"}})),
    ("/com/foo/slow", rec({"type": "host", "ttl": 60,
                           "host": {"address": "192.0.2.2", "ttl": 90}})),
    ("/com/foo/svc", rec({"type": "service", "service": {
        "srvce": "_http", "proto": "_tcp", "port": 8080}})),
    ("/com/foo/svc/lb0", rec({"type": "load_balancer",
                              "load_balancer": {"address": "10.0.1.1"}})),
    ("/com/foo/svc/lb1", rec({"type": "load_balancer",
                              "load_balancer": {"address": "10.0.1.2"}})),
    ("/com/foo/svc/h0", rec({"type": "host", "host": {"address": "10.0.9.9"}})),
    ("/com/foo/c00", rec({"type": "host", "host": {"address": "10.9.0.0"}})),
]


@pytest.fixture
def ref():
    return ZoneReference("foo.com", ZONE)


def test_host_a_and_its_ttl(ref):
    e = ref.expect("web.foo.com", dnswire.A)
    assert e.rcode == dnswire.NOERROR
    assert e.answers == {("web.foo.com", dnswire.A, 30, "192.0.2.1")}
    assert ref.expect("slow.foo.com", dnswire.A).answers == {
        ("slow.foo.com", dnswire.A, 90, "192.0.2.2")}


def test_service_a_is_every_member_and_no_host_child(ref):
    e = ref.expect("svc.foo.com", dnswire.A)
    assert {a[3] for a in e.answers} == {"10.0.1.1", "10.0.1.2"}


def test_srv_has_a_record_and_glue_per_member(ref):
    e = ref.expect("_http._tcp.svc.foo.com", dnswire.SRV)
    assert e.answers == {
        ("_http._tcp.svc.foo.com", dnswire.SRV, 30,
         (8080, "lb0.svc.foo.com", 0, 10)),
        ("_http._tcp.svc.foo.com", dnswire.SRV, 30,
         (8080, "lb1.svc.foo.com", 0, 10))}
    assert e.additionals == {("lb0.svc.foo.com", dnswire.A, 30, "10.0.1.1"),
                             ("lb1.svc.foo.com", dnswire.A, 30, "10.0.1.2")}
    assert ref.expect("_ftp._tcp.svc.foo.com",
                      dnswire.SRV).rcode == dnswire.NXDOMAIN


def test_ptr_and_the_refused_names(ref):
    e = ref.expect("1.2.0.192.in-addr.arpa", dnswire.PTR)
    assert e.answers == {("1.2.0.192.in-addr.arpa", dnswire.PTR, 30,
                          "web.foo.com")}
    for name, qtype in (("nope.foo.com", dnswire.A),
                        ("web.bar.com", dnswire.A),
                        ("9.9.9.9.in-addr.arpa", dnswire.PTR)):
        assert ref.expect(name, qtype).rcode == dnswire.REFUSED


def reply(qid, name, qtype, answers, additionals=(), rcode=0, tc=0):
    """A reply assembled by hand, without name compression."""
    flags = 0x8000 | (tc << 9) | rcode
    out = struct.pack(">HHHHHH", qid, flags, 1, len(answers), 0,
                      len(additionals))
    out += dnswire.encode_name(name) + struct.pack(">HH", qtype, 1)
    for rname, rtype, ttl, value in list(answers) + list(additionals):
        if rtype == dnswire.A:
            rdata = bytes(int(x) for x in value.split("."))
        elif rtype == dnswire.PTR:
            rdata = dnswire.encode_name(value)
        else:
            port, target, prio, weight = value
            rdata = struct.pack(">HHH", prio, weight, port) \
                + dnswire.encode_name(target)
        out += dnswire.encode_name(rname) + struct.pack(
            ">HHIH", rtype, 1, ttl, len(rdata)) + rdata
    return out


def test_a_right_reply_in_any_order_passes(ref):
    want = ref.expect("_http._tcp.svc.foo.com", dnswire.SRV)
    data = reply(7, "_http._tcp.svc.foo.com", dnswire.SRV,
                 sorted(want.answers, reverse=True),
                 sorted(want.additionals))
    assert verdict(data, 7, "_http._tcp.svc.foo.com", dnswire.SRV,
                   [want]) == ""


@pytest.mark.parametrize("fault", ["address", "ttl", "rcode", "tc", "id",
                                   "missing", "extra", "question", "cut"])
def test_a_wrong_reply_fails(ref, fault):
    want = ref.expect("svc.foo.com", dnswire.A)
    answers = sorted(want.answers)
    kw = {}
    qid, qname = 9, "svc.foo.com"
    if fault == "address":
        answers[0] = answers[0][:3] + ("10.0.1.3",)
    elif fault == "ttl":
        answers[0] = answers[0][:2] + (31,) + answers[0][3:]
    elif fault == "rcode":
        kw["rcode"] = dnswire.REFUSED
    elif fault == "tc":
        kw["tc"] = 1
    elif fault == "id":
        qid = 10
    elif fault == "missing":
        answers = answers[:1]
    elif fault == "extra":
        answers = answers + answers[:1]
    elif fault == "question":
        qname = "web.foo.com"
    data = reply(qid, qname, dnswire.A, answers, **kw)
    if fault == "cut":
        data = data[:-2]
    assert verdict(data, 9, "svc.foo.com", dnswire.A, [want]) != ""


def test_a_churned_name_may_serve_what_the_store_held_in_time():
    ref = ZoneReference("foo.com", ZONE)
    log = ChurnLog(rec({"type": "host", "host": {"address": "10.9.0.0"}}))
    # write 1 sent at t=10, acknowledged at 10.01; write 2 at 20 / 20.01
    log.add(10.0, 10.01, rec({"type": "host", "host": {"address": "10.9.0.1"}}))
    log.add(20.0, 20.01, rec({"type": "host", "host": {"address": "10.9.0.2"}}))
    judge = Judge(ref, {"c00.foo.com": log}, fresh_limit=5.0)

    def ask(addr, t_sent, t_reply):
        data = reply(1, "c00.foo.com", dnswire.A,
                     [("c00.foo.com", dnswire.A, 30, addr)])
        return judge(data, 1, "c00.foo.com", dnswire.A, t_sent, t_reply)

    assert ask("10.9.0.0", 12.0, 12.1) == ""      # within 5 s of write 1
    assert ask("10.9.0.0", 16.0, 16.1) != ""      # older than the limit
    assert ask("10.9.0.1", 16.0, 16.1) == ""
    assert ask("10.9.0.2", 16.0, 16.1) != ""      # not yet written
    assert ask("10.9.0.2", 19.9, 20.005) == ""    # sent before the reply
    assert ask("10.9.0.1", 25.5, 25.6) != ""      # superseded > 5 s ago

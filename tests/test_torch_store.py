"""Store-mirror parity: ``binder_torch.store`` against ``binder_tpu.store``.

One scripted FakeStore mutation sequence drives a ``MirrorCache`` from
each package.  After every step the two mirrors must hold the same
names, records and reverse (PTR) index, have emitted the same
invalidation tags, and agree on generation and epoch.  All comparisons
are exact.  The port's ``load_state`` must rebuild a reference tree
exactly, and its name interning must keep one object per name.
"""
import json
import os

import pytest

from binder_torch.store import FakeStore as PortStore
from binder_torch.store import MirrorCache as PortCache
from binder_torch.store import fake as port_fake
from binder_torch.store import names as port_names
from binder_tpu.store import FakeStore as RefStore
from binder_tpu.store import MirrorCache as RefCache
from binder_tpu.store import fake as ref_fake
from binder_tpu.store import names as ref_names

DOMAIN = "foo.com"
FIXTURE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "etc", "fixture.json")


def fixture():
    with open(FIXTURE) as f:
        return json.load(f)


def host(addr, **extra):
    return {"type": "host", "host": dict(address=addr, **extra)}


def lb(addr):
    return {"type": "load_balancer", "load_balancer": {"address": addr}}


SERVICE = {"type": "service",
           "service": {"srvce": "_http", "proto": "_tcp", "port": 8080},
           "ttl": 120}

#: (method, args) applied to both stores, in order
SCRIPT = [
    ("start_session", ()),
    ("put_json", ("/com/foo/web", host("192.168.0.1"))),
    ("put_json", ("/com/foo/svc", SERVICE)),
    ("put_json", ("/com/foo/svc/lb0", lb("10.0.1.1"))),
    ("put_json", ("/com/foo/svc/lb1", lb("10.0.1.2"))),
    ("put_json", ("/com/foo/web", host("192.168.0.2", ttl=45))),
    ("put_json", ("/com/foo/v6", host("2001:DB8:0::1"))),
    ("put_json", ("/com/foo/twin", host("10.0.1.1"))),
    ("set_data", ("/com/foo/svc/lb1", b"not json")),
    ("set_data", ("/com/foo/svc/lb1", b"42")),
    ("put_json", ("/com/foo/svc/lb1", {"type": "service"})),
    ("put_json", ("/com/foo/db", {"type": "database",
                                  "database": {"primary": "tcp://x"}})),
    ("delete", ("/com/foo/svc/lb0",)),
    ("put_json", ("/com/foo/Mixed", host("10.9.9.9"))),
    ("expire_session", ()),
    ("rmr", ("/com/foo/svc",)),
    ("put_json", ("/com/foo/svc/lb7", lb("10.0.1.7"))),
    ("lose_session", ()),
    ("start_session", ()),
    ("delete", ("/com/foo/twin",)),
]


class Side:
    def __init__(self, store_cls, cache_cls):
        self.store = store_cls()
        self.cache = cache_cls(self.store, DOMAIN)
        self.tags = []
        self.cache.on_invalidate(lambda tags: self.tags.append(
            sorted(tags)))

    def apply(self, method, args):
        getattr(self.store, method)(*args)

    def snapshot(self):
        c = self.cache
        tags, self.tags = self.tags, []
        return {
            "names": sorted(c.nodes),
            "records": {d: (n.data, n.ip, n.path,
                            sorted(k.domain for k in n.children))
                        for d, n in sorted(c.nodes.items())},
            "reverse": {ip: n.domain
                        for ip, n in sorted(c.rev_lookup.items())},
            "tags": tags,
            "gen": c.gen, "epoch": c.epoch, "ready": c.is_ready(),
            "connected": self.store.is_connected(),
        }


def test_scripted_mutations_mirror_identically():
    port, ref = Side(PortStore, PortCache), Side(RefStore, RefCache)
    for step, (method, args) in enumerate(SCRIPT):
        port.apply(method, args)
        ref.apply(method, args)
        got, want = port.snapshot(), ref.snapshot()
        assert got == want, (step, method, args)
        # mirrored names are their own canonical objects
        for d, node in port.cache.nodes.items():
            assert port.cache.canon(d) is node.domain
    assert want["reverse"]["10.0.1.7"] == "lb7.svc.foo.com"


def walk(node, prefix=""):
    """A reference FakeStore tree as a plain ``path -> data`` mapping."""
    out = {}
    for label, kid in node.children.items():
        path = prefix + "/" + label
        out[path] = kid.data
        out.update(walk(kid, path))
    return out


def test_load_state_rebuilds_reference_tree():
    ref = RefStore()
    for path, obj in fixture().items():
        ref.put_json(path, obj)
    ref_fake.populate_synthetic(ref, DOMAIN, hosts=3000)
    port = PortStore()
    assert port_fake.load_state(port, walk(ref._root)) == len(
        walk(ref._root))
    assert walk(port._root) == walk(ref._root)
    # the port's own synthetic build goes through load_state too
    again = PortStore()
    port_fake.load_state(again, fixture())
    assert port_fake.populate_synthetic(again, DOMAIN, hosts=3000) == 3000
    assert walk(again._root) == walk(ref._root)
    assert list(walk(again._root)) == list(walk(ref._root))


def test_load_state_mirrors_like_put_json():
    nodes = {"/com/foo/web": host("192.168.0.1"),
             "/com/foo/raw": b'{"type": "host", "host": '
                             b'{"address": "10.1.1.1"}}'}
    port = PortStore()
    cache = PortCache(port, DOMAIN)
    port_fake.load_state(port, nodes)
    port.start_session()
    assert cache.lookup("web.foo.com").ip == "192.168.0.1"
    assert cache.reverse_lookup("10.1.1.1").domain == "raw.foo.com"


@pytest.mark.parametrize("parsed", [
    host("10.0.0.1"),
    host("10.0.0.1", ttl=5),
    {"type": "load_balancer", "load_balancer": {"address": "10.0.0.2"},
     "ttl": 9},
    {"type": "host", "host": {"address": "10.0.0.3", "extra": 1}},
    SERVICE,
    ["not", "a", "record"],
    None,
])
def test_compact_record_parity(parsed):
    got = port_names.compact_record(parsed)
    want = ref_names.compact_record(parsed)
    assert got == want
    assert port_names.expand_record(got) == ref_names.expand_record(want)


def test_name_pool_interns_one_object_per_name():
    # one object per name: equal strings built apart intern to the
    # pool's first copy, in a pool of the port's own
    pool = port_names.NamePool()
    a = "".join(["web.", "foo.com"])
    b = "".join(["web.fo", "o.com"])
    assert a is not b
    assert pool.intern(a) is a and pool.intern(b) is a
    assert port_names.POOL is not ref_names.POOL

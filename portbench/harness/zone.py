"""The zone every cell serves, made from a configuration's ``zone`` block
and the run's seed.

Copied from ``chip_smoke.py`` at commit 0ba68a39 (``host_name``,
``host_addr``, ``zone_fixture``, ``zone_nodes``, ``churn_name``,
``churn_addr``, ``host_json``: the synthetic hosts in racks, the shipped
fixture, the ``big`` service and the churn names).  One change: the
seed permutes which address each synthetic host holds, so that two seeds
serve different data of the same shape and size.
"""
from __future__ import annotations

import json

import numpy as np


def racks_for(hosts: int) -> int:
    """``populate_synthetic``'s rack count: one rack per 512 hosts."""
    return max(1, min(1024, hosts // 512))


def host_name(i: int, racks: int, domain: str, sub: str) -> str:
    return f"h{i:06d}.r{i % racks:04d}.{sub}.{domain}"


def host_addr(i: int) -> str:
    return f"10.{(i >> 16) & 255}.{(i >> 8) & 255}.{i & 255}"


def churn_name(k: int, domain: str) -> str:
    return f"c{k:02d}.churn.{domain}"


def churn_path(k: int, domain: str) -> str:
    return domain_path(churn_name(k, domain))


def churn_addr(w: int) -> str:
    """Address of churn write ``w`` (0, 1, ...): monotone in ``w``, so a
    reader can tell a newer write from an older one."""
    return f"10.{210 + (w >> 16)}.{(w >> 8) & 255}.{w & 255}"


def churn_write(addr: str) -> int:
    """The write ``w`` whose address is ``addr``; -1 for an address that
    no churn write gives (the names' first values)."""
    _, b, c, d = (int(x) for x in addr.split("."))
    return ((b - 210) << 16) | (c << 8) | d if b >= 210 else -1


def churn_first_addr(k: int) -> str:
    return f"10.209.0.{k}"


def host_json(addr: str) -> bytes:
    return b'{"type": "host", "host": {"address": "%s"}}' % addr.encode()


def domain_path(name: str) -> str:
    """The znode path of a DNS name: ``a.b.foo.com`` -> ``/com/foo/b/a``."""
    return "/" + "/".join(reversed(name.split(".")))


class Zone:
    """The zone of one run: ``nodes`` is ``[(path, data)]`` with parents
    first, as the ZooKeeper stand-in loads it; ``addr[i]`` is synthetic
    host ``i``'s address."""

    def __init__(self, spec: dict, seed: int):
        self.domain = spec["domain"]
        self.sub = spec["subtree"]
        self.hosts = int(spec["hosts"])
        self.racks = racks_for(self.hosts)
        self.churn_names = int(spec["churn_names"])
        perm = np.random.default_rng(seed).permutation(self.hosts)
        self.addr = [host_addr(int(j)) for j in perm]
        base = "/" + "/".join(reversed(self.domain.split(".")))
        leaves = {}
        for path, obj in spec["fixture"].items():
            leaves[path] = json.dumps(obj).encode()
        for name, svc in spec.get("services", {}).items():
            leaves[f"{base}/{name}"] = json.dumps(svc["service"]).encode()
            for k in range(int(svc["instances"])):
                leaves[f"{base}/{name}/lb{k}"] = json.dumps({
                    "type": "load_balancer",
                    "load_balancer": {
                        "address": svc["address_format"].format(k + 1)},
                }).encode()
        for k in range(self.churn_names):
            leaves[churn_path(k, self.domain)] = host_json(
                churn_first_addr(k))
        for r in range(self.racks):
            leaves[f"{base}/{self.sub}/r{r:04d}"] = json.dumps(
                spec["rack_service"]).encode()
        for i in range(self.hosts):
            leaves[f"{base}/{self.sub}/r{i % self.racks:04d}/h{i:06d}"] = \
                host_json(self.addr[i])
        nodes = {}
        for path, data in leaves.items():
            parts = path.split("/")[1:]
            for d in range(1, len(parts)):
                nodes.setdefault("/" + "/".join(parts[:d]), b"")
            nodes[path] = data
        self.nodes = sorted(nodes.items(), key=lambda kv: kv[0].count("/"))

    def host_name(self, i: int) -> str:
        return host_name(i, self.racks, self.domain, self.sub)

    def names(self) -> int:
        """The names at and under the domain's znode: a worker's mirror
        holds each of them once it holds the zone."""
        base = domain_path(self.domain)
        return sum(1 for path, _ in self.nodes
                   if path == base or path.startswith(base + "/"))

    def host_like_leaves(self) -> int:
        """Znodes holding an address record: each is one A and one PTR
        answer in a worker's native zone table when it is resident."""
        n = 0
        for _, data in self.nodes:
            if data[:1] == b"{":
                rec = json.loads(data)
                sub = rec.get(rec.get("type"), {})
                n += isinstance(sub, dict) and "address" in sub
        return n

    def write_tree(self, path: str) -> None:
        """The stand-in's bulk-load file: ``[[path, data], ...]``."""
        with open(path, "w") as f:
            json.dump([[p, d.decode()] for p, d in self.nodes], f)

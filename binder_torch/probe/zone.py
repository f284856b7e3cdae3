"""Zone-scale probe: mirror RSS/build/mutation-latency at N names.

The port's counterpart of ``tools/zone_probe.py``: the same harness,
measurements and JSON keys, on ``binder_torch``.

Builds a synthetic zone (``store.fake.populate_synthetic``) in a fake
store, mirrors it, wires the answer-cache + mutation-time precompiler
the way BinderServer does, and measures:

- store/mirror build wall time and RSS delta (→ bytes per name);
- single-name mutation → re-rendered compiled answer latency
  (p50/p99 over a sample spread across the zone), with a byte-parity
  check of every re-rendered wire against a fresh engine render;
- watch-storm recovery: a burst of mutations against served names,
  time until the precompile backlog drains (event-loop mode, so the
  bounded drain is what's being measured);
- chunked session rebuild: wall time, chunk count, the worst
  event-loop stall observed while it streamed, and proof that lookups
  kept serving mid-rebuild;
- interned-name pool stats.

Usage:  python -m binder_torch.probe.zone <names> [mutations] [storm]
Prints one JSON line.
"""
import asyncio
import gc
import json
import sys
import time

from binder_torch.dns.wire import Type
from binder_torch.resolver.answer_cache import AnswerCache
from binder_torch.resolver.engine import Resolver
from binder_torch.resolver.precompile import Precompiler
from binder_torch.store import FakeStore, MirrorCache
from binder_torch.store.fake import populate_synthetic
from binder_torch.store.names import POOL

DOMAIN = "bench.zone"


def rss_kb() -> int:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1])
    return 0


def host_path(i: int, racks: int) -> str:
    return f"/zone/bench/zs/r{i % racks:04d}/h{i:06d}"


def host_name(i: int, racks: int) -> str:
    return f"h{i:06d}.r{i % racks:04d}.zs.{DOMAIN}"


class Harness:
    """The answer-path wiring of BinderServer, minus transports: an
    AnswerCache + Resolver + Precompiler fed by the mirror's per-name
    invalidation events, so a store mutation exercises the REAL
    mirror → drop → re-render chain."""

    def __init__(self, cache: MirrorCache, cache_size: int = 65536):
        self.cache = cache
        self.answer_cache = AnswerCache(size=cache_size,
                                        compiled_size=cache_size,
                                        intern=cache.canon)
        self.resolver = Resolver(cache, dns_domain=DOMAIN)
        self.pc = Precompiler(resolver=self.resolver,
                              answer_cache=self.answer_cache,
                              zk_cache=cache, summarize=str)
        self.pc.MAX_PENDING_CAP = cache_size
        cache.on_invalidate(self._on_invalidate)

    def _on_invalidate(self, tags) -> None:
        dropped = []
        for tag in tags:
            self.answer_cache.invalidate_tag(tag, dropped=dropped)
        if dropped:
            self.pc.enqueue(dropped)

    def prime(self, qname: str) -> None:
        """Install serving evidence for a name (what a real query
        would do), so its mutations are eagerly re-rendered."""
        self.pc._compile_one((Type.A, qname),
                             evidence_at=time.monotonic())

    def compiled_wire(self, qname: str):
        hit = self.answer_cache.get_compiled(Type.A, qname,
                                             self.cache.epoch)
        return None if hit is None else hit[0][0]

    def engine_wire(self, qname: str):
        plan = self.resolver.plan(qname, Type.A)
        answers = [r for g in plan.groups for r in g[0]]
        adds = [r for g in plan.groups for r in g[1]]
        return Precompiler._render(qname, Type.A, plan, answers, adds,
                                   False)


def probe(n: int, mutations: int = 200, storm: int = 2000) -> dict:
    racks = max(1, min(1024, n // 512))
    out = {"names": n, "racks": racks}

    gc.collect()
    rss0 = rss_kb()
    t0 = time.perf_counter()
    store = FakeStore()
    populate_synthetic(store, DOMAIN, n, racks=racks)
    out["store_build_s"] = round(time.perf_counter() - t0, 3)
    gc.collect()
    rss1 = rss_kb()
    out["store_rss_kb"] = rss1 - rss0

    t0 = time.perf_counter()
    cache = MirrorCache(store, DOMAIN)
    store.start_session()
    out["mirror_build_s"] = round(time.perf_counter() - t0, 3)
    gc.collect()
    rss2 = rss_kb()
    out["mirror_rss_kb"] = rss2 - rss1
    out["mirror_rss_per_name_bytes"] = round(
        (rss2 - rss1) * 1024 / max(1, n), 1)
    out["mirror_nodes"] = len(cache.nodes)

    h = Harness(cache)

    # single-name mutation -> re-rendered answer, sampled across the
    # zone; inline (no loop), so the timing is the full synchronous
    # mirror -> invalidate -> re-render chain and nothing else
    step = max(1, n // max(1, mutations))
    sample = list(range(0, n, step))[:mutations]
    for i in sample:
        h.prime(host_name(i, racks))
    lat_us = []
    parity_failures = 0
    for j, i in enumerate(sample):
        addr = f"10.200.{(j >> 8) & 255}.{j & 255}"
        body = json.dumps({"type": "host",
                           "host": {"address": addr}}).encode()
        t0 = time.perf_counter()
        store.set_data(host_path(i, racks), body)
        lat_us.append((time.perf_counter() - t0) * 1e6)
        name = host_name(i, racks)
        cw = h.compiled_wire(name)
        if cw is None or cw != h.engine_wire(name):
            parity_failures += 1
    lat_us.sort()
    out["mutation_p50_us"] = round(lat_us[len(lat_us) // 2], 1)
    out["mutation_p99_us"] = round(
        lat_us[min(len(lat_us) - 1, int(len(lat_us) * 0.99))], 1)
    out["mutation_samples"] = len(sample)
    out["parity_failures"] = parity_failures

    # watch storm + chunked rebuild need a live event loop (the
    # bounded drains are the thing being measured)
    async def loop_phase():
        res = {}
        burst = min(storm, n)
        step_b = max(1, n // max(1, burst))
        burst_idx = list(range(0, n, step_b))[:burst]
        for i in burst_idx:
            h.prime(host_name(i, racks))
        t0 = time.perf_counter()
        for j, i in enumerate(burst_idx):
            store.set_data(
                host_path(i, racks),
                b'{"type": "host", "host": {"address": "10.201.%d.%d"}}'
                % ((j >> 8) & 255, j & 255))
        res["storm_mutate_s"] = round(time.perf_counter() - t0, 3)
        while h.pc._pending:
            await asyncio.sleep(0)
        res["storm_recovery_s"] = round(time.perf_counter() - t0, 3)
        res["storm_burst"] = len(burst_idx)
        res["storm_shed"] = h.pc.shed

        # chunked session rebuild: serving continues, loop stays live
        loop = asyncio.get_running_loop()
        stalls = {"max": 0.0}
        probe_name = host_name(burst_idx[0], racks)
        served = {"mid": 0, "miss": 0}
        done = {"v": False}

        async def sampler():
            while not done["v"]:
                t = loop.time()
                await asyncio.sleep(0.002)
                lag = loop.time() - t - 0.002
                if lag > stalls["max"]:
                    stalls["max"] = lag
                if cache.rebuild_pending():
                    if cache.lookup(probe_name) is not None:
                        served["mid"] += 1
                    else:
                        served["miss"] += 1

        task = asyncio.ensure_future(sampler())
        t0 = time.perf_counter()
        chunks0 = cache.rebuild_chunks
        store.expire_session()
        while cache.rebuild_pending():
            await asyncio.sleep(0.001)
        res["rebuild_s"] = round(time.perf_counter() - t0, 3)
        res["rebuild_chunks"] = cache.rebuild_chunks - chunks0
        done["v"] = True
        await task
        res["rebuild_max_loop_lag_ms"] = round(stalls["max"] * 1000, 2)
        res["rebuild_served_mid"] = served["mid"]
        res["rebuild_miss_mid"] = served["miss"]
        return res

    out.update(asyncio.run(loop_phase()))
    out["pool"] = POOL.stats()
    out["compiled"] = h.pc.compiled
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if argv else 100000
    mutations = int(argv[1]) if len(argv) > 1 else 200
    storm = int(argv[2]) if len(argv) > 2 else 2000
    print(json.dumps(probe(n, mutations, storm)))
    return 0


if __name__ == "__main__":
    sys.exit(main())

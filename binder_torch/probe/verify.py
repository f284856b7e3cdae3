"""Verify-plane probe: mutation→glass latency + checker cost at N names.

The port's counterpart of ``tools/verify_probe.py``: the same
measurements and JSON keys, on ``binder_torch``, reusing the answer-path
harness of :mod:`binder_torch.probe.zone`.

Builds a synthetic zone, wires the Harness (mirror → invalidate →
precompile, the BinderServer answer path minus transports), and
measures:

- a control mutation burst with NO verifier wired: the baseline
  single-name mutation latency (p50/p99) at this zone size;
- the same burst with the full verify plane wired — propagation
  tracer on the mirror + precompiler, incremental checker fed by the
  per-name invalidation tags (no event loop, so the checker drains
  INLINE and its entire cost lands in the measured latency — the
  honest worst case; in the server it amortizes across loop passes);
- the per-stage mutation→glass propagation figures off the tracer
  itself (`mirror-apply` / `precompile-render` / `compiled-install`;
  every figure end-to-end from the store event, exactly what
  `binder_propagation_seconds` records in production) — the
  O(delta) claim is these staying flat from 10k to 1M names;
- one full background-audit pass: wall time, slice count, the worst
  single slice (the loop-stall bound — budget is 2 ms), checks by
  invariant, and the violation count, which must be ZERO on an
  uncorrupted zone at any size.

Usage:  python -m binder_torch.probe.verify <names> [mutations] [sample]
Prints one JSON line.
"""
import json
import sys
import time

from binder_torch.probe.zone import DOMAIN, Harness, host_name, host_path
from binder_torch.store import FakeStore, MirrorCache
from binder_torch.store.fake import populate_synthetic
from binder_torch.verify import Verifier


def _pcts(lat_us):
    lat_us = sorted(lat_us)
    return (round(lat_us[len(lat_us) // 2], 1),
            round(lat_us[min(len(lat_us) - 1,
                             int(len(lat_us) * 0.99))], 1))


def probe(n: int, mutations: int = 400, sample: int = 0) -> dict:
    racks = max(1, min(1024, n // 512))
    if sample <= 0:
        # full-coverage pass at small sizes; at zone scale sample the
        # audit the way production would (residue rotation still
        # covers everything across `sample` passes)
        sample = 1 if n <= 20000 else 8
    out = {"names": n, "audit_sample": sample}

    store = FakeStore()
    populate_synthetic(store, DOMAIN, n, racks=racks)
    cache = MirrorCache(store, DOMAIN)
    store.start_session()
    h = Harness(cache)

    step = max(1, n // max(1, mutations))
    idx = list(range(0, n, step))[:mutations]
    for i in idx:
        h.prime(host_name(i, racks))

    def burst(octet: int):
        lat = []
        for j, i in enumerate(idx):
            body = json.dumps(
                {"type": "host",
                 "host": {"address":
                          f"10.{octet}.{(j >> 8) & 255}.{j & 255}"}}
            ).encode()
            t0 = time.perf_counter()
            store.set_data(host_path(i, racks), body)
            lat.append((time.perf_counter() - t0) * 1e6)
        return lat

    # control: the bare mirror → invalidate → re-render chain
    p50, p99 = _pcts(burst(210))
    out["mutation_p50_us"] = p50
    out["mutation_p99_us"] = p99
    out["mutation_samples"] = len(idx)

    # wire the verify plane the way BinderServer does (server.py):
    # tracer on the mirror (store-event stamp + mirror-apply) and on
    # the precompiler (render/install stages), checker fed by the
    # same invalidation tags the answer cache drops
    vf = Verifier(zk_cache=cache, answer_cache=h.answer_cache,
                  resolver=h.resolver, precompiler=h.pc,
                  config={"auditSample": sample})
    cache.tracer = vf.tracer
    h.pc.tracer = vf.tracer
    cache.on_invalidate(vf.enqueue_tags)

    p50v, p99v = _pcts(burst(211))
    out["mutation_checked_p50_us"] = p50v
    out["mutation_checked_p99_us"] = p99v
    out["mutation_checked_vs_control"] = round(
        p50v / p50, 3) if p50 else None

    tr = vf.tracer.introspect()
    out["propagation"] = {
        stage: {"count": s["count"],
                "p50_us": round(s["p50_seconds"] * 1e6, 1),
                "p99_us": round(s["p99_seconds"] * 1e6, 1)}
        for stage, s in tr["stages"].items() if s["count"]}

    # one full audit pass, slice by slice, worst slice recorded (the
    # production audit runs exactly these slices off a loop timer —
    # the worst slice IS the stall it can inject)
    worst = 0.0
    slices = 0
    t0 = time.perf_counter()
    vf.audit_slice()
    slices += 1
    while vf._audit_work:
        s0 = time.perf_counter()
        vf.audit_slice()
        worst = max(worst, time.perf_counter() - s0)
        slices += 1
    out["audit_wall_s"] = round(time.perf_counter() - t0, 3)
    out["audit_slices"] = slices
    out["audit_worst_slice_ms"] = round(worst * 1000, 3)
    snap = vf.introspect()
    out["checks"] = {k: v for k, v in snap["checks"].items() if v}
    out["violations"] = sum(snap["violations"].values())
    out["skipped"] = {k: v for k, v in snap["skipped"].items() if v}
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if argv else 10000
    mutations = int(argv[1]) if len(argv) > 1 else 400
    sample = int(argv[2]) if len(argv) > 2 else 0
    print(json.dumps(probe(n, mutations, sample)))
    return 0


if __name__ == "__main__":
    sys.exit(main())

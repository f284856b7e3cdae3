"""The hostile and population phases of ``chip_smoke.py``, rehearsed on
the CPU at a small zone, each in a fresh interpreter.

hostile: one port server with the reference smoke's RRL limit, a paced
legit control, then ``python -m binder_torch.loadgen.hostile``'s flood
(4 s here, 10 s on the chip) with the same probe under it.  population:
leg A, ``run_population`` against RRL v2 with the direct cohort
allowlisted (5 s here); leg B, a 2-worker group rolled by the chaos
block's ``worker-roll`` and then by SIGHUP under a spoofed flood, with a
closed-loop probe throughout.  Every gate of each phase must hold; in
particular leg B's flood must engage the workers' limiter, which the
reference smoke's 400-packet flood cannot do at its own burst of 120 (a
flood /24 sees 100 packets): on the sampled C lane it was limited in 4 of
6 rehearsals, and an exact limiter (the Python lane, every packet judged
at cost 1) never limits it.
"""
import asyncio
import json
import os
import subprocess
import sys

import chip_smoke
from binder_torch.chaos import ChaosDriver, FaultPlan
from binder_torch.chaos.plan import FLOOD_PREFIXES
from binder_torch.metrics.collector import MetricsCollector
from binder_torch.server import BinderServer
from binder_torch.store import FakeStore, MirrorCache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PHASE = """
import json, os, sys
sys.path.insert(0, {root!r})
import chip_smoke
native = {{}}
chip_smoke.{call}
print(json.dumps({{"native": native,
                  "left": chip_smoke.descendants(os.getpid())}}))
"""


def run_phase(call: str, key: str):
    out = subprocess.run(
        [sys.executable, "-c", PHASE.format(root=ROOT, call=call)],
        cwd=ROOT, capture_output=True, timeout=240)
    lines = out.stdout.decode().splitlines()
    said = "\n".join(lines) + "\n" + out.stderr.decode()[-3000:]
    assert out.returncode == 0, said
    report = json.loads(next(x for x in lines
                             if x.startswith('{"' + key + '"')))[key]
    tail = json.loads(lines[-1])
    assert tail["left"] == [], said
    return report, tail["native"], said


def test_chip_smoke_hostile_phase_on_the_cpu():
    report, native, said = run_phase(
        "hostile_phase(hosts=2000, duration=4.0, native=native)", "hostile")
    assert report["errors"] == 0, said
    assert report["goodput_ratio"] >= 0.5, said
    spoof = report["categories"]["spoof"]
    assert spoof["slipped"] > 0 and spoof["dropped"] > 0, said
    assert report["categories"]["malformed"]["sent"] > 0, said
    assert report["rrl"]["dropped_total"] > 0, said
    assert report["shed_response_ratelimit"] > 0, said
    assert 0 < report["rrl"]["buckets"] <= 512, said
    assert native["hostile"]["binder_zone_entries"] > 0, said


def test_chip_smoke_population_phase_on_the_cpu():
    report, native, said = run_phase(
        "population_phase(hosts=2000, duration=5.0, native=native)",
        "population")
    assert report["errors"] == 0, said
    a, b = report["leg_a"], report["leg_b"]
    assert a["farm_goodput_ratio"] >= 0.5, said
    assert a["rrl_false_positive_rate"] <= 0.10, said
    assert a["rrl"]["adaptations_total"] >= 1, said
    assert a["rrl"]["allowlisted_total"] > 0, said
    assert native["population"]["binder_zone_entries"] > 0, said
    assert b["rolls_total"] == 4 and b["roll_aborts"] == 0, said
    assert b["probe"]["lost"] == 0, said
    assert b["quiesced_clean"] >= 4, said
    # the flood is past the burst on whichever worker a socket hashes to
    assert b["rrl_dropped"] > 0, said


def test_roll_flood_is_past_the_burst_of_an_exact_limiter():
    """Leg B's ``rrl-flood`` (the n of ``chip_smoke.ROLL_PLAN``), fired
    by the port's chaos driver at one server on the Python lane, where
    the limiter judges every packet: each of the flood's sockets alone
    sends more than the burst, and the flood is limited."""
    plan = FaultPlan.parse(chip_smoke.ROLL_PLAN)
    n = int(next(kw for _, action, kw in plan.timeline
                 if action == "rrl-flood")["n"])
    burst = chip_smoke.POP_RRL["burst"]
    assert n // (2 * len(FLOOD_PREFIXES)) > burst

    async def run():
        store = FakeStore()
        cache = MirrorCache(store, "foo.com")
        store.put_json("/com/foo/web",
                       {"type": "host", "host": {"address": "10.0.0.1"}})
        store.start_session()
        server = BinderServer(
            zk_cache=cache, dns_domain="foo.com", datacenter_name="dc0",
            host="127.0.0.1", port=0, collector=MetricsCollector(),
            query_log=False,
            rrl=dict(chip_smoke.POP_RRL, allowlist=["127.0.0.0/24"]))
        await server.start()
        try:
            assert server.engine.fastpath is None
            driver = ChaosDriver(FaultPlan(), udp_target=(
                "127.0.0.1", server.udp_port, "web.foo.com"))
            loop = asyncio.get_running_loop()
            t0 = loop.time()
            # sent from a thread, so the server reads while it lands
            await loop.run_in_executor(None, driver.apply, "rrl-flood",
                                       {"n": n})
            await asyncio.sleep(0.3)
            rrl = server._rrl
            return (rrl.responses, rrl.dropped + rrl.slipped,
                    loop.time() - t0)
        finally:
            await server.stop()

    with chip_smoke.python_lane():
        responses, limited, elapsed = asyncio.run(run())
    # each flood /24 is answered at most its burst and what the rate
    # refilled while the flood lasted; the rest is limited
    rate = chip_smoke.POP_RRL["responsesPerSecond"]
    assert responses <= len(FLOOD_PREFIXES) * (burst + rate * elapsed)
    assert limited > 0

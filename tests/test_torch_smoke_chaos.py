"""The chaos phase of ``chip_smoke.py``, rehearsed on the CPU at a small
zone (its own file: the phase runs its 26 s plan in full).

Leg (a): a 4-worker ``python -m binder_torch.main`` group over the fake
store with a ``chaos`` block scripting every supervisor-side action,
under the 16-socket stream; leg (b): recursion through a
``ChaosUpstream`` under loss, a dead peer and recovery, in process.
Every gate of the phase must hold.
"""
import json
import os
import subprocess
import sys

CHAOS_SMALL = """
import json, os, sys
sys.path.insert(0, {root!r})
import chip_smoke
native = {{}}
chip_smoke.chaos_phase(hosts=2000, upstream_s=6.0, native=native)
print(json.dumps({{"native": native,
                  "left": chip_smoke.descendants(os.getpid())}}))
"""


def test_chip_smoke_chaos_phase_on_the_cpu():
    # the smoke's chaos phase at a small zone: every supervisor-side
    # action against a 4-worker group under the stream, then the
    # in-process upstream leg
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-c", CHAOS_SMALL.format(root=root)],
        cwd=root, capture_output=True, timeout=300)
    lines = out.stdout.decode().splitlines()
    assert out.returncode == 0, (lines[-8:], out.stderr.decode()[-3000:])
    group = json.loads(next(x for x in lines
                            if x.startswith('{"chaos_group"')))
    report = group["chaos_group"]
    assert report["errors"] == 0 and report["left_after_drain"] == []
    assert len(report["injected"]) == 11
    stale = report["stale"]
    assert stale["data_past_cap"] == 0 and stale["stale_answers"] > 0
    assert stale["refusals_past_cap"] > 0
    assert report["digest_violations"] >= 1 and report["rrl_dropped"] > 0
    assert report["respawns_total"] >= 1 and report["rolls_total"] >= 1
    upstream = json.loads(next(x for x in lines
                               if x.startswith('{"chaos_upstream"')))
    assert upstream["chaos_upstream"]["violations"] == []
    assert json.loads(lines[-1])["left"] == []

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
    # on failure, the whole of both legs' reports and the errors
    said = "\n".join(lines) + "\n" + out.stderr.decode()[-3000:]
    assert out.returncode == 0, said
    group = json.loads(next(x for x in lines
                            if x.startswith('{"chaos_group"')))
    report = group["chaos_group"]
    assert report["errors"] == 0 and report["left_after_drain"] == [], said
    assert len(report["injected"]) == 11, said
    stale = report["stale"]
    assert stale["data_past_cap"] == 0 and stale["stale_answers"] > 0, said
    assert stale["refusals_past_cap"] > 0, said
    assert report["digest_violations"] >= 1 and \
        report["rrl_flood"]["limited"] > 0, said
    assert report["respawns_total"] >= 1 and \
        report["rolls_total"] >= 1, said
    upstream = json.loads(next(x for x in lines
                               if x.startswith('{"chaos_upstream"')))
    assert upstream["chaos_upstream"]["violations"] == [], said
    assert json.loads(lines[-1])["left"] == [], said


# -- the rrl-flood gate's arithmetic ----------------------------------


def worker(shard, pid, responses=0, dropped=0, slipped=0, allowlisted=100,
           buckets=0):
    return {"shard": shard, "pid": pid, "responses": responses,
            "dropped": dropped, "slipped": slipped,
            "allowlisted": allowlisted, "buckets": buckets,
            "read_at": 0.0}


def test_rrl_gate_counts_a_worker_killed_before_its_frame():
    # shard 0 limited the flood and was killed before its next stats
    # frame: the supervisor folded nothing from it, but its own counters
    # were read before the kill, and its successor starts from zero
    import chip_smoke
    readings = [
        worker(0, 10, responses=34, dropped=3, slipped=3, buckets=2),
        worker(0, 20, allowlisted=900),
        worker(1, 11, responses=12, buckets=1),
        worker(2, 12), worker(3, 13)]
    summary, errors = chip_smoke.rrl_flood_gate(readings)
    assert errors == []
    assert (summary["limited"], summary["dropped"], summary["slipped"],
            summary["judged"]) == (6, 3, 3, 52)
    assert summary["received_by"] == [[0, 10], [1, 11]]
    assert summary["limited_by"] == [[0, 10]]


def test_rrl_gate_counts_slips_without_drops():
    # the reference's gate is dropped + slipped: a limiter whose limited
    # responses all slipped limited the burst all the same
    import chip_smoke
    summary, errors = chip_smoke.rrl_flood_gate(
        [worker(1, 11, responses=40, slipped=5, buckets=1), worker(2, 12)])
    assert errors == [] and summary["limited"] == 5
    assert summary["dropped"] == 0


def test_rrl_gate_fails_when_nothing_was_limited():
    import chip_smoke
    summary, errors = chip_smoke.rrl_flood_gate(
        [worker(0, 10, responses=50, buckets=2), worker(1, 11)])
    assert summary["limited"] == 0
    assert errors == ["rrl-flood: never rate-limited (dropped + slipped "
                      "0 on every worker process)"]


def test_rrl_gate_fails_where_the_measurement_client_was_judged():
    # no allowlisted bypass, and limiting on a worker that tracks no
    # flood prefix: both are errors
    import chip_smoke
    _, errors = chip_smoke.rrl_flood_gate(
        [worker(0, 10, dropped=2, allowlisted=0),
         worker(1, 11, responses=9, buckets=1, allowlisted=0)])
    assert errors == [
        "rrl-flood: the allowlisted measurement prefix never bypassed "
        "the limiter",
        "rrl-flood: limited on worker(s) [[0, 10]] that track no flood "
        "prefix"]


def test_rrl_incarnations_keep_the_last_reading_before_a_death():
    # a series of readings: shard 0's pid 10 read twice, then gone (its
    # counters unreadable), then its successor pid 20
    import chip_smoke

    def reading(pid0, counters0, age):
        row = {"pid": pid0, "report_age": age}
        row.update(counters0)
        return {0: row, 1: dict(worker(1, 11), report_age=0.2)}
    c = {k: 0.0 for k in chip_smoke.RRL_FAMILIES}
    points = [(100.0, reading(10, dict(c), 0.5)),
              (100.1, reading(10, dict(c, dropped=2.0, buckets=1.0), 0.6)),
              (100.2, reading(10, {}, 0.7)),
              (101.0, reading(20, dict(c), None))]
    last, frames = chip_smoke.rrl_incarnations(points)
    assert [(w["shard"], w["pid"], w["dropped"], w["read_at"])
            for w in last] == [(0, 10, 2.0, 100.1), (0, 20, 0.0, 101.0),
                               (1, 11, 0, 101.0)]
    assert frames[(0, 10)] == [99.5]

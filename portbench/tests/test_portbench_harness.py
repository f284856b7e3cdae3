"""Runs of the harness on the CPU at the tiny size: the card check, the
result line, and the faults its check has to catch."""
import argparse
import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT, FakeCard
from portbench.harness import cell, faults

RUN = os.path.join(ROOT, "portbench", "run.py")


def test_a_run_stops_at_the_card_check_without_a_result():
    """Without CUDA (a CPU-only torch) the run exits 2 and prints no
    result line."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, RUN, "--workload",
                        "shards4-zk-100k.open", "--seed", str(2**31 + 5),
                        "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 2
    assert p.stdout.strip() == ""
    assert "no card" in p.stderr


def test_a_checkout_of_the_benchmark_alone_gives_no_result(tmp_path):
    """A directory with only BENCHMARK.json and portbench/: not 0, and
    no result line (here at the card check, on the chip at the missing
    program)."""
    bare = tmp_path / "bare"
    bare.mkdir()
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), bare)
    shutil.copytree(os.path.join(ROOT, "portbench"), bare / "portbench",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "shards4-zk-100k.open", "--seed", "3",
                        "--seconds", "1", "--trace", "0"], cwd=bare,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def tiny_run(root, workload, trace, capsys, fault=None, seed=2**31 + 11):
    args = argparse.Namespace(workload=workload, seed=seed, seconds=3.0,
                              trace=trace)
    rc = cell.main(args, FakeCard(), __import__("time").monotonic(),
                   root=root, fault=fault)
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0, out[-3:]
    return json.loads(out[-1])


@pytest.mark.parametrize("workload, trace", [
    ("shards4-zk-100k.open", 0), ("topology4-zk-100k.open", 1)])
def test_the_result_line(tiny_root, capsys, workload, trace):
    """The result line of a cell of BENCHMARK.json, and of the balancer
    topology's cell, which a test root adds by entries alone."""
    result = tiny_run(tiny_root, workload, trace, capsys)
    assert list(result)[-1] == "checks"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in result
    assert result["correct"] is True, result["checks"]
    assert 0 <= result["failed"] <= result["attempted"]
    bench = cell.Bench(tiny_root)
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"]: m["unit"] for m in bench.metrics(workload, kind)}
    assert {k: v["unit"] for k, v in result["metrics"].items()} == want
    for v in result["metrics"].values():
        assert isinstance(v["value"], float) and v["value"] >= 0
    dev = result["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert dev["window_s"] > 0 and "busy_s" in dev
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"}


@pytest.mark.parametrize("workload", ["shards4-zk-100k.open",
                                      "topology4-zk-100k.open"])
@pytest.mark.parametrize("fault, check", [
    ("stale", "stale"), ("drop_half", "missing"), ("alter", "wrong")])
def test_a_planted_fault_makes_the_run_not_correct(tiny_root, capsys,
                                                   workload, fault, check):
    """The state left unchanged (the control), half of the questions
    left out, an answer altered where it is produced: each run reads
    ``correct`` false, on the number that catches it."""
    result = tiny_run(tiny_root, workload, 0, capsys,
                      faults.FAULTS[fault]())
    assert result["correct"] is False
    assert result["checks"][check]["value"] > \
        result["checks"][check]["limit"]


@pytest.mark.cuda
def test_the_control_at_the_cells_size(need_card):
    """On the card: the control (``stale``) at each cell's own size, on
    three seeds, reads ``correct`` false every time."""
    for workload in [w["name"] for w in cell.Bench().spec["workloads"]]:
        p = subprocess.run(
            [sys.executable, os.path.join(ROOT, "portbench", "control.py"),
             "--workload", workload, "--seeds", "101,102,103",
             "--seconds", "10"], cwd=ROOT, capture_output=True, text=True,
            timeout=3600)
        assert p.returncode == 0, p.stdout[-2000:]


def test_a_worker_is_filled_once_its_mirror_holds_the_zone(monkeypatch):
    """Readiness waits for every name of the zone in each worker's
    mirror and a settled native table, and then reports a table short
    of the zone's answers as it is, with no share to meet."""
    from portbench.harness import deploy
    settled = deploy.SETTLE_S + 1
    readings = iter([(50.0, 90.0)] * 2 * settled + [(100.0, 150.0)] * 2
                    + [(100.0, 190.0)] * settled)
    monkeypatch.setattr(deploy, "scrape", lambda mport: dict(zip(
        ("mirror_names", "zone_entries"), next(readings))))
    monkeypatch.setattr(deploy.time, "sleep", lambda s: None)
    dep = deploy.Deployment()
    dep.workers = [{"pid": 1, "mport": 1}]
    got = dep.wait_resident(100, deploy.time.monotonic() + 60)
    assert got == [(100.0, 190.0)]
    assert next(readings, None) is None     # it waited for the settle

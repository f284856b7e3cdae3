"""The benchmark's own tests, on the CPU: ``python -m pytest
portbench/tests`` from the root of a checkout.  Tests that need the card
carry the ``cuda`` marker and skip without one; the decision is taken
inside the test, never while a module is imported."""
import json
import os
import shutil
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

#: the tiny size a test run holds: the cells' configurations and mixes
#: with fewer names, a lower rate and a smaller sample
TINY_HOSTS = 2000
TINY_RATE = 1500
TINY_INFLIGHT = 16
TINY_SAMPLE = 3000

#: the balancer topology's cell, not in BENCHMARK.json yet: its
#: configuration, mix and balancer readers are in ``portbench/``, and a
#: test root adds it by entries alone
LATER_CELL = {"name": "topology4-zk-100k.open",
              "config": "topology4-zk-100k", "traffic": "open-6000",
              "chips": 1, "why": "mbalancer on direct return to 4 servers"}
LATER_CONFIG = {"name": "topology4-zk-100k",
                "file": "portbench/configs/topology4-zk-100k.json"}
LATER_METRICS = ("balancer.busy.open", "balancer.cpu_us_per_query.open")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skipped without one")


@pytest.fixture
def need_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


class FakeCard:
    """The card's part of a run, for a run on the CPU: no device path."""

    def check(self, chips):
        return {"platform": "cpu", "kind": "none", "count": chips}

    def power(self):
        return "no card"

    def trace_start(self):
        self.t = time.monotonic()

    def util_start(self):
        pass

    def util_stop(self):
        return [0.0, 0.0]

    def summary(self, lat):
        return {"n": len(lat)}

    def trace_stop(self):
        w = time.monotonic() - self.t
        return {"busy_s": 0.0, "window_s": w, "device_ops": [],
                "idle_gaps": [["host", w]]}

    def memory_peak(self):
        return 0


def add_later_cell(bench: dict) -> None:
    """:data:`LATER_CELL` in ``bench``, with its configuration and the
    readers it reports, by entries alone."""
    with open(os.path.join(ROOT, LATER_CONFIG["file"])) as f:
        cfg = json.load(f)
    bench["configs"].append(dict(LATER_CONFIG, source=cfg["source"],
                                 reduced=cfg["reduced"], why="later"))
    bench["workloads"].append(dict(LATER_CELL))
    for m in bench["per_layer"]:
        if not m["layer"].startswith("shard"):
            m["workloads"].append(LATER_CELL["name"])
    from portbench.harness import cell
    for name in LATER_METRICS:
        mod = cell.load_metric(name)
        bench["per_layer"].append({
            "name": name, "unit": mod.UNIT, "better": "lower",
            "source": mod.SOURCE, "layer": mod.LAYER, "moves": mod.MOVES,
            "workloads": [LATER_CELL["name"]]})


def make_root(dest: str) -> str:
    """A copy of the benchmark's data files at the tiny size, under
    ``dest``: ``BENCHMARK.json`` with :data:`LATER_CELL` added,
    ``portbench/{configs,mixes,metrics}``."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    add_later_cell(bench)
    for sub in ("configs", "mixes"):
        os.makedirs(os.path.join(dest, "portbench", sub))
    shutil.copytree(os.path.join(ROOT, "portbench", "metrics"),
                    os.path.join(dest, "portbench", "metrics"))
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        cfg["zone"]["hosts"] = TINY_HOSTS
        with open(os.path.join(dest, c["file"]), "w") as f:
            json.dump(cfg, f)
    for w in bench["workloads"]:
        name = f"{w['traffic']}.json"
        with open(os.path.join(ROOT, "portbench", "mixes", name)) as f:
            mix = json.load(f)
        if mix["loop"] == "open":
            mix["rate_qps"] = TINY_RATE
        else:
            mix["inflight"] = TINY_INFLIGHT
        mix["check_sample"] = TINY_SAMPLE
        with open(os.path.join(dest, "portbench", "mixes", name), "w") as f:
            json.dump(mix, f)
    with open(os.path.join(dest, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return dest


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(str(tmp_path / "root"))

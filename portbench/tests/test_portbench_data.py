"""The benchmark is driven by its data files: BENCHMARK.json against the
contract, and a new configuration, mix or metric added by a file and an
entry, with no other file edited."""
import json
import os
import re
import shutil

import numpy as np
import pytest

from conftest import ROOT
from portbench.harness import cell, traffic, zone as zonemod

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys_and_names(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024


def test_run_seconds_fits_the_check_at_24_cells(bench):
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_every_cell_reports_what_the_contract_asks(bench):
    cells = {w["name"] for w in bench["workloads"]}
    for w in bench["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        e2e = [m["name"] for m in bench["end_to_end"]
               if w["name"] in m.get("workloads", cells)]
        assert "setup_s" in e2e and len(e2e) >= 2
        per = [m for m in bench["per_layer"]
               if w["name"] in m.get("workloads", cells)]
        assert per
        for m in per:
            assert m["moves"] in e2e
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_each_config_file_and_its_source(bench):
    for c in bench["configs"]:
        assert c["file"].startswith("portbench/configs/")
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["source"] == c["source"] and len(c["source"]) <= 200
        assert cfg["reduced"] == c["reduced"]
        assert cfg["layout"] in ("shards", "topology")


def test_each_metric_file_declares_its_entry(bench):
    for m in bench["per_layer"]:
        mod = cell.load_metric(m["name"])
        assert (mod.NAME, mod.UNIT, mod.LAYER, mod.SOURCE, mod.MOVES) == (
            m["name"], m["unit"], m["layer"], m["source"], m["moves"])


def test_each_mix_file_makes_a_schedule(bench):
    zone = zonemod.Zone(dict(json.load(open(os.path.join(
        ROOT, bench["configs"][0]["file"])))["zone"], hosts=500), 7)
    for w in bench["workloads"]:
        mix = cell.Bench().mix(w["traffic"])
        t = traffic.Templates(mix, zone)
        a = traffic.schedule(mix, t, 7, 2.0)
        b = traffic.schedule(mix, t, 7, 2.0)
        assert (a == b).all()             # the same seed, the same inputs
        assert a.size > 0 and a["tmpl"].max() < len(t.wires)


def test_seeds_change_the_data_and_not_the_work(bench):
    cfg = json.load(open(os.path.join(ROOT, bench["configs"][0]["file"])))
    spec = dict(cfg["zone"], hosts=500)
    mix = cell.Bench().mix("open")
    z1, z2 = zonemod.Zone(spec, 1), zonemod.Zone(spec, 2**31 + 99)
    assert len(z1.nodes) == len(z2.nodes) and z1.addr != z2.addr
    t1, t2 = traffic.Templates(mix, z1), traffic.Templates(mix, z2)
    s1, s2 = (traffic.schedule(mix, t1, 1, 3.0),
              traffic.schedule(mix, t2, 2**31 + 99, 3.0))
    assert s1.size == s2.size
    for first, size in t1.blocks.values():
        k1 = ((s1["tmpl"] >= first) & (s1["tmpl"] < first + size)).sum()
        k2 = ((s2["tmpl"] >= first) & (s2["tmpl"] < first + size)).sum()
        assert k1 == k2
    assert not np.array_equal(s1["due"], s2["due"])


def test_a_new_mix_and_metric_are_found_by_name(tmp_path):
    """A later cell: a mix file, a metric file and their entries in
    BENCHMARK.json; no file of the harness is edited."""
    root = tmp_path / "root"
    shutil.copytree(os.path.join(ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    mix = json.load(open(os.path.join(ROOT, "portbench", "mixes",
                                      "open.json")))
    mix["names"] = {"zipf": 1.1}
    mix["queries"].append({"kind": "unknown", "share": 0.05, "count": 100})
    with open(root / "portbench" / "mixes" / "zipf.json", "w") as f:
        json.dump(mix, f)
    with open(root / "portbench" / "metrics" / "zone.rate.zipf.py",
              "w") as f:
        f.write('NAME = "zone.rate.zipf"\nUNIT = "1/s"\nLAYER = "C lane"\n'
                'SOURCE = "program_counter"\nMOVES = "p99_ms"\n\n\n'
                'def read(r):\n    return sum(w["zone_serves"] for w in '
                'r["workers"]) / r["window_s"]\n')
    cellname = "shards4-zk-100k.zipf"
    bench["workloads"].append({"name": cellname, "config": "shards4-zk-100k",
                               "traffic": "zipf", "chips": 1, "why": "x"})
    for m in bench["end_to_end"]:
        if "shards4-zk-100k.open" in m.get("workloads", []):
            m["workloads"].append(cellname)
    bench["per_layer"].append({"name": "zone.rate.zipf", "unit": "1/s",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "C lane", "moves": "p99_ms",
                               "workloads": [cellname]})
    with open(root / "BENCHMARK.json", "w") as f:
        json.dump(bench, f)
    b = cell.Bench(str(root))
    w = b.cell(cellname)
    got = b.mix(w["traffic"])
    cfg = b.config(w["config"])
    zone = zonemod.Zone(dict(cfg["zone"], hosts=500), 3)
    t = traffic.Templates(got, zone)
    s = traffic.schedule(got, t, 3, 2.0)
    first, size = t.blocks["unknown"]
    assert ((s["tmpl"] >= first) & (s["tmpl"] < first + size)).any()
    hosts = np.bincount(s["tmpl"][s["tmpl"] < zone.hosts],
                        minlength=zone.hosts)
    assert hosts.max() > 20 * max(1, np.median(hosts))   # Zipf's head
    assert [m["name"] for m in b.metrics(cellname, "per_layer")] == [
        "zone.rate.zipf"]
    reader = cell.load_metric("zone.rate.zipf", str(root))
    assert reader.read({"window_s": 2.0, "workers": [
        {"zone_serves": 10.0}, {"zone_serves": 30.0}]}) == 20.0

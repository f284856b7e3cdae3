"""The zone phase of ``chip_smoke.py``, rehearsed on the CPU at small
zones in a fresh interpreter.

Leg (a), the port of ``tools/zone_smoke.py``: ``python -m
binder_torch.probe.zone`` at 2,000 and 10,000 names (100,000 on the
chip), each in its own process, and ``validate_mirror_metrics`` on a
collector-wired port server.  Leg (b): the zone and verify probes at
2,000 and 10,000 names (10,000 to 1,000,000 on the chip).  Leg (c): an
in-process server at 2,000 names with the C zone resident, a sample of
500 hosts through a session rebuild and a degradation cycle (2,000 of
100,000 on the chip).  Every gate of the phase must hold.
"""
from tests.test_torch_smoke_hostile import run_phase


def test_chip_smoke_zone_phase_on_the_cpu():
    report, native, said = run_phase(
        "zone_phase(control=2000, smoke=10000, scale=(2000, 10000), "
        "verify_sizes=(2000, 10000), lane_hosts=2000, lane_sample=500, "
        "recover_s=2.0, native=native)", "zone")
    assert report["errors"] == 0, said
    assert report["smoke"]["mirror_metrics_errors"] == [], said
    scale = report["scale"]
    assert set(scale["zone"]) == {"2000", "10000"}, said
    assert set(scale["verify"]) == {"2000", "10000"}, said
    assert all(r["violations"] == 0 for r in scale["verify"].values())
    assert all(r["peak_rss_kb"] > 0 for r in scale["zone"].values())
    lane = report["lane"]
    assert lane["fresh"]["zone_share"] > 0.5, said
    assert lane["rebuild"]["moved_host_zone_served_after"], said
    assert lane["rebuild"]["epochs"] == 1, said
    assert lane["degradation"]["stale_ttls"] == [5], said
    assert set(lane["degradation"]["recovered_rcodes"]) == {"NOERROR"}
    assert native["zone"]["c_zone_hits"] > 0, said

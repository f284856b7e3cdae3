"""The federation, verify, tcp and conformance phases of
``chip_smoke.py``, rehearsed on the CPU at a small zone, each in a fresh
interpreter.

federation: two west servers, a federated east and a UFDS-routed east
(the port's ``LdapTestServer`` over LDAPS, certificates from the
``openssl`` command line), a 500-name working set and a 4 s stream with
west SIGKILLed at 55% of it (10 s and 2,000 names on the chip).  verify:
an in-process server with the verifier on, a 3 s clean soak, then
``corrupt-answer`` and ``drop-reverse`` and one audit cycle.  tcp: the
stream-lane clients against ``python -m binder_torch.main`` with a
4,096-byte write cap, then glibc's resolver (``libresolv_probe
--server``) and the RFC vectors against the same server.  Every gate
of each phase must hold, with the C lane resident.
"""
import shutil

import pytest

from tests.test_torch_smoke_hostile import run_phase


def test_chip_smoke_federation_phase_on_the_cpu():
    if shutil.which("openssl") is None:
        pytest.skip("no openssl: the UFDS leg makes its certificates "
                    "with it")
    report, native, said = run_phase(
        "federation_phase(hosts=2000, duration=4.0, working=500, "
        "native=native)", "federation")
    assert report["errors"] == 0, said
    assert report["ufds"]["datacenters"]["west"], said
    assert report["parity"]["differ"] == 0, said
    assert report["stream"]["timeouts"] == 0, said
    assert report["stream"]["foreign_stale"] > 0, said
    assert report["post_dark_sweep_ok"] == 500, said
    assert report["never_seen_rcode"] == 5, said        # REFUSED
    assert report["dark"] == ["west"], said
    assert all(report["flight_events"].values()), said
    assert native["federation"]["c_zone_hits"] > 0, said


def test_chip_smoke_verify_phase_on_the_cpu():
    report, native, said = run_phase(
        "verify_phase(hosts=2000, duration=3.0, native=native)", "verify")
    assert report["errors"] == 0, said
    assert report["violations"]["compiled-bytes"] >= 1, said
    assert report["violations"]["ptr-coherence"] >= 1, said
    assert report["audit_cycle"]["items_left"] == 0, said
    assert report["propagation"]["stages"]["compiled-install"] > 0, said
    assert native["verify"]["binder_zone_entries"] > 0, said


def test_chip_smoke_tcp_and_conformance_phases_on_the_cpu():
    report, native, said = run_phase(
        "tcp_phase(hosts=2000, native=native)", "tcp")
    assert report["errors"] == 0, said
    after, before = report["tcp_after"], report["tcp_before"]
    for counter in ("fast_serves", "oneshot_closes", "promotions",
                    "coalesced_writes", "slow_reader_drops", "rst_drops"):
        assert after[counter] > before[counter], (counter, said)
    assert after["open_conns"] == 0, said
    assert native["tcp"]["c_zone_hits"] > 0, said
    conformance = native["conformance"]
    assert conformance["binder_zone_entries"] > 0, said
    assert '"conformance": {' in said and '"golden_errors": 0' in said, said

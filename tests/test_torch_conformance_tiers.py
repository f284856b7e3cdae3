"""``python -m binder_torch.cli.conformance_tiers``: the port's tier
report, held to ``tools/conformance_tiers.py``'s tiers, order, output
and exit codes on small junit files."""
import inspect

import pytest

from binder_torch.cli import conformance_tiers as tiers
from tests import (test_torch_conformance, test_torch_libc_ns,
                   test_torch_real_conformance)
from tools import conformance_tiers as reference

JUNIT = """<?xml version="1.0" encoding="utf-8"?>
<testsuites><testsuite name="pytest" errors="0" failures="1" skipped="3"
 tests="{n}">{cases}</testsuite></testsuites>
"""
CASES = [
    ("tests.test_torch_conformance.TestGoldenVectors", "test_soa_decode",
     None),
    ("tests.test_torch_conformance",
     "test_query_encode_matches_rfc_bytes[port]", None),
    ("tests.test_torch_conformance", "test_dig_exchanges",
     "dig(1) not installed"),
    ("tests.test_torch_conformance", "test_getent_a_and_ptr",
     "set BINDER_LIBC_CONFORMANCE=1"),
    ("tests.test_torch_libc_ns.TestGetent", "test_both_packages_read_alike",
     None),
    ("tests.test_torch_libc_ns", "test_host_files_are_the_same_after", None),
    ("tests.test_torch_libc_ns.TestLibresolvRoute",
     "test_srv_a_ptr_and_edns_echo[ref]", "FAIL"),
    ("tests.test_torch_real_conformance.TestRealZooKeeper",
     "test_session_reads_writes_watches", "set ZK_HOST"),
    ("tests.test_conformance.TestLibcConformance", "test_getent_a_and_ptr",
     None),
]


def junit(tmp_path, cases):
    body = []
    for cls, name, outcome in cases:
        inner = ("" if outcome is None else '<failure message="x"/>'
                 if outcome == "FAIL" else f'<skipped message="{outcome}"/>')
        body.append(f'<testcase classname="{cls}" name="{name}">{inner}'
                    "</testcase>")
    path = tmp_path / "junit.xml"
    path.write_text(JUNIT.format(n=len(cases), cases="".join(body)))
    return str(path)


def test_the_reference_tiers_in_the_reference_order():
    assert [name for name, _ in tiers.TIERS] == [
        name for name, _, _ in reference.TIERS]
    assert tiers.DNS_CLIENT_TIERS == reference.DNS_CLIENT_TIERS


def test_report_names_each_tier_and_its_outcome(tmp_path, capsys):
    assert tiers.main([junit(tmp_path, CASES), "--strict"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "conformance tiers of binder_torch (actual outcomes):"
    assert out[1:] == [
        "  rfc-golden-vectors   ran     — 2 test(s) passed",
        "  dig(1)               SKIPPED — dig(1) not installed",
        "  glibc-getent         ran     — 2 test(s) passed",
        "  glibc-libresolv      FAILED  — 1 test(s) failed",
        "  real-zookeeper       SKIPPED — set ZK_HOST",
        "  real-systemd         SKIPPED — not collected",
    ]


def test_strict_needs_an_independent_dns_client(tmp_path, capsys,
                                                monkeypatch):
    monkeypatch.delenv("BINDER_LIBC_CONFORMANCE", raising=False)
    only_vectors = junit(tmp_path, CASES[:4])
    assert tiers.main([only_vectors]) == 0
    assert tiers.main([only_vectors, "--strict"]) == 1
    assert "WARNING: no independent DNS client" in capsys.readouterr().err
    monkeypatch.setenv("BINDER_LIBC_CONFORMANCE", "0")
    assert tiers.main([only_vectors, "--strict"]) == 0
    assert "independence gate waived" in capsys.readouterr().out


def test_unreadable_or_foreign_reports(tmp_path):
    assert tiers.main([str(tmp_path / "missing.xml")]) == 2
    assert tiers.main([junit(tmp_path, CASES[-1:])]) == 2
    assert tiers.main([]) == 2


@pytest.mark.parametrize("tier", [name for name, _ in tiers.TIERS])
def test_every_tier_names_tests_that_exist(tier):
    cases = []
    for module in (test_torch_conformance, test_torch_libc_ns,
                   test_torch_real_conformance):
        for name, obj in vars(module).items():
            if name.startswith("test_") and inspect.isfunction(obj):
                cases.append((module.__name__, name))
            elif name.startswith("Test") and inspect.isclass(obj):
                cases += [(module.__name__, f"{name}::{m}") for m in vars(obj)
                          if m.startswith("test_")]
    assert any(tiers.tier_of(m, c) == tier for m, c in cases)

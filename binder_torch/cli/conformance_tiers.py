"""Report which independent-conformance tiers of the port ran and which
skipped, from a junit report of its tests.

The counterpart of ``tools/conformance_tiers.py``: the same six tiers
in the same order, the same report and exit codes, read from the
``tests/test_torch_*`` modules that hold each tier on the port:

- rfc-golden-vectors, dig(1), glibc-libresolv through ``--server``,
  getent behind ``BINDER_LIBC_CONFORMANCE``: ``test_torch_conformance``;
- glibc-getent and glibc-libresolv through resolv.conf, in a private
  namespace (``binder_torch.cli.resolv_ns``): ``test_torch_libc_ns``;
- real-zookeeper, real-systemd: ``test_torch_real_conformance``.

Usage: python3 -m binder_torch.cli.conformance_tiers <junit.xml> [--strict]

Exit status: 0 normally; with ``--strict``, 1 unless at least one
independent DNS client tier (dig, glibc getent or glibc libresolv)
passed, waived with a note by an explicit
``BINDER_LIBC_CONFORMANCE=0``; 2 on a report it cannot read or one
without a case of these modules.
"""
import os
import re
import sys
import xml.etree.ElementTree as ET

#: tier -> (module, pattern) pairs; a case belongs to the tier whose
#: pattern matches the start of its ``Class::name`` (or ``name``): no
#: case matches two
TIERS = [
    ("rfc-golden-vectors", (
        ("tests.test_torch_conformance",
         r"TestGoldenVectors::|test_(the_smoke_carries|query_|responses_"
         r"|srv_encode|both_codecs)"),)),
    ("dig(1)", (("tests.test_torch_conformance", r"test_dig_"),)),
    ("glibc-getent", (
        ("tests.test_torch_conformance", r"test_getent_"),
        ("tests.test_torch_libc_ns", r"(?!TestLibresolvRoute::)"))),
    ("glibc-libresolv", (
        ("tests.test_torch_conformance", r"test_(srv_a_ptr|probe_)"),
        ("tests.test_torch_libc_ns", r"TestLibresolvRoute::"))),
    ("real-zookeeper", (
        ("tests.test_torch_real_conformance", r"TestRealZooKeeper::"),)),
    ("real-systemd", (
        ("tests.test_torch_real_conformance", r"TestRealSystemd::"),)),
]
DNS_CLIENT_TIERS = {"dig(1)", "glibc-getent", "glibc-libresolv"}
MODULES = {m for _, pairs in TIERS for m, _ in pairs}


def tier_of(module: str, case: str):
    """The tier of test ``case`` of ``module``, or None."""
    for name, pairs in TIERS:
        if any(m == module and re.match(p, case) for m, p in pairs):
            return name
    return None


def tier_outcomes(junit_path: str):
    """tier -> [passed, failed, skip reasons], for the cases of
    ``MODULES`` only."""
    out = {}
    for case in ET.parse(junit_path).getroot().iter("testcase"):
        classname, name = case.get("classname", ""), case.get("name", "")
        if classname in MODULES:
            module, key = classname, name
        else:
            module, _, cls = classname.rpartition(".")
            key = f"{cls}::{name}"
        if module not in MODULES:
            continue
        tier = tier_of(module, key)
        if tier is None:
            continue
        rec = out.setdefault(tier, [0, 0, []])
        skip = case.find("skipped")
        if skip is not None:
            rec[2].append(skip.get("message") or "skipped")
        elif case.find("failure") is not None or \
                case.find("error") is not None:
            rec[1] += 1
        else:
            rec[0] += 1
    return out


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = [a for a in argv if a != "--strict"]
    strict = "--strict" in argv
    if len(args) != 1:
        print("usage: python3 -m binder_torch.cli.conformance_tiers "
              "<junit.xml> [--strict]", file=sys.stderr)
        return 2
    try:
        outcomes = tier_outcomes(args[0])
    except (OSError, ET.ParseError) as e:
        print(f"conformance_tiers: cannot read junit report "
              f"{args[0]}: {e}", file=sys.stderr)
        return 2
    if not outcomes:
        print(f"conformance_tiers: no testcases from {sorted(MODULES)} "
              f"in {args[0]} (wrong file, or the modules failed to "
              f"collect)", file=sys.stderr)
        return 2

    any_dns_client = False
    print("conformance tiers of binder_torch (actual outcomes):")
    for name, _ in TIERS:
        passed, failed, reasons = outcomes.get(
            name, (0, 0, ["not collected"]))
        if failed:
            status, why = "FAILED ", f"{failed} test(s) failed"
        elif passed:
            status, why = "ran    ", f"{passed} test(s) passed"
        else:
            status = "SKIPPED"
            why = reasons[0] if reasons else "no tests ran"
        print(f"  {name:<20} {status} — {why}")
        if passed and not failed and name in DNS_CLIENT_TIERS:
            any_dns_client = True

    if not any_dns_client:
        if os.environ.get("BINDER_LIBC_CONFORMANCE") == "0":
            print("  note: independence gate waived — "
                  "BINDER_LIBC_CONFORMANCE=0 set explicitly")
            return 0
        print("  WARNING: no independent DNS client executed; codec "
              "conformance rests on golden vectors alone",
              file=sys.stderr)
        return 1 if strict else 0
    return 0


if __name__ == "__main__":
    sys.exit(main())

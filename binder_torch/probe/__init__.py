"""Zone-scale probes: the mirror's O(delta) invariants measured at N names.

Each module is the counterpart of one of ``tools/``'s probes, with the
same arguments and the same keys in its one JSON line, built on
``binder_torch`` and the standard library only:

- ``zone`` (``tools/zone_probe.py``): mirror build seconds and bytes per
  name, single-name mutation latency with a byte-parity check of every
  re-rendered answer against a fresh engine render, watch-storm
  recovery, and the chunked session rebuild's loop lag.
  ``python -m binder_torch.probe.zone N [mutations] [storm]``.
- ``verify`` (``tools/verify_probe.py``): mutation latency with and
  without the verify plane wired, the propagation stages, and one full
  background-audit pass.
  ``python -m binder_torch.probe.verify N [mutations] [sample]``.

Run each size in its own process: the RSS figures are deltas of the
probe's own address space.
"""

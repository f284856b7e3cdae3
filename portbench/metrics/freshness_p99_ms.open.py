"""The 99th percentile of the freshness of the timed churn writes
acknowledged in the window: from the stand-in's acknowledgement of the
``setData`` to the last worker's answer carrying it (or a later write of
the name), by nearest rank; a write never read back counts as infinite.
Nothing when it is infinite (the run is then not correct)."""
NAME = "freshness_p99_ms.open"
UNIT = "ms"
LAYER = "served path"
SOURCE = "host_clock"
MOVES = "qps"


def read(r):
    return r["client"]["freshness_p99_ms"]

"""The 99th percentile of the client's latency over every query due in
the window, by nearest rank, from its due time to its first reply with
retransmissions included, a query never answered counting as infinite:
the benchmark's own clock on the served path.  Nothing when it is
infinite (more than 1% never answered; the run is then not correct)."""
NAME = "p99_ms.open"
UNIT = "ms"
LAYER = "served path"
SOURCE = "host_clock"
MOVES = "qps"


def read(r):
    return r["client"]["p99_ms"]

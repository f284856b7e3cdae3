"""The 99th percentile of the workers' propagation to the native zone
table: the window's delta of ``binder_propagation_seconds{stage=
"native-install"}``, summed over the workers, read at the histogram's
bucket resolution (the upper bound of the bucket that holds it: 5 us to
1 s), in ms.  Past the last finite bound it reads that bound, 1000 ms,
as a floor.  Nothing when no write reached a worker's zone table in the
window."""
from portbench.harness.stats import bucket_percentile

NAME = "propagation_p99_ms.open"
UNIT = "ms"
LAYER = "ZooKeeper lane and mirror"
SOURCE = "program_counter"
MOVES = "qps"


def read(r):
    total = {}
    for w in r["workers"]:
        for le, n in w["native_install_buckets"].items():
            total[le] = total.get(le, 0.0) + n
    finite = [float(le) for le, n in total.items()
              if le != "+Inf" and n > 0]
    if not finite:
        return None
    v = bucket_percentile(total, 99)
    return (max(float(le) for le in total if le != "+Inf")
            if v is None else v) * 1e3

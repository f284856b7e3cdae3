"""The 99th percentile of the backends' propagation to the native zone
table over the window: ``propagation_p99_ms.open`` over the backends'
``binder_propagation_seconds{stage="native-install"}``.  Each backend's
own session carries the write from the store to its zone table, with no
supervisor between."""
import os

from portbench.harness import cell

NAME = "backends.propagation_p99_ms.open"
UNIT = "ms"
LAYER = "ZooKeeper sessions and mirrors"
SOURCE = "program_counter"
MOVES = "qps"
#: the shards cell's reader of the same quantity, which this one reads
OF = "propagation_p99_ms.open"


def read(r):
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return cell.load_metric(OF, root).read(r)

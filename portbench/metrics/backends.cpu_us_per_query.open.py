"""The backends' CPU microseconds per query they completed over the window:
``workers.cpu_us_per_query.open``, their summed /proc CPU over the delta
of their ``binder_requests_completed``."""
import os

from portbench.harness import cell

NAME = "backends.cpu_us_per_query.open"
UNIT = "us/query"
LAYER = "topology backends"
SOURCE = "program_counter"
MOVES = "qps"
#: the shards cell's reader of the same quantity, which this one reads
OF = "workers.cpu_us_per_query.open"


def read(r):
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return cell.load_metric(OF, root).read(r)

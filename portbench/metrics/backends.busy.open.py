"""The mean busy share of the servers behind the balancer over the window:
``workers.busy.open``, over the ``worker*`` roles the topology fills
with its backends (/proc CPU seconds over the window's seconds)."""
import os

from portbench.harness import cell

NAME = "backends.busy.open"
UNIT = "share"
LAYER = "topology backends"
SOURCE = "program_counter"
MOVES = "qps"
#: the shards cell's reader of the same quantity, which this one reads
OF = "workers.busy.open"


def read(r):
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return cell.load_metric(OF, root).read(r)

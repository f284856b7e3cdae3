"""Seconds from the topology's launch to every backend filled (its own
session's walk of the tree, its mirror at the zone's names and its
native zone table settled), on the harness's clock: ``boot.filled_s``."""
import os

from portbench.harness import cell

NAME = "backends.boot.filled_s"
UNIT = "s"
LAYER = "deployment boot"
SOURCE = "host_clock"
MOVES = "setup_s"
#: the shards cell's reader of the same quantity, which this one reads
OF = "boot.filled_s"


def read(r):
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return cell.load_metric(OF, root).read(r)

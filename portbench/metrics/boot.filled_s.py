"""Seconds from the deployment's launch to every worker filled: its
mirror holding every name of the zone and its native zone table's count
settled (the supervisor's walk of the tree, the snapshot's replay into
each replica, the zone fill), on the harness's clock."""
NAME = "boot.filled_s"
UNIT = "s"
LAYER = "deployment boot"
SOURCE = "host_clock"
MOVES = "setup_s"


def read(r):
    boot = r.get("boot")
    if not boot:
        return None
    return boot["filled_s"]

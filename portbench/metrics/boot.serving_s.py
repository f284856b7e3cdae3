"""Seconds from the deployment's launch to its public port answering
(the shard group's supervisor and workers started, their sockets
bound), on the harness's clock."""
NAME = "boot.serving_s"
UNIT = "s"
LAYER = "deployment boot"
SOURCE = "host_clock"
MOVES = "setup_s"


def read(r):
    boot = r.get("boot")
    if not boot:
        return None
    return boot["serving_s"]

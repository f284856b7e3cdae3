"""The shard supervisor's busy share: its /proc CPU seconds over the
window's seconds.  It holds the ZooKeeper session and the mirror, and
encodes every change once per worker link."""
NAME = "supervisor.busy.open"
UNIT = "share"
LAYER = "shard supervisor"
SOURCE = "program_counter"
MOVES = "qps"


def read(r):
    cpu = r["cpu"].get("supervisor")
    return None if cpu is None else cpu / r["window_s"]

"""The mean busy share of the workers (the reuseport group's, or the
backends behind the balancer): each one's /proc CPU
seconds over the window's seconds, averaged."""
NAME = "workers.busy.open"
UNIT = "share"
LAYER = "server and Python lane"
SOURCE = "program_counter"
MOVES = "qps"


def read(r):
    cpu = [v for k, v in r["cpu"].items() if k.startswith("worker")]
    if not cpu or len(cpu) != len(r["workers"]):
        return None
    return sum(cpu) / len(cpu) / r["window_s"]

"""The one ``mbalancer`` process's busy share over the window: its CPU
seconds (/proc/<pid>/stat) over the window's seconds.  At 1.0 the
balancer's core is the topology's bound."""
NAME = "balancer.busy.open"
UNIT = "share"
LAYER = "balancer"
SOURCE = "program_counter"
MOVES = "qps"


def read(r):
    cpu = r["cpu"].get("balancer")
    return None if cpu is None else cpu / r["window_s"]

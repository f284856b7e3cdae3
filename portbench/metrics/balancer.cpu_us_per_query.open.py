"""``mbalancer``'s CPU microseconds per query it forwarded in the window:
its /proc CPU over the delta of ``forwarded`` summed over the backends
of its stats socket (``.balancer.stats``)."""
NAME = "balancer.cpu_us_per_query.open"
UNIT = "us/query"
LAYER = "balancer"
SOURCE = "program_counter"
MOVES = "qps"


def read(r):
    cpu = r["cpu"].get("balancer")
    bal = r.get("balancer")
    if cpu is None or not bal or bal["forwarded"] <= 0:
        return None
    return cpu * 1e6 / bal["forwarded"]

"""The workers' (or backends') CPU microseconds per query they completed: their summed
/proc CPU over the window over the delta of their
``binder_requests_completed``."""
NAME = "workers.cpu_us_per_query.open"
UNIT = "us/query"
LAYER = "server and Python lane"
SOURCE = "program_counter"
MOVES = "qps"


def read(r):
    cpu = [v for k, v in r["cpu"].items() if k.startswith("worker")]
    done = sum(w["completed"] for w in r["workers"])
    if len(cpu) != len(r["workers"]) or done <= 0:
        return None
    return sum(cpu) * 1e6 / done

"""The C lane's share of the replies: its zone-table serves
(``binder_zone_serves``) and its answer-cache hits (``binder_answer_
cache_hits`` less the Python cache's own hits from ``/status``) over
every completed query (``binder_requests_completed``), summed over the
workers, over the window."""
NAME = "clane.share.open"
UNIT = "share"
LAYER = "C lane"
SOURCE = "program_counter"
MOVES = "qps"


def read(r):
    done = sum(w["completed"] for w in r["workers"])
    c = sum(w["zone_serves"] + w["cache_hits"] - w["python_cache_hits"]
            for w in r["workers"])
    return None if done <= 0 else c / done

"""The card's idle share over the window: 1 - the mean of ``nvidia-smi``'s
``utilization.gpu`` (every process on the card), sampled each second."""
NAME = "device.idle.open"
UNIT = "share"
LAYER = "device"
SOURCE = "device_trace"
MOVES = "qps"


def read(r):
    util = r.get("gpu_util")
    if not util:
        return None
    return 1.0 - sum(util) / len(util) / 100.0

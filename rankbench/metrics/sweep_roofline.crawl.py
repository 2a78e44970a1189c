"""The rankings' share of the roofline: the least time the window's
sweeps need (``roofline.sweep_seconds``: each link's weight and index and
each vector once a product, at the data sheet's HBM rate) over the
device time in which a kernel ran (profiler)."""
from rankbench import roofline


def read(obs):
    c, t = obs.get("crawl"), obs.get("trace")
    if not c or not t or t["kernel_s"] <= 0:
        return None
    need = roofline.sweep_seconds(c["pages"], c["links"], c["dtype"]) \
        * sum(c["sweeps"])
    return 100.0 * need / t["kernel_s"]

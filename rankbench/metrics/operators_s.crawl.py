"""Seconds the set-up spends building a whole-crawl cell's two operators
from the crawl's edges: the port's ``Graph``, ``accel_weights`` and
``kernels/ops.py::hits_sweep_bsr`` (host blocks, copies to the card),
on the benchmark's clock; the work a changed crawl pays before its first
ranking."""


def read(obs):
    c = obs.get("crawl")
    return c["operators_s"] if c else None

"""Share of the traced window of a whole-crawl cell with nothing running
on the device (profiler)."""
from rankbench.obs import idle_pct


def read(obs):
    return idle_pct(obs) if obs.get("crawl") else None

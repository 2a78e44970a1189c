"""What the per-layer readers share: the device's idle share from the
trace."""
from __future__ import annotations


def idle_pct(obs: dict):
    """Share of the traced window in which nothing ran on the device."""
    t = obs.get("trace")
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])

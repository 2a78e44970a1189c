"""Sweeps a whole-crawl ranking takes: the mean of the window's rankings'
``iters`` (the program's count)."""


def read(obs):
    c = obs.get("crawl")
    if not c or not c["sweeps"]:
        return None
    return sum(c["sweeps"]) / len(c["sweeps"])

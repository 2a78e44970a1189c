"""Operator bytes K1 reads a sweep of a whole-crawl ranking, in GB: the
program's own count of the bytes its K1 launches on the card read
(``repro_torch.kernels.build.counters.bsr_spmm_bytes``: each launch's
blocks, idx and row_ptr) over the sweeps that count covers. The count is
the process's: the set-up's one warm-up ranking (the same crawl from the
same start, so as many sweeps as each ranking of the window) and the
window's rankings. None where the program counted no such bytes (no
card, or a program without the counter) or the window's rankings took
different sweeps."""


def read(obs):
    c = obs.get("crawl")
    if not c or not c["sweeps"] or len(set(c["sweeps"])) != 1:
        return None
    from repro_torch.kernels.build import counters
    read_bytes = getattr(counters, "bsr_spmm_bytes", 0)
    if not read_bytes:
        return None
    return read_bytes / 1e9 / (sum(c["sweeps"]) + c["sweeps"][0])

"""The benchmark's files against its contract, on the CPU: names, units
and keys of ``BENCHMARK.json``, the files each cell and metric is found
by, the frozen crawl generator's counts, the page renumbering and the
roofline's counting on a graph built by hand."""
from __future__ import annotations

import json
import re
from pathlib import Path

import numpy as np
import pytest

from rankbench import harness, roofline, webgraph

ROOT = Path(__file__).resolve().parents[1]

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}\Z")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["rankbench"]
    assert SPEC["command"][1].startswith("rankbench/")
    assert all(_line(w) for w in SPEC["command"])
    assert isinstance(SPEC["run_seconds"], int)
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units_use_allowed_characters():
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    names = [m["name"] for m in metrics]
    for group in (SPEC["configs"], SPEC["workloads"], metrics):
        ns = [x["name"] for x in group]
        assert len(ns) == len(set(ns))
    for n in names + [c["name"] for c in SPEC["configs"]] \
            + [w["name"] for w in SPEC["workloads"]] \
            + [w["traffic"] for w in SPEC["workloads"]]:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES


def test_configs_and_cells():
    configs = {c["name"] for c in SPEC["configs"]}
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("rankbench/")
        assert c["reduced"] == []
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == configs
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and _line(w["why"])


def test_metrics_keys_and_reporting():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert _line(m["layer"]) and m["moves"] in e2e
    for w in SPEC["workloads"]:
        cell = harness.Cell(w["name"], ROOT)
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in reported


def test_every_metric_has_a_reader():
    readers = {p.name[:-3] for p in (ROOT / "rankbench/metrics").glob("*.py")}
    assert {m["name"] for m in SPEC["per_layer"]} <= readers


@pytest.mark.parametrize("name", sorted(
    p.name[:-3] for p in (ROOT / "rankbench/metrics").glob("*.py")))
def test_a_reader_with_nothing_to_read_gives_no_number(name):
    assert harness.reader(name)({"trace": None}) is None


def test_every_traffic_names_its_load():
    import importlib
    for w in SPEC["workloads"]:
        cell = harness.Cell(w["name"], ROOT)
        mod = importlib.import_module(
            f"rankbench.loads.{cell.traffic['generator']}")
        assert hasattr(mod, "Load")


# the crawls' counts at graph seed 0: Table 7's links, then the
# back-button transform's
TABLE = {  # crawl, back-button: (links, dangling %, blocks Lt, blocks L)
    ("britannica", False): (994554, 85.0, 27225, 27225),
    ("britannica", True): (1843957, 0.0, 27225, 27225),
    ("yahoo", False): (161700, 98.0, 50503, 50528),
    ("yahoo", True): (320535, 30.6, 64498, 64498),
}


def _blocks(src, dst, bs=128, n=None):
    """Blocks of the operator with rows ``src``: those holding a link,
    and with ``n`` one more for each block row holding none (the port
    stores a zero block there)."""
    count = len(np.unique(src.astype(np.int64) // bs * 10 ** 6 + dst // bs))
    if n is not None:
        count += -(-n // bs) - len(np.unique(src // bs))
    return count


@pytest.mark.parametrize("crawl", ["britannica", "yahoo"])
def test_frozen_generator_gives_the_tables_counts(crawl):
    n, src, dst = webgraph.paper_dataset(crawl, 0)
    pages, links = webgraph.PAPER_TABLE7[crawl][:2]
    assert n == pages and len(src) == links
    assert not (src == dst).any()
    assert len(np.unique(src.astype(np.int64) * n + dst)) == links
    for bb in (False, True):
        s, d = webgraph.back_button(n, src, dst) if bb else (src, dst)
        links, dang, blt, bl = TABLE[crawl, bb]
        assert len(s) == links
        share = 100 * (np.bincount(s, minlength=n) == 0).mean()
        assert round(share, 1) == dang
        assert (_blocks(d, s, n=n), _blocks(s, d, n=n)) == (blt, bl)


def test_frozen_generator_keeps_the_ports_links():
    from repro_torch.graph.generators import paper_dataset
    for name, seed in (("yahoo", 0), ("britannica", 3), ("jobs", 2 ** 31)):
        g = paper_dataset(name, 0.05, seed)
        n, s, d = webgraph.paper_dataset(name, seed, 0.05)
        assert n == g.n_nodes
        assert len(s) == int(webgraph.PAPER_TABLE7[name][1] * 0.05)
        assert len(g.src) < len(s)
        ours = s.astype(np.int64) * n + d
        assert np.isin(g.src.astype(np.int64) * n + g.dst, ours).all()


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 5])
def test_renumbering_keeps_blocks_and_degrees(seed):
    cfg = json.loads((ROOT / "rankbench/configs/yahoo-bb.json").read_text())
    n0, s0, d0 = webgraph.crawl(cfg, 0, scale=0.1)
    n, s, d = webgraph.crawl(cfg, seed, scale=0.1)
    assert n == n0 and len(s) == len(s0)
    assert not np.array_equal(s, s0)
    assert _blocks(s, d) == _blocks(s0, d0)
    assert sorted(np.bincount(s, minlength=n)) == \
        sorted(np.bincount(s0, minlength=n))


def test_roofline_counts_a_hand_built_graph():
    # 3 pages, 4 links of a 0/1 matrix: each product reads 4 indices of
    # 4 B; the vectors h, ch, a, ca are read and a, h' written: 6 x 3 x 8 B
    assert roofline.sweep_bytes(3, 4) == 2 * 4 * 4 + 6 * 3 * 8
    assert roofline.sweep_flops(4) == 16
    assert roofline.sweep_seconds(3, 4) == (2 * 4 * 4 + 6 * 3 * 8) / 3.35e12
    # britannica-bb: 1,843,957 links, 21,104 pages
    assert roofline.sweep_bytes(21104, 1843957) == 15_764_648
    assert roofline.sweep_bytes(3, 4, "float32") == 2 * 4 * 4 + 6 * 3 * 4
    # a sweep is bound by its bytes in both types
    for dtype in ("float64", "float32"):
        assert roofline.sweep_seconds(21104, 1843957, dtype) == \
            roofline.sweep_bytes(21104, 1843957, dtype) / 3.35e12

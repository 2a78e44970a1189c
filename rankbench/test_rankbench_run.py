"""Whole runs of each cell of ``BENCHMARK.json`` on the CPU at a small
scale (the program's plain kernel versions), with the look for a card
skipped: sound runs come out correct, and the control (the program's
float32 path) and each fault planted under the timed path come out not
correct; and the process as the command line starts it."""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from rankbench import harness

ROOT = Path(__file__).resolve().parents[1]
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEED = 2 ** 31 + 77


def run(cell: str, control: bool = False, trace: bool = False,
        seconds: float = 1.0) -> dict:
    return harness.run_cell(cell, SEED, seconds, trace, device="cpu",
                            control=control, overrides={"scale": 0.02})


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    out = run(cell)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {m["name"] for m in
                                   harness.Cell(cell).end_to_end}
    assert all(v["value"] > 0 for v in out["metrics"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    out = run(cell, control=True)
    assert not out["correct"]
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


def test_traced_run_reads_the_per_layer_metrics():
    out = run("crawl.yahoo-bb", trace=True)
    assert out["correct"]
    assert out["metrics"]["sweeps.crawl"]["value"] >= 1
    assert out["metrics"]["operators_s.crawl"]["value"] > 0
    # no device on the CPU: the trace's metrics find nothing to read
    assert "sweep_roofline.crawl" not in out["metrics"]
    assert "device_idle.crawl" not in out["metrics"]
    assert out["device"]["busy_s"] == 0.0 and out["device"]["window_s"] > 0


# -- faults planted under the timed path ----------------------------------

def _crawl_fault(monkeypatch, kind):
    from repro_torch.core import power
    from repro_torch.kernels import ops
    real_sweep, real_pm = ops.hits_sweep_bsr, power.power_method

    def sweep_factory(*a, **k):
        sweep, lt, l = real_sweep(*a, **k)  # noqa: E741

        def unchanged(h):  # a step that returns its state unchanged
            return h, h

        def half(h):  # half the pages left out, normalised over the rest
            h_new, a = sweep(h)
            h_new = h_new.clone()
            h_new[h_new.shape[0] // 2:] = 0
            return h_new / h_new.abs().sum(), a
        return {"unchanged": unchanged, "half": half}[kind], lt, l

    def altered(*a, **k):  # the answer altered where it is produced
        r = real_pm(*a, **k)
        v = r.v.copy()
        i, j = int(np.argmax(v)), int(np.argmin(v))
        v[i], v[j] = v[j], v[i]
        r.v = v
        return r

    if kind == "altered":
        monkeypatch.setattr(power, "power_method", altered)
    else:
        monkeypatch.setattr(ops, "hits_sweep_bsr", sweep_factory)


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_planted_fault_is_not_correct(monkeypatch, kind):
    _crawl_fault(monkeypatch, kind)
    out = run("crawl.britannica-bb")
    assert not out["correct"] and out["failed"] > 0


# -- the process as the command line starts it --------------------------

def _env():
    """The environment without the test run's module paths (the run finds
    its own), with two threads for torch, as the other tests here."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "2"
    return env


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys, json\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
        "from rankbench import harness, reference, webgraph, roofline\n"
        "before = set(m.split('.')[0] for m in sys.modules)\n"
        "out = harness.run_cell('crawl.yahoo-bb', 5, 0.2, True,"
        " device='cpu', overrides={'scale': 0.05})\n"
        "assert out['correct']\n"
        "mods = sorted(set(m.split('.')[0] for m in sys.modules))\n"
        "print(json.dumps({'before': sorted(before), 'after': mods}))\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=_env(), timeout=300, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    got = json.loads(p.stdout.strip().splitlines()[-1])
    assert not set(got["after"]) & set(harness.BANNED)
    assert "repro_torch" in got["after"]
    # the yardstick alone pulls in nothing of the program
    assert "repro_torch" not in got["before"]


def test_without_a_card_the_run_prints_no_result():
    p = subprocess.run(
        [sys.executable, "rankbench/run.py", "--workload",
         "crawl.britannica-bb", "--seed", "3", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, env=_env(),
        timeout=300, cwd=ROOT)
    if p.returncode == 0:
        pytest.skip("a CUDA card is present")
    assert p.returncode != 0
    assert '"correct"' not in p.stdout


@pytest.mark.cuda
def test_a_short_run_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    p = subprocess.run(
        [sys.executable, "rankbench/run.py", "--workload",
         "crawl.britannica-bb", "--seed", "12", "--seconds", "3",
         "--trace", "1"], capture_output=True, text=True, env=_env(),
        timeout=600, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["busy_s"] > 0

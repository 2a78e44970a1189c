"""``k1_operator_gb.crawl``: the program's count of the operator bytes K1
reads, over the sweeps it covers (the set-up's warm-up ranking and the
window's); left out where no K1 launch on a card was counted."""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from rankbench import harness

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def counters():
    from repro_torch.kernels.build import counters, reset_counters
    reset_counters()
    yield counters
    reset_counters()


def test_reads_the_count_over_the_warm_up_and_window_sweeps(counters):
    read = harness.reader("k1_operator_gb.crawl")
    obs = {"crawl": {"sweeps": [8, 8, 8]}}
    assert read(obs) is None  # nothing counted: no launch on a card
    counters.bsr_spmm_bytes = 4 * 8 * 3_000_000_000
    assert read(obs) == pytest.approx(3.0)
    assert read({"crawl": {"sweeps": [8, 9]}}) is None
    assert read({"crawl": {"sweeps": []}}) is None
    assert read({}) is None


def test_a_traced_cpu_run_leaves_it_out(counters):
    out = harness.run_cell("crawl.britannica-bb", 2 ** 31 + 91, 0.5, True,
                           device="cpu", overrides={"scale": 0.02})
    assert out["correct"]
    assert "sweeps.crawl" in out["metrics"]
    assert "k1_operator_gb.crawl" not in out["metrics"]
    assert counters.bsr_spmm_bytes == 0


@pytest.mark.cuda
def test_britannica_bb_reads_its_stored_blocks_on_the_card():
    """2 x (27,225 blocks x 131,080 B + 664 B of row_ptr) a sweep."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "2"
    p = subprocess.run(
        [sys.executable, "rankbench/run.py", "--workload",
         "crawl.britannica-bb", "--seed", "2147830419", "--seconds", "3",
         "--trace", "1"], capture_output=True, text=True, env=env,
        timeout=600, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"]
    gb = out["metrics"]["k1_operator_gb.crawl"]["value"]
    assert f"{gb:.4g}" == "7.137", gb

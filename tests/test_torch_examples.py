"""The five example ports (``examples/*_torch.py``) as ``--device cpu``
subprocesses, held to the JAX package's deterministic lines by the
checker ``chip_smoke.py`` applies to them on the card
(``chip_smoke.example_problems`` over ``EXAMPLE_LINES``): iteration
counts, graph lines and top pages exactly, the query service's scores
within 1e-12 and its oracle within 1e-10 L1, the async clients' tickets
all accounted for and served again from the spill after a restart, the
retrieval prior raising the mean authority of the top-20. The JAX
package's own ``examples/<name>.py``, run on the CPU, is held to the
same checker, so ``EXAMPLE_LINES`` (which the card, having no JAX, is
held to) are the reference's lines and not only numbers in a script.
The two LM examples (``serve_decode``, ``train_lm``) are held, port and
reference alike, to their lines' formats (``LM_EXAMPLE_LINES``).
"""
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


def _run(script, tmp_path, *args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1", TMPDIR=str(tmp_path), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, str(ROOT / "examples" / script),
                        *args], capture_output=True, text=True, env=env,
                       cwd=tmp_path, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


@pytest.mark.parametrize("name", sorted(chip_smoke.EXAMPLE_LINES))
def test_example_port_matches_reference_lines(name, tmp_path):
    out = _run(f"{name}_torch.py", tmp_path, "--device", "cpu")
    assert chip_smoke.example_problems(name, out) == [], out


@pytest.mark.parametrize("name", sorted(chip_smoke.EXAMPLE_LINES))
def test_reference_example_gives_the_pinned_lines(name, tmp_path):
    """The JAX package's example on the CPU passes the same checker: the
    pinned lines are its own."""
    out = _run(f"{name}.py", tmp_path)
    assert chip_smoke.example_problems(name, out) == [], out


@pytest.mark.parametrize("name", sorted(chip_smoke.LM_EXAMPLE_LINES))
@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_lm_example_gives_the_reference_lines(name, pkg, tmp_path):
    """The LM examples (``serve_decode``, ``train_lm``): the port on the CPU
    and the JAX package's own example pass the same checker
    (``chip_smoke.lm_example_problems``: formats, sizes, finite and
    falling losses; init and batches are each package's own draws)."""
    args = chip_smoke.LM_EXAMPLE_LINES[name]["args"]
    if pkg == "port":
        out = _run(f"{name}_torch.py", tmp_path, "--device", "cpu", *args)
    else:
        out = _run(f"{name}.py", tmp_path, *args)
    assert chip_smoke.lm_example_problems(name, out) == [], out


def test_checker_rejects_a_wrong_line():
    """The checker is not vacuous: a changed iteration count or a lost
    ticket is reported."""
    out = ("synthetic 'wikipedia' crawl: 3129 pages, 7529 links, 96% "
           "dangling\n" + "\n".join(f"X : {n:4d} iterations"
                                     for n in (13, 9, 6, 159, 18, 104)))
    assert any("iters" in p for p in
               chip_smoke.example_problems("quickstart", out))
    out = ("graph: N=4000 E=24782\n48 queries from 4 concurrent clients\n"
           "queue: 5 dispatches, 13 coalesced in flight\n"
           "cache: 10 hits / 1 warm / 23 cold\nrestored 21 spilled entries;"
           " popular repeats -> ['hit', 'hit', 'hit', 'hit'] (4 served")
    assert any("tickets" in p for p in
               chip_smoke.example_problems("async_ranking_clients", out))
    out = ("model: 8.1M params (demo-20m)\nstep    0 loss 9.1 (1 steps/s)\n"
           "step   20 loss 9.2 (1 steps/s)")
    assert chip_smoke.lm_example_problems("train_lm", out)
    out = ("served batch=8: 192 tokens in 1.0s (192.0 tok/s, rolling SWA "
           "cache len=16)\nsample: [1, 2, 3, 4, 5] -> [1] ")
    assert chip_smoke.lm_example_problems("serve_decode", out)

#!/usr/bin/env python3
"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``).

    python3 rankbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

runs one cell of ``BENCHMARK.json`` on the card and prints, as the last
line of standard output, one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics), ``device`` and, traced,
``breakdown``, then ``checks``: each number held to the reference beside
its limit, which also close standard error. It exits non-zero and prints
no result without a CUDA card (or with fewer than the cell asks for), when
a check fails to run, or when JAX or the JAX package is loaded.

``--control 1`` runs the program's lower-precision path (float32) in the
program's place: its answers must come out not correct (a check of the
comparison, not a benchmark run).
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from rankbench import harness
    cell = harness.Cell(args.workload)
    import torch
    chips = int(cell.workload["chips"])
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); torch sees "
              f"{cards}", file=sys.stderr)
        return 2
    out = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), control=bool(args.control),
                           t_start=T_START)
    banned = harness.banned_modules()
    if banned:
        print(f"loaded after the window: {banned} (JAX or the JAX "
              "package); no result", file=sys.stderr)
        return 3
    print("set-up: " + ", ".join(f"{step} {s!r} s" for step, s in
                                 out["setup_phases_s"].items()),
          file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r}) "
              f"{'ok' if c['value'] <= c['limit'] else 'FAILED'}",
              file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

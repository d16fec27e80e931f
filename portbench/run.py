"""Run one cell of the benchmark once, on the card, and print its result.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

(or `python3 -m portbench.run ...`) from the root of a checkout.  The cell
is an entry of BENCHMARK.json's `workloads`; its configuration, traffic
mix, limits and per-layer readers are files under portbench/ found by
name (portbench/spec.py).  A run:

  1. refuses to run without the cards the cell asks for (exit 3, no
     result), and never falls back to the CPU;
  2. sets up: makes the traffic from --seed, builds the program's kernels
     (into its own `_build/` in the checkout, once) and captures every
     graph the window replays by running the traffic's shapes once;
     `setup_s` is the time from the process's start to the window's;
  3. measures for --seconds: the cell's end-to-end metrics (--trace 0),
     or, with --trace 1, the same window and then a short profiled one,
     read by the per-layer metrics;
  4. refuses to report if a module of JAX or of the JAX package is loaded
     (exit 4, no result);
  5. reads the device's memory peak, frees the program's state, and
     compares what the window produced with the plain reference
     (portbench/reference), each number against its limit
     (portbench/limits/<workload>.json), for `correct`;
  6. prints the numbers compared, with their limits, as the last lines of
     standard error, and the result as the last line of standard output.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "portbench" / "_cache"


def _pin_caches():
    """Every build and kernel cache a run could write, at a fixed path
    inside the checkout."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    _pin_caches()
    # run as a script, this file's directory leads sys.path, where
    # trace.py would shadow the standard library's module of that name
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    sys.path.insert(0, str(ROOT))
    args = parse(argv)
    from portbench import harness
    return harness.run_cell(args.workload, args.seed, args.seconds,
                            bool(args.trace))


if __name__ == "__main__":
    sys.exit(main())

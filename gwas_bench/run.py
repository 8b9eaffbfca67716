"""Run one cell of the benchmark once and print its result line.

    python3 gwas_bench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout.  The last line on standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared beside its limit); the last lines on standard error give
the same numbers and limits.  Without a CUDA card, or with fewer cards
than the cell asks for, it prints no result and exits non-zero.

A cell on one card runs in this process.  A cell on more cards starts one
process a card running this same command (``launch.py``), which print
rank 0's result through this one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# the program's build caches stay at fixed paths inside the checkout (K1's
# nvcc build is the package's own _build/)
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(HERE / ".cache" / sub)
# the program's own settings keep their defaults: the cell states them
for var in [v for v in os.environ if v.startswith("PYGEMMA_TPU_")]:
    del os.environ[var]
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    from gwas_bench import launch

    rank_of = launch.launched_at()  # the launcher's start, in a rank
    started = launch.process_start() if rank_of is None else rank_of
    with open(ROOT / "BENCHMARK.json") as f:
        chips = {w["name"]: w["chips"]
                 for w in json.load(f)["workloads"]}.get(args.workload)
    if chips is None:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    if chips > 1 and rank_of is None:
        return launch.launch([sys.executable, str(Path(__file__).resolve()),
                              *sys.argv[1:]], chips, started)
    from gwas_bench import harness, spec

    import pygemma_tpu_torch  # noqa: F401  (the system under test)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 3
    cell = spec.load_cell(args.workload)
    result = harness.run(args.workload, args.seed, args.seconds,
                         bool(args.trace), "cuda", cell, started,
                         log=lambda s: print(s, file=sys.stderr, flush=True))
    if result is None:  # a rank other than 0: rank 0 reports
        return 0
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

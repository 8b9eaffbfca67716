"""One rank of a multi-card cell on the CPU, for the launcher's tests.

    python gwas_bench/tests/cpu_rank.py --workload ukb_synth_50k.mesh4 \\
        --seed <n> --seconds <s> --trace 0|1 --ranks 2 [--kill-in-window F]

``launch.launch`` starts it once a rank, as ``run.py`` starts itself: it
runs ``harness.run`` with the cell shrunk to a test's size (``conftest``)
on a mesh of ``--ranks`` gloo ranks, and rank 0 prints the result line.
With ``--kill-in-window F``, rank 1 writes the time to ``F`` and kills
itself (SIGKILL) as its second window call starts; ``--fault`` plants one
of ``faults.py``'s faults in every rank.
"""

import argparse
import contextlib
import json
import os
import signal
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parents[1]))
sys.path.insert(0, str(HERE))

from conftest import small  # noqa: E402
from gwas_bench import faults, harness, launch, spec  # noqa: E402


def _die_in_window(path: str) -> None:
    """Rank 1's third call (set-up's warm-up, then two in the window)
    kills its process."""
    real = harness.Program.call
    made = []

    def call(self, i):
        made.append(i)
        if len(made) == 3:
            Path(path).write_text(repr(time.time()))
            os.kill(os.getpid(), signal.SIGKILL)
        return real(self, i)

    harness.Program.call = call


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--ranks", type=int, required=True)
    ap.add_argument("--kill-in-window")
    ap.add_argument("--fault", choices=faults.NAMES)
    args = ap.parse_args()
    torch.set_num_threads(2)  # two ranks share the test machine's cores
    cell = small(spec.load_cell(args.workload))
    cell = cell._replace(chips=args.ranks, traffic=dict(
        cell.traffic, mesh={"snp": args.ranks, "sample": 1}))
    if args.kill_in_window and os.environ["RANK"] == "1":
        _die_in_window(args.kill_in_window)
    with (faults.plant(args.fault) if args.fault
          else contextlib.nullcontext()):
        result = harness.run(args.workload, args.seed, args.seconds,
                             bool(args.trace), "cpu", cell,
                             launch.launched_at(),
                             log=lambda s: print(s, file=sys.stderr,
                                                 flush=True))
    if result is not None:
        print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The control of `correct`: the plain reference in float8 put in the
program's place, read on the chip at the cell's own size.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 --seconds 20

For each seed, one run of the cell as a benchmark run makes it (the
program serves the cell's traffic for --seconds), then, on the run's own
samples (check.py): the float32 reference's widest admission gap of the
tokens the program served (max_logit_gap, and sampled_logit_gap where the
traffic samples: lower readings) and of the tokens the float8 reference
draws at the same positions (control_*: upper readings). One JSON line a
seed, with the run's end-to-end metrics.
"""

from __future__ import annotations

import time

T_PROC = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    args = ap.parse_args(argv)
    from benchmark import harness

    spec = harness.cell_spec(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        result, compared = harness.run_cell(spec, seed, args.seconds, False,
                                            time.monotonic(), control=True)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          **{n: v for n, v, _ in compared},
                          **{n: m["value"] for n, m in result["metrics"].items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

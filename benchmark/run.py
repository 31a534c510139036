"""Run one cell of BENCHMARK.json on this machine's card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

prints one JSON line (correct, attempted, failed, metrics, device, and with
--trace 1 the breakdown; the numbers compared for `correct`, each with its
limit, last under "checks") and the same numbers on standard error. Exits
non-zero, with no result, when CUDA or the cell's cards are missing, or
when jax, jaxlib, flax or the JAX package is loaded once the window has
closed. --rate overrides an open-loop cell's arrival rate (the knee
sweep); --dump writes every reading and request record to a file.
"""

from __future__ import annotations

import time

T_PROC = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".benchmark_cache")
# the program's build and kernel caches, at fixed paths in the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE, "cuda")
# libraries that would load JAX by themselves
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rate", type=float, default=None)
    ap.add_argument("--dump", default=None)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness

    spec = harness.cell_spec(args.workload)
    need = int(spec["workload"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"needs {need} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, compared = harness.run_cell(spec, args.seed, args.seconds,
                                        bool(args.trace), T_PROC, rate=args.rate,
                                        dump=args.dump)
    for name, value, limit in compared:
        print(f"check {name}: {value} (limit {limit})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Where load_model's time goes on the card, against the route before it.

    python -m tpu_engine_torch.tools.load_trace              # needs one CUDA card
    python -m tpu_engine_torch.tools.load_trace model.gguf --family llama3.1:32

For each GGUF (those named, and those written by tools/family_gguf.py from
seed 0 at a family's published widths cut to LAYERS layers; with neither,
gemma2, qwen2, phi3 and llama3.1 at 2 layers and llama3.1 at its published
32), reads the whole file once first, so the page cache is warm for every
timed load, then times --repeats runs (median of each phase; the first
new-route run is also kept whole: in the first file it carries what the
process pays once) of:

  new  load_model(path) on the card: its LoadedModel.load_split (read,
       tokenizer, stage: host copies into the pinned staging buffers,
       upload and extract: CUDA events around the raw uploads and the
       extract kernels, dense, permute_fuse, norms) and its total, the
       host's wall time until a synchronize;
  old  the route before the extract kernel: load_model(path, device="cpu")
       (extract_plain, numpy, for every quantized tensor) and then every
       weight moved to the card (qtensor_to), timed to a synchronize.

Every number is the card's and this host's: the card's name and power
limit are printed beside them, and the seconds the process took to
create its CUDA context before any load. Prints one JSON line per file
and writes chiprun_out/load_trace.json under the current directory.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile
import time

import numpy as np
import torch

from ..kernels import _build
from ..model.loader import load_model
from ..model.weights import QTensor, qtensor_to
from . import family_gguf as FG

DEFAULT_FAMILIES = ["gemma2:2", "qwen2:2", "phi3:2", "llama3.1:2",
                    "llama3.1:32"]


def smi_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi: not available"


def warm(path: str) -> float:
    """Read the whole file once (the page cache then holds it); seconds."""
    t0 = time.time()
    with open(path, "rb") as f:
        while f.read(64 << 20):
            pass
    return time.time() - t0


def to_card(weights):
    """Every tensor of a weight tree on cuda (a tied tensor moved once)."""
    seen = {}

    def put(x):
        if id(x) not in seen:
            if isinstance(x, QTensor):
                seen[id(x)] = qtensor_to(x, "cuda")
            elif isinstance(x, torch.Tensor):
                seen[id(x)] = x.to("cuda")
            elif isinstance(x, dict):
                seen[id(x)] = {k: put(v) for k, v in x.items()}
            elif isinstance(x, list):
                seen[id(x)] = [put(v) for v in x]
            else:
                seen[id(x)] = x
        return seen[id(x)]

    return put(weights)


def new_route(path: str) -> dict:
    torch.cuda.synchronize()
    lm = load_model(path)
    split = dict(lm.load_split)
    del lm
    torch.cuda.empty_cache()
    return split


def old_route(path: str) -> dict:
    t0 = time.time()
    lm = load_model(path, device="cpu")
    t1 = time.time()
    on_card = to_card(lm.weights)
    torch.cuda.synchronize()
    t2 = time.time()
    split = {f"cpu {k}": v for k, v in lm.load_split.items()}
    split.update(cpu_load=t1 - t0, upload=t2 - t1, total=t2 - t0)
    del lm, on_card
    torch.cuda.empty_cache()
    return split


def medians(runs: list[dict]) -> dict:
    return {k: float(np.median([r[k] for r in runs])) for k in runs[0]}


def trace(path: str, label: str, repeats: int, smi: str) -> dict:
    warm_s = warm(path)
    out = dict(file=label, path=path, gb=os.path.getsize(path) / 1e9,
               device=smi, repeats=repeats, warm_read_s=warm_s,
               page_cache="warm (the file was read once before)")
    runs = [new_route(path) for _ in range(repeats)]
    out["new_first"] = runs[0]
    out["new"] = medians(runs)
    out["old"] = medians([old_route(path) for _ in range(repeats)])
    out["speedup"] = out["old"]["total"] / out["new"]["total"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("paths", nargs="*", help="GGUF files to load")
    ap.add_argument("--family", action="append", default=None,
                    metavar="NAME:LAYERS",
                    help="write tools/family_gguf.py's NAME cut to LAYERS "
                         "layers and trace it (repeatable)")
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("load_trace: no CUDA device")
    families = (args.family if args.family is not None
                else ([] if args.paths else DEFAULT_FAMILIES))
    smi = smi_line()
    t0 = time.time()
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    cuda_init_s = time.time() - t0
    _build.build_all()  # nvcc before any timed load
    jobs = [(p, None, 0) for p in args.paths]
    for spec in families:
        name, layers = spec.split(":")
        jobs.append((None, name, int(layers)))
    results = []
    with tempfile.TemporaryDirectory(dir=os.getcwd(),
                                     prefix=".smoke_load_") as tmp:
        for path, family, layers in jobs:
            label = os.path.basename(path) if family is None else (
                f"{family} {layers} layers")
            if family is not None:
                path = os.path.join(tmp, f"{family}-{layers}l.gguf")
                t0 = time.time()
                FG.build_family_gguf(path, family, n_layer=layers, seed=0)
                print(f"wrote {path} ({os.path.getsize(path) / 1e9:.2f} GB) in "
                      f"{time.time() - t0:.1f}s", flush=True)
            res = trace(path, label, args.repeats, smi)
            print(json.dumps(res), flush=True)
            results.append(res)
            if family is not None:
                os.remove(path)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "load_trace.json"), "w") as f:
        json.dump(dict(device=smi, cuda_init_s=cuda_init_s, files=results),
                  f, indent=1)
    print(f"CUDA context in {cuda_init_s:.2f}s", flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

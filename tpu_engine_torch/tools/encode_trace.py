"""Where an embedding model's encode spends its time on the card.

    python -m tpu_engine_torch.tools.encode_trace     # needs one CUDA card

Writes the two full-width random encoders of tools/encoder_gguf.py (bge-base
widths at Q8_0, nomic-embed-v1.5 widths at the Q4_K_M mix, seed 0), and
for each prompt bucket times one encode (model/bert.encode through the
qmm kernels) by the host clock around a synchronised call (median of 10),
then traces one encode with torch.profiler and reads the trace's device
activity: the card's busy time (the union of kernel, copy and set
intervals), its idle share of the wall time, and the busy time by kernel
family. At 8, 128 and 512 tokens it also times eight encodes done one
after another, by eight threads at once, and by eight threads under one
lock. Prints one JSON line per (model, bucket) and the card's name and
power limit; writes chiprun_out/encode_trace.json.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from ..model.bert import encode
from ..model.loader import load_model
from . import encoder_gguf as EG

N_CONCURRENT = 8  # encodes at once, as chip_smoke.py's burst sends
MODELS = [("bge-base Q8_0", "bge-base", "q8_0"),
          ("nomic-embed-v1.5 Q4_K_M", "nomic-embed-v1.5", "q4_k_m")]
FAMILIES = [("qmm", ("qmm_kernel",)),
            ("gemm (attention einsums)", ("gemm", "Kernel2", "cutlass", "sm90_")),
            ("softmax", ("softmax",)),
            ("reduce (LayerNorm, pooling)", ("reduce",)),
            ("copy / set", ("Memcpy", "Memset", "copy"))]


def _family(name: str) -> str:
    for fam, keys in FAMILIES:
        if any(k in name for k in keys):
            return fam
    return "elementwise and other"


def device_activity(trace_path: str) -> tuple[float, dict, int]:
    """(busy ms: the union of device intervals, busy ms by kernel family,
    number of device events) from a chrome trace of torch.profiler."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    by_fam: dict[str, float] = {}
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in dev)
    busy, end = 0.0, -1e30
    for t0, t1 in spans:
        if t1 > end:
            busy += t1 - max(t0, end)
            end = t1
    for e in dev:
        fam = _family(e.get("name", ""))
        by_fam[fam] = by_fam.get(fam, 0.0) + float(e["dur"]) / 1e3
    return busy / 1e3, by_fam, len(dev)


def trace_encode(run) -> dict:
    from torch.profiler import ProfilerActivity, profile

    with tempfile.TemporaryDirectory() as d:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        busy, by_fam, n = device_activity(path)
    if n == 0:
        raise RuntimeError("the profiler traced no device activity")
    return dict(traced_wall_ms=wall, busy_ms=busy, idle_share=1 - busy / wall,
                device_events=n, busy_ms_by_family=by_fam)


def concurrent_encodes(runs: list) -> dict:
    """Wall ms of the encodes `runs` (callables) done one after another, by
    one thread each at once, and by one thread each under one lock (the
    HTTP server's threads encoding with and without serialising), each
    ended by a synchronise; medians of 5."""
    lock = threading.Lock()

    def locked(fn):
        with lock:
            fn()

    def threaded(wrap):
        ths = [threading.Thread(target=wrap, args=(fn,)) for fn in runs]
        for t in ths:
            t.start()
        for t in ths:
            t.join()

    ways = {"sequential": lambda: [fn() for fn in runs],
            "threads": lambda: threaded(lambda fn: fn()),
            "threads_locked": lambda: threaded(locked)}
    out = {}
    for name, way in ways.items():
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            way()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        out[name + "_ms"] = float(np.median(walls))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("encode_trace: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    out = []
    with tempfile.TemporaryDirectory() as tmp:
        for label, preset, level in MODELS:
            path = os.path.join(tmp, f"{preset}.gguf")
            if preset == "bge-base":
                EG.build_bert_gguf(path, preset, level, seed=0, pooling_type=2)
            else:
                EG.build_nomic_bert_gguf(path, preset, level, seed=0)
            lm = load_model(path, device="cuda")
            cfg = lm.cfg
            rng = np.random.default_rng(0)
            for n in sorted({8, 32, 128, 512, cfg.n_ctx_train}):
                ids = rng.integers(5, cfg.n_vocab, n, dtype=np.int64)
                toks = torch.tensor(ids[None], dtype=torch.int32, device="cuda")
                nv = torch.tensor([n], dtype=torch.int32, device="cuda")

                def run():
                    return encode(lm.weights, toks, nv, cfg)

                for _ in range(3):
                    run()
                torch.cuda.synchronize()
                walls = []
                for _ in range(10):
                    t0 = time.perf_counter()
                    run()
                    torch.cuda.synchronize()
                    walls.append((time.perf_counter() - t0) * 1e3)
                row = dict(model=label, tokens=n, wall_ms=float(np.median(walls)),
                           **trace_encode(run))
                if n in (8, 128, 512):
                    row[f"{N_CONCURRENT}_encodes"] = concurrent_encodes(
                        [run] * N_CONCURRENT)
                print(json.dumps(row), flush=True)
                out.append(row)
            del lm
            torch.cuda.empty_cache()
    print(smi, flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "encode_trace.json"), "w") as f:
        json.dump({"device": smi, "rows": out}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

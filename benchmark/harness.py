"""One run of one cell: set-up, the measured window, the check, the result.

Set-up (setup_s, from the process's start to the window's first request):
the GGUF of the cell's configuration is written from the seed (weights
drawn on the device, gguf_file's header) under TMPDIR and deleted as soon
as /loadmodel has read it; tpu_engine_torch's HTTP server starts in this
process on a free localhost port; /loadmodel loads the file with the
cell's load fields (n_parallel, ctx_len, cache_type) and runs the
program's own warm-up; the load generator starts as a process of its own
and builds its schedule from the seed.

The window: the generator drives the cell's traffic for `seconds`. With
trace on, torch.profiler records the middle of the window (TRACE_S at
most) and trace.Tracer's spans give the per-layer numbers.

After the window: the peak of device memory is read, the engine is shut
down and its memory freed, and check.run compares what was served with
the reference. Then every metric of the cell is read by its reader
(metrics/), and the result printed.
"""

from __future__ import annotations

import gc
import http.client
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import torch

from . import check, flops, gguf_file, stats, trace
from .traffic import load_body
from .weights import draw_tensors, tensor_table

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
TRACE_S = 10.0  # longest traced span of a window
MODEL_ID = "bench"
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_engine")


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_spec(workload: str, manifest_path: str | None = None) -> dict:
    """Everything BENCHMARK.json and the cell's files say about one cell."""
    man = _json(manifest_path or os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in man["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}")
    w = cells[workload]
    conf = {c["name"]: c for c in man["configs"]}[w["config"]]

    def here(m):
        return "workloads" not in m or workload in m["workloads"]

    return {"workload": w, "cfg": _json(os.path.join(ROOT, conf["file"])),
            "traffic": _json(os.path.join(HERE, "traffic", w["traffic"] + ".json")),
            "check": _json(os.path.join(HERE, "checks", workload + ".json")),
            "end_to_end": [m for m in man["end_to_end"] if here(m)],
            "per_layer": [m for m in man["per_layer"] if here(m)]}


def reader(name: str):
    """metrics/<name>.py, or metrics/<prefix>.py with prefix the part of
    the name before its first dot; its read(run) -> number or None."""
    for stem in (name, name.split(".")[0]):
        path = os.path.join(HERE, "metrics", stem + ".py")
        if os.path.exists(path):
            spec = importlib.util.spec_from_file_location(f"bench_metric_{stem}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise FileNotFoundError(f"no reader for metric {name!r} in metrics/")


def write_gguf(cfg: dict, seed: int, device, path: str) -> list:
    """Write the configuration's GGUF from the seed; returns each tensor's
    checksum (int64 sum of its bytes)."""
    header = gguf_file.header_bytes(gguf_file.model_metadata(cfg), tensor_table(cfg))
    sums = []
    with open(path, "wb") as f:
        f.write(header)
        for _, _, _, data in draw_tensors(cfg, seed, device):
            sums.append(data.to(torch.int64).sum())
            host = data.cpu().numpy()
            f.write(memoryview(host))
            f.write(b"\0" * (-host.size % gguf_file.ALIGNMENT))
    return torch.stack(sums).tolist()


class Server:
    """tpu_engine_torch.api.server in a thread of this process."""

    def __init__(self, device: str):
        from tpu_engine_torch.api.server import make_server

        self.srv = make_server("127.0.0.1", 0, device=device)
        self.port = self.srv.server_address[1]
        self.thread = threading.Thread(target=self.srv.serve_forever,
                                       name="bench-http", daemon=True)
        self.thread.start()

    def post(self, path: str, body: dict, timeout: float = 1800.0) -> dict:
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=timeout)
        try:
            conn.request("POST", path, json.dumps(body),
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            out = json.loads(resp.read() or b"{}")
            if resp.status != 200:
                raise RuntimeError(f"{path} -> HTTP {resp.status}: {out}")
            return out
        finally:
            conn.close()

    def engine(self):
        return self.srv.registry.check_loaded(MODEL_ID).engine

    def stop(self) -> None:
        """Stop serving and free the engine: its loop ends, every reply
        still awaited fails at once (the generator has gone), and the model
        and cache are dropped."""
        from tpu_engine_torch.serve.types import TaskResult

        entry = self.srv.registry.check_loaded(MODEL_ID)
        self.srv.shutdown()
        if entry is not None:
            eng = entry.engine
            self.srv.registry.unload_model(MODEL_ID)
            for tid in list(getattr(eng, "_results", {})):
                eng._emit(tid, TaskResult(task_id=tid, error=True, stop=True,
                                          error_message="benchmark ended"))
        self.srv.server_close()


class Run:
    """What the metric readers read (metrics/*.py: read(run))."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def start_loadgen(spec: dict, seed: int, port: int, grace_s: float):
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    p = subprocess.Popen([sys.executable, os.path.join(HERE, "loadgen.py")],
                         stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                         env=env, cwd=ROOT, text=True)
    p.stdin.write(json.dumps({
        "cfg": spec["cfg"], "traffic": spec["traffic"], "seed": seed,
        "host": "127.0.0.1", "port": port, "model": MODEL_ID,
        "grace_s": grace_s}) + "\n")
    p.stdin.flush()
    line = p.stdout.readline()
    if line.strip() != "ready":
        p.kill()
        raise RuntimeError(f"load generator failed to start: {line!r}")
    return p


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(spec: dict, seed: int, seconds: float, traced: bool, t_proc: float,
             device: str = "cuda", rate: float | None = None,
             dump: str | None = None, control: bool = False) -> tuple[dict, list]:
    """One run; returns (result line, [(name, value, limit)] compared)."""
    cfg, traffic = spec["cfg"], dict(spec["traffic"])
    if rate is not None:
        traffic["rate_per_s"] = rate
        spec = dict(spec, traffic=traffic)
    dev = torch.device(device)
    tmp = tempfile.gettempdir()
    path = os.path.join(tmp, f"bench-{spec['workload']['name']}-{os.getpid()}.gguf")
    try:
        t0 = time.monotonic()
        sums = write_gguf(cfg, seed, dev, path)
        gguf_s = time.monotonic() - t0
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        srv = Server(device)
        body = {"model": MODEL_ID, "llama_model_path": path}
        body.update(load_body(cfg, traffic))
        t0 = time.monotonic()
        srv.post("/loadmodel", body)
        loadmodel_s = time.monotonic() - t0
    finally:
        if os.path.exists(path):
            os.remove(path)
    engine = srv.engine()
    load_split = dict(getattr(engine.model, "load_split", {}) or {})

    tracer = trace.Tracer(cfg["num_hidden_layers"], cfg["vocab_size"]) if traced else None
    prof = None
    if tracer is not None:
        tracer.engine = engine
        tracer.install()
        # started on an idle card, before the window: a start while the
        # engine launches can stall for seconds or miss the kernels
        prof = _profiler(dev)
        prof.start()
    gen = start_loadgen(spec, seed, srv.port, float(traffic.get("grace_s", 30.0)))
    try:
        t_start = time.monotonic() + 0.2
        t_end = t_start + seconds
        gen.stdin.write(json.dumps({"t_start": t_start, "t_end": t_end}) + "\n")
        gen.stdin.flush()
        setup_s = t_start - t_proc
        traced_window = _spans_to_end(tracer, t_start, t_end) if tracer else None
        out, _ = gen.communicate(timeout=seconds + 600)
    finally:
        if gen.poll() is None:
            gen.kill()
            gen.wait()
    if gen.returncode != 0:
        raise RuntimeError(f"load generator exited with {gen.returncode}")
    records = json.loads(out.strip().splitlines()[-1])
    peak_bytes = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    tr = None
    if tracer is not None:
        tr = _reduce_trace(tracer, prof, traced_window, dev)
        tracer.uninstall()
    srv.stop()
    del engine, srv
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_check = time.monotonic()
    compared = check.run(cfg, spec["check"], records, seed, dev, sums, control)
    check_s = time.monotonic() - t_check
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"forbidden modules loaded in this process: {bad}")

    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    run = Run(records=records, t0=t_start, t1=t_end, seconds=seconds,
              setup_s=setup_s, load_split=load_split, loadmodel_s=loadmodel_s,
              trace=tr, cfg=cfg, traffic=traffic)
    metrics = {}
    for m in (spec["per_layer"] if traced else spec["end_to_end"]):
        v = reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device_out = {"platform": "gpu" if dev.type == "cuda" else "cpu", "kind": name,
                  "count": 1, "memory_peak_bytes": int(peak_bytes)}
    if tr is not None:
        device_out.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
    correct = all(v <= lim for _, v, lim in compared if lim is not None)
    result = {"correct": correct,
              "attempted": len(stats.due_in_window(records, t_start, t_end)),
              "failed": sum(1 for r in records if "error" in r),
              "metrics": metrics, "device": device_out}
    if tr is not None:
        result["breakdown"] = {"device_ops": [list(x) for x in tr["device_ops"]],
                               "idle_gaps": [list(x) for x in tr["idle_gaps"]]}
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in compared}
    if dump:
        with open(dump, "w") as f:
            json.dump({"result": result, "records": records, "trace": tr,
                       "load_split": load_split, "loadmodel_s": loadmodel_s,
                       "gguf_s": gguf_s, "setup_s": setup_s,
                       "check_s": check_s,
                       "window": [t_start, t_end],
                       "all": {m["name"]: reader(m["name"])(run) for m in
                               spec["end_to_end"] + spec["per_layer"]}},
                      f)
    return result, compared


def _profiler(dev):
    """The device's activity only (kernels, copies, the runtime calls that
    launched them); host spans are the Tracer's own."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] if dev.type == "cuda" else [ProfilerActivity.CPU]
    return profile(activities=acts, record_shapes=False, with_stack=False)


def _spans_to_end(tracer, t_start: float, t_end: float) -> tuple:
    """Record the Tracer's spans over the end of the window (TRACE_S at
    most); returns that span of time on the host's clock (ns)."""
    length = min(TRACE_S, t_end - t_start - 1.0)
    time.sleep(max(0.0, t_end - length - time.monotonic()))
    a_ns = time.time_ns()
    tracer.on = True
    time.sleep(max(0.0, t_end - time.monotonic()))
    tracer.on = False
    return a_ns, time.time_ns()


def _reduce_trace(tracer, prof, traced_window, dev) -> dict:
    """Stop the profiler (the load generator has finished, so its stop,
    which synchronizes and gathers its buffers, delays nothing measured)
    and reduce the traced span of the window."""
    t0 = time.monotonic()
    prof.stop()
    events = prof.profiler.kineto_results.events()
    t1 = time.monotonic()
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    out = trace.reduce(events, *traced_window, tracer, flops.peaks(name))
    out.update(stop_s=t1 - t0, reduce_s=time.monotonic() - t1)
    return out

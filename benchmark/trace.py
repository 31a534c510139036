"""The traced run's instrumentation and the reduction of its trace.

Tracer.install() wraps, from the benchmark's side, the calls into the
program's layers (all by attribute, so nothing of the program is edited):

  - serve.engine.InferenceEngine's host steps (_process_tasks,
    _launch_slot, _prefill_group, _prefill_chunk, _dispatch_chunk,
    _process_chunk, _consume_pending_first, _settle_all, _decode_host) and
    serve.ops.EngineOps.pull, each a host span named by its method;
  - serve.ops.EngineOps.step and .dloop, whose host arguments (slots,
    active rows, tokens a row) and the engine's slot lengths give every
    row's start and new tokens: the step's context;
  - kernels.dequant_matmul.qmm_cuda and kernels.flash_attention.
    flash_attention, each call a span with the operations and bytes that
    call needs (flops.py) and the useful model operations in it (active
    rows only).

Spans are kept in lists on the host's clock (time.time_ns, the clock the
profiler's events are given in), not as profiler events: the profiler
records the device only (kernels, copies, and the runtime calls that
launched them), so it costs the engine little and stops quickly.
Wrappers record only while `on`, i.e. inside the traced window, and pass
everything through. A program whose names moved leaves the wrapper out
and the metrics that need it silent.

reduce() reads the profiler's raw events: device activity gives the busy
time and every kernel's time by name, its complement the idle gaps (each
named by the innermost host span in flight at its middle), and each
kernel's launch (its runtime call, by correlation id) falls in one call's
span, which gives that call's device time.
"""

from __future__ import annotations

import bisect
import functools
import re
import time

from . import flops

HOST_STEPS = ("_process_tasks", "_launch_slot", "_prefill_group",
              "_prefill_chunk", "_dispatch_chunk", "_process_chunk",
              "_consume_pending_first", "_settle_all", "_decode_host")


def kernel_name(raw: str) -> str:
    """`void ns::(anonymous namespace)::name<...>(...)` -> `ns::name`."""
    s = raw.replace("(anonymous namespace)::", "")
    s = s[5:] if s.startswith("void ") else s
    return re.split(r"[<(]", s, maxsplit=1)[0].strip()


class Tracer:
    def __init__(self, n_layer: int, vocab: int):
        self.n_layer, self.vocab = n_layer, vocab
        self.on = False
        self.engine = None
        self.calls: list = []  # (kind, need ops, need bytes, useful ops, t0, t1)
        self.host: list = []  # (method, t0, t1), ns
        self.ctx = None  # the step in flight: rows, decode, attention calls
        self._undo: list = []

    # -- wrappers ------------------------------------------------------------
    def _patch(self, owner, name: str, make) -> None:
        orig = getattr(owner, name, None)
        if orig is None:
            return
        setattr(owner, name, make(orig))
        self._undo.append((owner, name, orig))

    def uninstall(self) -> None:
        for owner, name, orig in reversed(self._undo):
            setattr(owner, name, orig)
        self._undo = []

    def install(self) -> None:
        from tpu_engine_torch.kernels import dequant_matmul, flash_attention
        from tpu_engine_torch.serve import engine, ops

        for name in HOST_STEPS:
            self._patch(engine.InferenceEngine, name, functools.partial(
                self._span_wrap, name))
        self._patch(ops.EngineOps, "pull", functools.partial(self._span_wrap, "pull"))
        self._patch(ops.EngineOps, "step", self._step_wrap)
        self._patch(ops.EngineOps, "dloop", self._dloop_wrap)
        self._patch(dequant_matmul, "qmm_cuda", self._qmm_wrap)
        self._patch(flash_attention, "flash_attention", self._attn_wrap)

    def _span_wrap(self, span: str, orig):
        tracer = self

        @functools.wraps(orig)
        def w(*a, **kw):
            if not tracer.on:
                return orig(*a, **kw)
            t0 = time.time_ns()
            try:
                return orig(*a, **kw)
            finally:
                tracer.host.append((span, t0, time.time_ns()))
        return w

    def _call(self, kind: str, need: tuple, useful: float, fn, *a):
        t0 = time.time_ns()
        try:
            return fn(*a)
        finally:
            self.calls.append((kind, need[0], need[1], useful, t0, time.time_ns()))

    def _starts(self, slot_ids) -> list:
        slots = self.engine.slots
        return [slots[int(s)].n_past for s in slot_ids]

    def _step_wrap(self, orig):
        tracer = self

        @functools.wraps(orig)
        def w(ops_self, tokens, slot_ids, active, n_valid=None, *a, **kw):
            if not tracer.on or tracer.engine is None:
                return orig(ops_self, tokens, slot_ids, active, n_valid, *a, **kw)
            import numpy as np

            B, Tc = np.asarray(tokens).shape
            nv = (np.full(B, Tc) if n_valid is None else np.asarray(n_valid))
            act = np.asarray(active, bool)
            tracer.ctx = {"rows": list(zip(tracer._starts(slot_ids),
                                           nv.tolist(), act.tolist())),
                          "decode": False, "attn": 0}
            try:
                return orig(ops_self, tokens, slot_ids, active, n_valid, *a, **kw)
            finally:
                tracer.ctx = None
        return w

    def _dloop_wrap(self, orig):
        tracer = self

        @functools.wraps(orig)
        def w(ops_self, n_inner, active, *a, **kw):
            if not tracer.on or tracer.engine is None:
                return orig(ops_self, n_inner, active, *a, **kw)
            import numpy as np

            act = np.asarray(active, bool)
            ahead = tracer.engine._inflight()
            starts = tracer._starts(range(len(act)))
            tracer.ctx = {"rows": [(s + (ahead if x else 0), 1, bool(x))
                                   for s, x in zip(starts, act.tolist())],
                          "decode": True, "attn": 0}
            try:
                return orig(ops_self, n_inner, active, *a, **kw)
            finally:
                tracer.ctx = None
        return w

    def _rows_now(self):
        """(all rows [(start, new)], active rows) of the forward step the
        current attention call belongs to."""
        ctx = self.ctx
        j = ctx["attn"] // self.n_layer if ctx["decode"] else 0
        rows = [(s + (j if a else 0), n, a) for s, n, a in ctx["rows"]]
        return rows

    def _qmm_wrap(self, orig):
        tracer = self

        @functools.wraps(orig)
        def w(x, qt):
            if not tracer.on or tracer.ctx is None:
                return orig(x, qt)
            m = x.shape[0]
            n, k = qt.shape
            wb = flops.WEIGHT_BYTES.get((qt.kind, qt.group, qt.bias is not None))
            if wb is None:
                return orig(x, qt)
            ops_, byts = flops.qmm_need(m, n, k, wb)
            rows = tracer._rows_now()
            if n == tracer.vocab:  # the head: one row a sequence
                useful = sum(1 for _, nv, a in rows if a and nv > 0)
            else:
                useful = sum(nv for _, nv, a in rows if a)
            return tracer._call("qmm", (ops_, byts), 2.0 * useful * n * k,
                                orig, x, qt)
        return w

    def _attn_wrap(self, orig):
        tracer = self

        @functools.wraps(orig)
        def w(q, cache, li, slot_ids, q_pos, n_valid, k_new, v_new, cfg,
              *a, **kw):
            if not tracer.on or tracer.ctx is None:
                return orig(q, cache, li, slot_ids, q_pos, n_valid, k_new,
                            v_new, cfg, *a, **kw)
            rows = tracer._rows_now()
            tracer.ctx["attn"] += 1
            win = kw.get("win")
            window = int(cfg.layer_window(li) if win is None else win)
            H, D, KH = q.shape[2], q.shape[3], k_new.shape[1]
            kvb = flops.KV_BYTES.get(cache.kind, 2.0)
            need = flops.attention_need([(s, n) for s, n, _ in rows], H, KH, D,
                                        kvb, 2.0, window)
            useful = flops.attention_need([(s, n) for s, n, a in rows if a], H,
                                          KH, D, kvb, 2.0, window)[0]
            return tracer._call("attn", need, useful, functools.partial(
                orig, q, cache, li, slot_ids, q_pos, n_valid, k_new, v_new,
                cfg, *a, **kw))
        return w


# -- reduction ------------------------------------------------------------------

def _ev(e):
    """(name, activity, start_ns, end_ns, correlation, linked correlation,
    on the device)"""
    start = e.start_ns()
    kind = e.activity_type() if hasattr(e, "activity_type") else ""
    return (e.name(), str(kind).lower(),
            start, start + e.duration_ns(), e.correlation_id(),
            e.linked_correlation_id(), str(e.device_type()).endswith("CUDA"))


def _union(intervals, lo: int, hi: int) -> list:
    out = []
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce(events, t0_ns: int, t1_ns: int, tracer: Tracer, peak: dict | None) -> dict:
    """Summary of one traced window [t0_ns, t1_ns] (host clock, ns):
    busy_s and window_s; kernel_s, the device seconds inside the window of
    every kernel name (kernel_name()), and device_ops, its ten longest;
    idle_gaps, the ten longest sums of gaps by the host span they fell in;
    with a peak, each traced call kind's least and device seconds."""
    lo = t0_ns - 1_000_000_000  # a launch runs at most this far ahead
    evs = [_ev(e) for e in events if e.start_ns() + e.duration_ns() >= lo
           and e.start_ns() <= t1_ns]
    device = [e for e in evs if e[6] and "annotation" not in e[1]]
    # runtime calls (cudaLaunchKernel, cuLaunchKernel, ...): host events
    # named cu*, matched to kernels by correlation id
    launch = {e[4]: e[2] for e in evs if not e[6] and e[0].startswith("cu")}
    host = sorted(tracer.host, key=lambda h: h[1])
    calls = tracer.calls

    busy = _union([(e[2], e[3]) for e in device], t0_ns, t1_ns)
    busy_ns = sum(b - a for a, b in busy)

    ops_time: dict = {}
    for e in device:
        inside = min(e[3], t1_ns) - max(e[2], t0_ns)
        if inside > 0:
            k = kernel_name(e[0])
            ops_time[k] = ops_time.get(k, 0.0) + inside / 1e9

    gaps: dict = {}
    starts = [h[1] for h in host]
    prev = t0_ns
    for a, b in busy + [[t1_ns, t1_ns]]:
        if a > prev:
            mid = (prev + a) // 2
            name = "no_engine_span"
            i = bisect.bisect_right(starts, mid)
            # innermost = latest-starting span that still covers mid
            for h in reversed(host[max(0, i - 64):i]):
                if h[2] >= mid:
                    name = h[0]
                    break
            gaps[name] = gaps.get(name, 0.0) + (a - prev) / 1e9
        prev = max(prev, b)

    # device time of each qmm / attention call, by kernel name
    order = sorted(range(len(calls)), key=lambda i: calls[i][4])
    span_starts = [calls[i][4] for i in order]
    call_dev: dict = {}
    for e in device:
        t = launch.get(e[5]) or launch.get(e[4])
        if t is None or not t0_ns <= t < t1_ns:
            continue
        j = bisect.bisect_right(span_starts, t) - 1
        if j < 0 or calls[order[j]][5] < t:
            continue
        idx = order[j]
        if calls[idx][0] not in kernel_name(e[0]):
            continue  # casts and sums launched inside the call
        call_dev[idx] = call_dev.get(idx, 0.0) + (e[3] - e[2]) / 1e9

    out = {"busy_s": busy_ns / 1e9, "window_s": (t1_ns - t0_ns) / 1e9,
           "kernel_s": ops_time,
           "device_ops": sorted(ops_time.items(), key=lambda kv: -kv[1])[:10],
           "idle_gaps": sorted(gaps.items(), key=lambda kv: -kv[1])[:10],
           "n_device_events": len(device), "n_calls_timed": len(call_dev)}
    if peak is not None:
        for kind in ("qmm", "attn"):
            bound = dev = 0.0
            for idx, t in call_dev.items():
                k, o, b = calls[idx][:3]
                if k == kind:
                    bound += flops.bound_s(o, b, peak)
                    dev += t
            out[f"{kind}_bound_s"], out[f"{kind}_device_s"] = bound, dev
        out["useful_ops"] = sum(calls[idx][3] for idx in call_dev)
        out["peak_flops"] = peak["flops"]
    return out

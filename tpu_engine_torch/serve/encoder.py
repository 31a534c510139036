"""Serving wrapper for bidirectional embedding models (bert family).

The port of the JAX package's serve/encoder.py. The reference serves
dedicated embedding models loaded with `model_type: embedding` through
the same engine interface as chat models. EncoderEngine has
InferenceEngine's task surface (request_completion / next_result /
request_cancel / warm_up / shutdown) but runs one bidirectional encode
per request: no slots, no decode loop, no KV cache.

Requests encode synchronously on the calling thread, one at a time. The
quantized products launch on the current CUDA stream
(kernels/dequant_matmul.py) and everything else is PyTorch on that
stream, so concurrent encodes would be correct; but an encode launches
560-920 small kernels from Python (bge-base / nomic-embed widths), and
eight of the HTTP server's threads dispatching at once contend for the
interpreter lock: on an H100 (700 W) eight such encodes took 4.2-5.2x
as long as the same eight serialised by a lock (tools/encode_trace.py).
So encodes take `_encode_lock`. Prompt lengths are bucketed to powers of two from 8, as
in the JAX package. The device is the one the model's weights lie on.
"""

from __future__ import annotations

import math
import threading
import time

import numpy as np
import torch

from ..model.bert import encode
from ..model.loader import LoadedModel
from .types import CompletionParams, StopReason, TaskResult


class EncoderEngine:
    def __init__(self, lm: LoadedModel, n_ctx: int = 512, **_unused):
        self.lm = lm
        self.cfg = lm.cfg
        self.tokenizer = lm.tokenizer
        self.device = lm.weights["token_embd_norm"].device
        self.n_ctx = min(int(n_ctx), lm.cfg.n_ctx_train)
        self.failed = False
        self.n_requests = 0
        self.slots: list = []  # registry inventory probes iterate this
        self._results: dict[int, TaskResult] = {}
        self._next_id = 0
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._encode_lock = threading.Lock()

    # -- engine surface ------------------------------------------------------
    def warm_up(self) -> None:
        """Encode the smallest bucket once (the reference's WarmUpModel)."""
        self.encode_ids([self.tokenizer.bos_id if self.tokenizer.bos_id >= 0
                         else 0, 1])

    def shutdown(self) -> None:
        pass

    def request_cancel(self, task_id: int) -> None:
        pass  # encodes are synchronous; nothing in flight to cancel

    def request_completion(self, params: CompletionParams) -> int:
        with self._lock:
            tid = self._next_id
            self._next_id += 1
            self.n_requests += 1
        result = self._run(tid, params)
        with self._cv:
            self._results[tid] = result
            self._cv.notify_all()
        return tid

    def next_result(self, task_id: int, timeout: float | None = None) -> TaskResult:
        deadline = time.time() + (timeout or 120.0)
        with self._cv:
            while task_id not in self._results:
                if not self._cv.wait(timeout=max(deadline - time.time(), 0.01)):
                    return TaskResult(task_id=task_id, error=True, stop=True,
                                      error_message="timeout")
            return self._results.pop(task_id)

    # -- internals -----------------------------------------------------------
    def prompt_ids(self, prompt) -> list[int]:
        """Token ids of a prompt (text or ids) as a request encodes them:
        an empty prompt becomes [bos], then cut to n_ctx."""
        if isinstance(prompt, str):
            ids = self.tokenizer.encode(prompt, add_special=True)
        else:
            ids = [int(t) for t in prompt]
        if not ids:
            ids = [self.tokenizer.bos_id if self.tokenizer.bos_id >= 0 else 0]
        return ids[: self.n_ctx]

    def _run(self, tid: int, params: CompletionParams) -> TaskResult:
        if not params.embedding:
            return TaskResult(
                task_id=tid, error=True, stop=True,
                error_message="This model is loaded for embeddings only "
                              "(model_type: embedding); chat completion is "
                              "not supported")
        t0 = time.time()
        ids = self.prompt_ids(params.prompt)
        try:
            vec = self.encode_ids(ids)
        except Exception as e:  # noqa: BLE001 — per-request isolation
            self.failed = True
            return TaskResult(task_id=tid, error=True, stop=True,
                              error_message=f"encode failed: {e}")
        norm = float(np.linalg.norm(vec))
        if norm > 0:
            vec = vec / norm  # common_embd_normalize L2
        ms = (time.time() - t0) * 1000.0
        return TaskResult(
            task_id=tid, stop=True, stop_reason=StopReason.EOS,
            tokens_evaluated=len(ids),
            embedding=[float(x) for x in vec],
            timings={"prompt_n": len(ids), "prompt_ms": round(ms, 2)},
        )

    def bucket(self, n: int) -> int:
        """Padded length of an n-token prompt: the next power of two from
        8, capped at n_ctx, and never below n (n_ctx not a power of two)."""
        return max(min(max(8, 1 << math.ceil(math.log2(n))), self.n_ctx), n)

    def encode_ids(self, ids: list[int]) -> np.ndarray:
        """Pooled, unnormalised [n_embd] f32 vector of ids on the host."""
        toks = torch.zeros((1, self.bucket(len(ids))), dtype=torch.int32)
        toks[0, : len(ids)] = torch.tensor(ids, dtype=torch.int32)
        with self._encode_lock:
            out = encode(self.lm.weights, toks.to(self.device),
                         torch.tensor([len(ids)], dtype=torch.int32,
                                      device=self.device), self.cfg)
            return out[0].cpu().numpy()

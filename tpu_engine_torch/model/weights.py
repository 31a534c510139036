"""Quantized weights as torch tensors, and the ops over them.

A QTensor holds one 2-D weight [N, K] (y = x @ W.T) in the unified
blockwise layout of quant/device_format.py, in NATURAL element order:

    "nib4": qs uint8 [N, K/2]  (element 2j = low nibble, 2j+1 = high)
    "i8":   qs int8  [N, K]
    scale f32 [N, K/G], bias f32 [N, K/G] or None

so dequant(W)[n, k] = qs[n, k] * scale[n, k//G] + bias[n, k//G], exactly
DeviceQuant.dequantize. Scale and bias stay f32 (exact for d*sc and
-dmin*m). The JAX package's group transposition and 128-lane k_pad exist
for TPU tiles only; the port has neither. "dense" tensors keep qs as a
float [N, K] and never reach a quantized kernel.

A quantized GGUF tensor reaches that layout through kernels/extract.py:
its raw block bytes are staged in row chunks, uploaded, and extracted by
the CUDA kernel on the card (extract_plain, the numpy to_device_format,
on the CPU).

Quantized products go through the hand-written CUDA kernels of
kernels/dequant_matmul.py (their plain PyTorch version on CPU tensors);
set_qmatmul_impl swaps the implementation, e.g. to hold the model against
the plain version on the card.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass

import numpy as np
import torch

from ..gguf.reader import GGUFFile
from ..kernels import extract as EX
from ..quant.device_format import (
    LAYOUTS,
    unpermute_group_transpose_i8,
    unpermute_group_transpose_nib4,
)

# raw bytes a staged chunk of a quantized tensor carries to the device
STAGE_BYTES = 32 << 20


@dataclass
class QTensor:
    """A (possibly) quantized 2-D weight [N, K] in natural element order."""

    qs: torch.Tensor  # dense weights, packed nibbles, or int8 values
    scale: torch.Tensor | None
    bias: torch.Tensor | None
    kind: str  # "dense" | "nib4" | "i8"
    group: int
    shape: tuple[int, int]

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.qs, self.scale, self.bias) if t is not None)


def _to(a: np.ndarray, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # e.g. a view of a JAX array
        a = a.copy()
    return torch.from_numpy(a).to(device)


class LoadSplit:
    """Where a load's time goes. Host phases add their wall seconds; the
    device phases ("upload", "extract") are timed by CUDA events around
    their work on the card (read once, by seconds(), after a synchronize),
    and by the host clock on the CPU."""

    DEVICE = ("upload", "extract")

    def __init__(self, device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.host = defaultdict(float)
        self.events = {k: [] for k in self.DEVICE}

    @contextlib.contextmanager
    def phase(self, name: str):
        if self.cuda and name in self.DEVICE:
            stream = torch.cuda.current_stream(self.device)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record(stream)
            yield
            e1.record(stream)
            self.events[name].append((e0, e1))
            return
        t0 = time.perf_counter()
        yield
        self.host[name] += time.perf_counter() - t0

    def seconds(self) -> dict:
        """{phase: seconds}; on the card, waits for the device first."""
        out = dict(self.host)
        if self.cuda:
            torch.cuda.synchronize(self.device)
            for k, evs in self.events.items():
                out[k] = sum(e0.elapsed_time(e1) for e0, e1 in evs) / 1e3
        return out


def extract_staged(raw: np.ndarray, ty, n: int, k: int, device,
                   split: LoadSplit) -> tuple:
    """(qs, scale, bias) of a quantized tensor on `device` from its raw
    block bytes (a read-only host view, e.g. the GGUF's mmap): the rows go
    in chunks of about STAGE_BYTES, each copied once into a staging buffer
    (pinned, from PyTorch's caching host allocator, on the card), uploaded
    without blocking and extracted into its rows of the outputs
    (kernels/extract.py). Rows hold whole blocks, so a chunk is a byte
    range. A staging buffer is reused only once its upload has finished,
    so the host copy of one chunk overlaps the upload of the one before."""
    dev = torch.device(device)
    qs, scale, bias = EX.alloc(ty, n, k, dev)
    row_bytes = raw.size // n
    rows = max(1, STAGE_BYTES // row_bytes)
    for r0 in range(0, n, rows):
        r1 = min(n, r0 + rows)
        with split.phase("stage"):
            buf = torch.empty((r1 - r0) * row_bytes, dtype=torch.uint8,
                              pin_memory=dev.type == "cuda")
            buf.numpy()[:] = raw[r0 * row_bytes:r1 * row_bytes]
        with split.phase("upload"):
            src = buf.to(dev, non_blocking=True)
        with split.phase("extract"):
            EX.extract(src, ty, r1 - r0, k, out=(
                qs[r0:r1], scale[r0:r1], None if bias is None else bias[r0:r1]))
    return qs, scale, bias


def qtensor_from_gguf(g: GGUFFile, name: str, device,
                      dtype=torch.float32,
                      split: LoadSplit | None = None) -> QTensor:
    """Convert one GGUF tensor to a QTensor on `device`: a quantized one
    through extract_staged (the extract kernel on the card), a dense one
    dequantized by numpy and uploaded. split: the load's LoadSplit."""
    ti = g.tensors[name]
    k = ti.shape[-1]
    n = ti.n_elems // k
    split = split or LoadSplit(device)
    if ti.ggml_type in LAYOUTS:
        lay = LAYOUTS[ti.ggml_type]
        qs, scale, bias = extract_staged(g.tensor_bytes(name), ti.ggml_type,
                                         n, k, device, split)
        return QTensor(qs=qs, scale=scale, bias=bias, kind=lay.kind,
                       group=lay.group, shape=(n, k))
    with split.phase("dense"):
        w = np.asarray(g.dequantize(name, np.float32)).reshape(n, k)
        return QTensor(qs=_to(w, device).to(dtype), scale=None, bias=None,
                       kind="dense", group=0, shape=(n, k))


def qtensor_to(qt: QTensor, device) -> QTensor:
    """The same weight on `device` (no copy where it already lies)."""
    return QTensor(*(None if a is None else a.to(device)
                     for a in (qt.qs, qt.scale, qt.bias)),
                   kind=qt.kind, group=qt.group, shape=qt.shape)


def _unpack_natural(qs: torch.Tensor, kind: str) -> torch.Tensor:
    """Quantized values -> f32 in natural element order. qs [..., K or K/2]."""
    if kind == "nib4":
        lo = (qs & 0x0F).to(torch.float32)
        hi = (qs >> 4).to(torch.float32)
        return torch.stack([lo, hi], dim=-1).reshape(*qs.shape[:-1], -1)
    return qs.to(torch.float32)


def _scaled(q: torch.Tensor, scale: torch.Tensor, bias, group: int):
    w = q * torch.repeat_interleave(scale, group, dim=-1)
    if bias is not None:
        w = w + torch.repeat_interleave(bias, group, dim=-1)
    return w


def dequant(qt: QTensor, dtype=torch.float32) -> torch.Tensor:
    """Full dequantization [N, K] (plain path, embeddings, tests)."""
    if qt.kind == "dense":
        return qt.qs.to(dtype)
    q = _unpack_natural(qt.qs, qt.kind)
    return _scaled(q, qt.scale, qt.bias, qt.group).to(dtype)


def embed_rows(qt: QTensor, ids: torch.Tensor, dtype=torch.float32):
    """Gather + dequantize rows (embedding lookup). ids: any int shape."""
    if qt.kind == "dense":
        return qt.qs[ids].to(dtype)
    q = _unpack_natural(qt.qs[ids], qt.kind)
    bias = qt.bias[ids] if qt.bias is not None else None
    return _scaled(q, qt.scale[ids], bias, qt.group).to(dtype)


def permute_rows(qt: QTensor, perm: np.ndarray) -> QTensor:
    """Permute output rows (axis N). Exact for every kind: quantization is
    along K, so each row travels with its own scales and bias. Used to
    de-interleave "norm"-rope q/k projections at load time."""
    idx = torch.as_tensor(np.asarray(perm, np.int64), device=qt.qs.device)
    return QTensor(
        qs=qt.qs[idx],
        scale=qt.scale[idx] if qt.scale is not None else None,
        bias=qt.bias[idx] if qt.bias is not None else None,
        kind=qt.kind, group=qt.group, shape=qt.shape)


def concat_qtensors(qts: list[QTensor]) -> QTensor | None:
    """Fuse weights along N (q|k|v, gate|up) so one product replaces
    several sharing an activation. Requires matching kind/group/K and
    uniform presence of a bias; returns None otherwise (the tensors then
    stay separate, e.g. Q4_K q/k beside a Q6_K v under Q4_K_M)."""
    k0 = qts[0]
    if any(t.kind != k0.kind or t.group != k0.group
           or t.shape[1] != k0.shape[1]
           or t.qs.dtype != k0.qs.dtype
           or (t.bias is None) != (k0.bias is None) for t in qts):
        return None
    return QTensor(
        qs=torch.cat([t.qs for t in qts], 0),
        scale=torch.cat([t.scale for t in qts], 0)
        if k0.scale is not None else None,
        bias=torch.cat([t.bias for t in qts], 0)
        if k0.bias is not None else None,
        kind=k0.kind, group=k0.group,
        shape=(sum(t.shape[0] for t in qts), k0.shape[1]))


# Quantized-product implementation; None = the kernel wrapper of
# kernels/dequant_matmul.py (CUDA kernel on the card, plain on the CPU).
_QMATMUL_IMPL = None


def set_qmatmul_impl(fn) -> None:
    """Install fn(x, qt) -> y as the quantized product (None resets to the
    kernels). chip_smoke.py installs the plain version to hold the model
    phase against it."""
    global _QMATMUL_IMPL
    _QMATMUL_IMPL = fn


def qmatmul(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """y = x @ W.T with W quantized. x: [..., K] -> [..., N]."""
    if qt.kind == "dense":
        return x @ qt.qs.t().to(x.dtype)
    fn = _QMATMUL_IMPL
    if fn is None:
        from ..kernels.dequant_matmul import qmatmul as fn
    return fn(x, qt)


# ---------------------------------------------------------------------------
# weights carried across from the JAX package
# ---------------------------------------------------------------------------

def _qt_from_mapping(m: dict, device) -> QTensor:
    """One JAX-package QTensor, given as a plain mapping {qs, scale, bias,
    kind, group, shape, perm, perm_shards, packed, k_pad} with numpy
    arrays, -> a natural-layout QTensor. qs may carry a leading layer axis;
    callers split stacked leaves first."""
    if m.get("packed"):
        raise ValueError("packed two-level k-quant scales are not supported "
                         "by from_jax_params (the JAX default is unpacked)")
    kind = m["kind"]
    n, k = m["shape"]
    qs = np.asarray(m["qs"])
    if kind == "dense":
        return QTensor(qs=_to(qs.astype(np.float32), device), scale=None,
                       bias=None, kind="dense", group=0, shape=(n, k))
    group = int(m["group"])
    scale = np.asarray(m["scale"], np.float32)  # widens bf16 storage
    bias = None if m["bias"] is None else np.asarray(m["bias"], np.float32)
    if m.get("perm"):
        shards = 1 if m.get("k_pad") else int(m.get("perm_shards", 1))
        unperm = (unpermute_group_transpose_nib4 if kind == "nib4"
                  else unpermute_group_transpose_i8)
        qs = unperm(qs, group, shards)
    # k_pad: zero groups at the tail in natural order -> strip them
    qs = qs[:, : (k // 2 if kind == "nib4" else k)]
    scale = scale[:, : k // group]
    bias = None if bias is None else bias[:, : k // group]
    return QTensor(qs=_to(qs, device), scale=_to(scale, device),
                   bias=None if bias is None else _to(bias, device),
                   kind=kind, group=group, shape=(n, k))


def _is_qt_mapping(v) -> bool:
    return isinstance(v, dict) and "qs" in v and "kind" in v


def _leaf(v, device):
    if _is_qt_mapping(v):
        return _qt_from_mapping(v, device)
    return _to(np.asarray(v, np.float32), device)


def _layer_of(v, li: int):
    """Layer li of a stacked leaf (array or QTensor mapping)."""
    if _is_qt_mapping(v):
        out = dict(v)
        for key in ("qs", "scale", "bias"):
            if out[key] is not None:
                out[key] = np.asarray(out[key])[li]
        return out
    return np.asarray(v)[li]


def from_jax_params(params: dict, cfg, device) -> dict:
    """The JAX package's LoadedModel.weights -> the port's weights dict.

    Each QTensor arrives as a plain mapping (see _qt_from_mapping); other
    leaves are numpy arrays. `layers` may be the stacked dict of [L, ...]
    leaves or a per-layer list; the port keeps a per-layer list. The
    group transposition is undone, k_pad columns are stripped and bf16
    scales widen to f32, so the result matches load_model of the same
    GGUF (with f32 scale storage) exactly."""
    layers = params["layers"]
    if isinstance(layers, dict):
        layers = [{key: _layer_of(v, li) for key, v in layers.items()}
                  for li in range(cfg.n_layer)]
    out = {key: _leaf(v, device) for key, v in params.items()
           if key not in ("layers", "output")}
    out["layers"] = [{key: _leaf(v, device) for key, v in lw.items()}
                     for lw in layers]
    if "output" in params:
        out["output"] = (out["token_embd"]
                         if params["output"] is params.get("token_embd")
                         else _leaf(params["output"], device))
    return out

"""GGUF block bytes -> a QTensor's natural layout: the CUDA kernel extract.

The counterpart of the JAX package's tpu_engine/native/lib.py:85
extract_device (convert.cc's multithreaded host C++ te_extract_device)
without its group-transposed permutation, which only the TPU kernels
read (source: csrc/extract.cu). For a type of quant/device_format.py
LAYOUTS it maps (raw uint8 blocks, type, n, k) to

    qs     uint8 [n, k/2] ("nib4", element 2j in the low nibble) or
           int8 [n, k] ("i8")
    scale  f32 [n, k/G]
    bias   f32 [n, k/G], or None where the layout has no bias

bit for bit what quant/device_format.to_device_format returns (Q5_0 keeps
its all-zero bias). The model loader (model/weights.qtensor_from_gguf)
uploads each quantized tensor's raw bytes and extracts on the card.

extract_plain is that numpy function, wrapped for tensors: it is the JAX
package's own reference for native/ (tests/test_native.py), and the port
already carries an exact copy of it.

extract() is the wrapper: on a CUDA tensor it launches the kernel on the
current stream (or raises), on a CPU tensor it runs extract_plain.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from ..gguf.constants import GGML_BLOCK_INFO, GGMLType
from ..quant.device_format import LAYOUTS, to_device_format
from . import _build

# kernel launches, bumped only where the kernel is launched (a lock: the
# registry may load two models from two threads)
LAUNCHES = {"extract": 0}
_LAUNCHES_LOCK = threading.Lock()


def _specs(ty: GGMLType, n: int, k: int) -> list:
    """(shape, dtype) of qs, scale and bias (None without a bias)."""
    lay = LAYOUTS[ty]
    grp = ((n, k // lay.group), torch.float32)
    return [((n, k // 2), torch.uint8) if lay.kind == "nib4"
            else ((n, k), torch.int8), grp, grp if lay.has_bias else None]


def alloc(ty: GGMLType, n: int, k: int, device) -> tuple:
    """Empty (qs, scale, bias or None) for extract's out= on `device`."""
    return tuple(None if s is None else torch.empty(s[0], dtype=s[1],
                                                    device=device)
                 for s in _specs(ty, n, k))


def _tensor(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def extract_plain(raw: torch.Tensor, ty: GGMLType, n: int, k: int) -> tuple:
    """Plain version: to_device_format (numpy, on the host) of a CPU uint8
    tensor; returns CPU tensors (qs, scale, bias or None)."""
    dq = to_device_format(raw.contiguous().numpy(), ty, (n, k))
    return (_tensor(dq.qs), _tensor(dq.scale.astype(np.float32, copy=False)),
            None if dq.bias is None
            else _tensor(dq.bias.astype(np.float32, copy=False)))


def _check(raw: torch.Tensor, ty: GGMLType, n: int, k: int) -> None:
    if ty not in LAYOUTS:
        raise ValueError(f"extract takes the types of LAYOUTS, not {ty!r}")
    blk, nbytes = GGML_BLOCK_INFO[ty]
    if k % blk:
        raise ValueError(f"extract: k={k} is not a multiple of {ty.name}'s "
                         f"{blk}-element block")
    want = n * (k // blk) * nbytes
    if raw.dtype != torch.uint8 or raw.dim() != 1 or raw.numel() != want:
        raise ValueError(f"extract: raw must be uint8 [{want}] for {ty.name} "
                         f"[{n}, {k}], got {tuple(raw.shape)} {raw.dtype}")


def _fn():
    f = _build.load("extract").extract
    if f.argtypes is None:
        f.argtypes = ([ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
                       ctypes.c_int64] + [ctypes.c_void_p] * 4)
        f.restype = ctypes.c_int
    return f


def extract_cuda(raw: torch.Tensor, ty: GGMLType, n: int, k: int,
                 out: tuple) -> tuple:
    """Launch the kernel on raw (uint8 on the card) into out = (qs, scale,
    bias or None), shaped as alloc's, contiguous on raw's device."""
    for got, want in zip(out, _specs(ty, n, k)):
        if (got is None) != (want is None) or (
                got is not None and (tuple(got.shape), got.dtype) != want):
            raise ValueError(f"extract: out does not match {ty.name} "
                             f"[{n}, {k}]")
    qs, scale, bias = out
    for t in (raw, *(t for t in out if t is not None)):
        if t.device != raw.device or not t.is_contiguous():
            raise ValueError("extract: raw and out must be contiguous on one "
                             "CUDA device")
    if qs.data_ptr() % 16:
        raise ValueError("extract: qs must be 16-byte aligned")
    if n == 0:
        return out
    P = _build.ptr
    rc = _fn()(int(ty), P(raw), n, k, P(qs), P(scale),
               None if bias is None else P(bias), _build.stream_ptr(raw.device))
    _build.check(rc, f"extract {ty.name}")
    with _LAUNCHES_LOCK:
        LAUNCHES["extract"] += 1
    return out


def extract(raw: torch.Tensor, ty: GGMLType, n: int, k: int,
            out: tuple | None = None) -> tuple:
    """(qs, scale, bias or None) of n rows of k elements of type ty from
    their raw block bytes (uint8 [n * k / block * block bytes]). On a CUDA
    tensor the kernel writes them (into out, or new tensors); on a CPU
    tensor extract_plain computes them (copied into out when given)."""
    ty = GGMLType(ty)
    _check(raw, ty, n, k)
    if raw.device.type == "cpu":
        res = extract_plain(raw, ty, n, k)
        if out is None:
            return res
        for dst, src in zip(out, res):
            if (dst is None) != (src is None):
                raise ValueError(f"extract: out does not match {ty.name}")
            if dst is not None:
                dst.copy_(src)
        return out
    if raw.device.type != "cuda":
        raise ValueError(f"extract: unsupported device {raw.device}")
    return extract_cuda(raw, ty, n, k,
                        alloc(ty, n, k, raw.device) if out is None else out)

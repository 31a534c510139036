"""Fused dequantize + matmul: the CUDA kernels qmm_nib4 and qmm_i8.

They replace the TPU kernels tpu_engine/kernels/dequant_matmul.py
_nib4_kernel and _i8_kernel (sources: csrc/qmm.cu); qmm_nib4 also takes
the ideas of the measurement variants scripts/qmm_variants.py _v2_kernel
and _v3_kernel. Both compute y[M, N] = x[M, K] @ dequant(W).T for a
natural-layout QTensor (model/weights.py) as their TPU kernels do, on the
tensor cores: x and q * scale rounded to bf16, f32 sums, and the bias
folded in as the f32 group sums of the bf16 x times the bias (xsum, made
here as the JAX wrapper makes it). qmm_nib4 takes 4-bit planes (Q4_K,
Q4_0, Q4_1, Q2_K), qmm_i8 int8 planes (Q8_0, Q6_K, Q5_*, Q3_K); one plain
twin, qmatmul_twin (named qmm_nib4_plain and qmm_i8_plain after each
kernel), computes that function for both.

qmatmul_plain is f32 dequant + f32 matmul, the function of the JAX
package's XLA path. It is what qmatmul runs on a CPU tensor, as the JAX
package runs XLA's f32 product on the CPU and its bf16 Pallas kernels on
the TPU.

qmatmul() is the wrapper the model calls: on a CUDA tensor it launches the
kernel (or raises); on a CPU tensor it runs qmatmul_plain.
"""

from __future__ import annotations

import ctypes
import threading
from dataclasses import replace

import torch

from ..model.weights import QTensor, dequant
from . import _build

# launches per kernel, bumped only where a kernel is launched; under a lock,
# since separate engines (two loaded models, or an encoder beside the LLM
# loop) launch from their own threads at the same time
LAUNCHES = {"qmm_nib4": 0, "qmm_i8": 0}
_LAUNCHES_LOCK = threading.Lock()


def qmatmul_plain(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """Plain version: dequantize W to f32, then one matmul. x [..., K]."""
    n, k = qt.shape
    lead = x.shape[:-1]
    y = x.reshape(-1, k).to(torch.float32) @ dequant(qt, torch.float32).t()
    return y.reshape(*lead, n).to(x.dtype)


def _bf16_operands(x2: torch.Tensor, qt: QTensor):
    """The kernels' activation operands, made as the JAX wrapper makes
    them: xb = bf16(x) [M, K] and, with a bias, xsum [M, K/G] f32, the sum
    of xb over each group (None without a bias)."""
    xb = x2.to(torch.bfloat16).contiguous()
    if qt.bias is None:
        return xb, None
    m, k = xb.shape
    return xb, torch.sum(xb.view(m, k // qt.group, qt.group), -1,
                         dtype=torch.float32)


def qmatmul_twin(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """The plain twin of the kernel qmatmul launches for qt on the card
    (nib4 or i8 weights): sum_k bf16(x) bf16(q scale) in f32, plus
    xsum @ bias.T. x [..., K]."""
    n, k = qt.shape
    lead = x.shape[:-1]
    xb, xsum = _bf16_operands(x.reshape(-1, k), qt)
    w = dequant(replace(qt, bias=None)).to(torch.bfloat16)
    y = xb.float() @ w.float().t()
    if xsum is not None:
        y = y + xsum @ qt.bias.t()
    return y.reshape(*lead, n).to(x.dtype)


# each kernel's plain version: the two compute one function
qmm_nib4_plain = qmm_i8_plain = qmatmul_twin


def _fn(name: str):
    """The launcher `name` (qmm_nib4 or qmm_i8): (x, xsum, qs, scale, bias,
    y, M, N, K, group, stream)."""
    f = getattr(_build.load("qmm"), name)
    if f.argtypes is None:
        f.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                      + [ctypes.c_void_p])
        f.restype = ctypes.c_int
    return f


def qmm_cuda(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """Launch qmm_nib4 / qmm_i8 on x [M, K] on the card (each takes x
    rounded to bf16, with its group sums where there is a bias); returns a
    new y [M, N] f32."""
    n, k = qt.shape
    if qt.kind not in ("nib4", "i8"):
        raise ValueError(f"qmm kernels take nib4/i8 weights, not {qt.kind}")
    if x.device.type != "cuda" or qt.qs.device != x.device:
        raise ValueError("qmm_cuda: x and the weight must be on one CUDA device")
    if not x.is_floating_point() or x.dim() != 2 or x.shape[1] != k:
        raise ValueError(f"qmm_cuda: x must be float [M, {k}], got "
                         f"{tuple(x.shape)} {x.dtype}")
    qdt, qcols = ((torch.uint8, k // 2) if qt.kind == "nib4"
                  else (torch.int8, k))
    if (qt.qs.dtype != qdt or tuple(qt.qs.shape) != (n, qcols)
            or k % 32 or qt.group not in (16, 32)):
        raise ValueError(f"qmm_cuda: unsupported weight layout {qt.kind} "
                         f"{tuple(qt.qs.shape)} {qt.qs.dtype} group {qt.group}")
    ng = k // qt.group
    for name, t in (("scale", qt.scale), ("bias", qt.bias)):
        if t is None and name == "bias":
            continue
        if (t is None or t.dtype != torch.float32 or tuple(t.shape) != (n, ng)
                or not t.is_contiguous() or t.device != x.device):
            raise ValueError(f"qmm_cuda: {name} must be f32 [{n}, {ng}] "
                             "contiguous on the device")
    if not qt.qs.is_contiguous() or qt.qs.data_ptr() % 16:
        raise ValueError("qmm_cuda: qs must be contiguous and 16-byte aligned")
    xb, xsum = _bf16_operands(x, qt)
    if xb.data_ptr() % 16:  # a view into the middle of a larger tensor
        xb = xb.clone()
    m = x.shape[0]
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0:
        return y
    P = _build.ptr
    name = "qmm_nib4" if qt.kind == "nib4" else "qmm_i8"
    rc = _fn(name)(
        P(xb), None if xsum is None else P(xsum), P(qt.qs), P(qt.scale),
        None if qt.bias is None else P(qt.bias), P(y), m, n, k, qt.group,
        _build.stream_ptr(x.device))
    _build.check(rc, name)
    with _LAUNCHES_LOCK:
        LAUNCHES[name] += 1
    return y


def qmatmul(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """y = x @ W.T for a quantized QTensor, x [..., K] -> [..., N]."""
    if x.device.type == "cpu":
        return qmatmul_plain(x, qt)
    n, k = qt.shape
    lead = x.shape[:-1]
    return qmm_cuda(x.reshape(-1, k), qt).reshape(*lead, n).to(x.dtype)

"""Random Q4_K_M weights of a configuration, drawn on the device from a seed.

tensor_table() lists a configuration's GGUF tensors in file order, as its
model module (models/<reference>.py, gguf_file.model_module) gives them.
Every such module defines

    tensor_table(cfg) -> [(name, shape rows first, ggml type, draw)]

in file order, with a shape of any rank (3-D [experts, rows, cols] for
stacked experts) and a type of gguf_file.BLOCK (F32, Q4_K, Q5_K, Q6_K);
`draw` says how an F32 tensor is drawn: "norm" is 1 + 0.1 N(0, 1),
"bias" 0.1 N(0, 1), "weight" SPREAD * N(0, 1) (a router, a convolution's
kernel); a k-quant tensor's blocks are drawn as below, whatever it says.
models/llama_family.py gives the llama family's, with llama.cpp's Q4_K_M
types.

draw_tensors() draws every tensor's raw bytes from one torch.Generator on
the given device, a few calls per tensor, in file order, so the same seed
on the same device gives the same bytes. Each k-quant block is drawn
directly, as tools/family_gguf.random_blocks draws it (frozen copy, in
torch): quants uniform, sub-block scales and mins set so that the weights
of a group average about 0 with a spread about SPREAD. A k-quant tensor of
any rank is drawn as its blocks in row-major order.
"""

from __future__ import annotations

import math

import torch

from .gguf_file import (BLOCK, GGML_F32, GGML_Q4_K, GGML_Q6_K, model_module,
                        tensor_nbytes)

SPREAD = 0.02  # about the std of a drawn weight
# how an F32 tensor is drawn: (scale of N(0, 1), offset)
DRAWS = {"norm": (0.1, 1.0), "bias": (0.1, 0.0), "weight": (SPREAD, 0.0)}


def drawn_table(cfg: dict) -> list:
    """[(name, shape (rows first), ggml type, draw)] in file order: the
    model module's tensor_table(cfg), its types and draws checked."""
    out = [(n, tuple(shape), ty, draw) for n, shape, ty, draw
           in model_module(cfg).tensor_table(cfg)]
    for n, _, ty, draw in out:
        if ty not in BLOCK:
            raise ValueError(f"{n}: no drawn type {ty} (one of {sorted(BLOCK)})")
        if ty == GGML_F32 and draw not in DRAWS:
            raise ValueError(f"{n}: no draw {draw!r} (one of {sorted(DRAWS)})")
    return out


def tensor_table(cfg: dict) -> list:
    """[(name, shape (rows first), ggml type)] in file order."""
    return [t[:3] for t in drawn_table(cfg)]


def _f16_bytes(x: float, n: int, device) -> torch.Tensor:
    return torch.full((n, 1), x, dtype=torch.float16,
                      device=device).view(torch.uint8)


def pack_scale_min_k4(sc: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """ggml's 12-byte packing of 8 six-bit scales and mins ([nb, 8] each)."""
    sc, m = sc.to(torch.uint8), m.to(torch.uint8)
    out = torch.zeros((sc.shape[0], 12), dtype=torch.uint8, device=sc.device)
    out[:, 0:4] = sc[:, 0:4] | ((sc[:, 4:8] >> 4) << 6)
    out[:, 4:8] = m[:, 0:4] | ((m[:, 4:8] >> 4) << 6)
    out[:, 8:12] = (sc[:, 4:8] & 0x0F) | ((m[:, 4:8] & 0x0F) << 4)
    return out


def random_blocks(g: torch.Generator, n: int, ty: int, device) -> torch.Tensor:
    """n weights (a multiple of 256) as random blocks of a k-quant type,
    [n / 256, block bytes] uint8. Q6_K: w = d * sc * (q - 32), q uniform on
    0..63, sc on +-[8, 24]. Q4_K / Q5_K: w = d * sc * q - dmin * m, q
    uniform on 0..qmax, sc on [lo, hi], dmin = d * (qmax + 1) / 2 and
    m = rint(sc * qmax / (qmax + 1)), so each sub-block's mean is about 0."""
    nb = n // 256
    if ty == GGML_Q6_K:
        blk = torch.randint(0, 256, (nb, 210), dtype=torch.uint8, generator=g,
                            device=device)
        mag = torch.randint(8, 25, (nb, 16), generator=g, device=device)
        sign = torch.randint(0, 2, (nb, 16), generator=g, device=device) * 2 - 1
        blk[:, 192:208] = (mag * sign).to(torch.int8).view(torch.uint8)
        blk[:, 208:210] = _f16_bytes(SPREAD / (16 * 18.47), nb, device)
        return blk
    qmax, lo, hi, size = ((15, 32, 63, 144) if ty == GGML_Q4_K
                          else (31, 24, 40, 176))
    d = SPREAD / ((lo + hi) / 2 * math.sqrt(((qmax + 1) ** 2 - 1) / 12))
    blk = torch.randint(0, 256, (nb, size), dtype=torch.uint8, generator=g,
                        device=device)
    sc = torch.randint(lo, hi + 1, (nb, 8), generator=g, device=device)
    m = torch.round(sc.to(torch.float64) * qmax / (qmax + 1)).to(torch.int64)
    blk[:, 0:2] = _f16_bytes(d, nb, device)
    blk[:, 2:4] = _f16_bytes(d * (qmax + 1) / 2, nb, device)
    blk[:, 4:16] = pack_scale_min_k4(sc, m)
    return blk


def draw_tensors(cfg: dict, seed: int, device):
    """Yield (name, shape, type, bytes as a flat uint8 tensor on `device`)
    for every tensor of tensor_table(cfg), in order; an F32 tensor drawn
    as its draw says (DRAWS)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    for name, shape, ty, draw in drawn_table(cfg):
        if ty == GGML_F32:
            scale, offset = DRAWS[draw]
            x = scale * torch.randn(shape, generator=g, device=device,
                                    dtype=torch.float32)
            if offset:
                x = x + offset
            data = x.view(torch.uint8).reshape(-1)
        else:
            data = random_blocks(g, math.prod(shape), ty, device).reshape(-1)
        assert data.numel() == tensor_nbytes(shape, ty)
        yield name, shape, ty, data

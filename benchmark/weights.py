"""Random Q4_K_M weights of a configuration, drawn on the device from a seed.

tensor_table() lists a configuration's GGUF tensors in file order with
llama.cpp's Q4_K_M types (llama_tensor_get_type): 2-D weights are Q4_K;
output.weight is Q6_K; attn_v and ffn_down are Q6_K on the layers where
use_more_bits(i, n) holds; a fused attn_qkv is Q5_K; norms and biases are
F32.

draw_tensors() draws every tensor's raw bytes from one torch.Generator on
the given device, a few calls per tensor, in file order, so the same seed
on the same device gives the same bytes. Each k-quant block is drawn
directly, as tools/family_gguf.random_blocks draws it (frozen copy, in
torch): quants uniform, sub-block scales and mins set so that the weights
of a group average about 0 with a spread about SPREAD.
"""

from __future__ import annotations

import math

import torch

from .gguf_file import (GGML_F32, GGML_Q4_K, GGML_Q5_K, GGML_Q6_K,
                        tensor_nbytes)

SPREAD = 0.02  # about the std of a drawn weight


def use_more_bits(i: int, n: int) -> bool:
    """llama.cpp's layer rule for the Q6_K bump of attn_v / ffn_down."""
    return i < n // 8 or i >= 7 * n // 8 or (i - n // 8) % 3 == 2


def tensor_table(cfg: dict) -> list:
    """[(name, shape (rows first), ggml type)] in file order."""
    E, F, V = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    H, KH = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    L = cfg["num_hidden_layers"]
    D = E // H
    q, kv = H * D, KH * D
    g = cfg["gguf"]
    t = [("token_embd.weight", (V, E), GGML_Q4_K),
         ("output_norm.weight", (E,), GGML_F32),
         ("output.weight", (V, E), GGML_Q6_K)]
    for i in range(L):
        p = f"blk.{i}."
        more = use_more_bits(i, L)
        t.append((p + "attn_norm.weight", (E,), GGML_F32))
        if g["fused_qkv"]:
            t.append((p + "attn_qkv.weight", (q + 2 * kv, E), GGML_Q5_K))
        else:
            t += [(p + "attn_q.weight", (q, E), GGML_Q4_K),
                  (p + "attn_k.weight", (kv, E), GGML_Q4_K),
                  (p + "attn_v.weight", (kv, E),
                   GGML_Q6_K if more else GGML_Q4_K)]
        if g["qkv_bias"]:
            t += [(p + "attn_q.bias", (q,), GGML_F32),
                  (p + "attn_k.bias", (kv,), GGML_F32),
                  (p + "attn_v.bias", (kv,), GGML_F32)]
        t += [(p + "attn_output.weight", (E, q), GGML_Q4_K),
              (p + "ffn_norm.weight", (E,), GGML_F32)]
        if g["fused_gate_up"]:
            t.append((p + "ffn_up.weight", (2 * F, E), GGML_Q4_K))
        else:
            t += [(p + "ffn_gate.weight", (F, E), GGML_Q4_K),
                  (p + "ffn_up.weight", (F, E), GGML_Q4_K)]
        t.append((p + "ffn_down.weight", (E, F),
                  GGML_Q6_K if more else GGML_Q4_K))
    return t


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
    for every tensor of tensor_table(cfg), in order. Norm weights are
    1 + 0.1 N(0, 1), biases 0.1 N(0, 1), in f32."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    for name, shape, ty in tensor_table(cfg):
        if ty == GGML_F32:
            x = 0.1 * torch.randn(shape, generator=g, device=device,
                                  dtype=torch.float32)
            if not name.endswith(".bias"):
                x = x + 1.0
            data = x.view(torch.uint8).reshape(-1)
        else:
            data = random_blocks(g, math.prod(shape), ty, device).reshape(-1)
        assert data.numel() == tensor_nbytes(shape, ty)
        yield name, shape, ty, data

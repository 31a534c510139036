"""BERT-family encoder forward in PyTorch: the embedding-model graph.

The port of the JAX package's model/bert.py. Two arch variants, as in
upstream llama.cpp:
  - "bert": learned absolute position embeddings, token-type embeddings,
    post-norm LayerNorm(+bias) blocks, biased projections, GELU FFN.
  - "nomic-bert": rope (neox) instead of position embeddings, SwiGLU FFN
    (gate, up), otherwise the same LayerNorm skeleton.

Encoding is one bidirectional pass over a right-padded [B, T] batch: no
KV cache, no decode loop. Quantized projections go through
model/weights.qmatmul (the CUDA kernels qmm_nib4 / qmm_i8 on the card).
Attention is plain f32 matmuls, as the JAX package leaves it to an XLA
einsum (no Pallas kernel there). Pooling (mean/cls/last) happens here;
the serving layer L2-normalizes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .llama import NEG_INF, apply_rope
from .weights import embed_rows, qmatmul


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm in the JAX package's order: f32 mean and centred
    variance, rsqrt(var + eps), the normalised rows cast to x's dtype,
    then * w + b."""
    xf = x.to(torch.float32)
    xc = xf - torch.mean(xf, dim=-1, keepdim=True)
    inv = torch.rsqrt(torch.mean(xc * xc, dim=-1, keepdim=True) + eps)
    return ((xc * inv).to(x.dtype) * w + b).to(x.dtype)


def _proj(x: torch.Tensor, lw: dict, name: str) -> torch.Tensor:
    y = qmatmul(x, lw[name])
    b = lw.get(name + "_b")
    return y + b if b is not None else y


@torch.no_grad()
def encode(weights: dict, tokens: torch.Tensor, n_valid: torch.Tensor,
           cfg: ModelConfig, pooling: str = "") -> torch.Tensor:
    """Bidirectional encode + pool of tokens [B, T] (right-padded, on the
    weights' device) with n_valid [B] real tokens a row. pooling "" takes
    cfg.pooling_type. Returns [B, n_embd] f32, unnormalised."""
    B, T = tokens.shape
    H, D = cfg.n_head, cfg.head_dim
    dev = tokens.device
    dtype = weights["token_embd_norm"].dtype

    x = embed_rows(weights["token_embd"], tokens.long(), dtype)  # [B, T, E]
    if "token_types" in weights:
        # single-segment inputs: type id 0 everywhere
        x = x + weights["token_types"][0].to(dtype)
    if "position_embd" in weights:
        x = x + weights["position_embd"][:T].to(dtype)
    x = layer_norm(x, weights["token_embd_norm"], weights["token_embd_norm_b"],
                   cfg.rms_eps)

    pos = torch.arange(T, dtype=torch.int32, device=dev)
    valid = pos[None, :] < n_valid.to(dev)[:, None]  # [B, T]
    # every query row (padded ones too) attends every valid key
    mask = valid[:, None, None, :]  # [B, 1(h), 1(q), T(k)]
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=dev)

    for lw in weights["layers"]:
        q = _proj(x, lw, "wq").reshape(B, T, H, D)
        k = _proj(x, lw, "wk").reshape(B, T, H, D)
        v = _proj(x, lw, "wv").reshape(B, T, H, D)
        if "position_embd" not in weights:  # nomic-bert: rope positions
            q = apply_rope(q, pos[None, :], cfg)
            k = apply_rope(k, pos[None, :], cfg)
        scores = torch.einsum("bthd,buhd->bhtu", q.to(torch.float32),
                              k.to(torch.float32)) * (D ** -0.5)
        p = torch.softmax(torch.where(mask, scores, neg), dim=-1)
        attn = torch.einsum("bhtu,buhd->bthd", p, v.to(torch.float32))
        attn = _proj(attn.reshape(B, T, H * D).to(dtype), lw, "wo")
        x = layer_norm(x + attn, lw["attn_norm"], lw["attn_norm_b"], cfg.rms_eps)

        if "w_gate" in lw:  # nomic-bert SwiGLU
            ffn = _proj(F.silu(_proj(x, lw, "w_gate")) * _proj(x, lw, "w_up"),
                        lw, "w_down")
        else:  # exact (erf) GELU, in f32
            h = F.gelu(_proj(x, lw, "w_up").to(torch.float32),
                       approximate="none").to(dtype)
            ffn = _proj(h, lw, "w_down")
        x = layer_norm(x + ffn, lw["ffn_norm"], lw["ffn_norm_b"], cfg.rms_eps)

    xf = x.to(torch.float32)
    mode = pooling or cfg.pooling_type
    if mode == "cls":
        return xf[:, 0]
    nv = n_valid.to(dev).long()
    if mode == "last":
        return xf[torch.arange(B, device=dev), torch.clamp(nv - 1, min=0)]
    vf = valid[..., None].to(torch.float32)
    return torch.sum(xf * vf, dim=1) / torch.clamp(
        nv[:, None].to(torch.float32), min=1.0)

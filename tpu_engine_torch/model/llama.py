"""Llama-family forward step and decode loop in PyTorch.

The port of the JAX package's model/llama.py. One function serves both
prefill chunks ([B, Tc] with per-row n_valid) and batched decode ([S, 1]).
Graph: RMSNorm -> q|k|v projection -> RoPE (split-half; "norm"-rope models
are de-interleaved at load) -> attention over the slot cache plus the
step's in-flight rows -> o projection -> residual -> RMSNorm -> SwiGLU /
GeGLU -> residual.

Deferred append, as in the JAX version: attention sees the step's K/V rows
as in-flight operands; the cache write happens once after the layer loop,
for every layer and slot at once (kvcache.append_step), in place.

Quantized projections go through model/weights.qmatmul (the CUDA kernels
qmm_nib4 / qmm_i8 on the card); attention through the hook below, which
defaults to kernels/flash_attention.flash_attention (the CUDA kernels
attn_decode / attn_prefill for a "td" cache and attn_decode_dt /
attn_prefill_dt for a "dt" cache on the card, attention_reference on the
CPU). append_step quantizes the appended rows for q8_0/q4_0 caches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kvcache.cache import KVCache, append_step, dequant_kv
from .config import ModelConfig
from .weights import embed_rows, qmatmul

NEG_INF = -1e30


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    inv = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * inv).to(x.dtype) * w


def rope_cos_sin(pos: torch.Tensor, cfg: ModelConfig):
    """cos/sin tables for positions pos [...] -> [..., rope_dim // 2], with
    linear / yarn / llama-3.1 scaling folded in (cfg.rope_freq_table)."""
    inv_freq_t, mscale = cfg.rope_freq_table()
    inv_freq = torch.tensor(inv_freq_t, dtype=torch.float32, device=pos.device)
    ang = pos.to(torch.float32)[..., None] * inv_freq
    if mscale != 1.0:
        return torch.cos(ang) * mscale, torch.sin(ang) * mscale
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, pos: torch.Tensor, cfg: ModelConfig):
    """x [..., T, H, D], pos broadcastable to [..., T]. Applied in f32."""
    rd = cfg.rope_dim
    cos, sin = rope_cos_sin(pos, cfg)
    cos, sin = cos[..., None, :], sin[..., None, :]  # [..., T, 1, rd/2]
    xf = x.to(torch.float32)
    xr, x_pass = xf[..., :rd], xf[..., rd:]
    if cfg.rope_type == "norm":
        xe, xo = xr[..., 0::2], xr[..., 1::2]
        rot = torch.stack([xe * cos - xo * sin, xe * sin + xo * cos],
                          dim=-1).reshape(xr.shape)
    else:  # neox: split halves
        x1, x2 = xr[..., : rd // 2], xr[..., rd // 2:]
        rot = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return torch.cat([rot, x_pass], dim=-1).to(x.dtype)


def apply_rope_storage(x: torch.Tensor, pos: torch.Tensor, cfg: ModelConfig):
    """Split-half rotation of storage-order K rows x [..., KH, Tc, D] by
    positions pos [..., Tc] (leading dims broadcast)."""
    rd, half = cfg.rope_dim, cfg.rope_dim // 2
    cos, sin = rope_cos_sin(pos, cfg)
    cos, sin = cos[..., None, :, :], sin[..., None, :, :]  # [..., 1, Tc, half]
    xf = x.to(torch.float32)
    x1, x2, rest = xf[..., :half], xf[..., half:rd], xf[..., rd:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos, rest],
                     dim=-1).to(x.dtype)


def self_extend_pos(pos: torch.Tensor, ga_n: int, ga_w: int) -> torch.Tensor:
    """Grouped self-extend remap: p < w -> p; p >= w -> w + (p - w) // n.
    ga_n <= 1 disables."""
    ga_n, ga_w = int(ga_n), int(ga_w)
    if ga_n <= 1:
        return pos
    return torch.where(pos < ga_w, pos,
                       ga_w + torch.div(pos - ga_w, ga_n, rounding_mode="floor"))


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")
    return F.silu(x)


def attention_reference(q, cache: KVCache, li: int, slot_ids, q_pos, n_valid,
                        k_new, v_new, cfg: ModelConfig, ga_n=1, ga_w=0,
                        rot_cache: bool = False, win=None) -> torch.Tensor:
    """Plain attention over the slot cache + in-flight rows; the plain
    version of every attention kernel (attn_decode, attn_prefill,
    attn_decode_dt, attn_prefill_dt).

    q [B, Tc, H, D] rotated; cache ("td" or "dt", any kind) holding
    history only (cells < start = q_pos[:, 0]); k_new/v_new [B, KH, Tc, D]
    this step's rows (K rotated). rot_cache: cached K is stored
    pre-rotated, otherwise it is rotated here by its (self-extend-remapped)
    cell index. Returns [B, Tc, H, D]."""
    B, Tc, H, D = q.shape
    KH = k_new.shape[1]
    G = H // KH
    sl = slot_ids.long()
    kc, vc = cache.k[li, sl], cache.v[li, sl]
    if cache.layout == "dt":  # [B, KH, Dk, T] -> [B, KH, T, Dk]
        kc, vc = kc.transpose(-1, -2), vc.transpose(-1, -2)
    ks = cache.k_scale[li, sl] if cache.quantized else None
    vs = cache.v_scale[li, sl] if cache.quantized else None
    kf = dequant_kv(kc, ks, cache.kind)  # [B, KH, T, D]
    vf = dequant_kv(vc, vs, cache.kind)
    T = kf.shape[2]
    cell = torch.arange(T, dtype=torch.int32, device=q.device)[None, :].expand(B, T)
    kf = kf.transpose(1, 2)  # [B, T, KH, D]
    if not rot_cache:
        kf = apply_rope(kf, self_extend_pos(cell, ga_n, ga_w), cfg)
    kf = kf.to(torch.float32)
    vf = vf.transpose(1, 2)
    kf = torch.cat([kf, k_new.transpose(1, 2).to(torch.float32)], dim=1)
    vf = torch.cat([vf, v_new.transpose(1, 2).to(torch.float32)], dim=1)

    qf = q.reshape(B, Tc, KH, G, D).to(torch.float32)
    scores = torch.einsum("btkgd,bukd->btkgu", qf, kf) * cfg.attention_scale()
    if cfg.attn_logit_softcap > 0:
        c = cfg.attn_logit_softcap
        scores = torch.tanh(scores / c) * c
    start = q_pos[:, 0]
    mask_cache = (cell[:, None, :] < start[:, None, None]).expand(B, Tc, T)
    t_rel = torch.arange(Tc, dtype=torch.int32, device=q.device)
    mask_new = (t_rel[None, None, :] <= t_rel[None, :, None]) & (
        t_rel[None, None, :] < n_valid[:, None, None])
    window = int(cfg.layer_window(li) if win is None else win)
    if window > 0:
        mask_cache = mask_cache & (cell[:, None, :] > q_pos[..., None] - window)
        mask_new = mask_new & (t_rel[None, None, :] > t_rel[None, :, None] - window)
    mask = torch.cat([mask_cache, mask_new.expand(B, Tc, Tc)], dim=2)
    scores = torch.where(mask[:, :, None, None, :], scores,
                         torch.tensor(NEG_INF, dtype=scores.dtype, device=q.device))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("btkgu,bukd->btkgd", p, vf)
    return out.reshape(B, Tc, H, D).to(q.dtype)


# Attention implementation; None = kernels/flash_attention.flash_attention
# (CUDA kernels on the card, attention_reference on the CPU).
_ATTN_IMPL = None


def set_attention_impl(fn) -> None:
    """Install fn (attention_reference's signature) as the attention; None
    resets to the kernels."""
    global _ATTN_IMPL
    _ATTN_IMPL = fn


def _attention(*args, **kw):
    fn = _ATTN_IMPL
    if fn is None:
        from ..kernels.flash_attention import flash_attention as fn
    return fn(*args, **kw)


@torch.no_grad()
def forward_step(weights: dict, cache: KVCache, tokens: torch.Tensor,
                 slot_ids: torch.Tensor, active: torch.Tensor,
                 cfg: ModelConfig, ga_n: int = 1, ga_w: int = 0,
                 n_valid: torch.Tensor | None = None, collect_hidden=False,
                 embd: torch.Tensor | None = None, rot_cache: bool = False):
    """One engine step over a [B, Tc] token block; updates `cache` in place.

    n_valid [B]: real tokens per row (rows are right-padded to Tc; pad
    tokens neither write to the cache nor count). Inactive rows neither
    write nor advance. embd [B, Tc, E]: decode these embeddings instead of
    token ids. Returns (logits [B, V] f32 at each row's last valid token,
    cache, pooled hidden or None)."""
    B, Tc = tokens.shape
    H, D = cfg.n_head, cfg.head_dim
    dev = tokens.device
    dtype = weights["output_norm"].dtype
    if n_valid is None:
        n_valid = torch.full((B,), Tc, dtype=torch.int32, device=dev)
    sl = slot_ids.long()
    start = cache.lengths[sl]  # [B] int32
    q_pos = start[:, None] + torch.arange(Tc, dtype=torch.int32, device=dev)[None, :]
    pos = self_extend_pos(q_pos, ga_n, ga_w)

    if embd is not None:
        x = embd.to(dtype)
    else:
        x = embed_rows(weights["token_embd"], tokens.long(), dtype)
        if cfg.embedding_scale != 1.0:
            x = x * cfg.embedding_scale

    k_rows, v_rows = [], []
    for li, lw in enumerate(weights["layers"]):
        h = rms_norm(x, lw["attn_norm"], cfg.rms_eps)
        if "wqkv" in lw:  # load-time fused q|k|v
            hqkv = qmatmul(h, lw["wqkv"])
            if "bqkv" in lw:
                hqkv = hqkv + lw["bqkv"]
            KHD = (hqkv.shape[-1] - H * D) // 2
            hq, hk, hv = hqkv.split([H * D, KHD, KHD], dim=-1)
        else:
            hq, hk, hv = (qmatmul(h, lw["wq"]), qmatmul(h, lw["wk"]),
                          qmatmul(h, lw["wv"]))
            if "bq" in lw:
                hq, hk, hv = hq + lw["bq"], hk + lw["bk"], hv + lw["bv"]
        hq = hq.reshape(B, Tc, -1, D)
        hk = hk.reshape(B, Tc, -1, D)
        hv = hv.reshape(B, Tc, -1, D)
        q_rot = apply_rope(hq, pos, cfg)
        k_store = hk.transpose(1, 2)  # [B, KH, Tc, D] storage order
        v_store = hv.transpose(1, 2).contiguous()
        k_new_rot = apply_rope_storage(k_store, pos, cfg)
        attn = _attention(q_rot, cache, li, slot_ids, q_pos, n_valid,
                          k_new_rot, v_store, cfg, ga_n, ga_w,
                          rot_cache=rot_cache, win=cfg.layer_window(li))
        attn = qmatmul(attn.reshape(B, Tc, -1), lw["wo"])
        if cfg.post_norms:
            attn = rms_norm(attn, lw["post_attn_norm"], cfg.rms_eps)
        x = x + attn

        h = rms_norm(x, lw["ffn_norm"], cfg.rms_eps)
        if "w_gateup" in lw:  # load-time fused gate|up
            gu = qmatmul(h, lw["w_gateup"])
            nf = gu.shape[-1] // 2
            gate, up = _act(gu[..., :nf], cfg.act), gu[..., nf:]
        else:
            gate = _act(qmatmul(h, lw["w_gate"]), cfg.act)
            up = qmatmul(h, lw["w_up"])
        ffn = qmatmul(gate * up, lw["w_down"])
        if cfg.post_norms:
            ffn = rms_norm(ffn, lw["post_ffn_norm"], cfg.rms_eps)
        x = x + ffn
        # rotated K is stored under rot_cache (the same values attention
        # just read in flight); unrotated otherwise (self-extend)
        k_rows.append(k_new_rot if rot_cache else k_store)
        v_rows.append(v_store)

    x = rms_norm(x, weights["output_norm"], cfg.rms_eps)
    rows = torch.arange(B, device=dev)
    last_idx = torch.clamp(n_valid.long() - 1, min=0)
    if collect_hidden == "all":
        pooled = x.to(torch.float32)
    elif collect_hidden == "cls":
        pooled = x[:, 0].to(torch.float32)
    elif collect_hidden == "last":
        pooled = x[rows, last_idx].to(torch.float32)
    elif collect_hidden:
        valid = (torch.arange(Tc, device=dev)[None, :] < n_valid[:, None])[..., None]
        hidden_sum = torch.where(valid, x.to(torch.float32), 0.0).sum(dim=1)
        pooled = hidden_sum / torch.clamp(n_valid[:, None], min=1)
    else:
        pooled = None

    last = x[rows, last_idx]  # [B, E]
    logits = qmatmul(last, weights["output"]).to(torch.float32)
    if cfg.final_logit_softcap > 0:
        c = cfg.final_logit_softcap
        logits = torch.tanh(logits / c) * c

    append_step(cache, torch.stack(k_rows), torch.stack(v_rows), slot_ids,
                start, n_valid, active)
    old = cache.lengths[sl]
    cache.lengths[sl] = torch.where(active, old + n_valid.to(old.dtype), old)
    return logits, cache, pooled


@torch.no_grad()
def decode_loop(weights: dict, cache: KVCache, tokens: torch.Tensor,
                active: torch.Tensor, cfg: ModelConfig, samp_params,
                samp_state, n_inner: int, ga_n: int = 1, ga_w: int = 0,
                rot_cache: bool = False, gbank=None):
    """n_inner batched decode steps with on-device sampling: a Python loop
    of forward_step + sample_step over all S slots. Returns (tokens
    [S, n_inner], last [S], cache, sampler state)."""
    from ..sampling.device import sample_step

    S = tokens.shape[0]
    slot_ids = torch.arange(S, dtype=torch.int32, device=tokens.device)
    tok, st, out = tokens, samp_state, []
    for _ in range(int(n_inner)):
        logits, cache, _ = forward_step(
            weights, cache, tok[:, None], slot_ids, active, cfg,
            ga_n=ga_n, ga_w=ga_w, rot_cache=rot_cache)
        tok, st = sample_step(logits, samp_params, st, gbank=gbank)
        out.append(tok)
    return torch.stack(out, dim=1), tok, cache, st
